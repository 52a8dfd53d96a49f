// The fused form's bfloat16 kernels of the CUDA-core backward
// (csrc/rnn_bwd.cu: kernels, design and bound there), built as a
// translation unit of its own so that the backward's four units compile in
// parallel.
#define LFM_RNN_BWD_BF16
#include "rnn_bwd.cu"
