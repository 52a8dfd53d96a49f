// The hoisted form's entry point of the CUDA-core forward
// (csrc/rnn_fused_fwd.cu: kernels, design and bound there), built as a
// translation unit of its own so that its kernels compile in parallel with
// the fused form's.
#define LFM_RNN_FWD_HOISTED
#include "rnn_fused_fwd.cu"
