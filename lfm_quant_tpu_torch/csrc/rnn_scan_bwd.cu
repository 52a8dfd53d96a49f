// The hoisted form's float32 kernels and public entry point of the
// CUDA-core backward (csrc/rnn_bwd.cu: kernels, design and bound there),
// built as a translation unit of its own so that the backward's four
// units compile in parallel.
#define LFM_RNN_BWD_HOISTED
#include "rnn_bwd.cu"
