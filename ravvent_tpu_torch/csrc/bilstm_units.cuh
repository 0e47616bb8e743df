// The unit counts U that the BiLSTM kernels (bilstm.cu, bilstm_bf16.cu) are
// compiled for, listed once, in increasing order: each C entry instantiates
// its kernel for each of them and refuses any other U, and
// ops/rnn_cuda.py:KERNEL_UNITS reads the list from the #define line below. A
// width joins by being added there, where both kernels' templates take it
// (their headers state the rules: U a multiple of 16). A layer of any other
// width up to the widest runs at the next compiled one, its weights
// zero-padded once in ops/rnn_cuda.py:kernel_layout; the C entries never see
// its own U.

#pragma once

#define RV_BILSTM_UNITS(X) X(32) X(64) X(96) X(128) X(192) X(256)

#define RV_BILSTM_UNIT_EQ(u) || U == (u)
__host__ __device__ constexpr bool rv_bilstm_compiled(int U) {
  return false RV_BILSTM_UNITS(RV_BILSTM_UNIT_EQ);
}
#undef RV_BILSTM_UNIT_EQ
