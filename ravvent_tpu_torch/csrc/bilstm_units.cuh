// The unit counts U that the BiLSTM kernels are compiled for, listed once, in
// increasing order, and ops/rnn_cuda.py:KERNEL_UNITS reads both lists from
// the #define lines below.
// - RV_BILSTM_UNITS: bilstm.cu and bilstm_bf16.cu instantiate their kernel
//   for each (a template on U, a multiple of 16) and refuse any other U.
// - RV_BILSTM_WIDE_UNITS: bilstm_wide.cu and bilstm_bf16_wide.cu take these,
//   past the widest of the first list, in one instance each whose unit count
//   is a runtime loop bound (a multiple of 32, at most 512), and refuse any
//   other U.
// A width joins by being added to one of them, where its kernels take it
// (their headers state the rules). A layer of any other width up to the
// widest runs at the next compiled one, its weights zero-padded once in
// ops/rnn_cuda.py:kernel_layout; the C entries never see its own U.

#pragma once

#define RV_BILSTM_UNITS(X) X(32) X(64) X(96) X(128) X(192) X(256)
#define RV_BILSTM_WIDE_UNITS(X) X(320) X(384) X(448) X(512)

#define RV_BILSTM_UNIT_EQ(u) || U == (u)
__host__ __device__ constexpr bool rv_bilstm_compiled(int U) {
  return false RV_BILSTM_UNITS(RV_BILSTM_UNIT_EQ);
}
__host__ __device__ constexpr bool rv_bilstm_wide_compiled(int U) {
  return false RV_BILSTM_WIDE_UNITS(RV_BILSTM_UNIT_EQ);
}
#undef RV_BILSTM_UNIT_EQ
