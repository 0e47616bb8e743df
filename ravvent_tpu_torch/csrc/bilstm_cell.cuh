// Device helpers shared by the BiLSTM kernels: bilstm.cu and bilstm_wide.cu
// (f32 stream), bilstm_bf16.cu and bilstm_bf16_wide.cu (bf16 stream). Each
// source includes this header and is compiled on its own, so everything here
// is internal to each object.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The cell in f32 with ex2.approx (__expf) and rcp.approx (__fdividef), five
// exponentials and three reciprocals a (row, unit): with E(x) = e^-x,
// sigmoid(i) * tanh(g) = (1 - E(2g)) / ((1 + E(i)) (1 + E(2g))) and
// sigmoid(o) * tanh(c) likewise, sigmoid(f) c = c / (1 + E(f)). The
// arguments are clamped where the factors would overflow (i, o >= -40,
// 2g, 2c >= -30: e^40 e^30 < 2^126, where __fdividef still divides), which
// moves no result by more than 1e-17.
__device__ __forceinline__ float exp_neg(float x, float lo) { return __expf(-fmaxf(x, lo)); }
__device__ __forceinline__ float sig_tanh(float s, float t) {  // sigmoid(s) * tanh(t)
  const float es = exp_neg(s, -40.f), et = exp_neg(2.f * t, -30.f);
  return __fdividef(1.f - et, (1.f + es) * (1.f + et));
}
__device__ __forceinline__ void lstm_cell(float zi, float zf, float zg, float zo, float& c,
                                          float& h) {
  c = __fdividef(c, 1.f + exp_neg(zf, -88.f)) + sig_tanh(zi, zg);
  h = sig_tanh(zo, c);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// ---- the f32 stream (bilstm.cu, bilstm_wide.cu) ----

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// The weight k-tiles by the Tensor Memory Accelerator: one thread asks for a
// whole k-tile (contiguous in global and in shared memory), and the copy
// completes on the slot's mbarrier, which every thread waits on.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// acc[q][gate][i] += a[k][i] * w[k][unit q][gate] for the k-rows [0, K) of
// a k-tile of U units: a points at row 0 of A's rows for this thread (stride
// AS), w at the thread's first unit in the k-tile, its second unit U/2
// float4s further
template <int K, int AS>
__device__ __forceinline__ void fma_rows(float (&acc)[2][4][8], const float* a, const float4* w,
                                         int U) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 w0 = w[k * U], w1 = w[k * U + U / 2];
    const float4 xa = *reinterpret_cast<const float4*>(a + k * AS);
    const float4 xb = *reinterpret_cast<const float4*>(a + k * AS + 4);
    const float xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      acc[0][0][i] = fmaf(xv[i], w0.x, acc[0][0][i]);
      acc[0][1][i] = fmaf(xv[i], w0.y, acc[0][1][i]);
      acc[0][2][i] = fmaf(xv[i], w0.z, acc[0][2][i]);
      acc[0][3][i] = fmaf(xv[i], w0.w, acc[0][3][i]);
      acc[1][0][i] = fmaf(xv[i], w1.x, acc[1][0][i]);
      acc[1][1][i] = fmaf(xv[i], w1.y, acc[1][1][i]);
      acc[1][2][i] = fmaf(xv[i], w1.z, acc[1][2][i]);
      acc[1][3][i] = fmaf(xv[i], w1.w, acc[1][3][i]);
    }
  }
}

// ---- the bf16 stream (bilstm_bf16.cu, bilstm_bf16_wide.cu) ----

typedef __nv_bfloat16 bf16;

constexpr int kFrag = 4 * 32;  // 8-byte words of one (unit octet, k-tile): 4 gates x 32 lanes

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// d += a . b for one m16n8k16 tile, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint4& a, const uint2& b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// A fragment of m-tile mt, k-tile kt of the row-major x tile (row stride xsr).
__device__ __forceinline__ uint4 x_frag(const bf16* x, int xsr, int mt, int kt, int g, int tg) {
  const bf16* p = x + (16 * mt + g) * xsr + 16 * kt + 2 * tg;
  return make_uint4(lds32(p), lds32(p + 8 * xsr), lds32(p + 8), lds32(p + 8 * xsr + 8));
}

}  // namespace
