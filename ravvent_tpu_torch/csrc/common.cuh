// Device helpers shared by the port's decoder kernels (beam_step_f.cu,
// beam_loop.cu, decode_step.cu). Each source includes this header and is
// compiled on its own, so everything here is internal to each object.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegMax = -3.4028234663852886e38f;  // finfo(float32).min

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// Rounding of an f32 operand to the memory's precision: the reference casts
// h and the alignments to the memory dtype before each dot, accumulating in f32.
template <typename M> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Four consecutive memory elements starting at p (16 B aligned for f32, 8 B
// for bf16), read from global memory through the read-only path.
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float v[2]) {
  const unsigned int q = __ldg(reinterpret_cast<const unsigned int*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q);
  v[0] = __low2float(a); v[1] = __high2float(a);
}

// The same four elements from shared memory.
__device__ __forceinline__ void lds4(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float v[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Masked softmax of one row of n scores in shared memory by one warp,
// in place; masked scores hold finfo.min, so an all-masked row becomes
// uniform, as in the reference. The result is rounded to M's precision.
template <typename M>
__device__ __forceinline__ void warp_softmax(float* srow, int n, int lane) {
  float m = kNegMax;
  for (int s = lane; s < n; s += 32) m = fmaxf(m, srow[s]);
  m = warp_max(m);
  float sum = 0.f;
  for (int s = lane; s < n; s += 32) {
    const float e = expf(srow[s] - m);
    srow[s] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int s = lane; s < n; s += 32) srow[s] = round_to<M>(srow[s] / sum);
}

// First-index argmax of n values in shared memory by one warp: every lane
// returns the best value and its index (the smallest index on a tie, the
// rule of jax.lax.top_k and of the reference kernels' iterated argmax).
__device__ __forceinline__ void warp_argmax(const float* f, int n, int lane, float& best,
                                            int& bi) {
  best = __int_as_float(0xff800000);  // -inf
  bi = n;
  for (int i = lane; i < n; i += 32) {
    const float x = f[i];
    if (x > best || bi == n) { best = x; bi = i; }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
  }
}

}  // namespace
