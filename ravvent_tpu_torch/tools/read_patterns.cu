// Three ways to read a beam step's memory (keys, then values, [B, S, 128]
// bf16, one batch row a CTA of 64 threads), for tools/read_patterns.py:
//   0 thread_row: a thread reads its position's 256-byte row, 16 loads of
//     16 bytes in flight (how a kernel that gives each position a thread
//     reads it straight from global memory);
//   1 coalesced: consecutive threads read consecutive 16-byte chunks, 8
//     loads in flight a thread;
//   2 cp_async_blocks: blocks of 32 positions copied into shared memory
//     with coalesced 16-byte cp.async, two blocks in flight, each row then
//     read by its thread (csrc/beam_step_f.cu's beam_attend).
// Each thread folds what it read into one float, so nothing is optimized
// away. Plain C interface: rv_read_pattern(kind, B, S, keys, values, out,
// stream) returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64, kChunks = 16, kKB = 32;

__device__ __forceinline__ float fold(uint4 q) { return __uint_as_float(q.x ^ q.y ^ q.z ^ q.w); }

__global__ void __launch_bounds__(kThreads) thread_row(const uint4* k, const uint4* v, int S,
                                                       float* out) {
  float acc = 0.f;
  for (int a = 0; a < 2; ++a) {
    const uint4* base = (a ? v : k) + (size_t)blockIdx.x * S * kChunks;
    for (int s = threadIdx.x; s < S; s += kThreads) {
      uint4 q[kChunks];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) q[c] = __ldg(base + (size_t)s * kChunks + c);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) acc += fold(q[c]);
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads) coalesced(const uint4* k, const uint4* v, int S,
                                                      float* out) {
  const int n = S * kChunks;
  float acc = 0.f;
  for (int a = 0; a < 2; ++a) {
    const uint4* base = (a ? v : k) + (size_t)blockIdx.x * n;
    for (int i0 = threadIdx.x; i0 < n; i0 += 8 * kThreads) {
      uint4 q[8];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        q[r] = i0 + r * kThreads < n ? __ldg(base + i0 + r * kThreads) : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int r = 0; r < 8; ++r) acc += fold(q[r]);
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

__device__ __forceinline__ void fetch(uint4* buf, const uint4* base, int S, int b) {
  if (b * kKB < S) {
    const int rows = min(kKB, S - b * kKB);
    for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const unsigned d = (unsigned)__cvta_generic_to_shared(buf + (b & 1) * kKB * kChunks +
                                                            r * kChunks + (c ^ (r & 7)));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(base + (size_t)b * kKB * kChunks + i));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__global__ void __launch_bounds__(kThreads) cp_async_blocks(const uint4* k, const uint4* v, int S,
                                                            float* out) {
  __shared__ __align__(16) uint4 buf[2 * kKB * kChunks];
  const int nb = (S + kKB - 1) / kKB;
  const int r = threadIdx.x / 2, c0 = (threadIdx.x % 2) * (kChunks / 2);
  float acc = 0.f;
  for (int a = 0; a < 2; ++a) {
    const uint4* base = (a ? v : k) + (size_t)blockIdx.x * S * kChunks;
    fetch(buf, base, S, 0);
    fetch(buf, base, S, 1);
    for (int b = 0; b < nb; ++b) {
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      if (b * kKB + r < S) {
#pragma unroll
        for (int c = c0; c < c0 + kChunks / 2; ++c)
          acc += fold(buf[(b & 1) * kKB * kChunks + r * kChunks + (c ^ (r & 7))]);
      }
      __syncthreads();
      fetch(buf, base, S, b + 2);
    }
  }
  out[blockIdx.x * kThreads + threadIdx.x] = acc;
}

}  // namespace

extern "C" int rv_read_pattern(int kind, int B, int S, const void* keys, const void* values,
                               void* out, void* stream) {
  const uint4 *k = (const uint4*)keys, *v = (const uint4*)values;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case 0: thread_row<<<B, kThreads, 0, st>>>(k, v, S, (float*)out); break;
    case 1: coalesced<<<B, kThreads, 0, st>>>(k, v, S, (float*)out); break;
    case 2: cp_async_blocks<<<B, kThreads, 0, st>>>(k, v, S, (float*)out); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
