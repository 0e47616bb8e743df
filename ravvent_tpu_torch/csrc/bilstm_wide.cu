// One bidirectional LSTM layer on an f32 stream past 256 units, the whole
// time loop in one launch.
//
// Replaces the TPU kernel ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel
// (entry point run_bidi_lstm_pallas) with an f32 input, at the widths of
// RV_BILSTM_WIDE_UNITS (bilstm_units.cuh: 320, 384, 448 and 512 units); the
// narrower ones run bilstm.cu. Same math as that kernel and as bilstm.cu:
// keras LSTMCell, gates i, f, g, o, z = x.Wx + h.Wh + b, f32 state and
// products, the cell of bilstm_cell.cuh, the backward direction on
// x[T-1-t], time-aligned outputs.
//
// What bounds it on the H100: the f32 products, 2*(F+U)*4U flops per row,
// step and direction, on the FMA pipe (67 TFLOP/s), as in bilstm.cu. Here
// the weights, (F + U) x 4U f32 a direction (up to 6 MiB at U = 512 and F =
// 1024), stream from L2 every step into every CTA, R / 2 flops a byte, so
// at 16 rows a CTA L2's rate for them bounds it too.
//
// Design: bilstm.cu's, cut to fit shared memory at Kx = 2U = 1024. One CTA
// per (direction, tile of R = 16 batch rows), U threads (R U / 16), U a
// runtime argument (a multiple of 32, at most 512) in one instance:
// - Thread (u, r0) owns units u and u + U/2 of rows [r0, r0 + 8): all four
//   gates, 64 accumulators, so the cell needs no exchange (u = 16 w + lane %
//   16, r0 = 8 (lane / 16): a warp's weight loads read 256 contiguous bytes,
//   its loads of A two addresses).
// - A = [x_t | h_{t-1}] k-major in shared memory, [Kx + U][R + 4], and the
//   cell state c beside it, [2][8][U]: 120 and 32 KiB at U = 512, Kx = 1024.
// - The weights stream through a ring of two k-tiles of 4 rows (U / 8 KiB
//   each, 64 KiB at U = 512: 216 KiB in all, within the 227 KiB of a block),
//   one bulk copy (TMA) a k-tile on the slot's mbarrier, while the other is
//   used, laid out once per engine as bilstm.cu takes them
//   (ops/rnn_cuda.py:kernel_layout).
// - x_{t+1} lands in A by 4-byte cp.async in U / 4 pieces, one per h
//   k-tile; h_t is stored after the next step's first barrier: one block
//   barrier a k-tile, (Kx + U) / 4 a step.
// What this costs (PERF.md): one block barrier a 4-row k-tile, 384 a step
// at U = 512, F = 1024; one CTA an SM (216 KiB), 16 warps; 4096 rows run
// 512 CTAs in four waves, each CTA reading all the weights every step.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "bilstm_cell.cuh"
#include "bilstm_units.cuh"

namespace {

constexpr int kSlots = 2;   // k-tiles in the ring
constexpr int kKT = 4;      // weight rows of a k-tile
constexpr int kR = 16;      // batch rows of a CTA
constexpr int AS = kR + 4;  // A's row stride: a warp's float4 stores of h on distinct banks
constexpr int kMaxUnits = 512;
// every width of the list is one this kernel takes: the U / 2 unit slots
// fill whole warps of 16 slots, and U threads fit the launch bound
#define RV_WIDE_TAKES(u) static_assert((u) % 32 == 0 && (u) <= kMaxUnits, "bilstm_wide: U");
RV_BILSTM_WIDE_UNITS(RV_WIDE_TAKES)
#undef RV_WIDE_TAKES

__global__ void __launch_bounds__(kMaxUnits, 1)
bilstm_wide_kernel(const float* __restrict__ xs,    // [B, T, F]
                   int B, int T, int F, int Kx,     // Kx = F rounded up to 4
                   int U,                           // threads of the CTA (R U / 16)
                   const float4* __restrict__ wxL,  // [2][Kx][U]: gates i, f, g, o of a unit
                   const float4* __restrict__ whL,  // [2][U][U]
                   const float* __restrict__ bias,  // [2, 4U]
                   const float* __restrict__ h0,    // [2, B, U]
                   const float* __restrict__ c0,    // [2, B, U]
                   float* __restrict__ out,         // [B, T, 2U]
                   float* __restrict__ hN,          // [2, B, U]
                   float* __restrict__ cN) {        // [2, B, U]
  const int kThreads = U;
  const int kTile = kKT * U;  // float4s of a k-tile
  const int kHT = U / kKT;    // h k-tiles a step; x_{t+1} lands in as many pieces
  const int kHalf = U / 2;    // a thread's units u and u + kHalf
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kSlots];                // k-tile landed in slot s
  float4* ring = reinterpret_cast<float4*>(smem);  // [kSlots][kKT][U] weight k-tiles
  float* A = smem + 4 * kSlots * kTile;            // [Kx + U][AS]: x_t, then h_{t-1}
  float* C = A + (Kx + U) * AS;                    // [2][8][kThreads]: each thread's c

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int b0 = blockIdx.x * kR;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int u = 16 * w + (lane & 15);  // units u and u + kHalf
  const int r0 = 8 * (lane >> 4);      // rows r0 .. r0 + 7 of the tile
  const int nx = Kx / kKT;             // x k-tiles a step
  const int NT = nx + kHT;             // k-tiles a step
  const float4* wx_d = wxL + (size_t)d * Kx * U;
  const float4* wh_d = whL + (size_t)d * U * U;
  const float* bd = bias + d * 4 * U;
  auto c_at = [&](int q, int i) -> float& { return C[(q * 8 + i) * kThreads + tid]; };

  // k-tile j of a step: rows [kKT j, kKT j + kKT) of A and of [Wx; Wh]
  auto issue_tile = [&](int j, int slot) {  // by thread 0
    const float4* src = j < nx ? wx_d + (size_t)kKT * j * U : wh_d + (size_t)kKT * (j - nx) * U;
    bulk_copy(ring + slot * kTile, src, 16u * kTile, &bars[slot]);
  };
  // piece p of x_t into A's rows [0, F) (transposed, 4 bytes a copy): the
  // thread's elements e = tid + m * kThreads of the row-major [R, F] tile,
  // m in piece p's share of [0, M); (r, k) is element e's place, carried
  // from piece to piece
  const int M = (kR * F + kThreads - 1) / kThreads;
  const int dr = kThreads / F, dk = kThreads - dr * F;
  auto issue_x = [&](int t, int p, int& m, int& r, int& k) {
    for (const int end = ((p + 1) * M + kHT - 1) / kHT; m < end; ++m) {
      if (r < kR && b0 + r < B) cp_async4(A + k * AS + r, xs + ((size_t)(b0 + r) * T + t) * F + k);
      r += dr;
      k += dk;
      if (k >= F) { k -= F; ++r; }
    }
  };

  // A zero: x's columns past F and the rows past B stay zero
  for (int i = tid; i < (Kx + U) * AS; i += kThreads) A[i] = 0.f;
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = b0 + r0 + i;
      const size_t s = ((size_t)d * B + row) * U + u + kHalf * q;
      c_at(q, i) = row < B ? c0[s] : 0.f;
      A[(Kx + u + kHalf * q) * AS + r0 + i] = row < B ? h0[s] : 0.f;
    }
  {
    int m = 0, r = tid / F, k = tid - (tid / F) * F;
    for (int p = 0; p < kHT; ++p) issue_x(d == 0 ? 0 : T - 1, p, m, r, k);
    cp_async_commit();
  }
  if (tid == 0) issue_tile(0, 0);

  float hp[2][8];  // h_t until its store into A
  int n = 0;       // k-tiles used so far: k-tile n lies in slot n % 2, phase n / 2 of its barrier
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const bool more = step + 1 < T;
    int xm = 0, xr = tid / F, xk = tid - (tid / F) * F;  // x_{t+1}'s next element

    float acc[2][4][8];
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float bv = __ldg(bd + gate * U + u + kHalf * q);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[q][gate][i] = bv;
      }

#pragma unroll 1
    for (int j = 0; j < NT; ++j, ++n) {
      mbar_wait(&bars[n & 1], (n >> 1) & 1);
      cp_async_wait_all();
      __syncthreads();  // k-tile j (and x_t) landed; every warp is done with k-tile j - 1
      if (j == 0 && step > 0) {  // every read of h_{t-1}'s predecessor is done
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float4* hd = reinterpret_cast<float4*>(A + (Kx + u + kHalf * q) * AS + r0);
          hd[0] = make_float4(hp[q][0], hp[q][1], hp[q][2], hp[q][3]);
          hd[1] = make_float4(hp[q][4], hp[q][5], hp[q][6], hp[q][7]);
        }
      }
      if (j >= nx && more) {
        issue_x(d == 0 ? step + 1 : T - 2 - step, j - nx, xm, xr, xk);
        cp_async_commit();
      }
      if (tid == 0) {
        if (j + 1 < NT) issue_tile(j + 1, (n + 1) & 1);
        else if (more) issue_tile(0, (n + 1) & 1);
      }
      fma_rows<kKT, AS>(acc, A + kKT * j * AS + r0, ring + (n & 1) * kTile + u, U);
    }

#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float& c = c_at(q, i);
        float cv = c;
        lstm_cell(acc[q][0][i], acc[q][1][i], acc[q][2][i], acc[q][3][i], cv, hp[q][i]);
        c = cv;
        const int row = b0 + r0 + i;
        if (row < B) {
          out[((size_t)row * T + t) * (2 * U) + d * U + u + kHalf * q] = hp[q][i];
          if (!more) {
            const size_t s = ((size_t)d * B + row) * U + u + kHalf * q;
            hN[s] = hp[q][i];
            cN[s] = cv;
          }
        }
      }
  }
}

// Shared memory of one CTA of U units for an input padded to Kx columns:
// the ring, A and c.
size_t smem_bytes(int U, int Kx) {
  return 16 * (size_t)kSlots * kKT * U + 4 * (size_t)(Kx + U) * AS + 4 * (size_t)U * kR;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). U one of
// RV_BILSTM_WIDE_UNITS (bilstm_units.cuh); the other arguments as
// rv_bilstm_layer's (bilstm.cu): xs [B, T, F] f32 (F <= 2U); Kx = F rounded
// up to 4; wxL [2, Kx, U, 4], whL [2, U, U, 4] (ops/rnn_cuda.py:
// kernel_layout), 16-byte aligned; bias [2, 4U]; h0, c0, hN, cN [2, B, U];
// out [B, T, 2U].
extern "C" int rv_bilstm_layer_wide(const float* xs, int B, int T, int F, int Kx, int U,
                                    const void* wxL, const void* whL, const float* bias,
                                    const float* h0, const float* c0, float* out, float* hN,
                                    float* cN, void* stream) {
  if (!rv_bilstm_wide_compiled(U) || B <= 0 || T <= 0 || F <= 0 || F > 2 * U ||
      Kx != (F + 3) / 4 * 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(U, Kx);
  cudaError_t e = cudaFuncSetAttribute(bilstm_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + kR - 1) / kR, 2);
  bilstm_wide_kernel<<<grid, U, smem, (cudaStream_t)stream>>>(
      xs, B, T, F, Kx, U, static_cast<const float4*>(wxL), static_cast<const float4*>(whL), bias,
      h0, c0, out, hN, cN);
  return (int)cudaGetLastError();
}

// What a CTA of the layer takes at U units and Kx padded input columns, into
// info: threads, dynamic shared memory bytes, batch rows, registers a thread
// and local memory bytes a thread (cudaFuncGetAttributes). Returns a
// cudaError_t; refuses what rv_bilstm_layer_wide refuses.
extern "C" int rv_bilstm_layer_wide_cta(int U, int Kx, int* info) {
  if (!rv_bilstm_wide_compiled(U) || Kx <= 0 || Kx % 4 != 0 || Kx > 2 * U)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, bilstm_wide_kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = U;
  info[1] = (int)smem_bytes(U, Kx);
  info[2] = kR;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}
