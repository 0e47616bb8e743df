// One bidirectional LSTM layer on an f32 stream, the whole time loop in one
// launch.
//
// Replaces the TPU kernel ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel
// (entry point run_bidi_lstm_pallas) with an f32 input. Same math as that
// kernel and as the scan path models/rnn.py::run_bidi_layer: keras
// LSTMCell, gates i,f,g,o, z = x.Wx + h.Wh + b, sigmoid/tanh, f32 state and
// products. The forward direction runs t = 0..T-1, the backward direction
// t = T-1..0; outputs are time-aligned. On the TPU the time axis is a
// sequential grid dimension; here it is a loop inside the CTA.
//
// What bounds it on the H100: the f32 products, 2*(F+U)*4U flops per row,
// step and direction, on the FMA pipe (67 TFLOP/s: f32 has no tensor-core
// path of the same precision); the bytes (x read once, outputs written
// once) are far below that. So the design aims at the FMA pipe's issue
// rate, with every SM busy.
//
// What the previous design's step spent (tools/bilstm_phases.py --stream
// f32, clock64() per warp, cycles a step at B = 4096, H100): one CTA of 16
// rows per direction and 8 warps, each thread reading its unit's weights by
// 4-byte __ldg for every k; the products took 87-91% of a step (52k cycles
// for h.Wh, 114k for x.Wx on a wide input: ≈ 400 cycles a k for 32 FMAs a
// thread), and the 512 CTAs of 4096 rows ran in two waves.
//
// Design: one CTA per (direction, tile of R batch rows), U R / 16 threads,
// for U = 32, 64, 96, 128, 192 or 256 units (a template on U, a multiple of
// 16; bilstm_units.cuh lists the widths, and the C entry refuses any other).
// The C entry picks the fewest rows R = 16, 32, ... with which both
// directions' CTAs fit the SMs at once, up to 64 rows for U <= 128 (4096
// rows: 128 CTAs of 64; 2858: 120 of 48) and up to 32 for U = 192 and 256,
// where 64 rows would take 768 or 1024 threads at 85 or 64 registers for the
// 64 accumulators, and A (below) would not fit beside the ring; there 4096
// rows run 256 CTAs of 32 in two waves. A step is one product
// z = [x_t | h_{t-1}] . [Wx; Wh] + b of R rows by 4U columns:
// - Thread (u, r0) owns units u and u + U/2 of rows [r0, r0 + 8): all four
//   gates, 64 accumulators, so the cell needs no exchange. For each k it
//   reads 8 rows of A and the 4 gates of its two units, four float4 loads
//   for 64 FMAs. A warp covers 8 units of 4 row octets (16 of 2 where R / 8
//   is not a multiple of 4): its loads of A read 4 addresses, its loads of
//   the weights 128 contiguous bytes (256 on 2 octets), at every U.
// - A = [x_t | h_{t-1}] lies k-major in shared memory, [Kx + U][R + 4]: the
//   pad puts a warp's float4 stores of h on distinct banks. The cell state c
//   lies there too, so that the registers go to the accumulators.
// - The weights, (F + U) x 4U f32 a direction (768 KiB at U = 128 and F =
//   256, 3 MiB at U = 256 and F = 512), exceed shared memory, so they stream
//   through a ring of two k-tiles of 16 rows (U KiB / 4 each: 8 KiB at U =
//   32, 32 KiB at 128, 48 KiB at 192, where A at Kx = 384 and R = 32, 81 KiB,
//   and c, 24 KiB, fit beside the ring's 96 KiB, and at R = 64 A's 153 KiB
//   would not; 8 rows at U = 256, 32 KiB each, so that A at Kx = 512 and R =
//   32, 108 KiB, fits beside them): every CTA reads them from L2 once a
//   step, one bulk copy
//   (TMA) a k-tile, asked for by one thread and landing on the slot's
//   mbarrier while the other k-tile is used. They come laid out once per
//   engine (ops/rnn_cuda.py:kernel_layout): row k's 4 gates of a unit are 16
//   adjacent bytes, and a k-tile is contiguous.
// - A step runs the x k-tiles first, then the h k-tiles. x_{t+1} lands in A
//   by 4-byte cp.async (a transposing copy) in one piece per h k-tile, and
//   h_t is stored after the next step's first barrier: one block barrier a
//   k-tile and no other.
// - The cell runs on ex2.approx and rcp.approx in f32 (bilstm_cell.cuh).
// What bounds a step now (PERF.md, U = 128): the FMA pipe, which the
// products' loop (1024 FFMA and 64 LDS.128 a k-tile and warp, no other
// instruction to speak of) keeps at about two thirds of its issue rate, with
// or without its shared-memory loads. At U = 256 every CTA also reads 3 MiB
// of weights from L2 a step.
//
// Timing build (-DRV_BILSTM_PHASES, tools/bilstm_phases.py --stream f32):
// lane 0 of each warp sums clock64() cycles per phase of the step and
// writes them at the end; the production build compiles none of it.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "bilstm_cell.cuh"
#include "bilstm_units.cuh"

namespace {

constexpr int kSlots = 2;  // k-tiles in the ring

// weight rows of a k-tile: 16, or 8 at U = 256, where a k-tile of 4U columns
// is 32 KiB at 8 rows (a k-tile is U / 4 KiB a row octet)
__host__ __device__ constexpr int kt_rows(int U) { return U >= 256 ? 8 : 16; }
// the most rows a CTA: U R / 16 threads of 64 accumulators stay at 512 and
// 128 registers, and A fits beside the ring; 32 past 128 units, where 64 rows
// would be 768 threads (U = 192) or 1024 (U = 256)
__host__ __device__ constexpr int max_rows(int U) { return U > 128 ? 32 : 64; }

constexpr int kPhases = 5;
#ifdef RV_BILSTM_PHASES
// the phases' names, by stamp index, for tools/bilstm_phases.py
#define RV_BILSTM_PHASE_NAMES "wait+barrier,issue+h_store,x_wx,h_wh,cell+out"
#define RV_PHASES_ARG , long long* __restrict__ stamps
#define RV_PHASES_PASS , stamps
#define RV_PHASES_INIT long long ph_[kPhases] = {}; long long last_ = clock64()
#define RV_STAMP(k) do { const long long now_ = clock64(); ph_[k] += now_ - last_; last_ = now_; } while (0)
#define RV_PHASES_STORE                                                                   \
  if ((threadIdx.x & 31) == 0)                                                            \
    for (int k_ = 0; k_ < kPhases; ++k_)                                                  \
      stamps[((blockIdx.y * gridDim.x + blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5)) \
             * kPhases + k_] = ph_[k_]
#else
#define RV_PHASES_ARG
#define RV_PHASES_PASS
#define RV_PHASES_INIT
#define RV_STAMP(k)
#define RV_PHASES_STORE
#endif

template <int U, int R>
__global__ void __launch_bounds__(U * R / 16, 1)
bilstm_kernel(const float* __restrict__ xs,    // [B, T, F]
              int B, int T, int F, int Kx,     // Kx = F rounded up to 4
              const float4* __restrict__ wxL,  // [2][Kx][U]: gates i, f, g, o of a unit
              const float4* __restrict__ whL,  // [2][U][U]
              const float* __restrict__ bias,  // [2, 4U]
              const float* __restrict__ h0,    // [2, B, U]
              const float* __restrict__ c0,    // [2, B, U]
              float* __restrict__ out,         // [B, T, 2U]
              float* __restrict__ hN,          // [2, B, U]
              float* __restrict__ cN           // [2, B, U]
              RV_PHASES_ARG) {
  constexpr int kThreads = U * R / 16;
  constexpr int kKT = kt_rows(U);  // weight rows of a k-tile
  constexpr int kTile = kKT * U;   // float4s of a k-tile
  constexpr int kHT = U / kKT;     // h k-tiles a step; x_{t+1} lands in as many pieces
  constexpr int kHalf = U / 2;     // a thread's units u and u + kHalf
  constexpr int AS = R + 4;        // A's row stride
  extern __shared__ __align__(16) float smem[];
  __shared__ uint64_t bars[kSlots];                // k-tile landed in slot s
  float4* ring = reinterpret_cast<float4*>(smem);  // [kSlots][kKT][U] weight k-tiles
  float* A = smem + 4 * kSlots * kTile;            // [Kx + U][AS]: x_t, then h_{t-1}
  float* C = A + (Kx + U) * AS;                    // [2][8][kThreads]: each thread's c

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int b0 = blockIdx.x * R;
  // a warp covers OW row octets of UW units: its loads of A read OW
  // addresses, of the weights UW * 16 contiguous bytes
  constexpr int OW = (R / 8) % 4 == 0 ? 4 : 2, UW = 32 / OW;
  static_assert(kHalf % UW == 0, "a warp's units tile the unit slots");
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int u = (w % (kHalf / UW)) * UW + lane % UW;         // units u and u + kHalf
  const int r0 = 8 * ((w / (kHalf / UW)) * OW + lane / UW);  // rows r0 .. r0 + 7 of the tile
  const int nx = (Kx + kKT - 1) / kKT;      // x k-tiles a step
  const int NT = nx + kHT;                  // k-tiles a step
  const float4* wx_d = wxL + (size_t)d * Kx * U;
  const float4* wh_d = whL + (size_t)d * U * U;
  const float* bd = bias + d * 4 * U;
  auto c_at = [&](int q, int i) -> float& { return C[(q * 8 + i) * kThreads + tid]; };

  // k-tile j of a step: rows [k0(j), k0(j) + rows(j)) of A and of [Wx; Wh]
  auto rows_of = [&](int j) { return j < nx ? min(kKT, Kx - kKT * j) : kKT; };
  auto k0_of = [&](int j) { return j < nx ? kKT * j : Kx + kKT * (j - nx); };
  auto issue_tile = [&](int j, int slot) {  // by thread 0
    const float4* src = j < nx ? wx_d + (size_t)kKT * j * U : wh_d + (size_t)kKT * (j - nx) * U;
    bulk_copy(ring + slot * kTile, src, 16u * U * rows_of(j), &bars[slot]);
  };
  // piece p of x_t into A's rows [0, F) (transposed, 4 bytes a copy): the
  // thread's elements e = tid + m * kThreads of the row-major [R, F] tile,
  // m in piece p's share of [0, M); (r, k) is element e's place, carried
  // from piece to piece
  const int M = (R * F + kThreads - 1) / kThreads;
  const int dr = kThreads / F, dk = kThreads - dr * F;
  auto issue_x = [&](int t, int p, int& m, int& r, int& k) {
    for (const int end = ((p + 1) * M + kHT - 1) / kHT; m < end; ++m) {
      if (r < R && b0 + r < B) cp_async4(A + k * AS + r, xs + ((size_t)(b0 + r) * T + t) * F + k);
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
  RV_PHASES_INIT;
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
      RV_STAMP(0);
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
      RV_STAMP(1);

      const float4* wt = ring + (n & 1) * kTile + u;
      const float* a = A + k0_of(j) * AS + r0;
      const int rows = rows_of(j);
      if (rows == kKT) {
        fma_rows<kKT, AS>(acc, a, wt, U);
      } else {
#pragma unroll 1
        for (int k = 0; k < rows; k += 4) fma_rows<4, AS>(acc, a + k * AS, wt + k * U, U);
      }
      if (j < nx) RV_STAMP(2);
      else RV_STAMP(3);
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
    RV_STAMP(4);
  }
  RV_PHASES_STORE;
}

// Shared memory of one CTA of R rows of U units for an input padded to Kx
// columns: the ring, A and c.
size_t smem_bytes(int U, int R, int Kx) {
  return 16 * (size_t)kSlots * kt_rows(U) * U + 4 * (size_t)(Kx + U) * (R + 4) + 4 * (size_t)U * R;
}

template <int U, int R>
int launch(const float* xs, int B, int T, int F, int Kx, const void* wxL, const void* whL,
           const float* bias, const float* h0, const float* c0, float* out, float* hN, float* cN
           RV_PHASES_ARG, cudaStream_t stream) {
  auto kern = bilstm_kernel<U, R>;
  const size_t smem = smem_bytes(U, R, Kx);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + R - 1) / R, 2);
  kern<<<grid, U * R / 16, smem, stream>>>(xs, B, T, F, Kx, static_cast<const float4*>(wxL),
                                           static_cast<const float4*>(whL), bias, h0, c0, out, hN,
                                           cN RV_PHASES_PASS);
  return (int)cudaGetLastError();
}

// The fewest rows a CTA (16, 32, ... up to max_rows(U)) with which both
// directions' CTAs fit the SMs at once; the most where none does.
template <int U>
int launch_rows(int sms, const float* xs, int B, int T, int F, int Kx, const void* wxL,
                const void* whL, const float* bias, const float* h0, const float* c0, float* out,
                float* hN, float* cN RV_PHASES_ARG, cudaStream_t s) {
  int R = 16;
  while (R < max_rows(U) && 2 * ((B + R - 1) / R) > sms) R += 16;
  switch (R) {
    case 16: return launch<U, 16>(xs, B, T, F, Kx, wxL, whL, bias, h0, c0, out, hN, cN RV_PHASES_PASS, s);
    case 32: return launch<U, 32>(xs, B, T, F, Kx, wxL, whL, bias, h0, c0, out, hN, cN RV_PHASES_PASS, s);
  }
  if constexpr (max_rows(U) >= 64) {
    if (R == 48) return launch<U, 48>(xs, B, T, F, Kx, wxL, whL, bias, h0, c0, out, hN, cN RV_PHASES_PASS, s);
    return launch<U, 64>(xs, B, T, F, Kx, wxL, whL, bias, h0, c0, out, hN, cN RV_PHASES_PASS, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). U one of
// RV_BILSTM_UNITS (bilstm_units.cuh); xs [B, T, F] f32 (F <= 2U); Kx = F
// rounded up to 4; wxL [2, Kx, U, 4], whL [2, U, U, 4] the weights with each
// row's gate columns grouped by unit, 16-byte aligned
// (ops/rnn_cuda.py:kernel_layout); bias [2, 4U]; h0, c0, hN, cN [2, B, U];
// out [B, T, 2U].
#ifdef RV_BILSTM_PHASES
extern "C" const char* rv_bilstm_phase_names() { return RV_BILSTM_PHASE_NAMES; }
extern "C" int rv_bilstm_layer_phases(const float* xs, int B, int T, int F, int Kx, int U,
                                      const void* wxL, const void* whL, const float* bias,
                                      const float* h0, const float* c0, float* out, float* hN,
                                      float* cN, long long* stamps, void* stream) {
#else
extern "C" int rv_bilstm_layer(const float* xs, int B, int T, int F, int Kx, int U,
                               const void* wxL, const void* whL, const float* bias,
                               const float* h0, const float* c0, float* out, float* hN,
                               float* cN, void* stream) {
#endif
  if (!rv_bilstm_compiled(U) || B <= 0 || T <= 0 || F <= 0 || F > 2 * U ||
      Kx != (F + 3) / 4 * 4)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (U) {  // one case a compiled width (bilstm_units.cuh)
#define RV_UNIT_CASE(u) \
    case u: return launch_rows<u>(sms, xs, B, T, F, Kx, wxL, whL, bias, h0, c0, out, hN, cN RV_PHASES_PASS, s);
    RV_BILSTM_UNITS(RV_UNIT_CASE)
#undef RV_UNIT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
