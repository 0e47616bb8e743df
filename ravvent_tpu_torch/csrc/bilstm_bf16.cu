// One bidirectional LSTM layer on a bf16 stream, the whole time loop in one
// launch, on the tensor cores.
//
// Replaces the bf16 stream of the TPU kernel
// ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel (entry point
// run_bidi_lstm_pallas with a bf16 input): bf16 x, Wx and Wh, f32 bias, f32
// state and accumulation, z = dot(x, Wx) + dot(bf16(h), Wh) + b, keras
// LSTMCell (gates i, f, g, o), bf16 outputs bf16(h), f32 final states. The
// forward direction runs t = 0..T-1, the backward direction t = T-1..0;
// outputs are time-aligned. On the TPU the time axis is a sequential grid
// dimension; here it is a loop inside the CTA.
//
// What bounds it on the H100: the bf16 products, 2*(F+U)*4U flops per row,
// step and direction, at 989 TFLOP/s dense; the bytes (x read once, outputs
// written once) are below that. But a step is a chain (h_t needs all of
// h_{t-1}), so what sets the time is each step's latency.
//
// What the previous design's step spent (tools/bilstm_phases.py, clock64()
// per warp, cycles a step at B = 4096, H100): raw layer 0 (F = 1) 21.5k, of
// which the cell 14.6k (IEEE expf, division and tanhf on 32 (row, unit)
// pairs a thread, 2 warps a sub-partition to hide their latency), h.Wh
// 3.6k, x.Wx 1.9k, x_t's synchronous load 1.4k; raw layer 1 (F = 256)
// 49.3k, of which x.Wx 23.2k (16 rounds of L2 latency: Wx read by 4-byte
// __ldg, one k-tile at a time), the cell 14.6k, x_t's load 7.7k. Its second
// barrier cost nothing.
//
// Design: one CTA per (direction, tile of 16*MT batch rows), U / 8 warps
// for U = 32, 64, 96, 128, 192 or 256 units (a template on U, a multiple of
// 16, so that h.Wh runs U / 16 k-tiles; bilstm_units.cuh lists the widths,
// and the C entry refuses any other), warp w owning units [8w, 8w + 8) of
// all four gates, so the i, f, g, o sums of a (row, unit) land in one thread
// and the cell needs no exchange; at U = 128, 4 warps a sub-partition hide
// the cell's and the products' latencies.
// - The grid fits the card: the C entry picks the fewest rows a CTA (16,
//   32, 48 or 64) with which 2*ceil(B / rows) CTAs fit the SMs in one wave
//   (2858 rows: 120 CTAs of 48). Past 128 units a CTA is 24 warps (U = 192),
//   768 threads at 80 registers, or 32 (U = 256), 1024 threads at 64: one
//   m-tile's 16 accumulators fit beside the streamed B fragments and no
//   more (at 256 units one m-tile already takes all 64), so 16 rows a CTA,
//   and 4096 rows run 512 CTAs in four waves.
// - The weights come in mma-fragment order, made once per engine
//   (ops/rnn_cuda.py:kernel_layout): for warp w, k-tile kt and gate, lane l's
//   B fragment is one 8-byte word, a warp's 32 words 256 contiguous bytes.
//   Wh (U^2 / 128 KiB: 8 KiB at U = 32, 32 at 64, 72 at 96, 128 at 128)
//   stays in shared memory up to 128 units; Wx stays there too for F <= 16,
//   else is read from L2 by coalesced loads, two k-tiles in flight, the
//   first two issued at the step's start so that they land during h.Wh. At
//   U = 192 and 256 Wh is 288 and 512 KiB a direction, past shared memory:
//   its k-tiles stream from L2 by the same two-in-flight loads, ahead of
//   Wx's in one sequence (a simple design; a cluster that splits the units
//   and trades bf16(h) through distributed shared memory would keep it on
//   chip).
// - bf16(h) lives in shared memory in A-fragment order: warp w's cell output
//   for m-tile mt is half of lane l's A fragment of k-tile w / 2, and an A
//   fragment is one 16-byte load.
// - x_{t+1} lands in a second buffer while step t runs (cp.async for F a
//   multiple of 8, registers stored after the cell for F <= 16), issued
//   after the products so that its misses do not queue ahead of Wx's loads:
//   one block barrier a step.
// - The cell runs on ex2.approx and rcp.approx (__expf, __fdividef) in f32,
//   eight of them a (row, unit) where sigmoid and tanh one by one take ten
//   (lstm_cell, bilstm_cell.cuh): these run 16 a clock an SM and set the cell's time.
//   PERF.md records the error this adds.
// What bounds a step now (PERF.md): the cell at the SFU's rate, h.Wh at
// mma.sync's, and on a wide input x.Wx at L2's rate for Wx (every CTA reads
// all of it each step: 33.5 MB a step at 4096 rows).
//
// Timing build (-DRV_BILSTM_PHASES, tools/bilstm_phases.py): lane 0 of each
// warp sums clock64() cycles per phase of the step and writes them at the
// end; the production build compiles none of it. At U = 256 h.Wh streams
// with x.Wx, so its cycles fall in phase x_wx+x_issue.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "bilstm_cell.cuh"
#include "bilstm_units.cuh"

namespace {

constexpr int kSmallK = 16;        // Wx stays in shared memory for F <= 16 (one k-tile)

// the most m-tiles (16 rows) a CTA: 4, or 1 past 128 units, whose 768 (U =
// 192) or 1024 (U = 256) threads have 80 or 64 registers each
__host__ __device__ constexpr int max_mtiles(int U) { return U > 128 ? 1 : 4; }

constexpr int kPhases = 6;
#ifdef RV_BILSTM_PHASES
// the phases' names, by stamp index, for tools/bilstm_phases.py
#define RV_BILSTM_PHASE_NAMES "wx_first_loads,x_wx+x_issue,h_wh,cell,stores+x_land,barrier"
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

template <int U, int MT, bool kWxSmem>
__global__ void __launch_bounds__(4 * U, 1)
bilstm_bf16_kernel(const bf16* __restrict__ xs,      // [B, T, F]
                   int B, int T, int F, int Kx,
                   const uint2* __restrict__ wxF,    // [2][U/8 warps][Kx/16][4 gates][32 lanes]
                   const uint2* __restrict__ whF,    // [2][U/8 warps][U/16][4 gates][32 lanes]
                   const float* __restrict__ bias,   // [2, 4U]
                   const float* __restrict__ h0,     // [2, B, U]
                   const float* __restrict__ c0,     // [2, B, U]
                   bf16* __restrict__ out,           // [B, T, 2U]
                   float* __restrict__ hN,           // [2, B, U]
                   float* __restrict__ cN            // [2, B, U]
                   RV_PHASES_ARG) {
  constexpr int R = 16 * MT;          // batch rows of the CTA
  constexpr int kWarps = U / 8;       // warp w owns units [8w, 8w + 8) of all four gates
  constexpr int kThreads = 32 * kWarps;
  constexpr int kHT = U / 16;         // k-tiles of h.Wh; warp w's units are half of k-tile w / 2
  constexpr bool kWhSmem = U <= 128;  // Wh in shared memory, else streamed from L2
  extern __shared__ __align__(16) float smem[];
  const int Kw = kWxSmem ? kSmallK : Kx;  // a constant on the small path (the C entry checks)
  const int KT = Kw / 16, XS = Kw + 8;    // x row stride: an A fragment's 8 rows, distinct banks
  uint2* whs = reinterpret_cast<uint2*>(smem);  // [kWarps][kHT][4][32] Wh fragments (kWhSmem)
  // [2][MT][kHT][32] bf16(h), in A-fragment order
  uint4* hs = reinterpret_cast<uint4*>(whs + (kWhSmem ? kWarps * kHT * kFrag : 0));
  uint2* wxs = reinterpret_cast<uint2*>(hs + 2 * MT * kHT * 32);  // [kWarps][1][4][32] (kWxSmem)
  bf16* xsm = reinterpret_cast<bf16*>(wxs + (kWxSmem ? kWarps * kFrag : 0));  // [2][R][XS]

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int b0 = blockIdx.x * R;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group and column pair
  const int ubase = 8 * w;
  const uint2* wx_d = wxF + (size_t)d * kWarps * KT * kFrag;
  const uint2* wx_w = (kWxSmem ? wxs : wx_d) + w * KT * kFrag + lane;  // this lane's words
  const uint2* wh_d = whF + (size_t)d * kWarps * kHT * kFrag;
  const uint2* wh_w = (kWhSmem ? whs : wh_d) + w * kHT * kFrag + lane;
  const float* bd = bias + d * 4 * U;
  // The k-tiles whose Wh or Wx fragments stream from L2, in order: h.Wh's
  // where Wh is not in shared memory, then x.Wx's where Wx is not. Streamed
  // k-tile j's A fragment of m-tile mt comes from bf16(h) or from the x
  // tile xc, its B fragments from src(j).
  constexpr int nh = kWhSmem ? 0 : kHT;
  const int NS = nh + (kWxSmem ? 0 : KT);
  auto src = [&](int j) { return j < nh ? wh_w + j * kFrag : wx_w + (j - nh) * kFrag; };
  auto a_frag = [&](const uint4* hc, const bf16* xc, int j, int mt) {
    return j < nh ? hc[(mt * kHT + j) * 32] : x_frag(xc, XS, mt, j - nh, g, tg);
  };

  {
    uint4* whs4 = reinterpret_cast<uint4*>(whs);
    if (kWhSmem)
      for (int i = tid; i < kWarps * kHT * kFrag / 2; i += kThreads)
        cp_async16(whs4 + i, reinterpret_cast<const uint4*>(wh_d) + i);
    if (kWxSmem)
      for (int i = tid; i < kWarps * kFrag / 2; i += kThreads)
        cp_async16(reinterpret_cast<uint4*>(wxs) + i, reinterpret_cast<const uint4*>(wx_d) + i);
    cp_async_commit();
    uint4* xz = reinterpret_cast<uint4*>(xsm);  // both x buffers zero: padding rows and columns
    for (int i = tid; i < 2 * R * XS / 8; i += kThreads) xz[i] = make_uint4(0u, 0u, 0u, 0u);
  }

  // x_t of the tile into buffer buf: on a wide input (F a multiple of 8) by
  // cp.async (committed here, waited for by the caller), 16-byte piece i of
  // the tile at row i / per, piece i % per, each thread walking its pieces
  // kThreads apart; for F <= 16 element by element through the registers xr
  auto issue_x = [&](int buf, int t) {
    const int per = F / 8, dr = kThreads / per, dk = kThreads - dr * per;
    int r = tid / per, k8 = tid - r * per;
    for (int i = tid; i < R * per; i += kThreads) {
      const int row = b0 + r;
      if (row < B)
        cp_async16(xsm + (buf * R + r) * XS + 8 * k8, xs + ((size_t)row * T + t) * F + 8 * k8);
      r += dr;
      k8 += dk;
      if (k8 >= per) { k8 -= per; ++r; }
    }
    cp_async_commit();
  };
  constexpr int kXR = (16 * MT * kSmallK + kThreads - 1) / kThreads;  // x elements a thread carries
  auto load_xr = [&](bf16 (&xr)[kXR], int t) {
#pragma unroll
    for (int i = 0; i < kXR; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSmallK, k = e % kSmallK;
      const int row = b0 + r;
      xr[i] = (r < R && row < B && k < F) ? xs[((size_t)row * T + t) * F + k]
                                          : __float2bfloat16_rn(0.f);
    }
  };
  auto store_xr = [&](const bf16 (&xr)[kXR], int buf) {
#pragma unroll
    for (int i = 0; i < kXR; ++i) {
      const int e = tid + i * kThreads;
      if (e < R * kSmallK) xsm[(buf * R + e / kSmallK) * XS + e % kSmallK] = xr[i];
    }
  };
  bf16 xr[kXR];
  __syncthreads();  // the x buffers are zero
  if (kWxSmem) {
    load_xr(xr, d == 0 ? 0 : T - 1);
    store_xr(xr, 0);
  } else {
    issue_x(0, d == 0 ? 0 : T - 1);
  }

  // Thread-owned (row, unit) pairs: row 16*mt + g + 8*hf, unit ubase + 2*tg + q,
  // element 2*hf + q of an accumulator tile; the h tile holds them as words
  // 2*(w & 1) + hf of the lane's A fragment of (mt, k-tile w / 2).
  float c[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t hw[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float hv[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int row = b0 + 16 * mt + g + 8 * hf, u = ubase + 2 * tg + q;
        const size_t s = ((size_t)d * B + row) * U + u;
        c[mt][2 * hf + q] = row < B ? c0[s] : 0.f;
        hv[q] = row < B ? h0[s] : 0.f;
      }
      hw[hf] = pack_bf16(hv[0], hv[1]);
    }
    reinterpret_cast<uint2*>(hs + (mt * kHT + (w >> 1)) * 32 + lane)[w & 1] = make_uint2(hw[0], hw[1]);
  }
  cp_async_wait_all();
  __syncthreads();  // the weights, x_0 and bf16(h_0) are in shared memory

  int cur = 0;
  RV_PHASES_INIT;
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const bool more = step + 1 < T;
    uint2 bx[2][4];  // streamed k-tiles in flight (NS > 0: at least 2 k-tiles)
    if (NS > 0) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) bx[s][gate] = __ldg(src(s) + gate * 32);
    }
    RV_STAMP(0);

    float acc[4][MT][4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
      const float2 bv = __ldg(reinterpret_cast<const float2*>(bd + gate * U + ubase + 2 * tg));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[gate][mt][0] = bv.x; acc[gate][mt][1] = bv.y;
        acc[gate][mt][2] = bv.x; acc[gate][mt][3] = bv.y;
      }
    }

    const uint4* hc = hs + cur * MT * kHT * 32 + lane;
#pragma unroll 1
    for (int kt = 0; kt < (kWhSmem ? kHT : 0); ++kt) {
      uint2 b[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) b[gate] = wh_w[(kt * 4 + gate) * 32];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a = hc[(mt * kHT + kt) * 32];
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) mma_bf16(acc[gate][mt], a, b[gate]);
      }
    }
    RV_STAMP(2);

    const bf16* xc = xsm + cur * R * XS;
#pragma unroll 1
    for (int j = 0; j < NS; j += 2) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a = a_frag(hc, xc, j, mt);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) mma_bf16(acc[gate][mt], a, bx[0][gate]);
      }
      if (j + 2 < NS) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) bx[0][gate] = __ldg(src(j + 2) + gate * 32);
      }
      if (j + 1 < NS) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4 a = a_frag(hc, xc, j + 1, mt);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) mma_bf16(acc[gate][mt], a, bx[1][gate]);
        }
        if (j + 3 < NS) {
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) bx[1][gate] = __ldg(src(j + 3) + gate * 32);
        }
      }
    }
    if (kWxSmem) {
      uint2 b[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) b[gate] = wx_w[gate * 32];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint4 a = x_frag(xc, XS, mt, 0, g, tg);
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) mma_bf16(acc[gate][mt], a, b[gate]);
      }
    }
    // x_{t+1} into the other buffer, for the next step: issued after the
    // products so that its misses do not queue ahead of Wx's loads, and
    // landed by the end of the cell
    if (more) {
      if (kWxSmem) load_xr(xr, d == 0 ? step + 1 : T - 2 - step);
      else issue_x(cur ^ 1, d == 0 ? step + 1 : T - 2 - step);
    }
    RV_STAMP(1);

    uint32_t hp[MT][2];  // bf16(h) pairs, [mt][hf]
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float hv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int e = 2 * hf + q;
          lstm_cell(acc[0][mt][e], acc[1][mt][e], acc[2][mt][e], acc[3][mt][e], c[mt][e], hv[q]);
        }
        hp[mt][hf] = pack_bf16(hv[0], hv[1]);
        if (!more) {
          const int row = b0 + 16 * mt + g + 8 * hf;
          if (row < B) {
            const size_t s = ((size_t)d * B + row) * U + ubase + 2 * tg;
            *reinterpret_cast<float2*>(hN + s) = make_float2(hv[0], hv[1]);
            *reinterpret_cast<float2*>(cN + s) = make_float2(c[mt][2 * hf], c[mt][2 * hf + 1]);
          }
        }
      }
    RV_STAMP(3);

    uint4* hn = hs + (cur ^ 1) * MT * kHT * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      reinterpret_cast<uint2*>(hn + (mt * kHT + (w >> 1)) * 32)[w & 1] =
          make_uint2(hp[mt][0], hp[mt][1]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = b0 + 16 * mt + g + 8 * hf;
        if (row < B)
          *reinterpret_cast<uint32_t*>(out + ((size_t)row * T + t) * (2 * U) + d * U + ubase +
                                       2 * tg) = hp[mt][hf];
      }
    }
    if (more) {
      if (kWxSmem) store_xr(xr, cur ^ 1);
      else cp_async_wait_all();
    }
    RV_STAMP(4);
    __syncthreads();  // bf16(h_t) and x_{t+1} are in place; this step's reads are done
    RV_STAMP(5);
    cur ^= 1;
  }
  RV_PHASES_STORE;
}

// Shared memory of one CTA of 16*mt rows of U units for an input padded to
// Kx columns.
size_t smem_bytes(int U, int mt, bool wx_smem, int Kx) {
  const size_t warps = U / 8, kht = U / 16;
  return 8 * ((U <= 128 ? warps * kht * kFrag : 0) + (wx_smem ? warps * kFrag : 0)) +
         16 * (size_t)2 * mt * kht * 32 + 2 * (size_t)2 * 16 * mt * (Kx + 8);
}

template <int U, int MT, bool kWxSmem>
int launch(const void* xs, int B, int T, int F, int Kx, const void* wxF, const void* whF,
           const float* bias, const float* h0, const float* c0, void* out, float* hN, float* cN
           RV_PHASES_ARG, cudaStream_t stream) {
  auto kern = bilstm_bf16_kernel<U, MT, kWxSmem>;
  const size_t smem = smem_bytes(U, MT, kWxSmem, Kx);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + 16 * MT - 1) / (16 * MT), 2);
  kern<<<grid, 4 * U, smem, stream>>>(
      static_cast<const bf16*>(xs), B, T, F, Kx, static_cast<const uint2*>(wxF),
      static_cast<const uint2*>(whF), bias, h0, c0, static_cast<bf16*>(out), hN, cN RV_PHASES_PASS);
  return (int)cudaGetLastError();
}

// The fewest m-tiles a CTA (1 up to max_mtiles(U)) with which both
// directions' CTAs fit the SMs at once; the most where none does.
template <int U, bool kWxSmem>
int launch_rows(int sms, const void* xs, int B, int T, int F, int Kx, const void* wxF,
                const void* whF, const float* bias, const float* h0, const float* c0, void* out,
                float* hN, float* cN RV_PHASES_ARG, cudaStream_t stream) {
  int mt = 1;
  while (mt < max_mtiles(U) && 2 * ((B + 16 * mt - 1) / (16 * mt)) > sms) ++mt;
  if constexpr (max_mtiles(U) >= 4) {
    switch (mt) {
      case 2: return launch<U, 2, kWxSmem>(xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN RV_PHASES_PASS, stream);
      case 3: return launch<U, 3, kWxSmem>(xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN RV_PHASES_PASS, stream);
      case 4: return launch<U, 4, kWxSmem>(xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN RV_PHASES_PASS, stream);
    }
  }
  return launch<U, 1, kWxSmem>(xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN RV_PHASES_PASS, stream);
}

template <int U>
int launch_units(int sms, const void* xs, int B, int T, int F, int Kx, const void* wxF,
                 const void* whF, const float* bias, const float* h0, const float* c0, void* out,
                 float* hN, float* cN RV_PHASES_ARG, cudaStream_t stream) {
  if (Kx <= kSmallK)
    return launch_rows<U, true>(sms, xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN
                                RV_PHASES_PASS, stream);
  return launch_rows<U, false>(sms, xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN
                               RV_PHASES_PASS, stream);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). U one of
// RV_BILSTM_UNITS (bilstm_units.cuh); xs [B, T, F] bf16 (F <= 16, or a
// multiple of 8 up to 2U, 16-byte aligned); Kx = F rounded up to 16; wxF,
// whF the weights in fragment order (ops/rnn_cuda.py:kernel_layout); bias
// [2, 4U] f32; h0, c0 [2, B, U] f32; out [B, T, 2U] bf16; hN, cN [2, B, U]
// f32.
#ifdef RV_BILSTM_PHASES
extern "C" const char* rv_bilstm_phase_names() { return RV_BILSTM_PHASE_NAMES; }
extern "C" int rv_bilstm_layer_bf16_phases(const void* xs, int B, int T, int F, int Kx, int U,
                                           const void* wxF, const void* whF, const float* bias,
                                           const float* h0, const float* c0, void* out,
                                           float* hN, float* cN, long long* stamps,
                                           void* stream) {
#else
extern "C" int rv_bilstm_layer_bf16(const void* xs, int B, int T, int F, int Kx, int U,
                                    const void* wxF, const void* whF, const float* bias,
                                    const float* h0, const float* c0,
                                    void* out, float* hN, float* cN, void* stream) {
#endif
  if (!rv_bilstm_compiled(U) || B <= 0 || T <= 0 || F <= 0 || F > 2 * U ||
      Kx != (F + 15) / 16 * 16 || (F > kSmallK && F % 8 != 0))  // F <= 16, or a multiple of 8
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = (cudaStream_t)stream;
  switch (U) {  // one case a compiled width (bilstm_units.cuh)
#define RV_UNIT_CASE(u) \
    case u: return launch_units<u>(sms, xs, B, T, F, Kx, wxF, whF, bias, h0, c0, out, hN, cN RV_PHASES_PASS, s);
    RV_BILSTM_UNITS(RV_UNIT_CASE)
#undef RV_UNIT_CASE
  }
  return (int)cudaErrorInvalidValue;
}
