// One bidirectional LSTM layer on a bf16 stream past 256 units, the whole
// time loop in one launch, on the tensor cores.
//
// Replaces the bf16 stream of the TPU kernel
// ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel (run_bidi_lstm_pallas with
// a bf16 input) at the widths of RV_BILSTM_WIDE_UNITS (bilstm_units.cuh:
// 320, 384, 448 and 512 units); the narrower ones run bilstm_bf16.cu. Same
// math as that kernel and as bilstm_bf16.cu: bf16 x, Wx and Wh, f32 bias,
// state and accumulation, z = dot(x, Wx) + dot(bf16(h), Wh) + b, keras
// LSTMCell (gates i, f, g, o) on the cell of bilstm_cell.cuh, bf16 outputs,
// f32 final states, the backward direction on x[T-1-t], time-aligned
// outputs.
//
// What bounds it on the H100: the bf16 products, 2*(F+U)*4U flops per row,
// step and direction, at 989 TFLOP/s dense, and each step's latency (h_t
// needs all of h_{t-1}). Wh and Wx, (F + U) x 4U bf16 a direction (up to 6
// MiB at U = 512, F = 1024), stay in no CTA's shared memory: every CTA
// reads them from L2 every step, 16 flops a byte at 32 rows a CTA, so L2's
// rate for them bounds it too.
//
// Design: bilstm_bf16.cu's streamed path with more units a warp. One CTA
// per (direction, tile of 32 batch rows, two m-tiles), U / 32 warps (U a
// runtime argument, a multiple of 32, at most 512, in one instance):
// - Warp w runs its units in four passes, pass p over the 8 units of octet
//   w + p U / 32, of all four gates: the i, f, g, o sums of a (row, unit)
//   land in one thread and the cell needs no exchange, and a pass holds 32
//   accumulators, as bilstm_bf16.cu holds at two m-tiles. A pass streams its
//   octet's Wh k-tiles, then its Wx k-tiles, from L2 (the fragment order of
//   ops/rnn_cuda.py:kernel_layout, one 8-byte word a lane, two k-tiles in
//   flight), runs the cell for its units, and writes their bf16(h_t) into
//   the second h buffer: later passes of the step still read h_{t-1} from
//   the first. The c of the four passes stays in registers.
// - bf16(h) lives in shared memory in A-fragment order, as in
//   bilstm_bf16.cu; x_t in a row-major tile, x_{t+1} landing in a second
//   buffer during the step (cp.async for F a multiple of 8; through the
//   registers for F <= 16): one block barrier a step.
// What this costs (PERF.md): every CTA reads all the weights from L2 every
// step (4096 rows: 256 CTAs, 1.5 GiB a step at U = 512, F = 1024), each
// k-tile a round of L2 latency with two in flight, four passes one after
// another; one CTA an SM (up to 512 threads at 128 registers).
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "bilstm_cell.cuh"
#include "bilstm_units.cuh"

namespace {

constexpr int kMT = 2;          // m-tiles (16 rows) a CTA
constexpr int kR = 16 * kMT;    // batch rows of a CTA
constexpr int kPasses = 4;      // unit octets a warp
constexpr int kSmallK = 16;     // F <= 16: x_t loaded through the registers
constexpr int kMaxUnits = 512;  // 16 warps
constexpr int kMinUnits = 320;  // 10 warps
constexpr int kXR = (kR * kSmallK + kMinUnits - 1) / kMinUnits;  // x elements a thread
// every width of the list is one this kernel takes: U / 32 warps of four
// 8-unit passes, within the launch bound and x's register share
#define RV_WIDE_TAKES(u) \
  static_assert((u) % 32 == 0 && (u) >= kMinUnits && (u) <= kMaxUnits, "bilstm_bf16_wide: U");
RV_BILSTM_WIDE_UNITS(RV_WIDE_TAKES)
#undef RV_WIDE_TAKES

__global__ void __launch_bounds__(kMaxUnits, 1)
bilstm_bf16_wide_kernel(const bf16* __restrict__ xs,     // [B, T, F]
                        int B, int T, int F, int Kx,     // Kx = F rounded up to 16
                        int U,                           // units: U / 32 warps
                        const uint2* __restrict__ wxF,   // [2][U/8 octets][Kx/16][4 gates][32 lanes]
                        const uint2* __restrict__ whF,   // [2][U/8 octets][U/16][4 gates][32 lanes]
                        const float* __restrict__ bias,  // [2, 4U]
                        const float* __restrict__ h0,    // [2, B, U]
                        const float* __restrict__ c0,    // [2, B, U]
                        bf16* __restrict__ out,          // [B, T, 2U]
                        float* __restrict__ hN,          // [2, B, U]
                        float* __restrict__ cN) {        // [2, B, U]
  const int nW = U / 32;           // warps; warp w owns octets w + nW p, p < kPasses
  const int kThreads = 32 * nW;
  const int kHT = U / 16;          // k-tiles of h.Wh; octet o's units are half of k-tile o / 2
  const int KT = Kx / 16;          // k-tiles of x.Wx
  const int NS = kHT + KT;         // k-tiles a pass streams
  const int XS = Kx + 8;           // x row stride: an A fragment's 8 rows, distinct banks
  extern __shared__ __align__(16) float smem[];
  uint4* hs = reinterpret_cast<uint4*>(smem);  // [2][kMT][kHT][32] bf16(h), A-fragment order
  bf16* xsm = reinterpret_cast<bf16*>(hs + 2 * kMT * kHT * 32);  // [2][kR][XS]

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int b0 = blockIdx.x * kR;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group and column pair
  const uint2* wx_d = wxF + (size_t)d * (U / 8) * KT * kFrag + lane;
  const uint2* wh_d = whF + (size_t)d * (U / 8) * kHT * kFrag + lane;
  const float* bd = bias + d * 4 * U;
  const bool small = Kx <= kSmallK;

  // x_t of the tile into buffer buf: on a wide input (F a multiple of 8) by
  // cp.async (committed here, waited for before the step's barrier), 16-byte
  // piece i of the tile at row i / per, piece i % per; for F <= 16 element
  // by element through the registers xr
  auto issue_x = [&](int buf, int t) {
    const int per = F / 8;
    for (int i = tid; i < kR * per; i += kThreads) {
      const int r = i / per, k8 = i - r * per, row = b0 + r;
      if (row < B)
        cp_async16(xsm + (buf * kR + r) * XS + 8 * k8, xs + ((size_t)row * T + t) * F + 8 * k8);
    }
    cp_async_commit();
  };
  auto load_xr = [&](bf16 (&xr)[kXR], int t) {
#pragma unroll
    for (int i = 0; i < kXR; ++i) {
      const int e = tid + i * kThreads;
      const int r = e / kSmallK, k = e % kSmallK;
      const int row = b0 + r;
      xr[i] = (r < kR && row < B && k < F) ? xs[((size_t)row * T + t) * F + k]
                                           : __float2bfloat16_rn(0.f);
    }
  };
  auto store_xr = [&](const bf16 (&xr)[kXR], int buf) {
#pragma unroll
    for (int i = 0; i < kXR; ++i) {
      const int e = tid + i * kThreads;
      if (e < kR * kSmallK) xsm[(buf * kR + e / kSmallK) * XS + e % kSmallK] = xr[i];
    }
  };

  {
    uint4* xz = reinterpret_cast<uint4*>(xsm);  // both x buffers zero: padding rows and columns
    for (int i = tid; i < 2 * kR * XS / 8; i += kThreads) xz[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  bf16 xr[kXR];
  __syncthreads();  // the x buffers are zero
  if (small) {
    load_xr(xr, d == 0 ? 0 : T - 1);
    store_xr(xr, 0);
  } else {
    issue_x(0, d == 0 ? 0 : T - 1);
  }

  // Thread-owned (row, unit) pairs of pass p: row 16*mt + g + 8*hf, unit
  // 8*o + 2*tg + q (octet o = w + nW p), element 2*hf + q of an accumulator
  // tile; the h tile holds them as words 2*(o & 1) + hf of the lane's A
  // fragment of (mt, k-tile o / 2).
  float c[kPasses][kMT][4];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int o = w + nW * p;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t hw[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float hv[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int row = b0 + 16 * mt + g + 8 * hf;
          const size_t s = ((size_t)d * B + row) * U + 8 * o + 2 * tg + q;
          c[p][mt][2 * hf + q] = row < B ? c0[s] : 0.f;
          hv[q] = row < B ? h0[s] : 0.f;
        }
        hw[hf] = pack_bf16(hv[0], hv[1]);
      }
      reinterpret_cast<uint2*>(hs + (mt * kHT + (o >> 1)) * 32 + lane)[o & 1] =
          make_uint2(hw[0], hw[1]);
    }
  }
  cp_async_wait_all();
  __syncthreads();  // x_0 and bf16(h_0) are in shared memory

  int cur = 0;
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    const bool more = step + 1 < T;
    const int tn = d == 0 ? step + 1 : T - 2 - step;
    // x_{t+1} into the other buffer, for the next step
    if (more) {
      if (small) load_xr(xr, tn);
      else issue_x(cur ^ 1, tn);
    }
    const uint4* hc = hs + cur * kMT * kHT * 32 + lane;
    const bf16* xc = xsm + cur * kR * XS;
    uint4* hn = hs + (cur ^ 1) * kMT * kHT * 32 + lane;

#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int o = w + nW * p;  // this pass's unit octet
      const uint2* wh_o = wh_d + (size_t)o * kHT * kFrag;
      const uint2* wx_o = wx_d + (size_t)o * KT * kFrag;
      // streamed k-tile j: h.Wh's first, then x.Wx's
      auto src = [&](int j) { return j < kHT ? wh_o + j * kFrag : wx_o + (j - kHT) * kFrag; };
      auto a_frag = [&](int j, int mt) {
        return j < kHT ? hc[(mt * kHT + j) * 32] : x_frag(xc, XS, mt, j - kHT, g, tg);
      };
      uint2 bx[2][4];  // k-tiles in flight (NS >= 21)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) bx[s][gate] = __ldg(src(s) + gate * 32);

      float acc[4][kMT][4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const float2 bv = __ldg(reinterpret_cast<const float2*>(bd + gate * U + 8 * o + 2 * tg));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          acc[gate][mt][0] = bv.x; acc[gate][mt][1] = bv.y;
          acc[gate][mt][2] = bv.x; acc[gate][mt][3] = bv.y;
        }
      }

#pragma unroll 1
      for (int j = 0; j < NS; j += 2) {
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const uint4 a = a_frag(j, mt);
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) mma_bf16(acc[gate][mt], a, bx[0][gate]);
        }
        if (j + 2 < NS) {
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) bx[0][gate] = __ldg(src(j + 2) + gate * 32);
        }
        if (j + 1 < NS) {
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            const uint4 a = a_frag(j + 1, mt);
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) mma_bf16(acc[gate][mt], a, bx[1][gate]);
          }
          if (j + 3 < NS) {
#pragma unroll
            for (int gate = 0; gate < 4; ++gate) bx[1][gate] = __ldg(src(j + 3) + gate * 32);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        uint32_t hp[2];  // bf16(h) pairs of rows g and g + 8
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float hv[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int e = 2 * hf + q;
            lstm_cell(acc[0][mt][e], acc[1][mt][e], acc[2][mt][e], acc[3][mt][e], c[p][mt][e],
                      hv[q]);
          }
          hp[hf] = pack_bf16(hv[0], hv[1]);
          const int row = b0 + 16 * mt + g + 8 * hf;
          if (row < B) {
            const int unit = 8 * o + 2 * tg;
            *reinterpret_cast<uint32_t*>(out + ((size_t)row * T + t) * (2 * U) + d * U + unit) =
                hp[hf];
            if (!more) {
              const size_t s = ((size_t)d * B + row) * U + unit;
              *reinterpret_cast<float2*>(hN + s) = make_float2(hv[0], hv[1]);
              *reinterpret_cast<float2*>(cN + s) =
                  make_float2(c[p][mt][2 * hf], c[p][mt][2 * hf + 1]);
            }
          }
        }
        reinterpret_cast<uint2*>(hn + (mt * kHT + (o >> 1)) * 32)[o & 1] =
            make_uint2(hp[0], hp[1]);
      }
    }
    if (more) {
      if (small) store_xr(xr, cur ^ 1);
      else cp_async_wait_all();
    }
    __syncthreads();  // bf16(h_t) and x_{t+1} are in place; this step's reads are done
    cur ^= 1;
  }
}

// Shared memory of one CTA of U units for an input padded to Kx columns:
// the two h buffers and the two x buffers.
size_t smem_bytes(int U, int Kx) {
  return 16 * (size_t)2 * kMT * (U / 16) * 32 + 2 * (size_t)2 * kR * (Kx + 8);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). U one of
// RV_BILSTM_WIDE_UNITS (bilstm_units.cuh); the other arguments as
// rv_bilstm_layer_bf16's (bilstm_bf16.cu): xs [B, T, F] bf16 (F <= 16, or
// a multiple of 8 up to 2U, 16-byte aligned); Kx = F rounded up to 16; wxF,
// whF the weights in fragment order (ops/rnn_cuda.py:kernel_layout); bias
// [2, 4U] f32; h0, c0 [2, B, U] f32; out [B, T, 2U] bf16; hN, cN [2, B, U]
// f32.
extern "C" int rv_bilstm_layer_bf16_wide(const void* xs, int B, int T, int F, int Kx, int U,
                                         const void* wxF, const void* whF, const float* bias,
                                         const float* h0, const float* c0, void* out, float* hN,
                                         float* cN, void* stream) {
  if (!rv_bilstm_wide_compiled(U) || B <= 0 || T <= 0 || F <= 0 || F > 2 * U ||
      Kx != (F + 15) / 16 * 16 || (F > kSmallK && F % 8 != 0))  // F <= 16, or a multiple of 8
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(U, Kx);
  cudaError_t e = cudaFuncSetAttribute(bilstm_bf16_wide_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + kR - 1) / kR, 2);
  bilstm_bf16_wide_kernel<<<grid, U, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(xs), B, T, F, Kx, U, static_cast<const uint2*>(wxF),
      static_cast<const uint2*>(whF), bias, h0, c0, static_cast<bf16*>(out), hN, cN);
  return (int)cudaGetLastError();
}

// What a CTA of the layer takes at U units and Kx padded input columns, into
// info: threads, dynamic shared memory bytes, batch rows, registers a thread
// and local memory bytes a thread (cudaFuncGetAttributes). Returns a
// cudaError_t; refuses what rv_bilstm_layer_bf16_wide refuses.
extern "C" int rv_bilstm_layer_bf16_wide_cta(int U, int Kx, int* info) {
  if (!rv_bilstm_wide_compiled(U) || Kx <= 0 || Kx % 16 != 0 || Kx > 2 * U)
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, bilstm_bf16_wide_kernel);
  if (e != cudaSuccess) return (int)e;
  info[0] = U;
  info[1] = (int)smem_bytes(U, Kx);
  info[2] = kR;
  info[3] = attr.numRegs;
  info[4] = (int)attr.localSizeBytes;
  return 0;
}
