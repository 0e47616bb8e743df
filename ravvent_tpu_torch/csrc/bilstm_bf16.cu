// One bidirectional LSTM layer on a bf16 stream, the whole time loop in one
// launch, on the tensor cores.
//
// Replaces the bf16 stream of the TPU kernel
// ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel (entry point
// run_bidi_lstm_pallas with a bf16 input): bf16 x, Wx and Wh, f32 bias, f32
// state and accumulation, z = dot(x, Wx) + dot(bf16(h), Wh) + b, keras
// LSTMCell (gates i, f, g, o), bf16 outputs bf16(h), f32 final states. The
// forward direction runs t = 0..T-1, the backward direction t = T-1..0;
// outputs are time-aligned.
//
// What bounds it on the H100: the bf16 products, 2*(F+U)*4U flops per row,
// step and direction, at 989 TFLOP/s dense; the bytes (x read once, outputs
// written once) are below that. Design: one CTA per (direction, tile of 64
// batch rows) loops over T itself. One direction's Wh (128 x 512 bf16,
// 128 KiB) stays in shared memory for the whole launch, stored transposed
// (gate column-major) so that an mma.sync B fragment is one 32-bit load.
// Each step every warp runs mma.sync.m16n8k16 (bf16 in, f32 accumulate) on
// the 4 row tiles of 16 against its 16 units' columns of all four gates, so
// the i, f, g, o sums of one (row, unit) land in the same thread and the cell
// needs no exchange; c stays in registers, bf16(h) goes to a double-buffered
// shared tile. x_t of the tile is staged in shared memory; Wx (up to
// 256 x 512 bf16) does not fit beside Wh and is read through L1/L2 each step,
// transposed and zero-padded to a multiple of 16 by the wrapper.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kU = 128;            // LSTM units (the flagship's; the wrapper checks)
constexpr int kG = 4 * kU;         // gate columns
constexpr int kBR = 64;            // batch rows per CTA
constexpr int kMT = kBR / 16;      // m16 row tiles per CTA
constexpr int kWarps = 8;          // warp w owns units [16w, 16w + 16)
constexpr int kThreads = 32 * kWarps;
constexpr int kWS = kU + 8;        // row stride (bf16) of Wh^T and h in shared memory:
                                   // 68 words, so a fragment load is conflict-free
constexpr int kMaxK = 2 * kU;      // widest layer input

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a . b for one m16n8k16 tile, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// acc[gate][mt][j] += A[rows of mt, k-tile] . B[k-tile, gate columns of tile j].
// A is row-major in shared memory (stride sa), B^T row-major (gate column n,
// stride sb) in shared or global memory.
template <bool kGlobalB>
__device__ __forceinline__ void mma_ktile(float (&acc)[4][kMT][2][4], const bf16* A, int sa,
                                          const bf16* Bt, int sb, int ubase, int g, int tg) {
  uint32_t b[4][2][2];
#pragma unroll
  for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bf16* p = Bt + (size_t)(gate * kU + ubase + 8 * j + g) * sb + 2 * tg;
      if (kGlobalB) {
        b[gate][j][0] = __ldg(reinterpret_cast<const unsigned int*>(p));
        b[gate][j][1] = __ldg(reinterpret_cast<const unsigned int*>(p + 8));
      } else {
        b[gate][j][0] = lds32(p);
        b[gate][j][1] = lds32(p + 8);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    const bf16* pa = A + (16 * mt + g) * sa + 2 * tg;
    const uint32_t a0 = lds32(pa), a1 = lds32(pa + 8 * sa);
    const uint32_t a2 = lds32(pa + 8), a3 = lds32(pa + 8 * sa + 8);
#pragma unroll
    for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
      for (int j = 0; j < 2; ++j) mma16816(acc[gate][mt][j], a0, a1, a2, a3, b[gate][j][0], b[gate][j][1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
bilstm_bf16_kernel(const bf16* __restrict__ xs,     // [B, T, F]
                   int B, int T, int F, int Kx,
                   const bf16* __restrict__ wxT,    // [2, 4U, Kx] Wx^T, zero past F
                   const bf16* __restrict__ whT,    // [2, 4U, U]  Wh^T
                   const float* __restrict__ bias,  // [2, 4U]
                   const float* __restrict__ h0,    // [2, B, U]
                   const float* __restrict__ c0,    // [2, B, U]
                   bf16* __restrict__ out,          // [B, T, 2U]
                   float* __restrict__ hN,          // [2, B, U]
                   float* __restrict__ cN) {        // [2, B, U]
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* whs = reinterpret_cast<bf16*>(smem_raw);  // [4U][kWS]      Wh^T
  bf16* hs = whs + kG * kWS;                        // [2][kBR][kWS]  bf16(h), double-buffered
  bf16* xsm = hs + 2 * kBR * kWS;                   // [kBR][Kx + 8]  x_t of the tile
  const int XS = Kx + 8;

  const int d = blockIdx.y;  // 0 forward, 1 backward
  const int b0 = blockIdx.x * kBR;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;  // mma fragment row group and column pair
  const int ubase = 16 * (tid >> 5);

  const bf16* Wx = wxT + (size_t)d * kG * Kx;
  const bf16* Wh = whT + (size_t)d * kG * kU;
  const float* bd = bias + d * kG;

  for (int i = tid; i < kG * kU / 8; i += kThreads) {
    const int n = i / (kU / 8), k8 = i - n * (kU / 8);
    *reinterpret_cast<uint4*>(whs + n * kWS + 8 * k8) =
        *reinterpret_cast<const uint4*>(Wh + (size_t)n * kU + 8 * k8);
  }

  // Thread-owned (row, unit) pairs: row 16*mt + g + 8*hf, unit ubase + 8*j + 2*tg + q,
  // element 2*hf + q of an accumulator tile.
  float c[kMT][2][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * mt + g + 8 * (e >> 1), u = ubase + 8 * j + 2 * tg + (e & 1);
        const int row = b0 + r;
        const size_t s = ((size_t)d * B + row) * kU + u;
        c[mt][j][e] = row < B ? c0[s] : 0.f;
        hs[r * kWS + u] = __float2bfloat16_rn(row < B ? h0[s] : 0.f);
      }

  int cur = 0;
  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    if (F == Kx) {  // F a multiple of 16: 16-byte pieces of each row
      const int per = F / 8;
      for (int i = tid; i < kBR * per; i += kThreads) {
        const int r = i / per, k8 = i - r * per;
        const int row = b0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (row < B) v = *reinterpret_cast<const uint4*>(xs + ((size_t)row * T + t) * F + 8 * k8);
        *reinterpret_cast<uint4*>(xsm + r * XS + 8 * k8) = v;
      }
    } else {
      for (int i = tid; i < kBR * Kx; i += kThreads) {
        const int r = i / Kx, k = i - r * Kx;
        const int row = b0 + r;
        xsm[r * XS + k] = (row < B && k < F) ? xs[((size_t)row * T + t) * F + k]
                                             : __float2bfloat16_rn(0.f);
      }
    }
    __syncthreads();  // x_t and bf16(h_{t-1}) are in shared memory

    float acc[4][kMT][2][4];
#pragma unroll
    for (int gate = 0; gate < 4; ++gate)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float* bp = bd + gate * kU + ubase + 8 * j + 2 * tg;
        const float bv0 = __ldg(bp), bv1 = __ldg(bp + 1);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          acc[gate][mt][j][0] = bv0; acc[gate][mt][j][1] = bv1;
          acc[gate][mt][j][2] = bv0; acc[gate][mt][j][3] = bv1;
        }
      }
#pragma unroll 1
    for (int kt = 0; kt < Kx / 16; ++kt)
      mma_ktile<true>(acc, xsm + 16 * kt, XS, Wx + 16 * kt, Kx, ubase, g, tg);
    const bf16* hc = hs + cur * kBR * kWS;
#pragma unroll 1
    for (int kt = 0; kt < kU / 16; ++kt)
      mma_ktile<false>(acc, hc + 16 * kt, kWS, whs + 16 * kt, kWS, ubase, g, tg);

    bf16* hn = hs + (cur ^ 1) * kBR * kWS;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float hv[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int e = 2 * hf + q;
            const float ig = sigmoid_f(acc[0][mt][j][e]);
            const float fg = sigmoid_f(acc[1][mt][j][e]);
            const float gg = tanhf(acc[2][mt][j][e]);
            const float og = sigmoid_f(acc[3][mt][j][e]);
            c[mt][j][e] = fg * c[mt][j][e] + ig * gg;
            hv[q] = og * tanhf(c[mt][j][e]);
          }
          const int r = 16 * mt + g + 8 * hf, u = ubase + 8 * j + 2 * tg;
          const __nv_bfloat162 hb = __floats2bfloat162_rn(hv[0], hv[1]);
          *reinterpret_cast<__nv_bfloat162*>(hn + r * kWS + u) = hb;
          const int row = b0 + r;
          if (row < B) {
            *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)row * T + t) * (2 * kU) + d * kU + u) = hb;
            if (step == T - 1) {
              const size_t s = ((size_t)d * B + row) * kU + u;
              *reinterpret_cast<float2*>(hN + s) = make_float2(hv[0], hv[1]);
              *reinterpret_cast<float2*>(cN + s) = make_float2(c[mt][j][2 * hf], c[mt][j][2 * hf + 1]);
            }
          }
        }
    __syncthreads();  // every read of x_t and of bf16(h_{t-1}) is done
    cur ^= 1;
  }
}

}  // namespace

// Shared memory of one CTA for an input padded to Kx columns.
static size_t bilstm_bf16_smem(int Kx) {
  return sizeof(bf16) * ((size_t)kG * kWS + 2 * kBR * kWS + (size_t)kBR * (Kx + 8));
}

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
// xs [B, T, F] bf16; wxT [2, 4U, Kx] bf16 (Kx = F rounded up to 16, zero
// columns past F); whT [2, 4U, U] bf16; bias [2, 4U] f32; h0, c0 [2, B, U]
// f32; out [B, T, 2U] bf16; hN, cN [2, B, U] f32.
extern "C" int rv_bilstm_layer_bf16(const void* xs, int B, int T, int F, int Kx,
                                    const void* wxT, const void* whT, const float* bias,
                                    const float* h0, const float* c0,
                                    void* out, float* hN, float* cN, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0 || Kx % 16 != 0 || Kx < F || Kx > kMaxK || (Kx != F && Kx - F >= 16))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bilstm_bf16_smem(Kx);
  cudaError_t e = cudaFuncSetAttribute(bilstm_bf16_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((B + kBR - 1) / kBR, 2);
  bilstm_bf16_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(xs), B, T, F, Kx, static_cast<const bf16*>(wxT),
      static_cast<const bf16*>(whT), bias, h0, c0, static_cast<bf16*>(out), hN, cN);
  return (int)cudaGetLastError();
}
