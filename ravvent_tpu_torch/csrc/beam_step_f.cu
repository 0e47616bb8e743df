// One beam-search decode step on bf16, f32 or int8 memory, as two kernels
// launched back to back (ops/beam_step_cuda.py:beam_step).
//
// Replaces the TPU kernel ravvent_tpu/ops/beam_loop_pallas.py::_beam_step_kernel
// (:333, entry point beam_step_decode) in all its memory modes: quant=False
// (bf16, f32), quant (int8 codes with per-(row, position) scales, dequantized
// dots) and quant_mxu (s8 x s8 -> s32 dots). Both kernels are compiled for
// the decoder units of beam_step_shapes.cuh (64, 128, 256) and the attend
// kernel for beam widths 1 to RV_STEP_MAX_BEAMS (32), as the TPU kernel
// takes any U and any W that fits its lanes.
//
// beam_cell (here): the LSTM cell and h'.watt_h for every hypothesis. A
//   tiled f32 product [B*W, 2U] x [2U, 4U] (rows [att_prev | h_prev],
//   columns the stacked wx[V:] and wh) on top of b + the token's row of wx
//   (ids >= V embed to zeros), the keras gates i, f, g, o, then att_h = h' .
//   watt_h while the CTA still holds its tile's h'. Writes h', c', att_h to
//   f32 scratch [B*W, U]. Bound by operations: 2 * (2U * 4U + U * U) f32
//   FMA-flops a hypothesis (6.04 GFLOP at B*W = 20480, U = 128, 90 us at 67
//   TFLOP/s; 1.51 GFLOP at 64 units, 24.2 at 256). Design: a CTA owns 32
//   hypotheses and all 4U gate columns, so that a thread holds the four
//   gates of its units for the epilogue (8 hypotheses x 2 units x 4 gates
//   in registers); a warp covers 32 hypotheses x 16 units, so a CTA has U /
//   16 warps (2U threads: 128, 256, 512). The weights (0.58 MB at 128 units)
//   stream through shared memory in k-slices of 16 rows, double-buffered
//   with cp.async, read from L2 once per 32 hypotheses (the single-kernel
//   step read them once per 20). 128 registers a thread, so 4, 2 and 1 CTAs
//   an SM (51, 100 and 200 KB of shared memory each): at 64 and 128 units
//   one CTA's loads and epilogue run under another's products.
//
// beam_attend (beam_attend.cuh, one source a memory mode): attention,
//   logits, top-W and the beam permutation of each batch row, bound by the
//   bytes of the keys and values; its header states its design.
//
// Numerics as the reference: the cell in f32.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include <initializer_list>

#include "beam_attend.cuh"

namespace {

// ---------------------------------------------------------------- beam_cell

template <int U>
struct Cell {
  static constexpr int kThreads = 2 * U;   // U / 16 warps of 32 hypotheses x 16 units
  static constexpr int kM = 32;            // hypotheses a CTA
  static constexpr int kG = 4 * U;         // gate columns
  static constexpr int kK = 2 * U;         // rows of the stacked cell kernel
  static constexpr int kKS = 16;           // rows a k-slice
  static constexpr int kXS = kM + 4;       // padded row of the transposed input tile
  static constexpr int kSmem = (kK * kXS + 2 * kKS * kG) * (int)sizeof(float);
  static constexpr int kMinBlocks = 65536 / (kThreads * 128);  // at 128 registers a thread
};

// Copy n floats (contiguous in global and shared memory) with 16-byte
// cp.async, spread over the CTA's NT threads.
template <int NT>
__device__ __forceinline__ void copy_slice(float* dst, const float* src, int n_floats) {
  for (int i = threadIdx.x * 4; i < n_floats; i += NT * 4) cp_async16(dst + i, src + i);
}

// Row k of the stacked cell kernel: wx[V + k] for k < U, wh[k - U] after.
template <int U>
__device__ __forceinline__ const float* cell_row(const float* wx, const float* wh, int V, int k) {
  return k < U ? wx + (size_t)(V + k) * (4 * U) : wh + (size_t)(k - U) * (4 * U);
}

__device__ __forceinline__ void lds2(const float* p, float v[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void stg2(float* p, const float v[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

template <int U>
__global__ void __launch_bounds__(Cell<U>::kThreads, Cell<U>::kMinBlocks)
beam_cell_kernel(int N, int V,
                 const int32_t* __restrict__ tok,     // [N]
                 const float* __restrict__ att_in,    // [N, U]
                 const float* __restrict__ h_in,      // [N, U]
                 const float* __restrict__ c_in,      // [N, U]
                 const float* __restrict__ wx,        // [V+U, 4U]
                 const float* __restrict__ wh,        // [U, 4U]
                 const float* __restrict__ bias,      // [4U]
                 const float* __restrict__ watt_h,    // [U, U]
                 float* __restrict__ h_new,           // [N, U]
                 float* __restrict__ c_new,           // [N, U]
                 float* __restrict__ att_h) {         // [N, U]
  using C = Cell<U>;
  constexpr int kG = C::kG, kK = C::kK, kKS = C::kKS, kXS = C::kXS, NT = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [kK][kXS]: x transposed (then h' [U][kXS])
  float* ws = smem + kK * kXS;       // [2][kKS][kG]: weight k-slices

  // warp: all 32 hypotheses x 16 units; lane: 8 hypotheses x 2 units
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (lane >> 3) * 8;               // first hypothesis of the thread (in the tile)
  const int u0 = warp * 16 + (lane & 7) * 2;    // first unit of the thread
  const int hyp0 = blockIdx.x * C::kM;

  // the first weight slice
  copy_slice<NT>(ws, cell_row<U>(wx, wh, V, 0), kKS * kG);
  cp_async_commit();

  // z[hyp][g*U + u] = b + the token's row of wx, then + x . [wx[V:]; wh]:
  // acc[j][g][e], hypothesis m0 + j, gate g, unit u0 + e
  float acc[8][4][2];
  {
    float bv[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) load2(bias + g * U + u0, bv[g]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hyp = hyp0 + m0 + j;
      const int tk = hyp < N ? __ldg(tok + hyp) : V;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float emb[2] = {0.f, 0.f};
        if (tk >= 0 && tk < V) load2(wx + (size_t)tk * kG + g * U + u0, emb);
        acc[j][g][0] = bv[g][0] + emb[0];
        acc[j][g][1] = bv[g][1] + emb[1];
      }
    }
  }

  // the input tile x = [att_prev | h_prev], transposed; rows past N are
  // zeros. Thread: hypothesis m = tid % 32, 4-row chunks tid / 32 + U/16 r;
  // the loads in flight together, then the stores
  {
    constexpr int kStep = NT / C::kM;
    constexpr int kChunks = kK / 4 / kStep;  // 8 a thread
    const int m = tid % C::kM;
    const bool live = hyp0 + m < N;
    const float* arow = att_in + (size_t)(hyp0 + m) * U;
    const float* hrow = h_in + (size_t)(hyp0 + m) * U;
    float v[kChunks][4];
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int k = 4 * (tid / C::kM + kStep * r);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[r][e] = 0.f;
      if (live) load4(k < U ? arow + k : hrow + (k - U), v[r]);
    }
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int k = 4 * (tid / C::kM + kStep * r);
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(k + e) * kXS + m] = v[r][e];
    }
  }

  constexpr int kSlices = kK / kKS;
  for (int kt = 0; kt < kSlices; ++kt) {
    if (kt + 1 < kSlices) {
      copy_slice<NT>(ws + ((kt + 1) & 1) * kKS * kG, cell_row<U>(wx, wh, V, (kt + 1) * kKS),
                     kKS * kG);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wsl = ws + (kt & 1) * kKS * kG;
#pragma unroll 4
    for (int kk = 0; kk < kKS; ++kk) {
      const float* xr = xs + (kt * kKS + kk) * kXS + m0;
      float x[8];
      lds4(xr, x);
      lds4(xr + 4, x + 4);
      float w[4][2];
#pragma unroll
      for (int g = 0; g < 4; ++g) lds2(wsl + kk * kG + g * U + u0, w[g]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int g = 0; g < 4; ++g)
#pragma unroll
          for (int e = 0; e < 2; ++e) acc[j][g][e] = fmaf(x[j], w[g][e], acc[j][g][e]);
    }
    __syncthreads();
  }

  // watt_h streams through the same buffers while the epilogue runs
  constexpr int kAttSlice = kKS * U;
  copy_slice<NT>(ws, watt_h, kAttSlice);
  cp_async_commit();

  // epilogue: the gates; h' to scratch and to shared memory (transposed,
  // the next product's input)
  float* hs = xs;  // [U][kXS]
  float cp[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int hyp = hyp0 + m0 + j;
    cp[j][0] = cp[j][1] = 0.f;
    if (hyp < N) load2(c_in + (size_t)hyp * U + u0, cp[j]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int m = m0 + j;
    const int hyp = hyp0 + m;
    float hv[2], cv[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      cv[e] = sigmoid_f(acc[j][1][e]) * cp[j][e] + sigmoid_f(acc[j][0][e]) * tanhf(acc[j][2][e]);
      hv[e] = sigmoid_f(acc[j][3][e]) * tanhf(cv[e]);
      hs[(u0 + e) * kXS + m] = hv[e];
    }
    if (hyp < N) {
      stg2(h_new + (size_t)hyp * U + u0, hv);
      stg2(c_new + (size_t)hyp * U + u0, cv);
    }
  }

  // att_h = h' . watt_h: acc2[j][e], hypothesis m0 + j, column u0 + e
  float acc2[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc2[j][0] = acc2[j][1] = 0.f;
  constexpr int kAttSlices = U / kKS;
  for (int kt = 0; kt < kAttSlices; ++kt) {
    if (kt + 1 < kAttSlices) {
      copy_slice<NT>(ws + ((kt + 1) & 1) * kKS * kG, watt_h + (size_t)(kt + 1) * kAttSlice,
                     kAttSlice);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // (first pass: also h' complete in shared memory)
    const float* wsl = ws + (kt & 1) * kKS * kG;
#pragma unroll 4
    for (int kk = 0; kk < kKS; ++kk) {
      const float* xr = hs + (kt * kKS + kk) * kXS + m0;
      float x[8], w[2];
      lds4(xr, x);
      lds4(xr + 4, x + 4);
      lds2(wsl + kk * U + u0, w);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc2[j][0] = fmaf(x[j], w[0], acc2[j][0]);
        acc2[j][1] = fmaf(x[j], w[1], acc2[j][1]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int hyp = hyp0 + m0 + j;
    if (hyp < N) stg2(att_h + (size_t)hyp * U + u0, acc2[j]);
  }
}

template <int U>
int launch_cell(int N, int V, const void* tok, const void* att_in, const void* h_in,
                const void* c_in, const void* wx, const void* wh, const void* bias,
                const void* watt_h, void* h_new, void* c_new, void* att_h, cudaStream_t stream) {
  using C = Cell<U>;
  static int allowed[kMaxDevices] = {};
  const int rc = allow_smem(beam_cell_kernel<U>, (size_t)C::kSmem, allowed);
  if (rc) return rc;
  const int grid = (N + C::kM - 1) / C::kM;
  beam_cell_kernel<U><<<grid, C::kThreads, C::kSmem, stream>>>(
      N, V, (const int32_t*)tok, (const float*)att_in, (const float*)h_in, (const float*)c_in,
      (const float*)wx, (const float*)wh, (const float*)bias, (const float*)watt_h,
      (float*)h_new, (float*)c_new, (float*)att_h);
  return (int)cudaGetLastError();
}

bool bad_attend_shape(int B, int S, int V, int VP, int end_token) {
  return B <= 0 || S <= 0 || V <= 0 || VP != kVP || V > VP || end_token < 0 || end_token >= V;
}

bool misaligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((uintptr_t)p % 16) return true;
  return false;
}

}  // namespace

// The cell of N = B*W hypotheses of U units: h', c' and h'.watt_h into f32
// scratch [N, U]. Launches on `stream`; returns cudaGetLastError() (0 =
// launched); cudaErrorInvalidValue for a U not compiled.
extern "C" int rv_beam_cell(int U, int N, int V, const void* tok, const void* att_in,
                            const void* h_in, const void* c_in, const void* wx, const void* wh,
                            const void* bias, const void* watt_h, void* h_new, void* c_new,
                            void* att_h, void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  switch (U) {  // one case a compiled width (beam_step_shapes.cuh)
#define RV_CELL_CASE(u)                                                                     \
    case u: return launch_cell<u>(N, V, tok, att_in, h_in, c_in, wx, wh, bias, watt_h, h_new, \
                                  c_new, att_h, (cudaStream_t)stream);
    RV_STEP_UNITS(RV_CELL_CASE)
#undef RV_CELL_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The rest of the step for B batch rows of W beams on bf16 (mem_bf16 = 1)
// or f32 keys/values [B, S, U], from rv_beam_cell's scratch; VP = 128. U and
// W as beam_step_shapes.cuh lists them. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rv_beam_attend(int mem_bf16, int U, int W, int B, int S, int V, int VP,
                              int end_token, const void* h_new, const void* c_new,
                              const void* att_h, const void* cum_in, const void* fin_in,
                              const void* keys, const void* values, const void* mask,
                              const void* wfc, const void* bfc, void* tok_out, void* par_out,
                              void* h_out, void* c_out, void* att_out, void* cum_out,
                              void* fin_out, void* stream) {
  if (bad_attend_shape(B, S, V, VP, end_token)) return (int)cudaErrorInvalidValue;
  const RvAttendArgs a{B, S, V, end_token, h_new, c_new, att_h, cum_in, fin_in, keys, values,
                       nullptr, nullptr, mask, wfc, bfc, tok_out, par_out, h_out, c_out,
                       att_out, cum_out, fin_out};
  if (mem_bf16) return rv_attend_bf16(U, W, &a, nullptr, stream);
  return rv_attend_f32(U, W, &a, nullptr, stream);
}

// The same on int8 keys/values [B, S, U] with f32 scales kscale, vscale
// [B, S]: mxu = 1 for quant_mxu (s8 x s8 -> s32 dots), 0 for quant
// (dequantized dots). Refuses missing scales and a [B*W, U] state or
// memory that is not 16-byte aligned.
extern "C" int rv_beam_attend_i8(int mxu, int U, int W, int B, int S, int V, int VP,
                                 int end_token, const void* h_new, const void* c_new,
                                 const void* att_h, const void* cum_in, const void* fin_in,
                                 const void* keys, const void* values, const void* kscale,
                                 const void* vscale, const void* mask, const void* wfc,
                                 const void* bfc, void* tok_out, void* par_out, void* h_out,
                                 void* c_out, void* att_out, void* cum_out, void* fin_out,
                                 void* stream) {
  if (bad_attend_shape(B, S, V, VP, end_token) || !kscale || !vscale ||
      misaligned16({h_new, c_new, att_h, keys, values, h_out, c_out, att_out}))
    return (int)cudaErrorInvalidValue;
  const RvAttendArgs a{B, S, V, end_token, h_new, c_new, att_h, cum_in, fin_in, keys, values,
                       kscale, vscale, mask, wfc, bfc, tok_out, par_out, h_out, c_out, att_out,
                       cum_out, fin_out};
  if (mxu) return rv_attend_i8mxu(U, W, &a, nullptr, stream);
  return rv_attend_i8(U, W, &a, nullptr, stream);
}

// What the attend kernel's instance for (mode, U, W) needs at S positions
// and V tokens, written to info[3]: shared memory a CTA in bytes (dynamic
// and static), threads a CTA, CTAs an SM (0 when a CTA does not fit in 227
// KB). mode: 0 bf16, 1 f32, 2 int8 quant, 3 int8 quant_mxu. Launches
// nothing; cudaErrorInvalidValue for a shape not compiled.
extern "C" int rv_beam_attend_info(int mode, int U, int W, int S, int V, int* info) {
  if (S <= 0 || V <= 0 || V > kVP || !info) return (int)cudaErrorInvalidValue;
  RvAttendArgs a{};
  a.B = 1;
  a.S = S;
  a.V = V;
  switch (mode) {
    case 0: return rv_attend_bf16(U, W, &a, info, nullptr);
    case 1: return rv_attend_f32(U, W, &a, info, nullptr);
    case 2: return rv_attend_i8(U, W, &a, info, nullptr);
    case 3: return rv_attend_i8mxu(U, W, &a, info, nullptr);
  }
  return (int)cudaErrorInvalidValue;
}
