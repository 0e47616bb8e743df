// One greedy decode step of the attention decoder on un-projected memory.
//
// Replaces the TPU kernel ravvent_tpu/ops/decode_step_pallas.py::_fused_step_kernel
// (entry fused_decode_step, looped by fused_greedy_decode; f32 memory,
// depth-1 LSTM, Luong). Per batch row: LSTM cell on [one-hot token | previous
// attention vector] (a token id >= V embeds to zeros), Luong scores of h
// against the keys [S, U], softmax masked with finfo(f32).min (an all-masked
// row becomes uniform), context from the values [S, E], the attention vector
// att = [h; context].W_att with W_att [U+E, U], and logits att.W_fc + b_fc for
// the V vocabulary columns (the reference padded them to 128 with a finfo.min
// bias and sliced the padding away).
//
// What bounds it on the H100: memory bytes. A step reads every row's f32 keys
// and values once: B x S x (U + E) x 4 B, 1.46 GB at B = 4096, S = 232,
// U = 128, E = 256 (0.44 ms at 3.35 TB/s), against ~2.2 GFLOP of f32 work;
// 2.92 GB (0.87 ms) at U = 256, E = 512.
// Design: one CTA per kRows batch rows. The TPU kernel pipelined batch tiles
// of memory through VMEM; here each CTA streams its rows' keys and values
// from HBM exactly once with coalesced loads (a warp reads one key row per
// position, U / 32 units a lane; the value rows are read by the threads'
// columns, eight rows' loads in flight per thread) and keeps every
// intermediate in shared memory. The decoder weights (~0.7 MB f32 at
// U = 128, E = 256) are read through L2 once per CTA and shared by its kRows
// rows: 4U / 256 gate columns per thread in the cell, one unit and 256 / U
// of the input rows per thread in the attention layer.
//
// Widths (decode_step_shapes.cuh lists them): the kernel is a template on
// (U, E) and a CTA has 256 threads at every width. The context gives each
// thread E / 256 memory columns where E >= 256; where E < 256 the CTA's
// threads split the positions into 256 / E groups, whose partial sums meet
// in shared memory. At (128, 256) the kernel computes what it computed when
// it was compiled for that width alone, in the same order.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "common.cuh"
#include "decode_step_shapes.cuh"

namespace {

constexpr int kRows = 8;       // batch rows per CTA
constexpr int kThreads = 256;  // at every width
constexpr int kWarps = kThreads / 32;

template <int U, int E>
struct StepShape {
  static constexpr int kU = U;
  static constexpr int kG = 4 * U;                 // gate columns
  static constexpr int kE = E;
  static constexpr int kCols = kG / kThreads;      // gate columns per thread
  static constexpr int kHalves = kThreads / U;     // input-row groups of the attention layer
  static constexpr int kUPL = U / 32;              // key units a lane in the scores
  static constexpr int kCtxCols = E < kThreads ? E : kThreads;  // columns a pass of the context
  static constexpr int kEPer = E / kCtxCols;                    // columns a thread
  static constexpr int kPosGroups = kThreads / kCtxCols;        // position groups
  static_assert(kG % kThreads == 0 && kThreads % U == 0, "U divides the CTA");
  static_assert((U + E) % kHalves == 0, "the attention layer's input rows split evenly");
  static_assert(kUPL == 2 || kUPL % 4 == 0, "a lane's key units load 8 or 16 bytes at a time");
  static_assert(E % kCtxCols == 0 && kThreads % kCtxCols == 0, "the context's columns");
  // the context's partial sums of each position group, and the attention
  // layer's of each input-row group, lie in the gates' buffer
  static_assert((kPosGroups == 1 || kPosGroups * kE <= kG) && kHalves * kU <= kG,
                "partial sums fit the gates");
};

// float offsets into the dynamic shared buffer
struct StepSmem {
  int attp, hp, hn, cn, an, z, ctx, sc, total;
};

template <class Sh>
__host__ __device__ inline StepSmem step_smem_layout(int S) {
  StepSmem L;
  int o = 0;
  L.attp = o; o += kRows * Sh::kU;  // [R][U] previous attention vector
  L.hp = o;   o += kRows * Sh::kU;  // [R][U] previous h
  L.hn = o;   o += kRows * Sh::kU;  // [R][U] new h
  L.cn = o;   o += kRows * Sh::kU;  // [R][U] new c
  L.an = o;   o += kRows * Sh::kU;  // [R][U] new attention vector
  L.z = o;    o += kRows * Sh::kG;  // [R][4U] gates; then [groups][R][E] partial context,
                                    // then [halves][R][U] partial att
  L.ctx = o;  o += kRows * Sh::kE;  // [R][E] context
  L.sc = o;   o += kRows * S;       // [R][S] scores, then alignments
  L.total = o;
  return L;
}

// n consecutive f32 elements from global memory (n = 2, or a multiple of 4)
template <int N>
__device__ __forceinline__ void load_n(const float* p, float* v) {
  if constexpr (N == 2) {
    load2(p, v);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) load4(p + i, v + i);
  }
}

template <int U, int E>
__global__ void __launch_bounds__(kThreads)
decode_step_kernel(int B, int S, int V,
                   const int32_t* __restrict__ tok,      // [B]
                   const float* __restrict__ att_in,     // [B, U]
                   const float* __restrict__ h_in,       // [B, U]
                   const float* __restrict__ c_in,       // [B, U]
                   const float* __restrict__ keys,       // [B, S, U]
                   const float* __restrict__ values,     // [B, S, E]
                   const uint8_t* __restrict__ mask,     // [B, S]
                   const float* __restrict__ wx,         // [V+U, 4U]
                   const float* __restrict__ wh,         // [U, 4U]
                   const float* __restrict__ bias,       // [4U]
                   const float* __restrict__ watt,       // [U+E, U]
                   const float* __restrict__ wfc,        // [U, V]
                   const float* __restrict__ bfc,        // [V]
                   float* __restrict__ h_out,            // [B, U]
                   float* __restrict__ c_out,            // [B, U]
                   float* __restrict__ att_out,          // [B, U]
                   float* __restrict__ logits) {         // [B, V]
  using Sh = StepShape<U, E>;
  constexpr int kU = Sh::kU, kG = Sh::kG, kE = Sh::kE, kCols = Sh::kCols;
  constexpr int kHalves = Sh::kHalves, kUPL = Sh::kUPL;
  extern __shared__ __align__(16) float smem[];
  const StepSmem L = step_smem_layout<Sh>(S);
  float* attp = smem + L.attp;
  float* hp = smem + L.hp;
  float* hn = smem + L.hn;
  float* cn = smem + L.cn;
  float* an = smem + L.an;
  float* z = smem + L.z;
  float* ctx = smem + L.ctx;
  float* sc = smem + L.sc;
  __shared__ int s_tok[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);

  // ---- the rows' inputs (zeros for the rows past B)
  for (int i = tid; i < kRows * kU; i += kThreads) {
    const int j = i / kU;
    const bool live = j < nrows;
    const size_t g = (size_t)row0 * kU + i;
    attp[i] = live ? att_in[g] : 0.f;
    hp[i] = live ? h_in[g] : 0.f;
  }
  if (tid < kRows) s_tok[tid] = tid < nrows ? tok[row0 + tid] : V;
  __syncthreads();

  // ---- LSTM cell: z = onehot(tok).wx[:V] + att.wx[V:] + h.wh + b,
  // columns tid + q * kThreads for every row
  {
    float acc[kCols][kRows];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      const int col = tid + q * kThreads;
      const float bc = __ldg(bias + col);
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int tk = s_tok[j];
        acc[q][j] = bc + ((unsigned)tk < (unsigned)V ? __ldg(wx + (size_t)tk * kG + col) : 0.f);
      }
    }
#pragma unroll 2
    for (int k = 0; k < kU; ++k) {
      float wa[kCols], wr[kCols];
#pragma unroll
      for (int q = 0; q < kCols; ++q) {
        wa[q] = __ldg(wx + (size_t)(V + k) * kG + tid + q * kThreads);
        wr[q] = __ldg(wh + (size_t)k * kG + tid + q * kThreads);
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const float x = attp[j * kU + k], hv = hp[j * kU + k];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          acc[q][j] = fmaf(x, wa[q], acc[q][j]);
          acc[q][j] = fmaf(hv, wr[q], acc[q][j]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q)
#pragma unroll
      for (int j = 0; j < kRows; ++j) z[j * kG + tid + q * kThreads] = acc[q][j];
  }
  __syncthreads();
  for (int i = tid; i < kRows * kU; i += kThreads) {
    const int j = i / kU, u = i - j * kU;
    const float* zj = z + j * kG;
    const float cp = j < nrows ? c_in[(size_t)row0 * kU + i] : 0.f;
    const float cc = sigmoid_f(zj[kU + u]) * cp + sigmoid_f(zj[u]) * tanhf(zj[2 * kU + u]);
    const float hh = sigmoid_f(zj[3 * kU + u]) * tanhf(cc);
    cn[i] = cc;
    hn[i] = hh;
    if (j < nrows) {
      c_out[(size_t)row0 * kU + i] = cc;
      h_out[(size_t)row0 * kU + i] = hh;
    }
  }
  __syncthreads();

  // ---- scores: one warp per (row, position), U / 32 units a lane
#pragma unroll 4
  for (int i = warp; i < nrows * S; i += kWarps) {
    const int r = i / S, s = i - r * S;
    const size_t brow = (size_t)(row0 + r);
    float kv[kUPL];
    load_n<kUPL>(keys + (brow * S + s) * kU + kUPL * lane, kv);
    const float* q = hn + r * kU + kUPL * lane;
    float p = q[0] * kv[0];
#pragma unroll
    for (int c = 1; c < kUPL; ++c) p = fmaf(q[c], kv[c], p);
    p = warp_sum(p);
    if (lane == 0) sc[r * S + s] = mask[brow * S + s] ? p : kNegMax;
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += kWarps) warp_softmax<float>(sc + r * S, S, lane);
  __syncthreads();

  // ---- context: thread (column e0, position group pg) sums columns
  // e0 + q * kCtxCols of every row's values over its group's positions
  {
    constexpr int kCC = Sh::kCtxCols, kEP = Sh::kEPer, kPG = Sh::kPosGroups;
    const int e0 = tid % kCC, pg = kPG == 1 ? 0 : tid / kCC;
    float acc[kEP][kRows];
#pragma unroll
    for (int q = 0; q < kEP; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[q][r] = 0.f;
    const float* vbase = values + (size_t)row0 * S * kE + e0;
#pragma unroll 2
    for (int s = pg; s < S; s += kPG) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nrows)
#pragma unroll
          for (int q = 0; q < kEP; ++q)
            acc[q][r] = fmaf(sc[r * S + s], __ldg(vbase + ((size_t)r * S + s) * kE + q * kCC),
                             acc[q][r]);
    }
    float* out = kPG == 1 ? ctx : z + pg * kRows * kE;  // the group's partial sums
#pragma unroll
    for (int q = 0; q < kEP; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) out[r * kE + e0 + q * kCC] = acc[q][r];
    if constexpr (kPG > 1) {
      __syncthreads();
      for (int i = tid; i < kRows * kE; i += kThreads) {
        float c = z[i];
#pragma unroll
        for (int g = 1; g < kPG; ++g) c += z[g * kRows * kE + i];
        ctx[i] = c;
      }
    }
  }
  __syncthreads();

  // ---- att = [h; context].watt: thread (unit, one of the U / 256 groups of
  // the U+E input rows)
  {
    const int u = tid & (kU - 1), half = tid / kU;
    constexpr int kIn = kU + kE, kPer = kIn / kHalves;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = half * kPer; k < (half + 1) * kPer; ++k) {
      const float w = __ldg(watt + (size_t)k * kU + u);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = k < kU ? hn[r * kU + k] : ctx[r * kE + (k - kU)];
        acc[r] = fmaf(x, w, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) z[(half * kRows + r) * kU + u] = acc[r];
  }
  __syncthreads();
  for (int i = tid; i < kRows * kU; i += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) s += z[hh * kRows * kU + i];
    an[i] = s;
    if (i / kU < nrows) att_out[(size_t)row0 * kU + i] = s;
  }
  __syncthreads();

  // ---- logits [rows][V]: one warp per (row, column)
  for (int i = warp; i < nrows * V; i += kWarps) {
    const int r = i / V, v = i - r * V;
    float p = 0.f;
    for (int k = lane; k < kU; k += 32) p = fmaf(an[r * kU + k], __ldg(wfc + (size_t)k * V + v), p);
    p = warp_sum(p);
    if (lane == 0) logits[(size_t)(row0 + r) * V + v] = p + __ldg(bfc + v);
  }
}

// The arguments of one launch, as rv_decode_step receives them.
struct StepArgs {
  const int32_t* tok;
  const float *att_in, *h_in, *c_in, *keys, *values;
  const uint8_t* mask;
  const float *wx, *wh, *bias, *watt, *wfc, *bfc;
  float *h_out, *c_out, *att_out, *logits;
};

template <int U, int E>
int launch(int B, int S, int V, const StepArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)step_smem_layout<StepShape<U, E>>(S).total * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_step_kernel<U, E>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kRows - 1) / kRows;
  decode_step_kernel<U, E><<<grid, kThreads, smem, stream>>>(
      B, S, V, a.tok, a.att_in, a.h_in, a.c_in, a.keys, a.values, a.mask, a.wx, a.wh, a.bias,
      a.watt, a.wfc, a.bfc, a.h_out, a.c_out, a.att_out, a.logits);
  return (int)cudaGetLastError();
}

template <int U>
int dispatch_e(int E, int B, int S, int V, const StepArgs& a, cudaStream_t stream) {
#define RV_E_CASE(e) \
  case e:            \
    return launch<U, e>(B, S, V, a, stream);
  switch (E) {
    RV_GREEDY_MEMORY_DIMS(RV_E_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RV_E_CASE
}

}  // namespace

// U, E: the decoder units and the memory width, a pair of
// decode_step_shapes.cuh's sets (cudaErrorInvalidValue otherwise). Launches
// on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rv_decode_step(int U, int E, int B, int S, int V, const void* tok,
                              const void* att_in, const void* h_in, const void* c_in,
                              const void* keys, const void* values, const void* mask,
                              const void* wx, const void* wh, const void* bias, const void* watt,
                              const void* wfc, const void* bfc, void* h_out, void* c_out,
                              void* att_out, void* logits, void* stream) {
  if (B <= 0 || S <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const StepArgs a = {(const int32_t*)tok, (const float*)att_in, (const float*)h_in,
                      (const float*)c_in, (const float*)keys, (const float*)values,
                      (const uint8_t*)mask, (const float*)wx, (const float*)wh,
                      (const float*)bias, (const float*)watt, (const float*)wfc,
                      (const float*)bfc, (float*)h_out, (float*)c_out, (float*)att_out,
                      (float*)logits};
  const cudaStream_t st = (cudaStream_t)stream;
#define RV_U_CASE(u) \
  case u:            \
    return dispatch_e<u>(E, B, S, V, a, st);
  switch (U) {
    RV_GREEDY_UNITS(RV_U_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RV_U_CASE
}
