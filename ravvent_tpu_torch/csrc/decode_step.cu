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
// U = 128, E = 256 (0.44 ms at 3.35 TB/s), against ~2.2 GFLOP of f32 work.
// Design: one CTA per kRows batch rows. The TPU kernel pipelined batch tiles
// of memory through VMEM; here each CTA streams its rows' keys and values
// from HBM exactly once with coalesced loads (a warp reads one 512-byte key
// row per position; 256 threads read one 1 KiB value row per position, eight
// rows' loads in flight per thread) and keeps every intermediate in shared
// memory. The decoder weights (~0.7 MB f32) are read through L2 once per CTA
// and shared by its kRows rows: two gate columns per thread in the cell, one
// unit and half the input rows per thread in the attention layer.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "common.cuh"

namespace {

constexpr int kU = 128;        // decoder units (the wrapper checks)
constexpr int kG = 4 * kU;     // gate columns
constexpr int kE = 256;        // memory width (2 x 128 encoder units)
constexpr int kRows = 8;       // batch rows per CTA
constexpr int kThreads = 256;  // == kE: one memory column per thread in the context
constexpr int kWarps = kThreads / 32;
constexpr int kCols = kG / kThreads;  // gate columns per thread
constexpr int kHalves = kThreads / kU;

static_assert(kThreads == kE, "the context product gives each thread one memory column");

// float offsets into the dynamic shared buffer
struct StepSmem {
  int attp, hp, hn, cn, an, z, ctx, sc, total;
};

__host__ __device__ inline StepSmem step_smem_layout(int S) {
  StepSmem L;
  int o = 0;
  L.attp = o; o += kRows * kU;  // [R][U] previous attention vector
  L.hp = o;   o += kRows * kU;  // [R][U] previous h
  L.hn = o;   o += kRows * kU;  // [R][U] new h
  L.cn = o;   o += kRows * kU;  // [R][U] new c
  L.an = o;   o += kRows * kU;  // [R][U] new attention vector
  L.z = o;    o += kRows * kG;  // [R][4U] gates, then [halves][R][U] partial att
  L.ctx = o;  o += kRows * kE;  // [R][E] context
  L.sc = o;   o += kRows * S;   // [R][S] scores, then alignments
  L.total = o;
  return L;
}

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
  extern __shared__ __align__(16) float smem[];
  const StepSmem L = step_smem_layout(S);
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
        const float a = attp[j * kU + k], hv = hp[j * kU + k];
#pragma unroll
        for (int q = 0; q < kCols; ++q) {
          acc[q][j] = fmaf(a, wa[q], acc[q][j]);
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

  // ---- scores: one warp per (row, position), 4 units a lane
#pragma unroll 4
  for (int i = warp; i < nrows * S; i += kWarps) {
    const int r = i / S, s = i - r * S;
    const size_t brow = (size_t)(row0 + r);
    float kv[4];
    load4(keys + (brow * S + s) * kU + 4 * lane, kv);
    const float* q = hn + r * kU + 4 * lane;
    float p = q[0] * kv[0];
    p = fmaf(q[1], kv[1], p);
    p = fmaf(q[2], kv[2], p);
    p = fmaf(q[3], kv[3], p);
    p = warp_sum(p);
    if (lane == 0) sc[r * S + s] = mask[brow * S + s] ? p : kNegMax;
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += kWarps) warp_softmax<float>(sc + r * S, S, lane);
  __syncthreads();

  // ---- context: thread e sums column e of every row's values
  {
    const int e = tid;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const float* vbase = values + (size_t)row0 * S * kE + e;
#pragma unroll 2
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nrows)
          acc[r] = fmaf(sc[r * S + s], __ldg(vbase + ((size_t)r * S + s) * kE), acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) ctx[r * kE + e] = acc[r];
  }
  __syncthreads();

  // ---- att = [h; context].watt: thread (unit, half of the U+E input rows)
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
    float a = 0.f;
#pragma unroll
    for (int hh = 0; hh < kHalves; ++hh) a += z[hh * kRows * kU + i];
    an[i] = a;
    if (i / kU < nrows) att_out[(size_t)row0 * kU + i] = a;
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

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rv_decode_step(int B, int S, int V, const void* tok, const void* att_in,
                              const void* h_in, const void* c_in, const void* keys,
                              const void* values, const void* mask, const void* wx,
                              const void* wh, const void* bias, const void* watt, const void* wfc,
                              const void* bfc, void* h_out, void* c_out, void* att_out,
                              void* logits, void* stream) {
  if (B <= 0 || S <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)step_smem_layout(S).total * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + kRows - 1) / kRows;
  decode_step_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      B, S, V, (const int32_t*)tok, (const float*)att_in, (const float*)h_in, (const float*)c_in,
      (const float*)keys, (const float*)values, (const uint8_t*)mask, (const float*)wx,
      (const float*)wh, (const float*)bias, (const float*)watt, (const float*)wfc,
      (const float*)bfc, (float*)h_out, (float*)c_out, (float*)att_out, (float*)logits);
  return (int)cudaGetLastError();
}
