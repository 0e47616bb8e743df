// One beam-search decode step for every hypothesis of a batch, on int8
// memory.
//
// Replaces the TPU kernel ravvent_tpu/ops/beam_loop_pallas.py::_beam_step_kernel
// (entry point beam_step_decode) in its two int8 modes, memory with
// per-(row, position) scales (rv_beam_step_i8): "quant", the scales folded
// into the dequantized dots, and "quant_mxu", s8 x s8 -> s32 dots. bf16 and
// f32 memory (quant=False) run the two kernels of beam_step_f.cu. Per
// hypothesis:
// LSTM cell on [one-hot token | previous attention vector],
// Luong scores of h against the keys, softmax masked with finfo(f32).min
// (an all-masked row becomes uniform, as in the reference), context from the
// pre-projected values, att = h.watt_h + context, logits, log-softmax,
// finished beams continuing only through the end token, top-W over the
// flattened W x VP row by iterated first-index argmax (the reference's tie
// rule; vocabulary columns >= V are padding whose logit is finfo.min), and
// the beam permutation of h, c, att and the finished flags.
//
// What bounds it on the H100: memory bytes. Each step reads every row's int8
// keys and values once (B x S x U x 2 codes and 8 bytes of scales a
// position; 243 MB of codes per step at B=4096, S=232, U=128), against ~0.3
// GFLOP of f32 work per row-step. Design: one CTA per kRows batch rows (all
// W hypotheses of each). The TPU kernel pipelined batch tiles through VMEM;
// here each CTA streams its rows' keys and values from HBM exactly once,
// with coalesced loads (a warp reads one key row per position and four value
// rows, 4 codes a 32-bit word), and keeps every intermediate in shared
// memory. The decoder
// weights (~0.6 MB f32) are read through L2 once per CTA, shared by the
// kRows x W hypotheses of the CTA.
//
// int8 memory, as the reference folds the scales (beam_loop_pallas.py:374-420):
// quant: scores = (bf16(h) . codes) * kscale, then the mask; after the
//   softmax a = bf16(align * vscale), context = a . codes (f32 sums).
// quant_mxu: hq = rn(h * 127) (|h| < 1, no clip); scores = s32(hq . codes)
//   * (1/127) * kscale, then the mask; af = align * vscale, amax =
//   max(max_s af, 1e-30), aq = rn(af * (127 / amax)); context =
//   s32(aq . codes) * (amax / 127). The integer dots run on __dp4a: the
//   scores with the 4 codes of a key word, the context on value words whose
//   bytes are transposed in registers to 4 positions of one unit. Integer
//   sums are exact, so they equal the reference's in any order.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kU = 128;         // decoder units (the flagship's; the wrapper checks)
constexpr int kG = 4 * kU;
constexpr int kRows = 4;        // batch rows per CTA
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// memory modes: int8 "quant" (dequantized dots), int8 "quant_mxu" (integer
// dots)
constexpr int kQuant = 1, kQuantMxu = 2;

// Groups of positions the context product is split over: a thread owns a
// unit quad (32 quads x 8 groups).
__host__ __device__ constexpr int ctx_groups(int) { return 8; }

// Positions of one quantized alignment row, padded to whole 32-bit words.
__host__ __device__ constexpr int aq_stride(int S) { return (S + 3) & ~3; }

struct Smem {
  // offsets into the dynamic shared buffer, in floats
  int xin, hn, cn, att, sc, ctxp, aq, logit, flat;
  int total;
};

__host__ __device__ inline Smem smem_layout(int q, int W, int S, int V, int VP) {
  const int H = kRows * W;
  Smem s;
  int o = 0;
  s.xin = o;   o += 2 * kU * H;        // [2U][H]  (att_prev ; h_prev), transposed
  s.hn = o;    o += H * kU;            // [H][U]   new h
  s.cn = o;    o += H * kU;            // [H][U]   new c
  s.att = o;   o += H * kU;            // [H][U]   context, then the new attention vector
  s.sc = o;    o += W * S;             // [W][S]   scores, then alignments, of one row
  s.ctxp = o;  o += ctx_groups(q) * W * kU;  // [groups][W][U] partial contexts
  s.aq = o;    o += q == kQuantMxu ? W * aq_stride(S) / 4 : 0;  // [W][S] int8 alignments
  s.logit = o; o += H * V;             // [H][V]
  s.flat = o;  o += kRows * W * VP;    // [rows][W*VP] candidate totals
  s.total = o;
  return s;
}

// The 4 int8 codes of a 32-bit word as floats (exact).
__device__ __forceinline__ void codes4(int w, float v[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = (float)(int8_t)(w >> (8 * i));
}

// One batch row's attention on int8 memory: the scores of its W hypotheses
// (h in hn_row [W][U]), the masked softmax, the scale folds, and the
// context into ctx_row [W][U]. Uses sc, ctxp and (quant_mxu) aq of the
// shared buffer; all threads of the CTA call it.
template <int W, bool MXU>
__device__ __forceinline__ void attend_row_i8(const float* hn_row, const int8_t* __restrict__ K,
                                              const int8_t* __restrict__ Vv,
                                              const float* __restrict__ ks,
                                              const float* __restrict__ vs,
                                              const uint8_t* __restrict__ mrow, int S, float* sc,
                                              float* ctxp, int8_t* aq, float* s_amax,
                                              float* ctx_row) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int SQ = aq_stride(S);

  // scores: one warp per position, each lane one word of 4 codes; the
  // scale fold before the mask, as in the reference
  if constexpr (MXU) {
    int hq[W];  // 4 codes of h a word, units 4*lane..4*lane+3
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float* h = hn_row + w * kU + 4 * lane;
      unsigned word = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        word |= (unsigned)(__float2int_rn(h[i] * 127.f) & 0xff) << (8 * i);
      hq[w] = (int)word;
    }
    for (int s = warp; s < S; s += kWarps) {
      const int kw = __ldg(reinterpret_cast<const int*>(K + (size_t)s * kU) + lane);
      const bool m = mrow[s] != 0;
      const float k = __ldg(ks + s);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int p = __reduce_add_sync(0xffffffffu, __dp4a(hq[w], kw, 0));
        if (lane == 0) sc[w * S + s] = m ? (float)p * (1.f / 127.f) * k : kNegMax;
      }
    }
  } else {
    float q[W][4];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) q[w][i] = round_to<__nv_bfloat16>(hn_row[w * kU + 4 * lane + i]);
    for (int s = warp; s < S; s += kWarps) {
      float kv[4];
      codes4(__ldg(reinterpret_cast<const int*>(K + (size_t)s * kU) + lane), kv);
      const bool m = mrow[s] != 0;
      const float k = __ldg(ks + s);
#pragma unroll
      for (int w = 0; w < W; ++w) {
        float p = q[w][0] * kv[0];
        p = fmaf(q[w][1], kv[1], p);
        p = fmaf(q[w][2], kv[2], p);
        p = fmaf(q[w][3], kv[3], p);
        p = warp_sum(p);
        if (lane == 0) sc[w * S + s] = m ? p * k : kNegMax;
      }
    }
  }
  __syncthreads();

  // masked softmax (one warp per hypothesis), then the value scales folded
  // into the alignment: rounded to bf16 (quant), or quantized against the
  // row's max (quant_mxu). Each lane reads back only what it wrote.
  for (int w = warp; w < W; w += kWarps) {
    float* srow = sc + w * S;
    warp_softmax<float>(srow, S, lane);
    if constexpr (MXU) {
      float mx = 0.f;  // af >= 0
      for (int s = lane; s < S; s += 32) {
        const float af = srow[s] * __ldg(vs + s);
        srow[s] = af;
        mx = fmaxf(mx, af);
      }
      mx = fmaxf(warp_max(mx), 1e-30f);
      const float r = 127.f / mx;
      int8_t* arow = aq + w * SQ;
      for (int s = lane; s < SQ; s += 32) arow[s] = s < S ? (int8_t)__float2int_rn(srow[s] * r) : 0;
      if (lane == 0) s_amax[w] = mx;
    } else {
      for (int s = lane; s < S; s += 32) srow[s] = round_to<__nv_bfloat16>(srow[s] * __ldg(vs + s));
    }
  }
  __syncthreads();

  // context: thread = (unit quad j, group g of 4-position blocks); a warp
  // reads 4 whole value rows (128 B each) per block
  {
    const int j = tid & 31, g = tid >> 5;
    using Acc = typename std::conditional<MXU, int, float>::type;
    Acc acc[W][4];
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[w][u] = 0;
    for (int s0 = 4 * g; s0 < S; s0 += 4 * ctx_groups(kQuant)) {
      int v[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        v[p] = s0 + p < S ? __ldg(reinterpret_cast<const int*>(Vv + (size_t)(s0 + p) * kU) + j) : 0;
      if constexpr (MXU) {
        // transpose the 4 x 4 bytes: t[u] = unit 4j+u at positions s0..s0+3
        const unsigned lo01 = __byte_perm(v[0], v[1], 0x5140);  // v0.b0 v1.b0 v0.b1 v1.b1
        const unsigned hi01 = __byte_perm(v[0], v[1], 0x7362);  // v0.b2 v1.b2 v0.b3 v1.b3
        const unsigned lo23 = __byte_perm(v[2], v[3], 0x5140);
        const unsigned hi23 = __byte_perm(v[2], v[3], 0x7362);
        const int t[4] = {(int)__byte_perm(lo01, lo23, 0x5410),
                          (int)__byte_perm(lo01, lo23, 0x7632),
                          (int)__byte_perm(hi01, hi23, 0x5410),
                          (int)__byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int a = *reinterpret_cast<const int*>(aq + w * SQ + s0);
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[w][u] = __dp4a(t[u], a, acc[w][u]);
        }
      } else {
        float c[4][4];  // c[p][u]
#pragma unroll
        for (int p = 0; p < 4; ++p) codes4(v[p], c[p]);
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float a = s0 + p < S ? sc[w * S + s0 + p] : 0.f;
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[w][u] = fmaf(a, c[p][u], acc[w][u]);
          }
      }
    }
    Acc* part = reinterpret_cast<Acc*>(ctxp);
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int u = 0; u < 4; ++u) part[(g * W + w) * kU + 4 * j + u] = acc[w][u];
  }
  __syncthreads();
  for (int i = tid; i < W * kU; i += kThreads) {
    const int w = i / kU;
    if constexpr (MXU) {
      const int* part = reinterpret_cast<const int*>(ctxp);
      int sum = 0;
#pragma unroll
      for (int g = 0; g < ctx_groups(kQuantMxu); ++g) sum += part[g * W * kU + i];
      ctx_row[i] = (float)sum * (s_amax[w] / 127.f);
    } else {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < ctx_groups(kQuant); ++g) sum += ctxp[g * W * kU + i];
      ctx_row[i] = sum;
    }
  }
  __syncthreads();
}

template <typename M, int W, int Q>
__global__ void __launch_bounds__(kThreads)
beam_step_kernel(int B, int S, int V, int VP, int end_token,
                 const int32_t* __restrict__ tok_in,   // [B*W]
                 const float* __restrict__ h_in,       // [B*W, U]
                 const float* __restrict__ c_in,       // [B*W, U]
                 const float* __restrict__ att_in,     // [B*W, U]
                 const float* __restrict__ cum_in,     // [B, W]
                 const uint8_t* __restrict__ fin_in,   // [B, W]
                 const M* __restrict__ keys,           // [B, S, U]
                 const M* __restrict__ values,         // [B, S, U] (pre-projected)
                 const float* __restrict__ kscale,     // [B, S] (int8 memory only)
                 const float* __restrict__ vscale,     // [B, S] (int8 memory only)
                 const uint8_t* __restrict__ mask,     // [B, S]
                 const float* __restrict__ wx,         // [V+U, 4U]
                 const float* __restrict__ wh,         // [U, 4U]
                 const float* __restrict__ bias,       // [4U]
                 const float* __restrict__ watt_h,     // [U, U]
                 const float* __restrict__ wfc,        // [U, V]
                 const float* __restrict__ bfc,        // [V]
                 int32_t* __restrict__ tok_out,        // [B*W]
                 int32_t* __restrict__ par_out,        // [B, W]
                 float* __restrict__ h_out,
                 float* __restrict__ c_out,
                 float* __restrict__ att_out,
                 float* __restrict__ cum_out,          // [B, W]
                 uint8_t* __restrict__ fin_out) {      // [B, W]
  constexpr int H = kRows * W;        // hypotheses of this CTA
  constexpr int HH = H / 2;           // per thread half (H is even: kRows is)
  extern __shared__ float smem[];
  const Smem L = smem_layout(Q, W, S, V, VP);
  float* xin = smem + L.xin;
  float* hn = smem + L.hn;
  float* cn = smem + L.cn;
  float* att = smem + L.att;
  float* sc = smem + L.sc;
  float* ctxp = smem + L.ctxp;
  float* logit = smem + L.logit;
  float* flat = smem + L.flat;
  __shared__ int s_tok[H];
  __shared__ int s_par[H];
  __shared__ float s_lse[H];
  __shared__ float s_amax[W];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, B - row0);
  const int nh = nrows * W;           // live hypotheses
  const size_t hyp0 = (size_t)row0 * W;

  // ---- inputs of the cell: xin[k][j] = att_prev (k < U), h_prev (k >= U)
  for (int i = tid; i < H * kU; i += kThreads) {
    const int j = i / kU, k = i - j * kU;
    const bool live = j < nh;
    xin[k * H + j] = live ? att_in[(hyp0 + j) * kU + k] : 0.f;
    xin[(kU + k) * H + j] = live ? h_in[(hyp0 + j) * kU + k] : 0.f;
  }
  if (tid < H) s_tok[tid] = tid < nh ? tok_in[hyp0 + tid] : V;
  __syncthreads();

  // ---- LSTM cell: z = onehot(tok).wx[:V] + att.wx[V:] + h.wh + b
  {
    const int u = tid & (kU - 1);
    const int j0 = (tid >> 7) * HH;
    float acc[4][HH];
#pragma unroll
    for (int j = 0; j < HH; ++j) {
      const int tk = s_tok[j0 + j];
#pragma unroll
      for (int g = 0; g < 4; ++g)
        acc[g][j] = bias[g * kU + u] + (tk < V ? __ldg(wx + (size_t)tk * kG + g * kU + u) : 0.f);
    }
#pragma unroll 2
    for (int k = 0; k < 2 * kU; ++k) {
      const float* w = k < kU ? wx + (size_t)(V + k) * kG + u : wh + (size_t)(k - kU) * kG + u;
      const float w0 = __ldg(w), w1 = __ldg(w + kU), w2 = __ldg(w + 2 * kU), w3 = __ldg(w + 3 * kU);
      const float* xr = xin + k * H + j0;
#pragma unroll
      for (int j = 0; j < HH; ++j) {
        const float xv = xr[j];
        acc[0][j] = fmaf(xv, w0, acc[0][j]);
        acc[1][j] = fmaf(xv, w1, acc[1][j]);
        acc[2][j] = fmaf(xv, w2, acc[2][j]);
        acc[3][j] = fmaf(xv, w3, acc[3][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < HH; ++j) {
      const int hj = j0 + j;
      const float cp = hj < nh ? c_in[(hyp0 + hj) * kU + u] : 0.f;
      const float c = sigmoid_f(acc[1][j]) * cp + sigmoid_f(acc[0][j]) * tanhf(acc[2][j]);
      cn[hj * kU + u] = c;
      hn[hj * kU + u] = sigmoid_f(acc[3][j]) * tanhf(c);
    }
  }
  __syncthreads();

  // ---- attention, one batch row at a time (its W hypotheses together)
  for (int r = 0; r < nrows; ++r) {
    const size_t brow = (size_t)(row0 + r);
    const M* K = keys + brow * S * kU;
    const M* Vv = values + brow * S * kU;
    const uint8_t* mrow = mask + brow * S;
    attend_row_i8<W, Q == kQuantMxu>(hn + r * W * kU, K, Vv, kscale + brow * S,
                                      vscale + brow * S, mrow, S, sc, ctxp,
                                      reinterpret_cast<int8_t*>(smem + L.aq), s_amax,
                                      att + r * W * kU);
  }

  // ---- attention vector: att = h.watt_h + context (in place over the context)
  {
    const int u = tid & (kU - 1);
    const int j0 = (tid >> 7) * HH;
    float acc[HH];
#pragma unroll
    for (int j = 0; j < HH; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < kU; ++k) {
      const float w = __ldg(watt_h + (size_t)k * kU + u);
#pragma unroll
      for (int j = 0; j < HH; ++j) acc[j] = fmaf(hn[(j0 + j) * kU + k], w, acc[j]);
    }
#pragma unroll
    for (int j = 0; j < HH; ++j) att[(j0 + j) * kU + u] += acc[j];
  }
  __syncthreads();

  // ---- logits [H][V]
  for (int i = tid; i < H * V; i += kThreads) {
    const int j = i / V, v = i - j * V;
    float acc = 0.f;
    for (int k = 0; k < kU; ++k) acc = fmaf(att[j * kU + k], __ldg(wfc + (size_t)k * V + v), acc);
    logit[i] = acc + bfc[v];
  }
  __syncthreads();

  // log-sum-exp per hypothesis (padding columns add exp(finfo.min - max) = 0)
  if (tid < H) {
    const float* l = logit + tid * V;
    float m = l[0];
    for (int v = 1; v < V; ++v) m = fmaxf(m, l[v]);
    float sum = 0.f;
    for (int v = 0; v < V; ++v) sum += expf(l[v] - m);
    s_lse[tid] = logf(sum) + m;
  }
  __syncthreads();

  // candidate totals: flat[r][w*VP + v] = cum + step log-prob; finished
  // beams continue only through the end token; padding columns carry
  // cum + finfo.min (their log-prob is finfo.min - lse == finfo.min)
  for (int i = tid; i < nrows * W * VP; i += kThreads) {
    const int r = i / (W * VP), rem = i - r * W * VP;
    const int w = rem / VP, v = rem - w * VP;
    const int j = r * W + w;
    const size_t bw = (size_t)(row0 + r) * W + w;
    const bool fin = fin_in[bw] != 0;
    float lp;
    if (v >= V) lp = kNegMax;
    else if (fin) lp = v == end_token ? 0.f : kNegMax;
    else lp = logit[j * V + v] - s_lse[j];
    flat[i] = cum_in[bw] + lp;
  }
  __syncthreads();

  // top-W by iterated first-index argmax, one warp per batch row
  if (warp < nrows) {
    const int r = warp;
    float* f = flat + r * W * VP;
    const int n = W * VP;
    for (int k = 0; k < W; ++k) {
      float best;
      int bi;
      warp_argmax(f, n, lane, best, bi);
      if (lane == 0) {
        const size_t bw = (size_t)(row0 + r) * W + k;
        const int parent = bi / VP, token = bi - parent * VP;
        f[bi] = kNegMax;
        cum_out[bw] = best;
        tok_out[bw] = token;
        par_out[bw] = parent;
        fin_out[bw] = (fin_in[(size_t)(row0 + r) * W + parent] != 0 || token == end_token) ? 1 : 0;
        s_tok[r * W + k] = token;
        s_par[r * W + k] = r * W + parent;
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- beam permutation of the recurrent state
  for (int i = tid; i < nh * kU; i += kThreads) {
    const int j = i / kU, u = i - j * kU;
    const int p = s_par[j];
    const size_t o = (hyp0 + j) * kU + u;
    h_out[o] = hn[p * kU + u];
    c_out[o] = cn[p * kU + u];
    att_out[o] = att[p * kU + u];
  }
}

// The step's operands, as the C entry points receive them.
struct StepArgs {
  int B, S, V, VP, end_token;
  const void *tok_in, *h_in, *c_in, *att_in, *cum_in, *fin_in, *keys, *values, *kscale,
      *vscale, *mask, *wx, *wh, *bias, *watt_h, *wfc, *bfc;
  void *tok_out, *par_out, *h_out, *c_out, *att_out, *cum_out, *fin_out;
};

template <typename M, int W, int Q>
int launch(const StepArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)smem_layout(Q, W, a.S, a.V, a.VP).total * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(beam_step_kernel<M, W, Q>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (a.B + kRows - 1) / kRows;
  beam_step_kernel<M, W, Q><<<grid, kThreads, smem, stream>>>(
      a.B, a.S, a.V, a.VP, a.end_token, (const int32_t*)a.tok_in, (const float*)a.h_in,
      (const float*)a.c_in, (const float*)a.att_in, (const float*)a.cum_in,
      (const uint8_t*)a.fin_in, (const M*)a.keys, (const M*)a.values, (const float*)a.kscale,
      (const float*)a.vscale, (const uint8_t*)a.mask, (const float*)a.wx, (const float*)a.wh,
      (const float*)a.bias, (const float*)a.watt_h, (const float*)a.wfc, (const float*)a.bfc,
      (int32_t*)a.tok_out, (int32_t*)a.par_out, (float*)a.h_out, (float*)a.c_out,
      (float*)a.att_out, (float*)a.cum_out, (uint8_t*)a.fin_out);
  return (int)cudaGetLastError();
}

template <typename M, int Q>
int dispatch_w(int W, const StepArgs& a, cudaStream_t st) {
  switch (W) {
    case 1: return launch<M, 1, Q>(a, st);
    case 2: return launch<M, 2, Q>(a, st);
    case 3: return launch<M, 3, Q>(a, st);
    case 4: return launch<M, 4, Q>(a, st);
    case 5: return launch<M, 5, Q>(a, st);
    case 8: return launch<M, 8, Q>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

bool bad_shape(int B, int S, int V, int VP, int end_token) {
  return B <= 0 || S <= 0 || V <= 0 || V > VP || end_token < 0 || end_token >= V;
}

}  // namespace

// int8 keys/values [B, S, U] with f32 scales kscale, vscale [B, S]; mxu: 1
// for quant_mxu (integer dots), 0 for quant (dequantized dots). Beam widths
// 1-5 and 8. Launches on `stream`; returns cudaGetLastError().
extern "C" int rv_beam_step_i8(int mxu, int W, int B, int S, int V, int VP, int end_token,
                               const void* tok_in, const void* h_in, const void* c_in,
                               const void* att_in, const void* cum_in, const void* fin_in,
                               const void* keys, const void* values, const void* kscale,
                               const void* vscale, const void* mask, const void* wx,
                               const void* wh, const void* bias, const void* watt_h,
                               const void* wfc, const void* bfc, void* tok_out, void* par_out,
                               void* h_out, void* c_out, void* att_out, void* cum_out,
                               void* fin_out, void* stream) {
  if (bad_shape(B, S, V, VP, end_token)) return (int)cudaErrorInvalidValue;
  const StepArgs a{B, S, V, VP, end_token, tok_in, h_in, c_in, att_in, cum_in, fin_in, keys,
                   values, kscale, vscale, mask, wx, wh, bias, watt_h, wfc, bfc, tok_out,
                   par_out, h_out, c_out, att_out, cum_out, fin_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (mxu) return dispatch_w<int8_t, kQuantMxu>(W, a, st);
  return dispatch_w<int8_t, kQuant>(W, a, st);
}
