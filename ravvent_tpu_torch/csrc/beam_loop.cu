// The whole beam-search decode loop of one batch row in one CTA.
//
// Replaces the TPU kernel ravvent_tpu/ops/beam_loop_pallas.py::_beam_loop_kernel
// (entry point beam_loop_decode; pre-projected bf16 or f32 memory, depth-1
// LSTM, Luong). Each step has the per-step kernel's semantics (beam_step_f.cu):
// LSTM cell on [one-hot token | previous attention vector], Luong scores of h
// against the keys, softmax masked with finfo(f32).min, context from the
// pre-projected values, att = h.watt_h + context, logits, log-softmax,
// finished beams continuing only through the end token, top-W over the
// flattened W x 128 row by iterated first-index argmax (columns >= V are
// padding at cum + finfo.min), and the beam permutation of h, c and att.
// Writes the token, parent and cumulative score of each of the eff live
// steps; the steps from eff on are left to the caller's zeros.
//
// What bounds it on the H100: f32 operations. Over a chunk of B = 4096 rows,
// W = 5 and 39 steps the cell, attention-vector and logit products are
// ~243 GFLOP of f32 FMA work (3.6 ms at 67 TFLOP/s), while the memory is read
// from HBM once (~0.5 GB, 0.15 ms). Design: the TPU kernel kept a 16-row tile's
// memory in VMEM for the whole loop; a Hopper block has at most 227 KB of
// shared memory, and one row of bf16 keys plus values (2 x 232 x 128 x 2 B =
// 116 KiB) fits while two do not. So one CTA runs one batch row: it loads the
// row's keys (and, for bf16 memory, its values) into shared memory once and
// then loops over the steps; h, c, att, the scores and the beam bookkeeping
// stay in shared memory. f32 memory is twice as large: its keys stay
// resident and its values are read from global memory (L2) every step. The
// decoder weights (~0.6 MB f32) do not fit beside the memory; they stream
// through L2 once per CTA per step, one gate column per thread, shared by the
// W hypotheses of the row. That L2 traffic (0.6 MB x B x steps) and one CTA
// per SM are expected to limit this simple kernel (PERF.md).
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "common.cuh"

namespace {

constexpr int kU = 128;                 // decoder units (the wrapper checks)
constexpr int kG = 4 * kU;              // gate columns
constexpr int kVP = 128;                // padded vocabulary width of the top-W row
constexpr int kThreads = kG;            // one gate column per thread in the cell
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / kU;  // position groups of the context product

struct LoopSmem {
  // byte offsets into the dynamic shared buffer
  int keys, values, floats, mask, total;
  // float offsets from `floats`
  int h, c, att, hn, cn, an, z, sc, logit, flat;
};

__host__ __device__ inline LoopSmem loop_smem_layout(int mem_bytes, int W, int S, int V) {
  LoopSmem L;
  const int row = S * kU * mem_bytes;  // one row of keys (or values), a multiple of 256 B
  L.keys = 0;
  L.values = row;
  L.floats = mem_bytes == 2 ? 2 * row : row;  // f32 values stay in global memory
  int o = 0;
  L.h = o;     o += W * kU;      // [W][U] state, beam-permuted
  L.c = o;     o += W * kU;
  L.att = o;   o += W * kU;
  L.hn = o;    o += W * kU;      // [W][U] this step's new h, c, att
  L.cn = o;    o += W * kU;
  L.an = o;    o += W * kU;
  L.z = o;     o += W * kG;      // [W][4U] gates, then [kGroups][W][U] partial att
  L.sc = o;    o += W * S;       // [W][S] scores, then alignments
  L.logit = o; o += W * V;       // [W][V]
  L.flat = o;  o += W * kVP;     // [W*VP] candidate totals
  L.mask = L.floats + 4 * o;
  L.total = L.mask + ((S + 15) / 16) * 16;
  return L;
}

template <typename M, int W>
__global__ void __launch_bounds__(kThreads, 1)
beam_loop_kernel(int S, int V, int T, int eff, int start_token, int end_token,
                 const M* __restrict__ keys,           // [B, S, U]
                 const M* __restrict__ values,         // [B, S, U] (pre-projected)
                 const uint8_t* __restrict__ mask,     // [B, S]
                 const float* __restrict__ wx,         // [V+U, 4U]
                 const float* __restrict__ wh,         // [U, 4U]
                 const float* __restrict__ bias,       // [4U]
                 const float* __restrict__ watt_h,     // [U, U]
                 const float* __restrict__ wfc,        // [U, V]
                 const float* __restrict__ bfc,        // [V]
                 int32_t* __restrict__ tok_out,        // [T, B, W]
                 int32_t* __restrict__ par_out,        // [T, B, W]
                 float* __restrict__ score_out) {      // [T, B, W]
  constexpr bool kResidentValues = sizeof(M) == 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LoopSmem L = loop_smem_layout((int)sizeof(M), W, S, V);
  M* sk = reinterpret_cast<M*>(smem_raw + L.keys);
  M* sv = reinterpret_cast<M*>(smem_raw + L.values);
  float* F = reinterpret_cast<float*>(smem_raw + L.floats);
  float* h = F + L.h;
  float* c = F + L.c;
  float* att = F + L.att;
  float* hn = F + L.hn;
  float* cn = F + L.cn;
  float* an = F + L.an;
  float* z = F + L.z;
  float* sc = F + L.sc;
  float* logit = F + L.logit;
  float* flat = F + L.flat;
  uint8_t* smask = smem_raw + L.mask;
  __shared__ int s_tok[W], s_ntok[W], s_npar[W];
  __shared__ float s_cum[W], s_ncum[W], s_lse[W];
  __shared__ uint8_t s_fin[W], s_nfin[W];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = gridDim.x;
  const size_t row = blockIdx.x;
  const M* vrow = values + row * S * kU;  // read per step when not resident

  // ---- the row's memory into shared memory, once
  {
    const int n16 = S * kU * (int)sizeof(M) / 16;
    const uint4* ks = reinterpret_cast<const uint4*>(keys + row * S * kU);
    uint4* kd = reinterpret_cast<uint4*>(sk);
    for (int i = tid; i < n16; i += kThreads) kd[i] = __ldg(ks + i);
    if (kResidentValues) {
      const uint4* vs = reinterpret_cast<const uint4*>(vrow);
      uint4* vd = reinterpret_cast<uint4*>(sv);
      for (int i = tid; i < n16; i += kThreads) vd[i] = __ldg(vs + i);
    }
    for (int s = tid; s < S; s += kThreads) smask[s] = mask[row * S + s];
  }
  for (int i = tid; i < W * kU; i += kThreads) h[i] = c[i] = att[i] = 0.f;
  if (tid < W) {
    s_tok[tid] = start_token;
    s_cum[tid] = tid == 0 ? 0.f : kNegMax;  // step 1 expands beam 0 only
    s_fin[tid] = 0;
  }
  __syncthreads();

  for (int t = 0; t < eff; ++t) {
    // ---- LSTM cell: z = onehot(tok).wx[:V] + att.wx[V:] + h.wh + b, one column per thread
    {
      const int col = tid;
      float acc[W];
      const float bc = __ldg(bias + col);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const int tk = s_tok[j];
        acc[j] = bc + ((unsigned)tk < (unsigned)V ? __ldg(wx + (size_t)tk * kG + col) : 0.f);
      }
#pragma unroll 4
      for (int k = 0; k < kU; ++k) {
        const float wa = __ldg(wx + (size_t)(V + k) * kG + col);
        const float wr = __ldg(wh + (size_t)k * kG + col);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          acc[j] = fmaf(att[j * kU + k], wa, acc[j]);
          acc[j] = fmaf(h[j * kU + k], wr, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) z[j * kG + col] = acc[j];
    }
    __syncthreads();
    for (int i = tid; i < W * kU; i += kThreads) {
      const int j = i / kU, u = i - j * kU;
      const float* zj = z + j * kG;
      const float cc = sigmoid_f(zj[kU + u]) * c[i] + sigmoid_f(zj[u]) * tanhf(zj[2 * kU + u]);
      cn[i] = cc;
      hn[i] = sigmoid_f(zj[3 * kU + u]) * tanhf(cc);
    }
    __syncthreads();

    // ---- scores over the resident keys: one warp per position, 4 units a lane
    {
      float q[W][4];
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int i = 0; i < 4; ++i) q[w][i] = round_to<M>(hn[w * kU + 4 * lane + i]);
      for (int s = warp; s < S; s += kWarps) {
        float kv[4];
        lds4(sk + (size_t)s * kU + 4 * lane, kv);
        const bool m = smask[s] != 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float p = q[w][0] * kv[0];
          p = fmaf(q[w][1], kv[1], p);
          p = fmaf(q[w][2], kv[2], p);
          p = fmaf(q[w][3], kv[3], p);
          p = warp_sum(p);
          if (lane == 0) sc[w * S + s] = m ? p : kNegMax;
        }
      }
    }
    __syncthreads();
    for (int w = warp; w < W; w += kWarps) warp_softmax<M>(sc + w * S, S, lane);
    __syncthreads();

    // ---- att = h.watt_h + context: thread (unit, group) sums its group's
    // positions and its quarter of watt_h's rows; the partials land in z
    {
      const int u = tid & (kU - 1), g = tid / kU;
      float acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0.f;
#pragma unroll 2
      for (int s = g; s < S; s += kGroups) {
        float v;
        if constexpr (kResidentValues) v = to_float(sv[(size_t)s * kU + u]);
        else v = to_float(__ldg(vrow + (size_t)s * kU + u));
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = fmaf(sc[w * S + s], v, acc[w]);
      }
      constexpr int kq = kU / kGroups;
#pragma unroll 4
      for (int k = g * kq; k < (g + 1) * kq; ++k) {
        const float wv = __ldg(watt_h + (size_t)k * kU + u);
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] = fmaf(hn[w * kU + k], wv, acc[w]);
      }
#pragma unroll
      for (int w = 0; w < W; ++w) z[(g * W + w) * kU + u] = acc[w];
    }
    __syncthreads();
    for (int i = tid; i < W * kU; i += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) a += z[g * W * kU + i];
      an[i] = a;
    }
    __syncthreads();

    // ---- logits [W][V]: one warp per (beam, column)
    for (int i = warp; i < W * V; i += kWarps) {
      const int j = i / V, v = i - j * V;
      float p = 0.f;
      for (int k = lane; k < kU; k += 32)
        p = fmaf(an[j * kU + k], __ldg(wfc + (size_t)k * V + v), p);
      p = warp_sum(p);
      if (lane == 0) logit[i] = p + __ldg(bfc + v);
    }
    __syncthreads();
    // log-sum-exp per beam (padding columns add exp(finfo.min - max) = 0)
    if (tid < W) {
      const float* l = logit + tid * V;
      float m = l[0];
      for (int v = 1; v < V; ++v) m = fmaxf(m, l[v]);
      float sum = 0.f;
      for (int v = 0; v < V; ++v) sum += expf(l[v] - m);
      s_lse[tid] = logf(sum) + m;
    }
    __syncthreads();

    // ---- candidate totals: cum + step log-prob; finished beams continue
    // only through the end token; padding columns carry cum + finfo.min
    for (int i = tid; i < W * kVP; i += kThreads) {
      const int w = i / kVP, v = i - w * kVP;
      float lp;
      if (v >= V) lp = kNegMax;
      else if (s_fin[w]) lp = v == end_token ? 0.f : kNegMax;
      else lp = logit[w * V + v] - s_lse[w];
      flat[i] = s_cum[w] + lp;
    }
    __syncthreads();

    // ---- top-W by iterated first-index argmax (warp 0)
    if (warp == 0) {
      for (int k = 0; k < W; ++k) {
        float best;
        int bi;
        warp_argmax(flat, W * kVP, lane, best, bi);
        if (lane == 0) {
          const int parent = bi / kVP, token = bi - parent * kVP;
          flat[bi] = kNegMax;
          s_ncum[k] = best;
          s_ntok[k] = token;
          s_npar[k] = parent;
          s_nfin[k] = (s_fin[parent] != 0 || token == end_token) ? 1 : 0;
          const size_t o = ((size_t)t * B + row) * W + k;
          tok_out[o] = token;
          par_out[o] = parent;
          score_out[o] = best;
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // ---- beam permutation of the recurrent state
    for (int i = tid; i < W * kU; i += kThreads) {
      const int j = i / kU, u = i - j * kU;
      const int p = s_npar[j] * kU + u;
      h[i] = hn[p];
      c[i] = cn[p];
      att[i] = an[p];
    }
    if (tid < W) {
      s_tok[tid] = s_ntok[tid];
      s_cum[tid] = s_ncum[tid];
      s_fin[tid] = s_nfin[tid];
    }
    __syncthreads();
  }
}

template <typename M, int W>
int launch(int B, int S, int V, int T, int eff, int start_token, int end_token,
           const void* keys, const void* values, const void* mask, const void* wx,
           const void* wh, const void* bias, const void* watt_h, const void* wfc,
           const void* bfc, void* tok_out, void* par_out, void* score_out,
           cudaStream_t stream) {
  const int smem = loop_smem_layout((int)sizeof(M), W, S, V).total;
  cudaError_t e = cudaFuncSetAttribute(beam_loop_kernel<M, W>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  beam_loop_kernel<M, W><<<B, kThreads, smem, stream>>>(
      S, V, T, eff, start_token, end_token, (const M*)keys, (const M*)values,
      (const uint8_t*)mask, (const float*)wx, (const float*)wh, (const float*)bias,
      (const float*)watt_h, (const float*)wfc, (const float*)bfc, (int32_t*)tok_out,
      (int32_t*)par_out, (float*)score_out);
  return (int)cudaGetLastError();
}

template <typename M>
int dispatch_w(int W, int B, int S, int V, int T, int eff, int start_token, int end_token,
               const void* a0, const void* a1, const void* a2, const void* a3, const void* a4,
               const void* a5, const void* a6, const void* a7, const void* a8, void* o0,
               void* o1, void* o2, cudaStream_t st) {
#define RV_LOOP_CASE(WW)                                                                      \
  case WW:                                                                                    \
    return launch<M, WW>(B, S, V, T, eff, start_token, end_token, a0, a1, a2, a3, a4, a5, a6, \
                         a7, a8, o0, o1, o2, st);
  switch (W) {
    RV_LOOP_CASE(1)
    RV_LOOP_CASE(2)
    RV_LOOP_CASE(3)
    RV_LOOP_CASE(4)
    RV_LOOP_CASE(5)
    RV_LOOP_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RV_LOOP_CASE
}

}  // namespace

// Dynamic shared memory, in bytes, that one CTA of rv_beam_loop needs.
extern "C" int rv_beam_loop_smem(int mem_bf16, int W, int S, int V) {
  return loop_smem_layout(mem_bf16 ? 2 : 4, W, S, V).total;
}

// mem_bf16: 1 when keys/values are bf16, 0 when f32. Beam widths 1-5 and 8.
// Outputs [T, B, W]: steps [0, eff) are written, the rest left as they are.
// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rv_beam_loop(int mem_bf16, int W, int B, int S, int V, int T, int eff,
                            int start_token, int end_token, const void* keys, const void* values,
                            const void* mask, const void* wx, const void* wh, const void* bias,
                            const void* watt_h, const void* wfc, const void* bfc, void* tok_out,
                            void* par_out, void* score_out, void* stream) {
  if (B <= 0 || S <= 0 || V <= 0 || V > kVP || end_token < 0 || end_token >= V ||
      start_token < 0 || start_token >= kVP || eff < 0 || eff > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (mem_bf16)
    return dispatch_w<__nv_bfloat16>(W, B, S, V, T, eff, start_token, end_token, keys, values,
                                     mask, wx, wh, bias, watt_h, wfc, bfc, tok_out, par_out,
                                     score_out, st);
  return dispatch_w<float>(W, B, S, V, T, eff, start_token, end_token, keys, values, mask, wx,
                           wh, bias, watt_h, wfc, bfc, tok_out, par_out, score_out, st);
}
