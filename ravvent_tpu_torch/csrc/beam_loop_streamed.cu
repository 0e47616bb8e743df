// The whole beam-search decode loop of one batch row in one CTA, with
// nothing resident but the row's step state: the streamed layout of the
// whole-loop kernel, for the shapes whose resident layout (beam_loop.cu) does
// not exist or does not fit.
//
// Replaces the TPU kernel ravvent_tpu/ops/beam_loop_pallas.py::_beam_loop_kernel
// (entry point beam_loop_decode; pre-projected bf16 or f32 memory, depth-1
// LSTM, Luong) at every decoder width U of beam_step_shapes.cuh and every beam
// width W from 1 to RV_STEP_MAX_BEAMS. Each step has the semantics of the
// resident kernel and of the per-step kernels (beam_step_f.cu, beam_attend.cuh):
// LSTM cell on [one-hot token | previous attention vector], Luong scores of
// h rounded to the memory's type against the keys, softmax masked with
// finfo(f32).min (rounded to the memory's type), context from the
// pre-projected values, att = h.watt_h + context, logits, log-softmax,
// finished beams continuing only through the end token, top-W over the
// flattened W x 128 row by iterated first-index argmax (a pick replaced by
// finfo.min), the beam permutation read through the parents. Writes the
// token, parent and cumulative score of each of the eff live steps.
//
// Why it exists: the resident layout keeps a row's keys (and bf16 values) in
// shared memory and spreads the decoder weights over a cluster's CTAs; at
// 256 units no slice of the weights fits beside the memory (the cell kernel
// alone is 1 MiB a CTA at a cluster of 8), and at 16 beams the step's own
// floats no longer fit beside the keys. Here one CTA of 512 threads owns one
// row and its W hypotheses; its shared memory holds only the step's floats
// (h', att, c [W][U], the gates [W][4U], the scores [W][S], the candidates),
// about 130 KB at U = 256, W = 16, S = 232. Where that does not fit in 227
// KB (U = 256, W > 27 at S = 232: 267 KB at W = 32), the scores and the
// candidates of beam j lie in its gates' row past the first U columns, which
// are dead from the gates on until the next step's products (7 W U floats:
// 225 KB at U = 256, W = 32). Every step reads the decoder
// weights from L2 (2.4 MB at 256 units, 0.6 MB at 128) and the row's keys
// and values from L2 or HBM.
//
// What bounds it on the H100: the bytes each SM takes in. The repo's
// measurements (PERF.md) put one CTA a row reading 0.58 MB of weights from
// L2 a step at ~57k cycles a step: the weights stream into every SM every
// step, ~22 B a clock an SM. This layout is that design, kept simple; its
// time stands beside the resident layout's in PERF.md.
//
// Work a step: the cell, thread c of a CTA's 4U (or 512) columns, all the
// beams of its beam group, reading a float of weights a column per 4W (or
// 2W) FMAs; the gates and h'.watt_h, a thread a unit and a group of beams;
// the scores, 8 lanes a position; the softmax, a warp a beam; the context,
// a thread a unit and a group of beams over every position; the logits, the
// log-sum-exp and the candidates, a warp a beam; the top-W, one warp, as the
// resident kernel picks.
//
// Candidates: a beam's V real columns and its first W padding columns (its
// padding columns all hold cum + finfo.min, so they are picked in index
// order, at most W of them), V + W of them: at most 32, one a lane, in the
// instances of 8 and 16 beams, whose top-W warp holds a lane's share of the
// row's candidates in registers; at most 64, two a lane, in the instance of
// 32 beams (V <= 32), whose top-W reads them from shared memory, and whose
// scores take the beams 16 at a time, so that its code and registers stay
// at the 16-beam instance's (the keys are read once a pass).
//
// Instances: bf16 and f32 memory, U in beam_step_shapes.cuh, and a maximum
// of WM = 8, 16 or 32 beams on a runtime W <= WM.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py). Its C
// entry is called by beam_loop.cu's, which chooses the layout.

#include "beam_step_shapes.cuh"
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper (227 KB)

// V + W candidate columns a beam of an instance of at most WM beams: one
// warp's lanes up to 16 beams, two a lane at 32
__host__ __device__ constexpr int max_cand(int WM) { return WM <= 16 ? 32 : 64; }

// float offsets into the dynamic shared buffer; the mask and the total in
// bytes; the scores' row stride sp, and the row strides of the scores and
// the candidates as they lie (scs, ccs)
struct StreamSmem {
  int hn, an, cn, z, sc, cand, cum, tok, par, fin, mask, total, sp, scs, ccs;
};

// h' [WM][U], att [WM][U] (h'.watt_h, then att), c [WM][U], z [WM][4U] (the
// gate pre-activations; h' rounded to the memory's type in its first U
// columns), the scores [WM][sp], the candidates [WM][max_cand], the beams'
// cum, token, parent and finished flag; the mask. Where that passes the
// limit and they fit there, the scores and candidates of beam j lie in z's
// row j past its first U columns.
__host__ __device__ inline StreamSmem stream_smem_layout(int U, int WM, int S) {
  StreamSmem L;
  L.sp = (S + 3) / 4 * 4;
  const int mc = max_cand(WM);
  const int fixed = WM * (7 * U + 4) * 4 + (S + 15) / 16 * 16;  // all but scores, candidates
  const bool alias = fixed + WM * (L.sp + mc) * 4 > kSmemLimit && L.sp + mc <= 3 * U;
  int o = 0;
  L.hn = o;   o += WM * U;
  L.an = o;   o += WM * U;
  L.cn = o;   o += WM * U;
  L.z = o;    o += WM * 4 * U;
  if (alias) {
    L.sc = L.z + U;
    L.cand = L.sc + L.sp;
    L.scs = L.ccs = 4 * U;
  } else {
    L.sc = o;   o += WM * L.sp;
    L.cand = o; o += WM * mc;
    L.scs = L.sp;
    L.ccs = mc;
  }
  L.cum = o;  o += WM;
  L.tok = o;  o += WM;
  L.par = o;  o += WM;
  L.fin = o;  o += WM;
  L.mask = 4 * o;
  L.total = L.mask + (S + 15) / 16 * 16;
  return L;
}

template <typename M, int U, int WM>
__global__ void __launch_bounds__(kThreads, 1)
beam_loop_streamed_kernel(int B, int S, int V, int W, int eff, int start_token, int end_token,
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
  constexpr int kG = 4 * U;   // gate columns
  constexpr int kK = 2 * U;   // rows of the stacked cell kernel [wx[V:]; wh]
  constexpr int kUB = kThreads / U;            // beam groups of a thread-a-unit phase
  constexpr int kJU = (WM + kUB - 1) / kUB;    // beams a thread there
  static_assert(kThreads % U == 0 && U % 32 == 0, "a unit a thread, whole warps a group");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const StreamSmem L = stream_smem_layout(U, WM, S);
  float* F = reinterpret_cast<float*>(smem_raw);
  float* hn = F + L.hn;
  float* an = F + L.an;
  float* cn = F + L.cn;
  float* z = F + L.z;
  float* sc = F + L.sc;
  float* cand = F + L.cand;
  float* s_cum = F + L.cum;
  int* s_tok = reinterpret_cast<int*>(F + L.tok);
  int* s_par = reinterpret_cast<int*>(F + L.par);
  int* s_fin = reinterpret_cast<int*>(F + L.fin);
  uint8_t* smask = smem_raw + L.mask;
  const int scs = L.scs, ccs = L.ccs;  // the scores' and the candidates' row strides
  constexpr int kMaxCand = max_cand(WM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = blockIdx.x;
  const M* krow = keys + row * S * U;
  const M* vrow = values + row * S * U;
  const int ut = tid % U, ub = tid / U;  // a thread's unit and beam group

  for (int i = tid; i < WM * U; i += kThreads) hn[i] = an[i] = cn[i] = 0.f;
  if (tid < WM) {
    s_tok[tid] = start_token;
    s_cum[tid] = tid == 0 ? 0.f : kNegMax;  // step 1 expands beam 0 only
    s_fin[tid] = 0;
    s_par[tid] = 0;
  }
  for (int s = tid; s < S; s += kThreads) smask[s] = mask[row * S + s];
  __syncthreads();

  for (int t = 0; t < eff; ++t) {
    // ---- cell products: z[j] = [att | h][par[j]] . [wx[V:]; wh]; a thread:
    // kCPT columns, the beams of its beam group, every stacked row, 4 at a
    // time (a row quad never straddles att and h: U is a multiple of 4)
    {
      constexpr int kCT = kG < kThreads ? kG : kThreads;  // column threads
      constexpr int kBG = kThreads / kCT;                  // beam groups
      constexpr int kCPT = kG / kCT;                       // columns a thread
      constexpr int kJPT = (WM + kBG - 1) / kBG;           // beams a thread
      const int c0 = tid % kCT, bg = kBG == 1 ? 0 : tid / kCT;
      int poff[kJPT];
#pragma unroll
      for (int r = 0; r < kJPT; ++r) {
        const int j = bg + r * kBG;
        poff[r] = (j < W ? s_par[j] : 0) * U;
      }
      float acc[kJPT][kCPT];
#pragma unroll
      for (int r = 0; r < kJPT; ++r)
#pragma unroll
        for (int q = 0; q < kCPT; ++q) acc[r][q] = 0.f;
#pragma unroll 2
      for (int k = 0; k < kK; k += 4) {
        const float* wrow = (k < U ? wx + (size_t)(V + k) * kG : wh + (size_t)(k - U) * kG) + c0;
        const float* xs = (k < U ? an : hn) + (k < U ? k : k - U);
        float w[4][kCPT];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int q = 0; q < kCPT; ++q) w[i][q] = __ldg(wrow + (size_t)i * kG + q * kCT);
#pragma unroll
        for (int r = 0; r < kJPT; ++r) {
          if (bg + r * kBG < W) {  // warp-uniform: a warp lies in one beam group
            float x[4];
            lds4(xs + poff[r], x);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int q = 0; q < kCPT; ++q) acc[r][q] = fmaf(x[i], w[i][q], acc[r][q]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kJPT; ++r) {
        const int j = bg + r * kBG;
        if (j < W)
#pragma unroll
          for (int q = 0; q < kCPT; ++q) z[j * kG + c0 + q * kCT] = acc[r][q];
      }
    }
    __syncthreads();

    // ---- gates, a thread a unit and its beam group's beams: b + the
    // token's row of wx + z; c' from the parent's c, read by every thread
    // before any writes
    {
      float cold[kJU];
#pragma unroll
      for (int r = 0; r < kJU; ++r) {
        const int j = ub + r * kUB;
        cold[r] = j < W ? cn[s_par[j] * U + ut] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kJU; ++r) {
        const int j = ub + r * kUB;
        if (j < W) {
          const int tk = s_tok[j];
          float g[4];
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            const int col = gi * U + ut;
            float e = __ldg(bias + col);
            if ((unsigned)tk < (unsigned)V) e += __ldg(wx + (size_t)tk * kG + col);
            g[gi] = z[j * kG + col] + e;
          }
          const float cc = sigmoid_f(g[1]) * cold[r] + sigmoid_f(g[0]) * tanhf(g[2]);
          const float hv = sigmoid_f(g[3]) * tanhf(cc);
          cn[j * U + ut] = cc;
          hn[j * U + ut] = hv;
          z[j * kG + ut] = round_to<M>(hv);  // the query; only this thread read this column
        }
      }
    }
    __syncthreads();

    // ---- h'.watt_h into att, a thread a unit and its beam group's beams
    // (the context below adds to what the same thread wrote)
    {
      float acc[kJU];
#pragma unroll
      for (int r = 0; r < kJU; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < U; ++k) {
        const float w = __ldg(watt_h + (size_t)k * U + ut);
#pragma unroll
        for (int r = 0; r < kJU; ++r)
          if (ub + r * kUB < W) acc[r] = fmaf(hn[(ub + r * kUB) * U + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kJU; ++r)
        if (ub + r * kUB < W) an[(ub + r * kUB) * U + ut] = acc[r];
    }

    // ---- scores from the keys in global memory: 8 lanes a position (U / 8
    // units each, interleaved by 32), 4 positions a warp; 16 beams a pass
    // past 16 (the keys read once a pass), which keeps the instance of 32
    // beams' code and registers at the 16-beam instance's
    {
      constexpr int kSJ = WM > 16 ? 16 : WM;  // beams a pass
      const int sub = lane & 7, pq = lane >> 3;
#pragma unroll 1
      for (int j0 = 0; j0 < (WM > 16 ? W : kSJ); j0 += kSJ) {
        for (int b = 4 * warp; b < S; b += 4 * kWarps) {  // warp-uniform
          const int s = b + pq;
          const bool v = s < S;
          float a[kSJ];
#pragma unroll
          for (int j = 0; j < kSJ; ++j) a[j] = 0.f;
#pragma unroll
          for (int m = 0; m < U / 32; ++m) {
            const int u = 4 * sub + 32 * m;
            float k4[4] = {0.f, 0.f, 0.f, 0.f};
            if (v) load4(krow + (size_t)s * U + u, k4);
#pragma unroll
            for (int j = 0; j < kSJ; ++j) {
              if (j0 + j < W) {
                float q[4];
                lds4(z + (j0 + j) * kG + u, q);
#pragma unroll
                for (int c = 0; c < 4; ++c) a[j] = fmaf(q[c], k4[c], a[j]);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < kSJ; ++j) {
            if (j0 + j < W) {
#pragma unroll
              for (int o = 1; o < 8; o <<= 1) a[j] += __shfl_xor_sync(0xffffffffu, a[j], o);
              if (v && (j & 7) == sub) sc[(j0 + j) * scs + s] = smask[s] ? a[j] : kNegMax;
            }
          }
        }
      }
    }
    __syncthreads();

    // ---- softmax, a warp a beam (rounded to the memory's type; the 16 warps
    // take beams 16-31 too)
    for (int j = warp; j < W; j += kWarps) warp_softmax<M>(sc + j * scs, S, lane);
    __syncthreads();

    // ---- context from the values in global memory, added to att: a thread a
    // unit and its beam group's beams, every position
    {
      float acc[kJU];
#pragma unroll
      for (int r = 0; r < kJU; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float v = to_float(__ldg(vrow + (size_t)s * U + ut));
#pragma unroll
        for (int r = 0; r < kJU; ++r)
          if (ub + r * kUB < W) acc[r] = fmaf(sc[(ub + r * kUB) * scs + s], v, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kJU; ++r)
        if (ub + r * kUB < W) {
          float* ap = an + (ub + r * kUB) * U + ut;
          *ap = *ap + acc[r];
        }
    }
    __syncthreads();

    // ---- a warp a beam: the logits, the log-sum-exp and the candidates that
    // can win (V real columns, then the first W padding columns; past 32, a
    // lane's second; the 16 warps take beams 16-31 too); finished beams
    // continue only through the end token
    for (int j = warp; j < W; j += kWarps) {
      constexpr int kPL = U / 32;
      float a[kPL];
#pragma unroll
      for (int c = 0; c < kPL; ++c) a[c] = an[j * U + lane + 32 * c];
      float logit = kNegMax;
      for (int v = 0; v < V; ++v) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < kPL; ++c) p = fmaf(a[c], __ldg(wfc + (size_t)(lane + 32 * c) * V + v), p);
        p = warp_sum(p);
        if (lane == v) logit = p + __ldg(bfc + v);
      }
      const float m = warp_max(lane < V ? logit : kNegMax);
      const float sum = warp_sum(lane < V ? expf(logit - m) : 0.f);
      const float lse = logf(sum) + m;
      for (int col = lane; col < V + W; col += 32) {  // V <= 32: a real column is its lane's
        float lp;
        if (col >= V) lp = kNegMax;
        else if (s_fin[j]) lp = col == end_token ? 0.f : kNegMax;
        else lp = logit - lse;
        cand[j * ccs + col] = s_cum[j] + lp;
      }
    }
    __syncthreads();

    // ---- top-W by iterated first-index argmax over the W x (V + W)
    // candidates, in the flattened row's order (warp 0); a lane holds the
    // candidates e = lane + 32 i, in registers up to 16 beams, past them in
    // shared memory with the lane's best, which only the winner's lane
    // finds again after a pick
    if (warp == 0) {
      const int nc = V + W, ne = W * nc;
      float pick_v = 0.f;
      int pick_e = 0;
      if constexpr (WM > 16) {
        auto lane_best = [&](float& best, int& bi) {
          best = 0.f;
          bi = -1;
          int r = lane / nc, c = lane - r * nc;  // candidate e's beam and column
          for (int e = lane; e < ne; e += 32) {
            const float x = cand[r * ccs + c];
            if (bi < 0 || x > best) { best = x; bi = e; }
            for (c += 32; c >= nc; c -= nc) ++r;
          }
        };
        float lb;
        int li;
        lane_best(lb, li);
        for (int k = 0; k < W; ++k) {
          const unsigned key = li < 0 ? 0u : order_key(lb);
          const unsigned top = __reduce_max_sync(0xffffffffu, key);
          const int e = (int)__reduce_min_sync(0xffffffffu,
                                               li >= 0 && key == top ? (unsigned)li : 0xffffffffu);
          if (lane == k) { pick_v = from_key(top); pick_e = e; }
          if (lane == e % 32) {  // the pick becomes finfo.min; its lane looks again
            const int r = e / nc;
            cand[r * ccs + e - r * nc] = kNegMax;
            lane_best(lb, li);
          }
          __syncwarp();
        }
      } else {
        constexpr int kPer = WM * kMaxCand / 32;  // candidates a lane
        float val[kPer];
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = lane + 32 * i;
          val[i] = e < ne ? cand[(e / nc) * ccs + e % nc] : 0.f;
        }
        for (int k = 0; k < W; ++k) {
          float best = 0.f;
          int bi = -1;
#pragma unroll
          for (int i = 0; i < kPer; ++i) {
            const int e = lane + 32 * i;
            if (e < ne && (bi < 0 || val[i] > best)) { best = val[i]; bi = e; }
          }
          const unsigned key = bi < 0 ? 0u : order_key(best);
          const unsigned top = __reduce_max_sync(0xffffffffu, key);
          const int e = (int)__reduce_min_sync(0xffffffffu,
                                               bi >= 0 && key == top ? (unsigned)bi : 0xffffffffu);
          if (lane == k) { pick_v = from_key(top); pick_e = e; }
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            if (lane + 32 * i == e) val[i] = kNegMax;
        }
      }
      const int parent = pick_e / nc, token = pick_e - parent * nc;
      int nfin = 0;
      if (lane < W) {
        nfin = (s_fin[parent] != 0 || token == end_token) ? 1 : 0;
        const size_t o = ((size_t)t * B + row) * W + lane;
        tok_out[o] = token;
        par_out[o] = parent;
        score_out[o] = pick_v;
      }
      __syncwarp();
      if (lane < W) {
        s_tok[lane] = token;
        s_par[lane] = parent;
        s_cum[lane] = pick_v;
        s_fin[lane] = nfin;
      }
    }
    __syncthreads();
  }
}

// One instance's launch, or with `info` its query alone: the dynamic shared
// memory a CTA and the CTAs the card holds at once (cudaErrorInvalidValue
// when a CTA does not fit the card's shared memory).
template <typename M, int U, int WM>
int launch(int B, int S, int V, int W, int eff, int start_token, int end_token,
           const void* keys, const void* values, const void* mask, const void* wx,
           const void* wh, const void* bias, const void* watt_h, const void* wfc,
           const void* bfc, void* tok_out, void* par_out, void* score_out, int* info,
           cudaStream_t stream) {
  auto kern = beam_loop_streamed_kernel<M, U, WM>;
  const int smem = stream_smem_layout(U, WM, S).total;
  int dev = 0, limit = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (smem > limit) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (info != nullptr) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, smem);
    if (e != cudaSuccess) return (int)e;
    info[0] = smem;
    info[1] = sms * per_sm;
    return 0;
  }
  kern<<<B, kThreads, smem, stream>>>(B, S, V, W, eff, start_token, end_token, (const M*)keys,
                                      (const M*)values, (const uint8_t*)mask, (const float*)wx,
                                      (const float*)wh, (const float*)bias,
                                      (const float*)watt_h, (const float*)wfc, (const float*)bfc,
                                      (int32_t*)tok_out, (int32_t*)par_out, (float*)score_out);
  return (int)cudaGetLastError();
}

template <typename M, int U>
int dispatch_wm(int B, int S, int V, int W, int eff, int start_token, int end_token,
                const void* a0, const void* a1, const void* a2, const void* a3, const void* a4,
                const void* a5, const void* a6, const void* a7, const void* a8, void* o0,
                void* o1, void* o2, int* info, cudaStream_t st) {
  if (W <= 8)
    return launch<M, U, 8>(B, S, V, W, eff, start_token, end_token, a0, a1, a2, a3, a4, a5, a6,
                           a7, a8, o0, o1, o2, info, st);
  if (W <= 16)
    return launch<M, U, 16>(B, S, V, W, eff, start_token, end_token, a0, a1, a2, a3, a4, a5,
                            a6, a7, a8, o0, o1, o2, info, st);
  return launch<M, U, 32>(B, S, V, W, eff, start_token, end_token, a0, a1, a2, a3, a4, a5, a6,
                          a7, a8, o0, o1, o2, info, st);
}

}  // namespace

// The streamed layout at U units (beam_step_shapes.cuh), 1 <= W <=
// RV_STEP_MAX_BEAMS beams and V + W <= max_cand(W) candidates; the caller (rv_beam_loop in beam_loop.cu) has
// checked the rest of the shape. With `info` null: launches one CTA a row on
// `stream` and returns cudaGetLastError(); else launches nothing and writes
// info[0] = the dynamic shared memory a CTA, info[1] = the CTAs the card
// holds at once. cudaErrorInvalidValue for a U or W not compiled, or a CTA
// that does not fit.
extern "C" int rv_beam_loop_streamed(int mem_bf16, int U, int W, int B, int S, int V, int eff,
                                     int start_token, int end_token, const void* keys,
                                     const void* values, const void* mask, const void* wx,
                                     const void* wh, const void* bias, const void* watt_h,
                                     const void* wfc, const void* bfc, void* tok_out,
                                     void* par_out, void* score_out, int* info, void* stream) {
  if (W < 1 || W > RV_STEP_MAX_BEAMS || V > 32 || V + W > max_cand(W))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define RV_STREAM_CASE(u)                                                                       \
  case u:                                                                                       \
    return mem_bf16 ? dispatch_wm<__nv_bfloat16, u>(B, S, V, W, eff, start_token, end_token,    \
                                                    keys, values, mask, wx, wh, bias, watt_h,   \
                                                    wfc, bfc, tok_out, par_out, score_out,      \
                                                    info, st)                                   \
                    : dispatch_wm<float, u>(B, S, V, W, eff, start_token, end_token, keys,      \
                                            values, mask, wx, wh, bias, watt_h, wfc, bfc,       \
                                            tok_out, par_out, score_out, info, st);
  switch (U) {
    RV_STEP_UNITS(RV_STREAM_CASE)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RV_STREAM_CASE
}
