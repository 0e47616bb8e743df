// The whole beam-search decode loop of one batch row in one CTA; the C rows
// of a thread-block cluster share the decoder weights, which stay resident,
// spread over the cluster's shared memory.
//
// Replaces the TPU kernel ravvent_tpu/ops/beam_loop_pallas.py::_beam_loop_kernel
// (entry point beam_loop_decode; pre-projected bf16 or f32 memory, depth-1
// LSTM, Luong). Each step has the per-step kernel's semantics (beam_step_f.cu):
// LSTM cell on [one-hot token | previous attention vector], Luong scores of h
// against the keys, softmax masked with finfo(f32).min, context from the
// pre-projected values, att = h.watt_h + context, logits, log-softmax,
// finished beams continuing only through the end token, top-W over the
// flattened W x 128 row by iterated first-index argmax (columns >= V are
// padding at cum + finfo.min; a pick is replaced by finfo.min), and the
// beam permutation of h, c and att. Writes the token, parent and cumulative
// score of each of the eff live steps; the steps from eff on are left to
// the caller's zeros.
//
// What bounds it on the H100: f32 operations. Over a chunk of B = 4096 rows,
// W = 5 and 39 steps the cell, attention-vector and logit products are
// ~243 GFLOP of f32 FMA work (3.6 ms at 67 TFLOP/s), while the memory is read
// from HBM once (~0.5 GB, 0.15 ms).
//
// What the previous designs' steps spent (tools/beam_loop_phases.py,
// clock64() per warp, B = 4096, bf16 memory, H100; PERF.md): one CTA of 512
// threads a row reading the decoder weights (0.58 MB) from L2 every step,
// 57k cycles a step, 41% of it the cell product at ~22 B of weights a clock
// an SM. Streaming the weights through a shared-memory ring by multicast
// bulk copies, one L2 read for a cluster of 8 rows, waited as long (23-27k
// cycles a step for clusters of 1, 2 and 8 alike): what bounds the stream is
// the bytes an SM takes in, not the L2 reads, so every design that brings
// all the weights into every SM each step is held to it.
//
// Design: the weights do not move.
// - Residency. One CTA of 512 threads owns one batch row and its W
//   hypotheses from start to finish: its keys (and, for bf16 memory, its
//   values) land in shared memory once by bulk copy; f32 values are read
//   from L2 every step. One CTA an SM.
// - Weights. C CTAs (C = 8 on the H100: 116 KiB of memory and 72 KiB of
//   weights a CTA) form a cluster. CTA r keeps columns [r 4U/C, (r+1) 4U/C)
//   of the stacked cell kernel [wx[V:]; wh] and units [r U/C, (r+1) U/C) of
//   watt_h in its shared memory for the whole loop, and computes them for
//   all C rows of the cluster: the inputs [att | h] of each row's beams are
//   read from that row's CTA through distributed shared memory (mapa), and
//   the gate pre-activations and h'.watt_h are stored into it. A step moves
//   ~70 KB between the SMs of a cluster instead of 0.58 MB of weights into
//   each SM.
// - Products. Cell: a warp owns 64 columns of one row and half the 256
//   rows, so that each input is read once a CTA; a thread 4 columns x W
//   beams x 64 rows, one float4 of weights serving 4W FMAs; the two halves'
//   sums meet through shared memory, and each column is stored once into
//   the row's z (remote atomic adds, tried, were slower). watt_h: a warp a
//   row, 4 lanes a unit pair, each reading a quarter of the row's h'.
//   Scores: 8 lanes a position, two positions a thread. Context: 4 units x
//   W beams over blocks of 4 positions, 4 warp groups of positions.
// - Tail. The softmax on all warps (a beam's positions in segments); a
//   warp a beam for att, the logits, the log-sum-exp and the candidates;
//   top-W by one warp over the W x (V + W) candidates that can win (the W
//   padding columns of a beam that come first are all it can pick: they
//   equal the later ones and lie before them), on warp reductions. The
//   permutation is not a pass: the next step reads h, att and c through the
//   parents.
// - Four cluster barriers a step (after the cell, after the gates, before
//   the tail, after the top-W). Rows past B run the loop on row B - 1 and
//   write nothing: every CTA takes part in every cluster barrier and
//   computes its columns for its peers.
// What bounds it now (PERF.md): 15 clusters of 8 fit the card (120 SMs);
// of a step's ~42k cycles the cell takes ~11k against an FMA floor of ~5k,
// its distributed-shared-memory reads part of that; the cluster barriers'
// waits ~7k; the attention and the tail, one row a CTA, ~20k.
//
// Layouts. This design (the resident layout) is compiled for 128 units and
// the beam widths 1-5 and 8, whose instances are exact. Every other shape of
// beam_step_shapes.cuh (64 and 256 units, W up to 16), and a shape whose
// resident layout does not fit the card (S far above 232), runs the streamed
// layout of beam_loop_streamed.cu: one CTA a row, no cluster, the weights
// and the memory read from global memory every step. rv_beam_loop picks the
// layout (or takes the one asked for), rv_beam_loop_clusters says which, and
// a shape that no layout fits is refused, never launched.
//
// Timing build (-DRV_BEAM_LOOP_PHASES, tools/beam_loop_phases.py): lane 0 of
// each warp sums clock64() cycles per phase of the step and writes them at
// the end; the production build compiles none of it.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "beam_step_shapes.cuh"
#include "common.cuh"

// The streamed layout's entry (beam_loop_streamed.cu), which rv_beam_loop
// launches where this source's resident layout does not exist or fit.
extern "C" int rv_beam_loop_streamed(int mem_bf16, int U, int W, int B, int S, int V, int eff,
                                     int start_token, int end_token, const void* keys,
                                     const void* values, const void* mask, const void* wx,
                                     const void* wh, const void* bias, const void* watt_h,
                                     const void* wfc, const void* bfc, void* tok_out,
                                     void* par_out, void* score_out, int* info, void* stream);

namespace {

constexpr int kU = 128;                 // decoder units of the resident layout
constexpr int kG = 4 * kU;              // gate columns
constexpr int kK = 2 * kU;              // rows of the stacked cell kernel
constexpr int kVP = 128;                // padded vocabulary width of the top-W row
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCand = 32;            // V + W candidate columns a beam (one warp)
constexpr int kMaxCluster = 8;          // the largest cluster size tried
constexpr int kAttStride = kU + 4;      // a unit's row of the watt_h slice, padded

constexpr int kPhases = 12;
#ifdef RV_BEAM_LOOP_PHASES
// the phases' names, by stamp index, for tools/beam_loop_phases.py
#define RV_BEAM_LOOP_PHASE_NAMES \
  "cell,cluster_barriers,gates,watt_h,scores,softmax,context,logits+lse+candidates,top_w,reduce,barriers,load"
#define RV_PHASES_ARG , long long* __restrict__ stamps
#define RV_PHASES_PASS , stamps
#define RV_PHASES_NULL , nullptr
#define RV_PHASES_INIT long long ph_[kPhases] = {}; long long last_ = clock64()
#define RV_STAMP(k) do { const long long now_ = clock64(); ph_[k] += now_ - last_; last_ = now_; } while (0)
#define RV_PHASES_STORE                                                             \
  if (live && (threadIdx.x & 31) == 0)                                              \
    for (int k_ = 0; k_ < kPhases; ++k_)                                            \
      stamps[((size_t)blockIdx.x * kWarps + (threadIdx.x >> 5)) * kPhases + k_] = ph_[k_]
#else
#define RV_PHASES_ARG
#define RV_PHASES_PASS
#define RV_PHASES_NULL
#define RV_PHASES_INIT
#define RV_STAMP(k)
#define RV_PHASES_STORE
#endif
enum { kCell, kClusterBar, kGates, kWattH, kScores, kSoftmax, kContext, kTail, kTopW, kReduce,
       kBarrier, kLoad };
#define RV_SYNC(k) do { RV_STAMP(k); __syncthreads(); RV_STAMP(kBarrier); } while (0)
#define RV_CSYNC(k) do { RV_STAMP(k); cluster_arrive(); cluster_wait(); RV_STAMP(kClusterBar); } while (0)

struct LoopSmem {
  // byte offsets into the dynamic shared buffer
  int keys, values, wcell, watt, floats, mask, bar, total;
  // float offsets from `floats`; the scores' row stride
  int hn, an, cn, z, sc, cand, red, cum, tok, par, fin, sp;
};

// Memory; this CTA's weight slices (cell kernel [2U][4U/C], watt_h
// transposed [U/C][U + 4]); the step's floats: h' [W][U], att [W][U] (h'.watt_h, then
// att), c [W][U], z [W][4U] (the gate pre-activations; h' rounded to the
// memory's type in its first U columns; then [4][W][U] partial sums), the
// scores [W][sp] and the candidates [W][32] (in the cell, the exchange of
// partial sums between warp pairs), the softmax's segment maxima and sums, the beams' cum, token, parent and finished flag; the mask; the
// memory's mbarrier.
__host__ __device__ inline LoopSmem loop_smem_layout(int mem_bytes, int W, int S, int C) {
  LoopSmem L;
  const int row = S * kU * mem_bytes;  // one row of keys (or values), a multiple of 256 B
  L.keys = 0;
  L.values = row;
  L.wcell = mem_bytes == 2 ? 2 * row : row;  // f32 values stay in global memory
  L.watt = L.wcell + 4 * kK * (kG / C);
  L.floats = L.watt + 4 * kAttStride * (kU / C);
  L.sp = (S + 3) / 4 * 4;
  int o = 0;
  L.hn = o;   o += W * kU;
  L.an = o;   o += W * kU;
  L.cn = o;   o += W * kU;
  L.z = o;    o += W * kG;
  L.sc = o;   o += W * L.sp;
  L.cand = o; o += W * kMaxCand;
  o = max(o, L.sc + kWarps / 2 * 64 * ((W + 1) / 2));  // the cell's exchange between warp pairs
  L.red = o;  o += 2 * kWarps;  // the softmax's segment maxima and sums
  L.cum = o;  o += W;
  L.tok = o;  o += W;
  L.par = o;  o += W;
  L.fin = o;  o += W;
  L.mask = L.floats + 4 * o;
  L.bar = L.mask + (S + 15) / 16 * 16;
  L.total = L.bar + 16;
  return L;
}

// ---- the memory's bulk copy, distributed shared memory and the cluster
// barrier (PTX)
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
// bytes from global memory to offset dst of the shared memory of every CTA
// in mask, completing on the mbarrier at offset bar in each
__device__ __forceinline__ void bulk_multicast(unsigned dst, const void* src, unsigned bytes,
                                               unsigned bar, unsigned short mask) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster [%0], [%1], %2, [%3], %4;\n"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask) : "memory");
}
// the same shared-memory location in CTA `rank` of the cluster, as a
// generic pointer (distributed shared memory)
template <typename T>
__device__ __forceinline__ T* peer(T* p, unsigned rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void sts4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// The four lanes of a column quad (lane bits 3 and 4) each hold partial sums
// of the quad's 4 columns for W hypotheses; afterwards the lane with bits
// 3-4 = q holds the whole sum of column q of the quad. 3W shuffles.
template <int W>
__device__ __forceinline__ void reduce_scatter4(const float (&acc)[W][4], int q, float (&out)[W]) {
  const bool hi = (q & 2) != 0, lo = (q & 1) != 0;
  float r[W][2];
#pragma unroll
  for (int j = 0; j < W; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float send = hi ? acc[j][c] : acc[j][c + 2];
      const float keep = hi ? acc[j][c + 2] : acc[j][c];
      r[j][c] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
    }
#pragma unroll
  for (int j = 0; j < W; ++j) {
    const float send = lo ? r[j][0] : r[j][1];
    const float keep = lo ? r[j][1] : r[j][0];
    out[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
}

template <typename M, int W>
__global__ void __launch_bounds__(kThreads, 1)
beam_loop_kernel(int B, int S, int V, int eff, int start_token, int end_token, int C,
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
                 float* __restrict__ score_out         // [T, B, W]
                 RV_PHASES_ARG) {
  constexpr bool kResidentValues = sizeof(M) == 2;
  constexpr int kHalfW = (W + 1) / 2;  // beams a round of the cell's exchange
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const LoopSmem L = loop_smem_layout((int)sizeof(M), W, S, C);
  const M* sk = reinterpret_cast<const M*>(smem_raw + L.keys);
  const M* sv = reinterpret_cast<const M*>(smem_raw + L.values);
  float* wcs = reinterpret_cast<float*>(smem_raw + L.wcell);  // [2U][4U/C]
  float* was = reinterpret_cast<float*>(smem_raw + L.watt);   // [U/C][U + 4], unit-major
  float* F = reinterpret_cast<float*>(smem_raw + L.floats);
  float* hn = F + L.hn;
  float* an = F + L.an;
  float* cn = F + L.cn;
  float* z = F + L.z;
  const float* qr = z;  // h' rounded, [W] rows of stride 4U, from the gates to the scores
  float* sc = F + L.sc;
  float* cand = F + L.cand;
  float* smax = F + L.red;
  float* ssum = smax + kWarps;
  float* s_cum = F + L.cum;
  int* s_tok = reinterpret_cast<int*>(F + L.tok);
  int* s_par = reinterpret_cast<int*>(F + L.par);
  int* s_fin = reinterpret_cast<int*>(F + L.fin);
  uint8_t* smask = smem_raw + L.mask;
  const int sp = L.sp;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg = lane & 7, kq = lane >> 3;  // a column quad of 8, one of 4 row groups
  const int rank = (int)(blockIdx.x % (unsigned)C);  // 1-D clusters
  const bool live = (int)blockIdx.x < B;
  const size_t row = live ? blockIdx.x : (size_t)B - 1;
  const M* vrow = values + row * S * kU;  // read per step when not resident
  const int ncol = kG / C, nu = kU / C;   // this CTA's cell columns and watt_h units
  const unsigned memb = smem_u32(smem_raw + L.bar);
  RV_PHASES_INIT;

  if (tid == 0 && eff > 0) {
    // the row's memory, once, by bulk copy on its own mbarrier
    mbar_init(memb, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const unsigned bytes = (unsigned)(S * kU * sizeof(M));
    mbar_expect(memb, kResidentValues ? 2 * bytes : bytes);
    bulk_multicast(smem_u32(sk), keys + row * S * kU, bytes, memb, (unsigned short)(1u << rank));
    if (kResidentValues)
      bulk_multicast(smem_u32(sv), vrow, bytes, memb, (unsigned short)(1u << rank));
  }
  // this CTA's slices of the weights, for the whole loop
  for (int i = tid; i < kK * ncol / 4; i += kThreads) {
    const int k = i / (ncol / 4), q = i - k * (ncol / 4);
    const float* src = (k < kU ? wx + (size_t)(V + k) * kG : wh + (size_t)(k - kU) * kG) +
                       rank * ncol + 4 * q;
    float v[4];
    load4(src, v);
    sts4(wcs + k * ncol + 4 * q, v);
  }
  for (int i = tid; i < kU * nu; i += kThreads) {  // transposed: unit-major
    const int k = i / nu, u = i - k * nu;
    was[u * kAttStride + k] = __ldg(watt_h + (size_t)k * kU + rank * nu + u);
  }
  for (int i = tid; i < W * kU; i += kThreads) hn[i] = an[i] = cn[i] = 0.f;
  if (tid < W) {
    s_tok[tid] = start_token;
    s_cum[tid] = tid == 0 ? 0.f : kNegMax;  // step 1 expands beam 0 only
    s_fin[tid] = 0;
    s_par[tid] = 0;
  }
  for (int s = tid; s < S; s += kThreads) smask[s] = mask[row * S + s];
  cluster_arrive();  // every row's state is set before any CTA reads it
  cluster_wait();
  RV_STAMP(kLoad);

  for (int t = 0; t < eff; ++t) {
    // ---- cell products of this CTA's columns for every row of the cluster:
    // z[row][j] = [att | h][par[j]] . [wx[V:]; wh][:, columns]; a warp: one
    // row, 64 columns, half the 256 stacked rows (att's or h's); a thread: 4
    // columns x W beams x 64 rows. Each input is read once a CTA
    {
      const int wpr = kWarps / C;  // warps a row: 64-column groups x 2 halves
      const int rho = warp / wpr, wr = warp - rho * wpr;
      const int quad = lane & 15, kq = lane >> 4, kh = wr & 1;
      const int lc = (wr >> 1) * 64 + 4 * quad;
      const int* pp = peer(s_par, (unsigned)rho);
      const float* xs = peer(kh == 0 ? an : hn, (unsigned)rho) + 64 * kq;
      int poff[W];
#pragma unroll
      for (int j = 0; j < W; ++j) poff[j] = pp[j] * kU;
      const float* wr4 = wcs + (kU * kh + 64 * kq) * ncol + lc;
      float acc[W][4];
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll 2
      for (int i = 0; i < 64; i += 4) {
        float w[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) lds4(wr4 + (i + r) * ncol, w[r]);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float x[4];
          lds4(xs + poff[j] + i, x);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(x[r], w[r][c], acc[j][c]);
        }
      }
      RV_STAMP(kCell);
      // the two quarters of the half (lane bit 4), then the two halves
      // (warps 2p and 2p + 1): each warp sums 32 of the 64 columns, the
      // other warp's partial sums passed through the scores' buffer
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] += __shfl_xor_sync(0xffffffffu, acc[j][c], 16);
      const bool mine = (quad >> 3) == kh;
      float* xb = sc + ((warp >> 1) * 16 + quad) * 4 * kHalfW;
      float* zr = peer(z, (unsigned)rho) + rank * ncol + lc + 2 * kq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // the beams in two rounds, to fit the buffer
        if (r * kHalfW >= W) break;
        if (r > 0) __syncthreads();  // the first round's reads are done
        if (!mine && kq == 0) {
#pragma unroll
          for (int j = r * kHalfW; j < W && j < (r + 1) * kHalfW; ++j)
            sts4(xb + 4 * (j - r * kHalfW), acc[j]);
        }
        __syncthreads();
        if (mine) {
#pragma unroll
          for (int j = r * kHalfW; j < W && j < (r + 1) * kHalfW; ++j) {
            float o[4];
            lds4(xb + 4 * (j - r * kHalfW), o);
            zr[j * kG] = (kq ? acc[j][2] : acc[j][0]) + (kq ? o[2] : o[0]);
            zr[j * kG + 1] = (kq ? acc[j][3] : acc[j][1]) + (kq ? o[3] : o[1]);
          }
        }
      }
      RV_STAMP(kReduce);
    }
    RV_CSYNC(kReduce);  // (B) every column of every row has landed

    // ---- gates, 4 lanes a unit: b + the token's row of wx + z; c' from the
    // parent's c (read by the unit's lanes before any writes it)
    {
      const int u = tid >> 2, sub = tid & 3;
      float cold[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = sub + 4 * q;
        cold[q] = j < W ? cn[s_par[j] * kU + u] : 0.f;
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = sub + 4 * q;
        if (j < W) {
          const int tk = s_tok[j];
          float g[4];
#pragma unroll
          for (int gi = 0; gi < 4; ++gi) {
            const int col = gi * kU + u;
            float e = __ldg(bias + col);
            if ((unsigned)tk < (unsigned)V) e += __ldg(wx + (size_t)tk * kG + col);
            g[gi] = z[j * kG + col] + e;
          }
          const float cc = sigmoid_f(g[1]) * cold[q] + sigmoid_f(g[0]) * tanhf(g[2]);
          const float hv = sigmoid_f(g[3]) * tanhf(cc);
          cn[j * kU + u] = cc;
          hn[j * kU + u] = hv;
          z[j * kG + u] = round_to<M>(hv);  // qr
        }
      }
    }
    RV_CSYNC(kGates);  // (C) every row's h' is final

    // ---- h'.watt_h of this CTA's units for every row: a warp a row (8
    // warps on the H100; the others wait), 4 lanes a unit pair (u, u + 8),
    // each a block of 32 of the 128 rows, 4 at a time, so that each row's
    // h' is read once; the slice lies unit-major (rows padded to 132: a
    // quarter-warp's 8 units on distinct banks); stored into each row's att
    if (tid < 2 * kU) {
      const int per_row = 2 * nu;
      const int rho = tid / per_row, tr = tid - rho * per_row;
      const int p = (tr >> 3) & 3, u = (tr & 7) + 16 * (tr >> 5);
      const float* hr = peer(hn, (unsigned)rho) + 32 * p;
      const float* wu = was + u * kAttStride + 32 * p;
      float acc[2][W];
#pragma unroll
      for (int j = 0; j < W; ++j) acc[0][j] = acc[1][j] = 0.f;
#pragma unroll 2
      for (int i = 0; i < 32; i += 4) {
        float w0[4], w1[4];
        lds4(wu + i, w0);
        lds4(wu + 8 * kAttStride + i, w1);
#pragma unroll
        for (int j = 0; j < W; ++j) {
          float x[4];
          lds4(hr + j * kU + i, x);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            acc[0][j] = fmaf(x[r], w0[r], acc[0][j]);
            acc[1][j] = fmaf(x[r], w1[r], acc[1][j]);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int j = 0; j < W; ++j) {
          acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], 8);
          acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], 16);
        }
      if (p == 0) {
        float* ar = peer(an, (unsigned)rho) + rank * nu + u;
#pragma unroll
        for (int j = 0; j < W; ++j) {
          ar[j * kU] = acc[0][j];
          ar[j * kU + 8] = acc[1][j];
        }
      }
    }
    RV_STAMP(kWattH);
    cluster_arrive();  // (D) this CTA's att_h slices are out; waited before the tail

    // ---- scores over the resident keys: 8 lanes a position (16 units
    // each, interleaved by 32), two positions 64 apart a thread
    if (t == 0) {
      mbar_wait(memb, 0);
      RV_STAMP(kLoad);
    }
    {
      const int sub = lane & 7, pq = lane >> 3;
      for (int b = 4 * warp; b < S; b += 4 * kWarps * 2) {  // warp-uniform
        const int s0 = b + pq, s1 = s0 + 4 * kWarps;
        const bool v0 = s0 < S, v1 = s1 < S;
        float a0[W], a1[W];
#pragma unroll
        for (int j = 0; j < W; ++j) a0[j] = a1[j] = 0.f;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int u = 4 * sub + 32 * m;
          float k0[4] = {0.f, 0.f, 0.f, 0.f}, k1[4] = {0.f, 0.f, 0.f, 0.f};
          if (v0) lds4(sk + (size_t)s0 * kU + u, k0);
          if (v1) lds4(sk + (size_t)s1 * kU + u, k1);
#pragma unroll
          for (int j = 0; j < W; ++j) {
            float q[4];
            lds4(qr + j * kG + u, q);
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              a0[j] = fmaf(q[c], k0[c], a0[j]);
              a1[j] = fmaf(q[c], k1[c], a1[j]);
            }
          }
        }
        float o0 = 0.f, o1 = 0.f;
#pragma unroll
        for (int j = 0; j < W; ++j) {
#pragma unroll
          for (int o = 1; o < 8; o <<= 1) {
            a0[j] += __shfl_xor_sync(0xffffffffu, a0[j], o);
            a1[j] += __shfl_xor_sync(0xffffffffu, a1[j], o);
          }
          if (sub == j) { o0 = a0[j]; o1 = a1[j]; }
        }
        if (sub < W) {
          if (v0) sc[sub * sp + s0] = smask[s0] ? o0 : kNegMax;
          if (v1) sc[sub * sp + s1] = smask[s1] ? o1 : kNegMax;
        }
      }
    }
    RV_SYNC(kScores);

    // ---- softmax (rounded to the memory's type; positions past S zero):
    // beam j's positions in G = 16 / W segments, a warp each; the segments'
    // maxima, then their sums, meet in shared memory
    {
      constexpr int G = kWarps / W;
      const int j = warp % W, g = warp / W;
      const int seg = (S + G - 1) / G, s0 = g * seg, s1 = min(S, s0 + seg);
      float* srow = sc + j * sp;
      if (g < G) {
        float m = kNegMax;
        for (int s = s0 + lane; s < s1; s += 32) m = fmaxf(m, srow[s]);
        m = warp_max(m);
        if (lane == 0) smax[j * G + g] = m;
      }
      RV_SYNC(kSoftmax);
      if (g < G) {
        float m = smax[j * G];
#pragma unroll
        for (int q = 1; q < G; ++q) m = fmaxf(m, smax[j * G + q]);
        float sum = 0.f;
        for (int s = s0 + lane; s < s1; s += 32) {
          const float e = expf(srow[s] - m);
          srow[s] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) ssum[j * G + g] = sum;
      }
      RV_SYNC(kSoftmax);
      if (g < G) {
        float sum = 0.f;
#pragma unroll
        for (int q = 0; q < G; ++q) sum += ssum[j * G + q];
        for (int s = s0 + lane; s < s1; s += 32) srow[s] = round_to<M>(srow[s] / sum);
        if (g == G - 1)
          for (int s = S + lane; s < sp; s += 32) srow[s] = 0.f;
      }
    }
    RV_SYNC(kSoftmax);

    // ---- context from the values: thread 4 units x W beams over blocks of
    // 4 positions; 4 warp groups of positions, their partial sums to z
    {
      const int ub = warp & 3, pg = warp >> 2, u0 = ub * 32 + 4 * cg;
      float acc[W][4];
#pragma unroll
      for (int j = 0; j < W; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
      for (int b = 4 * (pg * 4 + kq); b < S; b += 64) {
        float a[W][4];
#pragma unroll
        for (int j = 0; j < W; ++j) lds4(sc + j * sp + b, a[j]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int s = b + q;
          if (s < S) {
            float v[4];
            if constexpr (kResidentValues) lds4(sv + (size_t)s * kU + u0, v);
            else load4(vrow + (size_t)s * kU + u0, v);
#pragma unroll
            for (int j = 0; j < W; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) acc[j][c] = fmaf(a[j][q], v[c], acc[j][c]);
          }
        }
      }
      float out[W];
      reduce_scatter4<W>(acc, kq, out);
#pragma unroll
      for (int j = 0; j < W; ++j) z[(pg * W + j) * kU + u0 + kq] = out[j];
    }
    RV_SYNC(kContext);
    cluster_wait();  // (D) every CTA's slice of h'.watt_h has landed in att
    RV_STAMP(kClusterBar);

    // ---- a warp a beam: att = h'.watt_h + context, the logits, the
    // log-sum-exp and the candidates that can win (V real columns, then the
    // first W padding columns); finished beams continue only through the
    // end token
    if (warp < W) {
      const int j = warp;
      float a[4];
      lds4(an + j * kU + 4 * lane, a);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float p[4];
        lds4(z + (g * W + j) * kU + 4 * lane, p);
#pragma unroll
        for (int c = 0; c < 4; ++c) a[c] += p[c];
      }
      sts4(an + j * kU + 4 * lane, a);
      float logit = kNegMax;
      for (int v = 0; v < V; ++v) {
        float p = 0.f;
#pragma unroll
        for (int c = 0; c < 4; ++c) p = fmaf(a[c], __ldg(wfc + (size_t)(4 * lane + c) * V + v), p);
        p = warp_sum(p);
        if (lane == v) logit = p + __ldg(bfc + v);
      }
      const float m = warp_max(lane < V ? logit : kNegMax);
      const float sum = warp_sum(lane < V ? expf(logit - m) : 0.f);
      const float lse = logf(sum) + m;
      if (lane < V + W) {
        float lp;
        if (lane >= V) lp = kNegMax;
        else if (s_fin[j]) lp = lane == end_token ? 0.f : kNegMax;
        else lp = logit - lse;
        cand[j * kMaxCand + lane] = s_cum[j] + lp;
      }
    }
    RV_SYNC(kTail);

    // ---- top-W by iterated first-index argmax over the W x (V + W)
    // candidates, in the flattened row's order (warp 0); each pick is
    // replaced by finfo.min, as in the reference
    if (warp == 0) {
      const int nc = V + W, ne = W * nc;
      constexpr int kPer = W * kMaxCand / 32;
      float val[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int e = lane + 32 * i;
        val[i] = e < ne ? cand[(e / nc) * kMaxCand + e % nc] : 0.f;
      }
      float pick_v = 0.f;
      int pick_e = 0;
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
      const int parent = pick_e / nc, token = pick_e - parent * nc;
      int nfin = 0;
      if (lane < W) {
        nfin = (s_fin[parent] != 0 || token == end_token) ? 1 : 0;
        if (live) {
          const size_t o = ((size_t)t * B + row) * W + lane;
          tok_out[o] = token;
          par_out[o] = parent;
          score_out[o] = pick_v;
        }
      }
      __syncwarp();
      if (lane < W) {
        s_tok[lane] = token;
        s_par[lane] = parent;
        s_cum[lane] = pick_v;
        s_fin[lane] = nfin;
      }
    }
    RV_CSYNC(kTopW);  // (A) every row's parents, h' and att are final
  }
  RV_PHASES_STORE;
}

// The cluster size: the largest of 8, 4 and 2 whose layout fits the card's
// shared memory and of which the card holds at least one cluster at once;
// how many it holds; the layout's bytes.
template <typename K>
cudaError_t pick_cluster(K kern, int mem_bytes, int W, int S, int* size, int* active,
                         int* smem) {
  *size = *active = *smem = 0;
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  for (int c = kMaxCluster; c >= 2; c /= 2) {
    const int bytes = loop_smem_layout(mem_bytes, W, S, c).total;
    if (bytes > limit) continue;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)c);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = (size_t)bytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kern, &cfg);
    if (e != cudaSuccess) return e;
    if (n > 0) {
      *size = c;
      *active = n;
      *smem = bytes;
      return cudaSuccess;
    }
  }
  return cudaErrorInvalidValue;  // no cluster fits
}

template <typename M, int W>
int launch(int B, int S, int V, int T, int eff, int start_token, int end_token,
           const void* keys, const void* values, const void* mask, const void* wx,
           const void* wh, const void* bias, const void* watt_h, const void* wfc,
           const void* bfc, void* tok_out, void* par_out, void* score_out RV_PHASES_ARG,
           cudaStream_t stream, int* cluster = nullptr, int* active = nullptr) {
  (void)T;
  auto kern = beam_loop_kernel<M, W>;
  int C = 0, n = 0, smem = 0;
  cudaError_t e = pick_cluster(kern, (int)sizeof(M), W, S, &C, &n, &smem);
  if (e != cudaSuccess) return (int)e;
  if (cluster != nullptr) {  // the occupancy query alone
    *cluster = C;
    *active = n;
    return 0;
  }
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)((B + C - 1) / C * C));  // whole clusters; rows past B write nothing
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, B, S, V, eff, start_token, end_token, C, (const M*)keys,
                         (const M*)values, (const uint8_t*)mask, (const float*)wx,
                         (const float*)wh, (const float*)bias, (const float*)watt_h,
                         (const float*)wfc, (const float*)bfc, (int32_t*)tok_out,
                         (int32_t*)par_out, (float*)score_out RV_PHASES_PASS);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename M>
int dispatch_w(int W, int B, int S, int V, int T, int eff, int start_token, int end_token,
               const void* a0, const void* a1, const void* a2, const void* a3, const void* a4,
               const void* a5, const void* a6, const void* a7, const void* a8, void* o0,
               void* o1, void* o2 RV_PHASES_ARG, cudaStream_t st, int* cluster = nullptr,
               int* active = nullptr) {
#define RV_LOOP_CASE(WW)                                                                      \
  case WW:                                                                                    \
    return launch<M, WW>(B, S, V, T, eff, start_token, end_token, a0, a1, a2, a3, a4, a5, a6, \
                         a7, a8, o0, o1, o2 RV_PHASES_PASS, st, cluster, active);
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

// The layouts: 1, resident (this source's kernel: 128 units, the beam
// widths dispatch_w has an instance of, a cluster's shared memory holding
// the row's memory and the weights' slices); 2, streamed
// (beam_loop_streamed.cu: every U of beam_step_shapes.cuh and W up to
// RV_STEP_MAX_BEAMS, nothing resident). 0 asks for the resident layout
// where it exists and fits the card, else the streamed one.
enum { kLayoutAuto = 0, kLayoutResident = 1, kLayoutStreamed = 2 };

#define RV_LOOP_UNIT_EQ(u) || U == (u)
bool takes(int U, int W, int B, int S, int V, int T, int eff, int start_token, int end_token) {
  return (false RV_STEP_UNITS(RV_LOOP_UNIT_EQ)) && W >= 1 && W <= RV_STEP_MAX_BEAMS && B > 0 &&
         S > 0 && V > 0 && V <= 32 && V + W <= (W <= 16 ? kMaxCand : 2 * kMaxCand) &&
         end_token >= 0 && end_token < V &&
         start_token >= 0 && start_token < kVP && eff >= 0 && eff <= T;
}
#undef RV_LOOP_UNIT_EQ

// The layout a launch takes (the one asked for, or by kLayoutAuto's rule):
// info = {layout, cluster size (1 when streamed), clusters (CTAs when
// streamed) the card holds at once, dynamic shared memory a CTA}.
// cudaErrorInvalidValue when the layout asked for does not exist for the
// shape or no layout fits the card.
int plan(int mem_bf16, int U, int W, int S, int V, int layout, int* info) {
  if (layout != kLayoutAuto && layout != kLayoutResident && layout != kLayoutStreamed)
    return (int)cudaErrorInvalidValue;
  if (layout != kLayoutStreamed && U == kU) {
    int C = 0, n = 0;
    const int e = mem_bf16
        ? dispatch_w<__nv_bfloat16>(W, 1, S, V, 1, 0, 0, 0, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                    nullptr, nullptr RV_PHASES_NULL, nullptr, &C, &n)
        : dispatch_w<float>(W, 1, S, V, 1, 0, 0, 0, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                            nullptr RV_PHASES_NULL, nullptr, &C, &n);
    if (e == 0) {
      info[0] = kLayoutResident;
      info[1] = C;
      info[2] = n;
      info[3] = loop_smem_layout(mem_bf16 ? 2 : 4, W, S, C).total;
      return 0;
    }
    // no instance of W, or no cluster fits: the streamed layout, unless the
    // resident one was asked for; any other code is a fault
    if (e != (int)cudaErrorInvalidValue) return e;
  }
  if (layout == kLayoutResident) return (int)cudaErrorInvalidValue;
#ifdef RV_BEAM_LOOP_PHASES
  return (int)cudaErrorInvalidValue;  // the timing build times the resident layout alone
#else
  int q[2] = {0, 0};
  const int e = rv_beam_loop_streamed(mem_bf16, U, W, 1, S, V, 0, 0, 0, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, nullptr, q, nullptr);
  if (e != 0) return e;
  info[0] = kLayoutStreamed;
  info[1] = 1;
  info[2] = q[1];
  info[3] = q[0];
  return 0;
#endif
}

}  // namespace

// The layout rv_beam_loop takes for this shape with `layout` (0 auto, 1
// resident, 2 streamed): info[4] = {layout, cluster size, clusters the card
// holds at once (cudaOccupancyMaxActiveClusters; CTAs when streamed), dynamic
// shared memory a CTA in bytes}. cudaErrorInvalidValue, launching nothing,
// for a shape the kernels do not take or that no layout fits, as
// rv_beam_loop refuses it.
extern "C" int rv_beam_loop_clusters(int mem_bf16, int U, int W, int S, int V, int layout,
                                     int* info) {
  if (!takes(U, W, 1, S, V, 1, 0, 0, 0)) return (int)cudaErrorInvalidValue;
  return plan(mem_bf16, U, W, S, V, layout, info);
}

// mem_bf16: 1 when keys/values are bf16, 0 when f32. U in
// beam_step_shapes.cuh, beam widths 1 to RV_STEP_MAX_BEAMS; V + W <= 32 (64
// past 16 beams, V <= 32); S such that a layout fits the card's shared
// memory; keys, values, wx, wh, bias and watt_h 16-byte aligned; layout as
// rv_beam_loop_clusters takes it.
// Outputs [T, B, W]: steps [0, eff) are written, the rest left as they are.
// Launches on `stream`; returns a cudaError_t (0 = launched). The timing
// build's entry (rv_beam_loop_phases) takes the same arguments and the
// stamps before the stream, and runs the resident layout alone.
#ifdef RV_BEAM_LOOP_PHASES
extern "C" const char* rv_beam_loop_phase_names() { return RV_BEAM_LOOP_PHASE_NAMES; }
extern "C" int rv_beam_loop_phases(int mem_bf16, int U, int W, int B, int S, int V, int T,
                                   int eff, int start_token, int end_token, int layout,
                                   const void* keys, const void* values, const void* mask,
                                   const void* wx, const void* wh, const void* bias,
                                   const void* watt_h, const void* wfc, const void* bfc,
                                   void* tok_out, void* par_out, void* score_out,
                                   long long* stamps, void* stream) {
#else
extern "C" int rv_beam_loop(int mem_bf16, int U, int W, int B, int S, int V, int T, int eff,
                            int start_token, int end_token, int layout, const void* keys,
                            const void* values, const void* mask, const void* wx, const void* wh,
                            const void* bias, const void* watt_h, const void* wfc, const void* bfc,
                            void* tok_out, void* par_out, void* score_out, void* stream) {
#endif
  if (!takes(U, W, B, S, V, T, eff, start_token, end_token) ||
      ((uintptr_t)wx | (uintptr_t)wh | (uintptr_t)bias | (uintptr_t)watt_h | (uintptr_t)keys |
       (uintptr_t)values) % 16)
    return (int)cudaErrorInvalidValue;
  int info[4];
  const int e = plan(mem_bf16, U, W, S, V, layout, info);
  if (e != 0) return e;
  cudaStream_t st = (cudaStream_t)stream;
#ifndef RV_BEAM_LOOP_PHASES
  if (info[0] == kLayoutStreamed)
    return rv_beam_loop_streamed(mem_bf16, U, W, B, S, V, eff, start_token, end_token, keys,
                                 values, mask, wx, wh, bias, watt_h, wfc, bfc, tok_out, par_out,
                                 score_out, nullptr, stream);
#endif
  if (mem_bf16)
    return dispatch_w<__nv_bfloat16>(W, B, S, V, T, eff, start_token, end_token, keys, values,
                                     mask, wx, wh, bias, watt_h, wfc, bfc, tok_out, par_out,
                                     score_out RV_PHASES_PASS, st);
  return dispatch_w<float>(W, B, S, V, T, eff, start_token, end_token, keys, values, mask, wx,
                           wh, bias, watt_h, wfc, bfc, tok_out, par_out, score_out RV_PHASES_PASS,
                           st);
}
