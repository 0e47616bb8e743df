// The beam step's attend kernel (beam_attend), templated on the memory mode,
// the decoder units U and the beam widths, and the helpers it shares with
// the cell kernel (beam_step_f.cu). Each memory mode's instances live in a
// source of their own (beam_attend_bf16.cu, beam_attend_f32.cu,
// beam_attend_i8.cu, beam_attend_i8mxu.cu), and its instances of 32 beams in
// another (beam_attend_<mode>_w32.cu), so that nvcc compiles them in
// parallel; beam_step_f.cu's C entries rv_beam_attend / rv_beam_attend_i8
// call each mode's rv_attend_<mode>.
//
// Replaces the attention-to-permutation part of the TPU kernel
// ravvent_tpu/ops/beam_loop_pallas.py::_beam_step_kernel (:333), in all its
// memory modes. One batch row at a time: Luong scores of the W hypotheses
// against the row's keys, the masked softmax (finfo(f32).min: an all-masked
// row becomes uniform, as in the reference), the context from the
// pre-projected values, att = att_h + context, logits, log-softmax,
// finished beams continuing only through the end token, top-W over the
// flattened W x VP row by iterated first-index argmax (columns >= V are
// padding at cum + finfo.min), and the beam permutation of h', c', att.
//
// Bound by bytes: the keys and values (B*S*U*2 elements a step, 487 MB at
// B = 4096, S = 232, U = 128 in bf16; 243 MB at U = 64, 973 MB at U = 256;
// W does not change it). Design: the keys, then the values, stream through
// two shared-memory blocks of KB positions with coalesced 16-byte cp.async
// (a block is read while the next lands); a thread reading its own key row
// straight from global memory, 16 bytes a load, reaches only ~1.8 TB/s on
// the H100, coalesced reads ~3.0 TB/s (tools/read_patterns.py). Scores:
// kTPP threads a position, no other reduction per position; the rounded
// queries are read from shared memory as broadcasts. Softmax: every thread
// on its own positions, block reductions of the max and the sum. Context: a
// thread owns one 16-byte chunk of units (8 bf16, 4 f32 or 16 int8
// elements) of a group of positions; the groups of a warp are reduced by
// shuffles, the warps through shared memory. The grid is persistent (as
// many CTAs as fit: 6 an SM at U = 128, W = 5, S = 232 in bf16, 35 KB of
// shared memory each): a CTA walks over rows, and sends out the next row's
// first key blocks before this row's logits and top-W, and its state after
// them, so that the memory stream runs on while the row's serial tail
// computes.
//
// int8 memory: blocks of 64 positions, so that a block is 8 KB as a bf16
// block of 32 is (32-position int8 blocks ran slower); one thread a position
// in the scores; the row's scales land in shared memory with its state.
// quant: codes become floats by a byte permute into 2^23 + code + 128 and
// one subtraction (exact, no I2F). quant_mxu: h' quantized once a row,
// scores on __dp4a against the key words; the context on value words whose
// bytes are transposed in registers to 4 positions of one unit.
//
// Widths. U is any of beam_step_shapes.cuh's units: a row is U / kEl
// 16-byte chunks (4 for int8 at 64 units, 64 for f32 at 256), and the bank
// swizzle, the context's position groups and its partial sums follow from
// that count (Mode). Beam widths: exact instances for W = 1 and W = 5, the
// widths the main path and the evaluate-side tools run; the others run an
// instance of a compile-time maximum WM (8, 16 or 32) on a runtime W. Such an
// instance splits the WM hypotheses into groups of G (8 on bf16/f32, 4 on
// int8), one 64-thread group of the CTA each, so that a thread's context
// sums stay at G x kEl registers: every group reads every key and value
// block from shared memory for its own hypotheses, and the row's other
// work (the state, the sums, the logits, the permutation) spreads over all
// the CTA's threads. The top-W runs on one warp. Up to 16 beams it holds
// 4 WM candidate columns a lane in registers; the columns of hypotheses >= W
// hold -inf, above every valid index, so they are never picked. Shared
// memory holds 4 W U floats of state, W S of scores and two blocks (about
// 150 KB at U = 256, W = 16, S = 232 on f32). The 32-beam instance (W =
// 17-32; 256 threads on bf16/f32, 512 on int8) would need 234 KB there, so
// it holds no copy of c': the permutation reads the parents' c' from the
// cell's scratch in global memory (the same bytes the copy read), 3 W U
// floats of state (202 KB at U = 256, W = 32, S = 232). Its top-W keeps the
// candidates that can win in shared memory, the V real columns and the
// first W padding columns of each hypothesis, in the flattened row's order:
// a hypothesis's padding columns all hold cum + finfo.min, so they are
// picked in index order, at most W of them (a pick becomes finfo.min, as in
// the reference). Each lane keeps the best of its own candidates, and only
// the winner's lane scans its own again after a pick. rv_attend_<mode>'s
// query gives the shared memory, with the occupancy, and a shape whose CTA
// does not fit in 227 KB is refused, never launched.
//
// Numerics as the reference: att in f32; h rounded to the memory's type
// before the score dot and the alignments before the context dot, f32
// sums; the parents' state copied exactly. On int8 memory
// (beam_loop_pallas.py:374-425), in the reference's order:
//   quant: scores = (bf16(h) . codes) * kscale, then the mask; after the
//     softmax a = bf16(align * vscale), context = a . codes (f32 sums).
//   quant_mxu: hq = rn(h * 127) (|h| < 1, no clip); scores = s32(hq .
//     codes) * (1/127) * kscale, then the mask; af = align * vscale, amax =
//     max(max_s af, 1e-30), aq = rn(af * (127 / amax)); context =
//     s32(aq . codes) * (amax / 127). Integer sums are exact, so they equal
//     the reference's in any order.

#pragma once

#include <type_traits>

#include "beam_step_shapes.cuh"
#include "common.cuh"

// The arguments of one attend launch, as rv_beam_attend / rv_beam_attend_i8
// receive them (kscale, vscale null on bf16/f32 memory).
struct RvAttendArgs {
  int B, S, V, end_token;
  const void *hn, *cn, *ath, *cum_in, *fin_in, *keys, *values, *kscale, *vscale, *mask, *wfc,
      *bfc;
  void *tok_out, *par_out, *h_out, *c_out, *att_out, *cum_out, *fin_out;
};

// Each memory mode's entry (beam_attend_<mode>.cu): launches the instance
// for (U, W) on `stream` and returns cudaGetLastError(); or, with `info`,
// launches nothing and writes the instance's shared memory a CTA in bytes
// (dynamic and static), its threads a CTA and the CTAs an SM holds (0 when
// one does not fit). cudaErrorInvalidValue for a U or W not compiled. W =
// 17-32 goes to the mode's rv_attend_<mode>_w32, whose instances of 32
// beams live in a source of their own (beam_attend_<mode>_w32.cu): the
// kernels' build runs one nvcc a source on 8 cores, and a mode's 15
// instances in one source were its longest.
#define RV_ATTEND_MODES(X) X(bf16) X(f32) X(i8) X(i8mxu)
#define RV_ATTEND_DECL(m)                                                               \
  extern "C" int rv_attend_##m(int U, int W, const RvAttendArgs* a, int* info, void* stream); \
  extern "C" int rv_attend_##m##_w32(int U, int W, const RvAttendArgs* a, int* info,      \
                                     void* stream);
RV_ATTEND_MODES(RV_ATTEND_DECL)
#undef RV_ATTEND_DECL

namespace {

constexpr int kSmemLimit = 232448;  // shared memory a block may use on Hopper (227 KB)

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raise a kernel's dynamic shared memory limit on the current device to
// `bytes` the first time a launch there needs more than the limit set so far
// (the default 48 KB holds static and dynamic shared memory together). The
// attribute is a device's own, so the limit set is kept a device.
constexpr int kMaxDevices = 64;

template <typename Fn>
int allow_smem(Fn* kernel, size_t bytes, int (&allowed)[kMaxDevices]) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  if ((int)bytes <= allowed[device]) return 0;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  allowed[device] = (int)bytes;
  return 0;
}

constexpr int kGroupThreads = 64;  // a group of the CTA works on one batch row's hypotheses
constexpr int kWarps = kGroupThreads / 32;  // warps a group
constexpr int kVP = 128;                    // padded vocabulary width of the flattened top-W row

// A memory mode of the attend kernel: the stored element T, the positions KB
// of a streamed key or value block, for int8 codes with per-position scales
// the reference's two branches: quant (Q: dequantized dots, h and the
// folded alignments rounded to bf16) and quant_mxu (MXU: s8 x s8 -> s32
// dots on __dp4a), which the element type alone cannot say, and the units U.
template <typename T, int KB, bool Q, bool MXU, int U>
struct Mode {
  using M = T;
  static constexpr bool kQuant = Q, kMxu = MXU;
  static constexpr int kU = U;
  static constexpr int kKB = KB;
  static constexpr int kEl = 16 / (int)sizeof(T);         // elements of a 16-byte chunk
  static constexpr int kChunks = U / kEl;                 // 16-byte chunks of a row
  static constexpr int kTPP = kGroupThreads / kKB;        // threads a position in the scores
  static constexpr int kBlockFloats = kKB * U * (int)sizeof(T) / 4;  // a block
  static constexpr int kPG = kGroupThreads / kChunks > 0 ? kGroupThreads / kChunks : 1;
  // position groups of the context in one warp, reduced by shuffles, and
  // the partial sums left after them (one a warp, or one when a warp holds
  // only part of a row's chunks)
  static constexpr int kGPW = kChunks < 32 ? 32 / kChunks : 1;
  static constexpr int kPartSlots = kPG / kGPW;
  static constexpr int kSwz = (kChunks < 8 ? kChunks : 8) - 1;  // the bank swizzle's rows
  static constexpr int kGroup = sizeof(T) == 1 ? 4 : 8;  // hypotheses a group (WM > 5)
  static_assert(kChunks % kTPP == 0 && kChunks <= kGroupThreads, "a row's chunks");
  static_assert(kPG * kChunks == kGroupThreads || kChunks == kGroupThreads, "position groups");
};
// an int8 block of 64 positions is 8 KB, as a bf16 block of 32
template <int U> using ModeBf16 = Mode<__nv_bfloat16, 32, false, false, U>;
template <int U> using ModeF32 = Mode<float, 32, false, false, U>;
template <int U> using ModeI8 = Mode<int8_t, 64, true, false, U>;
template <int U> using ModeI8Mxu = Mode<int8_t, 64, true, true, U>;

// h' as the score dot takes it: rounded to the memory's type, or to bf16
// against int8 codes (quant).
template <class Md>
__device__ __forceinline__ float round_query(float x) {
  if constexpr (Md::kQuant) return round_to<__nv_bfloat16>(x);
  else return round_to<typename Md::M>(x);
}

// The elements of a 16-byte chunk as floats.
__device__ __forceinline__ void unpack(const uint4& q, float* v, const __nv_bfloat16*) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& q, float* v, const float*) {
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
// int8 codes, exactly and without I2F: a code's byte with its sign bit
// flipped is the low byte of the float 2^23 + code + 128.
__device__ __forceinline__ void unpack(const uint4& q, float* v, const int8_t*) {
  const unsigned w[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u, q.z ^ 0x80808080u,
                         q.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[4 * i + j] = __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7540 | j)) - 8388736.f;
}

// The 4 x 4 bytes of four words transposed: t[u] holds byte u of v[0..3].
__device__ __forceinline__ void transpose4(const unsigned v[4], int t[4]) {
  const unsigned lo01 = __byte_perm(v[0], v[1], 0x5140);  // v0.b0 v1.b0 v0.b1 v1.b1
  const unsigned hi01 = __byte_perm(v[0], v[1], 0x7362);  // v0.b2 v1.b2 v0.b3 v1.b3
  const unsigned lo23 = __byte_perm(v[2], v[3], 0x5140);
  const unsigned hi23 = __byte_perm(v[2], v[3], 0x7362);
  t[0] = (int)__byte_perm(lo01, lo23, 0x5410);
  t[1] = (int)__byte_perm(lo01, lo23, 0x7632);
  t[2] = (int)__byte_perm(hi01, hi23, 0x5410);
  t[3] = (int)__byte_perm(hi01, hi23, 0x7632);
}

struct AttSmem {
  int kbuf, part, hq, hs, cs, att, sc, aq, ks, vs, wfc, logit, cand, total;  // offsets in floats
};

// Whether an instance of at most WM beams keeps a copy of c' in shared
// memory (up to 16 beams), or reads it from global memory in the
// permutation and keeps the top-W's candidates in shared memory (32).
template <int WM>
__host__ __device__ constexpr bool att_wide() { return WM > 16; }

// The candidate columns a hypothesis of the 32-beam instance's top-W keeps:
// the V real ones and the first W padding ones.
__host__ __device__ inline int att_cand_cols(int W, int V) { return V + W < kVP ? V + W : kVP; }

template <class Md, bool kWide>
__host__ __device__ inline AttSmem att_layout(int W, int S, int V) {
  constexpr int U = Md::kU;
  const int SP = (S + 3) & ~3;
  AttSmem s;
  int o = 0;
  s.kbuf = o;  o += 2 * Md::kBlockFloats;   // [2][kKB][chunks] key, then value blocks
  s.part = 0;                               // [slots][W][U] partial contexts, over the
  if (Md::kPartSlots * W * U > o) o = Md::kPartSlots * W * U;  // blocks between the context and att
  s.hq = o;    o += Md::kMxu ? W * U / 4 : W * U;  // [W][U] h' for the scores (mxu: codes)
  s.hs = o;    o += W * U;                  // [W][U] h'
  s.cs = o;    o += kWide ? 0 : W * U;      // [W][U] c'
  s.att = o;   o += W * U;                  // [W][U] h'.watt_h, then the new attention vector
  s.sc = o;    o += W * SP;                 // [W][S] scores, then alignments
  s.aq = o;    o += Md::kMxu ? (W * SP / 4 + 3) & ~3 : 0;  // [W][S] quantized alignments
  s.ks = o;    o += Md::kQuant ? SP : 0;    // [S] key scales of the row
  s.vs = o;    o += Md::kQuant ? SP : 0;    // [S] value scales of the row
  s.wfc = o;   o += U * V;                  // [U][V]
  s.logit = o; o += W * V;                  // [W][V]
  s.cand = o;  o += kWide ? W * att_cand_cols(W, V) : 0;  // [W][V + W] the top-W's candidates
  s.total = o;
  return s;
}

// The kernel's static shared memory: the softmax's per-warp maxima, then
// sums; quant_mxu's per-warp maxima of the folded alignments; the row's
// cum, fin and chosen parents.
template <int WM>
struct AttStatic {
  float red[kWarps][WM];
  float amax[kWarps][WM];
  float cum[WM];
  int fin[WM];
  int par[WM];
};

// Chunk c of row r of a block sits at slot c ^ (r & kSwz): the 8 rows a
// quarter-warp reads at once (scores) fall on 8 distinct 16-byte bank
// groups, and so do the 8 chunks of a row (context); a row of 4 chunks
// swizzles within itself.
template <class Md>
__device__ __forceinline__ int kslot(int r, int c) { return c ^ (r & Md::kSwz); }

// cp.async of block b (positions [b * kKB, (b + 1) * kKB) of a batch row's
// keys or values) into buffer b & 1 by the CTA's NT threads, coalesced:
// consecutive threads, consecutive chunks. Commits one group a call, empty
// past the row's end.
template <class Md, int NT>
__device__ __forceinline__ void fetch_block(float* kbuf, const typename Md::M* K, int S, int b) {
  if (b * Md::kKB < S) {
    uint4* dst = reinterpret_cast<uint4*>(kbuf + (b & 1) * Md::kBlockFloats);
    const uint4* src = reinterpret_cast<const uint4*>(K + (size_t)b * Md::kKB * Md::kU);
    const int rows = min(Md::kKB, S - b * Md::kKB);
    for (int i = threadIdx.x; i < rows * Md::kChunks; i += NT) {
      const int r = i / Md::kChunks, c = i - r * Md::kChunks;
      cp_async16(dst + r * Md::kChunks + kslot<Md>(r, c), src + i);
    }
  }
  cp_async_commit();
}

// cp.async of batch row b's h', c' (not in the 32-beam instance) and
// h'.watt_h ([W][U] each) into hs, cs, att, and for int8 memory its S key
// and value scales (4-byte copies: a row of scales is 16-byte aligned only
// when S % 4 == 0) into ks, vs; one group.
template <class Md, int NT, bool kWide>
__device__ __forceinline__ void fetch_state(float* smem, const AttSmem& L, const float* hn,
                                            const float* cn, const float* ath,
                                            const float* kscale, const float* vscale, size_t b,
                                            int W, int S) {
  constexpr int U = Md::kU;
  const size_t bw = b * W;
  for (int i = threadIdx.x; i < W * U / 4; i += NT) {
    cp_async16(smem + L.hs + 4 * i, hn + bw * U + 4 * i);
    if constexpr (!kWide) cp_async16(smem + L.cs + 4 * i, cn + bw * U + 4 * i);
    cp_async16(smem + L.att + 4 * i, ath + bw * U + 4 * i);
  }
  if constexpr (Md::kQuant) {
    for (int s = threadIdx.x; s < S; s += NT) {
      cp_async4(smem + L.ks + s, kscale + b * S + s);
      cp_async4(smem + L.vs + s, vscale + b * S + s);
    }
  }
  cp_async_commit();
}

// Hypotheses a group of an instance of at most WM beams: all of them in the
// exact instances (W = WM), G = Md::kGroup in the others.
template <class Md, int WM, bool kFixed>
__host__ __device__ constexpr int att_group() {
  return kFixed ? WM : (WM < Md::kGroup ? WM : Md::kGroup);
}
template <class Md, int WM, bool kFixed>
__host__ __device__ constexpr int att_threads() {
  return kGroupThreads * ((WM + att_group<Md, WM, kFixed>() - 1) / att_group<Md, WM, kFixed>());
}

// The 32-beam instance's choice, by one warp (lane w holds hypothesis w's
// log-sum-exp): the candidates that can win, hypothesis w's V real columns
// and its first W padding columns (nc of them), are written to `cand` in
// the flattened row's order, candidate e = w * nc + v standing for column w
// * kVP + v; each lane keeps the best of its candidates e = lane + 32 i
// (the first on a tie), the warp picks the best of the lanes' (the smallest
// index on a tie), the pick becomes finfo.min and its lane looks again.
// Writes the row's W picks (cum, token, parent, finished) to global memory
// and the parents to `par`.
__device__ __forceinline__ void choose_wide(float* cand, const float* logit, const float* cum,
                                            const int* fin, int* par, float lse, int W, int V,
                                            int end_token, int lane, float* cum_out,
                                            int32_t* tok_out, int32_t* par_out,
                                            uint8_t* fin_out) {
  const int nc = att_cand_cols(W, V), ne = W * nc;
  for (int e0 = 0; e0 < ne; e0 += 32) {  // whole warps: the shuffle
    const int e = e0 + lane;
    const int w = min(e / nc, W - 1), v = e - w * nc;
    const float lse_w = __shfl_sync(0xffffffffu, lse, w);
    if (e < ne) {
      float lp;
      if (v >= V) lp = kNegMax;
      else if (fin[w]) lp = v == end_token ? 0.f : kNegMax;
      else lp = logit[w * V + v] - lse_w;
      cand[e] = cum[w] + lp;
    }
  }
  __syncwarp();
  auto lane_best = [&](float& best, int& bi) {
    best = __int_as_float(0xff800000);  // -inf
    bi = 0x7fffffff;                    // no candidate: never picked
    for (int e = lane; e < ne; e += 32)
      if (bi == 0x7fffffff || cand[e] > best) { best = cand[e]; bi = e; }
  };
  float lb;
  int li;
  lane_best(lb, li);
  for (int k = 0; k < W; ++k) {
    float best = lb;
    int bi = li;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    const int parent = bi / nc, token = bi - parent * nc;
    if (lane == 0) {
      cum_out[k] = best;
      tok_out[k] = token;
      par_out[k] = parent;
      fin_out[k] = (fin[parent] || token == end_token) ? 1 : 0;
      par[k] = parent;
    }
    if (lane == bi % 32) {  // the winner leaves the row
      cand[bi] = kNegMax;
      lane_best(lb, li);
    }
    __syncwarp();
  }
}

// A persistent grid: CTA i takes batch rows i, i + gridDim.x, ... W beams:
// WM when kFixed, else the runtime W_arg <= WM.
template <class Md, int WM, bool kFixed>
__global__ void __launch_bounds__(att_threads<Md, WM, kFixed>())
beam_attend_kernel(int W_arg, int B, int S, int V, int end_token,
                   const float* __restrict__ hn,       // [B*W, U] h' (scratch)
                   const float* __restrict__ cn,       // [B*W, U] c'
                   const float* __restrict__ ath,      // [B*W, U] h'.watt_h
                   const float* __restrict__ cum_in,   // [B, W]
                   const uint8_t* __restrict__ fin_in, // [B, W]
                   const typename Md::M* __restrict__ keys,    // [B, S, U]
                   const typename Md::M* __restrict__ values,  // [B, S, U] (pre-projected)
                   const float* __restrict__ kscale,   // [B, S] (int8 memory only)
                   const float* __restrict__ vscale,   // [B, S] (int8 memory only)
                   const uint8_t* __restrict__ mask,   // [B, S]
                   const float* __restrict__ wfc,      // [U, V]
                   const float* __restrict__ bfc,      // [V]
                   int32_t* __restrict__ tok_out,      // [B*W]
                   int32_t* __restrict__ par_out,      // [B, W]
                   float* __restrict__ h_out,
                   float* __restrict__ c_out,
                   float* __restrict__ att_out,
                   float* __restrict__ cum_out,        // [B, W]
                   uint8_t* __restrict__ fin_out) {    // [B, W]
  using M = typename Md::M;
  using Acc = typename std::conditional<Md::kMxu, int, float>::type;  // the dots' sums
  constexpr int U = Md::kU;
  constexpr int G = att_group<Md, WM, kFixed>();   // hypotheses a group
  constexpr int kH = (WM + G - 1) / G;             // groups
  constexpr int NT = kGroupThreads * kH;           // threads
  constexpr bool kWide = att_wide<WM>();
  const int W = kFixed ? WM : W_arg;
  extern __shared__ __align__(16) float smem[];
  const AttSmem L = att_layout<Md, kWide>(W, S, V);
  const int SP = (S + 3) & ~3;
  float* kbuf = smem + L.kbuf;
  float* part = smem + L.part;
  float* hq = smem + L.hq;
  float* hs = smem + L.hs;
  float* cs = smem + L.cs;
  float* att = smem + L.att;
  float* sc = smem + L.sc;
  unsigned* aq = reinterpret_cast<unsigned*>(smem + L.aq);  // [W][SP / 4] 4 codes a word
  const float* ks = smem + L.ks;
  const float* vs = smem + L.vs;
  float* wfs = smem + L.wfc;
  float* logit = smem + L.logit;
  float* cand = smem + L.cand;
  __shared__ AttStatic<WM> sh;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the thread's group (its hypotheses hg * G ...) and its place in it
  const int hg = kH == 1 ? 0 : tid / kGroupThreads;
  const int t = kH == 1 ? tid : tid % kGroupThreads;
  const int gwarp = t >> 5;
  const int n_blocks = (S + Md::kKB - 1) / Md::kKB;
  const int ug = t % Md::kChunks, pg = t / Md::kChunks;  // the context's thread layout
  // hypothesis j of the thread's group, and whether it is one of the W
  auto hyp = [&](int j) { return hg * G + j; };
  auto live = [&](int j) { return kFixed || hg * G + j < W; };

  size_t b = blockIdx.x;
  if (b >= (size_t)B) return;
  fetch_block<Md, NT>(kbuf, keys + b * S * U, S, 0);
  fetch_block<Md, NT>(kbuf, keys + b * S * U, S, 1);
  fetch_state<Md, NT, kWide>(smem, L, hn, cn, ath, kscale, vscale, b, W, S);
  for (int i = tid; i < U * V; i += NT) wfs[i] = __ldg(wfc + i);

  for (; b < (size_t)B; b += gridDim.x) {
    const size_t bw = b * W;  // first hypothesis of the row
    const M* K = keys + b * S * U;
    const M* Vv = values + b * S * U;
    const uint8_t* mrow = mask + b * S;
    const size_t nb = b + gridDim.x;  // the CTA's next row

    // the row's state and first key blocks have landed: h' for the scores
    // (rounded, or quant_mxu's codes rn(h' * 127), 4 a word; |h'| < 1, no
    // clip), cum and fin
    if (tid < W) {
      sh.cum[tid] = cum_in[bw + tid];
      sh.fin[tid] = fin_in[bw + tid];
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (Md::kMxu) {
      for (int i = tid; i < W * U / 4; i += NT) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (unsigned)(__float2int_rn(hs[4 * i + e] * 127.f) & 0xff) << (8 * e);
        reinterpret_cast<unsigned*>(hq)[i] = word;
      }
    } else {
      for (int i = tid; i < W * U; i += NT) hq[i] = round_query<Md>(hs[i]);
    }
    __syncthreads();

    // ---- scores, a block of kKB positions at a time: kTPP threads of a
    // group a position, each its share of the row's chunks; the scale fold
    // before the mask, as in the reference; the thread's running max of
    // each of its hypotheses's masked scores
    float mx[G];
#pragma unroll
    for (int j = 0; j < G; ++j) mx[j] = kNegMax;
    for (int k = 0; k < n_blocks; ++k) {
      if (k > 0) {
        cp_async_wait<1>();
        __syncthreads();
      }
      const int r = t / Md::kTPP, c0 = (t % Md::kTPP) * (Md::kChunks / Md::kTPP);
      const int s = k * Md::kKB + r;
      const uint4* krow =
          reinterpret_cast<const uint4*>(kbuf + (k & 1) * Md::kBlockFloats) + r * Md::kChunks;
      Acc acc[G];
#pragma unroll
      for (int j = 0; j < G; ++j) acc[j] = 0;
      if (s < S) {
#pragma unroll
        for (int cc = 0; cc < Md::kChunks / Md::kTPP; ++cc) {
          const int c = c0 + cc;
          const uint4 kq = krow[kslot<Md>(r, c)];
          if constexpr (Md::kMxu) {
#pragma unroll
            for (int j = 0; j < G; ++j) {
              if (!live(j)) continue;
              const uint4 h = reinterpret_cast<const uint4*>(hq)[hyp(j) * Md::kChunks + c];
              acc[j] = __dp4a((int)kq.x, (int)h.x, acc[j]);
              acc[j] = __dp4a((int)kq.y, (int)h.y, acc[j]);
              acc[j] = __dp4a((int)kq.z, (int)h.z, acc[j]);
              acc[j] = __dp4a((int)kq.w, (int)h.w, acc[j]);
            }
          } else {
            float kv[Md::kEl];
            unpack(kq, kv, (const M*)nullptr);
#pragma unroll
            for (int e = 0; e < Md::kEl; e += 4) {
#pragma unroll
              for (int j = 0; j < G; ++j) {
                if (!live(j)) continue;
                float h[4];
                lds4(hq + hyp(j) * U + c * Md::kEl + e, h);
                acc[j] = fmaf(h[0], kv[e], acc[j]);
                acc[j] = fmaf(h[1], kv[e + 1], acc[j]);
                acc[j] = fmaf(h[2], kv[e + 2], acc[j]);
                acc[j] = fmaf(h[3], kv[e + 3], acc[j]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int o = 1; o < Md::kTPP; o <<= 1)
#pragma unroll
        for (int j = 0; j < G; ++j) acc[j] += __shfl_xor_sync(0xffffffffu, acc[j], o);
      if (s < S && t % Md::kTPP == 0) {
        const bool m = mrow[s] != 0;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!live(j)) continue;
          float x;
          if constexpr (Md::kMxu) x = (float)acc[j] * (1.f / 127.f) * ks[s];
          else if constexpr (Md::kQuant) x = acc[j] * ks[s];
          else x = acc[j];
          x = m ? x : kNegMax;
          sc[hyp(j) * SP + s] = x;
          mx[j] = fmaxf(mx[j], x);
        }
      }
      __syncthreads();  // the block's buffer is free
      fetch_block<Md, NT>(kbuf, K, S, k + 2);
    }

    // the first value blocks go out before the softmax
    fetch_block<Md, NT>(kbuf, Vv, S, 0);
    fetch_block<Md, NT>(kbuf, Vv, S, 1);
#pragma unroll
    for (int j = 0; j < G; ++j) {
      mx[j] = warp_max(mx[j]);
      if (lane == 0 && live(j)) sh.red[gwarp][hyp(j)] = mx[j];
    }
    __syncthreads();

    // ---- masked softmax over the group (masked scores hold finfo.min, so
    // an all-masked row becomes uniform); each thread its own positions;
    // the alignments rounded to M, or with the value scales folded in:
    // rounded to bf16 (quant), or kept in f32 for quant_mxu's quantization
    {
      float sum[G];
#pragma unroll
      for (int j = 0; j < G; ++j) {
        sum[j] = 0.f;
        if (!live(j)) continue;
        mx[j] = sh.red[0][hyp(j)];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) mx[j] = fmaxf(mx[j], sh.red[g][hyp(j)]);
      }
      for (int s = t; s < S; s += kGroupThreads) {
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!live(j)) continue;
          const float e = expf(sc[hyp(j) * SP + s] - mx[j]);
          sc[hyp(j) * SP + s] = e;
          sum[j] += e;
        }
      }
      __syncthreads();  // every thread has read the maxima
#pragma unroll
      for (int j = 0; j < G; ++j) {
        sum[j] = warp_sum(sum[j]);
        if (lane == 0 && live(j)) sh.red[gwarp][hyp(j)] = sum[j];
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (!live(j)) continue;
        sum[j] = sh.red[0][hyp(j)];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) sum[j] += sh.red[g][hyp(j)];
      }
      if constexpr (Md::kMxu) {
        float amax[G];  // af >= 0
#pragma unroll
        for (int j = 0; j < G; ++j) amax[j] = 0.f;
        for (int s = t; s < S; s += kGroupThreads) {
          const float v = vs[s];
#pragma unroll
          for (int j = 0; j < G; ++j) {
            if (!live(j)) continue;
            const float af = sc[hyp(j) * SP + s] / sum[j] * v;
            sc[hyp(j) * SP + s] = af;
            amax[j] = fmaxf(amax[j], af);
          }
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
          amax[j] = warp_max(amax[j]);
          if (lane == 0 && live(j)) sh.amax[gwarp][hyp(j)] = amax[j];
        }
        __syncthreads();
        // aq = rn(af * (127 / amax)), amax = max(max_s af, 1e-30); 4
        // positions a word, zeros past S
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!live(j)) continue;
          const int w = hyp(j);
          float am = sh.amax[0][w];
#pragma unroll
          for (int g = 1; g < kWarps; ++g) am = fmaxf(am, sh.amax[g][w]);
          const float rs = 127.f / fmaxf(am, 1e-30f);
          for (int q = t; q < SP / 4; q += kGroupThreads) {
            unsigned word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int s = 4 * q + e;
              const int a = s < S ? __float2int_rn(sc[w * SP + s] * rs) : 0;
              word |= (unsigned)(a & 0xff) << (8 * e);
            }
            aq[w * (SP / 4) + q] = word;
          }
        }
      } else {
        for (int s = t; s < S; s += kGroupThreads) {
#pragma unroll
          for (int j = 0; j < G; ++j) {
            if (!live(j)) continue;
            const int w = hyp(j);
            if constexpr (Md::kQuant)
              sc[w * SP + s] = round_to<__nv_bfloat16>(sc[w * SP + s] / sum[j] * vs[s]);
            else
              sc[w * SP + s] = round_to<M>(sc[w * SP + s] / sum[j]);
          }
        }
      }
    }

    // ---- context: the values stream through the two blocks as the keys
    // did; thread = (16-byte unit chunk ug, positions pg + kPG * i of a
    // block; quant_mxu: position quads, each chunk's 4 x 16 codes transposed
    // to 4 positions of one unit a word for __dp4a against the quantized
    // alignments)
    {
      Acc acc[G][Md::kEl];
#pragma unroll
      for (int j = 0; j < G; ++j)
#pragma unroll
        for (int e = 0; e < Md::kEl; ++e) acc[j][e] = 0;
      for (int k = 0; k < n_blocks; ++k) {
        cp_async_wait<1>();
        __syncthreads();  // (first pass: also the alignments complete)
        const uint4* blk = reinterpret_cast<const uint4*>(kbuf + (k & 1) * Md::kBlockFloats);
        const int rows = min(Md::kKB, S - k * Md::kKB);
        if constexpr (Md::kMxu) {
          // rows past S in the last quad hold stale codes; their aq is 0
#pragma unroll 2
          for (int q = pg; 4 * q < rows; q += Md::kPG) {
            unsigned v[4][4];  // v[p][i]: position 4q + p, units 4i..4i+3 of the chunk
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const uint4 x = blk[(4 * q + p) * Md::kChunks + kslot<Md>(4 * q + p, ug)];
              v[p][0] = x.x; v[p][1] = x.y; v[p][2] = x.z; v[p][3] = x.w;
            }
            int tr[4][4];  // tr[i][u]: unit 4i+u at the quad's 4 positions
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned col[4] = {v[0][i], v[1][i], v[2][i], v[3][i]};
              transpose4(col, tr[i]);
            }
            const int word = (k * Md::kKB) / 4 + q;
#pragma unroll
            for (int j = 0; j < G; ++j) {
              if (!live(j)) continue;
              const int a = (int)aq[hyp(j) * (SP / 4) + word];
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  acc[j][4 * i + u] = __dp4a(tr[i][u], a, acc[j][4 * i + u]);
            }
          }
        } else {
#pragma unroll 4
          for (int r = pg; r < rows; r += Md::kPG) {
            float v[Md::kEl];
            unpack(blk[r * Md::kChunks + kslot<Md>(r, ug)], v, (const M*)nullptr);
            const int s = k * Md::kKB + r;
#pragma unroll
            for (int j = 0; j < G; ++j) {
              if (!live(j)) continue;
              const float a = sc[hyp(j) * SP + s];
#pragma unroll
              for (int e = 0; e < Md::kEl; ++e) acc[j][e] = fmaf(a, v[e], acc[j][e]);
            }
          }
        }
        __syncthreads();  // the block's buffer is free
        fetch_block<Md, NT>(kbuf, Vv, S, k + 2);
      }
      // the position groups of a warp first, then the warps' partial sums
#pragma unroll
      for (int o = Md::kChunks; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < G; ++j)
#pragma unroll
          for (int e = 0; e < Md::kEl; ++e) acc[j][e] += __shfl_xor_sync(0xffffffffu, acc[j][e], o);
      if (pg % Md::kGPW == 0) {
        Acc* pa = reinterpret_cast<Acc*>(part);
        const int slot = pg / Md::kGPW;
#pragma unroll
        for (int j = 0; j < G; ++j) {
          if (!live(j)) continue;
#pragma unroll
          for (int e = 0; e < Md::kEl; ++e)
            pa[(slot * W + hyp(j)) * U + ug * Md::kEl + e] = acc[j][e];
        }
      }
    }
    __syncthreads();

    // ---- att = h'.watt_h + context (quant_mxu: s32 sums * (amax / 127))
    for (int i = tid; i < W * U; i += NT) {
      float ctx;
      if constexpr (Md::kMxu) {
        const int* pa = reinterpret_cast<const int*>(part);
        int sum = 0;
#pragma unroll
        for (int g = 0; g < Md::kPartSlots; ++g) sum += pa[g * W * U + i];
        const int w = i / U;
        float am = sh.amax[0][w];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) am = fmaxf(am, sh.amax[g][w]);
        ctx = (float)sum * (fmaxf(am, 1e-30f) / 127.f);
      } else {
        ctx = 0.f;
#pragma unroll
        for (int g = 0; g < Md::kPartSlots; ++g) ctx += part[g * W * U + i];
      }
      att[i] += ctx;
    }
    __syncthreads();
    // the next row's first key blocks go out before this row's tail
    if (nb < (size_t)B) {
      fetch_block<Md, NT>(kbuf, keys + nb * S * U, S, 0);
      fetch_block<Md, NT>(kbuf, keys + nb * S * U, S, 1);
    }

    // ---- logits [W][V]: 8 lanes a (hypothesis, token), U / 8 units each
    {
      constexpr int kLanes = 8, kPer = U / kLanes;
      const int n = W * V * kLanes;
      for (int t0 = warp * 32; t0 < n; t0 += NT) {  // whole warps: the shuffles
        const int tt = t0 + lane;
        const int p = tt / kLanes, u0 = (tt % kLanes) * kPer;
        float acc = 0.f;
        if (tt < n) {
          const int w = p / V, v = p - w * V;
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            acc = fmaf(att[w * U + u0 + i], wfs[(u0 + i) * V + v], acc);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (tt < n && tt % kLanes == 0) logit[p] = acc + __ldg(bfc + p % V);
      }
    }
    __syncthreads();

    // ---- the choice, by warp 0: log-sum-exp per hypothesis (padding
    // columns add exp(finfo.min - max) = 0); the candidate totals cum +
    // step log-prob of the flattened WM x VP row, lane l holding columns
    // l + 32 t (finished beams continue only through the end token; padding
    // columns carry cum + finfo.min; hypotheses >= W -inf); top-W by
    // iterated first-index argmax (the 32-beam instance: over the
    // candidates that can win, in shared memory)
    if (warp == 0) {
      float lse = 0.f;
      if (lane < W) {
        const float* l = logit + lane * V;
        float m = l[0];
        for (int v = 1; v < V; ++v) m = fmaxf(m, l[v]);
        float sum = 0.f;
        for (int v = 0; v < V; ++v) sum += expf(l[v] - m);
        lse = logf(sum) + m;
      }
      if constexpr (kWide) {
        choose_wide(cand, logit, sh.cum, sh.fin, sh.par, lse, W, V, end_token, lane,
                    cum_out + bw, tok_out + bw, par_out + bw, fin_out + bw);
      } else {
        constexpr int kT = WM * kVP / 32;
        float f[kT];
#pragma unroll
        for (int tt = 0; tt < kT; ++tt) {
          const int w = tt / (kVP / 32), v = lane + 32 * (tt % (kVP / 32));
          const float lse_w = __shfl_sync(0xffffffffu, lse, w);
          if (!kFixed && w >= W) {
            f[tt] = __int_as_float(0xff800000);  // -inf
            continue;
          }
          float lp;
          if (v >= V) lp = kNegMax;
          else if (sh.fin[w]) lp = v == end_token ? 0.f : kNegMax;
          else lp = logit[w * V + v] - lse_w;
          f[tt] = sh.cum[w] + lp;
        }
        // the lane's best (first index on a tie: tt ascending is index ascending)
        auto lane_best = [&](float& best, int& bt) {
          best = f[0];
          bt = 0;
#pragma unroll
          for (int tt = 1; tt < kT; ++tt)
            if (f[tt] > best) { best = f[tt]; bt = tt; }
        };
        float lb;
        int lt;
        lane_best(lb, lt);
        for (int k = 0; k < W; ++k) {
          float best = lb;
          int bi = lane + 32 * lt;
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float ob = __shfl_xor_sync(0xffffffffu, best, o);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
            if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
          }
          const int parent = bi / kVP, token = bi - parent * kVP;
          if (lane == 0) {
            cum_out[bw + k] = best;
            tok_out[bw + k] = token;
            par_out[bw + k] = parent;
            fin_out[bw + k] = (sh.fin[parent] || token == end_token) ? 1 : 0;
            sh.par[k] = parent;
          }
          if (lane == bi % 32) {  // the winner's column leaves the row
            const int tw = bi / 32;
#pragma unroll
            for (int tt = 0; tt < kT; ++tt)
              if (tt == tw) f[tt] = kNegMax;
            lane_best(lb, lt);
          }
        }
      }
    }
    __syncthreads();

    // ---- beam permutation of the recurrent state, 16 bytes a thread (the
    // 32-beam instance reads c' from the cell's scratch)
    for (int i = tid; i < W * U / 4; i += NT) {
      const int k = 4 * i / U, u = 4 * i - k * U;
      const int src = sh.par[k] * U + u;
      const size_t dst = (bw + k) * U + u;
      const float4 h = *reinterpret_cast<const float4*>(hs + src);
      const float4 c = kWide ? __ldg(reinterpret_cast<const float4*>(cn + bw * U + src))
                             : *reinterpret_cast<const float4*>(cs + src);
      const float4 a = *reinterpret_cast<const float4*>(att + src);
      *reinterpret_cast<float4*>(h_out + dst) = h;
      *reinterpret_cast<float4*>(c_out + dst) = c;
      *reinterpret_cast<float4*>(att_out + dst) = a;
    }
    __syncthreads();  // hs, cs, att are free: the next row's state goes out
    if (nb < (size_t)B) fetch_state<Md, NT, kWide>(smem, L, hn, cn, ath, kscale, vscale, nb, W, S);
  }
}

// One instance's launch on the persistent grid (as many CTAs as fit on the
// card at once), or with `info` its shared memory, threads and occupancy.
template <class Md, int WM, bool kFixed>
int launch_attend(int W, const RvAttendArgs& a, int* info, cudaStream_t stream) {
  using M = typename Md::M;
  constexpr int NT = att_threads<Md, WM, kFixed>();
  static int allowed[kMaxDevices] = {};
  auto kernel = beam_attend_kernel<Md, WM, kFixed>;
  const size_t smem =
      (size_t)att_layout<Md, att_wide<WM>()>(W, a.S, a.V).total * sizeof(float);
  const bool fits = smem + sizeof(AttStatic<WM>) <= (size_t)kSmemLimit;
  int rc = 0, device = 0, sms = 0, per_sm = 0;
  if (fits) {
    if ((rc = allow_smem(kernel, smem, allowed))) return rc;
    if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)))
      return rc;
  }
  if (info) {
    info[0] = (int)(smem + sizeof(AttStatic<WM>));
    info[1] = NT;
    info[2] = per_sm;
    return 0;
  }
  if (!fits || per_sm < 1) return (int)cudaErrorInvalidValue;
  if ((rc = (int)cudaGetDevice(&device))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return rc;
  const int grid = min(a.B, max(1, sms * per_sm));
  kernel<<<grid, NT, smem, stream>>>(
      W, a.B, a.S, a.V, a.end_token, (const float*)a.hn, (const float*)a.cn,
      (const float*)a.ath, (const float*)a.cum_in, (const uint8_t*)a.fin_in, (const M*)a.keys,
      (const M*)a.values, (const float*)a.kscale, (const float*)a.vscale,
      (const uint8_t*)a.mask, (const float*)a.wfc, (const float*)a.bfc, (int32_t*)a.tok_out,
      (int32_t*)a.par_out, (float*)a.h_out, (float*)a.c_out, (float*)a.att_out,
      (float*)a.cum_out, (uint8_t*)a.fin_out);
  return (int)cudaGetLastError();
}

// The instance of W beams up to 16: exact at 1 and 5, else the smallest
// maximum of 8 and 16 that holds W.
template <class Md>
int dispatch_beams(int W, const RvAttendArgs& a, int* info, cudaStream_t st) {
  if (W == 1) return launch_attend<Md, 1, true>(W, a, info, st);
  if (W == 5) return launch_attend<Md, 5, true>(W, a, info, st);
  if (W >= 2 && W <= 8) return launch_attend<Md, 8, false>(W, a, info, st);
  if (W >= 9 && W <= 16) return launch_attend<Md, 16, false>(W, a, info, st);
  return (int)cudaErrorInvalidValue;
}

// The instance of 32 beams, for W = 17 to RV_STEP_MAX_BEAMS.
template <class Md>
int dispatch_wide(int W, const RvAttendArgs& a, int* info, cudaStream_t st) {
  static_assert(RV_STEP_MAX_BEAMS == 32, "the beam buckets end at RV_STEP_MAX_BEAMS");
  if (W >= 17 && W <= 32) return launch_attend<Md, 32, false>(W, a, info, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A memory mode's entries over its Mode template MODE, one case a compiled
// unit count (beam_step_shapes.cuh): rv_attend_<m> (beam_attend_<m>.cu),
// which hands W past 16 to rv_attend_<m>_w32 (beam_attend_<m>_w32.cu).
#define RV_ATTEND_UNIT_CASE(u) \
  case u: return dispatch_beams<MODE<u>>(W, *a, info, (cudaStream_t)stream);
#define RV_ATTEND_ENTRY(m)                                                                \
  extern "C" int rv_attend_##m(int U, int W, const RvAttendArgs* a, int* info,            \
                               void* stream) {                                            \
    if (W > 16) return rv_attend_##m##_w32(U, W, a, info, stream);                        \
    switch (U) { RV_STEP_UNITS(RV_ATTEND_UNIT_CASE) }                                     \
    return (int)cudaErrorInvalidValue;                                                    \
  }
#define RV_ATTEND_WIDE_CASE(u) \
  case u: return dispatch_wide<MODE<u>>(W, *a, info, (cudaStream_t)stream);
#define RV_ATTEND_WIDE_ENTRY(m)                                                           \
  extern "C" int rv_attend_##m##_w32(int U, int W, const RvAttendArgs* a, int* info,      \
                                     void* stream) {                                      \
    switch (U) { RV_STEP_UNITS(RV_ATTEND_WIDE_CASE) }                                     \
    return (int)cudaErrorInvalidValue;                                                    \
  }
