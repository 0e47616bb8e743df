// One beam-search decode step on bf16, f32 or int8 memory, as two kernels
// launched back to back (ops/beam_step_cuda.py:beam_step).
//
// Replaces the TPU kernel ravvent_tpu/ops/beam_loop_pallas.py::_beam_step_kernel
// (:333, entry point beam_step_decode) in all its memory modes: quant=False
// (bf16, f32), quant (int8 codes with per-(row, position) scales, dequantized
// dots) and quant_mxu (s8 x s8 -> s32 dots).
//
// beam_cell: the LSTM cell and h'.watt_h for every hypothesis. A tiled f32
//   product [B*W, 2U] x [2U, 4U] (rows [att_prev | h_prev], columns the
//   stacked wx[V:] and wh) on top of b + the token's row of wx (ids >= V
//   embed to zeros), the keras gates i, f, g, o, then att_h = h' . watt_h
//   while the CTA still holds its tile's h'. Writes h', c', att_h to f32
//   scratch [B*W, U]. Bound by operations: 2 * (2U * 4U + U * U) f32
//   FMA-flops a hypothesis (6.04 GFLOP at B*W = 20480, 90 us at 67
//   TFLOP/s). Design: a CTA of 256 threads owns 32 hypotheses and all 4U
//   gate columns, so that a thread holds the four gates of its units for
//   the epilogue (8 hypotheses x 2 units x 4 gates in registers); the
//   weights (0.58 MB) stream through shared memory in k-slices of 16 rows,
//   double-buffered with cp.async, read from L2 once per 32 hypotheses (the
//   single-kernel step read them once per 20). Two CTAs an SM (128
//   registers, 100 KB of shared memory each): one CTA's loads and epilogue
//   run under the other's products.
//
// beam_attend: one batch row at a time: Luong scores of the W hypotheses
//   against the row's keys, the masked softmax (finfo(f32).min: an
//   all-masked row becomes uniform, as in the reference), the context from
//   the pre-projected values, att = att_h + context, logits, log-softmax,
//   finished beams continuing only through the end token, top-W over the
//   flattened W x VP row by iterated first-index argmax (columns >= V are
//   padding at cum + finfo.min), and the beam permutation of h', c', att.
//   Bound by bytes: the keys and values (B*S*U*2 elements a step, 487 MB at
//   B = 4096, S = 232 in bf16). Design: the keys, then the values, stream
//   through two shared-memory blocks of 32 positions with coalesced 16-byte
//   cp.async (a block is read while the next lands); a thread reading its
//   own key row straight from global memory, 16 bytes a load, reaches only
//   ~1.8 TB/s on the H100, coalesced reads ~3.0 TB/s (tools/read_patterns.py).
//   Scores: two threads a position, no other reduction per position; the W
//   rounded queries are read from shared memory as broadcasts. Softmax: every
//   thread on its own positions, block reductions of the max and the sum.
//   Context: a thread owns 8 (bf16) or 4 (f32) units of a group of
//   positions; the groups are reduced through shared memory. The grid is
//   persistent (as many 64-thread CTAs as fit: 6 an SM at W = 5, S = 232
//   in bf16, 35 KB of shared memory each): a CTA walks over rows, and
//   sends out the next row's first key blocks before this row's logits and
//   top-W, and its state after them, so that the memory stream runs on
//   while the row's serial tail computes.
//
// beam_attend on int8 memory (rv_beam_attend_i8): the same kernel, templated
//   on the memory mode. Bound by bytes: 243 MB of codes a step at B = 4096,
//   S = 232, and 8 bytes of scales a position. Blocks of 64 positions, so
//   that a block is 8 KB as a bf16 block of 32 is (32-position int8 blocks
//   ran slower); one thread a position in the scores; in the context a
//   thread owns one 16-code chunk of a group of positions; the row's scales
//   land in shared memory with its state.
//   quant: codes become floats by a byte permute into 2^23 + code + 128 and
//   one subtraction (exact, no I2F). quant_mxu: h' quantized once a row,
//   scores on __dp4a against the key words; the context on value words
//   whose bytes are transposed in registers to 4 positions of one unit.
//
// Numerics as the reference: the cell and att in f32; h rounded to the
// memory's type before the score dot and the alignments before the
// context dot, f32 sums; the parents' state copied exactly. On int8 memory
// (beam_loop_pallas.py:374-425), in the reference's order:
//   quant: scores = (bf16(h) . codes) * kscale, then the mask; after the
//     softmax a = bf16(align * vscale), context = a . codes (f32 sums).
//   quant_mxu: hq = rn(h * 127) (|h| < 1, no clip); scores = s32(hq .
//     codes) * (1/127) * kscale, then the mask; af = align * vscale, amax =
//     max(max_s af, 1e-30), aq = rn(af * (127 / amax)); context =
//     s32(aq . codes) * (amax / 127). Integer sums are exact, so they equal
//     the reference's in any order.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include <initializer_list>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kU = 128;          // decoder units (the flagship's; the wrapper checks)
constexpr int kG = 4 * kU;       // gate columns

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

// ---------------------------------------------------------------- beam_cell

constexpr int kCellThreads = 256;
constexpr int kCellM = 32;                 // hypotheses a CTA
constexpr int kK = 2 * kU;                 // rows of the stacked cell kernel
constexpr int kKS = 16;                    // rows a k-slice
constexpr int kXS = kCellM + 4;            // padded row of the transposed input tile
constexpr int kCellSmem = (kK * kXS + 2 * kKS * kG) * (int)sizeof(float);

// Copy n floats (contiguous in global and shared memory) with 16-byte
// cp.async, spread over the CTA.
__device__ __forceinline__ void copy_slice(float* dst, const float* src, int n_floats) {
  for (int i = threadIdx.x * 4; i < n_floats; i += kCellThreads * 4) cp_async16(dst + i, src + i);
}

// Row k of the stacked cell kernel: wx[V + k] for k < U, wh[k - U] after.
__device__ __forceinline__ const float* cell_row(const float* wx, const float* wh, int V, int k) {
  return k < kU ? wx + (size_t)(V + k) * kG : wh + (size_t)(k - kU) * kG;
}

__device__ __forceinline__ void lds2(const float* p, float v[2]) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}
__device__ __forceinline__ void stg2(float* p, const float v[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__global__ void __launch_bounds__(kCellThreads, 2)
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
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                  // [kK][kXS]: x transposed (then h' [U][kXS])
  float* ws = smem + kK * kXS;       // [2][kKS][kG]: weight k-slices

  // warp: all 32 hypotheses x 16 units; lane: 8 hypotheses x 2 units
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = (lane >> 3) * 8;               // first hypothesis of the thread (in the tile)
  const int u0 = warp * 16 + (lane & 7) * 2;    // first unit of the thread
  const int hyp0 = blockIdx.x * kCellM;

  // the first weight slice
  copy_slice(ws, cell_row(wx, wh, V, 0), kKS * kG);
  cp_async_commit();

  // z[hyp][g*U + u] = b + the token's row of wx, then + x . [wx[V:]; wh]:
  // acc[j][g][e], hypothesis m0 + j, gate g, unit u0 + e
  float acc[8][4][2];
  {
    float bv[4][2];
#pragma unroll
    for (int g = 0; g < 4; ++g) load2(bias + g * kU + u0, bv[g]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int hyp = hyp0 + m0 + j;
      const int tk = hyp < N ? __ldg(tok + hyp) : V;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float emb[2] = {0.f, 0.f};
        if (tk >= 0 && tk < V) load2(wx + (size_t)tk * kG + g * kU + u0, emb);
        acc[j][g][0] = bv[g][0] + emb[0];
        acc[j][g][1] = bv[g][1] + emb[1];
      }
    }
  }

  // the input tile x = [att_prev | h_prev], transposed; rows past N are
  // zeros. Thread: hypothesis m = tid % 32, 4-row chunks tid / 32 + 8 r;
  // the loads in flight together, then the stores
  {
    constexpr int kStep = kCellThreads / kCellM;
    constexpr int kChunks = kK / 4 / kStep;  // 8 a thread
    const int m = tid % kCellM;
    const bool live = hyp0 + m < N;
    const float* arow = att_in + (size_t)(hyp0 + m) * kU;
    const float* hrow = h_in + (size_t)(hyp0 + m) * kU;
    float v[kChunks][4];
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int k = 4 * (tid / kCellM + kStep * r);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[r][e] = 0.f;
      if (live) load4(k < kU ? arow + k : hrow + (k - kU), v[r]);
    }
#pragma unroll
    for (int r = 0; r < kChunks; ++r) {
      const int k = 4 * (tid / kCellM + kStep * r);
#pragma unroll
      for (int e = 0; e < 4; ++e) xs[(k + e) * kXS + m] = v[r][e];
    }
  }

  constexpr int kSlices = kK / kKS;
  for (int kt = 0; kt < kSlices; ++kt) {
    if (kt + 1 < kSlices) {
      copy_slice(ws + ((kt + 1) & 1) * kKS * kG, cell_row(wx, wh, V, (kt + 1) * kKS), kKS * kG);
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
      for (int g = 0; g < 4; ++g) lds2(wsl + kk * kG + g * kU + u0, w[g]);
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
  constexpr int kAttSlice = kKS * kU;
  copy_slice(ws, watt_h, kAttSlice);
  cp_async_commit();

  // epilogue: the gates; h' to scratch and to shared memory (transposed,
  // the next product's input)
  float* hs = xs;  // [U][kXS]
  float cp[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int hyp = hyp0 + m0 + j;
    cp[j][0] = cp[j][1] = 0.f;
    if (hyp < N) load2(c_in + (size_t)hyp * kU + u0, cp[j]);
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
      stg2(h_new + (size_t)hyp * kU + u0, hv);
      stg2(c_new + (size_t)hyp * kU + u0, cv);
    }
  }

  // att_h = h' . watt_h: acc2[j][e], hypothesis m0 + j, column u0 + e
  float acc2[8][2];
#pragma unroll
  for (int j = 0; j < 8; ++j) acc2[j][0] = acc2[j][1] = 0.f;
  constexpr int kAttSlices = kU / kKS;
  for (int kt = 0; kt < kAttSlices; ++kt) {
    if (kt + 1 < kAttSlices) {
      copy_slice(ws + ((kt + 1) & 1) * kKS * kG, watt_h + (size_t)(kt + 1) * kAttSlice, kAttSlice);
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
      lds2(wsl + kk * kU + u0, w);
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
    if (hyp < N) stg2(att_h + (size_t)hyp * kU + u0, acc2[j]);
  }
}

// -------------------------------------------------------------- beam_attend

constexpr int kAttThreads = 64;            // a CTA works on one batch row at a time
constexpr int kWarps = kAttThreads / 32;
constexpr int kVP = 128;                   // padded vocabulary width of the flattened top-W row

// A memory mode of the attend kernel: the stored element T, the positions KB
// of a streamed key or value block, and for int8 codes with per-position
// scales the reference's two branches: quant (Q: dequantized dots, h and
// the folded alignments rounded to bf16) and quant_mxu (MXU: s8 x s8 -> s32
// dots on __dp4a). The element type alone cannot say which.
template <typename T, int KB, bool Q, bool MXU>
struct Mode {
  using M = T;
  static constexpr bool kQuant = Q, kMxu = MXU;
  static constexpr int kKB = KB;
  static constexpr int kEl = 16 / (int)sizeof(T);         // elements of a 16-byte chunk
  static constexpr int kChunks = kU / kEl;                // 16-byte chunks of a row
  static constexpr int kTPP = kAttThreads / kKB;          // threads a position in the scores
  static constexpr int kBlockFloats = kKB * kU * (int)sizeof(T) / 4;  // a block
  static constexpr int kPG = kAttThreads / kChunks;       // position groups of the context
};
// an int8 block of 64 positions is 8 KB, as a bf16 block of 32
using ModeBf16 = Mode<__nv_bfloat16, 32, false, false>;
using ModeF32 = Mode<float, 32, false, false>;
using ModeI8 = Mode<int8_t, 64, true, false>;
using ModeI8Mxu = Mode<int8_t, 64, true, true>;

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
  int kbuf, part, hq, hs, cs, att, sc, aq, ks, vs, wfc, logit, total;  // offsets in floats
};

template <class Md>
__host__ __device__ inline AttSmem att_layout(int W, int S, int V) {
  const int SP = (S + 3) & ~3;
  AttSmem s;
  int o = 0;
  s.kbuf = o;  o += 2 * Md::kBlockFloats;   // [2][kKB][chunks] key, then value blocks
  s.part = 0;                               // [warps][W][U] partial contexts, over the
  if (kWarps * W * kU > o) o = kWarps * W * kU;  // blocks between the context and att
  s.hq = o;    o += Md::kMxu ? W * kU / 4 : W * kU;  // [W][U] h' for the scores (mxu: codes)
  s.hs = o;    o += W * kU;                 // [W][U] h'
  s.cs = o;    o += W * kU;                 // [W][U] c'
  s.att = o;   o += W * kU;                 // [W][U] h'.watt_h, then the new attention vector
  s.sc = o;    o += W * SP;                 // [W][S] scores, then alignments
  s.aq = o;    o += Md::kMxu ? (W * SP / 4 + 3) & ~3 : 0;  // [W][S] quantized alignments
  s.ks = o;    o += Md::kQuant ? SP : 0;    // [S] key scales of the row
  s.vs = o;    o += Md::kQuant ? SP : 0;    // [S] value scales of the row
  s.wfc = o;   o += kU * V;                 // [U][V]
  s.logit = o; o += W * V;                  // [W][V]
  s.total = o;
  return s;
}

// Chunk c of row r of a block sits at slot c ^ (r & 7): the 8 rows a
// quarter-warp reads at once (scores) fall on 8 distinct 16-byte bank
// groups, and so do the 8 chunks of a row (context).
__device__ __forceinline__ int kslot(int r, int c) { return c ^ (r & 7); }

// cp.async of block b (positions [b * kKB, (b + 1) * kKB) of a batch row's
// keys or values) into buffer b & 1, coalesced: consecutive threads,
// consecutive chunks. Commits one group a call, empty past the row's end.
template <class Md>
__device__ __forceinline__ void fetch_block(float* kbuf, const typename Md::M* K, int S, int b) {
  if (b * Md::kKB < S) {
    uint4* dst = reinterpret_cast<uint4*>(kbuf + (b & 1) * Md::kBlockFloats);
    const uint4* src = reinterpret_cast<const uint4*>(K + (size_t)b * Md::kKB * kU);
    const int rows = min(Md::kKB, S - b * Md::kKB);
    for (int i = threadIdx.x; i < rows * Md::kChunks; i += kAttThreads) {
      const int r = i / Md::kChunks, c = i - r * Md::kChunks;
      cp_async16(dst + r * Md::kChunks + kslot(r, c), src + i);
    }
  }
  cp_async_commit();
}

// cp.async of batch row b's h', c' and h'.watt_h ([W][U] each) into hs, cs,
// att, and for int8 memory its S key and value scales (4-byte copies: a
// row of scales is 16-byte aligned only when S % 4 == 0) into ks, vs; one
// group.
template <class Md, int W>
__device__ __forceinline__ void fetch_state(float* smem, const AttSmem& L, const float* hn,
                                            const float* cn, const float* ath,
                                            const float* kscale, const float* vscale, size_t b,
                                            int S) {
  const size_t bw = b * W;
  for (int i = threadIdx.x; i < W * kU / 4; i += kAttThreads) {
    cp_async16(smem + L.hs + 4 * i, hn + bw * kU + 4 * i);
    cp_async16(smem + L.cs + 4 * i, cn + bw * kU + 4 * i);
    cp_async16(smem + L.att + 4 * i, ath + bw * kU + 4 * i);
  }
  if constexpr (Md::kQuant) {
    for (int s = threadIdx.x; s < S; s += kAttThreads) {
      cp_async4(smem + L.ks + s, kscale + b * S + s);
      cp_async4(smem + L.vs + s, vscale + b * S + s);
    }
  }
  cp_async_commit();
}

// A persistent grid: CTA i takes batch rows i, i + gridDim.x, ...
template <class Md, int W>
__global__ void __launch_bounds__(kAttThreads)
beam_attend_kernel(int B, int S, int V, int end_token,
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
  extern __shared__ __align__(16) float smem[];
  const AttSmem L = att_layout<Md>(W, S, V);
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
  __shared__ float s_red[kWarps][W];  // the softmax's per-warp maxima, then sums
  __shared__ float s_amax[kWarps][W]; // quant_mxu: per-warp maxima of the folded alignments
  __shared__ float s_cum[W];
  __shared__ int s_fin[W];
  __shared__ int s_par[W];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_blocks = (S + Md::kKB - 1) / Md::kKB;
  const int ug = tid % Md::kChunks, pg = tid / Md::kChunks;  // the context's thread layout

  size_t b = blockIdx.x;
  if (b >= (size_t)B) return;
  fetch_block<Md>(kbuf, keys + b * S * kU, S, 0);
  fetch_block<Md>(kbuf, keys + b * S * kU, S, 1);
  fetch_state<Md, W>(smem, L, hn, cn, ath, kscale, vscale, b, S);
  for (int i = tid; i < kU * V; i += kAttThreads) wfs[i] = __ldg(wfc + i);

  for (; b < (size_t)B; b += gridDim.x) {
    const size_t bw = b * W;  // first hypothesis of the row
    const M* K = keys + b * S * kU;
    const M* Vv = values + b * S * kU;
    const uint8_t* mrow = mask + b * S;
    const size_t nb = b + gridDim.x;  // the CTA's next row

    // the row's state and first key blocks have landed: h' for the scores
    // (rounded, or quant_mxu's codes rn(h' * 127), 4 a word; |h'| < 1, no
    // clip), cum and fin
    if (tid < W) {
      s_cum[tid] = cum_in[bw + tid];
      s_fin[tid] = fin_in[bw + tid];
    }
    cp_async_wait<0>();
    __syncthreads();
    if constexpr (Md::kMxu) {
      for (int i = tid; i < W * kU / 4; i += kAttThreads) {
        unsigned word = 0;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          word |= (unsigned)(__float2int_rn(hs[4 * i + e] * 127.f) & 0xff) << (8 * e);
        reinterpret_cast<unsigned*>(hq)[i] = word;
      }
    } else {
      for (int i = tid; i < W * kU; i += kAttThreads) hq[i] = round_query<Md>(hs[i]);
    }
    __syncthreads();

    // ---- scores, a block of kKB positions at a time: kTPP threads a
    // position, each its share of the row's chunks; the scale fold before
    // the mask, as in the reference; the thread's running max of each
    // hypothesis's masked scores
    float mx[W];
#pragma unroll
    for (int w = 0; w < W; ++w) mx[w] = kNegMax;
    for (int k = 0; k < n_blocks; ++k) {
      if (k > 0) {
        cp_async_wait<1>();
        __syncthreads();
      }
      const int r = tid / Md::kTPP, c0 = (tid % Md::kTPP) * (Md::kChunks / Md::kTPP);
      const int s = k * Md::kKB + r;
      const uint4* krow =
          reinterpret_cast<const uint4*>(kbuf + (k & 1) * Md::kBlockFloats) + r * Md::kChunks;
      Acc acc[W];
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] = 0;
      if (s < S) {
#pragma unroll
        for (int cc = 0; cc < Md::kChunks / Md::kTPP; ++cc) {
          const int c = c0 + cc;
          const uint4 kq = krow[kslot(r, c)];
          if constexpr (Md::kMxu) {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const uint4 h = reinterpret_cast<const uint4*>(hq)[w * Md::kChunks + c];
              acc[w] = __dp4a((int)kq.x, (int)h.x, acc[w]);
              acc[w] = __dp4a((int)kq.y, (int)h.y, acc[w]);
              acc[w] = __dp4a((int)kq.z, (int)h.z, acc[w]);
              acc[w] = __dp4a((int)kq.w, (int)h.w, acc[w]);
            }
          } else {
            float kv[Md::kEl];
            unpack(kq, kv, (const M*)nullptr);
#pragma unroll
            for (int e = 0; e < Md::kEl; e += 4) {
#pragma unroll
              for (int w = 0; w < W; ++w) {
                float h[4];
                lds4(hq + w * kU + c * Md::kEl + e, h);
                acc[w] = fmaf(h[0], kv[e], acc[w]);
                acc[w] = fmaf(h[1], kv[e + 1], acc[w]);
                acc[w] = fmaf(h[2], kv[e + 2], acc[w]);
                acc[w] = fmaf(h[3], kv[e + 3], acc[w]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int o = 1; o < Md::kTPP; o <<= 1)
#pragma unroll
        for (int w = 0; w < W; ++w) acc[w] += __shfl_xor_sync(0xffffffffu, acc[w], o);
      if (s < S && tid % Md::kTPP == 0) {
        const bool m = mrow[s] != 0;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float x;
          if constexpr (Md::kMxu) x = (float)acc[w] * (1.f / 127.f) * ks[s];
          else if constexpr (Md::kQuant) x = acc[w] * ks[s];
          else x = acc[w];
          x = m ? x : kNegMax;
          sc[w * SP + s] = x;
          mx[w] = fmaxf(mx[w], x);
        }
      }
      __syncthreads();  // the block's buffer is free
      fetch_block<Md>(kbuf, K, S, k + 2);
    }

    // the first value blocks go out before the softmax
    fetch_block<Md>(kbuf, Vv, S, 0);
    fetch_block<Md>(kbuf, Vv, S, 1);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      mx[w] = warp_max(mx[w]);
      if (lane == 0) s_red[warp][w] = mx[w];
    }
    __syncthreads();

    // ---- masked softmax over the CTA (masked scores hold finfo.min, so an
    // all-masked row becomes uniform); each thread its own positions; the
    // alignments rounded to M, or with the value scales folded in: rounded
    // to bf16 (quant), or kept in f32 for quant_mxu's quantization
    {
      float sum[W];
#pragma unroll
      for (int w = 0; w < W; ++w) {
        mx[w] = s_red[0][w];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) mx[w] = fmaxf(mx[w], s_red[g][w]);
        sum[w] = 0.f;
      }
      for (int s = tid; s < S; s += kAttThreads) {
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float e = expf(sc[w * SP + s] - mx[w]);
          sc[w * SP + s] = e;
          sum[w] += e;
        }
      }
      __syncthreads();  // every thread has read s_red's maxima
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sum[w] = warp_sum(sum[w]);
        if (lane == 0) s_red[warp][w] = sum[w];
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sum[w] = s_red[0][w];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) sum[w] += s_red[g][w];
      }
      if constexpr (Md::kMxu) {
        float amax[W];  // af >= 0
#pragma unroll
        for (int w = 0; w < W; ++w) amax[w] = 0.f;
        for (int s = tid; s < S; s += kAttThreads) {
          const float v = vs[s];
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const float af = sc[w * SP + s] / sum[w] * v;
            sc[w * SP + s] = af;
            amax[w] = fmaxf(amax[w], af);
          }
        }
#pragma unroll
        for (int w = 0; w < W; ++w) {
          amax[w] = warp_max(amax[w]);
          if (lane == 0) s_amax[warp][w] = amax[w];
        }
        __syncthreads();
        // aq = rn(af * (127 / amax)), amax = max(max_s af, 1e-30); 4
        // positions a word, zeros past S
#pragma unroll
        for (int w = 0; w < W; ++w) {
          float am = s_amax[0][w];
#pragma unroll
          for (int g = 1; g < kWarps; ++g) am = fmaxf(am, s_amax[g][w]);
          const float rs = 127.f / fmaxf(am, 1e-30f);
          for (int q = tid; q < SP / 4; q += kAttThreads) {
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
        for (int s = tid; s < S; s += kAttThreads) {
#pragma unroll
          for (int w = 0; w < W; ++w) {
            if constexpr (Md::kQuant)
              sc[w * SP + s] = round_to<__nv_bfloat16>(sc[w * SP + s] / sum[w] * vs[s]);
            else
              sc[w * SP + s] = round_to<M>(sc[w * SP + s] / sum[w]);
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
      Acc acc[W][Md::kEl];
#pragma unroll
      for (int w = 0; w < W; ++w)
#pragma unroll
        for (int e = 0; e < Md::kEl; ++e) acc[w][e] = 0;
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
              const uint4 x = blk[(4 * q + p) * Md::kChunks + kslot(4 * q + p, ug)];
              v[p][0] = x.x; v[p][1] = x.y; v[p][2] = x.z; v[p][3] = x.w;
            }
            int t[4][4];  // t[i][u]: unit 4i+u at the quad's 4 positions
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const unsigned col[4] = {v[0][i], v[1][i], v[2][i], v[3][i]};
              transpose4(col, t[i]);
            }
            const int word = (k * Md::kKB) / 4 + q;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const int a = (int)aq[w * (SP / 4) + word];
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int u = 0; u < 4; ++u)
                  acc[w][4 * i + u] = __dp4a(t[i][u], a, acc[w][4 * i + u]);
            }
          }
        } else {
#pragma unroll 4
          for (int r = pg; r < rows; r += Md::kPG) {
            float v[Md::kEl];
            unpack(blk[r * Md::kChunks + kslot(r, ug)], v, (const M*)nullptr);
            const int s = k * Md::kKB + r;
#pragma unroll
            for (int w = 0; w < W; ++w) {
              const float a = sc[w * SP + s];
#pragma unroll
              for (int e = 0; e < Md::kEl; ++e) acc[w][e] = fmaf(a, v[e], acc[w][e]);
            }
          }
        }
        __syncthreads();  // the block's buffer is free
        fetch_block<Md>(kbuf, Vv, S, k + 2);
      }
      // the position groups of a warp first, then the warps
#pragma unroll
      for (int o = Md::kChunks; o < 32; o <<= 1)
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int e = 0; e < Md::kEl; ++e) acc[w][e] += __shfl_xor_sync(0xffffffffu, acc[w][e], o);
      if (lane < Md::kChunks) {
        Acc* pa = reinterpret_cast<Acc*>(part);
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int e = 0; e < Md::kEl; ++e) pa[(warp * W + w) * kU + ug * Md::kEl + e] = acc[w][e];
      }
    }
    __syncthreads();

    // ---- att = h'.watt_h + context (quant_mxu: s32 sums * (amax / 127))
    for (int i = tid; i < W * kU; i += kAttThreads) {
      float ctx;
      if constexpr (Md::kMxu) {
        const int* pa = reinterpret_cast<const int*>(part);
        int sum = 0;
#pragma unroll
        for (int g = 0; g < kWarps; ++g) sum += pa[g * W * kU + i];
        const int w = i / kU;
        float am = s_amax[0][w];
#pragma unroll
        for (int g = 1; g < kWarps; ++g) am = fmaxf(am, s_amax[g][w]);
        ctx = (float)sum * (fmaxf(am, 1e-30f) / 127.f);
      } else {
        ctx = 0.f;
#pragma unroll
        for (int g = 0; g < kWarps; ++g) ctx += part[g * W * kU + i];
      }
      att[i] += ctx;
    }
    __syncthreads();
    // the next row's first key blocks go out before this row's tail
    if (nb < (size_t)B) {
      fetch_block<Md>(kbuf, keys + nb * S * kU, S, 0);
      fetch_block<Md>(kbuf, keys + nb * S * kU, S, 1);
    }

    // ---- logits [W][V]: 8 lanes a (hypothesis, token), 16 units each
    {
      constexpr int kLanes = 8, kPer = kU / kLanes;
      const int n = W * V * kLanes;
      for (int t0 = warp * 32; t0 < n; t0 += kAttThreads) {  // whole warps: the shuffles
        const int t = t0 + lane;
        const int p = t / kLanes, u0 = (t % kLanes) * kPer;
        float acc = 0.f;
        if (t < n) {
          const int w = p / V, v = p - w * V;
#pragma unroll
          for (int i = 0; i < kPer; ++i)
            acc = fmaf(att[w * kU + u0 + i], wfs[(u0 + i) * V + v], acc);
        }
#pragma unroll
        for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (t < n && t % kLanes == 0) logit[p] = acc + __ldg(bfc + p % V);
      }
    }
    __syncthreads();

    // ---- the choice, by warp 0: log-sum-exp per hypothesis (padding
    // columns add exp(finfo.min - max) = 0); the candidate totals cum +
    // step log-prob of the flattened W x VP row, lane l holding columns
    // l + 32 t (finished beams continue only through the end token; padding
    // columns carry cum + finfo.min); top-W by iterated first-index argmax
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
      constexpr int kT = W * kVP / 32;
      float f[kT];
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        const int w = t / (kVP / 32), v = lane + 32 * (t % (kVP / 32));
        const float lse_w = __shfl_sync(0xffffffffu, lse, w);
        float lp;
        if (v >= V) lp = kNegMax;
        else if (s_fin[w]) lp = v == end_token ? 0.f : kNegMax;
        else lp = logit[w * V + v] - lse_w;
        f[t] = s_cum[w] + lp;
      }
      // the lane's best (first index on a tie: t ascending is index ascending)
      auto lane_best = [&](float& best, int& bt) {
        best = f[0];
        bt = 0;
#pragma unroll
        for (int t = 1; t < kT; ++t)
          if (f[t] > best) { best = f[t]; bt = t; }
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
          fin_out[bw + k] = (s_fin[parent] || token == end_token) ? 1 : 0;
          s_par[k] = parent;
        }
        if (lane == bi % 32) {  // the winner's column leaves the row
          const int tt = bi / 32;
#pragma unroll
          for (int t = 0; t < kT; ++t)
            if (t == tt) f[t] = kNegMax;
          lane_best(lb, lt);
        }
      }
    }
    __syncthreads();

    // ---- beam permutation of the recurrent state, 16 bytes a thread
    for (int i = tid; i < W * kU / 4; i += kAttThreads) {
      const int k = 4 * i / kU, u = 4 * i - k * kU;
      const int src = s_par[k] * kU + u;
      const size_t dst = (bw + k) * kU + u;
      const float4 h = *reinterpret_cast<const float4*>(hs + src);
      const float4 c = *reinterpret_cast<const float4*>(cs + src);
      const float4 a = *reinterpret_cast<const float4*>(att + src);
      *reinterpret_cast<float4*>(h_out + dst) = h;
      *reinterpret_cast<float4*>(c_out + dst) = c;
      *reinterpret_cast<float4*>(att_out + dst) = a;
    }
    __syncthreads();  // hs, cs, att are free: the next row's state goes out
    if (nb < (size_t)B) fetch_state<Md, W>(smem, L, hn, cn, ath, kscale, vscale, nb, S);
  }
}

// Raise the kernel's dynamic shared memory limit on the current device to
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

struct AttendArgs {
  int B, S, V, end_token;
  const void *hn, *cn, *ath, *cum_in, *fin_in, *keys, *values, *kscale, *vscale, *mask, *wfc,
      *bfc;
  void *tok_out, *par_out, *h_out, *c_out, *att_out, *cum_out, *fin_out;
};

template <class Md, int W>
int launch_attend(const AttendArgs& a, cudaStream_t stream) {
  using M = typename Md::M;
  static int allowed[kMaxDevices] = {};
  const size_t smem = (size_t)att_layout<Md>(W, a.S, a.V).total * sizeof(float);
  int rc = allow_smem(beam_attend_kernel<Md, W>, smem, allowed);
  if (rc) return rc;
  // the persistent grid: as many CTAs as fit on the card at once
  int device = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&device))) return rc;
  if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device))) return rc;
  if ((rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, beam_attend_kernel<Md, W>,
                                                               kAttThreads, smem)))
    return rc;
  const int grid = min(a.B, max(1, sms * per_sm));
  beam_attend_kernel<Md, W><<<grid, kAttThreads, smem, stream>>>(
      a.B, a.S, a.V, a.end_token, (const float*)a.hn, (const float*)a.cn, (const float*)a.ath,
      (const float*)a.cum_in, (const uint8_t*)a.fin_in, (const M*)a.keys, (const M*)a.values,
      (const float*)a.kscale, (const float*)a.vscale, (const uint8_t*)a.mask,
      (const float*)a.wfc, (const float*)a.bfc, (int32_t*)a.tok_out, (int32_t*)a.par_out,
      (float*)a.h_out, (float*)a.c_out, (float*)a.att_out, (float*)a.cum_out,
      (uint8_t*)a.fin_out);
  return (int)cudaGetLastError();
}

template <class Md>
int dispatch_attend(int W, const AttendArgs& a, cudaStream_t st) {
  switch (W) {
    case 1: return launch_attend<Md, 1>(a, st);
    case 2: return launch_attend<Md, 2>(a, st);
    case 3: return launch_attend<Md, 3>(a, st);
    case 4: return launch_attend<Md, 4>(a, st);
    case 5: return launch_attend<Md, 5>(a, st);
    case 8: return launch_attend<Md, 8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
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

// The cell of N = B*W hypotheses: h', c' and h'.watt_h into f32 scratch
// [N, U]. Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rv_beam_cell(int N, int V, const void* tok, const void* att_in, const void* h_in,
                            const void* c_in, const void* wx, const void* wh, const void* bias,
                            const void* watt_h, void* h_new, void* c_new, void* att_h,
                            void* stream) {
  if (N <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  static int allowed[kMaxDevices] = {};
  const int rc = allow_smem(beam_cell_kernel, (size_t)kCellSmem, allowed);
  if (rc) return rc;
  const int grid = (N + kCellM - 1) / kCellM;
  beam_cell_kernel<<<grid, kCellThreads, kCellSmem, (cudaStream_t)stream>>>(
      N, V, (const int32_t*)tok, (const float*)att_in, (const float*)h_in, (const float*)c_in,
      (const float*)wx, (const float*)wh, (const float*)bias, (const float*)watt_h,
      (float*)h_new, (float*)c_new, (float*)att_h);
  return (int)cudaGetLastError();
}

// The rest of the step for B batch rows of W beams on bf16 (mem_bf16 = 1)
// or f32 keys/values [B, S, U], from rv_beam_cell's scratch; VP = 128.
// Beam widths 1-5 and 8. Launches on `stream`; returns cudaGetLastError().
extern "C" int rv_beam_attend(int mem_bf16, int W, int B, int S, int V, int VP, int end_token,
                              const void* h_new, const void* c_new, const void* att_h,
                              const void* cum_in, const void* fin_in, const void* keys,
                              const void* values, const void* mask, const void* wfc,
                              const void* bfc, void* tok_out, void* par_out, void* h_out,
                              void* c_out, void* att_out, void* cum_out, void* fin_out,
                              void* stream) {
  if (bad_attend_shape(B, S, V, VP, end_token)) return (int)cudaErrorInvalidValue;
  const AttendArgs a{B, S, V, end_token, h_new, c_new, att_h, cum_in, fin_in, keys, values,
                     nullptr, nullptr, mask, wfc, bfc, tok_out, par_out, h_out, c_out, att_out,
                     cum_out, fin_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (mem_bf16) return dispatch_attend<ModeBf16>(W, a, st);
  return dispatch_attend<ModeF32>(W, a, st);
}

// The same on int8 keys/values [B, S, U] with f32 scales kscale, vscale
// [B, S]: mxu = 1 for quant_mxu (s8 x s8 -> s32 dots), 0 for quant
// (dequantized dots). Refuses missing scales and a [B*W, U] state or
// memory that is not 16-byte aligned.
extern "C" int rv_beam_attend_i8(int mxu, int W, int B, int S, int V, int VP, int end_token,
                                 const void* h_new, const void* c_new, const void* att_h,
                                 const void* cum_in, const void* fin_in, const void* keys,
                                 const void* values, const void* kscale, const void* vscale,
                                 const void* mask, const void* wfc, const void* bfc,
                                 void* tok_out, void* par_out, void* h_out, void* c_out,
                                 void* att_out, void* cum_out, void* fin_out, void* stream) {
  if (bad_attend_shape(B, S, V, VP, end_token) || !kscale || !vscale ||
      misaligned16({h_new, c_new, att_h, keys, values, h_out, c_out, att_out}))
    return (int)cudaErrorInvalidValue;
  const AttendArgs a{B, S, V, end_token, h_new, c_new, att_h, cum_in, fin_in, keys, values,
                     kscale, vscale, mask, wfc, bfc, tok_out, par_out, h_out, c_out, att_out,
                     cum_out, fin_out};
  cudaStream_t st = (cudaStream_t)stream;
  if (mxu) return dispatch_attend<ModeI8Mxu>(W, a, st);
  return dispatch_attend<ModeI8>(W, a, st);
}
