// One bidirectional LSTM layer on an f32 stream past 256 units: the input
// projection as a GEMM ahead of the time loop, the recurrence over a
// thread-block cluster.
//
// Replaces the TPU kernel ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel
// (entry point run_bidi_lstm_pallas) with an f32 input, at the widths of
// RV_BILSTM_WIDE_UNITS (bilstm_units.cuh: 320, 384, 448 and 512 units); the
// narrower ones run bilstm.cu. Same math as that kernel and as bilstm.cu:
// keras LSTMCell, gates i, f, g, o, z = x.Wx + h.Wh + b, f32 state and
// products, the cell of bilstm_cell.cuh, the backward direction on
// x[T-1-t], time-aligned outputs.
//
// What bounds it on the H100: the f32 products, 2*(F+U)*4U flops per row,
// step and direction, on the FMA pipe (67 TFLOP/s). On a stacked layer (F =
// 2U) two thirds of them are x.Wx, which depends on no earlier step.
//
// Design, two kernels a window of Tw time steps:
// 1. proj_kernel: P = x.Wx + b for the B Tw rows of the window, both
//    directions (the backward one on x[T-1-t]), a register-tiled FMA GEMM
//    (CTA tile 128 x 128, k-blocks of 8, 256 threads of 8 x 8 sums; x staged
//    transposed through the registers, Wx's rows by cp.async, two buffers)
//    into the f32 scratch [2][Tw][B][U][4] the wrapper allocates: a (row,
//    unit)'s four gates in one float4, the bias added. A layer of F <= 16
//    features (the raw and event L0 layers) has none: its recurrence keeps
//    x.Wx inline, as one more k-tile, over all T steps in one launch.
// 2. rec_kernel: a cluster of C CTAs a (direction, tile of R batch rows);
//    CTA r owns units [r a, (r + 1) a), a = U / C, with all four gate
//    columns of each, so its cell needs no exchange. Thread (unit, 8 rows):
//    32 sums, A = [x_t | h_{t-1}] k-major in shared memory ([Kin + U][R]),
//    its unit's weights one float4 a k-row. The CTA's slice of [Wx; Wh] (U
//    x 4a f32: 512 KiB at U = 512, C = 8) streams from L2 every step
//    through a ring of 3 k-tiles of 16 rows (16-byte cp.async pieces, a
//    commit group and a block barrier a k-tile, U / 16 a step, two k-tiles
//    in flight). After the cell each CTA stores its rows of h_t into A and
//    copies them into every peer's A by the bulk-copy engine (distributed
//    shared memory), each copy completing on the peer's mbarrier; one
//    cluster barrier a step, arrived at after the product and waited at
//    after the cell, keeps a copy from landing before the peer's product
//    has read A. A step's P is loaded as it starts (its latency a small
//    part of the step); x_{t+1} (inline) during the cell.
// U, C, R and Tw are runtime arguments of one instance; the wrapper takes
// them from rv_bilstm_layer_wide_cta.
//
// Timing build (-DRV_BILSTM_PHASES, tools/bilstm_phases.py --stream f32
// --units 320|384|448|512): lane 0 of each warp of the recurrence sums
// clock64() cycles per phase of a step and adds them to its stamps at the
// end of each window; the production build compiles none of it.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include "bilstm_cell.cuh"
#include "bilstm_units.cuh"

namespace {

// ---- the cluster barrier and the h exchange through distributed shared
// memory

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The h exchange: an mbarrier that counts the bytes a step's peers copy in
// (init with one arrival, armed each step with the bytes it expects,
// waited on by phase), and one CTA's bytes of its own shared memory copied
// to the same offset in a peer's by the bulk-copy engine, completing on the
// peer's mbarrier. Shared-memory addresses (smem_u32), a peer's by
// peer_u32; the generic stores a copy reads are made visible to the copy by
// fence_proxy_async first.
__device__ __forceinline__ void xmbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void xmbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void xmbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}
__device__ __forceinline__ unsigned peer_u32(unsigned addr, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
__device__ __forceinline__ void bulk_to_peer(unsigned dst, unsigned src, unsigned bytes,
                                             unsigned bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kKT = 16;          // weight rows of a ring k-tile
constexpr int kRG = 8;           // batch rows of a thread
constexpr int kSlots = 3;        // ring slots: two k-tiles in flight
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr int kInline = 16;      // F <= 16: x.Wx inline in the recurrence
constexpr int kXR = 8;           // x_{t+1}'s elements a thread carries in its registers
constexpr int kBM = 128, kBN = 128, kBK = 8, kGemmThreads = 256;
constexpr int kAP = kBM + 4;     // the transposed x tile's row stride: its stores on distinct banks
// every width of the list is one this kernel takes: a multiple of the
// ring's k-tile and of the GEMM's 32 units a CTA
#define RV_WIDE_TAKES(u) static_assert((u) % kKT == 0 && (u) <= 512, "bilstm_wide: U");
RV_BILSTM_WIDE_UNITS(RV_WIDE_TAKES)
#undef RV_WIDE_TAKES

constexpr int kPhases = 5;
#ifdef RV_BILSTM_PHASES
// the phases' names, by stamp index, for tools/bilstm_phases.py
#define RV_BILSTM_PHASE_NAMES "product,ring_wait+barriers,cell+out+loads,exchange,cluster_barrier+data_wait"
#define RV_PHASES_ARG , long long* __restrict__ stamps
#define RV_PHASES_PASS , stamps
// stamps[0], [1]: the projection CTAs' cycles and count; the recurrence's
// per-warp phases after them
#define RV_REC_PASS , stamps + 2
#define RV_PROJ_INIT const long long proj0_ = clock64()
#define RV_PROJ_STORE                                                                 \
  if (threadIdx.x == 0) {                                                             \
    atomicAdd(reinterpret_cast<unsigned long long*>(stamps), (unsigned long long)(clock64() - proj0_)); \
    atomicAdd(reinterpret_cast<unsigned long long*>(stamps) + 1, 1ull);              \
  }
#define RV_PHASES_INIT long long ph_[kPhases] = {}; long long last_ = clock64()
#define RV_STAMP(k) do { const long long now_ = clock64(); ph_[k] += now_ - last_; last_ = now_; } while (0)
#define RV_PHASES_STORE                                                               \
  if ((threadIdx.x & 31) == 0)                                                        \
    for (int k_ = 0; k_ < kPhases; ++k_)                                              \
      stamps[((size_t)blockIdx.x * (kMaxThreads / 32) + (threadIdx.x >> 5)) * kPhases + k_] += ph_[k_]
#else
#define RV_PHASES_ARG
#define RV_PHASES_PASS
#define RV_REC_PASS
#define RV_PROJ_INIT
#define RV_PROJ_STORE
#define RV_PHASES_INIT
#define RV_STAMP(k)
#define RV_PHASES_STORE
#endif
enum { kProduct, kRing, kCell, kExchange, kClusterBar };

// all but this thread's newest commit group (kSlots - 2) have landed
__device__ __forceinline__ void ring_wait() {
  static_assert(kSlots == 3, "ring_wait: the immediate is kSlots - 2");
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}


// The recurrence's shape: Kin inline x rows (0 on the GEMM route), C CTAs a
// cluster of a = U / C units each, R rows, NT k-tiles a step.
struct Rec {
  int U, Kin, C, R, a, NT, threads;
  __host__ __device__ Rec(int U_, int Kin_, int C_, int R_)
      : U(U_), Kin(Kin_), C(C_), R(R_), a(C_ > 0 ? U_ / C_ : 0),
        NT((Kin_ > 0) + U_ / kKT), threads(a * R_ / kRG) {}
  // bytes of the ring, of A, then the exchange's mbarrier
  __host__ __device__ size_t ring_bytes() const { return (size_t)kSlots * kKT * a * 16; }
  __host__ __device__ size_t a_bytes() const { return (size_t)(Kin + U) * R * 4; }
  __host__ __device__ size_t smem() const { return ring_bytes() + a_bytes() + 16; }
  // the bytes of h_t a CTA copies to each peer
  __host__ __device__ unsigned slice_bytes() const { return (unsigned)(a * R * 4); }
  __host__ __device__ bool valid() const {
    return C >= 1 && C <= kMaxCluster && U % C == 0 && R >= kRG && R <= 128 && R % kRG == 0 &&
           threads >= 32 && threads <= kMaxThreads && Kin * R <= kXR * threads;
  }
};

// ---- 1. the projection GEMM

// P[d][s][b][u][gate] = x[b, t].Wx[d][:, gate, u] + b[d][gate U + u] for the
// n steps s of the window from step s0 (t = s0 + s forward, T-1-(s0 + s)
// backward), rows m = s B + b of the window.
__global__ void __launch_bounds__(kGemmThreads)
proj_kernel(const float* __restrict__ xs, int B, int T, int F, int Kx, int U,
            const float* __restrict__ wx,    // [2][Kx][U][4]: a row's gates by unit
            const float* __restrict__ bias,  // [2, 4U]
            float* __restrict__ P,           // [2][Tw][B][U][4]
            int Tw, int s0, int n RV_PHASES_ARG) {
  RV_PROJ_INIT;
  __shared__ __align__(16) float As[2][kBK][kAP];  // x tile, k-major
  __shared__ __align__(16) float Bs[2][kBK][kBN];  // Wx rows
  const int d = blockIdx.y, N = 4 * U, nbn = N / kBN;
  const int bm = blockIdx.x / nbn, bn = blockIdx.x % nbn;
  const int M = n * B, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const float* wd = wx + (size_t)d * Kx * N + bn * kBN;
  // this thread's x row of the tile and its 4 k columns of a k-block
  const int ar = tid / 2, ak = 4 * (tid % 2);
  const int m = bm * kBM + ar;
  const float* xrow = nullptr;
  if (m < M) {
    const int s = s0 + m / B, b = m % B, t = d == 0 ? s : T - 1 - s;
    xrow = xs + ((size_t)b * T + t) * F;
  }
  const bool vec = F % 4 == 0;
  auto load_x = [&](int k0, float (&v)[4]) {
    const int k = k0 + ak;
    if (xrow != nullptr && vec && k < F) {
      const float4 q = *reinterpret_cast<const float4*>(xrow + k);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) v[i] = (xrow != nullptr && k + i < F) ? xrow[k + i] : 0.f;
    }
  };
  auto store_x = [&](int buf, const float (&v)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) As[buf][ak + i][ar] = v[i];
  };
  // Wx rows [k0, k0 + 8): 8 x 128 floats, one 16-byte piece a thread
  const int bk = tid / 32, bq = 4 * (tid % 32);
  auto issue_w = [&](int buf, int k0) {
    if (k0 + bk < Kx) cp_async16(&Bs[buf][bk][bq], wd + (size_t)(k0 + bk) * N + bq);
    else *reinterpret_cast<float4*>(&Bs[buf][bk][bq]) = make_float4(0.f, 0.f, 0.f, 0.f);
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float xv[4];
  load_x(0, xv);
  store_x(0, xv);
  issue_w(0, 0);
  const int nk = (Kx + kBK - 1) / kBK;
  for (int kb = 0; kb < nk; ++kb) {
    const int cur = kb & 1;
    cp_async_wait_all();
    __syncthreads();  // k-block kb is in buffer cur; every read of the other buffer is done
    const bool more = kb + 1 < nk;
    if (more) {
      issue_w(cur ^ 1, (kb + 1) * kBK);
      load_x((kb + 1) * kBK, xv);
    }
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[cur][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[cur][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[cur][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[cur][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (more) store_x(cur ^ 1, xv);
  }
  // columns 4 tx .. 4 tx + 3 and 64 + 4 tx ..: one unit's four gates each
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int u = (bn * kBN + 64 * h + 4 * tx) / 4;
    const float* bd = bias + d * 4 * U;
    const float4 bv = make_float4(__ldg(bd + u), __ldg(bd + U + u), __ldg(bd + 2 * U + u),
                                  __ldg(bd + 3 * U + u));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = bm * kBM + 4 * ty + (i < 4 ? i : 60 + i);
      if (row >= M) continue;
      const int s = row / B, b = row % B;
      const float* v = acc[i] + 4 * h;
      *reinterpret_cast<float4*>(P + ((((size_t)d * Tw + s) * B + b) * U + u) * 4) =
          make_float4(v[0] + bv.x, v[1] + bv.y, v[2] + bv.z, v[3] + bv.w);
    }
  }
  RV_PROJ_STORE;
}

// ---- 2. the recurrence over a cluster

// acc[gate][i] += a[k][i] * w[k][gate] over K k-rows: a at A's row of the
// tile's first k and the thread's first row (row stride R), w at the
// thread's unit in the ring slot (row stride `units` float4s)
template <int K>
__device__ __forceinline__ void fma_unit(float (&acc)[4][kRG], const float* a, int R,
                                         const float4* w, int units) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 wv = w[k * units];
    const float4 xa = *reinterpret_cast<const float4*>(a + k * R);
    const float4 xb = *reinterpret_cast<const float4*>(a + k * R + 4);
    const float xv[kRG] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      acc[0][i] = fmaf(xv[i], wv.x, acc[0][i]);
      acc[1][i] = fmaf(xv[i], wv.y, acc[1][i]);
      acc[2][i] = fmaf(xv[i], wv.z, acc[2][i]);
      acc[3][i] = fmaf(xv[i], wv.w, acc[3][i]);
    }
  }
}

// Steps s0 .. s0 + n - 1 of the layer for one (direction, row tile) a
// cluster (1-D grid: cluster q = blockIdx.x / C runs direction q / tiles,
// tile q % tiles; its CTA rank = blockIdx.x % C). State from hsrc / csrc
// [2, B, U] (h0, c0 in the first window, hN, cN after), written to hN, cN
// at the window's last step.
//
// The h exchange, one A buffer: step k waits on the mbarrier for the peers'
// h_{k-1} (phase (k-1) & 1), runs its product, arrives at the cluster
// barrier (its reads of A are done) and arms the mbarrier for h_k; after
// the cell it waits at the cluster barrier (every peer's reads are done,
// and so every bulk copy that read its own rows of step k - 1), stores its
// h_k rows into A and copies them into each peer's A by the bulk-copy
// engine.
__global__ void __launch_bounds__(kMaxThreads, 1)
rec_kernel(const float* __restrict__ xs, int B, int T, int F, int Kx, int Kin, int U, int C,
           int R,
           const float4* __restrict__ wxL,  // [2][Kx][U]: gates i, f, g, o of a unit
           const float4* __restrict__ whL,  // [2][U][U]
           const float* __restrict__ bias,  // [2, 4U]
           const float4* __restrict__ P,    // [2][Tw][B][U] (GEMM route)
           int Tw, int s0, int n, const float* hsrc, const float* csrc,
           float* __restrict__ out,         // [B, T, 2U]
           float* hN, float* cN RV_PHASES_ARG) {
  const Rec L(U, Kin, C, R);
  extern __shared__ __align__(16) float smem[];
  float4* ring = reinterpret_cast<float4*>(smem);                // [kSlots][kKT][a]
  float* A = smem + L.ring_bytes() / 4;                          // [Kin + U][R]: x_t, h_{t-1}
  const unsigned full = smem_u32(reinterpret_cast<char*>(A) + L.a_bytes());  // the exchange's mbarrier

  const int tiles = (B + R - 1) / R;
  const int q = blockIdx.x / C, rank = blockIdx.x % C;
  const int d = q / tiles, b0 = (q % tiles) * R;
  const int tid = threadIdx.x, ul = tid % L.a, r0 = kRG * (tid / L.a);
  const int ra = rank * L.a, u = ra + ul;  // this CTA's first unit; this thread's
  RV_PHASES_INIT;

  // k-tile j of a step: Wx's Kin rows (j = 0 on the inline route), then Wh's
  // rows [16 i, 16 i + 16), the CTA's a units of each, into ring slot `slot`
  // by 16-byte cp.async pieces, one commit group a k-tile
  auto tile_rows = [&](int j) { return Kin > 0 && j == 0 ? Kin : kKT; };
  auto issue_tile = [&](int j, int slot) {
    const int rows = tile_rows(j);
    const int i = j - (Kin > 0);
    const float4* src = i < 0 ? wxL + (size_t)d * Kx * U + ra
                              : whL + ((size_t)d * U + kKT * i) * U + ra;
    float4* dst = ring + (size_t)slot * kKT * L.a;
    for (int e = tid; e < rows * L.a; e += L.threads) {
      const int k = e / L.a, v = e % L.a;
      cp_async16(dst + e, src + (size_t)k * U + v);
    }
    cp_async_commit();
  };
  // x_t of the tile, rows [0, Kin) of A (zero past F and B): the thread's
  // elements e = tid + i threads, loaded into xr, then stored
  float xr[kXR];
  auto load_x = [&](int t) {
#pragma unroll
    for (int i = 0; i < kXR; ++i) {
      const int e = tid + i * L.threads;
      if (e >= Kin * R) break;
      const int k = e / R, r = e % R, row = b0 + r;
      xr[i] = (k < F && row < B) ? __ldg(xs + ((size_t)row * T + t) * F + k) : 0.f;
    }
  };
  auto store_x = [&]() {
#pragma unroll
    for (int i = 0; i < kXR; ++i) {
      const int e = tid + i * L.threads;
      if (e >= Kin * R) break;
      A[e] = xr[i];
    }
  };

  if (tid == 0) xmbar_init(full, 1);
  // the first kSlots - 1 k-tiles in flight
  for (int j = 0; j < kSlots - 1; ++j) issue_tile(j, j);
  // A: x_{s0} and h (every unit) of the tile's rows; c of the thread's cells
  for (int e = tid; e < U * R; e += L.threads) {
    const int k = e / R, r = e % R, row = b0 + r;
    A[Kin * R + e] = row < B ? hsrc[((size_t)d * B + row) * U + k] : 0.f;
  }
  if (Kin > 0) {
    load_x(d == 0 ? s0 : T - 1 - s0);
    store_x();
  }
  float c[kRG];
#pragma unroll
  for (int i = 0; i < kRG; ++i) {
    const int row = b0 + r0 + i;
    c[i] = row < B ? csrc[((size_t)d * B + row) * U + u] : 0.f;
  }
  // a step's pre-activations: P (GEMM route), loaded as the step starts
  // (its latency a small part of the step), or the bias (inline)
  const float* bd = bias + d * 4 * U;
  const float4 bv = make_float4(__ldg(bd + u), __ldg(bd + U + u), __ldg(bd + 2 * U + u),
                                __ldg(bd + 3 * U + u));
  cluster_sync();  // every CTA of the cluster runs, its mbarrier set and A in place
  const unsigned own = smem_u32(A + (Kin + ra) * R);  // this CTA's h rows

  int nt = 0;  // k-tiles used so far: k-tile nt lies in slot nt % kSlots
  for (int step = 0; step < n; ++step) {
    const int s = s0 + step, t = d == 0 ? s : T - 1 - s;
    const bool more = step + 1 < n;
    if (step > 0) {
      xmbar_wait(full, (step - 1) & 1);  // the peers' rows of h_{t-1}
      RV_STAMP(kClusterBar);
    }
    float acc[4][kRG];
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      const int row = b0 + r0 + i;
      const float4 z = (Kin > 0 || row >= B)
                           ? bv : __ldg(P + (((size_t)d * Tw + step) * B + row) * U + u);
      acc[0][i] = z.x; acc[1][i] = z.y; acc[2][i] = z.z; acc[3][i] = z.w;
    }
    RV_STAMP(kCell);
    for (int j = 0; j < L.NT; ++j, ++nt) {
      const int slot = nt % kSlots;
      ring_wait();      // this thread's pieces of k-tile nt landed
      __syncthreads();  // everyone's; every thread is done with k-tile nt - 1: its slot is free
      const int next = nt + kSlots - 1;  // into the slot of k-tile nt - 1
      if (next < n * L.NT) issue_tile(next % L.NT, next % kSlots);
      else cp_async_commit();  // an empty group keeps the count
      RV_STAMP(kRing);
      const float4* w = ring + (size_t)slot * kKT * L.a + ul;
      if (Kin > 0 && j == 0) {
        for (int k = 0; k < Kin; k += 4) fma_unit<4>(acc, A + k * R + r0, R, w + k * L.a, L.a);
      } else {
        const int k0 = Kin + kKT * (j - (Kin > 0));
        fma_unit<kKT>(acc, A + k0 * R + r0, R, w, L.a);
      }
      RV_STAMP(kProduct);
    }
    if (more) {  // this thread's reads of A this step are done
      if (Kin > 0) load_x(d == 0 ? s + 1 : T - 2 - s);  // in flight through the cell
      if (tid == 0) xmbar_expect(full, (unsigned)(C - 1) * L.slice_bytes());
      cluster_arrive();  // ... and with every thread's, the peers may write h_t into it
    }

    // the cell of the thread's (row, unit) pairs
    float hv[kRG];
#pragma unroll
    for (int i = 0; i < kRG; ++i) {
      lstm_cell(acc[0][i], acc[1][i], acc[2][i], acc[3][i], c[i], hv[i]);
      const int row = b0 + r0 + i;
      if (row < B) {
        out[((size_t)row * T + t) * (2 * U) + d * U + u] = hv[i];
        if (!more) {
          const size_t st = ((size_t)d * B + row) * U + u;
          hN[st] = hv[i];
          cN[st] = c[i];
        }
      }
    }
    RV_STAMP(kCell);
    if (!more) break;
    cluster_wait();  // every read of A in the cluster is done: the copies of step t-1 too
    RV_STAMP(kClusterBar);
    if (Kin > 0) store_x();
    float4* hd = reinterpret_cast<float4*>(A + (Kin + u) * R + r0);
    hd[0] = make_float4(hv[0], hv[1], hv[2], hv[3]);
    hd[1] = make_float4(hv[4], hv[5], hv[6], hv[7]);
    fence_proxy_async();
    __syncthreads();  // this CTA's rows of h_t are in A
    // ... and into every peer's A, the peers in turn from the next rank
    if (tid < C - 1) {
      const unsigned p = (rank + 1 + tid) % C;
      bulk_to_peer(peer_u32(own, p), own, L.slice_bytes(), peer_u32(full, p));
    }
    RV_STAMP(kExchange);
  }
  cluster_sync();  // no CTA leaves while a peer's copy may still read its rows
  RV_PHASES_STORE;
}

// The shape's recurrence: refused (invalid) unless the entries take it.
bool takes(int B, int T, int F, int Kx, int U) {
  return rv_bilstm_wide_compiled(U) && B > 0 && T > 0 && F > 0 && F <= 2 * U &&
         Kx == (F + 3) / 4 * 4;
}
int inline_rows(int F, int Kx) { return F <= kInline ? Kx : 0; }

// The clusters of the shape the card holds at once (0: none fits).
cudaError_t active_clusters(const Rec& L, int* n) {
  *n = 0;
  cudaError_t e = cudaFuncSetAttribute(rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.smem());
  if (e == cudaSuccess && L.C > 8)
    e = cudaFuncSetAttribute(rec_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)L.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)L.C);
  cfg.blockDim = dim3((unsigned)L.threads);
  cfg.dynamicSmemBytes = L.smem();
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(n, rec_kernel, &cfg);
}

}  // namespace

// Launches on `stream`; returns a cudaError_t (0 = launched). U one of
// RV_BILSTM_WIDE_UNITS (bilstm_units.cuh); xs [B, T, F] f32 (F <= 2U);
// Kx = F rounded up to 4; wxL [2, Kx, U, 4], whL [2, U, U, 4] the weights
// with each row's gate columns grouped by unit, 16-byte aligned
// (ops/rnn_cuda.py:kernel_layout); bias [2, 4U]; h0, c0, hN, cN [2, B, U];
// out [B, T, 2U]; scratch [2, Tw, B, U, 4] f32 (F > 16; unused, may be
// null, for F <= 16); C, R, Tw as rv_bilstm_layer_wide_cta gives them
// (any others that the kernels take: C dividing U, at most 16; R a multiple
// of 8 up to 128 with U R / (8 C) threads, 32 to 512; Tw >= 1 steps a
// window); parts: 1 the projection alone, 2 the recurrence alone (on the
// scratch as it stands), 3 both (the layer). The timing build's entry
// (rv_bilstm_layer_wide_phases) takes the stamps before the stream.
#ifdef RV_BILSTM_PHASES
extern "C" const char* rv_bilstm_phase_names() { return RV_BILSTM_PHASE_NAMES; }
extern "C" int rv_bilstm_layer_wide_phases(const float* xs, int B, int T, int F, int Kx, int U,
                                           const void* wxL, const void* whL, const float* bias,
                                           const float* h0, const float* c0, float* out,
                                           float* hN, float* cN, void* scratch, int C, int R,
                                           int Tw, int parts, long long* stamps, void* stream) {
#else
extern "C" int rv_bilstm_layer_wide(const float* xs, int B, int T, int F, int Kx, int U,
                                    const void* wxL, const void* whL, const float* bias,
                                    const float* h0, const float* c0, float* out, float* hN,
                                    float* cN, void* scratch, int C, int R, int Tw, int parts,
                                    void* stream) {
#endif
  const int Kin = inline_rows(F, Kx);
  const Rec L(U, Kin, C, R);
  if (!takes(B, T, F, Kx, U) || !L.valid() || Tw < 1 || parts < 1 || parts > 3 ||
      (Kin == 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(rec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L.smem());
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(rec_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (B + R - 1) / R;
  const int window = Kin > 0 ? T : Tw;  // the inline route runs all T steps at once
  float* P = static_cast<float*>(scratch);
  for (int s0 = 0; s0 < T; s0 += window) {
    const int n = window < T - s0 ? window : T - s0;
    if (Kin == 0 && (parts & 1)) {
      dim3 grid((unsigned)(((size_t)n * B + kBM - 1) / kBM * (4 * U / kBN)), 2);
      proj_kernel<<<grid, kGemmThreads, 0, st>>>(xs, B, T, F, Kx, U,
                                                 static_cast<const float*>(wxL), bias, P, Tw,
                                                 s0, n RV_PHASES_PASS);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    if (parts & 2) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)C;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3((unsigned)(2 * tiles * C));
      cfg.blockDim = dim3((unsigned)L.threads);
      cfg.dynamicSmemBytes = L.smem();
      cfg.stream = st;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      const float* hs = s0 == 0 ? h0 : hN;
      const float* cs = s0 == 0 ? c0 : cN;
      e = cudaLaunchKernelEx(&cfg, rec_kernel, xs, B, T, F, Kx, Kin, U, C, R,
                             static_cast<const float4*>(wxL), static_cast<const float4*>(whL),
                             bias, static_cast<const float4*>(scratch), Tw, s0, n, hs, cs, out,
                             hN, cN RV_REC_PASS);
      if (e != cudaSuccess) return (int)e;
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  return 0;
}

// The plan of a layer of U units on Kx padded input columns, B rows and T
// steps, into info: {threads, dynamic shared memory bytes, R, registers a
// thread, local memory bytes a thread (cudaFuncGetAttributes, the
// recurrence), C, Tw, clusters the card holds at once, the projection's
// registers}. With C = 0 it takes the rule's (C, R): clusters of 8, and
// the fewest rows, a multiple of 16, that give a CTA at least 6 warps (48
// at 320 units, 32 at 384 to 512), or twice as many where the card holds
// only one such CTA an SM (at 512 units on F = 5: the SM's rows in flight
// in half the clusters, PERF.md); with C > 0 it describes the given (C,
// R), refused where the kernels do not take it. Tw keeps the scratch
// within 1 GiB. Returns a cudaError_t; refuses what rv_bilstm_layer_wide
// refuses.
extern "C" int rv_bilstm_layer_wide_cta(int U, int Kx, int B, int T, int C, int R, int* info) {
  if (!rv_bilstm_wide_compiled(U) || Kx <= 0 || Kx % 4 != 0 || Kx > 2 * U || B <= 0 || T <= 0)
    return (int)cudaErrorInvalidValue;
  const int Kin = Kx <= kInline ? Kx : 0;
  cudaError_t e = cudaSuccess;
  if (C == 0) {
    C = 8;
    for (R = 16; Rec(U, Kin, C, R).threads < 192; R += 16) {}
    int dev = 0, sms = 0, n = 0, n2 = 0;
    if ((e = cudaGetDevice(&dev)) == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) e = active_clusters(Rec(U, Kin, C, R), &n);
    if (e != cudaSuccess) return (int)e;
    const Rec L2(U, Kin, C, 2 * R);
    if (n > 0 && n * C <= sms && L2.valid()) {  // one CTA an SM
      if (active_clusters(L2, &n2) != cudaSuccess) cudaGetLastError();  // it does not fit
      if (n2 > 0) R *= 2;
    }
  }
  const Rec L(U, Kin, C, R);
  if (!L.valid()) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes rec, proj;
  e = cudaFuncGetAttributes(&rec, rec_kernel);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&proj, proj_kernel);
  int clusters = 0;
  if (e == cudaSuccess) e = active_clusters(L, &clusters);
  if (e != cudaSuccess) return (int)e;
  const size_t per_step = 2 * (size_t)B * 4 * U * sizeof(float);  // the scratch's bytes a step
  const size_t fit = ((size_t)1 << 30) / per_step;
  info[0] = L.threads;
  info[1] = (int)L.smem();
  info[2] = L.R;
  info[3] = rec.numRegs;
  info[4] = (int)rec.localSizeBytes;
  info[5] = L.C;
  info[6] = Kin > 0 || fit >= (size_t)T ? T : fit < 1 ? 1 : (int)fit;
  info[7] = clusters;
  info[8] = proj.numRegs;
  return 0;
}
