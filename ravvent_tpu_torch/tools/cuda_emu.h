// CPU emulation of the CUDA subset that the port's plain-C kernels use, for
// rehearsing a kernel's logic against its plain version without a card
// (ravvent_tpu_torch/tools/cuda_emu.py translates a csrc/ source against
// this header). One CTA at a time (1-D or 2-D grids), or one thread-block
// cluster at a time (cudaLaunchKernelEx with a cluster dimension). Each CUDA
// thread is a fiber (a stack and registers of its own) on the launching
// host thread, and the fibers of a CTA (of a cluster) run in turn, each until
// it waits: __syncthreads, the warp exchanges, the cluster barrier and an
// mbarrier wait are barriers whose waiters yield until the phase completes.
// A launch makes its fibers once and runs them again for each CTA (cluster),
// with the CUDA thread's registers of the emulation (threadIdx, blockIdx,
// the CTA, the cluster, the mma turn) set anew, a fresh CTA (barriers, NaN
// shared memory) each time; a host thread a CUDA thread would put every
// barrier through the OS scheduler, which a loaded host makes slow. The
// fibers run in pass order, forward on even passes and backward on odd
// ones, so that a read of what another thread writes in the same phase
// (a missing barrier) sees the unwritten value on one of two orders; a pass
// in which no fiber moves is a deadlock, and aborts.
// Shared memory starts as NaNs, so that a read of what no thread wrote
// shows; the card has 2 SMs that hold 2 CTAs each, and clusters of at most
// 2 CTAs. mma.sync.m16n8k16 on bf16 with an f32
// accumulator runs through the same warp exchange as __shfl_sync, its
// products summed in f32 in k order. A shared-memory address for inline PTX
// is the byte offset in the CTA's dynamic shared buffer; mapa.u64 moves a
// generic pointer into it to the same place in a peer CTA's buffer, which
// the kernel then reads and writes as distributed shared memory. The
// beam-loop kernel's and the wide f32 BiLSTM kernel's mbarriers (init,
// arrive.expect_tx, complete_tx, try_wait.parity) keep their phase and
// transaction count, and a wait blocks until its phase completes; a
// multicast bulk copy copies into every CTA of its mask at once and
// completes its bytes on each one's mbarrier, and a bulk copy from a CTA's
// shared memory into a peer's on the peer's.
// The card's 1 MiB of shared memory a block lets a cluster of 2 hold what
// a cluster of 8 holds on the H100.
#pragma once
#include <sys/mman.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <map>
#include <memory>
#include <mutex>
#include <vector>
using std::min; using std::max;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static  // one CTA at a time: a static is the CTA's
#define __align__(n)
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim, blockDim;
// aligned as on the card, so that the emulation's -fsanitize=alignment
// reports a misaligned vector access as the card would fault on it
struct alignas(16) uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return {x, y, z, w}; }
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(8) float2 { float x, y; };
inline float2 make_float2(float a, float b) { return {a, b}; }
struct __nv_bfloat16 { unsigned short v; };
struct __nv_bfloat162 { __nv_bfloat16 a, b; };
inline float __uint_as_float(unsigned u) { float f; memcpy(&f, &u, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned u; memcpy(&u, &f, 4); return u; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline __nv_bfloat16 __float2bfloat16_rn(float x) {
  unsigned u = __float_as_uint(x);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(unsigned short)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1);
  return {(unsigned short)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) { return __uint_as_float((unsigned)b.v << 16); }
inline __nv_bfloat162 __floats2bfloat162_rn(float lo, float hi) {
  return {__float2bfloat16_rn(lo), __float2bfloat16_rn(hi)};
}
inline float __low2float(__nv_bfloat162 p) { return __bfloat162float(p.a); }
inline float __high2float(__nv_bfloat162 p) { return __bfloat162float(p.b); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline unsigned emu_cluster_dim(const cudaLaunchConfig_t* cfg) {
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension) return cfg->attrs[i].val.clusterDim.x;
  return 1;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, F, const cudaLaunchConfig_t* cfg) {
  *n = emu_cluster_dim(cfg) <= 2 ? 1 : 0;  // clusters of 2 at most, one at a time
  return cudaSuccess;
}
// the non-portable cluster size (past 8 CTAs) that the wide f32 BiLSTM
// kernel asks for: accepted, and the emulation runs a cluster of any size
// together
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize, cudaFuncAttributeNonPortableClusterSizeAllowed
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount, cudaDevAttrMaxSharedMemoryPerBlockOptin };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
// a kernel's attributes: the emulation compiles no kernel, so it reports
// no registers and no local memory
struct cudaFuncAttributes { int numRegs; size_t localSizeBytes; };
template <class F>
cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a, F) {
  *a = cudaFuncAttributes{0, 0};
  return cudaSuccess;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  *v = a == cudaDevAttrMultiProcessorCount ? 2 : 1 << 20;  // 2 SMs; 1 MiB of shared memory a block
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 2;  // CTAs an SM
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class T> T __ldg(const T* p) { return *p; }
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
  uint64_t v = ((uint64_t)y << 32) | x;
  unsigned r = 0;
  for (int n = 0; n < 4; ++n)
    r |= (unsigned)((v >> (8 * ((s >> (4 * n)) & 7))) & 0xff) << (8 * n);
  return r;
}
inline int __dp4a(int a, int b, int c) {
  for (int i = 0; i < 4; ++i) c += (int)(int8_t)(a >> (8 * i)) * (int)(int8_t)(b >> (8 * i));
  return c;
}
inline int __float2int_rn(float x) { return (int)std::nearbyint(x); }
inline float __expf(float x) { return std::exp(x); }
inline float __fdividef(float a, float b) { return a / b; }

// ---- the fibers' barrier: arrive, then yield until the phase completes
inline void emu_yield();
inline thread_local unsigned long g_progress = 0;  // arrivals and exits: a deadlock moves none
struct EmuBarrier {
  long expected, left;
  unsigned long phase = 0;
  explicit EmuBarrier(long n) : expected(n), left(n) {}
  unsigned long arrive() {
    ++g_progress;
    const unsigned long p = phase;
    if (--left == 0) { left = expected; ++phase; }
    return p;
  }
  void wait(unsigned long p) { while (phase == p) emu_yield(); }
  void arrive_and_wait() { wait(arrive()); }
};

// ---- the CTA's barriers and warp exchange
struct Cta {
  std::unique_ptr<EmuBarrier> block;
  std::vector<std::unique_ptr<EmuBarrier>> warps;
  std::vector<uint64_t> slots;  // a warp exchange's values, one a thread
  std::vector<float> smem;      // the dynamic shared buffer
  std::vector<unsigned> mma[2]; // an mma's fragments, 6 words a thread, two calls in turn
};
inline thread_local Cta* g_cta = nullptr;
inline void __syncthreads() { g_cta->block->arrive_and_wait(); }
inline void __syncwarp() { g_cta->warps[threadIdx.x / 32]->arrive_and_wait(); }
template <class T> T shfl_impl(T v, int src_lane) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  uint64_t x = 0; memcpy(&x, &v, sizeof(T));
  g_cta->slots[threadIdx.x] = x;
  __syncwarp();
  uint64_t y = g_cta->slots[w * 32 + src_lane];
  __syncwarp();
  T r; memcpy(&r, &y, sizeof(T));
  return r;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  return shfl_impl(v, (threadIdx.x & 31) ^ o);
}
template <class T> T __shfl_sync(unsigned, T v, int l) { return shfl_impl(v, l); }
inline int __reduce_add_sync(unsigned, int v) {
  int s = 0; for (int o = 0; o < 32; ++o) s += shfl_impl(v, o); return s;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  unsigned m = 0; for (int o = 0; o < 32; ++o) m = std::max(m, shfl_impl(v, o)); return m;
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  unsigned m = ~0u; for (int o = 0; o < 32; ++o) m = std::min(m, shfl_impl(v, o)); return m;
}
inline float* emu_smem() { return g_cta->smem.data(); }
inline unsigned __cvta_generic_to_shared(const void* p) {
  return (unsigned)(reinterpret_cast<const char*>(p) - reinterpret_cast<const char*>(emu_smem()));
}

// ---- thread-block clusters: the cluster barrier, mapa (distributed shared
// memory), mbarriers and the multicast bulk copy
struct Cluster {
  std::vector<Cta*> ctas;
  std::unique_ptr<EmuBarrier> bar;
};
inline thread_local Cluster* g_cluster = nullptr;
inline thread_local unsigned long g_cluster_token = 0;  // the phase arrived at
inline void emu_cluster_arrive() { g_cluster_token = g_cluster->bar->arrive(); }
inline void emu_cluster_wait() { g_cluster->bar->wait(g_cluster_token); }
// a shared-memory address of this CTA, or of the rank emu_rank names
inline unsigned emu_rank(unsigned addr, unsigned rank) { return (addr & 0xffffffu) | ((rank + 1) << 24); }
inline unsigned char* emu_shared(unsigned addr) {
  Cta* c = addr >> 24 ? g_cluster->ctas.at((addr >> 24) - 1) : g_cta;
  return reinterpret_cast<unsigned char*>(c->smem.data()) + (addr & 0xffffffu);
}
// mapa.u64: a generic pointer into this CTA's shared memory, moved to the
// same place in the shared memory of CTA `rank` of the cluster
inline uint64_t emu_mapa(const void* p, unsigned rank) {
  const char* mine = reinterpret_cast<const char*>(emu_smem());
  return reinterpret_cast<uint64_t>(
      reinterpret_cast<char*>(g_cluster->ctas.at(rank)->smem.data()) +
      (reinterpret_cast<const char*>(p) - mine));
}
struct EmuMbar { long long expected = 0, pending = 0, tx = 0; unsigned phase = 0; };
inline std::mutex g_mbar_mu;  // the map, for launches from several host threads
inline std::map<const void*, EmuMbar> g_mbars;
inline void emu_mbar_complete(EmuMbar& m) {  // with g_mbar_mu held
  ++g_progress;
  if (m.pending == 0 && m.tx == 0) {
    m.phase ^= 1u;
    m.pending = m.expected;
  }
}
inline void emu_mbar_init(unsigned addr, unsigned count) {
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  g_mbars[emu_shared(addr)] = EmuMbar{count, count, 0, 0};
}
inline void emu_mbar_arrive_tx(unsigned addr, unsigned bytes) {
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  EmuMbar& m = g_mbars.at(emu_shared(addr));
  m.tx += bytes;
  m.pending -= 1;
  emu_mbar_complete(m);
}
inline unsigned emu_mbar_try_wait(unsigned addr, unsigned parity) {
  for (;;) {
    {
      std::lock_guard<std::mutex> lk(g_mbar_mu);
      if ((g_mbars.at(emu_shared(addr)).phase & 1u) != (parity & 1u)) return 1u;
    }
    emu_yield();
  }
}
inline void emu_bulk_multicast(unsigned dst, const void* src, unsigned bytes, unsigned bar,
                               unsigned short mask) {
  for (unsigned r = 0; r < g_cluster->ctas.size(); ++r)
    if (mask >> r & 1u) {
      memcpy(emu_shared(emu_rank(dst, r)), src, bytes);
      std::lock_guard<std::mutex> lk(g_mbar_mu);
      EmuMbar& m = g_mbars.at(emu_shared(emu_rank(bar, r)));
      m.tx -= bytes;
      emu_mbar_complete(m);
    }
}

// the bulk copy of bytes at this CTA's shared address src into the shared
// address dst (a peer's, by emu_rank), completing them on the mbarrier at
// bar (the peer's)
inline void emu_bulk_to_peer(unsigned dst, unsigned src, unsigned bytes, unsigned bar) {
  memcpy(emu_shared(dst), emu_shared(src), bytes);
  std::lock_guard<std::mutex> lk(g_mbar_mu);
  EmuMbar& m = g_mbars.at(emu_shared(bar));
  m.tx -= bytes;
  emu_mbar_complete(m);
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {d0..d3}, {a0..a3},
// {b0, b1}, {d0..d3}: lane (g, tg) holds A rows g, g + 8 and columns
// 2tg + {0, 1} (+8 in a2, a3), B column g and rows 2tg + {0, 1} (+8 in b1),
// D rows g, g + 8 and columns 2tg + {0, 1}. Fragments alternate between two
// buffers, so one warp barrier a call orders each write after the reads of
// two calls back.
inline thread_local unsigned emu_mma_turn = 0;
inline void emu_mma_m16n8k16_bf16(float& d0, float& d1, float& d2, float& d3, unsigned a0,
                                  unsigned a1, unsigned a2, unsigned a3, unsigned b0,
                                  unsigned b1) {
  const int lane = threadIdx.x & 31;
  const unsigned* warp = g_cta->mma[emu_mma_turn].data() + 6 * (threadIdx.x - lane);
  unsigned* mine = g_cta->mma[emu_mma_turn].data() + 6 * threadIdx.x;
  mine[0] = a0; mine[1] = a1; mine[2] = a2; mine[3] = a3; mine[4] = b0; mine[5] = b1;
  __syncwarp();
  auto half = [](unsigned v, int k) { return __uint_as_float((k & 1 ? v >> 16 : v & 0xffffu) << 16); };
  const int g = lane >> 2, tg = lane & 3;
  float* d[4] = {&d0, &d1, &d2, &d3};
  for (int i = 0; i < 4; ++i) {
    const int row = g + 8 * (i >> 1), col = 2 * tg + (i & 1);
    float s = *d[i];
    for (int k = 0; k < 16; ++k) {
      const float a = half(warp[6 * ((row & 7) * 4 + (k & 7) / 2) + (row >> 3) + 2 * (k >> 3)], k);
      const float b = half(warp[6 * (col * 4 + (k & 7) / 2) + 4 + (k >> 3)], k);
      s += a * b;
    }
    *d[i] = s;
  }
  emu_mma_turn ^= 1;
}

inline std::unique_ptr<Cta> emu_cta(int threads, size_t smem) {
  auto cta = std::make_unique<Cta>();
  cta->block = std::make_unique<EmuBarrier>(threads);
  for (int w = 0; w < (threads + 31) / 32; ++w)
    cta->warps.push_back(std::make_unique<EmuBarrier>(std::min(32, threads - 32 * w)));
  cta->slots.assign(threads, 0);
  cta->mma[0].assign(6 * threads, 0u);
  cta->mma[1].assign(6 * threads, 0u);
  cta->smem.assign(smem / 4 + 64, __uint_as_float(0x7fc00001u));  // NaNs
  return cta;
}

// ---- the fibers: a CUDA thread's stack, context and registers of the
// emulation, saved when it yields and set again when it resumes. A switch
// saves the callee-saved registers and the FP control words on the stack it
// leaves and loads the other stack's (x86-64; no system call, unlike
// swapcontext, which sets the signal mask on every switch).
#if !defined(__x86_64__)
#error "cuda_emu: the fibers' context switch is written for x86-64"
#endif
extern "C" void emu_ctx_switch(void** save_sp, void* load_sp);
asm(R"(
  .text
  .weak emu_ctx_switch
  .hidden emu_ctx_switch
  .type emu_ctx_switch, @function
emu_ctx_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_ctx_switch, .-emu_ctx_switch
)");
struct EmuFiber {
  void* sp = nullptr;  // its stack pointer while it waits
  void* stack = nullptr;
  bool done = true;
  dim3 tid, bid;
  Cta* cta = nullptr;
  Cluster* cluster = nullptr;
  unsigned mma_turn = 0;
  unsigned long cluster_token = 0;
};
constexpr size_t kEmuStack = 1u << 20;  // bytes a fiber, a guard page below
inline thread_local void* g_sched = nullptr;  // the launching thread's stack pointer
inline thread_local EmuFiber* g_fiber = nullptr;
inline thread_local const std::function<void()>* g_body = nullptr;
inline void emu_resume_state(const EmuFiber* f) {
  threadIdx = f->tid; blockIdx = f->bid; g_cta = f->cta; g_cluster = f->cluster;
  emu_mma_turn = f->mma_turn; g_cluster_token = f->cluster_token;
}
inline void emu_yield() {
  EmuFiber* f = g_fiber;
  f->mma_turn = emu_mma_turn; f->cluster_token = g_cluster_token;
  emu_ctx_switch(&f->sp, g_sched);
  emu_resume_state(f);
}
[[noreturn]] inline void emu_fiber_main() {
  emu_resume_state(g_fiber);
  (*g_body)();
  g_fiber->done = true;
  ++g_progress;
  emu_ctx_switch(&g_fiber->sp, g_sched);
  abort();  // a finished fiber is never resumed
}
inline void emu_fiber_start(EmuFiber& f) {
  char* top = static_cast<char*>(f.stack) + 4096 + kEmuStack;
  // the frame emu_ctx_switch pops: FP control words, six registers, then
  // emu_fiber_main as its return address, entered as if called (rsp = 8
  // mod 16)
  void** sp = reinterpret_cast<void**>(top) - 1;  // top is 16-aligned; *sp a dummy return
  *--sp = reinterpret_cast<void*>(&emu_fiber_main);
  for (int r = 0; r < 6; ++r) *--sp = nullptr;
  --sp;
  unsigned ctl[2];
  asm volatile("stmxcsr %0\n\tfnstcw %1" : "=m"(ctl[0]), "=m"(ctl[1]));
  memcpy(sp, ctl, 8);
  f.sp = sp;
}

// A launch's fibers, one a CUDA thread of a CTA (of a cluster), made once and
// run again for each CTA (cluster) by run().
struct EmuFibers {
  std::vector<EmuFiber> fs;
  explicit EmuFibers(size_t n) : fs(n) {
    for (auto& f : fs) {
      void* m = mmap(nullptr, kEmuStack + 4096, PROT_READ | PROT_WRITE,
                     MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
      if (m == MAP_FAILED) { perror("cuda_emu: mmap of a fiber's stack"); abort(); }
      mprotect(m, 4096, PROT_NONE);  // an overflow faults
      f.stack = m;
    }
  }
  ~EmuFibers() {
    for (auto& f : fs) munmap(f.stack, kEmuStack + 4096);
  }
  // every fiber runs body with fiber k's registers from set(k, fiber), in
  // passes until all have returned
  template <class Set>
  void run(const std::function<void()>& body, Set set) {
    for (size_t k = 0; k < fs.size(); ++k) {
      EmuFiber& f = fs[k];
      void* stack = f.stack;
      f = EmuFiber{};
      f.stack = stack;
      f.done = false;
      set(k, f);
      emu_fiber_start(f);
    }
    g_body = &body;
    size_t live = fs.size();
    for (unsigned pass = 0; live; ++pass) {
      const unsigned long before = g_progress;
      for (size_t i = 0; i < fs.size(); ++i) {
        EmuFiber& f = fs[pass & 1 ? fs.size() - 1 - i : i];
        if (f.done) continue;
        g_fiber = &f;
        emu_ctx_switch(&g_sched, f.sp);
        if (f.done) --live;
      }
      if (live && g_progress == before) {
        fprintf(stderr, "cuda_emu: deadlock, %zu CUDA threads wait on a barrier no thread "
                "will complete\n", live);
        abort();
      }
    }
  }
};

template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t, A... args) {
  gridDim = grid; blockDim.x = threads;
  EmuFibers fibers(threads);
  const std::function<void()> body = [&] { kernel(args...); };
  for (unsigned by = 0; by < grid.y; ++by)
    for (unsigned bx = 0; bx < grid.x; ++bx) {
      auto cta = emu_cta(threads, smem);
      fibers.run(body, [&](size_t t, EmuFiber& f) {
        f.tid.x = (unsigned)t; f.bid.x = bx; f.bid.y = by; f.cta = cta.get();
      });
    }
}
template <class K, class... A>
void emu_launch(K kernel, int grid, int threads, size_t smem, cudaStream_t stream, A... args) {
  emu_launch(kernel, dim3(grid), threads, smem, stream, args...);
}

// A 1-D grid of clusters of emu_cluster_dim(cfg) CTAs, one cluster at a time,
// the CTAs of a cluster together.
template <class... P, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A... args) {
  const unsigned C = emu_cluster_dim(cfg);
  const int threads = (int)cfg->blockDim.x;
  if (cfg->gridDim.x % C != 0 || cfg->gridDim.y != 1) return cudaErrorInvalidValue;
  gridDim = cfg->gridDim; blockDim.x = threads;
  EmuFibers fibers((size_t)C * threads);
  const std::function<void()> body = [&] { kernel(args...); };
  for (unsigned cl = 0; cl < cfg->gridDim.x / C; ++cl) {
    std::vector<std::unique_ptr<Cta>> ctas;
    Cluster cluster;
    for (unsigned r = 0; r < C; ++r) {
      ctas.push_back(emu_cta(threads, cfg->dynamicSmemBytes));
      cluster.ctas.push_back(ctas.back().get());
    }
    cluster.bar = std::make_unique<EmuBarrier>((long)C * threads);
    fibers.run(body, [&](size_t k, EmuFiber& f) {
      const unsigned r = (unsigned)(k / threads);
      f.tid.x = (unsigned)(k % threads); f.bid.x = cl * C + r; f.bid.y = 0;
      f.cta = ctas[r].get(); f.cluster = &cluster;
    });
  }
  return cudaSuccess;
}
