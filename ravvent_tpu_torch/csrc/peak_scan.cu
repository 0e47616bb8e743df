// The blocked peak scan of on-device event detection, with its exactness
// check and sequential rescan.
//
// Replaces no Pallas kernel: the JAX package runs this state machine as
// lax.scan loops that XLA compiles into one program
// (ravvent_tpu/ops/event_detect.py: peak_scan_device_blocked :210, its
// scans :285 and :292, the sequential peak_scan_device :180/:205, and the
// lax.cond fallback in detect_boundaries_device :344). Eager PyTorch would
// launch some 50 elementwise kernels for each of a read's 768 sequential
// steps; these two kernels take their place.
//
// The state machine (_peak_step, :102-164): a short detector on the window-w1
// t-statistic t1 and a long one on the window-w2 statistic t2, each holding
// (pos, val, valid); the short one masks the long one up to l_masked. Every
// compare is in f32 against f32 arguments, as the reference compares f32
// arrays with weakly typed Python floats; (bm - pos) > w/2 is an integer
// difference converted to f32. No product is formed, so no FMA contraction
// can change a bit.
//
// What bounds it on the H100: neither bytes nor operations, but the
// dependent chain. A read of S samples is cut into C = ceil(S / 512) blocks;
// each block is one thread, whose state lives in registers, and runs 256
// warm-up samples from the default state (block 0 skips them: they lie
// before the read) and then its own 512, so the chain is 768 steps whatever
// the read's length. The bytes are small (t1, t2 read about 1.5 times, the
// fired mask written once: ~1.7 MB at S = 131072). Each thread loads its
// samples 16 at a time ahead of the steps that use them, so a step waits on
// no load.
//
// peak_scan_check runs after it, one warp per read, every time, so the
// decision never leaves the card: block c (starting before n_valid) must
// begin in the state block c-1 ended in, all 7 components equal; if any
// differs, that read is scanned again from the default state one sample at
// a time and its fired mask overwritten. Rescanning only the reads that
// failed gives the reference's bits (it falls back for the whole batch),
// since each read's sequential scan is independent of the others. Fires
// from sample n_valid on are written 0.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;   // samples of a block (the reference's block)
constexpr int kWarmup = 256;  // warm-up samples before each block (its warmup)
constexpr int kStage = 16;    // samples loaded ahead of their steps
constexpr int kThreads = 64;  // blocks (threads) per CTA
constexpr float kFltMax = 3.4028234663852886e38f;

struct PeakState {
  int s_pos;
  float s_val;
  int s_valid;
  int l_pos;
  float l_val;
  int l_valid;
  int l_masked;
};

struct PeakParams {
  int w1;
  float half_w1, half_w2, th1, th2, ph;
};

__device__ __forceinline__ PeakState peak_init() {
  PeakState s;
  s.s_pos = -1; s.s_val = kFltMax; s.s_valid = 0;
  s.l_pos = -1; s.l_val = kFltMax; s.l_valid = 0;
  s.l_masked = 0;
  return s;
}

// One active sample of the state machine; returns whether it fires. The
// selects follow the reference's jnp.where chain.
__device__ __forceinline__ bool peak_step(PeakState& st, float t1, float t2, int bm,
                                          const PeakParams& p) {
  // short detector (skipped at bm == 0)
  const bool run_s = bm != 0;
  const bool in_case1 = st.s_pos == -1;
  const bool lower = t1 < st.s_val;
  const bool rise = (t1 - st.s_val) > p.ph;
  const float s_val_c1 = (lower || rise) ? t1 : st.s_val;
  const int s_pos_c1 = (rise && !lower) ? bm : st.s_pos;
  const bool upd = t1 > st.s_val;
  const float s_val_c2 = upd ? t1 : st.s_val;
  const int s_pos_c2 = upd ? bm : st.s_pos;
  const bool mask_long = s_val_c2 > p.th1;
  const bool s_valid_c2 = st.s_valid || (((s_val_c2 - t1) > p.ph) && mask_long);
  const bool fire_s0 = s_valid_c2 && ((float)(bm - s_pos_c2) > p.half_w1);
  if (run_s) {
    st.s_pos = in_case1 ? s_pos_c1 : (fire_s0 ? -1 : s_pos_c2);
    st.s_val = in_case1 ? s_val_c1 : (fire_s0 ? t1 : s_val_c2);
    st.s_valid = in_case1 ? st.s_valid : (s_valid_c2 && !fire_s0);
  }
  const bool fire_s = fire_s0 && !in_case1 && run_s;
  if (run_s && !in_case1 && mask_long) {  // the short detector masks the long one
    st.l_masked = s_pos_c2 + p.w1;
    st.l_pos = -1;
    st.l_val = kFltMax;
    st.l_valid = 0;
  }

  // long detector
  const bool run_l = st.l_masked < bm;
  const bool in_case1l = st.l_pos == -1;
  const bool lowerl = t2 < st.l_val;
  const bool risel = (t2 - st.l_val) > p.ph;
  const float l_val_c1 = (lowerl || risel) ? t2 : st.l_val;
  const int l_pos_c1 = (risel && !lowerl) ? bm : st.l_pos;
  const bool updl = t2 > st.l_val;
  const float l_val_c2 = updl ? t2 : st.l_val;
  const int l_pos_c2 = updl ? bm : st.l_pos;
  const bool l_valid_c2 = st.l_valid || (((l_val_c2 - t2) > p.ph) && (l_val_c2 > p.th2));
  const bool fire_l0 = l_valid_c2 && ((float)(bm - l_pos_c2) > p.half_w2);
  if (run_l) {
    st.l_pos = in_case1l ? l_pos_c1 : (fire_l0 ? -1 : l_pos_c2);
    st.l_val = in_case1l ? l_val_c1 : (fire_l0 ? t2 : l_val_c2);
    st.l_valid = in_case1l ? st.l_valid : (l_valid_c2 && !fire_l0);
  }
  const bool fire_l = fire_l0 && !in_case1l && run_l;
  return fire_s || fire_l;
}

__device__ __forceinline__ bool same_state(const PeakState& a, const PeakState& b) {
  return a.s_pos == b.s_pos && a.s_val == b.s_val && a.s_valid == b.s_valid &&
         a.l_pos == b.l_pos && a.l_val == b.l_val && a.l_valid == b.l_valid &&
         a.l_masked == b.l_masked;
}

// Samples [i0, i0 + n) of one read through the machine, kStage loads ahead;
// fires written to out (masked to i < nv) unless out is null.
__device__ __forceinline__ void run_samples(PeakState& st, const float* __restrict__ r1,
                                            const float* __restrict__ r2, int i0, int n, int w2,
                                            int nv, uint8_t* __restrict__ out,
                                            const PeakParams& p) {
  for (int j0 = 0; j0 < n; j0 += kStage) {
    float a[kStage], b[kStage];
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      const bool in = j0 + u < n;
      a[u] = in ? __ldg(r1 + i0 + j0 + u) : 0.f;
      b[u] = in ? __ldg(r2 + i0 + j0 + u) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStage; ++u) {
      if (j0 + u < n) {
        const int i = i0 + j0 + u;
        const bool f = peak_step(st, a[u], b[u], i + 1 - w2, p);
        if (out != nullptr) out[i] = (uint8_t)(f && i < nv);
      }
    }
  }
}

// grid (ceil(C / kThreads), B): thread c of read b scans block c and keeps
// its state after the warm-up (states[b, c, 0]) and at its end ([b, c, 1]).
__global__ void __launch_bounds__(kThreads) peak_scan_blocks_kernel(
    int S, int C, int w2, PeakParams p, const float* __restrict__ t1,
    const float* __restrict__ t2, const int32_t* __restrict__ n_valid,
    uint8_t* __restrict__ fired, PeakState* __restrict__ states) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (c >= C) return;
  const float* r1 = t1 + (size_t)b * S;
  const float* r2 = t2 + (size_t)b * S;
  const int nv = n_valid[b];
  const int base = c * kBlock;
  PeakState st = peak_init();
  if (c > 0) run_samples(st, r1, r2, base - kWarmup, kWarmup, w2, nv, nullptr, p);
  PeakState* mine = states + ((size_t)b * C + c) * 2;
  mine[0] = st;
  const int n = S - base < kBlock ? S - base : kBlock;
  run_samples(st, r1, r2, base, n, w2, nv, fired + (size_t)b * S, p);
  mine[1] = st;
}

// One warp per read: the exactness check, its lanes over the blocks, then
// the sequential rescan by lane 0 of a read that failed it. ok[b] = 1 when
// the blocked scan stood.
__global__ void __launch_bounds__(32) peak_scan_check_kernel(
    int S, int C, int w2, PeakParams p, const float* __restrict__ t1,
    const float* __restrict__ t2, const int32_t* __restrict__ n_valid,
    uint8_t* __restrict__ fired, const PeakState* __restrict__ states,
    uint8_t* __restrict__ ok) {
  const int b = blockIdx.x;
  const int nv = n_valid[b];
  const PeakState* st = states + (size_t)b * C * 2;
  unsigned good = 1;
  for (int c = 1 + (int)threadIdx.x; c < C && c * kBlock < nv; c += 32)
    good &= (unsigned)same_state(st[2 * c], st[2 * c - 1]);
  good = __reduce_min_sync(0xffffffffu, good);
  if (threadIdx.x != 0) return;
  ok[b] = (uint8_t)good;
  if (good) return;
  PeakState s = peak_init();
  const int n = nv < S ? nv : S;
  run_samples(s, t1 + (size_t)b * S, t2 + (size_t)b * S, 0, n, w2, nv, fired + (size_t)b * S, p);
}

PeakParams make_params(int w1, int w2, float th1, float th2, float ph) {
  PeakParams p;
  p.w1 = w1;
  p.half_w1 = (float)(w1 / 2.0);
  p.half_w2 = (float)(w2 / 2.0);
  p.th1 = th1;
  p.th2 = th2;
  p.ph = ph;
  return p;
}

}  // namespace

// t1, t2 [B, S] f32 (row-major), n_valid [B] int32, fired [B, S] uint8,
// states [B, C, 2] PeakState (7 x 4 bytes), C = ceil(S / 512).
extern "C" int rv_peak_scan_blocks(int B, int S, int w1, int w2, float th1, float th2, float ph,
                                   const void* t1, const void* t2, const void* n_valid,
                                   void* fired, void* states, void* stream) {
  if (B <= 0 || S <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  const int C = (S + kBlock - 1) / kBlock;
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  peak_scan_blocks_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      S, C, w2, make_params(w1, w2, th1, th2, ph), (const float*)t1, (const float*)t2,
      (const int32_t*)n_valid, (uint8_t*)fired, (PeakState*)states);
  return (int)cudaGetLastError();
}

// After rv_peak_scan_blocks on the same buffers; ok [B] uint8.
extern "C" int rv_peak_scan_check(int B, int S, int w1, int w2, float th1, float th2, float ph,
                                  const void* t1, const void* t2, const void* n_valid,
                                  void* fired, const void* states, void* ok, void* stream) {
  if (B <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const int C = (S + kBlock - 1) / kBlock;
  peak_scan_check_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
      S, C, w2, make_params(w1, w2, th1, th2, ph), (const float*)t1, (const float*)t2,
      (const int32_t*)n_valid, (uint8_t*)fired, (const PeakState*)states, (uint8_t*)ok);
  return (int)cudaGetLastError();
}

extern "C" int rv_peak_scan_state_bytes() { return (int)sizeof(PeakState); }
