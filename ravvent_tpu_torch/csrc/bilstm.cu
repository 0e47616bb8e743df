// One bidirectional LSTM layer, the whole time loop in one launch.
//
// Replaces the TPU kernel ravvent_tpu/ops/rnn_pallas.py::_bilstm_kernel
// (entry point run_bidi_lstm_pallas). Same math as that kernel and as the
// scan path models/rnn.py::run_bidi_layer: keras LSTMCell, gates i,f,g,o,
// z = x.Wx + h.Wh + b, sigmoid/tanh, f32 state. The forward direction runs
// t = 0..T-1, the backward direction t = T-1..0; outputs are time-aligned.
//
// What bounds it on the H100: the f32 recurrent product. Per step and row it
// does 2*(F+U)*4U flops, which is not on the tensor cores in f32 (67 TFLOP/s
// peak); the bytes (x read once, outputs written once) are far below that.
// Design: the TPU kernel carries (h, c) across a sequential grid axis; here
// one CTA per (direction, tile of BT batch rows) loops over T itself and keeps
// c in registers and h in shared memory for the whole sequence. Wx and Wh for
// one direction are (F+U) x 512 x 4 B, up to 768 KiB: more than a block's
// shared memory, so this first version reads them each step through L1/L2
// (every weight is read once per step per CTA, by coalesced 128-byte rows).
// Each thread owns one unit u and half of the tile's rows, and accumulates
// all four gates of its (u, row) pairs, so no gate exchange is needed.
//
// Plain C interface, no PyTorch header: built with nvcc into a shared
// library and bound with ctypes (ravvent_tpu_torch/ops/cuda_lib.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kU = 128;          // LSTM units (the flagship's; the wrapper checks)
constexpr int kG = 4 * kU;       // gate columns
constexpr int kBT = 16;          // batch rows per CTA
constexpr int kThreads = 256;    // two row halves x kU units
constexpr int kRH = kBT / 2;     // rows per thread

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

__global__ void __launch_bounds__(kThreads)
bilstm_kernel(const float* __restrict__ xs,    // [B, T, F]
              int B, int T, int F,
              const float* __restrict__ wx,    // [2, F, 4U]
              const float* __restrict__ wh,    // [2, U, 4U]
              const float* __restrict__ bias,  // [2, 4U]
              const float* __restrict__ h0,    // [2, B, U]
              const float* __restrict__ c0,    // [2, B, U]
              float* __restrict__ out,         // [B, T, 2U]
              float* __restrict__ hN,          // [2, B, U]
              float* __restrict__ cN) {        // [2, B, U]
  extern __shared__ float smem[];
  float* xT = smem;             // [F][kBT]  x_t of the tile, transposed
  float* hT = smem + F * kBT;   // [U][kBT]  h_{t-1} of the tile, transposed

  const int d = blockIdx.y;                 // 0 forward, 1 backward
  const int b0 = blockIdx.x * kBT;
  const int tid = threadIdx.x;
  const int u = tid & (kU - 1);
  const int r0 = (tid >> 7) * kRH;          // first tile row of this thread

  const float* Wx = wx + (size_t)d * F * kG;
  const float* Wh = wh + (size_t)d * kU * kG;
  const float* bd = bias + d * kG;
  const float bi = bd[u], bf = bd[kU + u], bg = bd[2 * kU + u], bo = bd[3 * kU + u];

  float c[kRH];
#pragma unroll
  for (int r = 0; r < kRH; ++r) {
    const int row = b0 + r0 + r;
    const size_t s = ((size_t)d * B + row) * kU + u;
    c[r] = row < B ? c0[s] : 0.f;
    hT[u * kBT + r0 + r] = row < B ? h0[s] : 0.f;
  }

  for (int step = 0; step < T; ++step) {
    const int t = d == 0 ? step : T - 1 - step;
    for (int i = tid; i < kBT * F; i += kThreads) {
      const int r = i / F, k = i - r * F;
      const int row = b0 + r;
      xT[k * kBT + r] = row < B ? xs[((size_t)row * T + t) * F + k] : 0.f;
    }
    __syncthreads();

    float acc[4][kRH];
#pragma unroll
    for (int r = 0; r < kRH; ++r) {
      acc[0][r] = bi; acc[1][r] = bf; acc[2][r] = bg; acc[3][r] = bo;
    }
    for (int k = 0; k < F; ++k) {
      const float* w = Wx + (size_t)k * kG + u;
      const float w0 = __ldg(w), w1 = __ldg(w + kU), w2 = __ldg(w + 2 * kU), w3 = __ldg(w + 3 * kU);
      const float* xr = xT + k * kBT + r0;
#pragma unroll
      for (int r = 0; r < kRH; ++r) {
        const float xv = xr[r];
        acc[0][r] = fmaf(xv, w0, acc[0][r]);
        acc[1][r] = fmaf(xv, w1, acc[1][r]);
        acc[2][r] = fmaf(xv, w2, acc[2][r]);
        acc[3][r] = fmaf(xv, w3, acc[3][r]);
      }
    }
#pragma unroll 4
    for (int k = 0; k < kU; ++k) {
      const float* w = Wh + (size_t)k * kG + u;
      const float w0 = __ldg(w), w1 = __ldg(w + kU), w2 = __ldg(w + 2 * kU), w3 = __ldg(w + 3 * kU);
      const float* hr = hT + k * kBT + r0;
#pragma unroll
      for (int r = 0; r < kRH; ++r) {
        const float hv = hr[r];
        acc[0][r] = fmaf(hv, w0, acc[0][r]);
        acc[1][r] = fmaf(hv, w1, acc[1][r]);
        acc[2][r] = fmaf(hv, w2, acc[2][r]);
        acc[3][r] = fmaf(hv, w3, acc[3][r]);
      }
    }
    __syncthreads();  // every read of hT and xT for this step is done

#pragma unroll
    for (int r = 0; r < kRH; ++r) {
      const float ig = sigmoid_f(acc[0][r]);
      const float fg = sigmoid_f(acc[1][r]);
      const float gg = tanhf(acc[2][r]);
      const float og = sigmoid_f(acc[3][r]);
      c[r] = fg * c[r] + ig * gg;
      const float h = og * tanhf(c[r]);
      hT[u * kBT + r0 + r] = h;
      const int row = b0 + r0 + r;
      if (row < B) out[((size_t)row * T + t) * (2 * kU) + d * kU + u] = h;
    }
  }

#pragma unroll
  for (int r = 0; r < kRH; ++r) {
    const int row = b0 + r0 + r;
    if (row < B) {
      const size_t s = ((size_t)d * B + row) * kU + u;
      hN[s] = hT[u * kBT + r0 + r];
      cN[s] = c[r];
    }
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int rv_bilstm_layer(const float* xs, int B, int T, int F,
                               const float* wx, const float* wh, const float* bias,
                               const float* h0, const float* c0,
                               float* out, float* hN, float* cN, void* stream) {
  if (B <= 0 || T <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(F + kU) * kBT * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(bilstm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((B + kBT - 1) / kBT, 2);
  bilstm_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(xs, B, T, F, wx, wh, bias, h0, c0,
                                                                out, hN, cN);
  return (int)cudaGetLastError();
}
