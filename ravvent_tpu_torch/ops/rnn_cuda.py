"""One bidirectional LSTM layer: the CUDA kernels and their plain version.

Counterpart of ravvent_tpu/ops/rnn_pallas.py (the TPU kernel
``_bilstm_kernel``, entry point ``run_bidi_lstm_pallas``). The stream dtype
is the input's: an f32 stream runs ``csrc/bilstm.cu``, a bf16 stream
``csrc/bilstm_bf16.cu`` (bf16 x, Wx and Wh, f32 bias, state and
accumulation, bf16 outputs, as the TPU kernel runs it when its input is
bf16). :func:`bilstm_layer` launches the kernel for CUDA tensors and runs
:func:`bilstm_layer_plain` for CPU tensors only.

Layouts (batch-major, as the model passes them):
  xs [B, T, F] in the stream dtype; wx [2, F, 4U], wh [2, U, 4U] in the
  stream dtype, b [2, 4U] f32 (forward, backward); h0, c0 [2, B, U] f32.
  Returns (out [B, T, 2U] in the stream dtype, time-aligned — forward units
  first —, h [2, B, U] f32, c [2, B, U] f32).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ravvent_tpu_torch.ops import cuda_lib

UNITS = 128  # the kernels' compiled unit count
STREAMS = (torch.float32, torch.bfloat16)


def bilstm_layer_plain(xs, wx, wh, b, h0, c0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the reference scan (models/rnn.py:run_bidi_layer
    in the JAX package): the input projection hoisted out of the time loop,
    one batched recurrent product per step for both directions. On a bf16
    stream the products take bf16 operands (x, the weights and bf16(h))
    upcast to f32, so they accumulate in f32 as the kernels do; a bf16
    ``@`` on the CPU would round its output to bf16."""
    B, T, F = xs.shape
    U = wh.shape[1]
    bf16 = xs.dtype == torch.bfloat16
    x2 = xs.reshape(B * T, F).float()
    wx, wh = wx.float(), wh.float()
    proj_f = (x2 @ wx[0] + b[0]).reshape(B, T, 4 * U)
    proj_b = (x2 @ wx[1] + b[1]).reshape(B, T, 4 * U)
    h, c = h0, c0
    out = xs.new_empty(B, T, 2 * U)
    for t in range(T):
        hr = h.to(torch.bfloat16).float() if bf16 else h
        z = torch.stack([proj_f[:, t], proj_b[:, T - 1 - t]]) + torch.bmm(hr, wh)
        i, f, g, o = z.split(U, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t, :U] = h[0]
        out[:, T - 1 - t, U:] = h[1]
    return out, h, c


def bilstm_layer(xs, wx, wh, b, h0, c0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BiLSTM layer: the CUDA kernel of the stream dtype for CUDA tensors,
    the plain version for CPU tensors."""
    if not xs.is_cuda:
        return bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    B, T, F = xs.shape
    U = wh.shape[1]
    if U != UNITS:
        raise ValueError(f"bilstm kernel is compiled for {UNITS} units, got {U}")
    dt, f32 = xs.dtype, torch.float32
    if dt not in STREAMS:
        raise ValueError(f"bilstm: the stream must be f32 or bf16, got {dt}")
    cuda_lib.check_tensors("bilstm", xs.device, [
        ("xs", xs, dt, (B, T, F)), ("wx", wx, dt, (2, F, 4 * U)), ("wh", wh, dt, (2, U, 4 * U)),
        ("b", b, f32, (2, 4 * U)), ("h0", h0, f32, (2, B, U)), ("c0", c0, f32, (2, B, U)),
    ])
    out = torch.empty(B, T, 2 * U, device=xs.device, dtype=dt)
    hN = torch.empty(2, B, U, device=xs.device, dtype=f32)
    cN = torch.empty_like(hN)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    if dt == f32:
        rc = cuda_lib.lib().rv_bilstm_layer(
            xs.data_ptr(), B, T, F, wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out.data_ptr(), hN.data_ptr(), cN.data_ptr(), stream,
        )
        name = "bilstm"
    else:
        # the kernel reads the weights gate-column-major (an mma B fragment
        # is then one 32-bit load), Wx zero-padded to a multiple of 16 rows
        Kx = -(-F // 16) * 16
        wxT = torch.nn.functional.pad(wx.transpose(1, 2), (0, Kx - F)).contiguous()
        whT = wh.transpose(1, 2).contiguous()
        rc = cuda_lib.lib().rv_bilstm_layer_bf16(
            xs.data_ptr(), B, T, F, Kx, wxT.data_ptr(), whT.data_ptr(), b.data_ptr(),
            h0.data_ptr(), c0.data_ptr(), out.data_ptr(), hN.data_ptr(), cN.data_ptr(), stream,
        )
        name = "bilstm_bf16"
    cuda_lib.check(rc, name)
    cuda_lib.launches[name] += 1
    return out, hN, cN
