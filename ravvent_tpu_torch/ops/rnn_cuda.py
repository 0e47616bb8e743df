"""One bidirectional LSTM layer: the CUDA kernel and its plain version.

Counterpart of ravvent_tpu/ops/rnn_pallas.py (the TPU kernel
``_bilstm_kernel``, entry point ``run_bidi_lstm_pallas``). The kernel is
``csrc/bilstm.cu``; :func:`bilstm_layer` launches it for CUDA tensors and
runs :func:`bilstm_layer_plain` for CPU tensors only.

Layouts (batch-major, as the model passes them):
  xs [B, T, F] f32; wx [2, F, 4U], wh [2, U, 4U], b [2, 4U] (forward, backward);
  h0, c0 [2, B, U]. Returns (out [B, T, 2U] time-aligned — forward units
  first —, h [2, B, U], c [2, B, U]).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ravvent_tpu_torch.ops import cuda_lib

UNITS = 128  # the kernel's compiled unit count


def bilstm_layer_plain(xs, wx, wh, b, h0, c0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the reference scan (models/rnn.py:run_bidi_layer
    in the JAX package): the input projection hoisted out of the time loop,
    one batched recurrent product per step for both directions."""
    B, T, F = xs.shape
    U = wh.shape[1]
    x2 = xs.reshape(B * T, F)
    proj_f = (x2 @ wx[0] + b[0]).reshape(B, T, 4 * U)
    proj_b = (x2 @ wx[1] + b[1]).reshape(B, T, 4 * U)
    h, c = h0, c0
    out = xs.new_empty(B, T, 2 * U)
    for t in range(T):
        z = torch.stack([proj_f[:, t], proj_b[:, T - 1 - t]]) + torch.bmm(h, wh)
        i, f, g, o = z.split(U, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t, :U] = h[0]
        out[:, T - 1 - t, U:] = h[1]
    return out, h, c


def bilstm_layer(xs, wx, wh, b, h0, c0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BiLSTM layer: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not xs.is_cuda:
        return bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    B, T, F = xs.shape
    U = wh.shape[1]
    if U != UNITS:
        raise ValueError(f"bilstm kernel is compiled for {UNITS} units, got {U}")
    f32 = torch.float32
    cuda_lib.check_tensors("bilstm", xs.device, [
        ("xs", xs, f32, (B, T, F)), ("wx", wx, f32, (2, F, 4 * U)), ("wh", wh, f32, (2, U, 4 * U)),
        ("b", b, f32, (2, 4 * U)), ("h0", h0, f32, (2, B, U)), ("c0", c0, f32, (2, B, U)),
    ])
    out = torch.empty(B, T, 2 * U, device=xs.device, dtype=torch.float32)
    hN = torch.empty(2, B, U, device=xs.device, dtype=torch.float32)
    cN = torch.empty_like(hN)
    stream = torch.cuda.current_stream(xs.device).cuda_stream
    rc = cuda_lib.lib().rv_bilstm_layer(
        xs.data_ptr(), B, T, F, wx.data_ptr(), wh.data_ptr(), b.data_ptr(),
        h0.data_ptr(), c0.data_ptr(), out.data_ptr(), hN.data_ptr(), cN.data_ptr(), stream,
    )
    cuda_lib.check(rc, "bilstm")
    cuda_lib.launches["bilstm"] += 1
    return out, hN, cN
