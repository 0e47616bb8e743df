"""LSTM cells and the stacked bidirectional encoder.

Counterpart of ravvent_tpu/models/rnn.py, bidirectional LSTM only (the
flagship's ``rnn_type="bilstm"``). Keras semantics: gate order (i, f, g, o),
sigmoid recurrent activation, tanh activation, unit forget bias,
glorot-uniform kernel, orthogonal recurrent kernel. Layer i's final states
seed layer i+1, forward seeds forward and backward seeds backward. The
encoder takes no mask: padded timesteps run as zero inputs, as in the
reference.

Parameters are nested dicts of tensors with the JAX tree's keys:
``{"kernel": [F, 4U], "recurrent": [U, 4U], "bias": [4U]}`` per direction.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ravvent_tpu_torch.ops.rnn_cuda import (
    UNITS, bilstm_layer, bilstm_layer_plain, kernel_layout,
)

Params = Dict[str, Any]


def glorot_uniform(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    limit = math.sqrt(6.0 / (shape[0] + shape[1]))
    u = torch.rand(shape, generator=gen, dtype=torch.float32)
    return ((2.0 * u - 1.0) * limit).to(device)


def orthogonal(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    """Orthogonal init as jax.nn.initializers.orthogonal draws it: QR of a
    normal matrix with the sign of R's diagonal folded in."""
    rows, cols = shape
    a = torch.randn((max(rows, cols), min(rows, cols)), generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.T
    return q.to(torch.float32).to(device)


def init_dense(gen: torch.Generator, in_dim: int, out_dim: int, use_bias: bool = True,
               device=None) -> Params:
    p = {"kernel": glorot_uniform(gen, (in_dim, out_dim), device)}
    if use_bias:
        p["bias"] = torch.zeros(out_dim, device=device)
    return p


def dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["kernel"]
    if "bias" in p:
        y = y + p["bias"]
    return y


def init_lstm_cell(gen: torch.Generator, in_dim: int, units: int, device=None) -> Params:
    bias = torch.zeros(4 * units, device=device)
    bias[units:2 * units] = 1.0  # unit_forget_bias
    return {
        "kernel": glorot_uniform(gen, (in_dim, 4 * units), device),
        "recurrent": orthogonal(gen, (units, 4 * units), device),
        "bias": bias,
    }


def lstm_step(p: Params, carry, x: torch.Tensor):
    """One LSTM step; returns ((h, c), h)."""
    h, c = carry
    z = x @ p["kernel"] + p["bias"] + h @ p["recurrent"]
    u = p["recurrent"].shape[0]
    i, f, g, o = z[:, :u], z[:, u:2 * u], z[:, 2 * u:3 * u], z[:, 3 * u:]
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def init_encoder(gen: torch.Generator, units: int, depth: int, in_features: int,
                 device=None) -> List[Params]:
    layers = []
    in_dim = in_features
    for _ in range(depth):
        layers.append({"fwd": init_lstm_cell(gen, in_dim, units, device),
                       "bwd": init_lstm_cell(gen, in_dim, units, device)})
        in_dim = 2 * units
    return layers


def stacked_weights(layer: Params):
    """(wx [2, F, 4U], wh [2, U, 4U], b [2, 4U]) of a layer, forward first."""
    pf, pb = layer["fwd"], layer["bwd"]
    return (torch.stack([pf["kernel"], pb["kernel"]]),
            torch.stack([pf["recurrent"], pb["recurrent"]]),
            torch.stack([pf["bias"], pb["bias"]]))


def stream_weights(layers: List[Params], dtype=torch.float32) -> List[Tuple[torch.Tensor, ...]]:
    """Per layer (wx, wh, b) as the BiLSTM kernels take them: wx and wh in
    the stream dtype (the TPU kernel casts its weights to the stream dtype,
    ravvent_tpu/ops/rnn_pallas.py:166-172), b f32."""
    return [(wx.to(dtype), wh.to(dtype), b) for wx, wh, b in map(stacked_weights, layers)]


def kernel_weights(weights: List[Tuple[torch.Tensor, ...]]) -> List[Tuple[Any, ...]]:
    """:func:`stream_weights` with each layer's weights in its stream's
    kernel layout (ops/rnn_cuda.py:kernel_layout) as a fourth item, made
    once so that no layer call re-lays them out. Layers of other widths
    than the kernels' (which they do not take) stay as they are."""
    return [(wx, wh, b, kernel_layout(wx, wh)) if wh.shape[1] == UNITS else (wx, wh, b)
            for wx, wh, b in weights]


def _zero_state(xs: torch.Tensor, units: int):
    z = torch.zeros(2, xs.shape[0], units, device=xs.device, dtype=torch.float32)
    return z, z.clone()


def run_bidi_layer(layer: Params, xs: torch.Tensor, initial_state=None):
    """Forward + backward directions of one layer (plain PyTorch). Returns
    (outputs [B, T, 2U] time-aligned, (h, c) each [2, B, U])."""
    U = layer["fwd"]["recurrent"].shape[0]
    h0, c0 = initial_state if initial_state is not None else _zero_state(xs, U)
    out, h, c = bilstm_layer_plain(xs, *stacked_weights(layer), h0, c0)
    return out, (h, c)


def encoder_apply(layers: List[Params], xs: torch.Tensor,
                  weights: Optional[List[Tuple[torch.Tensor, ...]]] = None,
                  trainable: bool = False) -> Tuple[torch.Tensor, Any]:
    """Stacked bidirectional encoder on the stream dtype of ``xs`` (f32 or
    bf16; the JAX package's bf16 stream, models/rnn.py:314-347): every layer
    takes and returns that dtype, with f32 state. Every layer of a CUDA
    tensor runs the BiLSTM kernel (ops/rnn_cuda.py); a CPU tensor runs its
    plain version. ``weights``: :func:`stream_weights` of ``layers`` in the
    stream dtype, or :func:`kernel_weights` of them, made once by the
    caller; made here when None.
    ``trainable=True`` runs every layer's plain version on any device, with
    the weights stacked from ``layers`` on each call so that autograd
    reaches them, as the reference trains through its scan because the
    Pallas layer has no VJP (ravvent_tpu/models/rnn.py:325-326).
    Returns (outputs [B, T, 2U], final (h, c) of the last layer)."""
    out = xs.contiguous()
    if trainable:
        if weights is not None:
            raise ValueError("encoder_apply: trainable=True stacks its own weights")
        state = None
        for layer in layers:
            out, state = run_bidi_layer(layer, out, state)
        return out, state
    if weights is None:
        weights = stream_weights(layers, xs.dtype)
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    for wx, wh, b, *layout in weights:
        h0, c0 = state if state is not None else _zero_state(out, wh.shape[1])
        out, h, c = bilstm_layer(out, wx, wh, b, h0.contiguous(), c0.contiguous(), *layout)
        state = (h, c)
    return out, state
