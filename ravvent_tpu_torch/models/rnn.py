"""Recurrent cells and the stacked (bi)directional encoder.

Counterpart of ravvent_tpu/models/rnn.py: LSTM and GRU cells, uni- and
bidirectional layers (``rnn_type`` "bilstm", "bigru", "lstm", "gru"). Keras
semantics: LSTM gate order (i, f, g, o), unit forget bias; GRU
``reset_after=True``, gate order (z, r, h), separate input and recurrent
biases; sigmoid recurrent activation, tanh activation, glorot-uniform
kernel, orthogonal recurrent kernel. Layer i's final states seed layer i+1,
forward seeds forward and backward seeds backward. The encoder takes no
mask: padded timesteps run as zero inputs, as in the reference.

A bidirectional LSTM layer runs the BiLSTM kernel on a CUDA tensor
(ops/rnn_cuda.py), at the next compiled width where its own is not one;
GRU layers and unidirectional layers run the plain scan on any device, as
the JAX package runs ``lax.scan`` for them (its Pallas layer is the
BiLSTM's alone, models/rnn.py:330-347 there).

Parameters are nested dicts of tensors with the JAX tree's keys, per
direction: LSTM ``{"kernel": [F, 4U], "recurrent": [U, 4U], "bias": [4U]}``,
GRU ``{"kernel": [F, 3U], "recurrent": [U, 3U], "input_bias": [3U],
"recurrent_bias": [3U]}``; a unidirectional layer has only ``"fwd"``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.ops.rnn_cuda import (
    bilstm_layer, bilstm_layer_plain, kernel_layout, kernel_takes, padded_units, unpad_outputs,
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


def _stream_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` honouring a bf16 stream (the JAX package's ``_stream_mm``):
    when ``a`` is bf16, bf16 operands whose products accumulate in f32 (the
    operands upcast; a bf16 ``@`` on the CPU would round its output to
    bf16); otherwise plain f32. Returns f32."""
    if a.dtype == torch.bfloat16:
        return a.float() @ b.to(torch.bfloat16).float()
    return a @ b


def lstm_zero_state(batch: int, units: int, device=None):
    return (torch.zeros(batch, units, device=device), torch.zeros(batch, units, device=device))


def lstm_step(p: Params, carry, x: Optional[torch.Tensor], x_proj: Optional[torch.Tensor] = None):
    """One LSTM step; returns ((h, c), h). ``x_proj`` is the precomputed
    ``x @ kernel + bias`` (the hoisted projection of a layer), else it is
    computed here."""
    h, c = carry
    z = (x @ p["kernel"] + p["bias"]) if x_proj is None else x_proj
    z = z + h @ p["recurrent"]
    u = p["recurrent"].shape[0]
    i, f, g, o = z[:, :u], z[:, u:2 * u], z[:, 2 * u:3 * u], z[:, 3 * u:]
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def init_gru_cell(gen: torch.Generator, in_dim: int, units: int, device=None) -> Params:
    return {
        "kernel": glorot_uniform(gen, (in_dim, 3 * units), device),
        "recurrent": orthogonal(gen, (units, 3 * units), device),
        "input_bias": torch.zeros(3 * units, device=device),
        "recurrent_bias": torch.zeros(3 * units, device=device),
    }


def gru_zero_state(batch: int, units: int, device=None):
    return (torch.zeros(batch, units, device=device),)


def _gru_gates(mx: torch.Tensor, mi: torch.Tensor, h: torch.Tensor, u: int) -> torch.Tensor:
    """keras ``reset_after=True``: the new h from the input part ``mx`` and
    the recurrent part ``mi`` (each [..., 3U], biases in)."""
    xz, xr, xh = mx[..., :u], mx[..., u:2 * u], mx[..., 2 * u:]
    rz, rr, rh = mi[..., :u], mi[..., u:2 * u], mi[..., 2 * u:]
    z = torch.sigmoid(xz + rz)
    r = torch.sigmoid(xr + rr)
    hh = torch.tanh(xh + r * rh)
    return z * h + (1.0 - z) * hh


def gru_step(p: Params, carry, x: Optional[torch.Tensor], x_proj: Optional[torch.Tensor] = None):
    """One GRU step (keras ``reset_after=True``); returns ((h,), h)."""
    (h,) = carry
    mx = (x @ p["kernel"] + p["input_bias"]) if x_proj is None else x_proj
    mi = h @ p["recurrent"] + p["recurrent_bias"]
    h = _gru_gates(mx, mi, h, p["recurrent"].shape[0])
    return (h,), h


# cell type -> (init, step, zero state, gate count)
CELLS = {
    "lstm": (init_lstm_cell, lstm_step, lstm_zero_state, 4),
    "gru": (init_gru_cell, gru_step, gru_zero_state, 3),
}


def cell_zero_state(cell_type: str, batch: int, units: int, device=None):
    return CELLS[cell_type][2](batch, units, device)


def cell_step(cell_type: str, p: Params, carry, x, x_proj=None):
    return CELLS[cell_type][1](p, carry, x, x_proj)


def run_rnn_layer(p: Params, cell_type: str, xs: torch.Tensor, initial_state=None,
                  reverse: bool = False):
    """One unidirectional layer over time (plain PyTorch, the reference's
    ``lax.scan``), its input projection hoisted into one product over all
    timesteps; ``reverse`` runs from the last timestep, the outputs staying
    time-aligned. On a bf16 stream the projection takes bf16 operands
    (:func:`_stream_mm`) while the state and the recurrent product stay f32,
    and the outputs are rounded to bf16. Returns (outputs [B, T, U] in the
    stream dtype, final carry)."""
    _, step, zero_state, ngates = CELLS[cell_type]
    B, T, _ = xs.shape
    units = p["recurrent"].shape[0]
    carry = zero_state(B, units, xs.device) if initial_state is None else initial_state
    bias = p["bias"] if cell_type == "lstm" else p["input_bias"]
    proj = (_stream_mm(xs.reshape(B * T, -1), p["kernel"]) + bias).reshape(B, T, ngates * units)
    outs: List[Optional[torch.Tensor]] = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        carry, h = step(p, carry, None, proj[:, t])
        outs[t] = h.to(xs.dtype)
    return torch.stack(outs, dim=1), carry


def bigru_layer_plain(layer: Params, xs: torch.Tensor, h0: Optional[torch.Tensor] = None):
    """Forward + backward GRU directions of one layer (plain PyTorch, the
    reference's GRU branch of ``run_bidi_layer``): one batched recurrent
    product per step for both directions; on a bf16 stream its operands
    bf16(h) and bf16 weights, accumulated in f32, with f32 state. Returns
    (outputs [B, T, 2U] time-aligned in the stream dtype, h [2, B, U])."""
    pf, pb = layer["fwd"], layer["bwd"]
    B, T, _ = xs.shape
    U = pf["recurrent"].shape[0]
    bf16 = xs.dtype == torch.bfloat16
    x2 = xs.reshape(B * T, -1)
    proj_f = (_stream_mm(x2, pf["kernel"]) + pf["input_bias"]).reshape(B, T, 3 * U)
    proj_b = (_stream_mm(x2, pb["kernel"]) + pb["input_bias"]).reshape(B, T, 3 * U)
    R = torch.stack([pf["recurrent"], pb["recurrent"]])  # [2, U, 3U]
    if bf16:
        R = R.to(torch.bfloat16).float()
    rbias = torch.stack([pf["recurrent_bias"], pb["recurrent_bias"]])[:, None, :]
    h = torch.zeros(2, B, U, device=xs.device) if h0 is None else h0
    out_f: List[Optional[torch.Tensor]] = [None] * T
    out_b: List[Optional[torch.Tensor]] = [None] * T
    for t in range(T):
        hr = h.to(torch.bfloat16).float() if bf16 else h
        mi = torch.bmm(hr, R) + rbias
        h = _gru_gates(torch.stack([proj_f[:, t], proj_b[:, T - 1 - t]]), mi, h, U)
        out_f[t] = h[0].to(xs.dtype)
        out_b[T - 1 - t] = h[1].to(xs.dtype)
    out = torch.cat([torch.stack(out_f, dim=1), torch.stack(out_b, dim=1)], dim=-1)
    return out, h


def init_encoder(gen: torch.Generator, units: int, depth: int, in_features: int,
                 device=None, cell_type: str = "lstm", bidirectional: bool = True
                 ) -> List[Params]:
    init_cell = CELLS[cell_type][0]
    layers = []
    in_dim = in_features
    for _ in range(depth):
        layer = {"fwd": init_cell(gen, in_dim, units, device)}
        if bidirectional:
            layer["bwd"] = init_cell(gen, in_dim, units, device)
        layers.append(layer)
        in_dim = units * (2 if bidirectional else 1)
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
    once so that no layer call re-lays or pads them. A layer of an
    uncompiled width is laid out zero-padded to the next compiled one, and
    the layer after it for the padded outputs it then gets (the activations
    between the encoder's layers stay padded). Layers of other shapes than
    the kernels take (ops/rnn_cuda.py:kernel_takes, on the input they get)
    stay as they are."""
    out, fed = [], None  # fed: the units of the laid-out layer before, whose outputs come padded
    for wx, wh, b in weights:
        f_in = wx.shape[1] if fed is None else 2 * padded_units(fed)
        if kernel_takes(wh.shape[1], f_in, wx.dtype):
            out.append((wx, wh, b, kernel_layout(wx, wh, b, fed)))
            fed = wh.shape[1]
        else:
            out.append((wx, wh, b))
            fed = None
    return out


def _zero_state(xs: torch.Tensor, units: int):
    z = torch.zeros(2, xs.shape[0], units, device=xs.device, dtype=torch.float32)
    return z, z.clone()


def run_bidi_layer(layer: Params, xs: torch.Tensor, initial_state=None, cell_type: str = "lstm"):
    """Forward + backward directions of one layer (plain PyTorch). Returns
    (outputs [B, T, 2U] time-aligned, final carry: (h, c) each [2, B, U]
    for an LSTM, (h,) for a GRU)."""
    if cell_type == "gru":
        out, h = bigru_layer_plain(layer, xs, None if initial_state is None else initial_state[0])
        return out, (h,)
    U = layer["fwd"]["recurrent"].shape[0]
    h0, c0 = initial_state if initial_state is not None else _zero_state(xs, U)
    out, h, c = bilstm_layer_plain(xs, *stacked_weights(layer), h0, c0)
    return out, (h, c)


def on_card(xs: torch.Tensor) -> bool:
    """Whether a layer of ``xs`` runs where the BiLSTM kernels launch."""
    return xs.is_cuda


def encoder_apply(layers: List[Params], xs: torch.Tensor,
                  weights: Optional[List[Tuple[torch.Tensor, ...]]] = None,
                  trainable: bool = False, cell_type: str = "lstm",
                  bidirectional: bool = True) -> Tuple[torch.Tensor, Any]:
    """Stacked encoder on the stream dtype of ``xs`` (f32 or bf16; the JAX
    package's bf16 stream, models/rnn.py:314-347): every layer takes and
    returns that dtype, with f32 state.

    Bidirectional LSTM: every layer of a CUDA tensor runs the BiLSTM kernel
    (ops/rnn_cuda.py) where the kernels take its shape
    (``kernel_takes``, through :func:`kernel_weights`), else its plain
    version, counted under ``cuda_lib.launches["bilstm_plain_route"]``, as
    the reference runs its scan where the Pallas layer does not fit
    (models/rnn.py:304-311 there); a CPU tensor runs the plain version. A
    layer of an uncompiled width runs the kernel's compiled width on its
    padded weights, and its outputs and states pass to the next layer at
    that width; the encoder's outputs and final states are sliced back to
    the layers' own width once, at its end. ``weights``:
    :func:`kernel_weights` of :func:`stream_weights` of ``layers`` in the
    stream dtype, made once by the caller, or the stream weights alone,
    laid out here on each call on a card; made here when None.
    ``trainable=True`` runs every layer's plain version on any device,
    with the weights stacked from ``layers`` on each call so that autograd
    reaches them, as the reference trains through its scan because the
    Pallas layer has no VJP (ravvent_tpu/models/rnn.py:325-326).

    GRU layers (``cell_type="gru"``) and unidirectional layers
    (``bidirectional=False``) run the plain scan on any device, as the
    reference runs ``lax.scan`` for them; they take no ``weights``.

    Returns (outputs [B, T, U * directions], the last layer's final carry:
    (h, c) or (h,) stacked [2, B, U] when bidirectional, ``(carry,)`` of
    [B, U] tensors when not)."""
    out = xs.contiguous()
    if cell_type != "lstm" or not bidirectional:
        if weights is not None:
            raise ValueError("encoder_apply: only bidirectional LSTM layers take weights")
        state = None
        for layer in layers:
            if bidirectional:
                out, state = run_bidi_layer(layer, out, state, cell_type)
            else:
                out, state = run_rnn_layer(layer["fwd"], cell_type, out, state)
        return out, (state if bidirectional else (state,))
    if trainable:
        if weights is not None:
            raise ValueError("encoder_apply: trainable=True stacks its own weights")
        state = None
        for layer in layers:
            out, state = run_bidi_layer(layer, out, state)
        return out, state
    if weights is None:
        weights = stream_weights(layers, xs.dtype)
    card = on_card(out)
    if card and all(len(w) == 3 for w in weights):
        weights = kernel_weights(weights)  # laid out here, once a call
    state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    units = None  # the layers' own width while their outputs run padded
    for wx, wh, b, *layout in weights:
        lay = layout[0] if card and layout else None
        if lay is not None and lay.padded is not None:  # the padded layer the kernel runs
            wx, wh, b = lay.padded
        units = lay.units if lay is not None and lay.units < wh.shape[1] else None
        h0, c0 = state if state is not None else _zero_state(out, wh.shape[1])
        h0, c0 = h0.contiguous(), c0.contiguous()
        if card and lay is None:
            out, h, c = bilstm_layer_plain(out, wx, wh, b, h0, c0)
            cuda_lib.launches["bilstm_plain_route"] += 1
        else:
            out, h, c = bilstm_layer(out, wx, wh, b, h0, c0, *layout)
        state = (h, c)
    if units is not None:
        out, state = unpad_outputs(out, units), tuple(s[..., :units].contiguous() for s in state)
    return out, state
