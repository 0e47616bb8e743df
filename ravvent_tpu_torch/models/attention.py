"""Luong and Bahdanau attention (counterpart of
ravvent_tpu/models/attention.py).

Luong: ``score = q . keys``; Bahdanau (tfa's non-normalized form): ``score =
sum(v * tanh(q @ W_q + keys))``, in f32 over the keys upcast.
``setup_memory`` zeroes the memory at masked positions, computes the keys
``values @ memory_kernel`` (no bias, for both) and, given the
AttentionWrapper's attention layer, pre-projects the values through its
context half ``kernel[U:]`` (the attention vector is then ``att = query @
watt_h + align @ values`` with ``watt_h = kernel[:U]``).
``dtype=torch.bfloat16`` stores keys and values in bf16; the dots that read
them accumulate in f32. ``dtype="i8"`` stores int8 codes with per-(row,
position) max-abs scales (``kscale``, ``vscale``), which only the beam step
consumes (ops/beam_step_cuda.py). Scores are masked with
``finfo(float32).min``, not ``-inf``, so an all-masked row softmaxes to a
uniform row, as in the reference.

On a ``('data', 'model')`` grid of training ranks each rank of a model row
holds a slice of the memory's positions (parallel/mesh.py:memory_sharding,
the counterpart of the JAX trainer's sequence sharding) and
:func:`attend_beams` takes the row's ``model_axis``
(parallel/distributed.py:Axis): the query enters the sharded region, the
scores' max is a MAX across the row (detached: the softmax does not change
under a shift), and the exp-sum and the context's partial sums leave it in
one SUM. Nothing is padded, so an all-masked row stays uniform over the
real positions.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch

from ravvent_tpu_torch.models.rnn import glorot_uniform

Params = Dict[str, Any]

NEG_INF = float(torch.finfo(torch.float32).min)


class AttnMemory(NamedTuple):
    keys: torch.Tensor  # [B, S, U]
    values: torch.Tensor  # [B, S, E], or pre-projected [B, S, U]
    mask: torch.Tensor  # [B, S] bool
    watt_h: Optional[torch.Tensor] = None  # [U, U] when the values are pre-projected
    # int8 memory: keys[b, s] * kscale[b, s] dequantizes a key row (values
    # alike); the consumer folds the scales into the scores and alignments
    kscale: Optional[torch.Tensor] = None  # [B, S] f32
    vscale: Optional[torch.Tensor] = None  # [B, S] f32

    @property
    def projected(self) -> bool:
        return self.watt_h is not None

    @property
    def quantized(self) -> bool:
        return self.kscale is not None

    def to(self, device) -> "AttnMemory":
        return AttnMemory(*(None if t is None else t.to(device) for t in self))


def init_attention(gen: torch.Generator, units: int, memory_dim: int, device=None,
                   attention_type: str = "luong", query_dim: Optional[int] = None) -> Params:
    """tfa LuongAttention: memory_layer Dense(units, use_bias=False);
    BahdanauAttention adds query_layer Dense(units, use_bias=False) over the
    query (``query_dim``, default ``units``) and the score vector v."""
    p = {"memory_kernel": glorot_uniform(gen, (memory_dim, units), device)}
    if attention_type == "luong":
        return p
    if attention_type != "bahdanau":
        raise ValueError(f"unknown attention_type {attention_type!r}")
    limit = math.sqrt(6.0 / (units + units))
    p["query_kernel"] = glorot_uniform(gen, (query_dim or units, units), device)
    u = torch.rand(units, generator=gen, dtype=torch.float32)
    p["attention_v"] = ((2.0 * u - 1.0) * limit).to(device)
    return p


def quantize_rows(x: torch.Tensor):
    """int8 codes and f32 scales [..., S] of x [..., S, U], per (row,
    position) max-abs, as the reference quantizes (attention.py:107-117), in
    x's dtype: scale = max(max|x|, 1e-12) / 127, codes = clip(round(x /
    scale)), true divisions (not products with a reciprocal, which torch
    takes for a Python-scalar divisor on the card) and rounding half to
    even."""
    div = torch.full((), 127.0, device=x.device)  # a 0-dim tensor keeps x's dtype
    scale = torch.clamp(x.abs().amax(dim=-1), min=1e-12) / div
    q = torch.clamp(torch.round(x / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def setup_memory(params: Params, memory: torch.Tensor, mask: torch.Tensor, dtype=None,
                 attention_layer: Optional[Params] = None) -> AttnMemory:
    """memory [B, S, E] (f32, or a bf16 encoder stream), mask [B, S] bool. A
    bf16 memory is upcast before the products, which is what the reference's
    ``bf16 @ f32`` promotes to (ravvent_tpu/models/attention.py:99-105).
    ``dtype``: None (f32), a torch dtype, or "i8" (int8 codes and scales)."""
    in_dtype = memory.dtype
    memory = memory.float()
    values = torch.where(mask[..., None], memory, torch.zeros((), device=memory.device))
    keys = values @ params["memory_kernel"]
    watt_h = None
    if attention_layer is not None:
        U = keys.shape[-1]
        kernel = attention_layer["kernel"]  # [U + E, U]
        watt_h = kernel[:U]
        values = values @ kernel[U:]
    if isinstance(dtype, str):
        if dtype != "i8":
            raise ValueError(f"dtype must be a torch dtype, None or 'i8', got {dtype!r}")
        keys, kscale = quantize_rows(keys)
        # un-projected values keep the memory's dtype in the reference, which
        # quantizes them in it (bf16 arithmetic for a bf16 stream)
        values, vscale = quantize_rows(values if watt_h is not None else values.to(in_dtype))
        return AttnMemory(keys=keys, values=values, mask=mask, watt_h=watt_h, kscale=kscale,
                          vscale=vscale)
    if dtype is not None:
        keys = keys.to(dtype)
        values = values.to(dtype)
    return AttnMemory(keys=keys, values=values, mask=mask, watt_h=watt_h)


def attend_beams(params: Params, attention_type: str, query: torch.Tensor, mem: AttnMemory,
                 model_axis=None):
    """Beam-batched attention: query [B, W, U] against untiled memory.
    Luong rounds the query to the keys' dtype before its dot, which
    accumulates in f32. Bahdanau computes ``v . tanh(query @ W_q + keys)``
    in f32 over the keys upcast ([B, W, S, U] at once). The alignments are
    rounded to the values' dtype before the context's dot. Returns (context
    [B, W, E], alignments [B, W, S]). Quantized memory is the beam step's
    alone. With ``model_axis`` (the module's docstring) ``mem`` is this
    rank's f32 slice of the memory, ``params`` have entered the region
    (models/basecaller.py:shard_attention) and the alignments returned are
    the slice's."""
    if mem.quantized:
        raise ValueError("int8 memory is consumed only by the beam step (beam_step_decode)")
    if model_axis is not None:
        if mem.values.dtype != torch.float32:
            raise ValueError("a memory sharded over the model axis is f32 (training's)")
        query = model_axis.enter(query)
    if attention_type == "luong":
        q = query.to(mem.keys.dtype).float()
        scores = torch.bmm(q, mem.keys.float().transpose(1, 2))
    elif attention_type == "bahdanau":
        q = query @ params["query_kernel"]  # [B, W, U]
        scores = torch.tanh(q[:, :, None, :] + mem.keys.float()[:, None]) @ params["attention_v"]
    else:
        raise ValueError(f"unknown attention_type {attention_type!r}")
    scores = torch.where(mem.mask[:, None, :], scores, torch.full((), NEG_INF, device=q.device))
    if model_axis is not None:
        m = model_axis.all_reduce(scores.detach().amax(dim=2, keepdim=True), "max")
        e = torch.exp(scores - m)
        # [B, W, 1 + E]: the exp-sum and the context's partials in one sum
        total = model_axis.leave(torch.cat([e.sum(dim=2, keepdim=True),
                                            torch.bmm(e, mem.values)], dim=2))
        denom = total[..., :1]
        return total[..., 1:] / denom, e / denom
    m = scores.max(dim=2, keepdim=True).values
    e = torch.exp(scores - m)
    align = e / e.sum(dim=2, keepdim=True)
    context = torch.bmm(align.to(mem.values.dtype).float(), mem.values.float())
    return context, align
