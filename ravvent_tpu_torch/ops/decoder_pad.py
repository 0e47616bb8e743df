"""The decoder's weights and memory zero-padded to a width the decode kernels
are compiled for.

The beam step's kernels (ops/beam_step_cuda.py), the whole-loop kernel
(ops/beam_loop_cuda.py) and the fused greedy step (ops/decode_step_cuda.py)
are compiled for the decoder units 64, 128 and 256, and the greedy step for
the memory widths 64, 128, 256 and 512. Any other decoder width U up to 256
runs the next compiled width Up on weights padded with zeros, as
ops/rnn_cuda.py pads the encoders' (:func:`pad_decoder_params`, once per
engine); the greedy step's memory width E runs the next compiled one Ep on
values padded with zero columns (:func:`pad_values`, once per decode).

Why this is exact: a padded unit's weights, bias and memory columns are
zero, so its gate pre-activations are 0 and its state stays 0 (c' = 0.5 * 0
+ 0.5 * tanh(0) = 0, h' = 0.5 * tanh(0) = 0); its key and value columns are
0, so the scores, the context and the attention vector gain only +0 terms,
and a padded unit's attention vector is 0; the logits read no padded row.
int8 memory's scales do not move (a max-abs ignores zeros), nor do a padded
column's codes (0). The real units' sums run at the padded width, so they
may differ from the true width's in the order of their f32 terms.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from ravvent_tpu_torch.models import attention as attn


def on_card(t: torch.Tensor) -> bool:
    """Whether the decode of memory ``t`` runs the kernels, and so takes the
    padded route at a width they are not compiled for (a CUDA tensor). The
    CPU tests patch it, so that the padded route runs the plain versions."""
    return t.is_cuda


def padded_width(n: int, compiled: Sequence[int], what: str) -> int:
    """The smallest of the ``compiled`` widths that holds ``n``. Raises
    ValueError, naming ``what`` and the widths, past the widest."""
    for c in sorted(compiled):
        if c >= n:
            return c
    raise ValueError(f"{what} = {n} is wider than the decode kernels take (up to "
                     f"{max(compiled)}, compiled for {', '.join(map(str, sorted(compiled)))})")


def _pad(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """``t`` with zeros appended along ``dim`` up to size ``n``."""
    extra = n - t.shape[dim]
    if extra == 0:
        return t
    shape = list(t.shape)
    shape[dim] = extra
    return torch.cat([t, t.new_zeros(shape)], dim=dim)


def _pad_gates(t: torch.Tensor, U: int, Up: int) -> torch.Tensor:
    """The last dim's four gate blocks of U (keras order i, f, g, o), each
    padded with zeros to Up."""
    return torch.cat([_pad(g, Up, -1) for g in t.split(U, dim=-1)], dim=-1)


def pad_decoder_params(dec: dict, Up: int) -> dict:
    """A depth-1 LSTM decoder's parameters (the JAX tree's layout, with its
    Luong attention's ``memory_kernel``) zero-padded from U to Up units:
    the cell kernel [V+U, 4U] (the V one-hot rows, the U attention rows, then
    zero rows; each gate's columns), the recurrent kernel's rows and gates,
    the bias's gates, the output layer's rows, the attention layer [U+E, U]
    (its cell-output rows padded to Up before the E context rows; its
    columns) and the memory kernel's columns. So setup_memory makes keys and
    pre-projected values at Up, with zero columns past U. The rest of the
    tree is kept."""
    cell = dec["cells"][0]
    U = cell["recurrent"].shape[0]
    if Up == U:
        return dec
    V = cell["kernel"].shape[0] - U
    kernel = _pad_gates(cell["kernel"], U, Up)
    kernel = torch.cat([kernel[:V], _pad(kernel[V:], Up, 0)])
    att = dec["attention_layer"]["kernel"]
    att = _pad(torch.cat([_pad(att[:U], Up, 0), att[U:]]), Up, 1)
    out = dict(dec)
    out["cells"] = [{**cell, "kernel": kernel,
                     "recurrent": _pad(_pad_gates(cell["recurrent"], U, Up), Up, 0),
                     "bias": _pad_gates(cell["bias"], U, Up)}] + list(dec["cells"][1:])
    out["fc"] = {**dec["fc"], "kernel": _pad(dec["fc"]["kernel"], Up, 0)}
    out["attention_layer"] = {**dec["attention_layer"], "kernel": att}
    out["attention"] = {**dec["attention"],
                        "memory_kernel": _pad(dec["attention"]["memory_kernel"], Up, 1)}
    return out


def pad_memory_units(mem: attn.AttnMemory, Up: int) -> attn.AttnMemory:
    """A memory of U-unit keys (and pre-projected values, with ``watt_h``)
    zero-padded to Up units, as setup_memory makes it from
    :func:`pad_decoder_params`' weights; a copy of the keys and values, for
    a memory made at the true width. Un-projected values keep their width;
    int8 scales are kept."""
    U = mem.keys.shape[2]
    if Up == U:
        return mem
    watt_h = None if mem.watt_h is None else _pad(_pad(mem.watt_h, Up, 0), Up, 1)
    values = _pad(mem.values, Up, 2) if mem.projected else mem.values
    return mem._replace(keys=_pad(mem.keys, Up, 2), values=values, watt_h=watt_h)


def pad_values(values: torch.Tensor, watt: torch.Tensor, Ep: int):
    """Un-projected values [B, S, E] and the attention layer [U+E, U] whose
    last E rows read the context, padded to Ep memory columns: zero value
    columns and zero context rows. Returns (values [B, S, Ep], watt
    [U+Ep, U])."""
    E = values.shape[2]
    if Ep == E:
        return values, watt
    return F.pad(values, (0, Ep - E)), _pad(watt, watt.shape[0] + Ep - E, 0)
