"""Attention-wrapped stacked RNN decoder (counterpart of ravvent_tpu/models/decoder.py).

tfa AttentionWrapper step semantics, Luong or Bahdanau attention, LSTM or
GRU cells at any depth:
1. cell input = concat([one-hot token, previous attention vector]);
2. the stacked cells run (cell i's output feeds cell i+1);
3. the top cell output is the attention query;
4. attention vector = Dense_{no bias}([cell output; context]), or
   ``query @ watt_h + context`` on pre-projected memory;
5. logits = Dense(vocab) of the attention vector.

The parameter layout is the JAX tree's: ``cells`` (list of cells, the first
with ``kernel`` [V+U, G*U], G = 4 for an LSTM and 3 for a GRU),
``attention`` (``memory_kernel``; Bahdanau adds ``query_kernel`` and
``attention_v``), ``attention_layer`` (``kernel`` [U+E, U]) and ``fc``
(``kernel``, ``bias``). A cell's carry is (h, c) for an LSTM and (h,) for a
GRU.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.rnn import CELLS, cell_step, cell_zero_state, dense, init_dense

Params = Dict[str, Any]


class DecoderState(NamedTuple):
    cells: Tuple  # per cell: its carry, (h, c) or (h,)
    attention: torch.Tensor  # [B, dec_units]


def init_decoder(gen: torch.Generator, vocab_size: int, depth: int, dec_units: int,
                 memory_dim: int, device=None, attention_type: str = "luong",
                 cell_type: str = "lstm") -> Params:
    init_cell = CELLS[cell_type][0]
    cells = []
    in_dim = vocab_size + dec_units  # one-hot token + attention vector
    for _ in range(depth):
        cells.append(init_cell(gen, in_dim, dec_units, device))
        in_dim = dec_units
    return {
        "cells": cells,
        "attention": attn.init_attention(gen, dec_units, memory_dim, device, attention_type,
                                         dec_units),
        "attention_layer": init_dense(gen, dec_units + memory_dim, dec_units, use_bias=False,
                                      device=device),
        "fc": init_dense(gen, dec_units, vocab_size, use_bias=True, device=device),
    }


def zero_state(params: Params, batch: int, dec_units: int, cell_type: str = "lstm",
               device=None) -> DecoderState:
    cells = tuple(cell_zero_state(cell_type, batch, dec_units, device) for _ in params["cells"])
    return DecoderState(cells=cells, attention=torch.zeros(batch, dec_units, device=device))


def embed(token_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """One-hot embedding; ids outside [0, vocab) embed to zeros."""
    cols = torch.arange(vocab_size, device=token_ids.device)
    return (token_ids[..., None] == cols).to(torch.float32)


def cells_apply(params: Params, cells_state: Tuple, x: torch.Tensor, cell_type: str = "lstm"):
    """Run the stacked cells; returns (new cells state, top output)."""
    new_cells = []
    for cell_p, carry in zip(params["cells"], cells_state):
        carry, x = cell_step(cell_type, cell_p, carry, x)
        new_cells.append(carry)
    return tuple(new_cells), x


def output_block(params: Params, query: torch.Tensor, context: torch.Tensor):
    """AttentionWrapper tail on un-projected memory: (attention vector, logits)."""
    attention_vec = dense(params["attention_layer"], torch.cat([query, context], dim=-1))
    return attention_vec, dense(params["fc"], attention_vec)


def decoder_step(params: Params, state: DecoderState, token_emb: torch.Tensor,
                 mem: attn.AttnMemory, beams: int = 1, attention_type: str = "luong",
                 cell_type: str = "lstm", model_axis=None):
    """One decode step for B*beams hypotheses (beam-major within each batch
    row) against memory of B rows, read once for all of a row's beams.
    Returns (new_state, logits [B*beams, V], alignments [B, beams, S]).
    ``model_axis``: ``mem`` is this rank's slice of the positions, the
    attention reduces across the axis (models/attention.py)."""
    x = torch.cat([token_emb, state.attention], dim=-1)
    new_cells, query = cells_apply(params, state.cells, x, cell_type)
    B = mem.mask.shape[0]
    context, align = attn.attend_beams(params["attention"], attention_type,
                                       query.reshape(B, beams, -1), mem, model_axis)
    context = context.reshape(B * beams, -1)
    if mem.projected:
        attention_vec = query @ mem.watt_h + context
        logits = dense(params["fc"], attention_vec)
    else:
        attention_vec, logits = output_block(params, query, context)
    return DecoderState(cells=new_cells, attention=attention_vec), logits, align


def scheduled_draws(gen: torch.Generator, T: int, B: int, vocab_size: int,
                    sampling_probability: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scheduled sampling's draws for T steps of B rows from ``gen``:
    (select [T, B] bool, gumbel [T, B, V] f32), select first. A
    data-parallel rank draws the global batch's and keeps its rows, so that
    it draws what one process draws."""
    select = torch.rand((T, B), generator=gen, device=device) < sampling_probability
    u = torch.rand((T, B, vocab_size), generator=gen, device=device)
    return select, -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def teacher_forced_decode(params: Params, dec_inputs: torch.Tensor, mem: attn.AttnMemory,
                          vocab_size: int, sampling_probability: float = 0.0,
                          gen: Optional[torch.Generator] = None,
                          draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                          attention_type: str = "luong", cell_type: str = "lstm",
                          model_axis=None):
    """Decode with (scheduled) teacher forcing (counterpart of the JAX
    package's models/decoder.py:teacher_forced_decode).

    ``dec_inputs`` [B, T] are the targets without their last column; ``mem``
    is un-projected. Returns (logits [B, T, V], sample_ids [B, T] int64).
    With ``sampling_probability == 0`` (tfa's TrainingSampler) sample_ids is
    the argmax and every next input is the ground truth. Otherwise
    (ScheduledEmbeddingTrainingSampler) each step selects rows with
    probability p, samples ``argmax(logits + gumbel)`` (what
    ``jax.random.categorical`` computes), emits the sample where selected
    and -1 elsewhere, and feeds the sample's one-hot to the selected rows.
    The draws come from ``gen`` on the inputs' device, or from ``draws =
    (select [T, B] bool, gumbel [T, B, V] f32)``; a generator's stream
    differs from jax.random's for the same seed. ``model_axis``: see
    :func:`decoder_step`."""
    B, T = dec_inputs.shape
    dev = dec_inputs.device
    state = zero_state(params, B, params["fc"]["kernel"].shape[0], cell_type, dev)
    inputs_emb = embed(dec_inputs, vocab_size)  # [B, T, V]
    scheduled = sampling_probability > 0.0
    if scheduled:
        if draws is None:
            if gen is None:
                raise ValueError("scheduled sampling needs a generator or draws")
            select, gumbel = scheduled_draws(gen, T, B, vocab_size, sampling_probability, dev)
        else:
            select, gumbel = (d.to(dev) for d in draws)
    cur = inputs_emb[:, 0]
    logits_t, ids_t = [], []
    for t in range(T):
        state, logits, _ = decoder_step(params, state, cur, mem, 1, attention_type, cell_type,
                                        model_axis)
        gt_next = inputs_emb[:, min(t + 1, T - 1)]  # the last step's is unused
        if scheduled:
            sampled = torch.argmax(logits.detach() + gumbel[t], dim=-1)
            ids = torch.where(select[t], sampled, -1)
            cur = torch.where(select[t][:, None], embed(sampled, vocab_size), gt_next)
        else:
            ids = torch.argmax(logits.detach(), dim=-1)
            cur = gt_next
        logits_t.append(logits)
        ids_t.append(ids)
    return torch.stack(logits_t, dim=1), torch.stack(ids_t, dim=1)
