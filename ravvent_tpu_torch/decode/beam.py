"""Beam-search decoding with tfa-compatible bookkeeping (counterpart of
ravvent_tpu/decode/beam.py).

- initial cumulative log-probs ``[0, finfo.min, ...]``: step 1 expands beam 0;
- finished beams continue only through the end token, with log-prob 0;
- top-W over the flattened ``W x V`` row by iterated first-index argmax, the
  tie order of ``jax.lax.top_k`` (``torch.topk`` does not promise it);
- recorded scores are the top-W cumulative log-probs;
- finalisation backtracks parents (TF ``gather_tree``) from step
  ``max_len - 1``; tokens after the first end token become the end token.

:func:`beam_decode` is the plain decode loop over the model's decoder
functions, any configuration; the engine runs it for ``beam_impl="xla"``.
The engine's kernel loops (ops/beam_step_cuda.py:beam_step_decode, one
fused kernel launch per step, and ops/beam_loop_cuda.py) take a depth-1
LSTM decoder with Luong attention; all end in :func:`gather_tree`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models import decoder as dec
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER

NEG_INF = float(torch.finfo(torch.float32).min)


class BeamResult(NamedTuple):
    tokens: torch.Tensor  # [B, T, W] backtracked, end-token padded
    scores: torch.Tensor  # [B, T, W] per-step cumulative log-probs


def take_along_beam(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[b, idx[b, w]]`` for [B, W] arrays."""
    return torch.gather(a, 1, idx.long())


def top_w(flat: torch.Tensor, W: int):
    """Top-W values and indices of each row of ``flat`` by iterated argmax:
    the first index wins a tie, and each pick is replaced by finfo.min before
    the next (the reference kernel's rule, beam_loop_pallas.py)."""
    flat = flat.clone()
    vals, idxs = [], []
    for _ in range(W):
        best = torch.argmax(flat, dim=1, keepdim=True)
        vals.append(torch.gather(flat, 1, best))
        idxs.append(best)
        flat.scatter_(1, best, NEG_INF)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


def effective_steps(total_steps: int, max_steps: Optional[int]) -> int:
    """The steps a decode loop executes: ``min(max_steps, total_steps)``;
    outputs from there on are dead (zero in the port's loops)."""
    return total_steps if max_steps is None else max(0, min(int(max_steps), total_steps))


def initial_cum(B: int, W: int, device=None) -> torch.Tensor:
    cum = torch.full((B, W), NEG_INF, device=device)
    cum[:, 0] = 0.0
    return cum


def beam_decode(dec_params, mem: attn.AttnMemory, vocab_size: int, beam_width: int,
                total_steps: int, max_steps: Optional[int] = None,
                attention_type: str = "luong", cell_type: str = "lstm",
                start_token: int = NUC_TOKENIZER.start_id,
                end_token: int = NUC_TOKENIZER.end_id) -> BeamResult:
    """Plain batched beam search over memory [B, S, E] (projected or not),
    any decoder depth, LSTM or GRU cells, Luong or Bahdanau attention: the
    reference's XLA loop (the JAX engine's ``beam_impl="xla"``). Runs
    ``eff = min(max_steps, total_steps)`` steps; the tail, which the
    reference computes from a frozen state and never backtracks, stays 0 in
    tokens, parents and scores."""
    B = mem.mask.shape[0]
    W, V = beam_width, vocab_size
    dev = mem.keys.device
    eff = effective_steps(total_steps, max_steps)
    dec_units = dec_params["fc"]["kernel"].shape[0]
    state = dec.zero_state(dec_params, B * W, dec_units, cell_type, dev)
    cur = torch.full((B * W,), start_token, device=dev)
    cum = initial_cum(B, W, dev)
    finished = torch.zeros(B, W, dtype=torch.bool, device=dev)
    lengths = torch.zeros(B, W, dtype=torch.int32, device=dev)
    finished_row = torch.full((V,), NEG_INF, device=dev)
    finished_row[end_token] = 0.0
    rows = (torch.arange(B, device=dev) * W)[:, None]
    tokens = torch.zeros(total_steps, B, W, dtype=torch.int32, device=dev)
    parents = torch.zeros_like(tokens)
    scores = torch.zeros(total_steps, B, W, device=dev)
    lens = torch.zeros_like(tokens)
    for t in range(eff):
        state, logits, _ = dec.decoder_step(dec_params, state, dec.embed(cur, V), mem, W,
                                            attention_type, cell_type)
        step_lp = torch.log_softmax(logits, dim=-1).reshape(B, W, V)
        step_lp = torch.where(finished[..., None], finished_row, step_lp)
        cum, idx = top_w((cum[..., None] + step_lp).reshape(B, W * V), W)
        parent, token = idx // V, idx % V
        prev_finished = take_along_beam(finished, parent)
        finished = prev_finished | (token == end_token)
        lengths = take_along_beam(lengths, parent) + (~prev_finished).to(torch.int32)
        flat_parent = (parent + rows).reshape(-1)
        state = dec.DecoderState(
            cells=tuple(tuple(x[flat_parent] for x in carry) for carry in state.cells),
            attention=state.attention[flat_parent])
        cur = token.reshape(-1)
        tokens[t], parents[t], scores[t], lens[t] = token, parent, cum, lengths
    final = gather_tree(tokens, parents, lens, eff, end_token)
    return BeamResult(tokens=final.permute(1, 0, 2), scores=scores.permute(1, 0, 2))


def reconstruct_lengths(tokens: torch.Tensor, parents: torch.Tensor,
                        end_token: int) -> torch.Tensor:
    """Per-step beam prediction lengths [T, B, W]: the parent's length + 1
    while the parent was unfinished (the recurrence beam_decode carries)."""
    T, B, W = tokens.shape
    lengths = torch.zeros(B, W, dtype=torch.int32, device=tokens.device)
    finished = torch.zeros(B, W, dtype=torch.bool, device=tokens.device)
    out = []
    for t in range(T):
        pf = take_along_beam(finished, parents[t])
        lengths = take_along_beam(lengths, parents[t]) + (~pf).to(torch.int32)
        finished = pf | (tokens[t] == end_token)
        out.append(lengths)
    return torch.stack(out)


def gather_tree(tokens: torch.Tensor, parents: torch.Tensor, lengths: torch.Tensor,
                eff_T: int, end_token: int) -> torch.Tensor:
    """TF ``gather_tree`` with a step limit: backtrack each beam from step
    ``max_len - 1`` (max_len = the row's longest prediction at the last
    executed step, capped at ``eff_T``), then replace everything after the
    first end token with the end token. Inputs and output are [T, B, W]."""
    T, B, W = tokens.shape
    last = max(eff_T - 1, 0)
    max_len = torch.clamp(lengths[last].max(dim=1).values, max=eff_T)[:, None]  # [B, 1]
    beam0 = torch.arange(W, device=tokens.device).expand(B, W)
    beam = beam0
    out = torch.empty_like(tokens)
    for t in range(T - 1, -1, -1):
        active = t < max_len
        beam = torch.where(t == max_len - 1, beam0, beam)
        out[t] = torch.where(active, take_along_beam(tokens[t], beam), end_token)
        beam = torch.where(active, take_along_beam(parents[t], beam), beam)
    found = torch.zeros(B, W, dtype=torch.bool, device=tokens.device)
    for t in range(T):
        tok = out[t]
        out[t] = torch.where(found, end_token, tok)
        found = found | (tok == end_token)
    return out


def beam_scores_to_step_probs(beam_scores: torch.Tensor) -> torch.Tensor:
    """Per-step probability ``exp(score_t - score_{t-1})`` from the top
    beam's cumulative scores [B, T]."""
    prev = torch.nn.functional.pad(beam_scores[:, :-1], (1, 0))
    return torch.exp(beam_scores - prev)
