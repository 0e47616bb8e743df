"""Greedy autoregressive decoding (counterpart of ravvent_tpu/decode/greedy.py).

tfa ``BasicDecoder`` + ``GreedyEmbeddingSampler`` under ``dynamic_decode``
with ``impute_finished=False``, as a fixed-length loop:

- per step the emitted token is argmax(logits) (first index on a tie) and the
  next input is its one-hot, *also for rows that have finished*
  (impute_finished=False: a finished row keeps emitting its argmax token
  until the whole batch has finished);
- a step executes while not every row has finished and ``t < max_steps``;
  outputs after the all-finished point or past ``max_steps`` are zeros.

``all_done`` is taken over the whole batch, so a row's output depends on the
other rows of the call. Steps at ``t >= max_steps`` emit zeros and change
nothing that is emitted, so the loop runs ``min(max_steps, total_steps)``
steps and leaves the rest zero; it never reads ``all_done`` on the host.
The samples do not depend on ``all_done``, so the loop keeps every step's
output and the ``all_done`` that held before it, and masks once after the
loop. A data-parallel rank passes ``reduce`` (utils/masking.py): one
reduction over the ranks (a minimum: all ranks done) turns its rows'
``all_done`` into the global batch's before the mask.

:func:`greedy_decode` is plain PyTorch over the model's ``decoder_step`` on
any memory. The fused loop over kernel B4 is
ops/decode_step_cuda.py:fused_greedy_decode; both run :func:`greedy_loop`.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ravvent_tpu_torch.decode.beam import effective_steps
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models import decoder as dec
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.utils.masking import Reduce


def greedy_loop(step: Callable[[torch.Tensor], torch.Tensor], B: int, vocab_size: int,
                total_steps: int, max_steps: Optional[int], start_token: int, end_token: int,
                device, reduce: Optional[Reduce] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The greedy bookkeeping around ``step(token_ids [B]) -> logits [B, V]``,
    which advances its own decoder state. Returns (tokens [B, total_steps]
    int32, logits [B, total_steps, V]); with ``reduce`` the all-finished
    stop is the global batch's."""
    eff = effective_steps(total_steps, max_steps)
    tokens = torch.zeros(B, total_steps, dtype=torch.int32, device=device)
    logits_out = torch.zeros(B, total_steps, vocab_size, device=device)
    cur = torch.full((B,), start_token, dtype=torch.int32, device=device)
    finished = torch.zeros(B, dtype=torch.bool, device=device)
    all_done = torch.zeros((), dtype=torch.bool, device=device)
    done_before = []  # each step's all_done before it, of this call's rows
    for t in range(eff):
        logits = step(cur)
        sample = torch.argmax(logits, dim=-1).to(torch.int32)
        tokens[:, t] = sample
        logits_out[:, t] = logits
        done_before.append(all_done)
        finished = finished | (sample == end_token)
        all_done = all_done | finished.all()
        cur = sample
    if eff:  # t < max_steps holds inside the loop
        done = torch.stack(done_before).to(torch.int32)
        executes = (done if reduce is None else reduce(done, "min")) == 0  # [eff]
        tokens[:, :eff] = torch.where(executes[None, :], tokens[:, :eff], 0)
        logits_out[:, :eff] = torch.where(executes[None, :, None], logits_out[:, :eff], 0.0)
    return tokens, logits_out


def greedy_decode(dec_params, mem: attn.AttnMemory, vocab_size: int, total_steps: int,
                  max_steps: Optional[int] = None, attention_type: str = "luong",
                  cell_type: str = "lstm", start_token: int = NUC_TOKENIZER.start_id,
                  end_token: int = NUC_TOKENIZER.end_id, reduce: Optional[Reduce] = None,
                  model_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain greedy decode over memory [B, S, E] (projected or not), any
    decoder depth, cell and attention; ``reduce``: see :func:`greedy_loop`;
    ``model_axis``: ``mem`` is this rank's slice of the positions
    (models/decoder.py:decoder_step). Returns (tokens [B, total_steps]
    int32, logits [B, total_steps, V])."""
    B = mem.mask.shape[0]
    dev = mem.keys.device
    dec_units = dec_params["fc"]["kernel"].shape[0]
    state = dec.zero_state(dec_params, B, dec_units, cell_type, dev)

    def step(cur: torch.Tensor) -> torch.Tensor:
        nonlocal state
        state, logits, _ = dec.decoder_step(dec_params, state, dec.embed(cur, vocab_size), mem, 1,
                                            attention_type, cell_type, model_axis)
        return logits

    return greedy_loop(step, B, vocab_size, total_steps, max_steps, start_token, end_token, dev,
                       reduce)
