"""Masking, loss and accuracy (counterpart of ravvent_tpu/utils/masking.py;
reference: utils.py:15-32, basecaller.py:212-220).

Data-parallel training passes ``reduce(t, op) -> t``, which reduces a
tensor over the ranks (parallel/distributed.py:all_reduce), so that a
mean's normalizer is the global batch's."""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

Reduce = Callable[[torch.Tensor, str], torch.Tensor]


def input_mask(x: torch.Tensor, padding_value: float = 0.0) -> torch.Tensor:
    """``all(x != padding_value)`` over the features, exactly as the
    reference writes it: a timestep is valid only when none of its features
    equals the padding value. x: [B, T, F] -> [B, T] bool."""
    return torch.all(x != padding_value, dim=-1)


def _token_ce(real: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """-log_softmax(logits)[real] per position; ``real`` any integer dtype."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, real.long()[..., None])[..., 0]


def masked_ce_loss(real: torch.Tensor, logits: torch.Tensor, pad_token: int = 0,
                   reduce: Optional[Reduce] = None) -> torch.Tensor:
    """Sparse categorical cross-entropy from logits, mean over non-pad
    positions (reference: basecaller.py:212-220). With ``reduce`` the count
    of non-pad positions is the global batch's, and the result this rank's
    share of the global mean: the ranks' shares sum to it."""
    ce = _token_ce(real, logits)
    mask = (real != pad_token).to(ce.dtype)
    count = torch.sum(mask)
    if reduce is not None:
        count = reduce(count, "sum")
    return torch.sum(ce * mask) / torch.clamp(count, min=1.0)


def masked_accuracy(y_true: torch.Tensor, y_pred: torch.Tensor, omit_vals: Sequence[int],
                    extra_mask: Optional[torch.Tensor] = None,
                    reduce: Optional[Reduce] = None) -> torch.Tensor:
    """Exact-match rate over positions whose true token is not in
    ``omit_vals`` (reference: utils.py:15-24). ``extra_mask`` (bool, same
    shape) excludes more positions: the validation step's batch-max target
    width on top of the static padding. Returns an f32 scalar; with
    ``reduce``, the global batch's rate."""
    match = (y_true == y_pred).to(torch.int32)
    mask = torch.ones_like(y_true, dtype=torch.int32)
    for ov in omit_vals:
        mask = mask * (y_true != ov).to(torch.int32)
    if extra_mask is not None:
        mask = mask * extra_mask.to(torch.int32)
    total = torch.sum(mask)
    count = torch.sum(mask * match)
    if reduce is not None:
        count, total = reduce(torch.stack([count, total]), "sum")
    return count.float() / torch.clamp(total, min=1).float()


def masked_ce_loss_sum(real: torch.Tensor, logits: torch.Tensor, pad_token: int = 0) -> torch.Tensor:
    """Sum-reduction masked CE, the reference's alternative ``MaskedLoss``
    (reference: utils.py:138-160)."""
    ce = _token_ce(real, logits)
    return torch.sum(ce * (real != pad_token).to(ce.dtype))
