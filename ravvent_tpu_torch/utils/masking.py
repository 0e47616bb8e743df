"""Input masking (counterpart of ravvent_tpu/utils/masking.py:input_mask)."""

from __future__ import annotations

import torch


def input_mask(x: torch.Tensor, padding_value: float = 0.0) -> torch.Tensor:
    """``all(x != padding_value)`` over the features, exactly as the
    reference writes it: a timestep is valid only when none of its features
    equals the padding value. x: [B, T, F] -> [B, T] bool."""
    return torch.all(x != padding_value, dim=-1)
