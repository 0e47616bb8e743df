"""Batched contiguous-row gather (counterpart of ravvent_tpu/ops/gather_rows.py).

``out[n, j] = src[starts[n] + j]`` for ``j < lens[n]``, else 0. The JAX
package decomposes this into a 128-aligned block gather and a shift tree, a
workaround for the TPU's serialized scalar gather; here it is one index
gather. Both only copy elements, so the outputs are bit-equal.
"""

from __future__ import annotations

import torch


def gather_rows(src: torch.Tensor, starts: torch.Tensor, lens: torch.Tensor, L: int) -> torch.Tensor:
    """``src`` is 1-D; ``starts``/``lens`` are [N] integers with ``starts >= 0``.
    Rows may run past the end of ``src``: positions beyond ``lens`` are
    zero-filled and never read outside the (zero-padded) source."""
    src_p = torch.nn.functional.pad(src, (0, L))
    j = torch.arange(L, device=src.device)
    idx = starts.long()[:, None] + j[None, :]
    idx = idx.clamp_(max=src_p.shape[0] - 1)
    valid = j[None, :] < lens.long()[:, None]
    return torch.where(valid, src_p[idx], torch.zeros((), dtype=src.dtype, device=src.device))
