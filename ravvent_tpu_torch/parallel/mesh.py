"""Device mesh and sharding helpers (counterpart of ravvent_tpu/parallel/mesh.py).

The workload is pure data parallelism over a 1-D ``('data',)`` mesh: the
model is small (128-unit RNNs, vocab 7) and the snippet batch is the
embarrassingly parallel axis, so parameters replicate and the batch's
leading axis shards. A :class:`Mesh` is the devices of that axis in order;
a device may repeat, so ``["cuda:0", "cuda:0"]`` is two shards on one card.

The JAX package's second axis, ``'model'`` (the attention memory's
positions sharded in training, with collectives inside every decode step),
is not ported: ``make_mesh(model_shards > 1)`` raises (ROADMAP A8b).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

Device = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes, as ``jax.sharding.Mesh``: here one
    axis, ``'data'``, and ``devices`` its devices in shard order."""

    devices: Tuple[torch.device, ...]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[Device]] = None,
              model_shards: int = 1) -> Mesh:
    """A ``('data',)`` mesh over ``devices``, by default the card's
    (``cuda:0`` .. ``cuda:{n-1}``, all of them unless ``n_devices`` is
    given); raises when there is no card. The CPU is used only when the
    caller passes it, e.g. ``devices=["cpu"] * 8``; a device may repeat.
    ``n_devices`` takes the first n of ``devices``."""
    if model_shards > 1:
        raise NotImplementedError(
            "the 'model' mesh axis (sequence-parallel attention memory in training) is not "
            "ported (ROADMAP A8b); use model_shards=1")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices=['cpu'] * n to shard "
                               "over the CPU")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise ValueError(f"asked for {n} devices, the machine has {count}")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [torch.device(d) for d in devices][:n_devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was asked for and none is available")
    return Mesh(tuple(devs))


def row_bounds(n_rows: int, n_shards: int) -> List[Tuple[int, int]]:
    """The [lo, hi) rows of each shard when ``n_rows`` split over
    ``n_shards`` as ``torch.tensor_split`` splits them: the first
    ``n_rows % n_shards`` shards hold one row more; a shard may be empty."""
    per, extra = divmod(n_rows, n_shards)
    bounds, lo = [], 0
    for i in range(n_shards):
        hi = lo + per + (i < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """One piece of a batch tree per device of the mesh: every leaf's
    leading axis split by :func:`row_bounds` (uneven counts differ by at
    most one row) and the piece moved to its device."""
    def piece(i: int, d: torch.device):
        def cut(x):
            x = torch.as_tensor(x)
            lo, hi = row_bounds(x.shape[0], mesh.size)[i]
            return x[lo:hi].to(d)
        return _tree_map(cut, batch)

    return [piece(i, d) for i, d in enumerate(mesh.devices)]


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of a tree per device of the mesh (a device's copy is the
    tree itself where its leaves already lie there)."""
    return [_tree_map(lambda x, d=d: torch.as_tensor(x).to(d), tree) for d in mesh.devices]
