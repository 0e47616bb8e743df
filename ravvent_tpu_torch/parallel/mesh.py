"""Device mesh and sharding helpers (counterpart of ravvent_tpu/parallel/mesh.py).

The snippet batch is the embarrassingly parallel axis, so the first axis,
``'data'``, shards the batch's leading axis and replicates the parameters
(the model is small: 128-unit RNNs, vocab 7). A second axis, ``'model'``
(``make_mesh(model_shards=k)``), shards the attention memory's positions
in training: each of the k ranks of a model row holds a slice of the
memory (:func:`memory_sharding`) and the attention reduces across the row
inside every decode step (models/attention.py, training/loop.py). A
:class:`Mesh` is its devices in rank order, laid out as JAX's
``devices.reshape(-1, k)``; a device may repeat, so ``["cuda:0",
"cuda:0"]`` is two shards on one card. Inference splits rows over
``'data'`` only (:attr:`Mesh.data_devices`), as the JAX engine does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

Device = Union[str, torch.device]


@dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes, as ``jax.sharding.Mesh``:
    ``('data',)``, or ``('data', 'model')`` when ``model_shards > 1``.
    ``devices`` holds them in rank order: device ``i`` is data index
    ``i // model_shards`` and model index ``i % model_shards``."""

    devices: Tuple[torch.device, ...]
    model_shards: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data",) if self.model_shards == 1 else ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        n_data = len(self.devices) // self.model_shards
        return {"data": n_data} if self.model_shards == 1 else {"data": n_data,
                                                                "model": self.model_shards}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def data_devices(self) -> Tuple[torch.device, ...]:
        """The first device of each model row, in data order: where a
        data shard of the rows runs (every device of a 1-D mesh)."""
        return self.devices[::self.model_shards]


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence[Device]] = None,
              model_shards: int = 1) -> Mesh:
    """A ``('data',)`` mesh over ``devices``, by default the card's
    (``cuda:0`` .. ``cuda:{n-1}``, all of them unless ``n_devices`` is
    given); raises when there is no card. The CPU is used only when the
    caller passes it, e.g. ``devices=["cpu"] * 8``; a device may repeat.
    ``n_devices`` takes the first n of ``devices``. With ``model_shards =
    k > 1`` a ``('data', 'model')`` mesh of ``n // k`` rows of k devices;
    k must divide the device count."""
    if model_shards < 1:
        raise ValueError(f"model_shards must be at least 1, got {model_shards}")
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
    if len(devs) % model_shards:
        raise ValueError(f"{len(devs)} devices do not split into rows of model_shards="
                         f"{model_shards}")
    return Mesh(tuple(devs), model_shards)


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


def memory_sharding(model_shards: int, model_index: int, n_positions: int) -> Optional[slice]:
    """The attention memory's positions that model index ``model_index``
    holds when ``n_positions`` split over ``model_shards`` ranks by
    :func:`row_bounds` (uneven counts differ by one position; nothing is
    padded, so an all-masked row still softmaxes over the real positions);
    None on a pure data-parallel mesh (``model_shards == 1``)."""
    if model_shards == 1:
        return None
    if n_positions < model_shards:
        raise ValueError(f"{n_positions} memory positions do not give each of {model_shards} "
                         f"model shards one")
    lo, hi = row_bounds(n_positions, model_shards)[model_index]
    return slice(lo, hi)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch: Any, mesh: Mesh) -> List[Any]:
    """One piece of a batch tree per data shard of the mesh, on its device
    (:attr:`Mesh.data_devices`): every leaf's leading axis split by
    :func:`row_bounds` (uneven counts differ by at most one row)."""
    devices = mesh.data_devices

    def piece(i: int, d: torch.device):
        def cut(x):
            x = torch.as_tensor(x)
            lo, hi = row_bounds(x.shape[0], len(devices))[i]
            return x[lo:hi].to(d)
        return _tree_map(cut, batch)

    return [piece(i, d) for i, d in enumerate(devices)]


def replicate(tree: Any, mesh: Mesh) -> List[Any]:
    """One copy of a tree per data shard of the mesh, on its device (a
    device's copy is the tree itself where its leaves already lie there)."""
    return [_tree_map(lambda x, d=d: torch.as_tensor(x).to(d), tree) for d in mesh.data_devices]
