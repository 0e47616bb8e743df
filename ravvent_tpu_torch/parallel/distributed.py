"""Process coordination and read sharding (counterpart of
ravvent_tpu/parallel/distributed.py).

- Process groups: :func:`initialize` wraps
  ``torch.distributed.init_process_group`` with an explicit backend:
  ``"nccl"`` for one process per GPU, ``"gloo"`` on the CPU or where ranks
  share a card (NCCL refuses two ranks on one GPU). Nothing picks a backend.
- Training: every rank is given the same global batch and keeps its
  :func:`local_batch_slice`; the trainer sums counts and gradients with
  :func:`all_reduce` (training/loop.py). On a (data, model) grid of ranks
  (:func:`grid_axes`) the ranks of one model row share a data shard and
  split the attention memory's positions: :meth:`Axis.enter` and
  :meth:`Axis.leave` carry tensors into and out of the row's sharded
  region under autograd, and the data reductions run over a data column.
- Inference: reads are the unit a rank owns (a read's snippets merge in a
  sequential fold), so the files-info index is split per rank
  (:func:`shard_files_info`, :func:`balanced_shard_files_info`) and the
  per-read results come together with :func:`gather_read_results`.
- :func:`spawn` starts a function on n ranks of one host, each in a fresh
  interpreter.

The file sharding and the framing are the JAX package's, copied.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def initialize(init_method: str, world_size: int, rank: int, backend: str) -> None:
    """Join this process to a group of ``world_size`` ranks at
    ``init_method`` (``tcp://host:port`` or ``file:///path``); a no-op for
    ``world_size <= 1``. ``backend`` is ``"nccl"`` (one process per GPU:
    rank r takes ``cuda:{r % device_count}`` as its current device) or
    ``"gloo"``. Under gloo it returns once every rank has joined: gloo
    connects the ranks while the group is set up, and a rank that left the
    set-up early and then failed would close its connections under a rank
    still connecting, whose set-up then fails with a connection error in
    place of the first rank's own (NCCL connects at the first
    collective)."""
    if world_size <= 1:
        return
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    if backend == "gloo":
        dist.barrier()


def process_info() -> tuple:
    """(rank, world size); (0, 1) when no process group is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _wire_device() -> torch.device:
    """The device a collective's tensors must lie on: the current card under
    NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _in_place(collective: Callable[[torch.Tensor], None], t: torch.Tensor) -> torch.Tensor:
    """``collective`` run in place on ``t``, through a copy on the backend's
    device where ``t`` lies elsewhere (a CUDA tensor under gloo, a CPU tensor
    such as a generator's state under NCCL); returns ``t``."""
    wire = _wire_device()
    if t.device == wire:
        collective(t)
        return t
    moved = t.to(wire, copy=True)
    collective(moved)
    return t.copy_(moved)


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """``t`` reduced over the ranks of ``group`` (default: all of them) in
    place (``op`` "sum", "max" or "min") and returned, on any device under
    either backend."""
    on = {} if group is None else {"group": group}
    return _in_place(lambda x: dist.all_reduce(x, _OPS[op], **on), t)


class _Enter(torch.autograd.Function):
    """The identity forward; the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(memory_format=torch.contiguous_format), "sum", ctx.group), None


class _Leave(torch.autograd.Function):
    """The sum over ``group`` forward; the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.clone(memory_format=torch.contiguous_format), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclass(frozen=True)
class Axis:
    """One axis of a (data, model) grid of ranks as this rank sees it: its
    ``size``, this rank's ``index`` along it, and the process ``group`` of
    the ranks that differ from this one only along it (None: every rank).
    An axis of size 1 runs no collective.

    Along the model axis the ranks hold the same rows and compute the same
    values, except inside a region where each holds a slice of the
    attention memory: a replicated tensor enters the region through
    :meth:`enter` (so its gradient sums every slice's share) and the
    slices' partial sums leave it through :meth:`leave` (summed, after which
    the computation is replicated again). ``torch.distributed.nn``'s
    all-reduce will not do for :meth:`leave`: its backward sums the
    gradient over the ranks again, and that gradient, computed alike on
    every rank downstream, would count ``size`` times."""

    size: int = 1
    index: int = 0
    group: Any = None

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return t if self.size == 1 else all_reduce(t, op, self.group)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Enter.apply(x, self.group)

    def leave(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.size == 1 else _Leave.apply(x, self.group)


def grid_axes(n_data: int, n_model: int) -> Tuple[Axis, Axis]:
    """This rank's (data, model) axes on a grid of ``n_data * n_model``
    ranks laid out as parallel.mesh.make_mesh lays out devices: rank r is
    data index ``r // n_model`` and model index ``r % n_model``. It creates
    the grid's process groups, one for each model row and one for each
    data column, so every rank must call it at the same point (gloo hangs
    otherwise). An axis that spans every rank uses the default group; a
    grid of one rank is this process alone, whatever its world."""
    if n_data * n_model == 1:
        return Axis(), Axis()
    rank, world = process_info()
    if world != n_data * n_model:
        raise RuntimeError(f"a grid of {n_data} x {n_model} ranks needs a world size of "
                           f"{n_data * n_model}; this process's is {world}")
    d, m = divmod(rank, n_model)
    data_group = model_group = None
    if n_data > 1 and n_model > 1:
        for row in range(n_data):
            g = dist.new_group([row * n_model + i for i in range(n_model)])
            model_group = g if row == d else model_group
        for col in range(n_model):
            g = dist.new_group([i * n_model + col for i in range(n_data)])
            data_group = g if col == m else data_group
    return Axis(n_data, d, data_group), Axis(n_model, m, model_group)


def broadcast(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` overwritten in place by rank ``src``'s and returned, on any
    device under either backend."""
    return _in_place(lambda x: dist.broadcast(x, src), t)


def _load_index(files_info_path) -> List[dict]:
    with open(files_info_path, "rt") as f:
        return json.load(f)


def shard_files_info(files_info_path, process_id: Optional[int] = None,
                     process_count: Optional[int] = None) -> List[dict]:
    """Deterministic per-rank partition of a files_info index: rank p owns
    reads p, p+P, p+2P, ... (round-robin)."""
    p, n = process_info()
    process_id = p if process_id is None else process_id
    process_count = n if process_count is None else process_count
    return _load_index(files_info_path)[process_id::process_count]


def balanced_shard_files_info(files_info_path, process_id: Optional[int] = None,
                              process_count: Optional[int] = None) -> List[dict]:
    """Greedy balanced partition by snippet count (longest processing time
    first): better than round-robin when read lengths are skewed."""
    p, n = process_info()
    process_id = p if process_id is None else process_id
    process_count = n if process_count is None else process_count
    files_info = _load_index(files_info_path)
    order = sorted(range(len(files_info)), key=lambda i: -files_info[i].get("snippets_num", 0))
    loads = np.zeros(process_count, dtype=np.int64)
    owner = np.zeros(len(files_info), dtype=np.int64)
    for i in order:
        q = int(np.argmin(loads))
        owner[i] = q
        loads[q] += files_info[i].get("snippets_num", 0)
    return [fi for i, fi in enumerate(files_info) if owner[i] == process_id]


def local_batch_slice(global_batch: int, index: Optional[int] = None,
                      count: Optional[int] = None) -> slice:
    """The half-open row range of the global batch that shard ``index`` of
    ``count`` feeds; by default this rank of all of them (on a grid, the
    caller passes its data index and the data axis's size)."""
    p, n = process_info()
    p = p if index is None else index
    n = n if count is None else count
    per = global_batch // n
    return slice(p * per, (p + 1) * per)


def frame_payload(payload: bytes, width: int) -> np.ndarray:
    """Zero-pad a JSON payload to the agreed all-gather width (u8 row)."""
    if len(payload) > width:
        raise ValueError(f"payload {len(payload)}B exceeds frame {width}B")
    arr = np.zeros(width, dtype=np.uint8)
    arr[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    return arr


def unframe_results(rows: np.ndarray, sizes: Sequence[int]) -> List[dict]:
    """Inverse of frame_payload over gathered rows: slice each rank's row to
    its declared byte length and concatenate the decoded result lists."""
    out: List[dict] = []
    for row, n in zip(np.asarray(rows, dtype=np.uint8), sizes):
        out.extend(json.loads(bytes(row[: int(n)]).decode() or "[]"))
    return out


def gather_read_results(results: Sequence[dict]) -> List[dict]:
    """Per-read result dicts from every rank; each rank receives the union,
    in rank order. Single process: identity.

    Two phases, size-safe: the ranks all-gather their payloads' byte
    lengths, then every payload is padded to the global maximum, so the
    all-gathered rows agree in shape whatever a payload's size. On NCCL the
    rows are CUDA tensors on the current device, on gloo CPU tensors."""
    _, n = process_info()
    if n == 1:
        return list(results)
    dev = _wire_device()
    payload = json.dumps(list(results)).encode()
    size = torch.tensor([len(payload)], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    sizes = torch.cat(sizes).cpu().numpy()
    row = torch.from_numpy(frame_payload(payload, int(sizes.max()))).to(dev)
    rows = [torch.empty_like(row) for _ in range(n)]
    dist.all_gather(rows, row)
    return unframe_results(torch.stack(rows).cpu().numpy(), sizes)


def spawn(fn: Callable, world_size: int, args: tuple = (), init_dir=None,
          timeout: float = 600.0) -> None:
    """Run ``fn(rank, world_size, init_method, *args)`` on ``world_size``
    spawned processes (fresh interpreters, so ``fn`` must be importable by
    module path) that rendezvous at a file in a new temporary directory
    (under ``init_dir`` when given). Raises when a rank raises or exits with
    an error, and after killing the ranks when they outlast ``timeout``
    seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=init_dir) as tmp:
        init = f"file://{Path(tmp).resolve()}/rendezvous"
        ctx = mp.spawn(fn, args=(world_size, init, *args), nprocs=world_size, join=False)
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"{world_size} ranks outlasted {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
