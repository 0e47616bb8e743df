"""Data-parallel inference over a device mesh (counterpart of
ravvent_tpu/parallel/inference.py).

Weights replicated, the snippet rows sharded: snippets are the
embarrassingly parallel axis, reads the unit a process owns
(parallel/distributed.py). ``BasecallEngine(..., mesh=)`` runs every output
it has (``predict_beam``, ``predict_greedy``, the compact wire with its
dispatch/collect pipelining, the signal-only wire) with each chunk's rows
split over the mesh's ``'data'`` axis; each shard runs the identical
single-device program on its device, kernels included, and no collective
sits on the hot path (evaluation/basecall.py's module docstring). A
``('data', 'model')`` mesh (training's) serves as its ``'data'`` axis: a
data shard runs on the first device of its model row, as the JAX engine
splits rows over ``mesh.shape["data"]`` alone.

:class:`ShardedBasecallEngine` is the mesh-first constructor of that engine;
the evaluators take it as they take a ``BasecallEngine``.
"""

from __future__ import annotations

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.basecall import TOTAL_STEPS, BasecallEngine
from ravvent_tpu_torch.parallel.mesh import Mesh


class ShardedBasecallEngine(BasecallEngine):
    """``BasecallEngine`` over a device mesh (see the module's docstring).
    Rows are independent, so any row count splits: a chunk of fewer rows
    than shards leaves the last shards idle."""

    def __init__(self, params, cfg: ModelConfig, mesh: Mesh, chunk_size: int = 4096,
                 total_steps: int = TOTAL_STEPS, **engine_kwargs) -> None:
        super().__init__(params, cfg, chunk_size=chunk_size, total_steps=total_steps, mesh=mesh,
                         **engine_kwargs)
