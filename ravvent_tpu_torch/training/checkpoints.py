"""Checkpoints in torch's own format (counterpart of
ravvent_tpu/training/checkpoints.py, which saves with Orbax).

The reference saves weights-only keras checkpoints, one directory per epoch,
named by the run-name schema (reference: ravvent.py:61-70). Here, as in the
JAX package, a checkpoint carries the whole training state so that a resume
is exact, in the same directory layout (``RunConfig.checkpoint_path``):

- ``params.npz``: the parameters as ``weights.save_npz`` writes them, so the
  CLI's ``--weights`` loads a checkpoint the port trained;
- ``state.pt``: one ``torch.save`` file of the optimizer state (``count``,
  ``mu`` and ``nu`` flattened to ``"a/b/c"`` keys like the npz), the epoch,
  the trainer's generator state and the data generator's seed.

It does not read the JAX package's Orbax checkpoints; their parameters come
across through ``weights.from_jax_params``.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from ravvent_tpu_torch import weights
from ravvent_tpu_torch.training.loop import AdamState, tree_map

PARAMS_FILE = "params.npz"
STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, base_dir: str) -> None:
        self.base_dir = Path(base_dir)

    def save(self, path: str, params: Any, opt_state: Any = None, epoch: int = 0,
             rng: Optional[torch.Generator] = None, data_seed: int = 0) -> str:
        """Write ``base_dir/path/`` (replacing what is there). ``opt_state``
        is the trainer's ``AdamState``; ``rng`` its generator."""
        full = (self.base_dir / path).resolve()
        full.mkdir(parents=True, exist_ok=True)
        state: Dict[str, Any] = {"epoch": int(epoch), "data_seed": int(data_seed)}
        if opt_state is not None:
            state["opt_state"] = {
                "count": int(opt_state.count),
                "mu": flat_tensors(opt_state.mu),
                "nu": flat_tensors(opt_state.nu),
            }
        if rng is not None:
            state["rng"] = rng.get_state()
        # each file is published whole, so a reader never sees a torn one,
        # through a temporary file of this writer's own (threads included)
        for name, write in ((PARAMS_FILE, lambda f: np.savez(f, **weights.flatten(params))),
                            (STATE_FILE, lambda f: torch.save(state, f))):
            tmp = full / f".{name}.tmp{os.getpid()}.{threading.get_ident()}"
            try:
                with open(tmp, "wb") as f:
                    write(f)
                os.replace(tmp, full / name)
            except BaseException:
                tmp.unlink(missing_ok=True)
                raise
        return str(full)

    def restore(self, path: str) -> Dict[str, Any]:
        """The saved state with CPU tensors: ``params`` (the nested tree),
        and where saved ``opt_state`` (an ``AdamState``), ``rng`` (the
        generator's state), ``epoch`` and ``data_seed``."""
        full = (self.base_dir / path).resolve()
        out: Dict[str, Any] = {"params": weights.load_npz(full / PARAMS_FILE)}
        state = torch.load(full / STATE_FILE, weights_only=True)
        out.update({k: v for k, v in state.items() if k != "opt_state"})
        if "opt_state" in state:
            o = state["opt_state"]
            out["opt_state"] = AdamState(count=o["count"], mu=weights.unflatten(o["mu"]),
                                         nu=weights.unflatten(o["nu"]))
        return out

    def restore_numpy(self, path: str) -> Dict[str, Any]:
        """:meth:`restore` with numpy leaves in the parameter and optimizer
        trees."""
        out = self.restore(path)
        out["params"] = to_numpy(out["params"])
        if "opt_state" in out:
            o = out["opt_state"]
            out["opt_state"] = o._replace(mu=to_numpy(o.mu), nu=to_numpy(o.nu))
        return out

    def latest_epoch(self, run_dir: str, prefix: str) -> Optional[int]:
        """The newest epoch checkpoint named as the reference names them,
        ``<prefix>.<epoch:02d>``."""
        d = self.base_dir / run_dir
        if not d.exists():
            return None
        epochs = []
        for p in d.iterdir():
            name = p.name
            if name.startswith(prefix + ".") and name[len(prefix) + 1:].isdigit():
                epochs.append(int(name[len(prefix) + 1:]))
        return max(epochs) if epochs else None


def flat_tensors(tree) -> Dict[str, torch.Tensor]:
    """``weights.flatten`` with CPU tensor leaves, which ``torch.load``
    reads back with ``weights_only``."""
    return {k: torch.from_numpy(v) for k, v in weights.flatten(tree).items()}


def to_numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def rename_model_epochs(models_dir: str, offset: int, dry_run: bool = False) -> list:
    """Renumber epoch-suffixed checkpoint directories when chaining runs
    (reference: rename_models.py:5-20)."""
    d = Path(models_dir)
    renames = []
    entries = sorted(d.iterdir(), reverse=offset > 0)
    for p in entries:
        if not p.is_dir():
            continue
        stem, _, ep = p.name.rpartition(".")
        if not ep.isdigit():
            continue
        new = d / f"{stem}.{int(ep) + offset:02d}"
        renames.append((str(p), str(new)))
        if not dry_run:
            os.rename(p, new)
    return renames
