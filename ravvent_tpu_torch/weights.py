"""Model weights: carried across from the JAX package, and npz files.

The port's parameters are nested dicts (and lists, for the encoder layers
and decoder cells) of f32 tensors with the JAX parameter tree's keys, e.g.
``decoder/cells/0/kernel`` (135, 512) or ``encoder_raw/0/fwd/kernel``
(1, 512) — 31 leaves for the flagship. An npz file holds the same tree
flattened to ``"a/b/c"`` keys.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Union

import numpy as np
import torch

Params = Dict[str, Any]


def from_jax_params(tree, device: Union[str, torch.device] = "cpu") -> Params:
    """The JAX parameter tree with numpy leaves -> the port's parameters."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def to_device(params, device: Union[str, torch.device]):
    if isinstance(params, dict):
        return {k: to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [to_device(v, device) for v in params]
    return params.to(device=device, dtype=torch.float32)


def flatten(params, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested tree (numpy or torch leaves) -> {"a/b/c": f32 array}."""
    items = (params.items() if isinstance(params, dict)
             else enumerate(params) if isinstance(params, (list, tuple)) else None)
    if items is None:
        leaf = params.detach().cpu().numpy() if isinstance(params, torch.Tensor) else params
        return {prefix: np.asarray(leaf, dtype=np.float32)}
    out: Dict[str, np.ndarray] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Params:
    """{"a/b/c": array} -> nested tree of CPU tensors; a level whose keys are
    all integers becomes a list."""
    root: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = root
        *parts, last = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = torch.tensor(np.asarray(arr, dtype=np.float32))

    def lists(node):
        if not isinstance(node, dict):
            return node
        node = {k: lists(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return lists(root)


def save_npz(path: Union[str, Path], params) -> None:
    np.savez(path, **flatten(params))


def load_npz(path: Union[str, Path]) -> Params:
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


# the trained flagship (checkpoints/flagship of the JAX package) as
# save_npz writes it; the card's machine reads no Orbax checkpoint
FLAGSHIP_NPZ = Path(__file__).resolve().parent / "assets" / "flagship.npz"


def load_flagship() -> Params:
    """The trained flagship's parameters (:data:`FLAGSHIP_NPZ`) as CPU
    tensors; raises ``FileNotFoundError`` when the file is missing."""
    if not FLAGSHIP_NPZ.is_file():
        raise FileNotFoundError(f"the trained flagship's weights are missing: {FLAGSHIP_NPZ}")
    return load_npz(FLAGSHIP_NPZ)
