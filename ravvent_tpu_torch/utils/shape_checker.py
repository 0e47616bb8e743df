"""Named-axis shape assertions (reference: shape_checker.py:3-41; a copy of
ravvent_tpu/utils/shape_checker.py).

The reference's eager-only ``ShapeChecker`` caches a dimension per axis name
and raises on mismatch. This version takes anything with a ``shape``: numpy
arrays and torch tensors, on any device.
"""

from __future__ import annotations

from typing import Dict


class ShapeChecker:
    def __init__(self) -> None:
        self.shapes: Dict[str, int] = {}

    def __call__(self, tensor, names, broadcast: bool = False) -> None:
        if isinstance(names, str):
            names = names.split()
        shape = tuple(tensor.shape)
        if len(shape) != len(names):
            raise ValueError(
                f"rank mismatch: shape {shape} vs axis names {tuple(names)}"
            )
        for name, dim in zip(names, shape):
            if broadcast and dim == 1:
                continue
            old = self.shapes.get(name)
            if old is None:
                self.shapes[name] = int(dim)
            elif old != dim:
                raise ValueError(
                    f"axis '{name}' was {old}, got {dim} (shape {shape})"
                )
