"""Chiron-format dataset IO and indexing.

Chiron format (reference: data_loader.py:113-126): per read, ``X.signal``
holds whitespace-separated integer DAC samples and ``X.label`` holds rows
``start end base`` giving the raw-sample range of each base.

Also writes the dataset index (``files_info``) and makes the val/test file
split (reference: data_loader.py:129-177) with identical JSON schemas.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Tuple

import numpy as np


def load_signal(signal_path) -> np.ndarray:
    return np.loadtxt(signal_path, dtype=int)


def load_label(label_path) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (nuc_raw_ranges [N,2] int, nuc_reference_symbols [N] str)."""
    label = np.loadtxt(label_path, dtype=object)
    if label.ndim == 1:  # single row
        label = label.reshape(1, -1)
    return label[:, :2].astype(int), label[:, 2].astype(str)


def write_read(signal_path, label_path, signal: np.ndarray, ranges: np.ndarray, bases: str) -> None:
    signal = np.asarray(signal, dtype=int)
    np.savetxt(signal_path, signal.reshape(1, -1), fmt="%d")
    with open(label_path, "wt") as f:
        for (s, e), b in zip(ranges, bases):
            f.write(f"{int(s)} {int(e)} {b}\n")


def list_read_pairs(files_dir) -> List[Tuple[Path, Path]]:
    d = Path(files_dir)
    signals = sorted(p for p in d.iterdir() if p.suffix == ".signal")
    labels = sorted(p for p in d.iterdir() if p.suffix == ".label")
    return list(zip(signals, labels))


def create_files_info(files_dir, stride: int = 6, verbose: bool = True) -> Path:
    """Build the dataset index JSON (reference: data_loader.py:129-156).

    Unlike the reference (which runs the full preprocessing just to count
    snippets, discarding the tensors), this uses the cached snippet store when
    enabled, so indexing doubles as cache warming.
    """
    from ravvent_tpu_torch.data.snippets import load_read_snippets

    d = Path(files_dir)
    files_info_path = d / f"files_info.snippets.stride_{stride}.json"
    files_info = []
    for signal_path, label_path in list_read_pairs(d):
        raw_snippets, _, _ = load_read_snippets(signal_path, label_path, stride)
        if verbose:
            print(signal_path.stem)
        files_info.append(
            {
                "signal_path": signal_path.as_posix(),
                "label_path": label_path.as_posix(),
                "snippets_num": int(raw_snippets.shape[0]),
            }
        )
    with open(files_info_path, "wt") as f:
        json.dump(files_info, f, indent=2)
    return files_info_path


def split_eval_files_info_into_test_validation(
    val_fraction: float, eval_files_info_path: str, seed: int | None = None
) -> Tuple[str, str]:
    """Split an eval index into val/test by file (reference: data_loader.py:158-177)."""
    with open(eval_files_info_path, "r") as f:
        files_info_data = json.load(f)

    rng = np.random.default_rng(seed)
    ids = np.arange(len(files_info_data))
    rng.shuffle(ids)

    n_val = int(val_fraction * len(ids))
    val_ids, test_ids = ids[:n_val], ids[n_val:]

    # Replace "eval" only in the file NAME (the reference replaces it in the
    # whole path — data_loader.py:171-172 — which also renames any "eval"
    # directory component and writes into a directory that may not exist).
    p = Path(eval_files_info_path)
    val_path = str(p.with_name(p.name.replace("eval", "val")))
    test_path = str(p.with_name(p.name.replace("eval", "test")))
    with open(val_path, "wt") as f:
        json.dump([files_info_data[i] for i in val_ids], f, indent=2)
    with open(test_path, "wt") as f:
        json.dump([files_info_data[i] for i in test_ids], f, indent=2)
    return val_path, test_path
