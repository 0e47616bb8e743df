"""Dataset IO helpers (a copy of ravvent_tpu/utils/io.py; reference:
utils.py:71-128).

fast5 writing, chiron label concatenation, chiron->fast5 batch conversion for
external event-detection tools, and the train/val/test splitter.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np


def get_bases_sequence_from_chiron_dir(dir_path, max_length: Optional[int] = None) -> str:
    """Concatenate label base sequences across a chiron dir
    (reference: utils.py:71-86)."""
    d = Path(dir_path)
    labels_paths = sorted(p for p in d.iterdir() if p.suffix == ".label")
    seq = ""
    for lp in labels_paths:
        labels = np.loadtxt(lp, dtype="object")
        if labels.ndim == 1:
            labels = labels.reshape(1, -1)
        seq += "".join(labels[:, 2].tolist())
        if max_length is not None and len(seq) >= max_length:
            return seq[:max_length]
    return seq


def create_fast5_from_raw_values(raw_values: np.ndarray, boilerplate_fast5_file, fast5_path) -> None:
    """Write a minimal single-read fast5 by patching a boilerplate file's
    signal dataset (reference: utils.py:88-97)."""
    import shutil

    import h5py

    shutil.copyfile(boilerplate_fast5_file, fast5_path)
    with h5py.File(fast5_path, "r+") as f:
        raw_dat = list(f["/Raw/Reads/"].values())[0]
        del raw_dat["Signal"]
        raw_dat.create_dataset(
            "Signal", data=raw_values, dtype="i2", compression="gzip", compression_opts=9
        )
        raw_dat.attrs["duration"] = raw_values.size
        raw_dat.attrs["read_id"] = "1"


def create_minimal_fast5(raw_values: np.ndarray, fast5_path, read_id: str = "1") -> None:
    """Create a fast5 from scratch (no boilerplate needed — the reference
    requires one; this removes that external dependency)."""
    import h5py

    with h5py.File(fast5_path, "w") as f:
        grp = f.create_group(f"Raw/Reads/Read_{read_id}")
        grp.create_dataset(
            "Signal", data=np.asarray(raw_values, dtype=np.int16),
            compression="gzip", compression_opts=9,
        )
        grp.attrs["duration"] = int(np.asarray(raw_values).size)
        grp.attrs["read_id"] = read_id


def read_fast5_signal(fast5_path) -> np.ndarray:
    import h5py

    with h5py.File(fast5_path, "r") as f:
        reads = list(f["Raw/Reads"].values())
        return np.asarray(reads[0]["Signal"][:], dtype=np.int64)


def run_external_event_detection(
    detect_events_path, fast5_path, event_detection_path,
    win_len1: int = 5, win_len2: int = 13,
) -> None:
    """Shell out to the external C++ ``detect_events`` tool
    (reference: utils.py:99-102; offline windows 5/13 vs online 6/9 — quirk
    #7). Only useful where that binary exists; our native detector
    (ravvent_tpu_torch.ops.native) is the built-in replacement."""
    import shlex
    import subprocess

    cmd = f"{detect_events_path} --win-len1 {win_len1} --win-len2 {win_len2} {fast5_path}"
    with open(event_detection_path, "wt") as f:
        subprocess.run(shlex.split(cmd), stdout=f)


def generate_event_detection_for_chiron(
    chiron_dir, detect_events_path=None, boilerplate_fast5_file=None,
    win_len1: int = 5, win_len2: int = 13,
) -> None:
    """Batch-convert a chiron dir to ``.eventdetection`` files
    (reference: utils.py:104-121): per read, crop the signal to the labeled
    region, write a fast5, run event detection, remove the fast5.

    Without the external ``detect_events`` binary, the built-in detector
    (ravvent_tpu_torch.data.event_detector) produces the events directly — same
    output format (start length mean stdv rows)."""
    from pathlib import Path

    import numpy as np

    from ravvent_tpu_torch.data.event_detector import detect_events

    d = Path(chiron_dir)
    signal_paths = sorted(p for p in d.iterdir() if p.suffix == ".signal")
    labels_paths = sorted(p for p in d.iterdir() if p.suffix == ".label")
    for signal_path, label_path in zip(signal_paths, labels_paths):
        signal = np.loadtxt(signal_path)
        labels = np.loadtxt(label_path, dtype="object")
        if labels.ndim == 1:
            labels = labels.reshape(1, -1)
        ranges_ids = labels[:, 0:2].astype("int")
        signal = signal[ranges_ids[0][0] : ranges_ids[-1][1]]
        ed_path = signal_path.with_suffix(".eventdetection")
        if detect_events_path is not None:
            fast5_path = signal_path.with_suffix(".fast5")
            if boilerplate_fast5_file is not None:
                create_fast5_from_raw_values(signal, boilerplate_fast5_file, fast5_path)
            else:
                create_minimal_fast5(signal, fast5_path)
            run_external_event_detection(
                detect_events_path, fast5_path, ed_path, win_len1, win_len2
            )
            fast5_path.unlink()
        else:
            ev = detect_events(signal, win_len1, win_len2)
            with open(ed_path, "wt") as f:
                for s, ln, m, sd in ev:
                    f.write(f"{int(s)}\t{int(ln)}\t{m:.6f}\t{sd:.6f}\n")


def train_val_test_split(
    data: Sequence,
    train_size: float = 0.8,
    val_size: float = 0.1,
    test_size: float = 0.1,
    random_state: Optional[int] = None,
    shuffle: bool = True,
) -> Tuple[Optional[list], Optional[list], Optional[list]]:
    """Fractional split (reference: utils.py:45-69)."""
    if abs(train_size + val_size + test_size - 1.0) > 1e-9:
        raise ValueError("Train/validation/test dataset fractions don't sum up to 1.")
    items = list(data)
    if shuffle:
        rng = np.random.default_rng(random_state)
        idx = rng.permutation(len(items))
        items = [items[i] for i in idx]
    n = len(items)
    n_train = int(round(train_size * n))
    n_val = int(round(val_size * n))
    train = items[:n_train] or None
    val = items[n_train : n_train + n_val] or None
    test = items[n_train + n_val :] or None
    return train, val, test
