"""Batch generation for training/eval (a copy of ravvent_tpu/data/generator.py).

Reproduces the reference generator's epoch semantics
(reference: data_loader.py:180-257):

- an epoch plan is shuffled files x shuffled within-file batch-start offsets;
- batches never cross file boundaries; each file's tail
  ``snippets_num % batch_size`` snippets are dropped;
- reshuffling between epochs re-seeds the RNG with ``initial_seed + epoch``;
- ``size_scaler`` truncates the (unshuffled) file list.

Unlike the reference — which re-runs the full preprocessing (including event
detection) on every file visit of every epoch and caches only the most recent
file — this generator uses the on-disk snippet cache plus a background
prefetch thread, so the device never waits on host preprocessing.
"""

from __future__ import annotations

import json
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ravvent_tpu_torch.config import DataConfig, MAX_TARGET_LEN
from ravvent_tpu_torch.data.snippets import load_read_snippets

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (raw, event, nuc)


class SnippetBatchGenerator:
    def __init__(
        self,
        files_info_path: str,
        stride: int,
        batch_size: int = 128,
        shuffle: bool = True,
        initial_random_seed: int = 0,
        size_scaler: float = 1.0,
        max_target_len: Optional[int] = MAX_TARGET_LEN,
        cache_dir: Optional[str] = ".snippet_cache",
        prefetch: int = 2,
    ) -> None:
        self.batch_size = batch_size
        self.stride = stride
        self.shuffle = shuffle
        self.random_seed = initial_random_seed
        self.size_scaler = size_scaler
        self.max_target_len = max_target_len
        self.cache_dir = cache_dir
        self.prefetch = prefetch

        with open(files_info_path, "r") as f:
            self.files_info = json.load(f)

        self.rng = np.random.default_rng(self.random_seed)
        self._last_file_id: Optional[int] = None
        self._file_data: Optional[Batch] = None
        self.fetch_ids = self._compute_new_fetch_ids()

    @classmethod
    def from_config(cls, files_info_path: str, cfg: DataConfig, **kw) -> "SnippetBatchGenerator":
        return cls(
            files_info_path,
            stride=cfg.stride,
            batch_size=cfg.batch_size,
            shuffle=cfg.shuffle,
            initial_random_seed=cfg.initial_random_seed,
            size_scaler=cfg.size_scaler,
            max_target_len=cfg.max_target_len,
            prefetch=cfg.prefetch,
            **kw,
        )

    # --- epoch plan (reference: data_loader.py:207-228) ---
    def _compute_new_fetch_ids(self) -> np.ndarray:
        files_ids = np.arange(len(self.files_info))
        if self.size_scaler < 1:
            files_ids = files_ids[0 : int(self.size_scaler * len(files_ids))]
        if self.shuffle:
            self.rng.shuffle(files_ids)
        fetch_ids: List[Tuple[int, int, int]] = []
        for f_id in files_ids:
            snippets_num = self.files_info[f_id]["snippets_num"]
            batches_num = snippets_num // self.batch_size
            start_ids = np.arange(0, self.batch_size * batches_num, self.batch_size)
            if self.shuffle:
                self.rng.shuffle(start_ids)
            fetch_ids.extend((f_id, s, s + self.batch_size) for s in start_ids)
        return np.array(fetch_ids, dtype=np.int64).reshape(-1, 3)

    def _load_file(self, f_id: int) -> Batch:
        info = self.files_info[f_id]
        return load_read_snippets(
            info["signal_path"],
            info["label_path"],
            self.stride,
            max_target_len=self.max_target_len,
            cache_dir=self.cache_dir,
        )

    def __len__(self) -> int:
        return len(self.fetch_ids)

    def __getitem__(self, index: int) -> Batch:
        f_id, s, e = (int(v) for v in self.fetch_ids[index])
        if f_id != self._last_file_id:
            self._file_data = self._load_file(f_id)
            self._last_file_id = f_id
        raw, event, nuc = self._file_data
        return raw[s:e], event[s:e], nuc[s:e]

    def on_epoch_end(self) -> None:
        if self.shuffle:
            self.random_seed += 1
            self.rng = np.random.default_rng(self.random_seed)
            self.fetch_ids = self._compute_new_fetch_ids()

    # --- prefetching epoch iterator (not in the reference) ---
    def epoch(self, start: int = 0) -> Iterator[Batch]:
        """Iterate one epoch with background prefetch, from batch ``start``
        of the plan, then advance the plan."""
        if self.prefetch <= 0:
            for i in range(start, len(self)):
                yield self[i]
            self.on_epoch_end()
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        n = len(self)
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer() -> None:
            try:
                for i in range(start, n):
                    if stop.is_set() or not _put(("ok", self[i])):
                        return
            except Exception as exc:  # pragma: no cover
                _put(("err", exc))
            finally:
                _put(("done", None))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                kind, item = q.get()
                if kind == "ok":
                    yield item
                elif kind == "err":
                    raise item
                else:
                    break
            self.on_epoch_end()
        finally:
            # Unblock the producer if the consumer abandons the epoch early
            # (e.g. steps() reached its budget mid-epoch).
            stop.set()
            t.join(timeout=5)

    def _stream(self, start: int = 0) -> Iterator[Batch]:
        while True:
            yield from self.epoch(start)
            start = 0

    def skip(self, num_steps: int) -> None:
        """Start the :meth:`steps` stream ``num_steps`` batches in, as if
        they had been drawn (the plans' reshuffles included), loading none:
        a resumed run then draws the batches the uninterrupted run drew
        after them. Call it before the first :meth:`steps`."""
        if getattr(self, "_steps_stream", None) is not None:
            raise RuntimeError("skip() starts the stream: call it before steps()")
        if num_steps and not len(self):
            raise ValueError("the index makes no batch to skip")
        while num_steps and num_steps >= len(self):
            num_steps -= len(self)
            self.on_epoch_end()
        self._steps_stream = self._stream(num_steps)

    def steps(self, num_steps: int) -> Iterator[Batch]:
        """Yield exactly ``num_steps`` batches from a PERSISTENT stream that
        cycles epoch plans (reshuffling at each true plan boundary).

        The cursor survives across calls: successive ``steps()`` calls (one
        per trainer epoch) continue through the full epoch plan instead of
        restarting it, so every file is visited even when ``steps_per_epoch``
        is smaller than the plan. (A pre-round-3 bug restarted the plan from
        batch 0 on every call WITHOUT reshuffling, silently training on only
        the first ``steps_per_epoch`` batches of a fixed plan — the reference
        generator reshuffles between keras epochs, data_loader.py:251-257, so
        its truncated epochs still cover all files over time.)"""
        if getattr(self, "_steps_stream", None) is None:
            self._steps_stream = self._stream()
        for _ in range(num_steps):
            yield next(self._steps_stream)
