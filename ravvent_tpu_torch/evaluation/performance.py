"""Throughput evaluation with the reference's 4-way timing partition.

Counterpart of ravvent_tpu/evaluation/performance.py: per read, wall-clock
timers partition the pipeline into ``t_data_loading`` / ``t_predicting`` /
``t_postprocessing`` / ``t_merge``; throughput is bases (or samples) over
``total_processing`` (prediction + postprocessing + merge, without data
loading). :meth:`PerformanceEvaluator.run_pipelined` overlaps reads (the
main thread loads and dispatches, a pool collects and merges) and gives one
aggregate record, the bench's throughput number; with ``wire="sigdev"`` or
``"sigdev8"`` it sends each read's raw samples only and the device segments
it (BasecallEngine.begin_beam_signal_batch / finish_beam_signal), as the JAX
evaluator does. ``run`` and ``evaluate_files`` stay on the compact wire.
``compute_total_results`` keeps the reference's running cumulative means.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from timeit import default_timer as timer
from typing import Dict, List, Optional

import numpy as np
import torch

from ravvent_tpu_torch.assembly.merger import (
    CONF_GATE_DEFAULT, Merger, confidence_keep_mask, drop_snippet_rows,
    expected_overlaps_from_ranges,
)
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.snippets import load_read_compact_ex
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER


EVALUATOR_WIRES = ("compact", "sigdev", "sigdev8")


def _max_output_len(rr: np.ndarray, nuc: np.ndarray) -> int:
    return int((nuc != 0).sum(axis=1).max()) if rr.shape[0] else 2


def flatten_calls(tokens, probs):
    """A read's snippet tokens [N, T] to one ASCII blob with row offsets;
    each snippet's scores are the first len(seq) probabilities of its row.
    Returns (blob, offsets, flat scores f64)."""
    _, blob, offsets = NUC_TOKENIZER.sequences_to_texts_flat(tokens)
    probs = np.asarray(probs, dtype=np.float64)
    counts = np.diff(offsets)
    prefix = np.arange(probs.shape[1])[None, :] < counts[:, None]
    return blob, offsets, probs[prefix]


def gate_snippets(conf_gate, blob, offsets, flat_probs, rr):
    """The confidence gate (assembly/merger.py:confidence_keep_mask) over the
    flat snippet layout: derailed low-confidence snippets leave before the
    merge fold, with their raw ranges. A no-op when ``conf_gate`` is None
    or nothing trips it."""
    if conf_gate is None or offsets.size <= 2:
        return blob, offsets, flat_probs, rr
    keep = confidence_keep_mask(flat_probs, offsets, *conf_gate)
    if not keep.all():
        blob, offsets, flat_probs = drop_snippet_rows(blob, offsets, flat_probs, keep)
        if rr is not None and rr.shape[0] == keep.shape[0]:
            rr = rr[keep]
    return blob, offsets, flat_probs, rr


def merge_snippets(merger: Merger, blob, offsets, flat_probs, rr):
    """The merge fold, with the positional prior from the snippets' raw
    ranges (none when ``rr`` is None)."""
    eo = (expected_overlaps_from_ranges(rr, np.diff(offsets))
          if rr is not None and rr.shape[0] > 1 else None)
    return merger.merge_flat(blob, offsets, flat_probs, expected_overlaps=eo)


class PerformanceEvaluator:
    def __init__(
        self,
        engine: BasecallEngine,
        merger_scores_id: int = 0,
        stride: int = 6,
        beam_width: int = 5,
        cache_dir: Optional[str] = None,
        wire: str = "compact",
        conf_gate="default",
    ) -> None:
        """``conf_gate``: the confidence gate's parameters (see
        assembly/merger.py:confidence_keep_mask), "default" or None (off).
        ``wire``: "compact", or the signal-only wire for
        :meth:`run_pipelined`: "sigdev" (i16 samples) or "sigdev8" (u8
        window-quantized samples, half the upload, not bit-equal
        boundaries)."""
        if wire not in EVALUATOR_WIRES:
            raise ValueError(f"wire must be one of {EVALUATOR_WIRES}, got {wire!r}")
        self.merger = Merger(scores_id=merger_scores_id)
        # drop derailed low-confidence snippets before the fold, as the
        # identity path does, so the timed work is what production merges
        self.conf_gate = CONF_GATE_DEFAULT if conf_gate == "default" else conf_gate
        self.stride = stride
        self.engine = engine
        self.beam_width = beam_width
        self.cache_dir = cache_dir
        self.wire = wire
        self.sig_wire = "u8" if wire == "sigdev8" else "i16"

    def _load(self, path):
        return load_read_compact_ex(path, Path(path).with_suffix(".label"), self.stride,
                                    cache_dir=self.cache_dir)

    def run(self, signal_data_source, chunk_size: int = 1024) -> Dict:
        """One read, timed stage by stage (``chunk_size`` is the reference's
        argument and unused: the engine has its own)."""
        ranges, syms = chiron.load_label(Path(signal_data_source).with_suffix(".label"))
        samples_num = int(ranges[-1, 1] - ranges[0, 0])

        start = timer()
        sig, rr, ev, er, nuc, aux = self._load(signal_data_source)
        t_data_loading = timer() - start

        t_predicting = t_postprocessing = 0.0
        if rr.shape[0]:
            start = timer()
            tokens, probs = self.engine.predict_beam_compact(
                sig, rr, ev, er, _max_output_len(rr, nuc), self.beam_width, aux=aux)
            t_predicting = timer() - start

            start = timer()
            blob, offsets, flat_probs = flatten_calls(tokens, probs)
            t_postprocessing = timer() - start

        start = timer()
        if rr.shape[0]:
            merge_snippets(self.merger, *gate_snippets(self.conf_gate, blob, offsets, flat_probs,
                                                       rr))
        t_merge = timer() - start

        return {
            "bases_num": len("".join(syms)),
            "samples_num": samples_num,
            "t_data_loading": t_data_loading,
            "t_predicting": t_predicting,
            "t_postprocessing": t_postprocessing,
            "t_merge": t_merge,
            "total": t_data_loading + t_predicting + t_postprocessing + t_merge,
            "total_processing": t_predicting + t_postprocessing + t_merge,
        }

    def _dispatch_compact(self, path):
        sig, rr, ev, er, nuc, aux = self._load(path)
        return self.engine.dispatch_beam_compact(sig, rr, ev, er, _max_output_len(rr, nuc),
                                                 self.beam_width, aux=aux)

    def run_pipelined(self, signal_paths, chunk_size: int = 1024, inflight: int = 8,
                      finishers: int = 4, seg_batch: int = 1) -> Dict:
        """The reads as a pipeline: the main thread loads and dispatches read
        k+1 while read k runs on the device and a pool of ``finishers``
        threads waits on finished reads' copies, postprocesses and merges
        them (the copy wait and the native merge release the GIL).
        ``inflight`` bounds the dispatched reads not yet finished. Returns
        one aggregate record: wall time over all reads, and each stage's
        seconds summed over threads (``collect_wait`` is time blocked on the
        device).

        On the signal-only wire the main thread reads the raw samples,
        segments ``seg_batch`` reads in one upload and one device pass, and
        finishes a segmentation (its meta read, its snippets decoded) only
        once another is queued behind it, so the meta's copy has a read's
        load to arrive in; a read whose segmentation buffer overflows takes
        the compact wire, merged without the gate and the positional prior
        as in the JAX evaluator (ravvent_tpu/evaluation/performance.py:214-233)."""
        bases_num = samples_num = 0
        stages = {"load": 0.0, "dispatch": 0.0, "collect_wait": 0.0, "postproc": 0.0,
                  "merge": 0.0}
        lock = threading.Lock()

        def add_stage(key, dt):
            with lock:
                stages[key] += dt

        def finish(handle, rr):
            # inference mode is per thread: the collect unpacks host bytes
            # only, but keep it off autograd like the dispatching thread
            with torch.inference_mode():
                t0 = timer()
                tokens, probs = self.engine.collect_beam_compact(handle)
                t1 = timer()
                add_stage("collect_wait", t1 - t0)
                if not tokens.shape[0]:
                    return
                blob, offsets, flat_probs = flatten_calls(tokens, probs)
                t2 = timer()
                add_stage("postproc", t2 - t1)
                if rr is not None:
                    blob, offsets, flat_probs, rr = gate_snippets(self.conf_gate, blob, offsets,
                                                                  flat_probs, rr)
                merge_snippets(self.merger, blob, offsets, flat_probs, rr)
                add_stage("merge", timer() - t2)

        start_all = timer()
        pending = deque()
        seg_q = deque()  # segmentations whose meta is still on its way
        raw_q = []  # reads waiting for a batched segmentation

        def finish_seg(seg, path):
            t1 = timer()
            handle = self.engine.finish_beam_signal(seg, beam_width=self.beam_width)
            add_stage("dispatch", timer() - t1)
            if handle is None:  # the segmentation buffer overflowed
                handle = self._dispatch_compact(path)
                pending.append(pool.submit(finish, handle, None))
                return
            pending.append(pool.submit(finish, handle, self.engine.signal_ranges(seg)))

        def segment_queued():
            t1 = timer()
            segs = self.engine.begin_beam_signal_batch([r for r, _ in raw_q], stride=self.stride,
                                                       sig_wire=self.sig_wire)
            stages["dispatch"] += timer() - t1
            seg_q.extend(zip(segs, [p for _, p in raw_q]))
            raw_q.clear()

        with ThreadPoolExecutor(max_workers=max(1, finishers)) as pool:
            for path in signal_paths:
                t0 = timer()
                if self.wire != "compact":
                    raw = chiron.load_signal(path)
                    ranges, _ = chiron.load_label(Path(path).with_suffix(".label"))
                    bases_num += int(ranges.shape[0])
                    samples_num += int(raw.size)
                    stages["load"] += timer() - t0
                    raw_q.append((raw, path))
                    if len(raw_q) >= max(1, seg_batch):
                        segment_queued()
                    while len(seg_q) >= 2:
                        finish_seg(*seg_q.popleft())
                else:
                    sig, rr, ev, er, nuc, aux = self._load(path)
                    bases_num += aux["n_bases"]
                    samples_num += aux["n_samples"]
                    t1 = timer()
                    stages["load"] += t1 - t0
                    handle = self.engine.dispatch_beam_compact(
                        sig, rr, ev, er, _max_output_len(rr, nuc), self.beam_width, aux=aux)
                    stages["dispatch"] += timer() - t1
                    pending.append(pool.submit(finish, handle, rr))
                while len(pending) >= inflight:
                    pending.popleft().result()
            if raw_q:  # the last, partial batch
                segment_queued()
            while seg_q:
                finish_seg(*seg_q.popleft())
            while pending:
                pending.popleft().result()
        wall = timer() - start_all
        return {
            "pipelined": True,
            "wire": self.wire,
            "reads": len(signal_paths),
            "inflight": inflight,
            "finishers": finishers,
            "bases_num": bases_num,
            "samples_num": samples_num,
            "wall_s": wall,
            "bases_per_s": bases_num / wall if wall else 0.0,
            "samples_per_s": samples_num / wall if wall else 0.0,
            "stages_s": {k: round(v, 5) for k, v in stages.items()},
        }

    @staticmethod
    def compute_total_results(results_path) -> tuple:
        """The reference's aggregation (ravvent_performance_evaluator.py:109-131),
        running cumulative means and its std of the signal speeds in the
        second place included."""
        with open(results_path, "rt") as f:
            results = json.load(f)
        bases_num = samples_num = 0
        t_processing = 0.0
        bases_speeds, signals_speeds = [], []
        for res in results:
            bases_num += res["bases_num"]
            samples_num += res["samples_num"]
            t_processing += res["total_processing"]
            bases_speeds.append(bases_num / t_processing)
            signals_speeds.append(samples_num / t_processing)
        return (
            float(np.mean(bases_speeds)),
            float(np.std(signals_speeds)),
            float(np.mean(signals_speeds)),
            float(np.std(signals_speeds)),
        )

    def evaluate_files(self, files_info_path, results_path, verbose: bool = True,
                       repeats: int = 1) -> List[Dict]:
        """Per-read timing over a files-info JSON, the results written to
        ``results_path`` after every read. ``repeats`` runs each read that
        many times and keeps the fastest."""
        with open(files_info_path, "rt") as f:
            val_files = [v["signal_path"] for v in json.load(f)]
        os.makedirs(os.path.dirname(str(results_path)) or ".", exist_ok=True)
        results: List[Dict] = []
        for v in val_files:
            if verbose:
                print(f"Running {v}", flush=True)
            res = min((self.run(v) for _ in range(max(1, repeats))),
                      key=lambda r: r["total_processing"])
            res["path"] = v
            results.append(res)
            with open(results_path, "wt") as f:
                json.dump(results, f, indent=2)
        return results
