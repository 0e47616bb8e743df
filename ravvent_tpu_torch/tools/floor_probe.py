"""Split the bench pipeline's wall into the device's floor and the host's, on
the GPU.

Counterpart of the repo root's tools/floor_probe.py, which runs the JAX
package. On the bench's stream reads (tools/bench.py:ensure_dataset, the
first ``--reads`` of the 12, in ``--data-dir``) and the bench's engine
(tools/bench.py:bench_engine), warmed by one pipelined pass, each pass the
fastest of 3:

- link probes: ``link_rtt_ms``, the round trip of an 8-byte host-to-device
  copy read back; ``upload_MBps``, a 4 MB upload from pinned memory timed
  around ``torch.cuda.synchronize``. Both null on the CPU;
- pass A, the production pipeline: ``run_pipelined(inflight=8,
  finishers=4)``, its wall, bases/s and stage seconds;
- pass B, load and dispatch only: every read loaded and dispatched
  (``PerformanceEvaluator._dispatch_compact``), then a wait on each of its
  chunks' copy events, with no postprocessing or merge: what the device
  must do, the copies overlapped (the device stream's floor);
- pass C, host work only: the postprocessing (``flatten_calls``) and the
  merge fold (``merge_snippets``, with the positional prior of the reads'
  raw ranges) over decodes collected beforehand (the host's floor).

If A's wall is near B's, the pipeline is device-bound and the finishers'
``collect_wait`` is time spent waiting on the device; if it is near C's (or
above both), the host bounds it. Then the signal-only wire (``sigdev``):
its pipeline (pass S) and the split of a read's dispatch into
``begin_beam_signal`` (upload and segmentation enqueued) and
``finish_beam_signal`` (the meta's wait, the snippets' plan and enqueue),
every read begun before the first is finished, as the pipeline lags one
read, with the chunks ("slabs") a read takes.

The model is the flagship on ``--weights`` or weights seeded from
``--seed``. Runs on the first CUDA device unless ``--cpu`` or
``--device``. Prints the result as ONE JSON line last and returns it; it
writes a file only where ``--out`` names one.

  python -m ravvent_tpu_torch.tools.floor_probe [--reads 12] [--beam 5]
      [--chunk 4096] [--weights w.npz | --seed 0] [--data-dir DIR] [--out PATH]
      [--cpu | --device DEV]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from timeit import default_timer as timer
from typing import List, Optional, Tuple

import numpy as np
import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.evaluation.performance import (
    PerformanceEvaluator, flatten_calls, merge_snippets,
)
from ravvent_tpu_torch.tools import bench
from ravvent_tpu_torch.tools.common import add_bench_flags, stream_paths, tool_device

PIPE_KEYS = ("wall_s", "bases_per_s", "stages_s", "bases_num")


def link_probes(device: torch.device, reps: int = 10) -> Tuple[Optional[float], Optional[float]]:
    """(round trip of an 8-byte upload read back, ms; a 4 MB pinned
    upload's MB/s), or (None, None) off the card."""
    if device.type != "cuda":
        return None, None
    small = torch.zeros(8, dtype=torch.uint8)
    for _ in range(3):
        small.to(device).cpu()
    t0 = timer()
    for _ in range(reps):
        small.to(device).cpu()
    rtt = (timer() - t0) / reps
    big = torch.zeros(1 << 22, dtype=torch.uint8).pin_memory()
    big.to(device, non_blocking=True)
    torch.cuda.synchronize(device)
    t0 = timer()
    for _ in range(3):
        big.to(device, non_blocking=True)
    torch.cuda.synchronize(device)
    return round(rtt * 1e3, 4), round(3 * big.numel() / (timer() - t0) / 1e6, 1)


def wait_chunks(handle) -> None:
    """Wait on every chunk's copy of a dispatched read (its CUDA event; on
    the CPU the copy is done when dispatched)."""
    for _, done, _ in handle.pending:
        if done is not None:
            done.synchronize()


def device_pass(pe: PerformanceEvaluator, stream) -> float:
    """Pass B: load and dispatch every read, then wait on each one's
    chunks; no postprocessing, no merge. Returns the wall in seconds."""
    t0 = timer()
    handles = [pe._dispatch_compact(p) for p in stream]
    for h in handles:
        wait_chunks(h)
    return timer() - t0


def collect_decodes(pe: PerformanceEvaluator, stream) -> List[tuple]:
    """Each read's (tokens, probs, raw ranges), decoded and collected before
    pass C."""
    out = []
    for p in stream:
        tokens, probs = pe.engine.collect_beam_compact(pe._dispatch_compact(p))
        out.append((tokens, probs, pe._load(p)[1]))
    return out


def host_pass(pe: PerformanceEvaluator, decodes) -> Tuple[float, list]:
    """Pass C: postprocessing and the merge fold over collected decodes.
    Returns (wall in seconds, the merged reads; None for a read of no
    snippet)."""
    t0 = timer()
    merged = [merge_snippets(pe.merger, *flatten_calls(tokens, probs), rr)
              if len(tokens) else None for tokens, probs, rr in decodes]
    return timer() - t0, merged


def sigdev_split(engine, pes: PerformanceEvaluator, stream, beam_width: int) -> dict:
    """Each read's begin_beam_signal and finish_beam_signal, every read begun
    before the first is finished; the chunks a read takes."""
    begin_t, finish_t, slabs, segs = [], [], [], []
    for p in stream:
        raw = chiron.load_signal(p)
        t0 = timer()
        segs.append(engine.begin_beam_signal(raw, stride=pes.stride, sig_wire=pes.sig_wire))
        begin_t.append(timer() - t0)
    for seg in segs:
        t0 = timer()
        h = engine.finish_beam_signal(seg, beam_width=beam_width)
        finish_t.append(timer() - t0)
        if h is not None:
            slabs.append(len(h.pending))
            wait_chunks(h)
    return {"sigdev_begin_ms_per_read": round(1e3 * float(np.mean(begin_t)), 4),
            "sigdev_finish_ms_per_read": round(1e3 * float(np.mean(finish_t)), 4),
            "sigdev_slabs_per_read": round(float(np.mean(slabs)), 2) if slabs else None}


def run_probe(data_dir, reads: int = 12, passes: int = 3, beam_width: int = 5,
              chunk_size: int = 4096, device=None, weights: Optional[str] = None, seed: int = 0,
              cfg: Optional[ModelConfig] = None, params=None, settings: Optional[dict] = None,
              n_reads: int = bench.N_READS, n_stream_reads: int = bench.N_STREAM_READS,
              read_len: Tuple[int, int] = bench.READ_LEN) -> dict:
    """The probes and passes of the module's docstring. ``settings``
    overrides the bench's engine settings; ``cfg`` and ``params`` the
    flagship and its weights."""
    device = resolve_device(device)
    data_dir = Path(data_dir)
    _, fi_stream = bench.ensure_dataset(data_dir, n_reads, n_stream_reads, read_len)
    stream = stream_paths(fi_stream)[:reads]
    cfg = cfg or bench.FLAGSHIP
    params, _ = bench.model_params(cfg, params, weights, seed)
    engine = bench.bench_engine(params, cfg, device, chunk_size, **(settings or {}))
    out = {"device": bench.device_line(device), "reads": len(stream)}
    out["link_rtt_ms"], out["upload_MBps"] = link_probes(device)

    cache = str(data_dir / "cache")
    pe = PerformanceEvaluator(engine, beam_width=beam_width, cache_dir=cache)
    pe.run_pipelined(stream, inflight=8, finishers=4)  # warm: build, caches
    rec = min((pe.run_pipelined(stream, inflight=8, finishers=4) for _ in range(passes)),
              key=lambda r: r["wall_s"])
    out["A_pipeline"] = {k: rec[k] for k in PIPE_KEYS}

    device_pass(pe, stream)
    out["B_device_stream_wall_s"] = round(min(device_pass(pe, stream)
                                              for _ in range(passes)), 4)

    decodes = collect_decodes(pe, stream)
    host_pass(pe, decodes)
    out["C_host_work_s"] = round(min(host_pass(pe, decodes)[0] for _ in range(passes)), 4)

    pes = PerformanceEvaluator(engine, beam_width=beam_width, cache_dir=cache, wire="sigdev")
    pes.run_pipelined(stream, inflight=8, finishers=4)
    rec = min((pes.run_pipelined(stream, inflight=8, finishers=4) for _ in range(passes)),
              key=lambda r: r["wall_s"])
    out["S_sigdev_pipeline"] = {k: rec[k] for k in PIPE_KEYS}
    out.update(sigdev_split(engine, pes, stream, beam_width))
    return out


def main(argv=None) -> dict:
    """Run the probe; returns the printed object."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=12, help="stream reads probed (of 12)")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--out", default=None, help="also write the JSON there")
    add_bench_flags(ap, bench.DATA_DIR)
    args = ap.parse_args(argv)
    out = run_probe(args.data_dir, args.reads, beam_width=args.beam, chunk_size=args.chunk,
                    device=tool_device(args), weights=args.weights, seed=args.seed)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
