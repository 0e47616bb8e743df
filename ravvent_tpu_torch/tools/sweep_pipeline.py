"""Sweep the read pipeline's depth (reads in flight, finisher threads, the
stream's length) on the bench's reads, and report each configuration's
steady-state throughput, on the GPU.

Counterpart of the repo root's tools/sweep_pipeline.py, which runs the JAX
package. ``PerformanceEvaluator.run_pipelined`` runs at each
``inflight:finishers`` pair of ``--configs`` over the bench's 12 distinct
stream reads repeated ``--mults`` times (tools/bench.py:ensure_dataset, in
``--data-dir``), on the bench's engine (tools/bench.py:bench_engine: i8dev
wire, bf16 memory and encoder stream, 4-bit probabilities, beam 5,
``beam_impl="step"``, chunks of 4096 rows), warmed as the bench warms it.
A configuration's figure is its fastest pass by wall time of ``--passes``:
the minimum of bases/s would pick the slowest pass. Compare configurations
within one process; the wall of another process varies with the host's
load. The model is the flagship on ``--weights`` (an npz of the JAX
parameter tree) or weights seeded from ``--seed``. Runs on the first CUDA
device unless ``--cpu`` or ``--device``; without a card it raises.

Prints one line a configuration, then ONE JSON line last:
  {"metric": "pipeline depth sweep", "rows": [{"reads": N, "inflight": N,
   "finishers": N, "bases_per_s": x, "bases_num": N, "wall_s": x}, ...],
   "device": "<name>, <power limit>"}

  python -m ravvent_tpu_torch.tools.sweep_pipeline [--configs 3:2,4:3,6:4,8:4]
      [--mults 1,3] [--passes 3] [--beam 5] [--weights w.npz | --seed 0]
      [--data-dir DIR] [--cpu | --device DEV]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.basecall import resolve_device
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from ravvent_tpu_torch.tools import bench
from ravvent_tpu_torch.tools.common import add_bench_flags, stream_paths, tool_device

METRIC = "pipeline depth sweep"


def run_sweep(data_dir, configs: Sequence[Tuple[int, int]], mults: Sequence[int], passes: int,
              beam_width: int = 5, device=None, weights: Optional[str] = None, seed: int = 0,
              cfg: Optional[ModelConfig] = None, params=None, settings: Optional[dict] = None,
              chunk_size: int = 4096, n_reads: int = bench.N_READS,
              n_stream_reads: int = bench.N_STREAM_READS,
              read_len: Tuple[int, int] = bench.READ_LEN) -> dict:
    """The sweep's rows, fastest pass by wall of each (stream length,
    configuration). ``settings`` overrides the bench's engine settings
    (tools/bench.py:bench_engine's keywords); ``cfg`` and ``params`` the
    flagship and its weights."""
    device = resolve_device(device)
    data_dir = Path(data_dir)
    _, fi_stream = bench.ensure_dataset(data_dir, n_reads, n_stream_reads, read_len)
    cfg = cfg or bench.FLAGSHIP
    params, _ = bench.model_params(cfg, params, weights, seed)
    settings = dict(settings or {})
    engine = bench.bench_engine(params, cfg, device, chunk_size, **settings)
    bench.warm_up(engine, chunk_size, beam_width, settings.get("transport", "i8dev"))
    pe = PerformanceEvaluator(engine, beam_width=beam_width, cache_dir=str(data_dir / "cache"))
    paths = stream_paths(fi_stream)
    rows = []
    for mult in mults:
        stream = paths * mult
        for inflight, finishers in configs:
            best = min((pe.run_pipelined(stream, inflight=inflight, finishers=finishers)
                        for _ in range(passes)), key=lambda r: r["wall_s"])
            rows.append({"reads": len(stream), "inflight": inflight, "finishers": finishers,
                         "bases_per_s": round(best["bases_per_s"], 1),
                         "bases_num": best["bases_num"], "wall_s": best["wall_s"]})
            print(f"reads={len(stream)} inflight={inflight} finishers={finishers}: "
                  f"{best['bases_per_s'] / 1e3:8.1f}k bases/s", flush=True)
    return {"metric": METRIC, "rows": rows, "device": bench.device_line(device)}


def main(argv=None) -> dict:
    """Run the sweep; returns the last line's object."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="3:2,4:3,6:4,8:4",
                    help="comma-separated inflight:finishers pairs")
    ap.add_argument("--mults", default="1,3",
                    help="read-stream repetitions of the bench's stream reads")
    ap.add_argument("--passes", type=int, default=3, help="passes a configuration, fastest kept")
    ap.add_argument("--beam", type=int, default=5)
    add_bench_flags(ap, bench.DATA_DIR)
    args = ap.parse_args(argv)
    configs = [tuple(int(x) for x in pair.split(":")) for pair in args.configs.split(",")]
    out = run_sweep(args.data_dir, configs, [int(m) for m in args.mults.split(",")],
                    args.passes, args.beam, tool_device(args), args.weights, args.seed)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
