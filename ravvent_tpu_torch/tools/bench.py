"""The bench's entry point for the port: end-to-end basecalling throughput
(and identity) of the flagship, on the GPU.

Counterpart of the repo root's bench.py, which runs the JAX package. The
protocol is the reference performance evaluator's (reference:
ravvent_performance_evaluator.py): per read, chunked beam-5 prediction,
score -> prob conversion and token -> sequence postprocessing, overlap
merge; throughput is bases over ``total_processing`` (data loading
excluded), over reads (``PerformanceEvaluator.evaluate_files``, each read
the fastest of 5 runs). Then the production number: ``run_pipelined`` over a
stream of 12 distinct reads (8 in flight, 4 finishers) on the compact wire
and on the signal-only wires (``sigdev``: i16 samples, ``sigdev8``: u8
window-quantized samples), the fastest of 3 passes; with ``--cpu``, 1 pass
over 4 stream reads. Unless ``--no-identity``, ``MappingEvaluator`` maps the
4 reads on the three wires.

The engine takes bench.py's settings and flags: beam 5, chunks of 4096
rows, ``beam_impl="step"`` (on the card the beam-step kernels; on the CPU
their plain versions), bf16 memory (``--memory i8|i8mxu|f32``),
pre-projected values, a bf16 encoder stream (the bf16 BiLSTM kernel), the
``i8dev`` wire, 4-bit probabilities. The model is the flagship (``FLAGSHIP``:
BiLSTM encoder of depth 2, LSTM decoder of depth 1 with Luong attention, 128
units each, joint input), as bench.py hard-codes it, on weights from
``--weights`` (an npz of the JAX parameter tree, ravvent_tpu_torch/weights.py)
or seeded from ``--seed``: the port reads no orbax checkpoint.

The reads are bench.py's: its generated 2048-6-mer genome (seed 7), 4 reads
of 12-18 kb (seed 1234) and 12 stream reads (seed 1235) on the ``noisy``
profile, written once into the data directory (``--data-dir``, by default
``.bench_data_torch/`` at the repo's root) and made again when its
``bench_meta.json`` names another profile, genome or size.

Prints ONE JSON line last:
  {"metric": ..., "value": N, "unit": "bases/s", "vs_baseline": N or null,
   "device": "<name>, <power limit>"}
``value`` is the largest of the per-read, the pipelined and the sigdev
rates, as in bench.py. ``vs_baseline`` is its ratio to the port's own CPU
record ``<data-dir>/baseline.json`` (``--cpu --record-baseline`` writes it),
null without one. ``device`` is the card's name and power limit as
``nvidia-smi`` gives them, or ``cpu``. The details (per-read timings, the
pipelined records, identity and its per-read mapping records) go to
``--details`` (by default ``<data-dir>/details.json``). ``--trace DIR``
runs the per-read pass (2 repeats) under ``torch.profiler`` and writes
``DIR/trace.json``. Runs on the first CUDA device unless ``--cpu``; without a
card it raises, with no fall back to the CPU.

  python -m ravvent_tpu_torch.tools.bench [--weights w.npz | --seed 0]
      [--memory bf16|i8|i8mxu|f32] [--beam-impl step|loop|xla] [--no-identity]
      [--data-dir DIR] [--details PATH] [--trace DIR] [--cpu [--record-baseline]]
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine, resolve_device
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from ravvent_tpu_torch.models.basecaller import init_basecaller
from ravvent_tpu_torch.parallel.inference import ShardedBasecallEngine
from ravvent_tpu_torch.tools import profile_decode
from ravvent_tpu_torch.tools.common import stream_paths
from ravvent_tpu_torch.weights import load_npz

REPO = Path(__file__).resolve().parents[2]
DATA_DIR = REPO / ".bench_data_torch"
BASELINE = "baseline.json"
N_READS = 4
N_STREAM_READS = 12
READ_LEN = (12000, 18000)
DATA_SEED = 1234
# the signal realism rung of bench.py's reads (the committed flagship's
# training profile)
BENCH_PROFILE = "noisy"
GENOME_TAG = "generated-2048"
STRIDE = 6
FLAGSHIP = ModelConfig()  # bench.py's model (bench.py:121-124)
MEMORY = {"bf16": torch.bfloat16, "i8": "i8", "i8mxu": "i8mxu", "f32": None}
SIGNAL_WIRES = ("sigdev", "sigdev8")
METRIC = ("basecall throughput (joint flagship, beam 5, pipelined reads, incl. "
          "postproc+merge)")
TRACE_WINDOW = "bench.evaluate_files"


def bench_genome() -> Tuple[str, str]:
    """bench.py's generated genome (its fallback recipe: 43 base 6-mers,
    300 kb, seed 7) and its tag. bench.py prefers the reference's committed
    2048-6-mer eval genome, which lies outside the repo."""
    return simulator.generate_reduced_genome(43, 300_000, np.random.default_rng(7)), \
        GENOME_TAG


def ensure_dataset(data_dir=DATA_DIR, n_reads: int = N_READS,
                   n_stream_reads: int = N_STREAM_READS,
                   read_len: Tuple[int, int] = READ_LEN) -> Tuple[Path, Path]:
    """The bench's reads in ``data_dir``: ``n_reads`` for the per-read pass
    and identity, and ``n_stream_reads`` distinct ones in ``stream/`` for the
    pipelined pass (a repeated read list with a warm cache would flatter
    the pipeline). A directory whose ``bench_meta.json`` names these reads
    (profile, genome, counts and lengths) is used as it is; one made for
    other reads is made again, with its records. Returns the two files-info
    paths."""
    data_dir = Path(data_dir)
    fi = data_dir / f"files_info.snippets.stride_{STRIDE}.json"
    fi_stream = data_dir / "stream" / fi.name
    meta = data_dir / "bench_meta.json"
    want = {"profile": BENCH_PROFILE, "genome": GENOME_TAG,
            "reads": [n_reads, n_stream_reads], "read_len": list(read_len)}
    if meta.exists():
        if fi.exists() and fi_stream.exists() and json.loads(meta.read_text()) == want:
            return fi, fi_stream
        shutil.rmtree(data_dir)  # made for other reads: made again
    genome, tag = bench_genome()
    profile = simulator.PROFILES[BENCH_PROFILE]
    print(f"bench dataset: {tag} genome, {BENCH_PROFILE} profile, {n_reads} + "
          f"{n_stream_reads} reads of {read_len[0]}-{read_len[1]} bases", file=sys.stderr)
    for d, n, seed in ((data_dir, n_reads, DATA_SEED),
                       (data_dir / "stream", n_stream_reads, DATA_SEED + 1)):
        simulator.generate_chiron_dataset(d, genome, n_reads=n, read_len_range=read_len,
                                          seed=seed, profile=profile)
        chiron.create_files_info(d, stride=STRIDE, verbose=False)
    meta.write_text(json.dumps(want))
    return fi, fi_stream


def device_line(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them; ``"cpu"`` on the
    CPU."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        res = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        res = None
    if res is not None and res.returncode == 0 and res.stdout.strip():
        return res.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(device)}, power limit not read (nvidia-smi failed)"


def warm_up(engine: BasecallEngine, chunk_size: int, beam_width: int, transport: str) -> None:
    """One full chunk through the compact path on synthetic inputs (first
    use: the kernels' build, cuBLAS, the native helpers), as bench.py warms
    its compile; the i8dev wire gets a consistent synthetic aux."""
    rng = np.random.default_rng(0)
    sig = rng.normal(size=(chunk_size * 54,)).astype(np.float32)
    ev = rng.normal(size=(chunk_size * 6, 5)).astype(np.float32)
    starts = (np.arange(chunk_size) * 54).astype(np.int64)
    rr = np.stack([starts, starts + 190], axis=1)
    estarts = (np.arange(chunk_size) * 6).astype(np.int64)
    er = np.stack([estarts, estarts + 25], axis=1)
    aux = None
    if transport == "i8dev":
        aux = {"ev_lens": np.full(chunk_size * 6, 9, np.uint16),
               "scaler_mean": np.zeros(5, np.float32), "scaler_std": np.ones(5, np.float32),
               "raw_mean": 0.0, "raw_std": 1.0, "stride": STRIDE, "contiguous": True}
    engine.predict_beam_compact(sig, rr, ev, er, 40, beam_width, aux=aux)


def traced_evaluate(pe: PerformanceEvaluator, fi: Path, out: Path, trace_dir,
                    device: torch.device) -> Tuple[list, dict]:
    """The per-read pass (2 repeats) under ``torch.profiler`` (CPU and, on
    the card, CUDA activities): ``trace_dir/trace.json`` and its summary
    (tools/profile_decode.py:trace_summary: the device's idle share in the
    pass's window and the top device operations)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda) as prof:
        with record_function(TRACE_WINDOW):
            results = pe.evaluate_files(fi, out, verbose=False, repeats=2)
        profile_decode.sync(device)
    path = Path(trace_dir) / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    summary = profile_decode.trace_summary(json.loads(path.read_text()), gaps=0,
                                           window=TRACE_WINDOW)
    print(f"profiler trace written to {path}: window {summary['window_ms']:.3f} ms, device "
          f"busy {summary['device_busy_ms']:.3f} ms, idle share {summary['idle_share']:.4f}",
          file=sys.stderr)
    return results, summary


def model_params(cfg: ModelConfig, params=None, weights: Optional[str] = None,
                 seed: int = 0) -> Tuple[dict, str]:
    """The model's parameters and where they came from: ``params`` (tensors
    in the JAX tree's layout), else ``weights`` (an npz of that tree), else
    weights seeded from ``seed``, with a warning on stderr."""
    if params is not None:
        return params, "the caller's"
    if weights:
        return load_npz(weights), f"npz {weights}"
    print(f"WARNING: no --weights — using random weights from seed {seed}", file=sys.stderr)
    return init_basecaller(cfg, torch.Generator().manual_seed(seed)), f"seed {seed}"


def bench_engine(params, cfg: ModelConfig, device, chunk_size: int = 4096, memory: str = "bf16",
                 project_values: bool = True, beam_impl: str = "step", bf16_encoder: bool = True,
                 pack_u8: bool = True, transport: str = "i8dev", prob_bits: int = 4,
                 mesh=None) -> BasecallEngine:
    """The engine on the bench's settings (bench.py's flags and defaults);
    with a ``mesh`` (parallel/mesh.py) a ``ShardedBasecallEngine`` over it,
    ``device`` unused."""
    kw = dict(chunk_size=chunk_size, memory_dtype=MEMORY[memory],
              project_values=project_values, beam_impl=beam_impl,
              encoder_dtype=torch.bfloat16 if bf16_encoder else None, pack_u8=pack_u8,
              transport_dtype=transport, prob_bits=prob_bits)
    if mesh is not None:
        return ShardedBasecallEngine(params, cfg, mesh, **kw)
    return BasecallEngine(params, cfg, device=device, **kw)


def run_bench(data_dir=DATA_DIR, beam_width: int = 5, chunk_size: int = 4096,
              with_identity: bool = True, memory: str = "bf16", project_values: bool = True,
              beam_impl: str = "step", bf16_encoder: bool = True, pack_u8: bool = True,
              trace_dir: Optional[str] = None, transport: str = "i8dev", prob_bits: int = 4,
              device=None, cfg: Optional[ModelConfig] = None, params=None,
              weights: Optional[str] = None, seed: int = 0, n_reads: int = N_READS,
              n_stream_reads: int = N_STREAM_READS,
              read_len: Tuple[int, int] = READ_LEN) -> dict:
    """The bench's measurements on ``n_reads`` + ``n_stream_reads`` reads of
    ``read_len`` bases in ``data_dir`` (:func:`ensure_dataset`); returns the
    details dict (bench.py's keys, ``device`` the card's name and power
    limit, ``weights`` where they came from). The model is ``cfg``
    (``FLAGSHIP`` by default) with ``params`` (tensors in the JAX tree's
    layout), else with ``weights`` (an npz of that tree), else with weights
    seeded from ``seed``, with a warning on stderr."""
    device = resolve_device(device)
    data_dir = Path(data_dir)
    fi, fi_stream = ensure_dataset(data_dir, n_reads, n_stream_reads, read_len)
    cfg = cfg or FLAGSHIP
    params, source = model_params(cfg, params, weights, seed)
    engine = bench_engine(params, cfg, device, chunk_size, memory, project_values, beam_impl,
                          bf16_encoder, pack_u8, transport, prob_bits)
    warm_up(engine, chunk_size, beam_width, transport)

    cache = str(data_dir / "cache")
    pe = PerformanceEvaluator(engine, beam_width=beam_width, cache_dir=cache)
    trace = None
    if trace_dir:
        results, trace = traced_evaluate(pe, fi, data_dir / "perf_results.json", trace_dir,
                                         device)
    else:
        results = pe.evaluate_files(fi, data_dir / "perf_results.json", verbose=False,
                                    repeats=5)
    bases = sum(r["bases_num"] for r in results)
    t_proc = sum(r["total_processing"] for r in results)

    # pipelined (production) throughput over the stream of distinct reads,
    # the fastest of the passes, on the compact wire and the signal-only ones
    stream = stream_paths(fi_stream)
    cpu = device.type == "cpu"
    passes = 1 if cpu else 3
    if cpu:
        stream = stream[:4]
    pipes = {}
    for wire in ("compact",) + SIGNAL_WIRES:
        pw = pe if wire == "compact" else PerformanceEvaluator(
            engine, beam_width=beam_width, cache_dir=cache, wire=wire)
        pipes[wire] = min((pw.run_pipelined(stream, inflight=8, finishers=4)
                           for _ in range(passes)), key=lambda r: r["wall_s"])

    details = {
        "device": device_line(device),
        "memory": memory,
        "bf16_encoder": bf16_encoder,
        "pack_u8": pack_u8,
        "prob_bits": prob_bits,
        "project_values": project_values,
        "beam_width": beam_width,
        "chunk_size": chunk_size,
        "beam_impl": beam_impl,
        "transport": transport,
        "trained_checkpoint": source.startswith("npz"),
        "weights": source,
        "bases_per_s": bases / t_proc,
        "samples_per_s": sum(r["samples_num"] for r in results) / t_proc,
        "pipeline": pipes["compact"],
        "pipeline_sigdev": pipes["sigdev"],
        "pipeline_sigdev8": pipes["sigdev8"],
        "reads": results,
    }
    if trace is not None:
        details["trace"] = trace

    if with_identity:
        for wire in ("compact",) + SIGNAL_WIRES:
            suffix = "" if wire == "compact" else f"_{wire}"
            out = data_dir / f"map_results{suffix}.json"
            ev = MappingEvaluator(engine, beam_width=beam_width, cache_dir=cache, wire=wire)
            ev.evaluate_files(fi, out, verbose=False)
            total, valid, invalid = ev.compute_total_results(out)
            details[f"identity_total{suffix}"] = total
            details[f"identity_valid{suffix}"] = valid
            details[f"invalid_pct{suffix}"] = invalid
            details[f"map_results{suffix}"] = json.loads(out.read_text())
    return details


def headline(details: dict) -> float:
    """bench.py's headline: the largest of the per-read, the pipelined and
    the sigdev rates."""
    return max(details["bases_per_s"], details["pipeline"]["bases_per_s"],
               details["pipeline_sigdev"]["bases_per_s"])


def main(argv=None) -> dict:
    """Run the bench; returns the last line's object."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--weights", help="npz of the JAX parameter tree (ravvent_tpu_torch.weights)")
    src.add_argument("--seed", type=int, default=0, help="seeded random weights (no --weights)")
    ap.add_argument("--record-baseline", action="store_true",
                    help="store this run's bases/s as the baseline (with --cpu)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--beam-impl", default="step", choices=["xla", "loop", "step"],
                    help="beam decode: the beam-step kernels, the beam-loop kernel, or the "
                         "plain decode")
    ap.add_argument("--no-identity", action="store_true")
    ap.add_argument("--memory", default="bf16", choices=list(MEMORY),
                    help="attention memory storage")
    ap.add_argument("--project-values", action=argparse.BooleanOptionalAction, default=True,
                    help="pre-project attention values (the kernels always do)")
    ap.add_argument("--bf16-encoder", action=argparse.BooleanOptionalAction, default=True,
                    help="run the encoder stream in bf16 (f32 state and accumulation)")
    ap.add_argument("--pack-u8", action=argparse.BooleanOptionalAction, default=True,
                    help="nibble-pack tokens and u8-quantize step probs")
    ap.add_argument("--transport", default="i8dev",
                    choices=["f16", "f32", "i8", "i8sig", "i8dev"],
                    help="wire format of the compact path's inputs")
    ap.add_argument("--prob-bits", type=int, default=4, choices=[8, 4],
                    help="step-prob quantization in the packed fetch")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the per-read pass to DIR/trace.json")
    ap.add_argument("--data-dir", default=str(DATA_DIR), help="the bench's reads and records")
    ap.add_argument("--details", default=None,
                    help="where the details go (default <data-dir>/details.json)")
    args = ap.parse_args(argv)
    if args.record_baseline and not args.cpu:
        ap.error("--record-baseline requires --cpu (the baseline is the CPU run)")

    device = resolve_device("cpu" if args.cpu else None)
    data_dir = Path(args.data_dir)
    details = run_bench(
        data_dir, args.beam, args.chunk, with_identity=not args.no_identity,
        memory=args.memory, project_values=args.project_values, beam_impl=args.beam_impl,
        bf16_encoder=args.bf16_encoder, pack_u8=args.pack_u8, trace_dir=args.trace,
        transport=args.transport, prob_bits=args.prob_bits, device=device,
        weights=args.weights, seed=args.seed)
    details_path = Path(args.details) if args.details else data_dir / "details.json"
    details_path.parent.mkdir(parents=True, exist_ok=True)
    details_path.write_text(json.dumps(details, indent=2))

    value = headline(details)
    baseline_path = data_dir / BASELINE
    if args.record_baseline:
        baseline_path.write_text(json.dumps({
            "bases_per_s": details["bases_per_s"], "device": details["device"],
            "method": "this tool with --cpu (the CPU's plain versions of the kernels)"},
            indent=2))
    baseline = (json.loads(baseline_path.read_text())["bases_per_s"]
                if baseline_path.exists() else None)
    line = {"metric": METRIC, "value": round(value, 1), "unit": "bases/s",
            "vs_baseline": round(value / baseline, 2) if baseline else None,
            "device": details["device"]}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
