"""Split one read's decode into its legs, and trace the bench's pipelined path.

Counterpart of tools/profile_decode.py of the JAX package. One simulated read
goes through the engine with bench.py's settings (bf16 encoder stream, 4-bit
probabilities; memory, wire and beam kernel from the options), and its
``predict_beam_compact`` (or, with ``--wire sigdev|sigdev8``,
``predict_beam_signal``) is split into legs:

- host pack + unpack: the host half of each chunk's upload (``upload_chunk``
  up to the return of ``_upload``: slicing, quantization, the pinned buffer's
  fill, the copy's enqueue), and ``collect_beam_compact`` on finished copies;
  on the signal-only wire ``signal_buffer`` and the same unpack;
- H2D upload: each chunk's wire buffer copied from pinned memory;
- device compute on resident inputs: the wire's unpack and the snippet
  gather on the uploaded buffer, then ``memory`` + ``beam`` + ``_pack`` on the
  gathered snippets (``_enqueue``); on the signal-only wire the segmentation
  (``_segment_batch``) and the same decode;
- D2H fetch: each chunk's packed result copied to pinned memory (and on the
  signal-only wire the meta and the snippet ranges);
- the sum of the legs, and end to end, which is what the evaluators'
  ``t_predicting`` measures (the card overlaps legs the sum adds up).

The signal-only wire also splits one dispatch as the pipelined evaluator
runs it: ``begin_beam_signal`` (upload + segmentation enqueued), the wait for
the meta, and ``finish_beam_signal`` + ``collect_beam_compact``.

Device legs are timed with CUDA events, host legs with the host clock, each
the best of ``--repeats`` runs; on ``--cpu`` every leg is host time. The tool
wraps the engine's methods from the outside for a run and restores them; it
changes nothing in the engine.

``--trace DIR`` (card only) runs ``torch.profiler`` (CPU and CUDA activities,
every host thread) over one ``PerformanceEvaluator.run_pipelined`` call on
the four reads (8 in flight, 4 finishers), writes the Chrome trace to
``DIR/trace.json`` and prints the device's idle share in the run's window (1 -
the union of all kernels' and copies' intervals over the window), the ten
device operations that took most time, and the three longest device-idle
gaps, each with the innermost host operation each thread was running at the
gap's middle (the engine's and the evaluator's seams are annotated).

The reads are :func:`simulated_reads`: four reads of 12-18 kb from a 60 kb
random genome, drawn from a seed (chip_smoke.py drives the same reads).

Usage:
  python -m ravvent_tpu_torch.tools.profile_decode [--weights w.npz | --seed 0]
      [--memory bf16|i8|i8mxu|f32] [--transport f16|f32|i8|i8sig|i8dev]
      [--beam-impl step|loop] [--wire compact|sigdev|sigdev8] [--beam 5]
      [--chunk 4096] [--read 0] [--repeats 6] [--trace DIR] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ravvent_tpu_torch.config import MAX_TARGET_LEN, ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.data.snippets import prepare_compact
from ravvent_tpu_torch.evaluation.basecall import SIG_BUCKET, BasecallEngine, resolve_device
from ravvent_tpu_torch.models.basecaller import init_basecaller
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.weights import load_npz

MEMORY = {"bf16": torch.bfloat16, "i8": "i8", "i8mxu": "i8mxu", "f32": None}
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # device work in a Chrome trace
WINDOW = "profile_decode.run_pipelined"
STRIDE = 6


def simulated_reads(seed: int = 0) -> list:
    """4 simulated reads of 12-18 kb from a 60 kb random genome (seeded):
    (raw signal, base ranges, bases) each."""
    rng = np.random.default_rng(seed)
    genome = simulator.random_genome(60_000, rng)
    pore = simulator.PoreModel()
    reads = []
    for _ in range(4):
        n = int(rng.integers(12_000, 18_001))
        s = int(rng.integers(0, len(genome) - n))
        reads.append(simulator.simulate_read(genome[s:s + n], rng, pore) + (genome[s:s + n],))
    return reads


def write_reads(reads: list, d: Path) -> List[str]:
    """The reads as chiron .signal/.label pairs in ``d``; their signal paths."""
    paths = []
    for i, (raw, ranges, seq) in enumerate(reads):
        chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", raw, ranges, seq)
        paths.append(str(d / f"r{i}.signal"))
    return paths


class Span:
    """One interval: device time between two CUDA events on the card, host
    time on the CPU."""

    def __init__(self, device: torch.device) -> None:
        self.cuda = device.type == "cuda"

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def start(self) -> "Span":
        self.a = self._mark()
        return self

    def stop(self) -> "Span":
        self.b = self._mark()
        return self

    def ms(self) -> float:
        if not self.cuda:
            return (self.b - self.a) * 1e3
        self.b.synchronize()
        return self.a.elapsed_time(self.b)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def best(fn: Callable[[], float], repeats: int) -> float:
    return min(fn() for _ in range(max(1, repeats)))


def device_ms(device: torch.device, fn: Callable[[], object], repeats: int) -> float:
    """Best of ``repeats`` device times of ``fn()`` (host time on the CPU)."""
    def once():
        sync(device)
        span = Span(device).start()
        fn()
        return span.stop().ms()
    return best(once, repeats)


def host_ms(device: torch.device, fn: Callable[[], object], repeats: int) -> float:
    """Best of ``repeats`` host times of ``fn()``, the device idle at the start."""
    def once():
        sync(device)
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    return best(once, repeats)


def copy_ms(device: torch.device, nbytes: int, to_device: bool, repeats: int) -> float:
    """One copy of ``nbytes`` between pinned host memory and the device."""
    cuda = device.type == "cuda"
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=cuda)
    dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
    dst, src = (dev, host) if to_device else (host, dev)
    return device_ms(device, lambda: dst.copy_(src, non_blocking=cuda), repeats)


def wire_bytes(parts: dict) -> int:
    """The size of ``BasecallEngine._upload``'s buffer for ``parts``."""
    return sum(-(-a.nbytes // 16) * 16 for a in parts.values())


class Wrapped:
    """Instance-level wrappers of an object's methods, removed on exit."""

    def __init__(self, obj, **wrappers) -> None:
        self.obj, self.wrappers = obj, wrappers

    def __enter__(self):
        for name, make in self.wrappers.items():
            setattr(self.obj, name, make(getattr(self.obj, name)))
        return self

    def __exit__(self, *exc) -> None:
        for name in self.wrappers:
            delattr(self.obj, name)


def prepare(read: tuple) -> tuple:
    """A read's compact form, as the evaluators load it, and its decode
    bound (the widest labelled snippet's tokens): (sig, rr, ev, er, aux, mol)."""
    raw, ranges, seq = read
    sig, rr, ev, er, nuc, aux = prepare_compact(raw, ranges, np.array(list(seq)), STRIDE)
    tok = NUC_TOKENIZER.pad_sequences(NUC_TOKENIZER.texts_to_sequences(nuc), maxlen=MAX_TARGET_LEN)
    return sig, rr, ev, er, aux, int((tok != 0).sum(axis=1).max())


def compact_legs(engine: BasecallEngine, read: tuple, beam: int, repeats: int) -> Dict[str, float]:
    """The legs of one read's ``predict_beam_compact`` (ms)."""
    dev = engine.device
    sig, rr, ev, er, aux, mol = prepare(read)

    def predict():
        return engine.predict_beam_compact(sig, rr, ev, er, mol, beam, aux=aux)

    predict()  # first-use costs
    e2e = host_ms(dev, predict, repeats)

    # one instrumented run: the host pack's time, each chunk's wire bytes,
    # uploaded buffer, snippets and decode arguments
    cap = {"pack": [], "bytes": [], "bufs": [], "enq": []}
    entered = []

    def on_chunk(real):
        def wrapped(*a, **k):
            entered.append(time.perf_counter())
            return real(*a, **k)
        return wrapped

    def on_upload(real):
        def wrapped(parts):
            out = real(parts)
            cap["pack"].append(time.perf_counter() - entered[-1])
            cap["bytes"].append(wire_bytes(parts))
            cap["bufs"].append(out)
            return out
        return wrapped

    def on_enqueue(real):
        def wrapped(*a):
            cap["enq"].append(a)
            return real(*a)
        return wrapped

    def host_pack():
        for v in cap.values():
            v.clear()
        sync(dev)
        with Wrapped(engine, upload_chunk=on_chunk, _upload=on_upload, _enqueue=on_enqueue):
            handle = engine.dispatch_beam_compact(sig, rr, ev, er, mol, beam, aux=aux)
        sync(dev)
        return sum(cap["pack"]) * 1e3, handle

    pack, handle = min((host_pack() for _ in range(max(1, repeats))), key=lambda x: x[0])
    unpack = host_ms(dev, lambda: engine.collect_beam_compact(handle), repeats)
    n, bufs, enq = len(cap["bytes"]), cap["bufs"], cap["enq"]
    up = sum(copy_ms(dev, b, True, repeats) for b in cap["bytes"])

    def unpack_gather():
        # the chunks again, each on its resident uploaded buffer; a span
        # runs from the buffer's hand-over to the gathered snippets
        spans, it = [], iter(bufs)

        def resident(real):
            def wrapped(parts):
                spans.append(Span(dev).start())
                return next(it)
            return wrapped

        sync(dev)
        with Wrapped(engine, _upload=resident):
            for _ in engine.compact_snippets(sig, rr, ev, er, aux):
                spans[-1].stop()
        return sum(s.ms() for s in spans)

    gather = best(unpack_gather, repeats)
    decode = sum(device_ms(dev, lambda a=a: engine._pack(*engine.beam(*a[:4]), a[4]), repeats)
                 for a in enq)
    packed = [engine._pack(*engine.beam(*a[:4]), a[4]) for a in enq]
    fetch = sum(copy_ms(dev, p.numel(), False, repeats) for p in packed)
    legs = {"host pack+unpack": pack + unpack, "H2D upload": up,
            "device compute": gather + decode, "D2H fetch": fetch}
    legs["sum of legs"] = sum(legs.values())
    legs["end-to-end"] = e2e
    legs.update({"  host pack": pack, "  host unpack": unpack,
                 "  device unpack+gather": gather, "  device encode+decode+pack": decode})
    legs["_info"] = {"snippets": int(rr.shape[0]), "max_output_len": mol, "chunks": n,
                     "upload_bytes": int(sum(cap["bytes"])),
                     "fetch_bytes": int(sum(p.numel() for p in packed))}
    return legs


def signal_legs(engine: BasecallEngine, read: tuple, beam: int, repeats: int,
                sig_wire: str = "i16") -> Dict[str, float]:
    """The legs of one read's ``predict_beam_signal`` (ms), decode bound from
    the read's labels as on the compact wire."""
    dev = engine.device
    mol = prepare(read)[5]
    raw = np.asarray(read[0])

    def predict():
        return engine.predict_beam_signal(raw, mol, beam, STRIDE, sig_wire)

    predict()  # first-use costs
    e2e = host_ms(dev, predict, repeats)

    def dispatch():
        sync(dev)
        t0 = time.perf_counter()
        seg = engine.begin_beam_signal(raw, STRIDE, sig_wire)
        t1 = time.perf_counter()
        engine._signal_meta(seg)
        t2 = time.perf_counter()
        engine.collect_beam_compact(engine.finish_beam_signal(seg, mol, beam))
        t3 = time.perf_counter()
        return (t1 - t0) * 1e3, (t2 - t1) * 1e3, (t3 - t2) * 1e3

    splits = [dispatch() for _ in range(max(1, repeats))]
    begin, meta_wait, finish = (min(s[i] for s in splits) for i in range(3))

    S_b = engine._bucket(raw.size, SIG_BUCKET)
    E_b = S_b // 2
    N_max = E_b // STRIDE + 1 + engine.chunk_size
    pack = host_ms(dev, lambda: engine.signal_buffer([raw], S_b, sig_wire), repeats)
    host_buf = engine.signal_buffer([raw], S_b, sig_wire)
    up = copy_ms(dev, host_buf.nbytes, True, repeats)
    buf = engine._upload({"buf": host_buf})["buf"]
    segment = device_ms(dev, lambda: engine._segment_batch(buf, S_b, E_b, N_max, STRIDE,
                                                          sig_wire), repeats)
    seg = engine.begin_beam_signal(raw, STRIDE, sig_wire)
    n_snip = engine._signal_meta(seg)[1]
    T_fetch = engine._fetch_width(mol)
    chunks = [engine.signal_snippets(seg, s, min(s + engine.chunk_size, n_snip))
              for s in range(0, n_snip, engine.chunk_size)]
    decode = sum(device_ms(dev, lambda c=c: engine._pack(*engine.beam(*c, mol - 1, beam), T_fetch),
                           repeats) for c in chunks)
    packed = [engine._pack(*engine.beam(*c, mol - 1, beam), T_fetch) for c in chunks]
    # the meta, the snippet ranges and the results
    fetch = (copy_ms(dev, 8, False, repeats) + copy_ms(dev, 8 * N_max, False, repeats)
             + sum(copy_ms(dev, p.numel(), False, repeats) for p in packed))
    handle = engine.finish_beam_signal(seg, mol, beam)
    sync(dev)
    unpack = host_ms(dev, lambda: engine.collect_beam_compact(handle), repeats)
    legs = {"host pack+unpack": pack + unpack, "H2D upload": up,
            "device compute": segment + decode, "D2H fetch": fetch}
    legs["sum of legs"] = sum(legs.values())
    legs["end-to-end"] = e2e
    legs.update({"  host pack": pack, "  host unpack": unpack,
                 "  device segmentation": segment, "  device encode+decode+pack": decode,
                 "begin_beam_signal": begin, "meta wait": meta_wait,
                 "finish+collect": finish})
    legs["_info"] = {"snippets": int(n_snip), "max_output_len": mol, "chunks": len(chunks),
                     "upload_bytes": int(host_buf.nbytes),
                     "fetch_bytes": int(8 + 8 * N_max + sum(p.numel() for p in packed))}
    return legs


def print_legs(legs: Dict[str, float], title: str) -> None:
    info = legs["_info"]
    print(f"{title}: snippets {info['snippets']}, max_output_len {info['max_output_len']}, "
          f"chunks {info['chunks']}")
    notes = {"H2D upload": f" ({info['upload_bytes']} bytes)",
             "D2H fetch": f" ({info['fetch_bytes']} bytes)",
             "device compute": " (resident inputs)",
             "end-to-end": " (the card overlaps legs the sum adds up)"}
    for k, v in legs.items():
        if k != "_info":
            print(f"  {k:28s}: {v:9.3f} ms{notes.get(k, '')}")


# ------------------------------------------------------------------ trace

def _union(intervals: list) -> list:
    """Sorted, merged [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_summary(trace: dict, thread: Optional[int] = None, top: int = 10, gaps: int = 3
                  ) -> dict:
    """The device's idle share, top device operations and longest idle
    gaps of a Chrome trace from ``torch.profiler``, inside the window of
    the ``WINDOW`` annotation (times in ms). Each gap names the innermost
    host operation of every thread at its middle, and the annotated seams
    of ``thread`` (the dispatching one; any thread when None) that ended
    last before it and start first after it."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    if not window:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    busy = _union([(max(w0, a), min(w1, b)) for a, b in spans if a < w1 and b > w0])
    busy_us = sum(b - a for a, b in busy)
    by_name: Dict[str, list] = {}
    for e in device:
        s = by_name.setdefault(e["name"], [0, 0.0])
        s[0] += 1
        s[1] += float(e["dur"])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    holes = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                    for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    host = [e for e in events if e.get("cat") in ("cpu_op", "user_annotation")
            and e["name"] != WINDOW]
    seams = [e for e in host if e["cat"] == "user_annotation"
             and (thread is None or e["tid"] == thread)]
    gap_list = []
    for length, a, b in holes[:gaps]:
        mid = (a + b) / 2
        running = {}  # thread -> innermost host op at the gap's middle
        for e in host:
            t0, d = float(e["ts"]), float(e["dur"])
            if t0 <= mid <= t0 + d and (e["tid"] not in running or d < running[e["tid"]][1]):
                running[e["tid"]] = (e["name"], d)
        # the annotated seams on either side of the gap's middle
        ended = [e for e in seams if float(e["ts"]) + float(e["dur"]) <= mid]
        later = [e for e in seams if float(e["ts"]) >= mid]
        gap_list.append({
            "ms": length / 1e3, "start_ms": (a - w0) / 1e3,
            "host": {str(t): n for t, (n, _) in running.items()},
            "after": max(ended, key=lambda e: float(e["ts"]) + float(e["dur"]))["name"]
            if ended else None,
            "before": min(later, key=lambda e: float(e["ts"]))["name"] if later else None})
    return {"window_ms": (w1 - w0) / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_events": len(device),
            "idle_share": 1.0 - busy_us / (w1 - w0) if w1 > w0 else float("nan"),
            "top_ops": [{"name": n, "count": c, "ms": d / 1e3} for n, (c, d) in ops],
            "gaps": gap_list}


def _annotated(name: str):
    def make(real):
        def wrapped(*a, **k):
            with torch.profiler.record_function(name):
                return real(*a, **k)
        return wrapped
    return make


ENGINE_SEAMS = ("upload_chunk", "_enqueue", "dispatch_beam_compact", "collect_beam_compact",
                "begin_beam_signal_batch", "finish_beam_signal", "signal_ranges")


def trace_pipelined(engine: BasecallEngine, paths: List[str], out_dir, wire: str = "compact",
                    beam: int = 5, cache_dir: Optional[str] = None) -> dict:
    """``torch.profiler`` over one ``run_pipelined`` call (8 in flight, 4
    finishers) after a warm-up one and an untraced one (the profiler's
    cost); writes ``out_dir/trace.json`` and returns :func:`trace_summary`
    with both runs' records. An engine on the CPU gives a trace of host
    operations only."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator

    cuda = engine.device.type == "cuda"
    pe = PerformanceEvaluator(engine, beam_width=beam, cache_dir=cache_dir, wire=wire)
    pe.run_pipelined(paths, inflight=8, finishers=4)  # warm-up; fills the read cache
    untraced = pe.run_pipelined(paths, inflight=8, finishers=4)
    sync(engine.device)
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except TypeError:  # an older torch: the host ops of the profiling thread only
        config = None
    seams = {n: _annotated(f"engine.{n}") for n in ENGINE_SEAMS}
    with Wrapped(engine, **seams), Wrapped(pe, _load=_annotated("evaluator._load")), \
            Wrapped(pe.merger, merge_flat=_annotated("merger.merge_flat")):
        with profile(activities=[ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda,
                     experimental_config=config) as prof:
            with record_function(WINDOW):
                rec = pe.run_pipelined(paths, inflight=8, finishers=4)
            sync(engine.device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(out / "trace.json"))
    tid = threading.get_native_id()
    summary = trace_summary(json.loads((out / "trace.json").read_text()), thread=tid)
    summary["record"], summary["untraced"] = rec, untraced
    summary["dispatching_thread"] = tid
    return summary


def print_trace(summary: dict) -> None:
    rec = summary["record"]
    for name, r in (("untraced", summary["untraced"]), ("traced", rec)):
        print(f"run_pipelined {name} ({r['wire']}, {r['reads']} reads, 8 in flight, 4 "
              f"finishers): {r['bases_per_s']:.1f} bases/s, wall {r['wall_s']:.4f} s, stages "
              f"{r['stages_s']}")
    print(f"  window {summary['window_ms']:.3f} ms, device busy {summary['device_busy_ms']:.3f} ms "
          f"({summary['device_events']} kernels and copies): idle share "
          f"{summary['idle_share']:.4f}")
    print("  top device operations (count, ms):")
    for op in summary["top_ops"]:
        print(f"    {op['ms']:9.3f} ms {op['count']:6d}x  {op['name'][:90]}")
    print(f"  longest device-idle gaps (dispatching thread {summary['dispatching_thread']}):")
    for g in summary["gaps"]:
        host = "; ".join(f"thread {t}: {n}" for t, n in g["host"].items()) or "no torch op"
        print(f"    {g['ms']:9.3f} ms at {g['start_ms']:.3f} ms: {host} (after {g['after']}, "
              f"before {g['before']})")


def build_engine(args, device) -> BasecallEngine:
    cfg = ModelConfig(enc_units=args.enc_units, dec_units=args.dec_units,
                      encoder_depth=args.encoder_depth, decoder_depth=1)
    if args.weights:
        params = load_npz(args.weights)
    else:
        params = init_basecaller(cfg, torch.Generator().manual_seed(args.seed))
    return BasecallEngine(params, cfg, chunk_size=args.chunk, memory_dtype=MEMORY[args.memory],
                          beam_impl=args.beam_impl, encoder_dtype=torch.bfloat16, pack_u8=True,
                          transport_dtype=args.transport, prob_bits=4, device=device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--weights", help="npz of the JAX parameter tree (ravvent_tpu_torch.weights)")
    src.add_argument("--seed", type=int, default=0, help="seeded random weights (no --weights)")
    ap.add_argument("--memory", default="bf16", choices=list(MEMORY))
    ap.add_argument("--transport", default="i8dev", choices=["f16", "f32", "i8", "i8sig", "i8dev"])
    ap.add_argument("--beam-impl", default="step", choices=["step", "loop"])
    ap.add_argument("--wire", default="compact", choices=["compact", "sigdev", "sigdev8"])
    ap.add_argument("--beam", type=int, default=5)
    ap.add_argument("--chunk", type=int, default=4096)
    ap.add_argument("--read", type=int, default=0, choices=range(4))
    ap.add_argument("--repeats", type=int, default=6)
    ap.add_argument("--trace", help="directory for one torch.profiler trace of run_pipelined")
    ap.add_argument("--enc-units", type=int, default=128)
    ap.add_argument("--dec-units", type=int, default=128)
    ap.add_argument("--encoder-depth", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    engine = build_engine(args, device)
    reads = simulated_reads(0)
    where = (f"{torch.cuda.get_device_name(0)}" if device.type == "cuda"
             else "CPU (host times only)")
    print(f"read {args.read} of 4, wire {args.wire}, transport {args.transport}, memory "
          f"{args.memory}, beam {args.beam} ({args.beam_impl}), chunk {args.chunk}; {where}")
    if args.wire == "compact":
        legs = compact_legs(engine, reads[args.read], args.beam, args.repeats)
    else:
        legs = signal_legs(engine, reads[args.read], args.beam, args.repeats,
                           "u8" if args.wire == "sigdev8" else "i16")
    print_legs(legs, f"legs, best of {args.repeats}")
    if args.trace and device.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            paths = write_reads(reads, Path(tmp))
            summary = trace_pipelined(engine, paths, args.trace, args.wire, args.beam,
                                      cache_dir=str(Path(tmp) / "cache"))
        print_trace(summary)
        print(f"trace written to {Path(args.trace) / 'trace.json'}")
    elif args.trace:
        print("trace skipped: the profiler's trace measures the card (--cpu)")


if __name__ == "__main__":
    main()
