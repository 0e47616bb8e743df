"""Where a step of a BiLSTM-layer kernel spends its cycles.

Builds the kernel of one stream a second time with ``-DRV_BILSTM_PHASES``
(``--stream bf16``: ``csrc/bilstm_bf16.cu``, the default; ``--stream
f32``: ``csrc/bilstm.cu``, or past 256 units ``csrc/bilstm_wide.cu``; the
wide bf16 source has no timing build), into the gitignored
``ravvent_tpu_torch/build/``, beside the production library, which it
leaves alone. In that build lane 0 of every warp sums ``clock64()`` cycles
over the phases of each time step that the source names
(``rv_bilstm_phase_names``) and writes its sums when the loop ends. For each
of a chunk's four layer shapes at each of ``--units`` (the flagship's 128
by default; widths of one source: up to 256 units, or on f32 320-512): raw
layers 0 and 1 at T = 200 on F = 1 and 2U, event layers 0 and 1 at T = 30
on F = 5 and 2U; and each batch size it prints the mean cycles per step of
each phase (mean over all warps), the production kernel's time and the
timing build's (CUDA events), and the card's SM clock that the two imply.
Past 256 units (a projection GEMM, then the recurrence over thread-block
clusters) the phases are the recurrence's, its clock implied from its waves
of clusters, and the layer's projection (on F > 16) is given apart: its ms
and its recurrence's (each part launched alone), and the projection's mean
cycles a CTA; ``--configs CxR ...`` also times the production build's
recurrence on each given cluster size C and rows R beside the plan's.
Needs a CUDA device and nvcc.

Usage: python -m ravvent_tpu_torch.tools.bilstm_phases [--stream bf16|f32]
       [--units U [U ...]] [--batch 4096 2858] [--configs 8x32 4x16 ...]
       [--json out.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from ravvent_tpu_torch.ops import cuda_lib, rnn_cuda

# (layer, F of U units, T, seeded state)
SHAPES = (("raw L0", lambda U: 1, 200, False), ("raw L1", lambda U: 2 * U, 200, True),
          ("event L0", lambda U: 5, 30, False), ("event L1", lambda U: 2 * U, 30, True))
# stream: (source, production entry, dtype); past 256 units on f32 the wide
# source, whose entries end in _wide
STREAMS = {"bf16": ("bilstm_bf16.cu", "rv_bilstm_layer_bf16", torch.bfloat16),
           "f32": ("bilstm.cu", "rv_bilstm_layer", torch.float32)}


def stream_source(stream: str, U: int):
    """(source, production entry, dtype) of ``stream`` at U units."""
    source, entry, dtype = STREAMS[stream]
    if U in rnn_cuda.WIDE_UNITS:
        if stream != "f32":
            raise ValueError("bilstm_phases: csrc/bilstm_bf16_wide.cu has no timing build")
        return source.replace(".cu", "_wide.cu"), entry + "_wide", dtype
    return source, entry, dtype


def timing_build(source: str, defines, entry: str, names: str):
    """The timing build of ``csrc/<source>`` (compiled with ``-D`` of each
    of ``defines``) into the build directory: (its ``<entry>_phases`` C
    entry, which takes ``entry``'s arguments and the stamps before the
    stream, the phase names that ``<names>()`` gives, the library)."""
    src = cuda_lib.CSRC / source
    lib = cuda_lib.BUILD / f"lib{src.stem}_phases.so"
    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_lib.nvcc_path(), cuda_lib.ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-Xptxas", "-v"] + [f"-D{d}" for d in defines]
                   + [str(src), "-o", str(lib)], check=True, timeout=600)
    handle = cuda_lib.bind(ctypes.CDLL(str(lib)))
    fn = getattr(handle, entry + "_phases")
    fn.restype = ctypes.c_int
    fn.argtypes = cuda_lib.ENTRIES[entry][:-1] + [ctypes.c_void_p, ctypes.c_void_p]
    getattr(handle, names).restype = ctypes.c_char_p
    return fn, getattr(handle, names)().decode().split(","), handle


def production_registers(source: str) -> str:
    """Build the production library; its ptxas lines (registers, spills) for
    ``source``."""
    log = cuda_lib.build()
    cuda_lib.lib()
    return " ".join(ln.strip() for part in log.split("== ")[1:] if part.startswith(source)
                    for ln in part.splitlines() if "Used" in ln or "spill" in ln)


def smi_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()


def time_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def split(entry, names, dtype, B: int, U: int, F: int, T: int, seeded: bool, seed: int,
          configs=()) -> dict:
    """One layer shape of U units at batch B: phase cycles per step, both
    builds' ms; past 256 units also the recurrence's ms on each (C, R) of
    ``configs``."""
    from ravvent_tpu_torch.models.rnn import init_encoder, stream_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    wx, wh, b = stream_weights(init_encoder(gen, U, 1, F, dev), dtype)[0]
    layout = rnn_cuda.kernel_layout(wx, wh)
    xs = torch.randn(B, T, F, generator=gen).to(dev, dtype)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)).to(dev) if seeded
              else torch.zeros(2, B, U, device=dev) for _ in range(2))
    out = torch.empty(B, T, 2 * U, device=dev, dtype=dtype)
    hN, cN = torch.empty(2, B, U, device=dev), torch.empty(2, B, U, device=dev)
    wide = U in rnn_cuda.WIDE_UNITS
    # room for any grid of >= 16 rows a CTA and <= 32 warps; past 256 units
    # the projection's two counters, then up to 16 warps of every CTA of
    # every cluster (up to 16 CTAs of 16 rows or more)
    rows = (2 * -(-B // 16) * 16 * 16 + 1) if wide else 2 * -(-B // 16) * 32
    stamps = torch.zeros(rows, len(names), dtype=torch.int64, device=dev)
    bufs = rnn_cuda.wide_launch(xs, layout, b, h0, c0) if wide else None

    def timed():
        if wide:
            rnn_cuda.wide_launch(xs, layout, b, h0, c0, bufs=bufs, entry=entry,
                                 extra=(stamps.data_ptr(),))
        else:
            cuda_lib.check(rnn_cuda.launch(entry, xs, layout, b, h0, c0, out, hN, cN,
                                           stamps.data_ptr()), "bilstm (timing build)")

    def production():
        rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0, layout)

    ms = time_ms(production)
    stamps.zero_()
    timed()
    torch.cuda.synchronize()
    flat = stamps.cpu().reshape(-1)
    proj = {}
    if wide:  # the projection's counters, then the recurrence's warps
        cyc, ctas = flat[0].item(), flat[1].item()
        plan = rnn_cuda.wide_plan(U, F, B, T)
        given = {}
        for C, R in configs:
            p = rnn_cuda.wide_plan(U, F, B, T, cluster=C, rows=R)
            given[f"{C}x{R}"] = time_ms(lambda: rnn_cuda.wide_launch(
                xs, layout, b, h0, c0, parts=2, bufs=bufs, plan=p), reps=3)
        proj = {"projection_cycles_per_cta": cyc / ctas if ctas else 0.0,
                "projection_ctas": ctas,
                "projection_ms": time_ms(lambda: rnn_cuda.wide_launch(
                    xs, layout, b, h0, c0, parts=1, bufs=bufs)) if F > 16 else 0.0,
                "recurrence_ms": time_ms(lambda: rnn_cuda.wide_launch(
                    xs, layout, b, h0, c0, parts=2, bufs=bufs)),
                "plan": plan._asdict(), "recurrence_ms_given": given}
        flat = flat[2:2 + (flat.numel() - 2) // len(names) * len(names)]
    per_warp = flat.reshape(-1, len(names))
    per_warp = per_warp[per_warp.sum(1) > 0].double() / T  # the warps that ran
    cycles = per_warp.mean(0).tolist()
    ms_timed = time_ms(timed)
    got = bufs[0] if wide else out
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    err = (got.float() - ref[0].float()).abs().max().item()
    total = sum(cycles)
    # the recurrence runs its clusters in waves, each wave all T steps
    waves = (-(-2 * -(-B // proj["plan"]["rows"]) // proj["plan"]["clusters"])
             if wide else 1)
    rec_ms = proj.get("recurrence_ms", ms_timed)
    return {"B": B, "U": U, "F": F, "T": T, "ms": ms, "ms_timing_build": ms_timed,
            "cycles_per_step": dict(zip(names, cycles)), "cycles_per_step_total": total,
            "warps": int(per_warp.shape[0]), "waves": waves,
            "implied_sm_ghz": total * T * waves / (rec_ms * 1e6), "timing_build_out_err": err,
            **proj}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", choices=sorted(STREAMS), default="bf16")
    ap.add_argument("--units", type=int, nargs="+", default=[128], choices=rnn_cuda.KERNEL_UNITS)
    ap.add_argument("--batch", type=int, nargs="+", default=[4096, 2858])
    ap.add_argument("--configs", nargs="*", default=[],
                    help="past 256 units: CxR clusters and rows to time the recurrence on")
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bilstm_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {stream_source(args.stream, U) for U in args.units}
    if len(sources) != 1:
        ap.error("--units: widths of one source (up to 256 units, or 320-512)")
    source, entry_name, dtype = sources.pop()
    configs = [tuple(int(v) for v in c.split("x")) for c in args.configs]
    print("production build:", production_registers(source))
    entry, names, _ = timing_build(source, ["RV_BILSTM_PHASES"], entry_name,
                                   "rv_bilstm_phase_names")
    smi = smi_line()
    rows = []
    for U in args.units:
        for B in args.batch:
            for i, (name, width, T, seeded) in enumerate(SHAPES):
                F = width(U)
                r = split(entry, names, dtype, B, U, F, T, seeded, seed=i, configs=configs)
                r["layer"] = name
                rows.append(r)
                ph = "  ".join(f"{k} {v:.0f}" for k, v in r["cycles_per_step"].items())
                wide = ""
                if "plan" in r:
                    p = r["plan"]
                    given = "".join(f"; {k} {v:.3f} ms"
                                    for k, v in r["recurrence_ms_given"].items())
                    wide = (f"; projection {r['projection_ms']:.3f} ms ({r['projection_ctas']} "
                            f"CTAs, {r['projection_cycles_per_cta']:.0f} cycles a CTA), "
                            f"recurrence {r['recurrence_ms']:.3f} ms (C {p['cluster']}, R "
                            f"{p['rows']}, window {p['window']}, {p['clusters']} clusters at "
                            f"once, {r['waves']} waves){given}")
                print(f"{args.stream} U={U} B={B} {name} (F={F}, T={T}): {r['ms']:.3f} ms "
                      f"(timing build {r['ms_timing_build']:.3f} ms); cycles a step: {ph}; total "
                      f"{r['cycles_per_step_total']:.0f} over {r['warps']} warps, "
                      f"{r['implied_sm_ghz']:.3f} GHz implied; out err "
                      f"{r['timing_build_out_err']:.2e}{wide}", flush=True)
            chunk = sum(r["ms"] for r in rows if r["B"] == B and r["U"] == U)
            print(f"{args.stream} U={U} B={B}: the chunk's four layers {chunk:.3f} ms")
    print(smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"stream": args.stream, "units": args.units, "card": smi, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
