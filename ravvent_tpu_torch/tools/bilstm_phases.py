"""Where a step of a BiLSTM-layer kernel spends its cycles.

Builds the kernel of one stream a second time with ``-DRV_BILSTM_PHASES``
(``--stream bf16``: ``csrc/bilstm_bf16.cu``, the default; ``--stream f32``:
``csrc/bilstm.cu``), into the gitignored ``ravvent_tpu_torch/build/``,
beside the production library, which it leaves alone. In that build lane 0
of every warp sums ``clock64()`` cycles over the phases of each time step
that the source names (``rv_bilstm_phase_names``) and writes its sums when
the loop ends. For each of a chunk's four layer shapes at ``--units`` U
(the flagship's 128 by default; any width these two sources are compiled
for, KERNEL_UNITS up to 256; the wide kernels past it have no timing
build): raw layers 0 and 1 at T = 200 on F = 1 and 2U, event layers 0 and
1 at T = 30 on F = 5 and 2U; and each batch size it prints the mean cycles per step of each phase (mean over all warps), the
production kernel's time and the timing build's (CUDA events), and the
card's SM clock that the two imply. Needs a CUDA device and nvcc.

Usage: python -m ravvent_tpu_torch.tools.bilstm_phases [--stream bf16|f32]
       [--units 32|64|96|128|192|256] [--batch 4096 2858] [--json out.json]
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
# stream: (source, production entry, dtype)
STREAMS = {"bf16": ("bilstm_bf16.cu", "rv_bilstm_layer_bf16", torch.bfloat16),
           "f32": ("bilstm.cu", "rv_bilstm_layer", torch.float32)}


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


def split(entry, names, dtype, B: int, U: int, F: int, T: int, seeded: bool, seed: int) -> dict:
    """One layer shape of U units at batch B: phase cycles per step, both
    builds' ms."""
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
    # room for any grid of >= 16 rows a CTA and <= 32 warps
    stamps = torch.zeros(2 * -(-B // 16) * 32, len(names), dtype=torch.int64, device=dev)

    def timed():
        cuda_lib.check(rnn_cuda.launch(entry, xs, layout, b, h0, c0, out, hN, cN,
                                       stamps.data_ptr()), "bilstm (timing build)")

    def production():
        rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0, layout)

    ms = time_ms(production)
    stamps.zero_()
    timed()
    torch.cuda.synchronize()
    per_warp = stamps.cpu()
    per_warp = per_warp[per_warp.sum(1) > 0].double() / T  # the warps that ran
    cycles = per_warp.mean(0).tolist()
    ms_timed = time_ms(timed)
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    err = (out.float() - ref[0].float()).abs().max().item()
    total = sum(cycles)
    return {"B": B, "U": U, "F": F, "T": T, "ms": ms, "ms_timing_build": ms_timed,
            "cycles_per_step": dict(zip(names, cycles)), "cycles_per_step_total": total,
            "warps": int(per_warp.shape[0]),
            "implied_sm_ghz": total * T / (ms_timed * 1e6), "timing_build_out_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stream", choices=sorted(STREAMS), default="bf16")
    ap.add_argument("--units", type=int, default=128,
                    choices=[u for u in rnn_cuda.KERNEL_UNITS if u not in rnn_cuda.WIDE_UNITS])
    ap.add_argument("--batch", type=int, nargs="+", default=[4096, 2858])
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bilstm_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    source, entry_name, dtype = STREAMS[args.stream]
    print("production build:", production_registers(source))
    entry, names, _ = timing_build(source, ["RV_BILSTM_PHASES"], entry_name,
                                   "rv_bilstm_phase_names")
    smi = smi_line()
    rows = []
    for B in args.batch:
        for i, (name, width, T, seeded) in enumerate(SHAPES):
            F = width(args.units)
            r = split(entry, names, dtype, B, args.units, F, T, seeded, seed=i)
            r["layer"] = name
            rows.append(r)
            ph = "  ".join(f"{k} {v:.0f}" for k, v in r["cycles_per_step"].items())
            print(f"{args.stream} U={args.units} B={B} {name} (F={F}, T={T}): {r['ms']:.3f} ms "
                  f"(timing build "
                  f"{r['ms_timing_build']:.3f} ms); cycles a step: {ph}; total "
                  f"{r['cycles_per_step_total']:.0f} over {r['warps']} warps, "
                  f"{r['implied_sm_ghz']:.3f} GHz implied; out err {r['timing_build_out_err']:.2e}",
                  flush=True)
        chunk = sum(r["ms"] for r in rows if r["B"] == B)
        print(f"{args.stream} U={args.units} B={B}: the chunk's four layers {chunk:.3f} ms")
    print(smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"stream": args.stream, "units": args.units, "card": smi, "rows": rows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
