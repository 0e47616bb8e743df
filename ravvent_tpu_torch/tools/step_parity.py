"""Hold this checkout's decoder kernels against another checkout's, on the card.

Runs the two kernels of the beam step (``beam_cell``, then ``beam_attend`` in
each memory mode: bf16, f32, int8 quant and quant_mxu), the whole-loop
kernel (``beam_loop``, bf16 and f32 memory, 39 live steps of 47, at the beam
widths 1-5 and 8) and the greedy decode step (``decode_step``, f32 memory,
E = 256) of two checkouts of the repository on the same inputs: chip_smoke.py
phase 3's decoder and encoder-like memory (seed 1, B = 4096, S = 232,
U = 128) and a seeded mid-decode state, the beam step at the beam widths 1
and 5. Each checkout runs in a process of its own, in the order other, this,
this, other, and prints a digest (sha256) of every output tensor and each
kernel's mean time by CUDA events over 100 launches (10 for the loop). The
result says whether the outputs are equal bit for bit and how far the times
moved, within this one call on one card.

  python -m ravvent_tpu_torch.tools.step_parity --other DIR

DIR is a checkout with a ``ravvent_tpu_torch`` package (for example one
unpacked with ``git archive``). Needs a CUDA device; each checkout builds
its own kernels into its own ``ravvent_tpu_torch/build/``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
THIS = HERE.parents[2]
WIDTHS = (5, 1)
MODES = ("bf16", "f32", "quant", "quant_mxu")
LOOP_WIDTHS = (1, 2, 3, 4, 5, 8)  # the whole-loop kernel's exact instances


def run_checkout(root: Path) -> dict:
    """The kernels of the checkout at ``root`` (its package first on the
    path): digests of their outputs and their times."""
    # the checkout's package first, and not this file's directory (a script's
    # first path entry), whose tool modules could shadow others
    sys.path[:] = [str(root)] + [p for p in sys.path if Path(p or ".").resolve() != HERE.parent]
    import torch

    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops import beam_loop_cuda as bl
    from ravvent_tpu_torch.ops import beam_step_cuda as bs
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.ops import decode_step_cuda as ds

    if not Path(bs.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {bs.__file__}, not the checkout at {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cuda_lib.lib()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")

    def ms(fn, reps: int = 100, warmup: int = 5) -> float:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def digest(tensors) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
        return h.hexdigest()

    # chip_smoke.py phase 3's decoder and memory: seed 1, a valid raw prefix
    # of 120-200 positions, 15-30 events, 2 of padding
    gen = torch.Generator().manual_seed(1)
    B, S, U, V, E = 4096, 232, 128, 7, 256
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    memory = torch.tanh(torch.randn(B, S, E, generator=gen)).to(dev)
    pos = torch.arange(S)
    n_raw = torch.randint(120, 201, (B, 1), generator=gen)
    n_ev = torch.randint(15, 31, (B, 1), generator=gen)
    mask = ((pos < n_raw) | ((pos >= 200) & (pos < 200 + n_ev))).to(dev)
    mems = {m: attn.setup_memory(dec_p["attention"], memory, mask, dt,
                                 attention_layer=dec_p["attention_layer"])
            for m, dt in (("bf16", torch.bfloat16), ("f32", torch.float32), ("quant", "i8"))}
    w = bs.pack_decoder_weights(dec_p, mems["f32"])
    digests, times = {}, {}
    for W in WIDTHS:
        g = torch.Generator().manual_seed(100 + W)
        st = bs.StepState(torch.randint(0, V + 2, (B * W,), generator=g, dtype=torch.int32),
                          torch.tanh(torch.randn(B * W, U, generator=g)),
                          torch.randn(B * W, U, generator=g), torch.randn(B * W, U, generator=g),
                          -5.0 * torch.rand(B, W, generator=g), torch.rand(B, W, generator=g) < 0.2)
        st = bs.StepState(*(t.to(dev) for t in st))
        cell = bs.beam_cell(st, w)
        digests[f"beam_cell W={W}"] = digest(cell)
        times[f"beam_cell W={W}"] = ms(lambda: bs.beam_cell(st, w))
        for mode in MODES:
            m = mems["quant" if mode == "quant_mxu" else mode]
            scales = (m.kscale, m.vscale) if m.quantized else None
            mxu = mode == "quant_mxu"

            def attend():
                return bs.beam_attend(st, *cell, m.keys, m.values, m.mask, w, 1, scales, mxu)

            nxt, parents = attend()
            digests[f"beam_attend {mode} W={W}"] = digest(list(nxt) + [parents])
            times[f"beam_attend {mode} W={W}"] = ms(attend)
    for mode in ("bf16", "f32"):
        m = mems[mode]
        for W in LOOP_WIDTHS:
            def loop():
                return bl.beam_loop(m.keys, m.values, m.mask, w, W, 47, 39, 2, 1)

            digests[f"beam_loop {mode} W={W}"] = digest(loop())
            times[f"beam_loop {mode} W={W}"] = ms(loop, reps=10, warmup=1)
    # the greedy step on un-projected f32 memory of the same encoder output
    raw = attn.setup_memory(dec_p["attention"], memory, mask, torch.float32)
    wg = ds.pack_decoder_weights(dec_p)
    g = torch.Generator().manual_seed(7)
    tok = torch.randint(0, V + 2, (B,), generator=g, dtype=torch.int32).to(dev)
    att, h, c = ((0.5 * torch.randn(B, U, generator=g)).to(dev) for _ in range(3))

    def step():
        return ds.fused_decode_step(wg, tok, att, h, c, raw.keys, raw.values, raw.mask)

    digests["decode_step E=256"] = digest(step())
    times["decode_step E=256"] = ms(step)
    return {"build_s": build_s, "digests": digests, "ms": times}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, help="the other checkout's root")
    ap.add_argument("--run", type=Path, help=argparse.SUPPRESS)  # one checkout, in a child
    args = ap.parse_args(argv)
    if args.run is not None:
        print(json.dumps(run_checkout(args.run.resolve())))
        return 0
    if args.other is None:
        ap.error("--other is required")
    res = {}
    for tag, root in (("other", args.other), ("this", THIS), ("this again", THIS),
                      ("other again", args.other)):
        out = subprocess.run([sys.executable, str(HERE), "--run", str(root)], capture_output=True,
                             text=True, timeout=1200)
        if out.returncode != 0:
            print(out.stdout + out.stderr, file=sys.stderr)
            return 1
        res[tag] = json.loads(out.stdout.strip().splitlines()[-1])
        print(f"{tag} ({root}): build {res[tag]['build_s']:.2f} s", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    equal = True
    for name, d in res["this"]["digests"].items():
        same = d == res["other"]["digests"][name]
        equal &= same
        t = [res[k]["ms"][name] for k in ("other", "this", "this again", "other again")]
        base, new = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"  {name}: outputs {'equal bit for bit' if same else 'DIFFER'}; ms other, this, "
              f"this, other {', '.join(f'{x:.4f}' for x in t)}: this / other {new / base:.4f}")
    print(smi)
    print(json.dumps({"equal": equal}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
