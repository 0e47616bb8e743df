"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the basecalling CLI's read path
(ravvent_tpu_torch/tools/basecall.py:basecall_read) at the flagship's full
width (joint raw+event input, 2-layer BiLSTM encoder of 128 units, 1-layer
LSTM decoder with Luong attention, vocab 7, beam 5) on seeded random
weights — and holds each hand-written kernel against its plain PyTorch
version on the card:

  0. device: the card, torch, CUDA and nvcc versions; TF32 off;
  1. build: nvcc builds the kernels from csrc/ (registers and shared memory
     per kernel from -Xptxas -v);
  2. the BiLSTM-layer kernel against its plain version at B=4096 for the four
     layer shapes of one chunk, timed beside torch.nn.LSTM;
  3. the beam-step kernel against its plain version at B=4096, S=232, U=128,
     W=5, bf16 memory, 40 steps, each step fed the plain version's state;
  4. end to end: 4 simulated reads through the CLI's read path, with each
     kernel's launch count, then a check against the CPU (plain) engine on
     the first 64 snippets of the first read.

Prints each phase's seconds, a ``{"kernels": [...]}`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero,
with no result line, when there is no CUDA device, a kernel does not build
or launch, or any comparison fails.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores
SEED = 0


class SmokeFailure(RuntimeError):
    pass


def require(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps launches, by CUDA events."""
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


def phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s", flush=True)


def smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 and res.stdout else "unknown"


def phase_device() -> str:
    smi = smi_line()
    print(f"nvidia-smi: {smi}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    from ravvent_tpu_torch.ops import cuda_lib

    res = subprocess.run([cuda_lib.nvcc_path(), "--version"], capture_output=True, text=True,
                         timeout=60)
    release = [ln for ln in res.stdout.splitlines() if "release" in ln]
    print(f"nvcc: {release[0].strip() if release else res.stdout.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    from ravvent_tpu_torch.ops import cuda_lib

    log = cuda_lib.build(force=True)
    for line in log.splitlines():
        if line.startswith("==") or "Compiling entry" in line or "Used" in line:
            print("  " + line.strip())
    cuda_lib.lib()


def bilstm_bounds(B: int, T: int, F: int, U: int) -> tuple:
    flops = 2 * B * T * 2 * (F + U) * 4 * U  # both directions, x.Wx + h.Wh
    nbytes = 4 * (B * T * F + 2 * (F + U + 1) * 4 * U + 4 * 2 * B * U + B * T * 2 * U)
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_bilstm() -> dict:
    from ravvent_tpu_torch.models.rnn import init_encoder, stacked_weights
    from ravvent_tpu_torch.ops.rnn_cuda import bilstm_layer, bilstm_layer_plain

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    B, U = 4096, 128
    tol = 1e-4  # f32 with another summation order over up to 200 steps
    # the four layer calls of one chunk: raw layers 0 and 1, event layers 0 and 1
    shapes = [(1, 200, False), (256, 200, True), (5, 30, False), (256, 30, True)]
    tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "err": 0.0}
    bound_by = set()
    for F, T, seeded in shapes:
        layer = init_encoder(gen, U, 1, F, dev)[0]
        wx, wh, b = stacked_weights(layer)
        xs = torch.randn(B, T, F, generator=gen).to(dev)
        h0 = (0.5 * torch.randn(2, B, U, generator=gen) if seeded else torch.zeros(2, B, U)).to(dev)
        c0 = (0.5 * torch.randn(2, B, U, generator=gen) if seeded else torch.zeros(2, B, U)).to(dev)
        got = bilstm_layer(xs, wx, wh, b, h0, c0)
        ref = bilstm_layer_plain(xs, wx, wh, b, h0, c0)
        torch.cuda.synchronize()
        err = max((g - r).abs().max().item() for g, r in zip(got, ref))
        rel = max(((g - r).abs() / r.abs().clamp(min=1.0)).max().item() for g, r in zip(got, ref))

        lib_lstm = torch.nn.LSTM(F, U, batch_first=True, bidirectional=True).to(dev)
        with torch.no_grad():
            for d, sfx in ((0, ""), (1, "_reverse")):
                getattr(lib_lstm, f"weight_ih_l0{sfx}").copy_(wx[d].T)
                getattr(lib_lstm, f"weight_hh_l0{sfx}").copy_(wh[d].T)
                getattr(lib_lstm, f"bias_ih_l0{sfx}").copy_(b[d])
                getattr(lib_lstm, f"bias_hh_l0{sfx}").zero_()
            lib_out = lib_lstm(xs, (h0, c0))[0]
            lib_err = (lib_out - ref[0]).abs().max().item()
            ms = time_ms(lambda: bilstm_layer(xs, wx, wh, b, h0, c0), reps=5)
            plain_ms = time_ms(lambda: bilstm_layer_plain(xs, wx, wh, b, h0, c0), reps=2)
            lib_ms = time_ms(lambda: lib_lstm(xs, (h0, c0)), reps=5)
        bound, by = bilstm_bounds(B, T, F, U)
        bound_by.add(by)
        print(f"  bilstm B={B} T={T} F={F}: max_abs_err {err:.3e} max_rel_err {rel:.3e} "
              f"(tol {tol:g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"torch.nn.LSTM {lib_ms:.3f} ms (its err vs plain {lib_err:.3e}), "
              f"bound {bound:.3f} ms ({by})")
        require(err <= tol and rel <= tol, f"bilstm F={F} T={T}: error {err:.3e} > {tol}")
        tot["ms"] += ms
        tot["plain_ms"] += plain_ms
        tot["library_ms"] += lib_ms
        tot["bound_ms"] += bound
        tot["err"] = max(tot["err"], err)
        del lib_lstm
    print(f"  bilstm, one chunk's four layers: kernel {tot['ms']:.3f} ms, "
          f"bound {tot['bound_ms']:.3f} ms")
    return {"name": "bilstm", "route": "cuda", "source": "ravvent_tpu_torch/csrc/bilstm.cu",
            "replaces": "ravvent_tpu/ops/rnn_pallas.py:33", "max_abs_err": tot["err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": tot["library_ms"]}


def beam_step_bounds(B: int, S: int, U: int, W: int, V: int, mem_bytes: int) -> tuple:
    hyps = B * W
    f32_flops = hyps * (2 * (V + 2 * U) * 4 * U + 2 * U * U + 2 * U * V)
    bf16_flops = hyps * 2 * 2 * S * U  # scores and context on bf16 memory
    nbytes = (2 * B * S * U * mem_bytes + B * S  # keys, values, mask
              + 2 * (hyps * (3 * U * 4 + 4) + B * W * 5)  # state in and out
              + 4 * ((V + 2 * U) * 4 * U + 4 * U + U * U + U * V + V))  # weights
    t_ops = f32_flops / H100_F32_FLOPS + bf16_flops / H100_BF16_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_beam_step() -> dict:
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_step_cuda import (
        beam_step, beam_step_plain, initial_state, pack_decoder_weights,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    B, S, U, W, V, E, steps = 4096, 232, 128, 5, 7, 256, 40
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    # encoder-like memory: valid raw prefix of 120-200 samples, 15-30 events,
    # 2 positions of padding to a multiple of 8
    memory = torch.tanh(torch.randn(B, S, E, generator=gen)).to(dev)
    pos = torch.arange(S)
    n_raw = torch.randint(120, 201, (B, 1), generator=gen)
    n_ev = torch.randint(15, 31, (B, 1), generator=gen)
    mask = ((pos < n_raw) | ((pos >= 200) & (pos < 200 + n_ev))).to(dev)
    mem = attn.setup_memory(dec_p["attention"], memory, mask, torch.bfloat16,
                            attention_layer=dec_p["attention_layer"])
    w = pack_decoder_weights(dec_p, mem)
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    st = initial_state(B, W, U, 2, dev)
    agree_tok = agree_par = n = 0
    err = 0.0
    tol = 1e-2  # cumulative log-prob; h and alignments round to bf16 in both versions
    for _ in range(steps):
        got, gpar = beam_step(st, keys, values, mask, w, 1)
        ref, rpar = beam_step_plain(st, keys, values, mask, w, 1)
        tok_eq = got.tok.reshape(B, W) == ref.tok.reshape(B, W)
        par_eq = gpar == rpar
        agree_tok += tok_eq.sum().item()
        agree_par += par_eq.sum().item()
        n += B * W
        both = tok_eq & par_eq
        if both.any():
            err = max(err, (got.cum - ref.cum).abs()[both].max().item())
        st = ref
    torch.cuda.synchronize()
    tok_share, par_share = agree_tok / n, agree_par / n
    st0 = initial_state(B, W, U, 2, dev)
    ms = time_ms(lambda: beam_step(st0, keys, values, mask, w, 1), reps=40)
    plain_ms = time_ms(lambda: beam_step_plain(st0, keys, values, mask, w, 1), reps=3)
    bound, by = beam_step_bounds(B, S, U, W, V, 2)
    print(f"  beam_step B={B} S={S} W={W} bf16, {steps} steps: tokens agree {tok_share:.5f}, "
          f"parents agree {par_share:.5f} (need >= 0.998); score max_abs_err {err:.3e} "
          f"(tol {tol:g}); kernel {ms:.4f} ms/step, plain {plain_ms:.4f} ms/step, "
          f"bound {bound:.4f} ms/step ({by})")
    require(tok_share >= 0.998 and par_share >= 0.998, "beam_step: token/parent agreement < 0.998")
    require(err <= tol, f"beam_step: score error {err:.3e} > {tol}")
    return {"name": "beam_step", "route": "cuda", "source": "ravvent_tpu_torch/csrc/beam_step.cu",
            "replaces": "ravvent_tpu/ops/beam_loop_pallas.py:333", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def phase_end_to_end() -> dict:
    from ravvent_tpu_torch.assembly.merger import Merger
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.data import simulator
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import init_basecaller
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN, basecall_read

    cfg = ModelConfig()  # the flagship: joint, 2 x BiLSTM(128), LSTM(128) + Luong, vocab 7
    params = init_basecaller(cfg, torch.Generator().manual_seed(SEED))
    engine = BasecallEngine(params, cfg, chunk_size=4096)  # the CLI's settings, on cuda
    merger = Merger()
    rng = np.random.default_rng(SEED)
    genome = simulator.random_genome(60_000, rng)
    pore = simulator.PoreModel()
    reads = []
    for _ in range(4):
        n = int(rng.integers(12_000, 18_001))
        s = int(rng.integers(0, len(genome) - n))
        reads.append(simulator.simulate_read(genome[s:s + n], rng, pore))

    # warm-up on a short read (first-use costs: native g++ build, cuBLAS)
    basecall_read(engine, merger, reads[0][0][:3000], reads[0][1][reads[0][1][:, 1] <= 3000])
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    stages = {"prepare": 0.0, "decode": 0.0, "merge": 0.0}
    n_snip = n_bases = 0
    for raw, ranges in reads:
        call = basecall_read(engine, merger, raw, ranges)
        require(call is not None, "a simulated read gave no snippets")
        n_snip += call.n_snippets
        n_bases += len(call.merged.seq)
        for k, v in call.seconds.items():
            stages[k] += v
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    print(f"  reads {len(reads)}, snippets {n_snip}, bases {n_bases}, wall {wall:.3f} s, "
          f"{n_bases / wall:.1f} bases/s")
    print("  stage seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
    print(f"  launches: bilstm {counts['bilstm']}, beam_step {counts['beam_step']}")
    require(counts["bilstm"] > 0 and counts["beam_step"] > 0, "a kernel was not launched")
    require(n_bases > 0, "the reads merged to no bases")

    # the card against the CPU (plain versions) on one read's first 64 snippets
    raw, ranges = reads[0]
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    rr, er = rr[:64], er[:64]
    t_gpu, p_gpu = engine.predict_beam_compact(sig, rr, ev, er, MAX_OUTPUT_LEN, 5)
    cpu = BasecallEngine(params, cfg, chunk_size=4096, device="cpu")
    t_cpu, p_cpu = cpu.predict_beam_compact(sig, rr, ev, er, MAX_OUTPUT_LEN, 5)
    agree = float((t_gpu == t_cpu).mean())
    rows = float((t_gpu == t_cpu).all(axis=1).mean())
    # untrained weights give flat, near-tied beams: f32 summation-order
    # differences between the kernels and the plain versions, rounded into
    # the bf16 memory, can flip a tie; the kernels' own bounds are phases 2-3
    print(f"  card vs CPU on 64 snippets: tokens agree {agree:.5f} (need >= 0.99), "
          f"rows identical {rows:.4f}; probs finite {bool(np.isfinite(p_gpu).all())}")
    require(t_gpu.shape == (64, 40) and np.isfinite(p_gpu).all(), "bad result shape or probs")
    require(((t_gpu >= 0) & (t_gpu < cfg.vocab_size)).all(), "token out of the vocabulary")
    require(agree >= 0.99, "card and CPU disagree on the end-to-end tokens")
    print('kernels: ["bilstm", "beam_step"]')
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    t0 = time.perf_counter()
    smi = phase_device()
    phase("0 device", t0)
    t0 = time.perf_counter()
    phase_build()
    phase("1 build", t0)
    t0 = time.perf_counter()
    k_bilstm = phase_bilstm()
    phase("2 bilstm kernel", t0)
    t0 = time.perf_counter()
    k_beam = phase_beam_step()
    phase("3 beam_step kernel", t0)
    t0 = time.perf_counter()
    counts = phase_end_to_end()
    phase("4 end to end", t0)
    k_bilstm["launches"] = counts["bilstm"]
    k_beam["launches"] = counts["beam_step"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in (k_bilstm, k_beam)]}))
    print(f"total: {time.perf_counter() - t_all:.2f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
