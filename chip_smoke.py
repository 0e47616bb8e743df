"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — the basecalling CLI's read path
(ravvent_tpu_torch/tools/basecall.py:basecall_read) with --beam-impl step
and with --beam-impl loop, fused greedy decode
(ops/decode_step_cuda.py:fused_greedy_decode), and bench.py's main path
(evaluation/performance.py:PerformanceEvaluator on the bench's engine
settings), the bench's path on int8 memory through PerformanceEvaluator
and MappingEvaluator (evaluation/mapping.py), the signal-only wire (sigdev,
sigdev8) through both, the engine's greedy decode, its top-K beams with the
mapping evaluator's beam selection, and tools/profile_decode.py with a
torch.profiler trace of the bench's pipelined path — at the flagship's full width
(joint raw+event input, 2-layer BiLSTM encoder of 128 units, 1-layer LSTM
decoder with Luong attention, vocab 7, beam 5) on seeded random weights, and
holds each hand-written kernel against its plain PyTorch version on the card:

  0. device: the card, torch, CUDA and nvcc versions; TF32 off;
  1. build: nvcc builds the kernels from csrc/ (registers and shared memory
     per kernel from -Xptxas -v);
  2. the f32-stream BiLSTM kernel against its plain version at B=4096 and
     at B=2858 (the first read's rows) for the four layer shapes of one
     chunk, timed beside torch.nn.LSTM in f32;
  3. the bf16/f32 beam step, two kernels (beam_cell, then beam_attend),
     against its plain version at B=4096, S=232, U=128, W=5: bf16 memory
     over 40 steps, each kernel also against its own plain version on the
     same inputs, then f32 memory over 10 steps, each step fed the plain
     version's state; the pair and each kernel timed beside its bound, and
     the step at S=8 beside S=232;
  4. end to end: 4 simulated reads through the CLI's read path, with each
     kernel's launch count, then a check against the CPU (plain) engine on
     the first 64 snippets of the first read;
  5. the beam-loop kernel against its plain version at B=4096, S=232, W=5,
     bf16 memory, 39 live steps (one launch of clusters of 8 CTAs; the
     cluster size and cudaOccupancyMaxActiveClusters printed), timed at 4096
     and at 2858 rows beside the beam-step kernel's 39-step loop on the same
     memory; then on a decoder whose end
     token is pushed down (every live step runs the whole cell), with bf16
     memory at B=4096 and f32 memory at B=256. Each live step of the
     kernel's result is replayed through the plain step
     (beam_loop_cuda.replay_plain), and the free-running loops are compared;
  6. the decode-step kernel against its plain version at B=4096, S=232,
     E=256, f32 memory, 40 chained steps, each fed the plain version's state;
  7. end to end: the same 4 reads through the read path with
     beam_impl="loop" (one beam-loop launch per chunk, no beam-step launch),
     checked against the step path and the CPU on 64 snippets;
  8. end to end: the first read's snippets encoded by the BiLSTM kernel, as
     un-projected f32 memory, decoded by fused_greedy_decode on the card,
     checked against plain greedy_decode on the CPU on 64 snippets;
  9. the bf16-stream BiLSTM kernel against its plain version at B=4096 and
     at B=2858 (the first read's rows) for the four layer shapes of one
     chunk, timed beside torch.nn.LSTM in bf16;
 10. end to end, bench.py's main path: PerformanceEvaluator (evaluate_files,
     then run_pipelined with 8 reads in flight and 4 finishers) over the
     engine with the bench's settings (i8dev wire, bf16 encoder stream on
     the bf16 BiLSTM kernel, bf16 memory on the beam-step kernel, 4-bit
     probabilities) on the same 4 reads; the i8dev snippet ranges on the
     card bit-equal to the host's, the card's event features within the
     host bars, and card and CPU tokens on 64 snippets;
 11. the int8 beam step, beam_cell then the int8 attend kernel
     (beam_attend_i8 for quant, beam_attend_i8mxu for quant_mxu), against
     its plain version at phase 3's shape and seed on setup_memory(...,
     "i8") memory, 40 steps each, the attend kernel also against its own
     plain version fed the plain cell; the step and the attend kernel timed
     at S=232 and S=8 beside their bounds, the bf16 step and the
     quantization's time per chunk;
 12. end to end, bench.py's path on int8 memory (--memory i8, then i8mxu):
     PerformanceEvaluator.evaluate_files and MappingEvaluator.evaluate_files
     over the same 4 reads; only beam_cell and the int8 attend kernel of the
     mode (once each a step) and the bf16 BiLSTM kernel launch; card and CPU
     tokens on 64 snippets, decoding the card's int8 memory and end to end.
 13. end to end, the signal-only wire (bench.py's sigdev and sigdev8
     pipelines): the peak-scan kernel (csrc/peak_scan.cu, the scan then the
     check) against its plain version on the card for the 4 reads on both
     wires and on two traces whose check fails, timed at 131072 and 196608
     samples; the engine's segmentation on the card against the CPU engine
     (meta and ranges bit-equal on the i16 wire, features within 1e-3);
     card and CPU tokens on 64 snippets; PerformanceEvaluator.run_pipelined
     over the compact wire, sigdev and sigdev8, and MappingEvaluator on
     sigdev, with the bench's settings; no read falls back to the compact
     wire, peak_scan launches twice a segmentation, bilstm_bf16 4 times a
     chunk, beam_cell and beam_attend once a step;
 14. end to end, BasecallEngine.predict_greedy on the first read's snippets
     with the CLI's settings (f32 encoder stream, bf16 memory) and the
     bench's (bf16 stream): the stream's BiLSTM kernel 4 times a chunk, no
     beam or decode-step kernel, plain greedy steps over the pre-projected
     memory; card and CPU tokens on 64 snippets, decoding the card's memory
     and end to end, logits finite;
 15. end to end, top-K beams: the bench's settings with n_beams=3 through
     predict_beam_compact on the 4 reads, beam 0 bit-equal to an n_beams=1
     engine's result with the same launches (beam_cell and beam_attend once
     a step); the 3 beams on the card and the CPU on 64 snippets, decoding
     the card's memory and end to end; MappingEvaluator over the reads on
     the compact wire (the phase-aware beam selection) and on sigdev (the
     top beam);
 16. tools/profile_decode.py: the legs of the first read's decode on the
     compact wire and on sigdev (host pack and unpack, H2D, device compute
     on resident inputs, D2H, end to end; on sigdev also begin, the meta
     wait and finish), then one torch.profiler trace of run_pipelined over
     the 4 reads with the bench's settings: the device's idle share, the top
     device operations and the longest device-idle gaps with the host
     operations running in them.

Prints each phase's seconds, a ``{"kernels": [...]}`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``. Exits non-zero,
with no result line, when there is no CUDA device, a kernel does not build
or launch, or any comparison fails.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores
H100_BF16_FLOPS = 989e12  # dense bf16 tensor cores
H100_INT8_OPS = 1979e12  # dense int8 tensor cores
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
        spills = "spill stores" in line and " 0 bytes spill stores" not in line
        if line.startswith("==") or "Compiling entry" in line or "Used" in line or spills:
            print("  " + line.strip())
    cuda_lib.lib()


def bilstm_bounds(B: int, T: int, F: int, U: int, dtype) -> tuple:
    """(ms, what bounds it) of one BiLSTM layer on a stream of ``dtype``:
    f32 products on the FMA pipe, bf16 ones on the tensor cores."""
    flops = 2 * B * T * 2 * (F + U) * 4 * U  # both directions, x.Wx + h.Wh
    if dtype == torch.float32:
        nbytes = 4 * (B * T * F + 2 * (F + U + 1) * 4 * U + 4 * 2 * B * U + B * T * 2 * U)
        t_ops = flops / H100_F32_FLOPS
    else:
        nbytes = (2 * (B * T * F + 2 * (F + U) * 4 * U + B * T * 2 * U)  # bf16 x, weights, out
                  + 4 * (2 * 4 * U + 4 * 2 * B * U))  # f32 bias, h0, c0, hN, cN
        t_ops = flops / H100_BF16_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def cudnn_lstm_ms(F: int, U: int, dtype, wx, wh, b, xs, h0, c0, reps: int) -> tuple:
    """(mean ms, output) of torch.nn.LSTM (cuDNN) in ``dtype`` with the
    layer's weights and states: the library call timed beside the kernel,
    never used by the port."""
    lstm = torch.nn.LSTM(F, U, batch_first=True, bidirectional=True).to(xs.device, dtype)
    with torch.no_grad():
        for d, sfx in ((0, ""), (1, "_reverse")):
            getattr(lstm, f"weight_ih_l0{sfx}").copy_(wx[d].T)
            getattr(lstm, f"weight_hh_l0{sfx}").copy_(wh[d].T)
            getattr(lstm, f"bias_ih_l0{sfx}").copy_(b[d])
            getattr(lstm, f"bias_hh_l0{sfx}").zero_()
        lstm.flatten_parameters()
        state = (h0.to(dtype), c0.to(dtype))
        out = lstm(xs, state)[0]
        ms = time_ms(lambda: lstm(xs, state), reps=reps)
    return ms, out


def phase_bilstm(dtype) -> dict:
    """The BiLSTM kernel of one stream (f32: csrc/bilstm.cu, phase 2; bf16:
    csrc/bilstm_bf16.cu, phase 9) against its plain version for the four
    layer shapes of one chunk, at 4096 rows and at 2858 (the first read's
    row count, which the CLI and the bench path run as their own chunk),
    timed beside torch.nn.LSTM in the stream's dtype. The weights are laid
    out for the kernel once, as the engine lays them out. The kernels line
    carries the 4096-row chunk."""
    from ravvent_tpu_torch.models.rnn import init_encoder, stream_weights
    from ravvent_tpu_torch.ops.rnn_cuda import bilstm_layer, bilstm_layer_plain, kernel_layout

    dev, f32 = torch.device("cuda"), dtype == torch.float32
    name = "bilstm" if f32 else "bilstm_bf16"
    gen = torch.Generator().manual_seed(SEED if f32 else SEED + 4)
    U = 128
    # f32: another summation order over up to 200 steps, relative to max(1, |ref|)
    # too. bf16: outputs are bf16(h), about two bf16 ulps at |h| <= 1, where a
    # summation order flips a rounding and the recurrence carries it; f32
    # final states
    tol_out, tol_state = (1e-4, 1e-4) if f32 else (1e-2, 1e-3)
    names = ["raw L0", "raw L1", "event L0", "event L1"]
    shapes = [(1, 200, False), (256, 200, True), (5, 30, False), (256, 30, True)]
    layers = [stream_weights(init_encoder(gen, U, 1, F, dev), dtype)[0] for F, _, _ in shapes]
    chunks, err = {}, 0.0
    for B in (4096, 2858):
        tot = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
        bound_by = set()
        for lname, (F, T, seeded), (wx, wh, b) in zip(names, shapes, layers):
            layout = kernel_layout(wx, wh)
            xs = torch.randn(B, T, F, generator=gen).to(dev, dtype)
            h0 = (0.5 * torch.randn(2, B, U, generator=gen) if seeded
                  else torch.zeros(2, B, U)).to(dev)
            c0 = (0.5 * torch.randn(2, B, U, generator=gen) if seeded
                  else torch.zeros(2, B, U)).to(dev)
            got = bilstm_layer(xs, wx, wh, b, h0, c0, layout)
            ref = bilstm_layer_plain(xs, wx, wh, b, h0, c0)
            torch.cuda.synchronize()
            require(got[0].dtype == dtype and got[1].dtype == torch.float32,
                    f"{name}: bad dtypes")
            err_out = (got[0].float() - ref[0].float()).abs().max().item()
            err_state = max((g - r).abs().max().item() for g, r in zip(got[1:], ref[1:]))
            rel = max(((g.float() - r.float()).abs() / r.float().abs().clamp(min=1.0)).max().item()
                      for g, r in zip(got, ref))
            ms = time_ms(lambda: bilstm_layer(xs, wx, wh, b, h0, c0, layout), reps=5)
            plain_ms = time_ms(lambda: bilstm_layer_plain(xs, wx, wh, b, h0, c0), reps=2)
            lib_ms, lib_out = cudnn_lstm_ms(F, U, dtype, wx, wh, b, xs, h0, c0, reps=5)
            lib_err = (lib_out.float() - ref[0].float()).abs().max().item()
            bound, by = bilstm_bounds(B, T, F, U, dtype)
            bound_by.add(by)
            print(f"  {name} B={B} {lname} T={T} F={F}: out max_abs_err {err_out:.3e} (tol "
                  f"{tol_out:g}), final states {err_state:.3e} (tol {tol_state:g}), max_rel_err "
                  f"{rel:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, torch.nn.LSTM "
                  f"{lib_ms:.3f} ms (its out err vs plain {lib_err:.3e}), bound {bound:.3f} ms "
                  f"({by})", flush=True)
            require(err_out <= tol_out and err_state <= tol_state and (rel <= tol_out or not f32),
                    f"{name} B={B} F={F} T={T}: errors {err_out:.3e} / {err_state:.3e} / {rel:.3e}")
            tot["ms"] += ms
            tot["plain_ms"] += plain_ms
            tot["library_ms"] += lib_ms
            tot["bound_ms"] += bound
            err = max(err, err_out, err_state)
        print(f"  {name} B={B}, one chunk's four layers: kernel {tot['ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, torch.nn.LSTM {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms", flush=True)
        chunks[B] = (tot, bound_by)
    tot, bound_by = chunks[4096]
    return {"name": name, "route": "cuda", "source": f"ravvent_tpu_torch/csrc/{name}.cu",
            "replaces": "ravvent_tpu/ops/rnn_pallas.py:33", "max_abs_err": err,
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": "operations" if "operations" in bound_by else "bytes",
            "library_ms": tot["library_ms"]}


def cell_flops(U: int, V: int, att_rows: int) -> int:
    """f32 operations of one hypothesis's decoder step outside the memory:
    the LSTM cell's products over the U attention rows and the U recurrent
    rows (the token's one-hot row of the input kernel is read, not
    multiplied), the attention layer over ``att_rows`` rows, the logits."""
    return 2 * 2 * U * 4 * U + 2 * att_rows * U + 2 * U * V


def beam_step_bounds(B: int, S: int, U: int, W: int, V: int, mem_bytes: int,
                     scale_bytes: int = 0, mem_peak: float = H100_BF16_FLOPS) -> tuple:
    """One step's bound: the memory's dots at ``mem_peak`` (bf16 for bf16
    memory and for int8 memory's dequantized dots, int8 for its integer
    dots), the cell's f32 work, and the bytes: keys, values, ``scale_bytes``
    of scales per position, mask, state in and out, weights."""
    hyps = B * W
    f32_flops = hyps * cell_flops(U, V, U)
    mem_flops = hyps * 2 * 2 * S * U  # scores and context on the memory
    nbytes = (2 * B * S * U * mem_bytes + B * S * (1 + scale_bytes)  # keys, values, mask, scales
              + 2 * (hyps * (3 * U * 4 + 4) + B * W * 5)  # state in and out
              + 4 * ((V + 2 * U) * 4 * U + 4 * U + U * U + U * V + V))  # weights
    t_ops = f32_flops / H100_F32_FLOPS + mem_flops / mem_peak
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def encoder_like_memory(gen: torch.Generator, B: int, S: int, E: int, dev) -> tuple:
    """Memory [B, S, E] and mask [B, S] shaped like the encoder's: a valid raw
    prefix of 120-200 samples, 15-30 events, 2 positions of padding to a
    multiple of 8."""
    memory = torch.tanh(torch.randn(B, S, E, generator=gen)).to(dev)
    pos = torch.arange(S)
    n_raw = torch.randint(120, 201, (B, 1), generator=gen)
    n_ev = torch.randint(15, 31, (B, 1), generator=gen)
    mask = ((pos < n_raw) | ((pos >= 200) & (pos < 200 + n_ev))).to(dev)
    return memory, mask


def beam_cell_bounds(N: int, U: int, V: int) -> tuple:
    """The cell kernel's bound for N hypotheses: the cell's products over the
    U attention and U recurrent rows and h'.watt_h in f32; bytes: the state
    in (token, att, h, c), h', c', att_h out, the cell's weights."""
    flops = N * (2 * 2 * U * 4 * U + 2 * U * U)
    nbytes = N * (4 + 3 * U * 4) + N * 3 * U * 4 + 4 * ((V + 2 * U) * 4 * U + 4 * U + U * U)
    t_ops, t_bytes = flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def beam_attend_bounds(B: int, S: int, U: int, W: int, V: int, mem_bytes: int,
                       scale_bytes: int = 0, mem_peak: float = H100_BF16_FLOPS) -> tuple:
    """The attend kernel's bound: the memory's dots at ``mem_peak`` (as
    beam_step_bounds counts them) and the logits in f32; bytes: keys,
    values, ``scale_bytes`` of scales per position, mask, the cell's scratch
    in (h', c', att_h), cum and fin in, the next state and the parents out,
    wfc and bfc."""
    hyps = B * W
    flops_mem = hyps * 2 * 2 * S * U
    flops_f32 = hyps * 2 * U * V
    nbytes = (2 * B * S * U * mem_bytes + B * S * (1 + scale_bytes) + hyps * 3 * U * 4 + hyps * 5
              + hyps * (3 * U * 4 + 4 + 4 + 1) + hyps * 4 + 4 * (U * V + V))
    t_ops = flops_mem / mem_peak + flops_f32 / H100_F32_FLOPS
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def check_steps(name: str, step, plain, st, steps: int, B: int, W: int, tol: float,
                extra=None) -> tuple:
    """``steps`` steps of ``step`` against ``plain``, each fed the plain
    state; ``extra(st, ref)`` runs beside each. Returns (token share, parent
    share, max score error where token and parent agree, last plain state)."""
    agree_tok = agree_par = n = 0
    err = 0.0
    for _ in range(steps):
        got, gpar = step(st)
        ref, rpar = plain(st)
        if extra is not None:
            extra(st, ref, rpar)
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
    require(tok_share >= 0.998 and par_share >= 0.998, f"{name}: token/parent agreement < 0.998")
    require(err <= tol, f"{name}: score error {err:.3e} > {tol}")
    return tok_share, par_share, err, st


def phase_beam_step() -> list:
    """The bf16/f32 beam step (beam_cell, then beam_attend) against
    beam_step_plain at B=4096, S=232, W=5: bf16 memory over 40 steps, with
    each kernel against its own plain version on the same inputs, then f32
    memory over 10 steps; each step fed the plain version's state. Times
    the pair and each kernel beside its bound, and the step at S=8."""
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_step_cuda import (
        attend_plain, beam_attend, beam_cell, beam_step, beam_step_plain, cell_plain,
        initial_state, pack_decoder_weights,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    B, S, U, W, V, E, steps = 4096, 232, 128, 5, 7, 256, 40
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    memory, mask = encoder_like_memory(gen, B, S, E, dev)
    mem = attn.setup_memory(dec_p["attention"], memory, mask, torch.bfloat16,
                            attention_layer=dec_p["attention_layer"])
    del memory
    w = pack_decoder_weights(dec_p, mem)
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    tol = 1e-2  # cumulative log-prob; h and alignments round to bf16 in both versions
    tol_cell = 1e-4  # h', c', att_h: f32 sums of 256 and 128 terms in another order
    cell_err = [0.0]
    attend = {"tok": 0, "par": 0, "n": 0, "err": 0.0}

    def kernels_alone(st, ref, rpar):
        """Each kernel against its plain version on the same inputs."""
        plain_cell = cell_plain(st, w)
        got_cell = beam_cell(st, w)
        cell_err[0] = max([cell_err[0]] + [(g - r).abs().max().item()
                                           for g, r in zip(got_cell, plain_cell)])
        got, gpar = beam_attend(st, *plain_cell, keys, values, mask, w, 1)
        tok_eq = got.tok.reshape(B, W) == ref.tok.reshape(B, W)
        both = tok_eq & (gpar == rpar)
        attend["tok"] += tok_eq.sum().item()
        attend["par"] += (gpar == rpar).sum().item()
        attend["n"] += B * W
        if both.any():
            attend["err"] = max(attend["err"], (got.cum - ref.cum).abs()[both].max().item())

    def step_on(k, v, m):
        return lambda st: beam_step(st, k, v, m, w, 1)

    def plain_on(k, v, m):
        return lambda st: beam_step_plain(st, k, v, m, w, 1)

    st0 = initial_state(B, W, U, 2, dev)
    tok_share, par_share, err, st_mid = check_steps(
        "beam_step bf16", step_on(keys, values, mask), plain_on(keys, values, mask), st0, steps,
        B, W, tol, extra=kernels_alone)
    a_tok, a_par = attend["tok"] / attend["n"], attend["par"] / attend["n"]
    print(f"  beam_step B={B} S={S} W={W} bf16, {steps} steps: tokens agree {tok_share:.5f}, "
          f"parents agree {par_share:.5f} (need >= 0.998); score max_abs_err {err:.3e} "
          f"(tol {tol:g})")
    print(f"  beam_cell alone: h', c', att_h max_abs_err {cell_err[0]:.3e} (tol {tol_cell:g}); "
          f"beam_attend alone, fed the plain cell: tokens agree {a_tok:.5f}, parents agree "
          f"{a_par:.5f} (need >= 0.998), score max_abs_err {attend['err']:.3e} (tol {tol:g})")
    require(cell_err[0] <= tol_cell, f"beam_cell: error {cell_err[0]:.3e} > {tol_cell}")
    require(a_tok >= 0.998 and a_par >= 0.998, "beam_attend: token/parent agreement < 0.998")
    require(attend["err"] <= tol, f"beam_attend: score error {attend['err']:.3e} > {tol}")

    kf, vf = keys.float(), values.float()
    f_tok, f_par, f_err, _ = check_steps("beam_step f32", step_on(kf, vf, mask),
                                         plain_on(kf, vf, mask), st0, 10, B, W, tol)
    print(f"  beam_step B={B} S={S} W={W} f32, 10 steps: tokens agree {f_tok:.5f}, parents agree "
          f"{f_par:.5f} (need >= 0.998); score max_abs_err {f_err:.3e} (tol {tol:g})")

    # times on a mid-decode state
    st = st_mid
    ms = time_ms(lambda: beam_step(st, keys, values, mask, w, 1), reps=40)
    plain_ms = time_ms(lambda: beam_step_plain(st, keys, values, mask, w, 1), reps=3)
    cell_ms = time_ms(lambda: beam_cell(st, w), reps=40)
    cell_plain_ms = time_ms(lambda: cell_plain(st, w), reps=10)
    hn, cn, ah = beam_cell(st, w)
    att_ms = time_ms(lambda: beam_attend(st, hn, cn, ah, keys, values, mask, w, 1), reps=40)
    att_plain_ms = time_ms(lambda: attend_plain(st, hn, cn, ah, keys, values, mask, w, 1), reps=3)
    f32_ms = time_ms(lambda: beam_step(st, kf, vf, mask, w, 1), reps=40)
    f32_att_ms = time_ms(lambda: beam_attend(st, hn, cn, ah, kf, vf, mask, w, 1), reps=40)
    f32_plain_ms = time_ms(lambda: beam_step_plain(st, kf, vf, mask, w, 1), reps=3)
    del kf, vf
    k8, v8, m8 = keys[:, :8].contiguous(), values[:, :8].contiguous(), mask[:, :8].contiguous()
    ms8 = time_ms(lambda: beam_step(st, k8, v8, m8, w, 1), reps=40)
    bound, by = beam_step_bounds(B, S, U, W, V, 2)
    bound8, _ = beam_step_bounds(B, 8, U, W, V, 2)
    f32_bound, f32_by = beam_step_bounds(B, S, U, W, V, 4, mem_peak=H100_F32_FLOPS)
    cell_bound, cell_by = beam_cell_bounds(B * W, U, V)
    att_bound, att_by = beam_attend_bounds(B, S, U, W, V, 2)
    f32_att_bound, _ = beam_attend_bounds(B, S, U, W, V, 4)
    print(f"  the step (beam_cell + beam_attend), bf16: {ms:.4f} ms/step, plain {plain_ms:.4f} "
          f"ms/step, bound {bound:.4f} ms/step ({by}); at S=8 {ms8:.4f} ms/step (bound "
          f"{bound8:.4f}) beside S={S} {ms:.4f}")
    print(f"  beam_cell B*W={B * W}: {cell_ms:.4f} ms, plain {cell_plain_ms:.4f} ms, bound "
          f"{cell_bound:.4f} ms ({cell_by})")
    print(f"  beam_attend bf16: {att_ms:.4f} ms, plain {att_plain_ms:.4f} ms, bound "
          f"{att_bound:.4f} ms ({att_by}); the two kernels' bounds sum to "
          f"{cell_bound + att_bound:.4f} ms against the step's {bound:.4f}")
    print(f"  f32 memory: the step {f32_ms:.4f} ms/step, plain {f32_plain_ms:.4f} ms/step, bound "
          f"{f32_bound:.4f} ms/step ({f32_by}); beam_attend {f32_att_ms:.4f} ms, bound "
          f"{f32_att_bound:.4f} ms")
    src = "ravvent_tpu_torch/csrc/beam_step_f.cu"
    replaces = "ravvent_tpu/ops/beam_loop_pallas.py:333"
    return [{"name": "beam_cell", "route": "cuda", "source": src, "replaces": replaces,
             "max_abs_err": cell_err[0], "ms": cell_ms, "plain_ms": cell_plain_ms,
             "bound_ms": cell_bound, "bound_by": cell_by, "library_ms": None},
            {"name": "beam_attend", "route": "cuda", "source": src, "replaces": replaces,
             "max_abs_err": attend["err"], "ms": att_ms, "plain_ms": att_plain_ms,
             "bound_ms": att_bound, "bound_by": att_by, "library_ms": None}]


def simulated_reads() -> list:
    """tools/profile_decode.py's 4 simulated reads of 12-18 kb from a 60 kb
    random genome (seeded): (raw signal, base ranges, bases) each."""
    from ravvent_tpu_torch.tools.profile_decode import simulated_reads as reads

    return reads(SEED)


def flagship_params():
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.models.basecaller import init_basecaller

    cfg = ModelConfig()  # the flagship: joint, 2 x BiLSTM(128), LSTM(128) + Luong, vocab 7
    return cfg, init_basecaller(cfg, torch.Generator().manual_seed(SEED))


def phase_end_to_end() -> dict:
    from ravvent_tpu_torch.assembly.merger import Merger
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN, basecall_read

    cfg, params = flagship_params()
    engine = BasecallEngine(params, cfg, chunk_size=4096)  # the CLI's settings, on cuda
    merger = Merger()
    reads = simulated_reads()

    # warm-up on a short read (first-use costs: native g++ build, cuBLAS)
    basecall_read(engine, merger, reads[0][0][:3000], reads[0][1][reads[0][1][:, 1] <= 3000])
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    stages = {"prepare": 0.0, "decode": 0.0, "merge": 0.0}
    n_snip = n_bases = 0
    for raw, ranges, _ in reads:
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
    print(f"  launches: bilstm {counts['bilstm']}, beam_step {counts['beam_step']} (beam_cell "
          f"{counts['beam_cell']}, beam_attend {counts['beam_attend']})")
    require(counts["bilstm"] > 0 and counts["beam_step"] > 0, "a kernel was not launched")
    require(counts["beam_cell"] == counts["beam_attend"] == counts["beam_step"],
            "a bf16 step did not launch beam_cell and beam_attend once each")
    require(n_bases > 0, "the reads merged to no bases")

    # the card against the CPU (plain versions) on one read's first 64 snippets
    raw, ranges, _ = reads[0]
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
    return counts


def beam_loop_bounds(B: int, S: int, U: int, W: int, V: int, mem_bytes: int,
                     steps: int) -> tuple:
    """The whole loop's bound: ``steps`` beam steps of operations, the memory,
    mask and weights read once, the live steps' tokens, parents and scores
    written once."""
    hyps = B * W
    f32_flops = steps * hyps * cell_flops(U, V, U)
    mem_flops = steps * hyps * 2 * 2 * S * U  # scores and context on the memory
    nbytes = (2 * B * S * U * mem_bytes + B * S
              + 4 * ((V + 2 * U) * 4 * U + 4 * U + U * U + U * V + V)
              + steps * hyps * 12)
    mem_peak = H100_BF16_FLOPS if mem_bytes == 2 else H100_F32_FLOPS
    t_ops = f32_flops / H100_F32_FLOPS + mem_flops / mem_peak
    t_bytes = nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def compare_loops(got, ref, eff: int, end_token: int = 1) -> tuple:
    """(top-beam token agreement over the live steps after the backtrack,
    share of live (step, row) pairs on a prefix where the tokens and parents
    of all beams agree, max score error there) of two whole-loop results
    [T, B, W]. A row's trajectories agree until its first flipped near-tie;
    scores are compared on each row's agreeing prefix."""
    from ravvent_tpu_torch.ops.beam_step_cuda import backtrack

    tok, par, sc = got
    rtok, rpar, rsc = ref
    top = backtrack(tok, par, sc, eff, end_token).tokens[:, :eff, 0]
    rtop = backtrack(rtok, rpar, rsc, eff, end_token).tokens[:, :eff, 0]
    same = ((tok == rtok) & (par == rpar)).all(dim=2)[:eff]  # [eff, B]
    prefix = torch.cumprod(same.int(), dim=0).bool()
    err = (sc[:eff] - rsc[:eff]).abs()[prefix].max().item() if prefix.any() else float("inf")
    return (top == rtop).float().mean().item(), prefix.float().mean().item(), err


def phase_beam_loop() -> dict:
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_loop_cuda import (
        beam_loop, beam_loop_plain, clusters, replay_plain,
    )
    from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop, pack_decoder_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    U, W, V, E, T, eff, end = 128, 5, 7, 256, 47, 39, 1  # the CLI: 47 steps, 39 live
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    # as drawn, most beams end within a few steps; once a row's beams have
    # all ended, a step keeps only the end token and no longer reads h, c or
    # the memory. With the end token's logit pushed down, every live step of
    # every row runs the whole cell and attention.
    live_p = dict(dec_p, fc=dict(dec_p["fc"], bias=dec_p["fc"]["bias"].clone()))
    live_p["fc"]["bias"][end] -= 20.0
    tol = 1e-2  # log-prob; h and alignments round to the memory dtype in both versions
    out = {}
    # (name, rows, memory dtype, decoder, whether the free-running loops are
    # held to the thresholds): with bf16 memory and no beam ending, 39
    # contested steps a row let rounding flip near-ties and part the two
    # loops' trajectories; there the replay holds every step instead
    for first, (name, B, dtype, dec, free) in zip((True, False, False), (
            ("bf16", 4096, torch.bfloat16, dec_p, True),
            ("bf16, no beam ending", 4096, torch.bfloat16, live_p, False),
            ("f32, no beam ending", 256, torch.float32, live_p, True))):
        memory, mask = encoder_like_memory(gen, B, 232, E, dev)
        mem = attn.setup_memory(dec["attention"], memory, mask, dtype,
                                attention_layer=dec["attention_layer"])
        del memory
        w = pack_decoder_weights(dec, mem)
        keys, values = mem.keys.contiguous(), mem.values.contiguous()
        got = beam_loop(keys, values, mask, w, W, T, eff, 2, end)
        ref = beam_loop_plain(keys, values, mask, w, W, T, eff, 2, end)
        rep = replay_plain(*got, keys, values, mask, w, eff, 2, end)
        agree, prefix, err = compare_loops(got, ref, eff, end)
        torch.cuda.synchronize()
        ended = (got[0][:eff] == end).float().mean().item()
        print(f"  beam_loop B={B} S=232 W={W} {name}, {eff} live steps (end-token picks "
              f"{ended:.5f}): each step replayed through the plain step: picks equal the plain "
              f"top-W {rep.exact:.5f} (need >= 0.99), distinct {rep.distinct}, picked-score "
              f"error {rep.rank_err:.3e}, step score error {rep.score_err:.3e} (tol {tol:g}); "
              f"free-running against the plain loop: top-beam tokens agree {agree:.5f}, live "
              f"(step, row) pairs on a prefix where all beams' tokens and parents agree "
              f"{prefix:.5f}, score error there {err:.3e}"
              + (" (need >= 0.998, >= 0.95, <= 0.01)" if free else " (not held)"), flush=True)
        require(not any(x[eff:].any() for x in got), f"beam_loop {name}: dead steps not zero")
        require(rep.distinct and rep.exact >= 0.99,
                f"beam_loop {name}: picks equal the plain top-W {rep.exact:.5f} < 0.99")
        require(max(rep.rank_err, rep.score_err) <= tol,
                f"beam_loop {name}: replayed score error "
                f"{max(rep.rank_err, rep.score_err):.3e} > {tol}")
        if not free:  # the per-step kernel's loop parts from the plain loop alike
            b2_agree, b2_prefix, _ = compare_loops(
                beam_step_loop(keys, values, mask, w, W, T, eff, 2, end), ref, eff, end)
            print(f"  beam_step kernel x {eff} on the same memory, free-running against the "
                  f"plain loop: top-beam tokens agree {b2_agree:.5f}, prefix {b2_prefix:.5f}")
        else:
            require(agree >= 0.998,
                    f"beam_loop {name}: top-beam token agreement {agree:.5f} < 0.998")
            require(prefix >= 0.95, f"beam_loop {name}: agreeing prefix share {prefix:.5f} < 0.95")
            require(err <= tol, f"beam_loop {name}: score error {err:.3e} > {tol}")
        err = max(rep.rank_err, rep.score_err, err if free else 0.0)
        if first:
            size, active = clusters(dtype, W, 232, V)
            print(f"  beam_loop: clusters of {size} CTAs, {active} at once "
                  f"(cudaOccupancyMaxActiveClusters)")
            ms = time_ms(lambda: beam_loop(keys, values, mask, w, W, T, eff, 2, end), reps=5)
            plain_ms = time_ms(lambda: beam_loop_plain(keys, values, mask, w, W, T, eff, 2, end),
                               reps=1)
            step_ms = time_ms(lambda: beam_step_loop(keys, values, mask, w, W, T, eff, 2, end),
                              reps=2)
            bound, by = beam_loop_bounds(B, 232, U, W, V, 2, eff)
            print(f"  beam_loop B={B} {name}: kernel {ms:.3f} ms/chunk, plain {plain_ms:.3f} "
                  f"ms/chunk, beam_step kernel x {eff} {step_ms:.3f} ms/chunk, bound "
                  f"{bound:.3f} ms/chunk ({by})", flush=True)
            # a read's rows (2858, the first simulated read's): the same memory's first rows
            k2, v2, m2 = keys[:2858], values[:2858], mask[:2858]
            ms2 = time_ms(lambda: beam_loop(k2, v2, m2, w, W, T, eff, 2, end), reps=5)
            step2 = time_ms(lambda: beam_step_loop(k2, v2, m2, w, W, T, eff, 2, end), reps=2)
            print(f"  beam_loop B=2858 {name}: kernel {ms2:.3f} ms/chunk, beam_step kernel x "
                  f"{eff} {step2:.3f} ms/chunk", flush=True)
            out = {"name": "beam_loop", "route": "cuda",
                   "source": "ravvent_tpu_torch/csrc/beam_loop.cu",
                   "replaces": "ravvent_tpu/ops/beam_loop_pallas.py:42", "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": None}
        else:
            out["max_abs_err"] = max(out["max_abs_err"], err)
        del mem, keys, values, got, ref
    return out


def decode_step_bounds(B: int, S: int, U: int, E: int, V: int) -> tuple:
    f32_flops = B * (cell_flops(U, V, U + E) + 2 * S * U + 2 * S * E)
    nbytes = (4 * B * S * (U + E) + B * S  # keys, values, mask
              + 4 * B * (1 + 3 * U) + 4 * B * (3 * U + V)  # state in, state and logits out
              + 4 * ((V + 2 * U) * 4 * U + 4 * U + (U + E) * U + U * V + V))  # weights
    t_ops, t_bytes = f32_flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_decode_step() -> dict:
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.decode_step_cuda import (
        fused_decode_step, fused_decode_step_plain, pack_decoder_weights,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    B, S, U, V, E, steps = 4096, 232, 128, 7, 256, 40
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    memory, mask = encoder_like_memory(gen, B, S, E, dev)
    mem = attn.setup_memory(dec_p["attention"], memory, mask, torch.float32)  # un-projected
    del memory
    w = pack_decoder_weights(dec_p)
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    tok = torch.full((B,), 2, dtype=torch.int32, device=dev)
    h, c, att = (torch.zeros(B, U, device=dev) for _ in range(3))
    tol = 1e-4  # f32 throughout, another summation order
    err = 0.0
    agree = n = 0
    for _ in range(steps):
        got = fused_decode_step(w, tok, att, h, c, keys, values, mask)
        ref = fused_decode_step_plain(w, tok, att, h, c, keys, values, mask)
        err = max([err] + [(g - r).abs().max().item() for g, r in zip(got, ref)])
        agree += (got[3].argmax(dim=1) == ref[3].argmax(dim=1)).sum().item()
        n += B
        h, c, att, logits = ref
        tok = logits.argmax(dim=1).to(torch.int32)
    torch.cuda.synchronize()
    share = agree / n
    h0, c0, a0 = (torch.zeros(B, U, device=dev) for _ in range(3))
    t0 = torch.full((B,), 2, dtype=torch.int32, device=dev)
    ms = time_ms(lambda: fused_decode_step(w, t0, a0, h0, c0, keys, values, mask), reps=20)
    plain_ms = time_ms(lambda: fused_decode_step_plain(w, t0, a0, h0, c0, keys, values, mask),
                       reps=3)
    bound, by = decode_step_bounds(B, S, U, E, V)
    print(f"  decode_step B={B} S={S} E={E} f32, {steps} chained steps: argmax agree "
          f"{share:.5f} (need >= 0.998); h/c/att/logits max_abs_err {err:.3e} (tol {tol:g}); "
          f"kernel {ms:.4f} ms/step, plain {plain_ms:.4f} ms/step, bound {bound:.4f} ms/step "
          f"({by})")
    require(share >= 0.998, f"decode_step: argmax agreement {share:.5f} < 0.998")
    require(err <= tol, f"decode_step: error {err:.3e} > {tol}")
    return {"name": "decode_step", "route": "cuda",
            "source": "ravvent_tpu_torch/csrc/decode_step.cu",
            "replaces": "ravvent_tpu/ops/decode_step_pallas.py:41", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def phase_end_to_end_loop() -> dict:
    from ravvent_tpu_torch.assembly.merger import Merger
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN, basecall_read

    cfg, params = flagship_params()
    engine = BasecallEngine(params, cfg, chunk_size=4096, beam_impl="loop")  # --beam-impl loop
    merger = Merger()
    reads = simulated_reads()
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    n_snip = n_bases = chunks = 0
    decode_s = 0.0
    for raw, ranges, _ in reads:
        call = basecall_read(engine, merger, raw, ranges)
        require(call is not None, "a simulated read gave no snippets")
        n_snip += call.n_snippets
        n_bases += len(call.merged.seq)
        chunks += -(-call.n_snippets // engine.chunk_size)
        decode_s += call.seconds["decode"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(cuda_lib.launches)
    print(f"  beam_impl=loop: reads {len(reads)}, snippets {n_snip}, chunks {chunks}, "
          f"bases {n_bases}, wall {wall:.3f} s (decode {decode_s:.3f} s), "
          f"{n_bases / wall:.1f} bases/s")
    print(f"  launches: bilstm {counts['bilstm']}, beam_loop {counts['beam_loop']}, "
          f"beam_step {counts['beam_step']}")
    require(counts["bilstm"] > 0 and counts["beam_loop"] == chunks,
            "beam_impl=loop: the beam-loop kernel was not launched once per chunk")
    require(counts["beam_step"] == counts["beam_cell"] == counts["beam_attend"] == 0,
            "beam_impl=loop launched the beam-step kernels")

    raw, ranges, _ = reads[0]
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    rr, er = rr[:64], er[:64]
    t_loop, p_loop = engine.predict_beam_compact(sig, rr, ev, er, MAX_OUTPUT_LEN, 5)
    step = BasecallEngine(params, cfg, chunk_size=4096)
    t_step, _ = step.predict_beam_compact(sig, rr, ev, er, MAX_OUTPUT_LEN, 5)
    cpu = BasecallEngine(params, cfg, chunk_size=4096, device="cpu", beam_impl="loop")
    t_cpu, _ = cpu.predict_beam_compact(sig, rr, ev, er, MAX_OUTPUT_LEN, 5)
    vs_step, vs_cpu = float((t_loop == t_step).mean()), float((t_loop == t_cpu).mean())
    print(f"  loop on the card vs step on the card / vs the CPU on 64 snippets: tokens agree "
          f"{vs_step:.5f} / {vs_cpu:.5f} (need >= 0.99)")
    require(t_loop.shape == (64, 40) and np.isfinite(p_loop).all(), "bad result shape or probs")
    require(vs_step >= 0.99 and vs_cpu >= 0.99, "beam_impl=loop disagrees end to end")
    return counts


def phase_greedy() -> dict:
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.decode.greedy import greedy_decode
    from ravvent_tpu_torch.evaluation.basecall import TOTAL_STEPS, BasecallEngine
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.ops.decode_step_cuda import fused_greedy_decode
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN

    cfg, params = flagship_params()
    card = BasecallEngine(params, cfg, chunk_size=4096)
    cpu = BasecallEngine(params, cfg, chunk_size=4096, device="cpu")

    def greedy(engine, raw, event, decode):
        """The engine's encoder and un-projected f32 memory, then ``decode``."""
        return decode(engine.params["decoder"], engine.memory(raw, event, project=False),
                      cfg.vocab_size, TOTAL_STEPS, MAX_OUTPUT_LEN - 1,
                      start_token=NUC_TOKENIZER.start_id, end_token=NUC_TOKENIZER.end_id)

    raw, ranges, _ = simulated_reads()[0]
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    with torch.inference_mode():
        # the read's snippets as the engine gathers them on the card
        chunks = list(card.compact_snippets(sig, rr, ev, er))
        raw_c, event_c = (torch.cat(x) for x in zip(*chunks))
        greedy(card, raw_c[:256], event_c[:256], fused_greedy_decode)  # warm-up
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tok, logits = greedy(card, raw_c, event_c, fused_greedy_decode)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(cuda_lib.launches)
        n = raw_c.shape[0]
        print(f"  fused greedy on one read: snippets {n}, wall {wall:.3f} s; launches: bilstm "
              f"{counts['bilstm']}, decode_step {counts['decode_step']}")
        require(counts["bilstm"] > 0 and counts["decode_step"] > 0,
                "fused greedy decode did not launch its kernels")
        require(tuple(tok.shape) == (n, TOTAL_STEPS) and bool(torch.isfinite(logits).all()),
                "bad greedy result shape or logits")
        # all_done couples a batch's rows: card and CPU decode the same 64 rows
        t_card, _ = greedy(card, raw_c[:64], event_c[:64], fused_greedy_decode)
        t_cpu, _ = greedy(cpu, raw_c[:64].cpu(), event_c[:64].cpu(), greedy_decode)
    agree = (t_card.cpu() == t_cpu).float().mean().item()
    print(f"  fused greedy on the card vs plain greedy_decode on the CPU, 64 snippets: "
          f"tokens agree {agree:.5f} (need >= 0.99)")
    require(agree >= 0.99, "fused greedy decode on the card disagrees with the CPU")
    return counts


def phase_bench_path(smi: str) -> dict:
    """bench.py's main path: PerformanceEvaluator over the engine with the
    bench's settings (i8dev wire, bf16 encoder stream, bf16 pre-projected
    memory, beam_impl="step", 4-bit probabilities) on the 4 simulated reads
    as chiron files, per read (evaluate_files) and pipelined."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.data import chiron
    from ravvent_tpu_torch.data.snippets import load_read_compact_ex
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
    from ravvent_tpu_torch.ops import cuda_lib

    cfg, params = flagship_params()
    bench = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
                 encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    engine = BasecallEngine(params, cfg, **bench)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = []
        for i, (raw, ranges, seq) in enumerate(simulated_reads()):
            chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", raw, ranges, seq)
            paths.append(str(d / f"r{i}.signal"))
        (d / "files_info.json").write_text(json.dumps([{"signal_path": p} for p in paths]))
        pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=str(d / "cache"))
        pe.run(paths[0])  # warm-up; fills the read cache, as the bench's repeats do
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        per_read = pe.evaluate_files(d / "files_info.json", d / "results.json", verbose=False)
        totals = PerformanceEvaluator.compute_total_results(d / "results.json")
        rec = pe.run_pipelined(paths, inflight=8, finishers=4)
        torch.cuda.synchronize()
        counts = dict(cuda_lib.launches)
        bases = sum(r["bases_num"] for r in per_read)
        proc = sum(r["total_processing"] for r in per_read)
        print(f"  evaluate_files, {len(per_read)} reads, {bases} bases: {bases / proc:.1f} bases/s "
              f"over total_processing {proc:.3f} s (predict "
              f"{sum(r['t_predicting'] for r in per_read):.3f} s, merge "
              f"{sum(r['t_merge'] for r in per_read):.3f} s); compute_total_results "
              f"{totals[0]:.1f} bases/s [{smi}]")
        print(f"  run_pipelined inflight 8, finishers 4: {rec['bases_per_s']:.1f} bases/s, wall "
              f"{rec['wall_s']:.3f} s, stages {rec['stages_s']} [{smi}]")
        print(f"  launches: bilstm_bf16 {counts['bilstm_bf16']}, beam_step {counts['beam_step']} "
              f"(beam_cell {counts['beam_cell']}, beam_attend {counts['beam_attend']}), "
              f"bilstm {counts['bilstm']}, beam_loop {counts['beam_loop']}, "
              f"decode_step {counts['decode_step']}")
        require(counts["bilstm_bf16"] > 0 and counts["beam_step"] > 0,
                "the bench path did not launch its kernels")
        require(counts["beam_cell"] == counts["beam_attend"] == counts["beam_step"],
                "a bf16 step did not launch beam_cell and beam_attend once each")
        require(counts["bilstm"] == counts["beam_loop"] == counts["decode_step"] == 0,
                "the bench path launched a kernel of another path")
        require(rec["bases_num"] == bases and bases > 0, "the pipelined run counted other bases")

        # the wire on the card against the host: ranges bit-equal, features
        # within the reference's bars (tests/test_compact_path.py:146-149)
        worst, mean_err, n_rows, n_chunks = 0.0, [], 0, 0
        for p in paths:
            sig, rr, ev, er, nuc, aux = load_read_compact_ex(p, Path(p).with_suffix(".label"), 6,
                                                              cache_dir=str(d / "cache"))
            for s in range(0, rr.shape[0], engine.chunk_size):
                rr_c, er_c = rr[s:s + engine.chunk_size], er[s:s + engine.chunk_size]
                _, ev_d, rr_d, er_d = engine.upload_chunk(sig, ev, rr_c, er_c, aux)
                lo_e, hi_e = int(er_c[0, 0]), int(er_c[:, 1].max())
                require(np.array_equal(rr_d.cpu().numpy(), rr_c - rr_c[0, 0])
                        and np.array_equal(er_d.cpu().numpy(), er_c - lo_e),
                        "i8dev snippet ranges on the card differ from the host's")
                err = np.abs(ev_d.cpu().numpy() - ev[lo_e:hi_e])
                worst = max(worst, float(err.max()))
                mean_err.append(float(err.mean()))
                n_rows += rr_c.shape[0]
                n_chunks += 1
        # evaluate_files and run_pipelined each encode every chunk once: four
        # layer launches a chunk (raw and event encoders, two layers each)
        print(f"  bilstm_bf16: {counts['bilstm_bf16']} launches over {2 * n_chunks} chunks "
              f"(need 4 a chunk)")
        require(counts["bilstm_bf16"] == 4 * 2 * n_chunks, "bilstm_bf16 did not launch 4 a chunk")
        print(f"  i8dev on the card: snippet ranges of {n_rows} rows bit-equal to the host's; "
              f"event features against the host's: max abs err {worst:.3e} (need < 5e-2), "
              f"worst chunk mean {max(mean_err):.3e} (need < 5e-3)")
        require(worst < 5e-2 and max(mean_err) < 5e-3, "i8dev event features miss the host bars")

        # the card against the CPU (plain versions) on 64 snippets, same settings
        sig, rr, ev, er, nuc, aux = load_read_compact_ex(paths[0], Path(paths[0]).with_suffix(
            ".label"), 6, cache_dir=str(d / "cache"))
    max_len = int((nuc != 0).sum(axis=1).max())
    rr, er = rr[:64], er[:64]
    t_gpu, p_gpu = engine.predict_beam_compact(sig, rr, ev, er, max_len, 5, aux=aux)
    cpu = BasecallEngine(params, cfg, device="cpu", **bench)
    t_cpu, p_cpu = cpu.predict_beam_compact(sig, rr, ev, er, max_len, 5, aux=aux)
    agree = float((t_gpu == t_cpu).mean())
    print(f"  bench settings, card vs CPU on 64 snippets: tokens agree {agree:.5f} (need >= 0.998), "
          f"rows identical {float((t_gpu == t_cpu).all(axis=1).mean()):.4f}; 4-bit probs on "
          f"the 16 levels {bool(np.isin(np.round(p_gpu * 15, 4), np.arange(16)).all())}")
    require(t_gpu.shape == (64, engine._fetch_width(max_len)) and np.isfinite(p_gpu).all(),
            "bad result shape or probs")
    require(np.isin(np.round(p_gpu * 15, 4), np.arange(16)).all(), "probs off the 4-bit levels")
    require(agree >= 0.998, "card and CPU disagree on the bench path's tokens")
    return counts


def phase_beam_step_i8() -> list:
    """The int8 beam step (beam_cell, then the int8 beam_attend: quant, then
    quant_mxu) against beam_step_plain at phase 3's shape and seed, on int8
    memory from setup_memory(..., "i8"): 40 steps each, every step fed the
    plain version's state, with the attend kernel also against attend_plain
    fed the plain cell's outputs (phase 3's bars). Times the step and the
    attend kernel at S=232 and S=8 beside their bounds and plain versions,
    the bf16 step on the same decoder, and the quantization per 4096-row
    chunk."""
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_step_cuda import (
        attend_plain, beam_attend, beam_cell, beam_step, beam_step_plain, cell_plain,
        initial_state, pack_decoder_weights,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)  # phase 3's decoder and memory
    B, S, U, W, V, E, steps = 4096, 232, 128, 5, 7, 256, 40
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    memory, mask = encoder_like_memory(gen, B, S, E, dev)
    layer = dec_p["attention_layer"]
    mem = attn.setup_memory(dec_p["attention"], memory, mask, "i8", attention_layer=layer)
    quant_ms = time_ms(lambda: (attn.quantize_rows(mem.keys.float()),
                                attn.quantize_rows(mem.values.float())), reps=5)
    setup_i8_ms = time_ms(lambda: attn.setup_memory(dec_p["attention"], memory, mask, "i8",
                                                    attention_layer=layer), reps=5)
    setup_bf16_ms = time_ms(lambda: attn.setup_memory(dec_p["attention"], memory, mask,
                                                      torch.bfloat16, attention_layer=layer), reps=5)
    bf16 = attn.setup_memory(dec_p["attention"], memory, mask, torch.bfloat16, attention_layer=layer)
    del memory
    w = pack_decoder_weights(dec_p, mem)
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    scales = (mem.kscale.contiguous(), mem.vscale.contiguous())
    k8, v8, m8 = keys[:, :8].contiguous(), values[:, :8].contiguous(), mask[:, :8].contiguous()
    scales8 = tuple(x[:, :8].contiguous() for x in scales)
    st0 = initial_state(B, W, U, 2, dev)
    bf16_ms = time_ms(lambda: beam_step(st0, bf16.keys, bf16.values, mask, w, 1), reps=40)
    del bf16
    print(f"  int8 memory per chunk of {B} rows: the quantization {quant_ms:.4f} ms (two "
          f"quantize_rows on f32 keys and values); setup_memory i8 {setup_i8_ms:.4f} ms, "
          f"bf16 {setup_bf16_ms:.4f} ms")
    tol = 1e-2  # cumulative log-prob; phase 3's bar
    out = []
    for name, mxu in (("beam_attend_i8", False), ("beam_attend_i8mxu", True)):
        attend = {"tok": 0, "par": 0, "n": 0, "err": 0.0}

        def attend_alone(st, ref, rpar):
            """The attend kernel against attend_plain on the plain cell's outputs."""
            got, gpar = beam_attend(st, *cell_plain(st, w), keys, values, mask, w, 1, scales, mxu)
            tok_eq = got.tok.reshape(B, W) == ref.tok.reshape(B, W)
            both = tok_eq & (gpar == rpar)
            attend["tok"] += tok_eq.sum().item()
            attend["par"] += (gpar == rpar).sum().item()
            attend["n"] += B * W
            if both.any():
                attend["err"] = max(attend["err"], (got.cum - ref.cum).abs()[both].max().item())

        tok_share, par_share, err, st = check_steps(
            f"int8 step ({name})", lambda st: beam_step(st, keys, values, mask, w, 1, scales, mxu),
            lambda st: beam_step_plain(st, keys, values, mask, w, 1, scales, mxu), st0, steps, B,
            W, tol, extra=attend_alone)
        a_tok, a_par = attend["tok"] / attend["n"], attend["par"] / attend["n"]
        require(a_tok >= 0.998 and a_par >= 0.998, f"{name}: token/parent agreement < 0.998")
        require(attend["err"] <= tol, f"{name}: score error {attend['err']:.3e} > {tol}")

        # times on a mid-decode state, at S=232 and at S=8
        hn, cn, ah = beam_cell(st, w)
        t = {}
        for tag, (k, v, m, sc) in (("232", (keys, values, mask, scales)),
                                   ("8", (k8, v8, m8, scales8))):
            t["step" + tag] = time_ms(lambda: beam_step(st, k, v, m, w, 1, sc, mxu), reps=40)
            t["step_plain" + tag] = time_ms(
                lambda: beam_step_plain(st, k, v, m, w, 1, sc, mxu), reps=3)
            t["att" + tag] = time_ms(
                lambda: beam_attend(st, hn, cn, ah, k, v, m, w, 1, sc, mxu), reps=40)
            t["att_plain" + tag] = time_ms(
                lambda: attend_plain(st, hn, cn, ah, k, v, m, w, 1, sc, mxu), reps=3)
        peak = H100_INT8_OPS if mxu else H100_BF16_FLOPS
        bound, by = beam_step_bounds(B, S, U, W, V, 1, scale_bytes=8, mem_peak=peak)
        bound8, _ = beam_step_bounds(B, 8, U, W, V, 1, scale_bytes=8, mem_peak=peak)
        att_bound, att_by = beam_attend_bounds(B, S, U, W, V, 1, scale_bytes=8, mem_peak=peak)
        att_bound8, _ = beam_attend_bounds(B, 8, U, W, V, 1, scale_bytes=8, mem_peak=peak)
        print(f"  int8 step (beam_cell + {name}) B={B} S={S} W={W}, {steps} steps: tokens agree "
              f"{tok_share:.5f}, parents agree {par_share:.5f} (need >= 0.998); score "
              f"max_abs_err {err:.3e} (tol {tol:g}); {name} alone, fed the plain cell: tokens "
              f"agree {a_tok:.5f}, parents agree {a_par:.5f} (need >= 0.998), score max_abs_err "
              f"{attend['err']:.3e} (tol {tol:g})")
        print(f"  int8 step ({name}): S={S} {t['step232']:.4f} ms/step, plain "
              f"{t['step_plain232']:.4f}, bound {bound:.4f} ({by}); S=8 {t['step8']:.4f} ms/step, "
              f"plain {t['step_plain8']:.4f}, bound {bound8:.4f}; the bf16 step in this run "
              f"{bf16_ms:.4f} ms/step")
        print(f"  {name}: S={S} {t['att232']:.4f} ms, plain {t['att_plain232']:.4f} ms, bound "
              f"{att_bound:.4f} ms ({att_by}); S=8 {t['att8']:.4f} ms, plain "
              f"{t['att_plain8']:.4f} ms, bound {att_bound8:.4f} ms", flush=True)
        variant = "quant_mxu" if mxu else "quant"
        out.append({"name": name, "route": "cuda",
                    "source": "ravvent_tpu_torch/csrc/beam_step_f.cu",
                    "replaces": f"ravvent_tpu/ops/beam_loop_pallas.py:333 ({variant})",
                    "max_abs_err": attend["err"], "ms": t["att232"],
                    "plain_ms": t["att_plain232"], "bound_ms": att_bound, "bound_by": att_by,
                    "library_ms": None})
    return out


def phase_bench_path_i8(smi: str) -> dict:
    """bench.py's path on int8 memory (--memory i8, then i8mxu): the 4
    simulated reads as chiron files through PerformanceEvaluator and
    MappingEvaluator on the bench's other settings. Returns each memory
    mode's launch counts."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.data import chiron
    from ravvent_tpu_torch.data.snippets import load_read_compact_ex
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
    from ravvent_tpu_torch.ops import cuda_lib

    cfg, params = flagship_params()
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = []
        for i, (raw, ranges, seq) in enumerate(simulated_reads()):
            chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", raw, ranges, seq)
            paths.append(str(d / f"r{i}.signal"))
        info = d / "files_info.json"
        info.write_text(json.dumps([{"signal_path": p} for p in paths]))
        cache = str(d / "cache")
        sig, rr, ev, er, nuc, aux = load_read_compact_ex(paths[0], Path(paths[0]).with_suffix(
            ".label"), 6, cache_dir=cache)
        max_len = int((nuc != 0).sum(axis=1).max())
        for memory in ("i8", "i8mxu"):
            step, attend = ("beam_step_i8mxu", "beam_attend_i8mxu") if memory == "i8mxu" else (
                "beam_step_i8", "beam_attend_i8")
            bench = dict(chunk_size=4096, memory_dtype=memory, beam_impl="step",
                         encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev",
                         prob_bits=4)
            engine = BasecallEngine(params, cfg, **bench)
            pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=cache)
            me = MappingEvaluator(engine, beam_width=5, cache_dir=cache)
            pe.run(paths[0])  # warm-up; fills the read cache
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            per_read = pe.evaluate_files(info, d / "perf.json", verbose=False)
            t1 = time.perf_counter()
            records = me.evaluate_files(info, d / "map.json", verbose=False)
            totals = MappingEvaluator.compute_total_results(d / "map.json")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            counts[memory] = dict(cuda_lib.launches)
            c = counts[memory]
            bases = sum(r["bases_num"] for r in per_read)
            proc = sum(r["total_processing"] for r in per_read)
            print(f"  --memory {memory}: PerformanceEvaluator.evaluate_files, {len(per_read)} "
                  f"reads, {bases} bases: {bases / proc:.1f} bases/s over total_processing "
                  f"{proc:.3f} s (predict {sum(r['t_predicting'] for r in per_read):.3f} s, merge "
                  f"{sum(r['t_merge'] for r in per_read):.3f} s; evaluator {t1 - t0:.3f} s) "
                  f"[{smi}]")
            print(f"  --memory {memory}: MappingEvaluator.evaluate_files {t2 - t1:.3f} s, "
                  f"mapper {sorted({r['mapper'] for r in records})}; compute_total_results "
                  f"(identity total, valid, invalid %) {totals} (seeded weights: not held)")
            print(f"  launches: {step} {c[step]} (beam_cell {c['beam_cell']}, {attend} "
                  f"{c[attend]}), bilstm_bf16 {c['bilstm_bf16']}; beam_step {c['beam_step']}, "
                  f"beam_attend {c['beam_attend']}, bilstm {c['bilstm']}, beam_loop "
                  f"{c['beam_loop']}, decode_step {c['decode_step']}")
            require(c[step] > 0 and c["bilstm_bf16"] > 0,
                    f"--memory {memory}: the path did not launch its kernels")
            require(c["beam_cell"] == c[attend] == c[step],
                    f"--memory {memory}: an int8 step did not launch beam_cell and {attend} once "
                    f"each")
            others = [k for k in c if k not in (step, attend, "beam_cell", "bilstm_bf16")]
            require(all(c[k] == 0 for k in others),
                    f"--memory {memory}: launched a kernel of another path")
            require(len(records) == len(paths) and bases > 0, "the evaluators missed a read")

            # the card against the CPU (plain versions) on 64 snippets: the
            # decode of the card's int8 memory, and end to end
            cpu = BasecallEngine(params, cfg, device="cpu", **bench)
            with torch.inference_mode():
                (raw_c, event_c), = engine.compact_snippets(sig, rr[:64], ev, er[:64], aux)
                mem = engine.memory(raw_c, event_c)
                mem_cpu = mem.to("cpu")
                same_mem = float((top_beam_tokens(engine, mem, max_len)
                                  == top_beam_tokens(cpu, mem_cpu, max_len)).float().mean())
                mem_host = cpu.memory(raw_c.cpu(), event_c.cpu())
                flips = float((mem_host.keys != mem_cpu.keys).float().mean())
            t_gpu, p_gpu = engine.predict_beam_compact(sig, rr[:64], ev, er[:64], max_len, 5,
                                                       aux=aux)
            t_cpu, _ = cpu.predict_beam_compact(sig, rr[:64], ev, er[:64], max_len, 5, aux=aux)
            agree = float((t_gpu == t_cpu).mean())
            print(f"  --memory {memory}, card vs CPU on 64 snippets: decoding the card's int8 "
                  f"memory, tokens agree {same_mem:.5f} (need >= 0.998); end to end, tokens agree "
                  f"{agree:.5f} (need >= 0.99), rows identical "
                  f"{float((t_gpu == t_cpu).all(axis=1).mean()):.4f}; the two encoders' int8 keys "
                  f"differ on {flips:.5f} of the codes")
            require(t_gpu.shape == (64, engine._fetch_width(max_len)) and np.isfinite(p_gpu).all(),
                    "bad result shape or probs")
            require(same_mem >= 0.998,
                    f"--memory {memory}: card and CPU decode the same memory differently")
            # as phase 4: seeded weights give flat, near-tied beams, and the
            # bf16 encoder kernel's last-bit differences from its plain version
            # (phase 9's bars) flip int8 codes, which can flip a tie
            require(agree >= 0.99, f"--memory {memory}: card and CPU disagree end to end")
    return counts


def peak_scan_bounds(B: int, S: int) -> tuple:
    """The least time of the peak scan on B reads of S samples: t1 and t2
    read once, n_valid read, the fired mask and ok written once; against 14
    f32 subtractions and compares a step over every block's 512 samples and
    every warm-up but block 0's (at the f32 rate). Its real limit is
    neither: a thread's chain of 768 dependent steps."""
    C = -(-S // 512)
    ops = 14 * B * (C * 512 + (C - 1) * 256)
    nbytes = B * S * (4 + 4 + 1) + B * (4 + 1)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S * 1e3, ops / H100_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profiled_ms(fn, calls: int = 20) -> str:
    """Each CUDA kernel's device time a call of fn(), by torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {e.key: getattr(e, "device_time_total", getattr(e, "cuda_time_total", 0.0))
             for e in prof.key_averages()}
    times = {k: v / calls / 1e3 for k, v in times.items() if v > 0}
    if not times:
        return "not measured (no device time in the trace)"
    def short(name):  # the kernel's own name, without namespace and parameters
        return re.sub(r"\(.*", "", name.replace("(anonymous namespace)::", ""))[-48:]
    return ", ".join(f"{short(k)} {v:.4f} ms" for k, v in sorted(times.items()))


def failing_traces() -> list:
    """Two t-statistic traces whose blocked check fails
    (tests/test_torch_cuda_emu.py's): an ancient dip no warm-up sees, and a
    slow rise that hides a valid peak from every block after the first,
    whose sequential fire at sample 1503 the blocked scan misses."""
    dip = np.full(4096, 1.0, np.float32)
    dip[:50], dip[60] = 5.0, 0.1
    rise = np.full(2048, 1.0, np.float32)
    rise[100], rise[101] = 2.0, 1.7
    rise[102:1500] = (2.1 + 0.001 * np.arange(1398)).astype(np.float32)
    rise[1500:] = rise[1499] - np.float32(0.1)
    return [dip, rise]


def phase_signal_wire(smi: str) -> tuple:
    """The signal-only wire: the peak-scan kernel against its plain version,
    the engine's segmentation on the card against the CPU's, and bench.py's
    sigdev/sigdev8 pipelines and the mapping evaluator on the 4 simulated
    reads with the bench's settings. Returns (the kernel's line, the launch
    counts of the wire's runs)."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.data import chiron
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.ops.event_detect import compute_tstats_device, peak_scan_plain
    from ravvent_tpu_torch.ops.peak_scan_cuda import peak_scan_cuda

    dev = torch.device("cuda")
    cfg, params = flagship_params()
    bench = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
                 encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    engine = BasecallEngine(params, cfg, **bench)
    cpu = BasecallEngine(params, cfg, device="cpu", **bench)
    reads = simulated_reads()
    raws = [raw for raw, _, _ in reads]

    # the kernel against its plain version on the card: the 4 reads in one
    # batch on each wire (their t-statistics as the engine computes them)
    S_b = BasecallEngine._bucket(max(r.size for r in raws), 65536)
    err, ok_all, fires = 0, True, {}
    for sig_wire in ("i16", "u8"):
        buf = engine._upload({"b": engine.signal_buffer(raws, S_b, sig_wire)})["b"]
        hdr = buf[:, :32].view(torch.float32)
        n_s = buf[:, 8:12].view(torch.int32)[:, 0].contiguous()
        x = (buf[:, 32:32 + S_b].float() * hdr[:, 4:5] + hdr[:, 3:4] if sig_wire == "u8"
             else buf[:, 32:32 + 2 * S_b].view(torch.int16).float())
        t1, t2 = (compute_tstats_device(x, w, 9, n_s) for w in (6, 9))
        got, ok = peak_scan_cuda(t1, t2, n_s, 6, 9)
        ref = peak_scan_plain(t1, t2, 6, 9, n_valid=n_s)
        torch.cuda.synchronize()
        err = max(err, int((got != ref).sum().item()))
        ok_all = ok_all and bool(ok.all())
        fires[sig_wire] = got.sum(dim=1).tolist()
    for trace in failing_traces():
        t = torch.from_numpy(trace[None]).to(dev)
        nv = torch.tensor([t.shape[1]], dtype=torch.int32, device=dev)
        got, ok = peak_scan_cuda(t, t, nv, 6, 9)
        ref = peak_scan_plain(t, t, 6, 9, n_valid=nv)
        err = max(err, int((got != ref).sum().item()))
        require(not bool(ok.item()), "peak_scan: a failing trace passed the check")
    print(f"  peak_scan on the 4 reads ({S_b} samples, fires i16 {fires['i16']}, u8 "
          f"{fires['u8']}) and the 2 failing traces: {err} fired samples differ from the plain "
          f"version (need 0); the check passed on every read {ok_all}", flush=True)
    require(err == 0 and ok_all, "peak_scan disagrees with its plain version")
    timing = {}
    for S in (131072, 196608):
        n = min(raws[0].size, S)
        x = torch.zeros(1, S, device=dev)
        x[0, :n] = torch.from_numpy(raws[0][:n].astype(np.float32)).to(dev)
        nv = torch.tensor([n], dtype=torch.int32, device=dev)
        t1, t2 = (compute_tstats_device(x, w, 9, nv) for w in (6, 9))
        ms = time_ms(lambda: peak_scan_cuda(t1, t2, nv, 6, 9), reps=50, warmup=3)
        plain_ms = time_ms(lambda: peak_scan_plain(t1, t2, 6, 9, n_valid=nv), reps=1)
        bound, by = peak_scan_bounds(1, S)
        timing[S] = (ms, plain_ms, bound, by)
        print(f"  peak_scan, one read of {S} samples ({-(-S // 512)} blocks, a chain of 768 "
              f"steps): kernel {ms:.4f} ms a call (the scan and the check, CUDA events over 50 "
              f"calls), plain {plain_ms:.3f} ms, bound {bound:.5f} ms ({by}); device time a call "
              f"by torch.profiler: {profiled_ms(lambda: peak_scan_cuda(t1, t2, nv, 6, 9))} "
              f"[{smi}]", flush=True)

    # the engine's segmentation on the card against the CPU engine's
    worst, meta = 0.0, {}
    for i, raw in enumerate(raws):
        for sig_wire in ("i16", "u8"):
            sb = BasecallEngine._bucket(raw.size, 65536)
            E_b, N_max = sb // 2, sb // 2 // 6 + 1 + engine.chunk_size
            buf = engine._upload({"b": engine.signal_buffer([raw], sb, sig_wire)})["b"][0]
            got = [x.cpu() for x in engine._segment(buf, sb, E_b, N_max, 6, sig_wire)]
            meta[i, sig_wire] = (int(got[4][0]), int(got[4][1]), E_b)
            if sig_wire == "u8":
                continue
            ref = cpu._segment(buf.cpu(), sb, E_b, N_max, 6)
            require(torch.equal(got[4], ref[4]) and torch.equal(got[2], ref[2])
                    and torch.equal(got[3], ref[3]),
                    f"read {i}: segmentation meta or ranges on the card differ from the CPU's")
            worst = max(worst, (got[1] - ref[1]).abs().max().item())
    print(f"  segmentation, card vs CPU engine on the 4 reads (i16): meta and snippet ranges "
          f"bit-equal; (events, snippets) {[meta[i, 'i16'][:2] for i in range(4)]}, u8 "
          f"{[meta[i, 'u8'][:2] for i in range(4)]}; features max abs err {worst:.3e} "
          f"(need <= 1e-3)", flush=True)
    require(worst <= 1e-3, "segmentation features on the card miss the CPU's")
    require(all(n_true <= E_b for n_true, _, E_b in meta.values()),
            "a read overflowed the segmentation buffer")

    # card against CPU tokens on the first read's first 64 snippets
    seg = engine.begin_beam_signal(raws[0])
    seg_cpu = cpu.begin_beam_signal(raws[0])
    n_true, _ = engine._signal_meta(seg)
    first64 = torch.tensor([[n_true, 64]], dtype=torch.int32)
    t_gpu, p_gpu = engine.collect_beam_compact(engine.finish_beam_signal(
        seg._replace(meta_host=first64), beam_width=5))
    t_cpu, _ = cpu.collect_beam_compact(cpu.finish_beam_signal(
        seg_cpu._replace(meta_host=first64), beam_width=5))
    agree = float((t_gpu == t_cpu).mean())
    with torch.inference_mode():  # the decode of the card's encoder memory on both
        mem = engine.memory(*engine.signal_snippets(seg, 0, 64))
        same_mem = float((top_beam_tokens(engine, mem, 40)
                          == top_beam_tokens(cpu, mem.to("cpu"), 40)).float().mean())
    print(f"  sigdev, bench settings, card vs CPU on 64 snippets: decoding the card's memory, "
          f"tokens agree {same_mem:.5f} (need >= 0.998); end to end, tokens agree {agree:.5f} "
          f"(need >= 0.99), rows identical {float((t_gpu == t_cpu).all(axis=1).mean()):.4f}")
    require(t_gpu.shape == t_cpu.shape and t_gpu.shape[0] == 64 and np.isfinite(p_gpu).all(),
            "bad result shape or probs")
    require(same_mem >= 0.998, "card and CPU decode the signal-only wire's memory differently")
    # as phases 4 and 12: the inputs are bit-equal (above), but seeded
    # weights give flat, near-tied beams, and the bf16 encoder kernel's
    # last-bit differences from its plain version (phase 9's bars) can flip
    # a tie
    require(agree >= 0.99, "card and CPU disagree on the signal-only wire's tokens")

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = []
        for i, (raw, ranges, seq) in enumerate(reads):
            chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", raw, ranges, seq)
            paths.append(str(d / f"r{i}.signal"))
        (d / "files_info.json").write_text(json.dumps([{"signal_path": p} for p in paths]))
        cache = str(d / "cache")
        compact = PerformanceEvaluator(engine, beam_width=5, cache_dir=cache)
        compact.run_pipelined(paths, inflight=8, finishers=4)  # warm-up; fills the read cache
        rec_compact = compact.run_pipelined(paths, inflight=8, finishers=4)
        evs = {w: PerformanceEvaluator(engine, beam_width=5, cache_dir=cache, wire=w)
               for w in ("sigdev", "sigdev8")}
        me = MappingEvaluator(engine, beam_width=5, cache_dir=cache, wire="sigdev")
        fallbacks = []  # reads that took the compact wire

        def noting_fallback(dispatch):
            def wrapped(path):
                fallbacks.append(path)
                return dispatch(path)
            return wrapped

        def noting_overflow(basecall):
            def wrapped(path, label_path):
                out = basecall(path, label_path)
                if out is None:
                    fallbacks.append(path)
                return out
            return wrapped

        for ev in evs.values():
            ev._dispatch_compact = noting_fallback(ev._dispatch_compact)
        me._basecall_read_sigdev = noting_overflow(me._basecall_read_sigdev)
        for ev in evs.values():  # warm-up, as the compact wire's
            ev.run_pipelined(paths, inflight=8, finishers=4)
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        recs = {w: ev.run_pipelined(paths, inflight=8, finishers=4) for w, ev in evs.items()}
        t0 = time.perf_counter()
        records = me.evaluate_files(d / "files_info.json", d / "map.json", verbose=False)
        totals = MappingEvaluator.compute_total_results(d / "map.json")
        torch.cuda.synchronize()
        t_map = time.perf_counter() - t0
        counts = dict(cuda_lib.launches)
    for w, rec in [("compact", rec_compact)] + list(recs.items()):
        print(f"  run_pipelined {w}, inflight 8, finishers 4: {rec['bases_per_s']:.1f} bases/s, "
              f"wall {rec['wall_s']:.3f} s, stages {rec['stages_s']} [{smi}]")
    print(f"  MappingEvaluator sigdev: {t_map:.3f} s, mapper {sorted({r['mapper'] for r in records})}"
          f"; compute_total_results (identity total, valid, invalid %) {totals} (seeded weights: "
          f"not held)")
    # segmentation dispatches: 4 reads on each of the three runs
    dispatches = 3 * len(paths)
    chunks = sum(-(-meta[i, w][1] // engine.chunk_size)
                 for i in range(len(paths)) for w in ("i16", "u8", "i16"))
    print(f"  launches: peak_scan {counts['peak_scan']} ({dispatches} segmentations, need 2 each), "
          f"bilstm_bf16 {counts['bilstm_bf16']} ({chunks} chunks, need 4 each), beam_step "
          f"{counts['beam_step']} (beam_cell {counts['beam_cell']}, beam_attend "
          f"{counts['beam_attend']}); reads on the compact wire {len(fallbacks)} (need 0)")
    require(not fallbacks, "a read fell back to the compact wire")
    require(counts["peak_scan"] == 2 * dispatches, "peak_scan did not launch twice a segmentation")
    require(counts["bilstm_bf16"] == 4 * chunks, "bilstm_bf16 did not launch 4 a chunk")
    require(counts["beam_step"] > 0 and counts["beam_cell"] == counts["beam_attend"]
            == counts["beam_step"], "a bf16 step did not launch beam_cell and beam_attend once each")
    require(all(rec["bases_num"] == rec_compact["bases_num"] for rec in recs.values())
            and len(records) == len(paths), "the signal-only runs counted other reads or bases")
    ms, plain_ms, bound, by = timing[131072]
    return ({"name": "peak_scan", "route": "cuda", "source": "ravvent_tpu_torch/csrc/peak_scan.cu",
             "replaces": "ravvent_tpu/ops/event_detect.py:210", "max_abs_err": float(err),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
             "library_ms": None}, counts)


def top_beam_tokens(engine, mem, max_len: int, beams: int = 1) -> torch.Tensor:
    """The engine's beam decode of ``mem`` (beam 5, ``max_len - 1`` live
    steps): the top ``beams`` beams' tokens over the live steps, on the host
    ([N, max_len - 1, beams])."""
    from ravvent_tpu_torch.evaluation.basecall import TOTAL_STEPS
    from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop, fused_beam_decode
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER

    res = fused_beam_decode(engine.params["decoder"], mem, engine.cfg.vocab_size, 5, TOTAL_STEPS,
                            max_len - 1, start_token=NUC_TOKENIZER.start_id,
                            end_token=NUC_TOKENIZER.end_id, loop=beam_step_loop,
                            quant_mxu=engine.quant_mxu)
    return res.tokens[:, :max_len - 1, :beams].cpu()


def phase_greedy_engine(smi: str) -> dict:
    """BasecallEngine.predict_greedy on the first read's snippets with the
    CLI's settings (f32 encoder stream, bf16 memory) and the bench's (bf16
    stream): the BiLSTM kernel of the stream 4 times a chunk, then plain
    greedy steps over the pre-projected memory; against a CPU engine on 64
    snippets, decoding the card's memory and end to end. Returns each
    setting's launch counts."""
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.decode.greedy import greedy_decode
    from ravvent_tpu_torch.evaluation.basecall import TOTAL_STEPS, BasecallEngine
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN

    cfg, params = flagship_params()
    raw, ranges, _ = simulated_reads()[0]
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    counts = {}
    for name, kw, kernel in (("CLI", {}, "bilstm"),
                             ("bench", dict(encoder_dtype=torch.bfloat16), "bilstm_bf16")):
        card = BasecallEngine(params, cfg, chunk_size=4096, **kw)
        cpu = BasecallEngine(params, cfg, chunk_size=4096, device="cpu", **kw)
        with torch.inference_mode():
            raw_c, event_c = (torch.cat(x) for x in zip(*card.compact_snippets(sig, rr, ev, er)))
        raw_h, event_h = raw_c.cpu().numpy(), event_c.cpu().numpy()
        n = raw_h.shape[0]
        card.predict_greedy(raw_h[:256], event_h[:256], MAX_OUTPUT_LEN)  # warm-up
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        tok, logits = card.predict_greedy(raw_h, event_h, MAX_OUTPUT_LEN)
        wall = time.perf_counter() - t0
        c = counts[name] = dict(cuda_lib.launches)
        chunks = -(-n // card.chunk_size)
        others = sum(v for k, v in c.items() if k != kernel)
        print(f"  predict_greedy, {name} settings, one read: snippets {n}, {wall:.4f} s "
              f"({n / wall:.1f} snippets/s); launches: {kernel} {c[kernel]} over {chunks} chunks "
              f"(need 4 a chunk), other kernels {others} (need 0) [{smi}]")
        require(c[kernel] == 4 * chunks, f"{kernel} did not launch 4 times a chunk")
        require(others == 0, "greedy decode launched a beam or decode-step kernel")
        T = card._fetch_width(MAX_OUTPUT_LEN)
        require(tok.shape == (n, T) and logits.shape == (n, T, cfg.vocab_size)
                and np.isfinite(logits).all(), "bad greedy result shape or logits")
        # all_done couples a call's rows: card and CPU decode the same 64 rows
        with torch.inference_mode():
            mem = card.memory(raw_c[:64], event_c[:64])
            same = [greedy_decode(e.params["decoder"], m, cfg.vocab_size, TOTAL_STEPS,
                                  MAX_OUTPUT_LEN - 1, start_token=NUC_TOKENIZER.start_id,
                                  end_token=NUC_TOKENIZER.end_id)[0].cpu()
                    for e, m in ((card, mem), (cpu, mem.to("cpu")))]
        same_mem = float((same[0] == same[1]).float().mean())
        t_cpu, l_cpu = cpu.predict_greedy(raw_h[:64], event_h[:64], MAX_OUTPUT_LEN)
        t_gpu, l_gpu = card.predict_greedy(raw_h[:64], event_h[:64], MAX_OUTPUT_LEN)
        agree = float((t_gpu == t_cpu).mean())
        print(f"  predict_greedy, {name} settings, card vs CPU on 64 snippets: decoding the "
              f"card's memory, tokens agree {same_mem:.5f} (need >= 0.998); end to end, tokens "
              f"agree {agree:.5f} (need >= 0.99); logits max abs diff "
              f"{float(np.abs(l_gpu - l_cpu).max()):.3e}, finite {bool(np.isfinite(l_gpu).all())}")
        require(np.isfinite(l_gpu).all(), "greedy logits not finite")
        require(same_mem >= 0.998, "card and CPU greedy-decode the same memory differently")
        # as phases 4 and 12: seeded weights give near-ties that the encoder
        # kernels' last-bit differences from their plain versions can flip
        require(agree >= 0.99, "card and CPU disagree on the greedy tokens end to end")
    return counts


def phase_multibeam(smi: str) -> dict:
    """Top-K beams: the bench's settings with n_beams=3 through
    predict_beam_compact on the 4 reads, beam 0 against an n_beams=1 engine
    bit for bit with the same launches; the 3 beams against a CPU engine on
    64 snippets (decoding the card's memory, and end to end); then
    MappingEvaluator over the reads on the compact wire (the beam selection)
    and on sigdev (the top beam). Returns the n_beams=3 run's launches."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.data.snippets import load_read_compact_ex
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tools.profile_decode import write_reads

    K = 3
    cfg, params = flagship_params()
    bench = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
                 encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    one = BasecallEngine(params, cfg, **bench)
    top_k = BasecallEngine(params, cfg, n_beams=K, **bench)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = write_reads(simulated_reads(), d)
        (d / "files_info.json").write_text(json.dumps([{"signal_path": p} for p in paths]))
        cache = str(d / "cache")
        loaded = [load_read_compact_ex(p, Path(p).with_suffix(".label"), 6, cache_dir=cache)
                  for p in paths]
        sig, rr, ev, er, nuc, aux = loaded[0]
        max_len = int((nuc != 0).sum(axis=1).max())
        for engine in (top_k, one):  # warm-up at a read's full size (the allocator's first blocks)
            engine.predict_beam_compact(sig, rr, ev, er, max_len, 5, aux=aux)
        counts, out, wall = {}, {}, {}
        for k, engine in ((K, top_k), (1, one)):
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            out[k] = [engine.predict_beam_compact(s, r, e, q, int((n != 0).sum(axis=1).max()), 5,
                                                  aux=a) for s, r, e, q, n, a in loaded]
            wall[k] = time.perf_counter() - t0
            counts[k] = dict(cuda_lib.launches)
        same = all(np.array_equal(tk[:, 0], t1) and np.array_equal(pk[:, 0], p1)
                   for (tk, pk), (t1, p1) in zip(out[K], out[1]))
        shapes = [tk.shape for tk, _ in out[K]]
        off = float(np.mean([(t[:, 1] != t[:, 0]).any(axis=1).mean() for t, _ in out[K]]))
        print(f"  n_beams={K}, bench settings, 4 reads: shapes {shapes}, {wall[K]:.4f} s "
              f"(n_beams=1 {wall[1]:.4f} s); beam 0 equals n_beams=1 bit for bit {same}; beam 1 "
              f"differs from beam 0 on {off:.4f} of the rows [{smi}]")
        print(f"  launches, n_beams={K}: {counts[K]}; n_beams=1: {counts[1]}")
        require(all(s[1] == K for s in shapes), "n_beams=3 did not return [N, 3, T]")
        require(same, "beam 0 of n_beams=3 differs from n_beams=1")
        require(counts[K] == counts[1], "n_beams=3 launched other kernels than n_beams=1")
        require(counts[K]["beam_cell"] == counts[K]["beam_attend"] == counts[K]["beam_step"] > 0,
                "a step did not launch beam_cell and beam_attend once each")

        # the card against the CPU on 64 snippets: the card's memory, and end to end
        cpu = BasecallEngine(params, cfg, device="cpu", n_beams=K, **bench)
        with torch.inference_mode():
            (raw_c, event_c), = top_k.compact_snippets(sig, rr[:64], ev, er[:64], aux)
            mem = top_k.memory(raw_c, event_c)
            same_mem = (top_beam_tokens(top_k, mem, max_len, K)
                        == top_beam_tokens(cpu, mem.to("cpu"), max_len, K)).float()
            same_mem = same_mem.mean(dim=(0, 1)).tolist()
        t_gpu, p_gpu = top_k.predict_beam_compact(sig, rr[:64], ev, er[:64], max_len, 5, aux=aux)
        t_cpu, _ = cpu.predict_beam_compact(sig, rr[:64], ev, er[:64], max_len, 5, aux=aux)
        agree = [float((t_gpu[:, k] == t_cpu[:, k]).mean()) for k in range(K)]
        # a lower beam's row that differs: is its sequence among the CPU's K
        # (near-tied hypotheses trading ranks) or a hypothesis of its own?
        cpu_sets = [set(map(tuple, row)) for row in t_cpu]
        among = [float(np.mean([tuple(t_gpu[i, k]) in cpu_sets[i] for i in range(64)]))
                 for k in range(K)]
        print(f"  n_beams={K}, card vs CPU on 64 snippets, by beam: decoding the card's memory, "
              f"tokens agree {np.round(same_mem, 5).tolist()} (need >= 0.998 each); end to end "
              f"{np.round(agree, 5).tolist()} (beam 0 needs >= 0.99); the card's beam among the "
              f"CPU's {K} on {np.round(among, 5).tolist()} of the rows")
        require(t_gpu.shape == t_cpu.shape == (64, K, top_k._fetch_width(max_len))
                and np.isfinite(p_gpu).all(), "bad top-K result shape or probs")
        require(min(same_mem) >= 0.998, "card and CPU decode the same memory's top-K differently")
        # as phases 4 and 12 (the top beam): the bf16 encoder kernel's
        # last-bit differences from its plain version can flip a near-tie of
        # seeded weights; the lower beams are closer ties still, and their
        # end-to-end figures are printed (ROADMAP.md section C)
        require(agree[0] >= 0.99, "card and CPU disagree on the top beam's tokens end to end")

        # MappingEvaluator: the selection on the compact wire, the top beam on sigdev
        picks, dims = [], []
        for wire in ("compact", "sigdev"):
            me = MappingEvaluator(top_k, beam_width=5, cache_dir=cache, wire=wire)
            select, predict = me._select_beams, top_k.predict_beam_signal

            def selecting(tokens, probs, rr, select=select):
                res = select(tokens, probs, rr)
                picks.append(int((res[0] != tokens[:, 0]).any(axis=1).sum()))
                return res

            def noting_dims(*a, predict=predict, **k):
                res = predict(*a, **k)
                dims.append(res[0].ndim)
                return res

            me._select_beams = selecting
            top_k.predict_beam_signal = noting_dims
            t0 = time.perf_counter()
            records = me.evaluate_files(d / "files_info.json", d / f"map_{wire}.json",
                                        verbose=False)
            del top_k.predict_beam_signal
            print(f"  MappingEvaluator(n_beams={K}) {wire}: {time.perf_counter() - t0:.3f} s, "
                  f"{len(records)} reads, mapper {sorted({r['mapper'] for r in records})}")
            require(len(records) == len(paths), f"MappingEvaluator {wire} missed a read")
        print(f"  beam selection on the compact wire: snippets off the top beam by read {picks} "
              f"(need one selection a read); sigdev results {dims}-D, no selection there")
        require(len(picks) == len(paths), "the beam selection did not run once a read")
        require(dims == [3] * len(paths), "sigdev did not return the top-K beams")
    return counts[K]


def phase_profile(smi: str) -> dict:
    """tools/profile_decode.py on the card: the legs of read 0's decode on
    the compact wire and on sigdev (bench settings), then one torch.profiler
    trace of run_pipelined over the 4 reads on the compact wire: the device's
    idle share, the top device operations, the longest idle gaps. Returns the
    trace's summary."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.tools import profile_decode as pd

    cfg, params = flagship_params()
    engine = BasecallEngine(params, cfg, chunk_size=4096, memory_dtype=torch.bfloat16,
                            beam_impl="step", encoder_dtype=torch.bfloat16, pack_u8=True,
                            transport_dtype="i8dev", prob_bits=4)
    reads = simulated_reads()
    need = ["host pack+unpack", "H2D upload", "device compute", "D2H fetch", "sum of legs",
            "end-to-end"]
    for wire, legs_of, extra in (
            ("compact", pd.compact_legs, []),
            ("sigdev", pd.signal_legs, ["begin_beam_signal", "meta wait", "finish+collect"])):
        legs = legs_of(engine, reads[0], 5, 3)
        pd.print_legs(legs, f"  profile_decode legs, read 0, {wire}, best of 3 [{smi}]")
        require(all(k in legs and np.isfinite(legs[k]) and legs[k] >= 0 for k in need + extra),
                f"profile_decode: a leg of the {wire} wire is missing")
    with tempfile.TemporaryDirectory() as tmp:
        paths = pd.write_reads(reads, Path(tmp))
        summary = pd.trace_pipelined(engine, paths, Path(tmp) / "trace", "compact", 5,
                                     cache_dir=str(Path(tmp) / "cache"))
    pd.print_trace(summary)
    print(f"  [{smi}]")
    require(summary["device_events"] > 0, "the profiler's trace holds no device event")
    require(0.0 <= summary["idle_share"] <= 1.0, "the device's idle share is outside [0, 1]")
    return summary


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
    k_bilstm = phase_bilstm(torch.float32)
    phase("2 bilstm kernel", t0)
    t0 = time.perf_counter()
    k_cell, k_attend = phase_beam_step()
    phase("3 beam_step: beam_cell + beam_attend", t0)
    t0 = time.perf_counter()
    counts = phase_end_to_end()
    require(counts["beam_loop"] == 0 and counts["decode_step"] == 0,
            "the step path launched a kernel of another path")
    phase("4 end to end", t0)
    t0 = time.perf_counter()
    k_loop = phase_beam_loop()
    phase("5 beam_loop kernel", t0)
    t0 = time.perf_counter()
    k_dstep = phase_decode_step()
    phase("6 decode_step kernel", t0)
    t0 = time.perf_counter()
    counts_loop = phase_end_to_end_loop()
    phase("7 end to end, beam_impl=loop", t0)
    t0 = time.perf_counter()
    counts_greedy = phase_greedy()
    phase("8 end to end, fused greedy", t0)
    t0 = time.perf_counter()
    k_bf16 = phase_bilstm(torch.bfloat16)
    phase("9 bilstm_bf16 kernel", t0)
    t0 = time.perf_counter()
    counts_bench = phase_bench_path(smi)
    phase("10 end to end, the bench's path", t0)
    t0 = time.perf_counter()
    k_i8, k_i8mxu = phase_beam_step_i8()
    phase("11 int8 beam step: beam_cell + beam_attend_i8 / beam_attend_i8mxu", t0)
    t0 = time.perf_counter()
    counts_i8 = phase_bench_path_i8(smi)
    phase("12 end to end, the bench's path on int8 memory", t0)
    t0 = time.perf_counter()
    k_peak, counts_sig = phase_signal_wire(smi)
    phase("13 end to end, the signal-only wire", t0)
    t0 = time.perf_counter()
    phase_greedy_engine(smi)
    phase("14 end to end, BasecallEngine.predict_greedy", t0)
    t0 = time.perf_counter()
    phase_multibeam(smi)
    phase("15 end to end, top-K beams (n_beams=3) and the beam selection", t0)
    t0 = time.perf_counter()
    phase_profile(smi)
    phase("16 tools/profile_decode.py: legs and a torch.profiler trace", t0)
    # launches of each kernel on its own path's run
    k_bilstm["launches"] = counts["bilstm"]
    k_cell["launches"] = counts["beam_cell"]
    k_attend["launches"] = counts["beam_attend"]
    k_loop["launches"] = counts_loop["beam_loop"]
    k_dstep["launches"] = counts_greedy["decode_step"]
    k_bf16["launches"] = counts_bench["bilstm_bf16"]
    k_i8["launches"] = counts_i8["i8"]["beam_attend_i8"]
    k_i8mxu["launches"] = counts_i8["i8mxu"]["beam_attend_i8mxu"]
    k_peak["launches"] = counts_sig["peak_scan"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in (
        k_bilstm, k_cell, k_attend, k_loop, k_dstep, k_bf16, k_i8, k_i8mxu, k_peak)]}))
    print(f"total: {time.perf_counter() - t_all:.2f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
