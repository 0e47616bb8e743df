"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's paths — the basecalling CLI's read path
(ravvent_tpu_torch/tools/basecall.py:basecall_read) with --beam-impl step
and with --beam-impl loop, fused greedy decode
(ops/decode_step_cuda.py:fused_greedy_decode), and bench.py's main path
(evaluation/performance.py:PerformanceEvaluator on the bench's engine
settings), the bench's path on int8 memory through PerformanceEvaluator
and MappingEvaluator (evaluation/mapping.py), the signal-only wire (sigdev,
sigdev8) through both, the engine's greedy decode, its top-K beams with the
mapping evaluator's beam selection, tools/profile_decode.py with a
torch.profiler trace of the bench's pipelined path, training
(training/loop.py:Trainer), the multi-device runs, the user CLIs
(tools/{make_dataset, train, evaluate, train_curriculum, sweep_epochs,
eval_token_acc}.py) and the bench's entry point (tools/bench.py), and the
engine's plain decode
(beam_impl="xla") on flagship32's shape and on GRU, unidirectional and
Bahdanau configurations — at the flagship's full width (joint raw+event
input, 2-layer BiLSTM encoder of 128 units, 1-layer LSTM decoder with Luong
attention, vocab 7, beam 5) on seeded random weights, and holds each
hand-written kernel against its plain PyTorch version on the card:

  0. device: the card, torch, CUDA and nvcc versions; TF32 off;
  1. build: nvcc builds the kernels from csrc/ (registers and shared memory
     per kernel from -Xptxas -v);
  2. the f32-stream BiLSTM kernel against its plain version for the four
     layer shapes of one chunk (F = 1, 2U, 5, 2U) at each compiled width
     (U = 64, 128, 256) at B=4096, and at 128 units also at B=2858 (the
     first read's rows), timed beside torch.nn.LSTM in f32;
  3. the bf16/f32 beam step, two kernels (beam_cell, then beam_attend),
     against its plain version at B=4096, S=232, U=128, W=5: bf16 memory
     over 40 steps, each kernel also against its own plain version on the
     same inputs, then f32 memory over 10 steps, each step fed the plain
     version's state; the pair and each kernel timed beside its bound, and
     the step at S=8 beside S=232; then the same holds at the other compiled
     widths (csrc/beam_step_shapes.cuh): U=64 and 256 at W=5 on bf16 (40
     steps) and f32 (10 steps), and W=6, 7, 10 and 16 at U=128 on bf16, each
     timed beside its bound with its attend CTA's threads, shared memory and
     occupancy;
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
     then the other widths of the step's sets, which the kernel runs on its
     streamed layout: U=64 and 256 (W=5, bf16 and f32) and W=6, 10, 16
     (U=128, bf16; W=16 also f32), B=4096, no beam ending, each replayed
     through the plain step and timed beside its bound and the beam step's
     39 launches, with its layout, cluster size and clusters at once;
  6. the decode-step kernel against its plain version at B=4096, S=232,
     f32 memory, 40 chained steps, each fed the plain version's state, at
     every (U, E) of csrc/decode_step_shapes.cuh (U=64, 128, 256; E=64,
     128, 256, 512), each timed beside its byte bound;
  7. end to end: the same 4 reads through the read path with
     beam_impl="loop" (one beam-loop launch per chunk, no beam-step launch),
     checked against the step path and the CPU on 64 snippets;
  8. end to end: the first read's snippets encoded by the BiLSTM kernel, as
     un-projected f32 memory, decoded by fused_greedy_decode on the card,
     checked against plain greedy_decode on the CPU on 64 snippets;
  9. the bf16-stream BiLSTM kernel against its plain version as phase 2
     holds the f32 one (each width at B=4096, 128 units also at B=2858),
     timed beside torch.nn.LSTM in bf16;
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
     quantization's time per chunk; then both branches at U=64 and 256 (W=5,
     40 steps) as phase 3 holds the other widths;
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
     operations running in them;
 17. training (ravvent_tpu_torch/training/loop.py:Trainer) at the
     flagship's width with TrainConfig's defaults (batch 128, lr 1e-4,
     clipnorm 1.0, scheduled sampling at p = 0.5) on batches of simulated
     reads (data/simulator.py into a temporary directory, then
     SnippetBatchGenerator): one train step's loss and gradients at p = 0
     on the card against the CPU from the same seeded weights and batch;
     fit for one epoch of 20 steps on a repeated batch (the loss finite and
     falling; seconds a step, peak device memory, and one step's launches
     by torch.profiler); validate_on_batch on the card against the CPU,
     which launches the f32 BiLSTM kernel 4 times a batch and no decode
     kernel; a checkpoint saved, restored into a new Trainer and validated
     again to the same loss. Training runs no hand-written kernel, as the
     JAX package's training reaches no Pallas kernel.
 18. the non-flagship configurations on seeded weights through
     BasecallEngine(beam_impl="xla"), the plain beam decode the JAX engine
     runs with XLA for every configuration: (a) flagship32's shape (joint,
     3 x BiLSTM(128), 2 x LSTM(128) + Luong, beam 5) over the 4 reads with
     the CLI's settings through its read path (decode seconds a read,
     bases/s) and with the bench's through
     PerformanceEvaluator.run_pipelined (bases/s, then one torch.profiler
     trace of it: the idle share and the top device operations): the
     stream's BiLSTM kernel 6 times a chunk, no beam or decode-step kernel; card and CPU
     tokens on 64 snippets, decoding the card's memory (>= 0.998) and end to
     end (>= 0.99); (b) bigru, gru and lstm on raw input and the flagship
     with Bahdanau attention, one engine each: encoder and decode ms of a
     512-snippet chunk, the same bars on 64 snippets; (c) "step" and "loop"
     refuse (a)'s configuration.
 19. multi-device runs on the one card (parallel/): (a) a
     ShardedBasecallEngine over a 2-shard mesh on cuda:0 with the bench's
     settings against the 1-shard engine, PerformanceEvaluator.run_pipelined
     over the 4 reads on the compact wire and on sigdev: every read's tokens
     and probabilities bit-equal, bilstm_bf16, beam_cell and beam_attend
     launched twice as often (each chunk's two shards), the segmentation's
     peak_scan as often, both walls printed; (b) data-parallel training, 2
     gloo ranks spawned on the card (parallel.distributed.spawn), 64 rows
     each of a global batch of 128 of phase 17's data, TrainConfig's
     defaults: the step's loss within 1e-5 relative of the single-process
     step on the card, the all-reduced gradients within 1e-5 of each leaf's
     largest magnitude, the two ranks' parameters bit-equal after it, the
     largest parameter difference printed in units of the learning rate,
     and 5 more steps timed on each; (d) the 'model' axis, a 1 x 2 and a
     2 x 2 grid (data x model) of gloo ranks spawned on the card, the
     attention memory's 230 positions split over each model row, the same
     global batch and defaults: each rank validates (bilstm 4 times, no
     plain route) then steps; loss within 1e-5 relative, gradients within
     1e-5 of each leaf's largest magnitude, validation loss within 1e-4,
     every rank's parameters bit-equal; each grid's step seconds printed
     beside (b)'s; (c) entry.dryrun_multichip(2) and (4) (a 2 x 2 grid),
     every rank on the card. A rank that fails fails the phase.
 18 (d). a 64-unit encoder (f32 stream and memory, beam_impl="step"): the
     first read on the card, every layer on the f32 BiLSTM kernel at 64
     units (bilstm 4 a chunk, bilstm_plain_route 0), the beam kernels as
     usual; card and CPU tokens on 64 snippets (>= 0.998); then on the bf16
     stream and memory (bilstm_bf16 4 a chunk; same memory >= 0.998, end to
     end >= 0.99); then a 48-unit encoder, a width the kernels are not
     compiled for, f32 as the first: every layer on its plain version on the
     card (bilstm_plain_route 4 a chunk, bilstm and bilstm_bf16 0), the beam
     kernels, tokens and same memory >= 0.998 against the CPU.
 18 (e). the slice's path at full width: a 256-unit encoder (joint, 2 x
     BiLSTM(256), LSTM(128) + Luong, vocab 7, seeded) through BasecallEngine
     at the bench's settings (i8dev wire, bf16 encoder stream, bf16 memory,
     4-bit probs, beam 5, "step") over the first read: bilstm_bf16 4 a chunk
     at 256 units, bilstm_plain_route 0, the beam kernels once a step; card
     and CPU on 64 snippets, same memory >= 0.998, end to end >= 0.99; then
     the same model on the f32 stream and memory (bilstm 4 a chunk at 256
     units, the same bars).
 18 (f). the beam step's kernels on the main path at other widths (seeded
     weights): a joint model with dec_units=256 at the bench's settings
     (i8dev, bf16 encoder, bf16 memory, 4-bit probs, beam 5, "step") through
     PerformanceEvaluator.run_pipelined over the 4 reads, beam_cell and
     beam_attend once a step, bilstm_bf16 4 a chunk, no other kernel and no
     plain route; card and CPU on 64 snippets (the kernels' decode of the
     card's memory >= 0.998 against the plain step, end to end >= 0.99); the
     same model and a dec_units=64 one on f32 memory and encoder over the
     first read (the same memory 1.00000, and >= 0.998 with the pad, end and
     start logits pushed down so that every step decodes whole rows); the
     flagship through tools/basecall.py's read path at --beam 10 over the 4
     reads, the same checks (the live decoder on f32 memory at W=10);
     the same three runs with beam_impl="loop" (the loop kernel once a
     chunk, no beam_cell; its decode of the card's memory against the plain
     step, and end to end against the step path and the CPU on 64
     snippets); fused greedy decode of an enc_units=64 (E=128) and the
     dec_units=256 model against the CPU; beam_impl="loop" refuses
     dec_units=96, the step and the loop W=17.
 20. the user tools (ravvent_tpu_torch/tools/), each CLI's main(argv) in
     process in a temporary directory at the flagship's width (batch 128,
     seeded): (a) make_dataset, 2 train and 4 eval reads of 1.5-1.8 kb (the
     val split a quarter of the eval reads); (b) train, 2 epochs of 3 steps
     at teacher forcing 1.0 (validation launches bilstm 4 times a batch, the
     steps no kernel), then a resume from epoch 1 whose epoch-2 loss and
     parameters equal the uninterrupted run's within 1e-6; (c) evaluate on
     (b)'s last checkpoint with beams 5 and 1 over the test split, on the
     card (bilstm, beam_cell, beam_attend) and with --cpu: the same result
     files, identities within 0.3 points, the card's bases/s; (d)
     train_curriculum, two stages, the bad-basin restart firing once, a
     sweep of 2 epochs and the export; (e) sweep_epochs over (b)'s
     checkpoints, and eval_token_acc on the card (bilstm, decode_step once a
     step) against --cpu: accuracies within 0.01, tokens on the same memory
     >= 0.998. Each step's seconds and launches printed.
 21. the bench's entry point (ravvent_tpu_torch/tools/bench.py), its
     main(argv) in process at its defaults on seeded weights, identity
     included, on bench.py's reads made into a temporary directory (4 reads
     of 12-18 kb, 12 distinct stream reads): its last JSON line (value > 0,
     the card's name and power limit), bilstm_bf16 4 times a chunk encoded,
     beam_cell = beam_attend = beam_step, peak_scan on the signal-only
     wires, no other kernel, each pipelined record's bases those of the
     stream reads; its seconds, its per-read and its three pipelined
     bases/s. After it, no phase that ran the flagship's shape (4, 7, 8,
     10, 12, 13, 21) took the BiLSTM's plain route.

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

    t0 = time.perf_counter()
    log = cuda_lib.build(force=True)
    wall = time.perf_counter() - t0
    for line in log.splitlines():
        spills = "spill stores" in line and " 0 bytes spill stores" not in line
        if line.startswith("==") or "Compiling entry" in line or "Used" in line or spills:
            print("  " + line.strip())
    print(f"  build wall {wall:.2f} s: {len(cuda_lib.sources())} sources, one nvcc each, in "
          f"parallel (need <= 60 s)")
    require(wall <= 60.0, f"the kernels' build took {wall:.2f} s (> 60 s)")
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


def phase_bilstm(dtype) -> list:
    """The BiLSTM kernel of one stream (f32: csrc/bilstm.cu, phase 2; bf16:
    csrc/bilstm_bf16.cu, phase 9) against its plain version for the four
    layer shapes of one chunk (raw F = 1 and 2U at T = 200, event F = 5 and
    2U at T = 30) at each compiled width U (ops/rnn_cuda.py:KERNEL_UNITS), at
    4096 rows, and at the flagship's 128 units also at 2858 (the first
    read's row count, which the CLI and the bench path run as their own
    chunk), timed beside torch.nn.LSTM in the stream's dtype. The weights
    are laid out for the kernel once, as the engine lays them out. Returns
    one kernels-line entry a width, of the 4096-row chunk."""
    from ravvent_tpu_torch.ops.rnn_cuda import KERNEL_UNITS

    f32 = dtype == torch.float32
    gen = torch.Generator().manual_seed(SEED if f32 else SEED + 4)
    # the flagship's width first, so that its draws are those of earlier runs
    return [bilstm_width(dtype, U, gen, (4096, 2858) if U == 128 else (4096,))
            for U in sorted(KERNEL_UNITS, key=lambda u: u != 128)]


def bilstm_width(dtype, U: int, gen: torch.Generator, batches) -> dict:
    """phase_bilstm at one width U: the kernels-line entry of its 4096-row
    chunk, named ``bilstm`` / ``bilstm_bf16`` at 128 units and with
    ``_u<U>`` after it at another width."""
    from ravvent_tpu_torch.models.rnn import init_encoder, stream_weights
    from ravvent_tpu_torch.ops.rnn_cuda import bilstm_layer, bilstm_layer_plain, kernel_layout

    dev, f32 = torch.device("cuda"), dtype == torch.float32
    source = "bilstm" if f32 else "bilstm_bf16"
    name = source if U == 128 else f"{source}_u{U}"
    # f32: another summation order over up to 200 steps, relative to max(1, |ref|)
    # too. bf16: outputs are bf16(h), about two bf16 ulps at |h| <= 1, where a
    # summation order flips a rounding and the recurrence carries it; f32
    # final states
    tol_out, tol_state = (1e-4, 1e-4) if f32 else (1e-2, 1e-3)
    names = ["raw L0", "raw L1", "event L0", "event L1"]
    shapes = [(1, 200, False), (2 * U, 200, True), (5, 30, False), (2 * U, 30, True)]
    layers = [stream_weights(init_encoder(gen, U, 1, F, dev), dtype)[0] for F, _, _ in shapes]
    chunks, err = {}, 0.0
    for B in batches:
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
            print(f"  {name} U={U} B={B} {lname} T={T} F={F}: out max_abs_err {err_out:.3e} (tol "
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
        print(f"  {name} U={U} B={B}, one chunk's four layers: kernel {tot['ms']:.3f} ms, plain "
              f"{tot['plain_ms']:.3f} ms, torch.nn.LSTM {tot['library_ms']:.3f} ms, bound "
              f"{tot['bound_ms']:.3f} ms", flush=True)
        chunks[B] = (tot, bound_by)
    tot, bound_by = chunks[4096]
    return {"name": name, "route": "cuda", "source": f"ravvent_tpu_torch/csrc/{source}.cu",
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
    memory over 10 steps, and over 10 steps at the evaluate-side tools'
    B=1024, W=5 and W=1; each step fed the plain version's state. Times
    the pair and each kernel beside its bound, and the step at S=8. Then
    the other widths (beam_step_width_case). Returns the kernels line's
    entries of the flagship's kernels and of width_entries."""
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
    # the evaluate-side tools' shapes: chunks of 1024 rows on f32 memory, at
    # beam widths 5 and 1 (tools/evaluate.py --beams 5,1)
    Bc = 1024
    kc, vc, mc = kf[:Bc].contiguous(), vf[:Bc].contiguous(), mask[:Bc].contiguous()
    for Wc in (5, 1):
        c_tok, c_par, c_err, _ = check_steps(
            f"beam_step f32 B={Bc} W={Wc}", step_on(kc, vc, mc), plain_on(kc, vc, mc),
            initial_state(Bc, Wc, U, 2, dev), 10, Bc, Wc, tol)
        print(f"  beam_step B={Bc} S={S} W={Wc} f32, 10 steps: tokens agree {c_tok:.5f}, parents "
              f"agree {c_par:.5f} (need >= 0.998); score max_abs_err {c_err:.3e} (tol {tol:g})")
    del kc, vc, mc

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
    del keys, values, mem
    src = "ravvent_tpu_torch/csrc/beam_step_f.cu"
    replaces = "ravvent_tpu/ops/beam_loop_pallas.py:333"
    # the other decoder widths (bf16 40 steps, f32 10) and beam widths
    # (128 units, bf16, 40 steps)
    cases = {}
    for U, W, mode, n in ((64, 5, "bf16", 40), (64, 5, "f32", 10), (256, 5, "bf16", 40),
                          (256, 5, "f32", 10), (128, 6, "bf16", 40), (128, 7, "bf16", 40),
                          (128, 10, "bf16", 40), (128, 16, "bf16", 40)):
        cases[(U, W, mode)] = beam_step_width_case(U, W, mode, n)
        torch.cuda.empty_cache()
    return [{"name": "beam_cell", "route": "cuda", "source": src, "replaces": replaces,
             "max_abs_err": cell_err[0], "ms": cell_ms, "plain_ms": cell_plain_ms,
             "bound_ms": cell_bound, "bound_by": cell_by, "library_ms": None},
            {"name": "beam_attend", "route": "cuda",
             "source": "ravvent_tpu_torch/csrc/beam_attend.cuh", "replaces": replaces, "max_abs_err": attend["err"], "ms": att_ms,
             "plain_ms": att_plain_ms, "bound_ms": att_bound, "bound_by": att_by,
             "library_ms": None}] + width_entries(cases, replaces)


def beam_step_width_case(U: int, W: int, mode: str, steps: int) -> dict:
    """The beam step's two kernels at U units and W beams on ``mode`` memory
    (bf16, f32, quant, quant_mxu) at B=4096, S=232: ``steps`` steps against
    beam_step_plain, each fed the plain state, with beam_cell against
    cell_plain and the attend kernel against attend_plain fed the plain cell
    (phase 3's bars); the step, each kernel and their plain versions timed
    on the last state beside the bounds; the attend instance's shared memory,
    threads and CTAs an SM (ops/beam_step_cuda.py:attend_info). Returns the
    figures."""
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_step_cuda import (
        attend_info, attend_plain, beam_attend, beam_cell, beam_step, beam_step_plain,
        cell_plain, initial_state, pack_decoder_weights,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    B, S, V, E = 4096, 232, 7, 256
    dec_p = init_decoder(gen, V, 1, U, E, dev)
    memory, mask = encoder_like_memory(gen, B, S, E, dev)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}.get(mode, "i8")
    mem = attn.setup_memory(dec_p["attention"], memory, mask, dtype,
                            attention_layer=dec_p["attention_layer"])
    del memory
    w = pack_decoder_weights(dec_p, mem)
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    scales = (mem.kscale.contiguous(), mem.vscale.contiguous()) if mem.quantized else None
    mxu = mode == "quant_mxu"
    tol, tol_cell = 1e-2, 1e-4  # phase 3's bars
    cell_err = [0.0]
    attend = {"tok": 0, "par": 0, "n": 0, "err": 0.0}

    def kernels_alone(st, ref, rpar):
        plain_cell = cell_plain(st, w)
        cell_err[0] = max([cell_err[0]] + [(g - r).abs().max().item()
                                           for g, r in zip(beam_cell(st, w), plain_cell)])
        got, gpar = beam_attend(st, *plain_cell, keys, values, mask, w, 1, scales, mxu)
        tok_eq = got.tok.reshape(B, W) == ref.tok.reshape(B, W)
        both = tok_eq & (gpar == rpar)
        attend["tok"] += tok_eq.sum().item()
        attend["par"] += (gpar == rpar).sum().item()
        attend["n"] += B * W
        if both.any():
            attend["err"] = max(attend["err"], (got.cum - ref.cum).abs()[both].max().item())

    name = f"U={U} W={W} {mode}"
    tok, par, err, st = check_steps(
        f"beam_step {name}", lambda st: beam_step(st, keys, values, mask, w, 1, scales, mxu),
        lambda st: beam_step_plain(st, keys, values, mask, w, 1, scales, mxu),
        initial_state(B, W, U, 2, dev), steps, B, W, tol, extra=kernels_alone)
    a_tok, a_par = attend["tok"] / attend["n"], attend["par"] / attend["n"]
    require(cell_err[0] <= tol_cell, f"beam_cell {name}: error {cell_err[0]:.3e} > {tol_cell}")
    require(a_tok >= 0.998 and a_par >= 0.998, f"beam_attend {name}: agreement < 0.998")
    require(attend["err"] <= tol, f"beam_attend {name}: score error {attend['err']:.3e} > {tol}")
    hn, cn, ah = beam_cell(st, w)
    t = {"step": time_ms(lambda: beam_step(st, keys, values, mask, w, 1, scales, mxu), reps=40),
         "step_plain": time_ms(lambda: beam_step_plain(st, keys, values, mask, w, 1, scales, mxu),
                               reps=3),
         "cell": time_ms(lambda: beam_cell(st, w), reps=40),
         "cell_plain": time_ms(lambda: cell_plain(st, w), reps=10),
         "att": time_ms(lambda: beam_attend(st, hn, cn, ah, keys, values, mask, w, 1, scales, mxu),
                        reps=40),
         "att_plain": time_ms(lambda: attend_plain(st, hn, cn, ah, keys, values, mask, w, 1,
                                                   scales, mxu), reps=3)}
    mem_bytes = {"bf16": 2, "f32": 4}.get(mode, 1)
    scale_bytes = 8 if scales is not None else 0
    peak = H100_F32_FLOPS if mode == "f32" else H100_INT8_OPS if mxu else H100_BF16_FLOPS
    bound, by = beam_step_bounds(B, S, U, W, V, mem_bytes, scale_bytes, peak)
    cell_bound, cell_by = beam_cell_bounds(B * W, U, V)
    att_bound, att_by = beam_attend_bounds(B, S, U, W, V, mem_bytes, scale_bytes, peak)
    info = attend_info(mode, U, W, S, V)
    print(f"  {name}, {steps} steps: tokens agree {tok:.5f}, parents {par:.5f}, score max_abs_err "
          f"{err:.3e}; beam_cell alone {cell_err[0]:.3e}; the attend alone tokens {a_tok:.5f}, "
          f"parents {a_par:.5f}, score {attend['err']:.3e}; the step {t['step']:.4f} ms (plain "
          f"{t['step_plain']:.4f}, bound {bound:.4f}, {by}); beam_cell {t['cell']:.4f} ms "
          f"(plain {t['cell_plain']:.4f}, bound {cell_bound:.4f}, {cell_by}); attend "
          f"{t['att']:.4f} ms (plain {t['att_plain']:.4f}, bound {att_bound:.4f}, {att_by}); "
          f"attend CTA {info.threads} threads, {info.smem} B of shared memory, {info.per_sm} "
          f"an SM", flush=True)
    return {"cell_err": cell_err[0], "att_err": attend["err"], "t": t, "bound": bound,
            "cell_bound": (cell_bound, cell_by), "att_bound": (att_bound, att_by)}


def width_entries(cases: dict, replaces: str) -> list:
    """The ``kernels`` line's entries of the beam step's kernels at other
    widths: beam_cell and beam_attend at 64 and 256 units (bf16 memory),
    beam_attend at W = 10 (128 units, bf16)."""
    src = "ravvent_tpu_torch/csrc/beam_step_f.cu"
    att_src = "ravvent_tpu_torch/csrc/beam_attend.cuh"
    out = []
    for U in (64, 256):
        c = cases[(U, 5, "bf16")]
        out.append({"name": f"beam_cell_u{U}", "route": "cuda", "source": src,
                    "replaces": replaces, "max_abs_err": c["cell_err"], "ms": c["t"]["cell"],
                    "plain_ms": c["t"]["cell_plain"], "bound_ms": c["cell_bound"][0],
                    "bound_by": c["cell_bound"][1], "library_ms": None})
    for name, key in (("beam_attend_u64", (64, 5, "bf16")), ("beam_attend_u256", (256, 5, "bf16")),
                      ("beam_attend_w10", (128, 10, "bf16"))):
        c = cases[key]
        out.append({"name": name, "route": "cuda", "source": att_src, "replaces": replaces,
                    "max_abs_err": c["att_err"], "ms": c["t"]["att"],
                    "plain_ms": c["t"]["att_plain"], "bound_ms": c["att_bound"][0],
                    "bound_by": c["att_bound"][1], "library_ms": None})
    return out


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
    from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop, beam_loop_plain, plan, replay_plain
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
            p = plan(dtype, U, W, 232, V)
            require(p.layout == "resident", f"beam_loop {name}: the {p.layout} layout, not the "
                    "resident one, at the flagship's shape")
            print(f"  beam_loop: {p.layout} layout, clusters of {p.cluster} CTAs, {p.active} at "
                  f"once (cudaOccupancyMaxActiveClusters), {p.smem} B of shared memory a CTA")
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
    # the other widths: 64 and 256 units (W = 5), W = 6, 10 and 16 (128
    # units), on the layout the C entry picks
    widths = {}
    for U_, W_, dtype in ((64, 5, torch.bfloat16), (64, 5, torch.float32),
                          (256, 5, torch.bfloat16), (256, 5, torch.float32),
                          (128, 6, torch.bfloat16), (128, 10, torch.bfloat16),
                          (128, 16, torch.bfloat16), (128, 16, torch.float32)):
        widths[(U_, W_, dtype)] = beam_loop_width_case(U_, W_, dtype)
        torch.cuda.empty_cache()
    return out, widths


def beam_loop_width_case(U: int, W: int, dtype, B: int = 4096, S: int = 232) -> dict:
    """The whole-loop kernel at U units and W beams on ``dtype`` memory, on
    the layout the C entry picks (beam_loop_cuda.plan, printed with its
    cluster size, the clusters or CTAs the card holds at once and its shared
    memory): phase 5's decoder at that width with the end token pushed down
    (every live step runs the whole cell), 39 live steps of 47 at B rows;
    every live step replayed through the plain step (picks equal the plain
    top-W >= 0.99, distinct, score errors <= 1e-2), the dead steps zero; the
    kernel, the plain loop and the beam step's 39-step loop on the same
    memory timed beside the loop's bound. Returns the figures."""
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop, beam_loop_plain, plan, replay_plain
    from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop, pack_decoder_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    V, E, T, eff, end = 7, 256, 47, 39, 1
    dec = init_decoder(gen, V, 1, U, E, dev)
    dec["fc"]["bias"][end] -= 20.0
    memory, mask = encoder_like_memory(gen, B, S, E, dev)
    mem = attn.setup_memory(dec["attention"], memory, mask, dtype,
                            attention_layer=dec["attention_layer"])
    del memory
    w = pack_decoder_weights(dec, mem)
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    p = plan(dtype, U, W, S, V)
    got = beam_loop(keys, values, mask, w, W, T, eff, 2, end)
    rep = replay_plain(*got, keys, values, mask, w, eff, 2, end)
    torch.cuda.synchronize()
    err = max(rep.rank_err, rep.score_err)
    mem_name = "bf16" if dtype == torch.bfloat16 else "f32"
    name = f"U={U} W={W} {mem_name}"
    require(not any(x[eff:].any() for x in got), f"beam_loop {name}: dead steps not zero")
    require(rep.distinct and rep.exact >= 0.99,
            f"beam_loop {name}: picks equal the plain top-W {rep.exact:.5f} < 0.99")
    require(err <= 1e-2, f"beam_loop {name}: replayed score error {err:.3e} > 0.01")
    ms = time_ms(lambda: beam_loop(keys, values, mask, w, W, T, eff, 2, end), reps=2)
    plain_ms = time_ms(lambda: beam_loop_plain(keys, values, mask, w, W, T, eff, 2, end), reps=1,
                       warmup=0)
    step_ms = time_ms(lambda: beam_step_loop(keys, values, mask, w, W, T, eff, 2, end), reps=1)
    bound, by = beam_loop_bounds(B, S, U, W, V, 2 if dtype == torch.bfloat16 else 4, eff)
    print(f"  beam_loop B={B} S={S} {name}, no beam ending, {eff} live steps: {p.layout} layout, "
          f"clusters of {p.cluster}, {p.active} at once, {p.smem} B of shared memory a CTA; each "
          f"step replayed through the plain step: picks equal the plain top-W {rep.exact:.5f} "
          f"(need >= 0.99), distinct {rep.distinct}, score error {err:.3e} (tol 0.01); kernel "
          f"{ms:.3f} ms/chunk, plain {plain_ms:.3f}, beam_step kernel x {eff} {step_ms:.3f}, "
          f"bound {bound:.3f} ({by})", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "step_ms": step_ms, "bound": bound,
            "by": by, "layout": p.layout}


def decode_step_bounds(B: int, S: int, U: int, E: int, V: int) -> tuple:
    f32_flops = B * (cell_flops(U, V, U + E) + 2 * S * U + 2 * S * E)
    nbytes = (4 * B * S * (U + E) + B * S  # keys, values, mask
              + 4 * B * (1 + 3 * U) + 4 * B * (3 * U + V)  # state in, state and logits out
              + 4 * ((V + 2 * U) * 4 * U + 4 * U + (U + E) * U + U * V + V))  # weights
    t_ops, t_bytes = f32_flops / H100_F32_FLOPS, nbytes / H100_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def phase_decode_step() -> tuple:
    """The decode-step kernel against its plain version at each (U, E) of its
    set (csrc/decode_step_shapes.cuh), B=4096, S=232, f32 memory, 40 chained
    steps, each fed the plain version's state; timed beside its byte bound.
    Returns (the flagship's (128, 256) kernels-line entry, every shape's
    figures by (U, E))."""
    from ravvent_tpu_torch.ops.decode_step_cuda import GREEDY_MEMORY_DIMS, GREEDY_UNITS

    shapes = [(128, 256)] + [(u, e) for u in GREEDY_UNITS for e in GREEDY_MEMORY_DIMS
                             if (u, e) != (128, 256)]
    figures = {}
    for U, E in shapes:
        figures[(U, E)] = decode_step_case(U, E)
        torch.cuda.empty_cache()
    f = figures[(128, 256)]
    return ({"name": "decode_step", "route": "cuda",
             "source": "ravvent_tpu_torch/csrc/decode_step.cu",
             "replaces": "ravvent_tpu/ops/decode_step_pallas.py:41", "max_abs_err": f["err"],
             "ms": f["ms"], "plain_ms": f["plain_ms"], "bound_ms": f["bound"], "bound_by": f["by"],
             "library_ms": None}, figures)


def decode_step_case(U: int, E: int) -> dict:
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.decode_step_cuda import (
        fused_decode_step, fused_decode_step_plain, pack_decoder_weights,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 3)
    B, S, V, steps = 4096, 232, 7, 40
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
    print(f"  decode_step B={B} S={S} U={U} E={E} f32, {steps} chained steps: argmax agree "
          f"{share:.5f} (need >= 0.998); h/c/att/logits max_abs_err {err:.3e} (tol {tol:g}); "
          f"kernel {ms:.4f} ms/step, plain {plain_ms:.4f} ms/step, bound {bound:.4f} ms/step "
          f"({by})", flush=True)
    require(share >= 0.998, f"decode_step U={U} E={E}: argmax agreement {share:.5f} < 0.998")
    require(err <= tol, f"decode_step U={U} E={E}: error {err:.3e} > {tol}")
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound, "by": by}


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


def phase_greedy(cfg=None, params=None, what: str = "fused greedy") -> dict:
    """Phase 8 (the flagship), and in phase 18 (f) a model of another
    width: the first read's snippets encoded on the card as un-projected f32
    memory, decoded by fused_greedy_decode (the decode-step kernel once a
    step), against plain greedy_decode on the CPU on 64 snippets. Returns
    the launches of the whole read's decode."""
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.decode.greedy import greedy_decode
    from ravvent_tpu_torch.evaluation.basecall import TOTAL_STEPS, BasecallEngine
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.ops.decode_step_cuda import fused_greedy_decode
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN

    if cfg is None:
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
        print(f"  {what} on one read: snippets {n}, wall {wall:.3f} s; launches: bilstm "
              f"{counts['bilstm']}, decode_step {counts['decode_step']}")
        require(counts["bilstm"] > 0 and counts["decode_step"] > 0,
                f"{what} did not launch its kernels")
        require(tuple(tok.shape) == (n, TOTAL_STEPS) and bool(torch.isfinite(logits).all()),
                f"{what}: bad greedy result shape or logits")
        # all_done couples a batch's rows: card and CPU decode the same 64 rows
        t_card, _ = greedy(card, raw_c[:64], event_c[:64], fused_greedy_decode)
        t_cpu, _ = greedy(cpu, raw_c[:64].cpu(), event_c[:64].cpu(), greedy_decode)
    agree = (t_card.cpu() == t_cpu).float().mean().item()
    print(f"  {what} on the card vs plain greedy_decode on the CPU, 64 snippets: "
          f"tokens agree {agree:.5f} (need >= 0.99)")
    require(agree >= 0.99, f"{what} on the card disagrees with the CPU")
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
                    "source": f"ravvent_tpu_torch/csrc/beam_attend_{'i8mxu' if mxu else 'i8'}.cu",
                    "replaces": f"ravvent_tpu/ops/beam_loop_pallas.py:333 ({variant})",
                    "max_abs_err": attend["err"], "ms": t["att232"],
                    "plain_ms": t["att_plain232"], "bound_ms": att_bound, "bound_by": att_by,
                    "library_ms": None})
    del keys, values, mem, k8, v8, scales, scales8
    torch.cuda.empty_cache()
    # the other decoder widths on both int8 branches, 40 steps each
    for U in (64, 256):
        for mode in ("quant", "quant_mxu"):
            beam_step_width_case(U, 5, mode, 40)
            torch.cuda.empty_cache()
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


def top_beam_tokens(engine, mem, max_len: int, beams: int = 1, width: int = 5,
                    dec=None, loop=None) -> torch.Tensor:
    """The engine's beam decode of ``mem`` (beam ``width``, ``max_len - 1``
    live steps; the engine's decoder or ``dec``; the beam step's loop, or
    ``loop``): the top ``beams`` beams' tokens over the live steps, on the
    host ([N, max_len - 1, beams])."""
    from ravvent_tpu_torch.evaluation.basecall import TOTAL_STEPS
    from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop, fused_beam_decode
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER

    dec = engine.params["decoder"] if dec is None else dec
    res = fused_beam_decode(dec, mem, engine.cfg.vocab_size, width,
                            TOTAL_STEPS,
                            max_len - 1, start_token=NUC_TOKENIZER.start_id,
                            end_token=NUC_TOKENIZER.end_id, loop=loop or beam_step_loop,
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


class RepeatedBatch:
    """A batch source for Trainer.fit that yields one batch every step."""
    random_seed = 0

    def __init__(self, batch) -> None:
        self.batch = batch

    def steps(self, n: int):
        return (self.batch for _ in range(n))


def step_launches(trainer, batch) -> tuple:
    """One train step under torch.profiler: (device operations, the host's
    kernel-launch calls, the device operations' summed ms, the step's wall
    ms under the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_on_batch(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    host = sum(1 for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                "cudaLaunchKernelExC"))
    busy_ms = sum(e.time_range.elapsed_us() for e in device) / 1e3
    return len(device), host, busy_ms, wall_ms


def phase_training(smi: str) -> dict:
    """Training at the flagship's width on simulated reads: one step card
    against CPU at p = 0, fit for 20 steps at p = 0.5 on a repeated batch,
    validation on the card against the CPU, a checkpoint round trip.
    Returns the figures."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.config import RunConfig
    from ravvent_tpu_torch.data import chiron, simulator
    from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.training.checkpoints import CheckpointManager
    from ravvent_tpu_torch.training.loop import Trainer, tree_leaves
    from ravvent_tpu_torch.weights import flatten

    _, params = flagship_params()
    cfg = RunConfig()  # the flagship's model; TrainConfig's defaults
    t = cfg.train
    require(t.batch_size == 128 and t.teacher_forcing == 0.5, "TrainConfig's defaults changed")
    cfg_tf = dataclasses.replace(cfg, train=dataclasses.replace(t, teacher_forcing=1.0))
    fig = {}
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        genome = simulator.random_genome(20_000, np.random.default_rng(SEED))
        simulator.generate_chiron_dataset(d, genome, n_reads=2, read_len_range=(1500, 1800),
                                          seed=SEED + 1)
        fi = chiron.create_files_info(d, stride=6, verbose=False)
        gen = SnippetBatchGenerator(fi, stride=6, batch_size=t.batch_size, shuffle=False,
                                    cache_dir=str(d / "cache"))
        require(len(gen) >= 2, "the simulated reads make fewer than 2 batches")
        batch, val_batch = gen[0], gen[1]

        # 1. one step at p = 0, card against CPU, from the same weights and batch
        card, cpu = Trainer(cfg_tf, params=params), Trainer(cfg_tf, params=params, device="cpu")
        cuda_lib.reset_launches()
        out_g, g_g = card.loss_and_grads(batch)
        torch.cuda.synchronize()
        step_kernels = dict(cuda_lib.launches)
        t0 = time.perf_counter()
        out_c, g_c = cpu.loss_and_grads(batch)
        cpu_s = time.perf_counter() - t0
        lg, lc = float(out_g.loss.detach()), float(out_c.loss.detach())
        rel = abs(lg - lc) / abs(lc)
        fg, fc = flatten(g_g), flatten(g_c)
        errs = {k: float(np.abs(fg[k] - fc[k]).max()) / max(float(np.abs(fc[k]).max()), 1e-30)
                for k in fc}
        worst = max(errs, key=errs.get)
        print(f"  one train step at p = 0, batch {t.batch_size}, card vs CPU: loss {lg:.7f} vs "
              f"{lc:.7f}, rel {rel:.3e} (need <= 1e-4); gradients: worst leaf {worst} "
              f"{errs[worst]:.3e} of its largest magnitude (need <= 1e-3) over {len(errs)} leaves; "
              f"hand-written kernel launches {sum(step_kernels.values())} (need 0); the CPU's "
              f"step {cpu_s:.2f} s [{smi}]")
        require(np.isfinite(lg) and rel <= 1e-4, "card and CPU train losses disagree")
        require(errs[worst] <= 1e-3, f"card and CPU gradients disagree on {worst}")
        require(sum(step_kernels.values()) == 0, "the train step launched a hand-written kernel")

        # 3. validation on the card (the f32 BiLSTM kernel) against the CPU
        card.validate_on_batch(val_batch)  # warm-up
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        vg = card.validate_on_batch(val_batch)
        vg = {k: float(v) for k, v in vg.items()}
        fig["val_step_s"] = time.perf_counter() - t0
        vk = dict(cuda_lib.launches)
        vc = {k: float(v) for k, v in cpu.validate_on_batch(val_batch).items()}
        vrel = abs(vg["loss"] - vc["loss"]) / abs(vc["loss"])
        others = sum(v for k, v in vk.items() if k != "bilstm")
        print(f"  validate_on_batch, batch {t.batch_size}: {fig['val_step_s']:.4f} s on the card; "
              f"loss {vg['loss']:.7f} vs CPU {vc['loss']:.7f}, rel {vrel:.3e} (need <= 1e-3); "
              f"acc {vg['acc']:.5f} vs {vc['acc']:.5f} (need within 0.005); launches: bilstm "
              f"{vk['bilstm']} (need 4), other kernels {others} (need 0) [{smi}]")
        require(vk["bilstm"] == 4 and others == 0, "validation did not launch bilstm 4 times alone")
        require(np.isfinite(vg["loss"]) and vrel <= 1e-3, "card and CPU validation losses disagree")
        require(abs(vg["acc"] - vc["acc"]) <= 0.005, "card and CPU validation accuracies disagree")
        del card, cpu, out_g, g_g

        # 2. learning on the card: fit, one epoch of 20 steps at p = 0.5
        tr = Trainer(cfg, params=params)
        require(tr.sampling_probability == 0.5, "the trainer does not sample at p = 0.5")
        losses, stamps = [], []

        def record(_i, m):
            losses.append(m["loss"])
            stamps.append(time.perf_counter())

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = tr.fit(RepeatedBatch(batch), epochs=1, steps_per_epoch=20,
                      batch_callbacks=[record], verbose=False)
        fit_s = time.perf_counter() - t0
        fig["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        fig["step_s"] = (stamps[-1] - stamps[1]) / (len(stamps) - 2)  # steps 3-20
        first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        print(f"  fit, 20 steps at p = 0.5 on a repeated batch of {t.batch_size}: {fit_s:.3f} s, "
              f"{fig['step_s']:.4f} s a step (mean over steps 3-20); loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, mean of the first 5 {first:.5f}, of the last 5 {last:.5f}; "
              f"peak device memory {fig['peak_gib']:.3f} GiB [{smi}]")
        require(len(losses) == 20 and all(np.isfinite(losses)), "a train loss is not finite")
        require(last < first, "the train loss did not fall")
        require(abs(hist["loss"][0] - float(np.mean(losses))) <= 1e-5 * abs(hist["loss"][0]),
                "fit's epoch loss is not the mean of its steps")
        fig["device_ops"], fig["host_launches"], busy, wall = step_launches(tr, batch)
        print(f"  one train step under torch.profiler: {fig['device_ops']} device operations "
              f"(kernels, copies, memsets), {fig['host_launches']} kernel launches on the host; "
              f"the device operations sum to {busy:.3f} ms of the step's {wall:.3f} ms under "
              f"the profiler [{smi}]")
        require(fig["device_ops"] > 0 or fig["host_launches"] > 0,
                "the profiler saw no launch of the train step")

        # 4. checkpoint round trip
        cm = CheckpointManager(str(d / "ckpt"))
        path = cfg.checkpoint_path(1)
        cm.save(path, tr.params, tr.opt_state, epoch=1, rng=tr.rng, data_seed=gen.random_seed)
        tr2 = Trainer(cfg, seed=SEED + 9)
        tr2.load_state(cm.restore(path))
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(tr.params),
                                                      tree_leaves(tr2.params)))
        same_opt = tr2.opt_state.count == tr.opt_state.count and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(tr.opt_state.nu),
                                              tree_leaves(tr2.opt_state.nu)))
        same_rng = torch.equal(tr.rng.get_state(), tr2.rng.get_state())
        v1 = float(tr.validate_on_batch(val_batch)["loss"])
        v2 = float(tr2.validate_on_batch(val_batch)["loss"])
        print(f"  checkpoint {path}: restored parameters equal {same}, optimizer state "
              f"{same_opt}, generator {same_rng}; validation loss {v1!r} before, {v2!r} after "
              f"(need equal)")
        require(same and same_opt and same_rng, "the checkpoint did not restore the state")
        require(v1 == v2, "the restored trainer validates to another loss")
    return fig


def xla_top_tokens(engine, mem, max_len: int) -> torch.Tensor:
    """The plain beam decode ("xla") of ``mem`` with the engine's
    configuration, beam 5, ``max_len - 1`` live steps: the top beam's tokens
    over the live steps, on the host ([N, max_len - 1])."""
    from ravvent_tpu_torch.decode.beam import beam_decode
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER

    cfg = engine.cfg
    res = beam_decode(engine.params["decoder"], mem, cfg.vocab_size, 5, engine.total_steps,
                      max_len - 1, cfg.effective_attention, cfg.cell_type,
                      NUC_TOKENIZER.start_id, NUC_TOKENIZER.end_id)
    return res.tokens[:, :max_len - 1, 0].cpu()


def card_vs_cpu(card, cpu, sig, rr, ev, er, max_len: int, aux=None) -> tuple:
    """Card and CPU engines on the same first 64 snippets of a read: token
    agreement decoding the card's memory on both devices, and end to end
    through predict_beam_compact. Returns (same memory, end to end)."""
    rr, er = rr[:64], er[:64]
    with torch.inference_mode():
        raw_c, event_c = next(iter(card.compact_snippets(sig, rr, ev, er, aux)))
        mem = card.memory(raw_c, event_c)
        t_card = xla_top_tokens(card, mem, max_len)
        t_host = xla_top_tokens(cpu, mem.to("cpu"), max_len)
    same = float((t_card == t_host).float().mean())
    t_gpu, p_gpu = card.predict_beam_compact(sig, rr, ev, er, max_len, 5, aux=aux)
    t_cpu, _ = cpu.predict_beam_compact(sig, rr, ev, er, max_len, 5, aux=aux)
    require(t_gpu.shape == (rr.shape[0], card._fetch_width(max_len)) and np.isfinite(p_gpu).all(),
            "bad result shape or probs")
    require(((t_gpu >= 0) & (t_gpu < card.cfg.vocab_size)).all(), "token out of the vocabulary")
    return same, float((t_gpu == t_cpu).mean())


def width_run(card, cpu, snippets, max_len: int, aux) -> tuple:
    """One read's snippets through ``card``'s predict_beam_compact (beam 5)
    after a warm-up, with the launches counted from 0 just before it, then
    card_vs_cpu on its first 64 snippets. Returns (the launches, the run's
    seconds, same memory, end to end)."""
    from ravvent_tpu_torch.ops import cuda_lib

    sig, rr, ev, er = snippets
    card.predict_beam_compact(sig, rr[:64], ev, er[:64], max_len, 5, aux=aux)  # warm-up
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    card.predict_beam_compact(sig, rr, ev, er, max_len, 5, aux=aux)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (dict(cuda_lib.launches), seconds) + card_vs_cpu(card, cpu, sig, rr, ev, er, max_len,
                                                            aux)


def phase_configs(smi: str) -> dict:
    """The non-flagship configurations through the engine's plain decode
    (beam_impl="xla"), on seeded weights at full width: (a) flagship32's
    shape (joint, 3 x BiLSTM(128), 2 x LSTM(128) + Luong, beam 5) over the 4
    reads with the CLI's settings (f32 encoder, bf16 pre-projected memory,
    f16 wire) through the CLI's read path, and with the bench's (i8dev, bf16
    encoder, bf16 memory, 4-bit probs) through
    PerformanceEvaluator.run_pipelined: the stream's BiLSTM kernel 6 times a
    chunk and no decode kernel; card against CPU on 64 snippets, decoding
    the same memory and end to end; (b) one engine each for bigru, gru and
    lstm on raw input and the flagship with Bahdanau attention: decode ms a
    chunk of 512 snippets, card against CPU on 64; (c) "step" and "loop"
    refuse (a)'s configuration; (d) a 64-unit encoder on the BiLSTM kernels
    at 64 units (f32, then bf16) beside the beam kernels, then a 48-unit
    one on the counted plain route, card against CPU on 64 snippets; (e) a
    256-unit encoder at the bench's settings (bf16 kernel at 256 units),
    then on the f32 stream, card against CPU on 64 snippets; (f) the beam
    step's kernels at other decoder and beam widths (phase_decoder_widths).
    Returns the launch counts of (a) ("cli", "bench"), (d) ("enc64",
    "enc64_bf16", "enc48"), (e) ("enc256", "enc256_f32") and (f) ("dec256",
    "dec64", "beam10")."""
    import dataclasses
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.assembly.merger import Merger
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.data.snippets import load_read_compact_ex, prepare_compact
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
    from ravvent_tpu_torch.models.basecaller import init_basecaller
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop
    from ravvent_tpu_torch.tools import profile_decode as pd
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN, basecall_read

    cfg = ModelConfig(encoder_depth=3, decoder_depth=2)  # flagship32's shape
    params = init_basecaller(cfg, torch.Generator().manual_seed(SEED))
    decoders = ("beam_step", "beam_cell", "beam_attend", "beam_step_i8", "beam_step_i8mxu",
                "beam_attend_i8", "beam_attend_i8mxu", "beam_loop", "decode_step")
    reads = simulated_reads()
    chunks = lambda n: -(-n // 4096)  # noqa: E731
    out = {}

    # (a) the CLI's settings through the CLI's read path
    cli = BasecallEngine(params, cfg, chunk_size=4096, beam_impl="xla", project_values=True)
    merger = Merger()
    basecall_read(cli, merger, reads[0][0][:3000], reads[0][1][reads[0][1][:, 1] <= 3000])
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    decode_s, n_bases, n_chunks = [], 0, 0
    for raw, ranges, _ in reads:
        call = basecall_read(cli, merger, raw, ranges)
        require(call is not None, "a simulated read gave no snippets")
        decode_s.append(call.seconds["decode"])
        n_bases += len(call.merged.seq)
        n_chunks += chunks(call.n_snippets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = out["cli"] = dict(cuda_lib.launches)
    print(f"  flagship32 shape, CLI settings (f32 encoder, bf16 memory, f16 wire, xla), 4 reads: "
          f"decode s a read {[round(s, 4) for s in decode_s]}, {n_bases} bases in {wall:.3f} s, "
          f"{n_bases / wall:.1f} bases/s [{smi}]")
    print(f"  launches: bilstm {c['bilstm']} over {n_chunks} chunks (need 6 a chunk), "
          f"bilstm_bf16 {c['bilstm_bf16']}, decode kernels {sum(c[k] for k in decoders)} "
          f"(need 0)")
    require(c["bilstm"] == 6 * n_chunks and c["bilstm_bf16"] == 0,
            "bilstm did not launch 6 times a chunk on flagship32's shape")
    require(sum(c[k] for k in decoders) == 0, "the xla path launched a decode kernel")
    require(n_bases > 0, "the reads merged to no bases")
    raw, ranges, _ = reads[0]
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    cpu = BasecallEngine(params, cfg, chunk_size=4096, beam_impl="xla", project_values=True,
                         device="cpu")
    same, e2e = card_vs_cpu(cli, cpu, sig, rr, ev, er, MAX_OUTPUT_LEN)
    print(f"  CLI settings, card vs CPU on 64 snippets: decoding the card's memory, tokens agree "
          f"{same:.5f} (need >= 0.998); end to end {e2e:.5f} (need >= 0.99)")
    require(same >= 0.998, "card and CPU decode the same memory differently (flagship32, CLI)")
    require(e2e >= 0.99, "card and CPU disagree end to end (flagship32, CLI)")

    # (a) the bench's settings through PerformanceEvaluator.run_pipelined
    bench = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="xla",
                 project_values=True, encoder_dtype=torch.bfloat16, pack_u8=True,
                 transport_dtype="i8dev", prob_bits=4)
    engine = BasecallEngine(params, cfg, **bench)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = pd.write_reads(reads, d)
        pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=str(d / "cache"))
        pe.run(paths[0])  # warm-up; fills the read cache
        loaded = [load_read_compact_ex(p, Path(p).with_suffix(".label"), 6,
                                       cache_dir=str(d / "cache")) for p in paths]
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        rec = pe.run_pipelined(paths, inflight=8, finishers=4)
        torch.cuda.synchronize()
        c = out["bench"] = dict(cuda_lib.launches)
        # where the time goes: one torch.profiler trace of the same pipeline
        summary = pd.trace_pipelined(engine, paths, d / "trace", "compact", 5,
                                     cache_dir=str(d / "cache"))
    pd.print_trace(summary)
    print(f"  [{smi}]")
    require(summary["device_events"] > 0, "the profiler's trace holds no device event")
    n_chunks = sum(chunks(x[1].shape[0]) for x in loaded)
    print(f"  flagship32 shape, bench settings (i8dev, bf16 encoder, bf16 memory, xla), "
          f"run_pipelined inflight 8, finishers 4: {rec['bases_per_s']:.1f} bases/s, wall "
          f"{rec['wall_s']:.3f} s, stages {rec['stages_s']} [{smi}]")
    print(f"  launches: bilstm_bf16 {c['bilstm_bf16']} over {n_chunks} chunks (need 6 a chunk), "
          f"bilstm {c['bilstm']}, decode kernels {sum(c[k] for k in decoders)} (need 0)")
    require(c["bilstm_bf16"] == 6 * n_chunks and c["bilstm"] == 0,
            "bilstm_bf16 did not launch 6 times a chunk on flagship32's shape")
    require(sum(c[k] for k in decoders) == 0, "the xla path launched a decode kernel")
    require(rec["bases_num"] > 0, "the pipelined run called no bases")
    sig, rr, ev, er, nuc, aux = loaded[0]
    max_len = int((nuc != 0).sum(axis=1).max())
    same, e2e = card_vs_cpu(engine, BasecallEngine(params, cfg, device="cpu", **bench), sig, rr,
                            ev, er, max_len, aux)
    print(f"  bench settings, card vs CPU on 64 snippets: decoding the card's memory, tokens "
          f"agree {same:.5f} (need >= 0.998); end to end {e2e:.5f} (need >= 0.99)")
    require(same >= 0.998, "card and CPU decode the same memory differently (flagship32, bench)")
    require(e2e >= 0.99, "card and CPU disagree end to end (flagship32, bench)")

    # (b) one engine each: GRU and unidirectional encoders, Bahdanau attention
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    rr, er = rr[:512], er[:512]
    for name, kw in (("bigru raw", dict(rnn_type="bigru", data_type="raw")),
                     ("gru raw", dict(rnn_type="gru", data_type="raw")),
                     ("lstm raw", dict(rnn_type="lstm", data_type="raw")),
                     ("flagship, Bahdanau", dict(attention_type="bahdanau"))):
        bcfg = dataclasses.replace(ModelConfig(), **kw)
        bparams = init_basecaller(bcfg, torch.Generator().manual_seed(SEED))
        card = BasecallEngine(bparams, bcfg, chunk_size=512, beam_impl="xla", project_values=True)
        with torch.inference_mode():
            raw_c, event_c = next(iter(card.compact_snippets(sig, rr, ev, er)))
            card.beam(raw_c, event_c, MAX_OUTPUT_LEN - 1, 5)  # warm-up
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            mem = card.memory(raw_c, event_c)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            xla_top_tokens(card, mem, MAX_OUTPUT_LEN)
            t2 = time.perf_counter()
        c = dict(cuda_lib.launches)
        same, e2e = card_vs_cpu(card, BasecallEngine(bparams, bcfg, chunk_size=512,
                                                     beam_impl="xla", project_values=True,
                                                     device="cpu"),
                                sig, rr, ev, er, MAX_OUTPUT_LEN)
        print(f"  {name}: a chunk of {raw_c.shape[0]} snippets, encoder + memory "
              f"{(t1 - t0) * 1e3:.3f} ms, beam decode (39 steps) {(t2 - t1) * 1e3:.3f} ms; "
              f"launches {dict((k, v) for k, v in c.items() if v)}; card vs CPU on 64 snippets: "
              f"same memory {same:.5f} (need >= 0.998), end to end {e2e:.5f} (need >= 0.99) "
              f"[{smi}]")
        layers = 4 if bcfg.rnn_type == "bilstm" else 0  # the BiLSTM kernel's alone
        require(c["bilstm"] == layers and sum(v for k, v in c.items() if k != "bilstm") == 0,
                f"{name}: unexpected kernel launches")
        require(same >= 0.998, f"{name}: card and CPU decode the same memory differently")
        require(e2e >= 0.99, f"{name}: card and CPU disagree end to end")

    # (d) a 64-unit encoder: every layer on the f32 BiLSTM kernel at 64
    # units, beside the beam kernels at the decoder's 128; then once on the
    # bf16 stream
    wcfg = ModelConfig(enc_units=64)
    wparams = init_basecaller(wcfg, torch.Generator().manual_seed(SEED))
    narrow = dict(chunk_size=4096, memory_dtype=None, encoder_dtype=None, transport_dtype="f32")
    sig, rr, ev, er, _, _ = prepare_compact(raw, ranges, np.array(["a"] * len(ranges)), 6)
    n_chunks = chunks(rr.shape[0])
    c, secs, same, agree = width_run(BasecallEngine(wparams, wcfg, **narrow),
                                     BasecallEngine(wparams, wcfg, device="cpu", **narrow),
                                     (sig, rr, ev, er), MAX_OUTPUT_LEN, None)
    out["enc64"] = c
    print(f"  64-unit encoder (f32 stream and memory, step): the first read, {rr.shape[0]} "
          f"snippets, {secs:.3f} s; launches {dict((k, v) for k, v in c.items() if v)} "
          f"(bilstm need 4 a chunk over {n_chunks}, bilstm_plain_route and bilstm_bf16 0); "
          f"card vs CPU on 64 snippets: tokens agree {agree:.5f} (need >= 0.998), same memory "
          f"{same:.5f} (need >= 0.998) [{smi}]")
    require(c["bilstm"] == 4 * n_chunks and c["bilstm_plain_route"] == c["bilstm_bf16"] == 0,
            "the 64-unit encoder did not run the f32 BiLSTM kernel 4 times a chunk")
    require(c["beam_cell"] == c["beam_attend"] == c["beam_step"] > 0,
            "the 64-unit encoder's engine did not run the beam kernels")
    require(agree >= 0.998 and same >= 0.998,
            "card and CPU disagree on the 64-unit encoder's tokens")
    stream = dict(chunk_size=4096, memory_dtype=torch.bfloat16, encoder_dtype=torch.bfloat16,
                  transport_dtype="f32")
    c, secs, same, e2e = width_run(BasecallEngine(wparams, wcfg, **stream),
                                   BasecallEngine(wparams, wcfg, device="cpu", **stream),
                                   (sig, rr, ev, er), MAX_OUTPUT_LEN, None)
    out["enc64_bf16"] = c
    print(f"  64-unit encoder, bf16 stream and memory: {secs:.3f} s; launches "
          f"{dict((k, v) for k, v in c.items() if v)} (bilstm_bf16 need 4 a chunk over "
          f"{n_chunks}); card vs CPU on 64 snippets: same memory {same:.5f} (need >= 0.998), "
          f"end to end {e2e:.5f} (need >= 0.99) [{smi}]")
    require(c["bilstm_bf16"] == 4 * n_chunks and c["bilstm_plain_route"] == c["bilstm"] == 0,
            "the 64-unit encoder did not run the bf16 BiLSTM kernel 4 times a chunk")
    require(same >= 0.998 and e2e >= 0.99, "card and CPU disagree on the 64-unit bf16 encoder")
    # a width the kernels are not compiled for (48 units; f32 stream and
    # memory as above): every layer on its plain version on the card,
    # counted under bilstm_plain_route, beside the beam kernels
    pcfg = ModelConfig(enc_units=48)
    pparams = init_basecaller(pcfg, torch.Generator().manual_seed(SEED))
    c, secs, same, agree = width_run(BasecallEngine(pparams, pcfg, **narrow),
                                     BasecallEngine(pparams, pcfg, device="cpu", **narrow),
                                     (sig, rr, ev, er), MAX_OUTPUT_LEN, None)
    out["enc48"] = c
    print(f"  48-unit encoder (uncompiled width; f32 stream and memory, step): {secs:.3f} s; "
          f"launches {dict((k, v) for k, v in c.items() if v)} (bilstm_plain_route need 4 a "
          f"chunk over {n_chunks}, bilstm and bilstm_bf16 0); card vs CPU on 64 snippets: tokens "
          f"agree {agree:.5f} (need >= 0.998), same memory {same:.5f} (need >= 0.998) [{smi}]")
    require(c["bilstm_plain_route"] == 4 * n_chunks and c["bilstm"] == c["bilstm_bf16"] == 0,
            "the 48-unit encoder did not take the plain route 4 times a chunk")
    require(c["beam_cell"] == c["beam_attend"] == c["beam_step"] > 0,
            "the 48-unit encoder's engine did not run the beam kernels")
    require(agree >= 0.998 and same >= 0.998,
            "card and CPU disagree on the 48-unit encoder's tokens")

    # (e) the slice's path at full width: a 256-unit encoder (joint, 2 x
    # BiLSTM(256), LSTM(128) + Luong) at the bench's settings over the first
    # read, its layers on the bf16 BiLSTM kernel at 256 units, the decoder on
    # the beam kernels; then once on the f32 stream (the f32 kernel at 256)
    ecfg = ModelConfig(enc_units=256)
    eparams = init_basecaller(ecfg, torch.Generator().manual_seed(SEED))
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        path = pd.write_reads(reads[:1], d)[0]
        loaded = load_read_compact_ex(path, Path(path).with_suffix(".label"), 6)
    sig, rr, ev, er, nuc, aux = loaded
    max_len = int((nuc != 0).sum(axis=1).max())
    n_chunks = chunks(rr.shape[0])
    wide = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
                encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    card = BasecallEngine(eparams, ecfg, **wide)
    c, secs, same, e2e = width_run(card, BasecallEngine(eparams, ecfg, device="cpu", **wide),
                                   (sig, rr, ev, er), max_len, aux)
    out["enc256"] = c
    print(f"  256-unit encoder, bench settings (i8dev, bf16 encoder, bf16 memory, 4-bit probs, "
          f"step): the first read, {rr.shape[0]} snippets, {secs:.3f} s; launches "
          f"{dict((k, v) for k, v in c.items() if v)} (bilstm_bf16 need 4 a "
          f"chunk over {n_chunks}, bilstm_plain_route 0); card vs CPU on 64 snippets: same "
          f"memory {same:.5f} (need >= 0.998), end to end {e2e:.5f} (need >= 0.99) [{smi}]")
    require(c["bilstm_bf16"] == 4 * n_chunks and c["bilstm_plain_route"] == c["bilstm"] == 0,
            "the 256-unit encoder did not run the bf16 BiLSTM kernel 4 times a chunk")
    require(c["beam_cell"] == c["beam_attend"] == c["beam_step"] > 0,
            "the 256-unit encoder's engine did not run the beam kernels")
    require(same >= 0.998, "card and CPU decode the same memory differently (256 units)")
    require(e2e >= 0.99, "card and CPU disagree end to end (256 units)")
    c, secs, same, e2e = width_run(BasecallEngine(eparams, ecfg, **narrow),
                                   BasecallEngine(eparams, ecfg, device="cpu", **narrow),
                                   (sig, rr, ev, er), MAX_OUTPUT_LEN, None)
    out["enc256_f32"] = c
    print(f"  256-unit encoder, f32 stream and memory (step): {secs:.3f} s; launches "
          f"{dict((k, v) for k, v in c.items() if v)} (bilstm need 4 a chunk "
          f"over {n_chunks}); card vs CPU on 64 snippets: same memory {same:.5f} (need >= "
          f"0.998), end to end {e2e:.5f} (need >= 0.99) [{smi}]")
    require(c["bilstm"] == 4 * n_chunks and c["bilstm_plain_route"] == c["bilstm_bf16"] == 0,
            "the 256-unit encoder did not run the f32 BiLSTM kernel 4 times a chunk")
    require(c["beam_cell"] == c["beam_attend"] == c["beam_step"] > 0,
            "the 256-unit f32 engine did not run the beam kernels")
    require(same >= 0.998 and e2e >= 0.99, "card and CPU disagree on the 256-unit f32 encoder")

    # (f) the slice's path at full width: the beam step's kernels at other
    # decoder and beam widths
    out.update(phase_decoder_widths(smi, reads))

    # (c) the kernels' beam loops refuse flagship32's shape
    for impl in ("step", "loop"):
        try:
            BasecallEngine(params, cfg, beam_impl=impl)
        except ValueError as e:
            require("beam_impl='xla'" in str(e), "the refusal does not name beam_impl='xla'")
        else:
            raise SmokeFailure(f"beam_impl={impl!r} accepted a depth-2 decoder")
    print("  beam_impl='step' and 'loop' refuse flagship32's shape (ValueError naming 'xla')")
    return out


def live_decoder(dec: dict) -> dict:
    """A copy of decoder parameters whose pad, end and start tokens' logits
    are pushed down by 20, so that no beam ends and every step picks among
    the bases: seeded weights as drawn end most beams within a few steps
    (phase 5), and at beam 10 every top beam at the first (the end token
    among a row's first 10 candidates outscores any longer beam)."""
    from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER as tk

    bias = dec["fc"]["bias"].clone()
    bias[[tk.pad_id, tk.end_id, tk.start_id]] -= 20.0
    return dict(dec, fc=dict(dec["fc"], bias=bias))


def kernel_vs_plain(card, cpu, snippets, max_len: int, aux, beams: int,
                    live: bool = False, loop=None) -> tuple:
    """The beam-step kernels' decode (or ``loop``'s, the whole-loop kernel's)
    of ``card``'s memory of the first 64 snippets against the plain step's
    decode of the same memory on the CPU (top beam, ``max_len - 1`` live
    steps), with the engines' decoder or, if ``live``, its
    :func:`live_decoder`. Returns (the share of equal tokens, the share of
    base tokens in the card's)."""
    sig, rr, ev, er = snippets
    with torch.inference_mode():
        raw_c, event_c = next(iter(card.compact_snippets(sig, rr[:64], ev, er[:64], aux)))
        mem = card.memory(raw_c, event_c)
        decs = [e.params["decoder"] for e in (card, cpu)]
        if live:
            decs = [live_decoder(d) for d in decs]
        t_card = top_beam_tokens(card, mem, max_len, width=beams, dec=decs[0], loop=loop)
        t_host = top_beam_tokens(cpu, mem.to("cpu"), max_len, width=beams, dec=decs[1])
    return float((t_card == t_host).float().mean()), float((t_card > 2).float().mean())


def phase_decoder_widths(smi: str, reads: list) -> dict:
    """Phase 18 (f), the beam step's kernels on the main path at other
    widths, seeded weights: (1) a joint model with dec_units=256 (2 x
    BiLSTM(128), LSTM(256) + Luong) at the bench's settings (i8dev, bf16
    encoder, bf16 memory, 4-bit probs, beam 5, "step") through
    PerformanceEvaluator.run_pipelined over the 4 reads: beam_cell and
    beam_attend once a step, bilstm_bf16 4 a chunk, no other kernel, no
    plain route; card against CPU on 64 snippets (the kernels' decode of the
    card's memory >= 0.998, end to end >= 0.99); then the same model on f32
    memory and encoder over the first read (the same memory 1.00000); (2)
    the same at dec_units=64 over the first read; (3) the flagship through
    tools/basecall.py's read path at --beam 10 over the 4 reads, the same
    checks; (4) beam_impl="loop" on the same runs: dec_units=256 at the
    bench's settings through run_pipelined, dec_units=64 on f32 over the
    first read, the flagship through the CLI's read path at --beam 10: the
    whole-loop kernel once a chunk, no beam-step kernel, the encoder's kernel
    4 a chunk; the loop kernel's decode of the card's memory against the
    plain step on the CPU (>= 0.998; at --beam 10 also with the live decoder
    on f32 memory) and, on 64 snippets, against the step path on the card
    and the CPU end to end (>= 0.99); (5) fused_greedy_decode of an
    enc_units=64 model (memory width 128) and of the dec_units=256 model
    against plain greedy_decode on the CPU (phase 8's check); (6)
    beam_impl="loop" refuses dec_units=96 on the card, the step's and the
    loop's wrappers W = 17. Returns the launch counts ("dec256", "dec64",
    "beam10", "loop256", "loop64", "loop_beam10", "greedy_e128",
    "greedy_u256")."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.assembly.merger import Merger
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.data.snippets import load_read_compact_ex, prepare_compact
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
    from ravvent_tpu_torch.models.basecaller import init_basecaller
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop
    from ravvent_tpu_torch.tools import profile_decode as pd
    from ravvent_tpu_torch.tools.basecall import MAX_OUTPUT_LEN, basecall_read

    chunks = lambda n: -(-n // 4096)  # noqa: E731
    others = ("beam_step_i8", "beam_step_i8mxu", "beam_attend_i8", "beam_attend_i8mxu",
              "beam_loop", "decode_step", "bilstm_plain_route")
    bench = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
                 project_values=True, encoder_dtype=torch.bfloat16, pack_u8=True,
                 transport_dtype="i8dev", prob_bits=4)
    f32 = dict(chunk_size=4096, memory_dtype=None, encoder_dtype=None, transport_dtype="f32")
    out = {}

    def steps_once(c, what, encoder, n_chunks):
        """beam_cell and beam_attend once a step, the encoder's kernel 4 times
        a chunk, and nothing else: no other decode kernel, no plain route."""
        require(c["beam_cell"] == c["beam_attend"] == c["beam_step"] > 0,
                f"{what}: beam_cell and beam_attend did not launch once a step")
        require(c[encoder] == 4 * n_chunks, f"{what}: {encoder} not 4 a chunk")
        unused = ("bilstm_bf16" if encoder == "bilstm" else "bilstm",) + others
        require(sum(c[k] for k in unused) == 0, f"{what}: another kernel or a plain route ran")

    def loop_once(c, what, encoder, n_chunks):
        """The whole-loop kernel once a chunk, the encoder's kernel 4 times a
        chunk, and nothing else: no beam-step kernel, no plain route."""
        require(c["beam_loop"] == n_chunks, f"{what}: the loop kernel did not launch once a chunk")
        require(c["beam_cell"] == c["beam_attend"] == c["beam_step"] == 0,
                f"{what}: the beam step's kernels launched")
        require(c[encoder] == 4 * n_chunks, f"{what}: {encoder} not 4 a chunk")
        unused = (("bilstm_bf16" if encoder == "bilstm" else "bilstm",)
                  + tuple(k for k in others if k != "beam_loop"))
        require(sum(c[k] for k in unused) == 0, f"{what}: another kernel or a plain route ran")

    def loop_vs(loop_card, step_card, loop_cpu, snippets, max_len, aux, beams):
        """End to end on the first 64 snippets: the loop on the card against
        the step path on the card and against the loop on the CPU."""
        sig, rr, ev, er = snippets
        rr, er = rr[:64], er[:64]
        t_loop, p_loop = loop_card.predict_beam_compact(sig, rr, ev, er, max_len, beams, aux=aux)
        t_step, _ = step_card.predict_beam_compact(sig, rr, ev, er, max_len, beams, aux=aux)
        t_cpu, _ = loop_cpu.predict_beam_compact(sig, rr, ev, er, max_len, beams, aux=aux)
        require(np.isfinite(p_loop).all(), "the loop's probabilities are not finite")
        return float((t_loop == t_step).mean()), float((t_loop == t_cpu).mean())

    cfg = ModelConfig(dec_units=256)
    params = init_basecaller(cfg, torch.Generator().manual_seed(SEED))
    engine = BasecallEngine(params, cfg, **bench)
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = pd.write_reads(reads, d)
        pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=str(d / "cache"))
        pe.run(paths[0])  # warm-up; fills the read cache
        loaded = [load_read_compact_ex(p, Path(p).with_suffix(".label"), 6,
                                       cache_dir=str(d / "cache")) for p in paths]
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        rec = pe.run_pipelined(paths, inflight=8, finishers=4)
        torch.cuda.synchronize()
        c = out["dec256"] = dict(cuda_lib.launches)
        # the same model and reads with beam_impl="loop" (the streamed layout)
        engine_l = BasecallEngine(params, cfg, **dict(bench, beam_impl="loop"))
        pe_l = PerformanceEvaluator(engine_l, beam_width=5, cache_dir=str(d / "cache"))
        pe_l.run(paths[0])  # warm-up
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        rec_l = pe_l.run_pipelined(paths, inflight=8, finishers=4)
        torch.cuda.synchronize()
        out["loop256"] = dict(cuda_lib.launches)
    n_chunks = sum(chunks(x[1].shape[0]) for x in loaded)
    print(f"  dec_units=256, bench settings (i8dev, bf16 encoder, bf16 memory, 4-bit probs, "
          f"step), run_pipelined inflight 8, finishers 4: {rec['bases_per_s']:.1f} bases/s, wall "
          f"{rec['wall_s']:.3f} s; launches {dict((k, v) for k, v in c.items() if v)} "
          f"(bilstm_bf16 need 4 a chunk over {n_chunks}) [{smi}]")
    steps_once(c, "dec_units=256", "bilstm_bf16", n_chunks)
    require(rec["bases_num"] > 0, "dec_units=256: the pipelined run called no bases")
    sig, rr, ev, er, nuc, aux = loaded[0]
    max_len = int((nuc != 0).sum(axis=1).max())
    cpu = BasecallEngine(params, cfg, device="cpu", **bench)
    same, _ = kernel_vs_plain(engine, cpu, (sig, rr, ev, er), max_len, aux, 5)
    _, e2e = card_vs_cpu(engine, cpu, sig, rr, ev, er, max_len, aux)
    print(f"  dec_units=256, bench settings, card vs CPU on 64 snippets: the kernels' decode of "
          f"the card's memory against the plain step's {same:.5f} (need >= 0.998); end to end "
          f"{e2e:.5f} (need >= 0.99)")
    require(same >= 0.998 and e2e >= 0.99, "dec_units=256: card and CPU disagree")
    c = out["loop256"]
    cpu_l = BasecallEngine(params, cfg, device="cpu", **dict(bench, beam_impl="loop"))
    same, _ = kernel_vs_plain(engine_l, cpu_l, (sig, rr, ev, er), max_len, aux, 5, loop=beam_loop)
    vs_step, vs_cpu = loop_vs(engine_l, engine, cpu_l, (sig, rr, ev, er), max_len, aux, 5)
    print(f"  dec_units=256, bench settings, beam_impl=loop, run_pipelined: "
          f"{rec_l['bases_per_s']:.1f} bases/s, wall {rec_l['wall_s']:.3f} s; launches "
          f"{dict((k, v) for k, v in c.items() if v)} (beam_loop need 1 a chunk over {n_chunks}); "
          f"the loop kernel's decode of the card's memory against the plain step {same:.5f} "
          f"(need >= 0.998); on 64 snippets against the step path {vs_step:.5f}, the CPU "
          f"{vs_cpu:.5f} (need >= 0.99) [{smi}]")
    loop_once(c, "dec_units=256 loop", "bilstm_bf16", n_chunks)
    require(rec_l["bases_num"] > 0, "dec_units=256 loop: the pipelined run called no bases")
    require(same >= 0.998 and vs_step >= 0.99 and vs_cpu >= 0.99,
            "dec_units=256 loop: the loop disagrees with the step or the CPU")
    sig, rr, ev, er, _, _ = prepare_compact(reads[0][0], reads[0][1],
                                            np.array(["a"] * len(reads[0][1])), 6)
    for U in (256, 64):
        wcfg = ModelConfig(dec_units=U)
        wparams = params if U == 256 else init_basecaller(wcfg, torch.Generator().manual_seed(SEED))
        card, host = (BasecallEngine(wparams, wcfg, device=dv, **f32) for dv in (None, "cpu"))
        c, secs, _, e2e = width_run(card, host, (sig, rr, ev, er), MAX_OUTPUT_LEN, None)
        same, _ = kernel_vs_plain(card, host, (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 5)
        live, bases = kernel_vs_plain(card, host, (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 5,
                                      live=True)
        print(f"  dec_units={U}, f32 memory and encoder (step): the first read, {rr.shape[0]} "
              f"snippets, {secs:.3f} s; launches {dict((k, v) for k, v in c.items() if v)}; "
              f"card vs CPU on 64 snippets: the kernels' decode of the same memory {same:.5f} "
              f"(need 1.00000), with the live decoder {live:.5f} (need >= 0.998; bases "
              f"{bases:.3f} of its tokens), end to end {e2e:.5f} (need >= 0.99) [{smi}]")
        steps_once(c, f"dec_units={U} f32", "bilstm", chunks(rr.shape[0]))
        require(same == 1.0 and live >= 0.998 and e2e >= 0.99,
                f"dec_units={U} f32: card and CPU disagree")
        if U == 64:
            out["dec64"] = c
            card_l, host_l = (BasecallEngine(wparams, wcfg, device=dv, beam_impl="loop", **f32)
                              for dv in (None, "cpu"))
            c, secs, _, _ = width_run(card_l, host_l, (sig, rr, ev, er), MAX_OUTPUT_LEN, None)
            same, _ = kernel_vs_plain(card_l, host_l, (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 5,
                                      live=True, loop=beam_loop)
            vs_step, vs_cpu = loop_vs(card_l, card, host_l, (sig, rr, ev, er), MAX_OUTPUT_LEN,
                                      None, 5)
            out["loop64"] = c
            print(f"  dec_units=64, f32 memory and encoder, beam_impl=loop: the first read "
                  f"{secs:.3f} s; launches {dict((k, v) for k, v in c.items() if v)}; the loop "
                  f"kernel's decode of the same memory with the live decoder {same:.5f} (need "
                  f">= 0.998); on 64 snippets against the step path {vs_step:.5f}, the CPU "
                  f"{vs_cpu:.5f} (need >= 0.99) [{smi}]")
            loop_once(c, "dec_units=64 loop", "bilstm", chunks(rr.shape[0]))
            require(same >= 0.998 and vs_step >= 0.99 and vs_cpu >= 0.99,
                    "dec_units=64 loop: the loop disagrees with the step or the CPU")

    # the flagship through the CLI's read path at --beam 10
    fcfg, fparams = flagship_params()
    cli = BasecallEngine(fparams, fcfg, chunk_size=4096, project_values=True)
    merger = Merger()
    basecall_read(cli, merger, reads[0][0][:3000], reads[0][1][reads[0][1][:, 1] <= 3000],
                  beam=10)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    n_bases = n_chunks = 0
    for raw, ranges, _ in reads:
        call = basecall_read(cli, merger, raw, ranges, beam=10)
        require(call is not None, "a simulated read gave no snippets")
        n_bases += len(call.merged.seq)
        n_chunks += chunks(call.n_snippets)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = out["beam10"] = dict(cuda_lib.launches)
    cpu = BasecallEngine(fparams, fcfg, chunk_size=4096, project_values=True, device="cpu")
    same, _ = kernel_vs_plain(cli, cpu, (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 10)
    rr64, er64 = rr[:64], er[:64]
    t_gpu, p_gpu = cli.predict_beam_compact(sig, rr64, ev, er64, MAX_OUTPUT_LEN, 10)
    t_cpu, _ = cpu.predict_beam_compact(sig, rr64, ev, er64, MAX_OUTPUT_LEN, 10)
    e2e = float((t_gpu == t_cpu).mean())
    # as drawn, every top beam at beam 10 ends at once (live_decoder); the
    # live decoder on f32 memory holds the kernels at W = 10 on full rows
    live, bases = kernel_vs_plain(*(BasecallEngine(fparams, fcfg, device=dv, **f32)
                                    for dv in (None, "cpu")),
                                  (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 10, live=True)
    print(f"  flagship, CLI read path at --beam 10, 4 reads: {n_bases} bases in {wall:.3f} s "
          f"(seeded weights: the top beams end at once); launches "
          f"{dict((k, v) for k, v in c.items() if v)}; card vs CPU on 64 snippets: the kernels' "
          f"decode of the same memory {same:.5f} (need >= 0.998), end to end {e2e:.5f} (need "
          f">= 0.99); f32 memory with the live decoder {live:.5f} (need >= 0.998; bases "
          f"{bases:.3f} of its tokens) [{smi}]")
    steps_once(c, "--beam 10", "bilstm", n_chunks)
    require(np.isfinite(p_gpu).all() and same >= 0.998 and e2e >= 0.99 and live >= 0.998,
            "--beam 10: card and CPU disagree")

    # the same read path with --beam-impl loop at --beam 10
    cli_l = BasecallEngine(fparams, fcfg, chunk_size=4096, project_values=True, beam_impl="loop")
    basecall_read(cli_l, merger, reads[0][0][:3000], reads[0][1][reads[0][1][:, 1] <= 3000],
                  beam=10)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.perf_counter()
    n_bases = 0
    for raw, ranges, _ in reads:
        call = basecall_read(cli_l, merger, raw, ranges, beam=10)
        require(call is not None, "a simulated read gave no snippets")
        n_bases += len(call.merged.seq)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = out["loop_beam10"] = dict(cuda_lib.launches)
    cpu_l = BasecallEngine(fparams, fcfg, chunk_size=4096, project_values=True, device="cpu",
                           beam_impl="loop")
    same, _ = kernel_vs_plain(cli_l, cpu_l, (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 10,
                              loop=beam_loop)
    vs_step, vs_cpu = loop_vs(cli_l, cli, cpu_l, (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 10)
    live, bases = kernel_vs_plain(*(BasecallEngine(fparams, fcfg, device=dv, beam_impl="loop",
                                                   **f32) for dv in (None, "cpu")),
                                  (sig, rr, ev, er), MAX_OUTPUT_LEN, None, 10, live=True,
                                  loop=beam_loop)
    print(f"  flagship, CLI read path at --beam 10 --beam-impl loop, 4 reads: {n_bases} bases in "
          f"{wall:.3f} s; launches {dict((k, v) for k, v in c.items() if v)}; the loop kernel's "
          f"decode of the card's memory against the plain step {same:.5f} (need >= 0.998), f32 "
          f"memory with the live decoder {live:.5f} (need >= 0.998; bases {bases:.3f} of its "
          f"tokens); on 64 snippets against the step path {vs_step:.5f}, the CPU {vs_cpu:.5f} "
          f"(need >= 0.99) [{smi}]")
    loop_once(c, "--beam 10 loop", "bilstm", n_chunks)
    require(same >= 0.998 and live >= 0.998 and vs_step >= 0.99 and vs_cpu >= 0.99,
            "--beam 10 loop: the loop disagrees with the step or the CPU")

    # fused greedy decode at other widths: a 64-unit encoder (memory width
    # 128) and the 256-unit decoder
    ecfg = ModelConfig(enc_units=64)
    out["greedy_e128"] = phase_greedy(ecfg, init_basecaller(ecfg, torch.Generator().manual_seed(SEED)),
                                      "fused greedy, enc_units=64 (E = 128)")
    out["greedy_u256"] = phase_greedy(cfg, params, "fused greedy, dec_units=256")

    # what stays refused: both beam kernels' loops at 96 decoder units, and
    # at 17 beams (a CUDA tensor raises, naming the shape)
    try:
        BasecallEngine({}, ModelConfig(dec_units=96), beam_impl="loop")
    except ValueError as e:
        require("64, 128, 256 units" in str(e), "the loop's refusal does not name its units")
    else:
        raise SmokeFailure("beam_impl='loop' accepted dec_units=96")
    for engine_, what in ((cli, "step"), (cli_l, "loop")):
        try:
            engine_.predict_beam_compact(sig, rr64, ev, er64, MAX_OUTPUT_LEN, 17)
        except ValueError as e:
            require("W = 17" in str(e), f"the {what}'s refusal does not name W = 17")
        else:
            raise SmokeFailure(f"the beam {what} accepted 17 beams")
    print("  beam_impl='loop' refuses dec_units=96; the step's and the loop's kernels refuse "
          "W = 17 (ValueError naming the shape)")
    return out


def captured(engine, store: list, lock) -> None:
    """Record on ``engine`` (its instance) a digest of each collected
    result: its shape and the bytes of its tokens and probabilities."""
    import hashlib

    orig = engine.collect_beam_compact

    def collect(handle):
        tokens, probs = orig(handle)
        digest = hashlib.sha256(tokens.tobytes() + probs.tobytes()).hexdigest()
        with lock:
            store.append((tokens.shape, digest))
        return tokens, probs

    engine.collect_beam_compact = collect


def dp_step_rank(rank: int, world_size: int, init_method: str, out_dir: str, params: dict,
                 batch: tuple, timed_steps: int, model_shards: int = 1) -> None:
    """A rank of phase 19 (b) (data-parallel) or (d) (a grid of
    ``world_size / model_shards`` data shards by ``model_shards`` model
    ranks) on the card: a validation of the flagship at TrainConfig's
    defaults, its kernel launches counted, then one train step on its rows
    of the global batch; its metrics, launches, gradients and updated
    parameters to ``out_dir/rank{rank}.npz``, then ``timed_steps`` steps
    timed."""
    import dataclasses

    from ravvent_tpu_torch.config import RunConfig
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.parallel import distributed
    from ravvent_tpu_torch.training.loop import Trainer
    from ravvent_tpu_torch.weights import flatten, unflatten

    distributed.initialize(init_method, world_size, rank, "gloo")
    try:
        cfg = RunConfig()
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, num_data_shards=world_size // model_shards))
        tr = Trainer(cfg, params=unflatten(params), model_shards=model_shards)
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        v = tr.validate_on_batch(batch)
        torch.cuda.synchronize()
        launches = dict(cuda_lib.launches)
        out, grads = tr.loss_and_grads(batch)
        tr.apply_gradients(grads)
        torch.cuda.synchronize()
        got = {"loss": float(out.loss.detach()), "acc": float(out.acc),
               "val": [float(v["loss"]), float(v["acc"])], "launches": json.dumps(launches)}
        got.update({"grad/" + k: v for k, v in flatten(grads).items()})
        got.update({"param/" + k: v for k, v in flatten(tr.params).items()})
        # the timed steps' collectives: their count and host seconds, each
        # timed from a synchronized card (its device-to-host copy would
        # wait for the queued work anyway)
        in_place, coll = distributed._in_place, [0, 0.0]

        def timed_in_place(fn, t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = in_place(fn, t)
            coll[0] += 1
            coll[1] += time.perf_counter() - t0
            return out

        distributed._in_place = timed_in_place
        got["step_s"] = np.asarray(train_steps(tr, batch, timed_steps))
        got["collectives"], got["collective_s"] = coll[0] / timed_steps, coll[1] / timed_steps
        np.savez(f"{out_dir}/rank{rank}.npz", **got)
    finally:
        torch.distributed.destroy_process_group()


def train_steps(trainer, batch, n: int) -> list:
    """Seconds of each of ``n`` train steps, each ending in a synchronize."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        trainer.train_on_batch(batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_multidevice(smi: str) -> dict:
    """Multi-device runs on the one card: (a) the sharded engine, a 2-shard
    mesh on cuda:0 at the flagship's widths and the bench's settings,
    against the 1-shard engine through PerformanceEvaluator.run_pipelined
    on the compact wire and on sigdev over the 4 reads (results bit-equal;
    each kernel's launches doubled a chunk); (b) data-parallel training, 2
    gloo ranks spawned on the card, global batch 128 of phase 17's data,
    one step against the single-process step on the card; (d) the same on
    a 1 x 2 and a 2 x 2 grid of ranks (the 'model' axis: the attention
    memory's positions sharded over each model row); (c) the entry's dry
    run, dryrun_multichip(2) and (4) (a 2 x 2 grid), every rank on the
    card. Returns the figures."""
    import tempfile
    import threading
    from pathlib import Path

    from ravvent_tpu_torch.config import RunConfig
    from ravvent_tpu_torch.data import chiron, simulator
    from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
    from ravvent_tpu_torch.entry import dryrun_multichip
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.parallel.distributed import spawn
    from ravvent_tpu_torch.parallel.inference import ShardedBasecallEngine
    from ravvent_tpu_torch.parallel.mesh import make_mesh
    from ravvent_tpu_torch.training.loop import Trainer
    from ravvent_tpu_torch.weights import flatten

    cfg, params = flagship_params()
    bench = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
                 encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    engines = {1: BasecallEngine(params, cfg, **bench),
               2: ShardedBasecallEngine(params, cfg, make_mesh(devices=["cuda:0", "cuda:0"]),
                                        **bench)}
    fig = {}
    kernels = ("bilstm_bf16", "beam_cell", "beam_attend", "peak_scan")
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        paths = []
        for i, (raw, ranges, seq) in enumerate(simulated_reads()):
            chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", raw, ranges, seq)
            paths.append(str(d / f"r{i}.signal"))

        # (a) the sharded engine against one shard, result for result
        for wire in ("compact", "sigdev"):
            runs = {}
            for shards, engine in engines.items():
                pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=str(d / "cache"),
                                          wire=wire)
                pe.run_pipelined(paths, inflight=8, finishers=4)  # warm-up; fills the read cache
                store, lock = [], threading.Lock()
                captured(engine, store, lock)
                torch.cuda.synchronize()
                cuda_lib.reset_launches()
                rec = pe.run_pipelined(paths, inflight=8, finishers=4)
                torch.cuda.synchronize()
                counts = dict(cuda_lib.launches)
                del engine.collect_beam_compact  # the class's method again
                runs[shards] = (sorted(store), counts, rec)
                per_read = ", ".join(f"{k} {counts[k] / len(paths):g}" for k in kernels)
                print(f"  (a) {wire}, {shards} shard(s) on cuda:0: run_pipelined wall "
                      f"{rec['wall_s']:.4f} s, {rec['bases_per_s']:.1f} bases/s, stages "
                      f"{rec['stages_s']}; launches a read: {per_read} [{smi}]")
                fig[f"{wire}_{shards}_wall_s"] = rec["wall_s"]
            (res1, c1, r1), (res2, c2, r2) = runs[1], runs[2]
            require(len(res1) == len(paths) and res1 == res2,
                    f"{wire}: 2 shards' tokens or probabilities differ from 1 shard's")
            require(r1["bases_num"] == r2["bases_num"], f"{wire}: the runs counted other bases")
            for k in ("bilstm_bf16", "beam_cell", "beam_attend"):
                require(c1[k] > 0 and c2[k] == 2 * c1[k], f"{wire}: {k} did not launch twice as "
                        f"often on 2 shards ({c2[k]} vs {c1[k]})")
            require(c2["peak_scan"] == c1["peak_scan"] == (2 * len(paths) if wire == "sigdev"
                                                           else 0),
                    f"{wire}: the segmentation ran other than once a read")
            print(f"  (a) {wire}: 2 shards' results bit-equal to 1 shard's on all "
                  f"{len(res1)} reads; wall 2 shards / 1 shard "
                  f"{r2['wall_s'] / r1['wall_s']:.4f}")

        # (b) data-parallel training: 2 gloo ranks on the card, against one process
        genome = simulator.random_genome(20_000, np.random.default_rng(SEED))
        simulator.generate_chiron_dataset(d / "ds", genome, n_reads=2,
                                          read_len_range=(1500, 1800), seed=SEED + 1)
        fi = chiron.create_files_info(d / "ds", stride=6, verbose=False)
        run_cfg = RunConfig()
        gen = SnippetBatchGenerator(fi, stride=6, batch_size=run_cfg.train.batch_size,
                                    shuffle=False, cache_dir=str(d / "ds" / "cache"))
        batch = gen[0]
        require(batch[2].shape[0] == 128, "phase 17's batch is not 128 rows")
        timed = 5
        t0 = time.perf_counter()
        spawn(dp_step_rank, 2, (str(d), flatten(params), batch, timed), init_dir=str(d),
              timeout=400.0)
        fig["dp_spawn_s"] = time.perf_counter() - t0
        one = Trainer(run_cfg, params=params)
        v1 = one.validate_on_batch(batch)
        out, grads = one.loss_and_grads(batch)
        one.apply_gradients(grads)
        g1, p1 = flatten(grads), flatten(one.params)  # after the one step
        one_steps = train_steps(one, batch, timed)
        loss1, val1 = float(out.loss.detach()), float(v1["loss"])
        lr = run_cfg.train.learning_rate

        def against_one(ranks: list) -> dict:
            """Rank 0 against the one-process step, and every rank's
            parameters against rank 0's."""
            gerr = {k: float(np.abs(ranks[0]["grad/" + k] - g1[k]).max())
                    / max(float(np.abs(g1[k]).max()), 1e-30) for k in g1}
            worst = max(gerr, key=gerr.get)
            return {"rel": abs(float(ranks[0]["loss"]) - loss1) / abs(loss1),
                    "val_rel": abs(float(ranks[0]["val"][0]) - val1) / abs(val1),
                    "worst": worst, "gerr": gerr[worst],
                    "same": all(np.array_equal(r[k], ranks[0][k]) for r in ranks[1:]
                                for k in ranks[0].files if k.startswith("param/")),
                    "pdiff": max(float(np.abs(ranks[0]["param/" + k] - p1[k]).max())
                                 for k in p1) / lr}

        ranks = [np.load(d / f"rank{r}.npz") for r in range(2)]
        h = against_one(ranks)
        fig["dp_step_s"] = float(np.mean(ranks[0]["step_s"]))
        fig["one_step_s"] = float(np.mean(one_steps))
        print(f"  (b) DP train step, 2 gloo ranks on cuda:0, 64 rows each of a global batch of "
              f"128 at p = 0.5: loss {float(ranks[0]['loss']):.7f} vs one process {loss1:.7f}, "
              f"rel {h['rel']:.3e} (need <= 1e-5); all-reduced gradients: worst leaf "
              f"{h['worst']} {h['gerr']:.3e} of its largest magnitude (need <= 1e-5); the "
              f"ranks' parameters bit-equal {h['same']}; parameters' largest difference from "
              f"one process {h['pdiff']:.4f} lr [{smi}]")
        print(f"  (b) step seconds (mean of {timed} after the first): DP rank 0 "
              f"{fig['dp_step_s']:.4f} s ({np.round(ranks[0]['step_s'], 4).tolist()}), one "
              f"process {fig['one_step_s']:.4f} s ({np.round(one_steps, 4).tolist()}); rank 0's "
              f"collectives a step {float(ranks[0]['collectives']):g}, "
              f"{float(ranks[0]['collective_s']):.4f} s; the spawn with its step "
              f"{fig['dp_spawn_s']:.2f} s [{smi}]")
        require(np.isfinite(loss1) and h["rel"] <= 1e-5, "the DP loss differs from one process's")
        require(h["gerr"] <= 1e-5, f"the DP gradients differ from one process's on {h['worst']}")
        require(h["same"], "the ranks' parameters differ after the step")

        # (d) the 'model' axis: a 1 x 2 and a 2 x 2 grid of gloo ranks on the
        # card, the attention memory's positions sharded over each model row
        for n_data in (1, 2):
            world, grid = 2 * n_data, f"{n_data}x2"
            gd = d / f"grid{grid}"
            gd.mkdir()
            t0 = time.perf_counter()
            spawn(dp_step_rank, world, (str(gd), flatten(params), batch, timed, 2),
                  init_dir=str(gd), timeout=400.0)
            fig[f"grid{grid}_spawn_s"] = time.perf_counter() - t0
            ranks = [np.load(gd / f"rank{r}.npz") for r in range(world)]
            h = against_one(ranks)
            counts = [json.loads(str(r["launches"])) for r in ranks]
            fig[f"grid{grid}_step_s"] = float(np.mean(ranks[0]["step_s"]))
            print(f"  (d) grid {grid} (data x model), {world} gloo ranks on cuda:0, "
                  f"{128 // n_data} rows and half the 230 memory positions each, p = 0.5: loss "
                  f"{float(ranks[0]['loss']):.7f} vs one process {loss1:.7f}, rel "
                  f"{h['rel']:.3e} (need <= 1e-5); gradients: worst leaf {h['worst']} "
                  f"{h['gerr']:.3e} of its largest magnitude (need <= 1e-5); validation loss "
                  f"rel {h['val_rel']:.3e} (need <= 1e-4); the ranks' parameters bit-equal "
                  f"{h['same']}; parameters' largest difference from one process "
                  f"{h['pdiff']:.4f} lr; bilstm launches a validation on each rank "
                  f"{[c['bilstm'] for c in counts]}, plain route "
                  f"{[c['bilstm_plain_route'] for c in counts]} [{smi}]")
            print(f"  (d) step seconds (mean of {timed} after the first): grid {grid} rank 0 "
                  f"{fig[f'grid{grid}_step_s']:.4f} s "
                  f"({np.round(ranks[0]['step_s'], 4).tolist()}), beside (b)'s DP rank 0 "
                  f"{fig['dp_step_s']:.4f} s and one process {fig['one_step_s']:.4f} s; rank "
                  f"0's collectives a step {float(ranks[0]['collectives']):g}, "
                  f"{float(ranks[0]['collective_s']):.4f} s; the spawn with its steps "
                  f"{fig[f'grid{grid}_spawn_s']:.2f} s [{smi}]")
            require(h["rel"] <= 1e-5, f"grid {grid}: the loss differs from one process's")
            require(h["gerr"] <= 1e-5,
                    f"grid {grid}: the gradients differ from one process's on {h['worst']}")
            require(h["val_rel"] <= 1e-4,
                    f"grid {grid}: the validation loss differs from one process's")
            require(h["same"], f"grid {grid}: the ranks' parameters differ after the step")
            require(all(c["bilstm"] == 4 and c["bilstm_plain_route"] == 0 for c in counts),
                    f"grid {grid}: a rank's validation did not run its encoder on bilstm")

    # (c) the dry run: one step and validation, then the sharded decodes; at
    # 4 ranks on a 2 x 2 grid
    for n in (2, 4):
        t0 = time.perf_counter()
        dryrun_multichip(n, timeout=400.0)
        fig[f"dryrun{n}_s"] = time.perf_counter() - t0
        print(f"  (c) dryrun_multichip({n}), all ranks on cuda:0: {fig[f'dryrun{n}_s']:.2f} s "
              f"[{smi}]")
    return fig


def last_checkpoint(models: "Path", epoch: int) -> "Path":
    """The run's one checkpoint of ``epoch`` under the run-name schema."""
    found = sorted((models / "snippets" / "mask" / "encd_2_decd_1").glob(f"*.{epoch:02d}"))
    require(len(found) == 1, f"expected one epoch-{epoch} checkpoint, found {len(found)}")
    return found[0]


def phase_tools(smi: str) -> dict:
    """The user tools (ravvent_tpu_torch/tools/) at the flagship's width,
    each CLI's main(argv) in process, in a temporary directory: (a)
    make_dataset, (b) train and a resume, (c) evaluate on the card and with
    --cpu, (d) train_curriculum with a restart and a sweep, (e) sweep_epochs
    and eval_token_acc on the card and with --cpu. Returns the figures."""
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.assembly.alignment import banded_global_identity
    from ravvent_tpu_torch.config import DataConfig, ModelConfig
    from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
    from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tools import (
        eval_token_acc, evaluate, make_dataset, sweep_epochs, train, train_curriculum,
    )
    from ravvent_tpu_torch.tools.common import load_params
    from ravvent_tpu_torch.weights import flatten, to_device

    fig, secs, kernels = {}, {}, {}

    def step(name: str, fn):
        """Run one step from zeroed launch counts: (result, seconds); the
        step's launches kept under its name."""
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        kernels[name] = {k: v for k, v in cuda_lib.launches.items() if v}
        print(f"  {name}: {secs[name]:.3f} s, launches {kernels[name]} [{smi}]", flush=True)
        return out

    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        ds = d / "ds"
        # (a) the dataset: 2 train and 4 eval reads of 1.5-1.8 kb (4, so that
        # the val split, a quarter of them, holds a read)
        step("(a) make_dataset", lambda: make_dataset.main([
            "--out", str(ds), "--n-kmers", "43", "--genome-len", "20000", "--train-reads", "2",
            "--eval-reads", "4", "--read-len", "1500", "1800", "--seed", str(SEED + 3)]))
        val_fi = ds / "eval" / "files_info.val.snippets.stride_6.json"
        test_fi = ds / "eval" / "files_info.test.snippets.stride_6.json"
        n_val, n_test = (len(json.loads(p.read_text())) for p in (val_fi, test_fi))
        require((n_val, n_test) == (1, 3), f"val/test split {n_val}/{n_test}, expected 1/3")

        # (b) train, 2 epochs of 3 steps at p = 0, then a resume from epoch 1
        models = d / "models"
        targs = ["--dataset", str(ds), "--epochs", "2", "--steps-per-epoch", "3",
                 "--validation-steps", "2", "--teacher-forcing", "1.0", "--seed", str(SEED)]
        hist = step("(b) train", lambda: train.main(targs + [
            "--checkpoint-dir", str(models), "--info-dir", str(d / "info")]))
        k = kernels["(b) train"]
        n_val_batches = 2 * 2
        print(f"  train: loss {hist['loss']}, val_loss {hist['val_loss']}; bilstm "
              f"{k.get('bilstm', 0)} launches (need 4 a validation batch: "
              f"{4 * n_val_batches}), others {sum(v for n, v in k.items() if n != 'bilstm')} "
              f"(need 0: the train steps run the plain encoder)")
        require(all(np.isfinite(hist["loss"] + hist["val_loss"])), "a train loss is not finite")
        require(k == {"bilstm": 4 * n_val_batches}, "train launched other than 4 bilstm a "
                "validation batch")
        ckpt1, ckpt2 = last_checkpoint(models, 1), last_checkpoint(models, 2)
        hist_r = step("(b) train, resumed", lambda: train.main(targs + [
            "--resume-epoch", "1", "--resume-path", str(ckpt1), "--checkpoint-dir",
            str(d / "models_r"), "--info-dir", str(d / "info_r")]))
        rel = abs(hist_r["loss"][0] - hist["loss"][1]) / abs(hist["loss"][1])
        got, ref = (flatten(load_params(p)) for p in (last_checkpoint(d / "models_r", 2), ckpt2))
        perr = max(float(np.abs(got[n] - ref[n]).max()) / max(float(np.abs(ref[n]).max()), 1e-30)
                   for n in ref)
        fig["resume_loss_rel"], fig["resume_param_err"] = rel, perr
        print(f"  resume from epoch 1: epoch-2 loss {hist_r['loss'][0]!r} vs {hist['loss'][1]!r}, "
              f"rel {rel:.3e} (need <= 1e-6); parameters {perr:.3e} of a leaf's largest "
              f"(need <= 1e-6)")
        require(rel <= 1e-6 and perr <= 1e-6, "the resumed run differs from the uninterrupted one")

        # (c) evaluate the last checkpoint on the card, then with --cpu
        merged = []
        map_identity = MappingEvaluator.map_identity

        def recording(self, pred_seq, ref_seq):
            merged.append(pred_seq)
            return map_identity(self, pred_seq, ref_seq)

        MappingEvaluator.map_identity = recording
        try:
            eargs = ["--checkpoint", str(ckpt2), "--files-info", str(test_fi), "--beams", "5,1",
                     "--tag", "smoke", "--cache-dir", str(ds / ".cache")]
            tot_card = step("(c) evaluate", lambda: evaluate.main(eargs + [
                "--out-dir", str(d / "ev_card")]))
            card_merged = list(merged)
            tot_cpu = step("(c) evaluate --cpu", lambda: evaluate.main(eargs + [
                "--cpu", "--out-dir", str(d / "ev_cpu")]))
        finally:
            MappingEvaluator.map_identity = map_identity
        cpu_merged = merged[len(card_merged):]
        card_bases = sum(len(m) for m in card_merged)
        require(len(card_merged) == len(cpu_merged) == 2 * n_test, "a read was not merged")
        agree = [banded_global_identity(a, b) for a, b in zip(card_merged, cpu_merged)]
        fig["merged_agree"] = sum(m for m, _, _ in agree) / max(sum(c for _, c, _ in agree), 1)
        n_equal = sum(a == b for a, b in zip(card_merged, cpu_merged))
        names = sorted(p.name for p in (d / "ev_card").iterdir())
        require(names == sorted(p.name for p in (d / "ev_cpu").iterdir()) and len(names) == 4,
                "card and CPU evaluate wrote other files")
        for n in names:
            if n.startswith("mapping_evaluator_results"):
                rc, rh = (json.loads((d / side / n).read_text()) for side in ("ev_card", "ev_cpu"))
                require([(r["path"], sorted(r)) for r in rc] == [(r["path"], sorted(r)) for r in rh],
                        f"{n}: card and CPU records differ in reads or keys")
        gap = max(abs(tot_card[key][0] - tot_cpu[key][0]) for key in tot_card)
        k = kernels["(c) evaluate"]
        fig["eval_bases_per_s"] = card_bases / secs["(c) evaluate"]
        print(f"  evaluate, beams 5 and 1 over {n_test} reads: card {tot_card}, CPU {tot_cpu}; "
              f"identity gap {gap:.3f} points (need <= 0.3); {card_bases} merged bases in "
              f"{secs['(c) evaluate']:.3f} s on the card: {fig['eval_bases_per_s']:.0f} bases/s "
              f"(a smoke figure: a 2-epoch model, {n_test} short reads, the host's merge and "
              f"mapping inside), "
              f"the CPU {secs['(c) evaluate --cpu']:.3f} s; merged reads card vs CPU: "
              f"{n_equal} of {len(agree)} equal, banded identity {fig['merged_agree']:.5f} (need "
              f">= 0.999) [{smi}]")
        require(gap <= 0.3, "card and CPU identities differ by more than 0.3 points")
        require(n_equal == len(agree) or fig["merged_agree"] >= 0.999,
                "card and CPU merged reads differ: banded "
                f"identity {fig['merged_agree']:.5f} < 0.999")
        require(k.get("beam_cell", 0) > 0 and k.get("beam_attend", 0) == k.get("beam_cell")
                and k.get("bilstm", 0) > 0, "evaluate did not run bilstm, beam_cell and "
                "beam_attend")
        require(not kernels["(c) evaluate --cpu"], "the CPU run launched a kernel")

        # (d) the curriculum: the restart fires once, the sweep takes 2 epochs
        summary = step("(d) train_curriculum", lambda: train_curriculum.main([
            "--dataset", str(ds), "--tag", "smoke", "--seed", str(SEED), "--stages",
            "[[1.0,2e-3,1,3],[0.5,5e-4,1,3]]", "--sweep-epochs", "2", "--restart-below",
            "1.01", "--max-restarts", "1", "--workdir", str(d / "cur"), "--export",
            str(d / "cur_best")]))
        print(f"  curriculum: restarts {summary['restarts']}, sweep {summary['epoch_sweep']}, "
              f"best epoch {summary['best_epoch']}")
        require(len(summary["restarts"]) == 1 and summary["restarts"][0]["restarted"]
                and summary["seed"] == SEED + 1, "the bad-basin restart did not fire once")
        require([r["epoch"] for r in summary["epoch_sweep"]] == [1, 2], "the sweep missed an epoch")
        require((d / "cur_best" / "params.npz").exists() and (d / "cur" / "restart_log.json")
                .exists(), "the curriculum wrote no export or restart log")
        k = kernels["(d) train_curriculum"]
        require(k.get("bilstm", 0) > 0 and k.get("beam_cell", 0) > 0, "the curriculum's "
                "validation and sweep launched no kernel")

        # (e) sweep_epochs over (b)'s checkpoints; eval_token_acc card and CPU
        res = step("(e) sweep_epochs", lambda: sweep_epochs.main([
            "--run-name", ckpt1.name[:-3], "--epochs", "1,2", "--checkpoint-dir", str(models),
            "--files-info", str(val_fi), "--out", str(d / "sweep.json"), "--export-best",
            str(d / "best")]))
        require(sorted(res) == [1, 2] and (d / "best" / "params.npz").exists(),
                "sweep_epochs missed an epoch or the export")
        targs = ["--checkpoint", str(ckpt2), "--files-info", str(test_fi), "--tag", "smoke",
                 "--max-batches", "2", "--cache-dir", str(ds / ".cache")]
        row_card = step("(e) eval_token_acc", lambda: eval_token_acc.main(
            targs + ["--out-dir", str(d / "tok_card")]))
        row_cpu = step("(e) eval_token_acc --cpu", lambda: eval_token_acc.main(
            targs + ["--cpu", "--out-dir", str(d / "tok_cpu")]))
        k = kernels["(e) eval_token_acc"]
        # the tokens on the same memory: the card's, decoded on both devices
        cfg = ModelConfig()
        params = to_device(load_params(ckpt2), "cuda")
        gen = SnippetBatchGenerator.from_config(str(test_fi), DataConfig(),
                                               cache_dir=str(ds / ".cache"))
        raw, event, nuc = gen[0]
        with torch.no_grad():
            mem = eval_token_acc.memory(params, cfg, torch.as_tensor(raw, device="cuda"),
                                        torch.as_tensor(event, device="cuda"))
            steps = nuc.shape[1] - 1
            t_card = eval_token_acc.greedy_tokens(params, cfg, mem, steps).cpu()
            t_cpu = eval_token_acc.greedy_tokens(to_device(params, "cpu"), cfg, mem.to("cpu"), steps)
        same = float((t_card == t_cpu).float().mean())
        accs = ("strict", "val_style", "teacher_forced")
        worst = max(abs(row_card[a] - row_cpu[a]) for a in accs)
        fig["token_same"], fig["token_acc_gap"] = same, worst
        print(f"  eval_token_acc, 2 batches of 128: card {row_card}, CPU {row_cpu}, largest gap "
              f"{worst:.5f} (need <= 0.01); tokens on the same memory {same:.5f} (need >= 0.998); "
              f"decode_step {k.get('decode_step', 0)} launches (need 2 x {steps}) [{smi}]")
        require(worst <= 0.01, "card and CPU token accuracies differ by more than 0.01")
        require(same >= 0.998, "card and CPU greedy tokens disagree on the same memory")
        require(k.get("decode_step", 0) == 2 * steps and k.get("bilstm", 0) == 8,
                "eval_token_acc did not launch decode_step a step and bilstm 4 a batch")
    fig["secs"], fig["kernels"] = secs, kernels
    return fig


def phase_bench_tool(smi: str, identity: bool = True) -> dict:
    """The bench's entry point (ravvent_tpu_torch/tools/bench.py): its
    main(argv) in process at its defaults on seeded weights (bf16 memory and
    encoder stream, i8dev, beam 5, step; 4 reads of 12-18 kb, 5 repeats
    each; 12 distinct stream reads pipelined over 3 passes on the compact
    wire, sigdev and sigdev8; the identity pass on the 3 wires unless
    ``identity`` is False) in a temporary data directory, the reads made
    first. Requires its last line, the launches (bilstm_bf16 4 a chunk
    encoded, beam_cell = beam_attend = beam_step, peak_scan, no other
    kernel, no BiLSTM layer on the plain route) and each pipelined record's
    bases. Returns the launch counts, the line and the figures."""
    import contextlib
    import io
    import tempfile
    from pathlib import Path

    from ravvent_tpu_torch.data import chiron
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.ops import cuda_lib
    from ravvent_tpu_torch.tools import bench

    encoded = [0]  # chunks encoded: each BasecallEngine.memory call encodes one
    memory = BasecallEngine.memory

    def counting(self, *a, **k):
        encoded[0] += 1
        return memory(self, *a, **k)

    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        t0 = time.perf_counter()
        fi, fi_stream = bench.ensure_dataset(data)
        t_data = time.perf_counter() - t0
        stream = [v["signal_path"] for v in json.loads(fi_stream.read_text())]
        stream_bases = sum(chiron.load_label(Path(p).with_suffix(".label"))[0].shape[0]
                           for p in stream)
        argv = ["--seed", str(SEED), "--data-dir", str(data)] + ([] if identity else
                                                                 ["--no-identity"])
        out = io.StringIO()
        BasecallEngine.memory = counting
        try:
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                line = bench.main(argv)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            BasecallEngine.memory = memory
        counts = dict(cuda_lib.launches)
        details = json.loads((data / "details.json").read_text())
    printed = out.getvalue().strip().splitlines()
    require(bool(printed) and json.loads(printed[-1]) == line,
            "the bench tool's last line is not its JSON object")
    pipes = {w: details["pipeline" if w == "compact" else f"pipeline_{w}"]
             for w in ("compact", "sigdev", "sigdev8")}
    print(f"  bench tool, main({argv[:2] + argv[4:]} and the reads' --data-dir), seeded "
          f"weights: {secs:.2f} s (the reads made before it in {t_data:.2f} s) [{smi}]")
    print(f"  its line: {printed[-1]}")
    print(f"  evaluate_files: {details['bases_per_s']:.1f} bases/s over "
          f"{len(details['reads'])} reads; run_pipelined over {pipes['compact']['reads']} "
          f"stream reads, best of 3: "
          + ", ".join(f"{w} {r['bases_per_s']:.1f} bases/s (wall {r['wall_s']:.3f} s, stages "
                      f"{r['stages_s']})" for w, r in pipes.items()) + f" [{smi}]")
    if identity:
        print("  identity (total, valid, invalid %), seeded weights: "
              + ", ".join(f"{w} ({details['identity_total' + sfx]}, "
                          f"{details['identity_valid' + sfx]}, {details['invalid_pct' + sfx]})"
                          for w, sfx in (("compact", ""), ("sigdev", "_sigdev"),
                                         ("sigdev8", "_sigdev8"))))
    others = {k: counts[k] for k in ("bilstm", "beam_loop", "decode_step", "bilstm_plain_route",
                                     "beam_step_i8", "beam_step_i8mxu", "beam_attend_i8",
                                     "beam_attend_i8mxu")}
    print(f"  launches: bilstm_bf16 {counts['bilstm_bf16']} over {encoded[0]} chunks encoded "
          f"(need 4 each), beam_step {counts['beam_step']} (beam_cell {counts['beam_cell']}, "
          f"beam_attend {counts['beam_attend']}), peak_scan {counts['peak_scan']}; "
          f"{others} (need 0)")
    require(line["value"] > 0 and line["unit"] == "bases/s", "the bench tool measured nothing")
    require(line["device"] == smi, f"the bench tool's device {line['device']!r} is not the card's")
    require(counts["bilstm_bf16"] == 4 * encoded[0] and encoded[0] > 0,
            "bilstm_bf16 did not launch 4 a chunk encoded")
    require(counts["beam_step"] > 0 and counts["beam_cell"] == counts["beam_attend"]
            == counts["beam_step"], "a bf16 step did not launch beam_cell and beam_attend once each")
    require(counts["peak_scan"] > 0, "the signal-only wires launched no peak_scan")
    require(not any(others.values()), "the bench tool launched a kernel of another path, or took "
            "the BiLSTM's plain route")
    require(all(r["bases_num"] == stream_bases and r["reads"] == len(stream)
                for r in pipes.values()),
            f"a pipelined record counted other bases than the stream reads' {stream_bases}")
    return {"counts": counts, "line": line, "secs": secs, "encoded": encoded[0],
            "bases_per_s": details["bases_per_s"],
            "pipelined": {w: r["bases_per_s"] for w, r in pipes.items()}}


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
    k_step = phase_beam_step()
    phase("3 beam_step: beam_cell + beam_attend, at 64, 128 and 256 units and W = 1-16", t0)
    t0 = time.perf_counter()
    counts = phase_end_to_end()
    require(counts["beam_loop"] == 0 and counts["decode_step"] == 0,
            "the step path launched a kernel of another path")
    phase("4 end to end", t0)
    t0 = time.perf_counter()
    k_loop, loop_widths = phase_beam_loop()
    phase("5 beam_loop kernel, at 64, 128 and 256 units and W = 1-16", t0)
    t0 = time.perf_counter()
    k_dstep, dstep_widths = phase_decode_step()
    phase("6 decode_step kernel, at 64, 128 and 256 units and memory widths 64-512", t0)
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
    t0 = time.perf_counter()
    phase_training(smi)
    phase("17 training: Trainer at the flagship's width", t0)
    t0 = time.perf_counter()
    counts_cfg = phase_configs(smi)
    phase("18 the non-flagship configurations, beam_impl=xla; other encoder widths; the beam "
          "step at other decoder and beam widths", t0)
    t0 = time.perf_counter()
    phase_multidevice(smi)
    phase("19 multi-device: the sharded engine, data-parallel training, the 'model' "
          "axis, the dry run", t0)
    t0 = time.perf_counter()
    phase_tools(smi)
    phase("20 the user tools at the flagship's width", t0)
    t0 = time.perf_counter()
    tool = phase_bench_tool(smi)
    phase("21 the bench's entry point, tools/bench.py", t0)
    # no BiLSTM layer of the flagship's shape takes the plain route
    for name, c in (("4", counts), ("7", counts_loop), ("8", counts_greedy),
                    ("10", counts_bench), ("12 i8", counts_i8["i8"]),
                    ("12 i8mxu", counts_i8["i8mxu"]), ("13", counts_sig),
                    ("21", tool["counts"])):
        require(c["bilstm_plain_route"] == 0, f"phase {name} ran a BiLSTM layer of the "
                "flagship's shape on its plain route")
    # launches of each kernel on its own path's run; the BiLSTM kernels' at
    # 64 and 256 units on phase 18 (d) and (e)
    runs = {"bilstm": counts, "bilstm_u64": counts_cfg["enc64"],
            "bilstm_u256": counts_cfg["enc256_f32"], "bilstm_bf16": counts_bench,
            "bilstm_bf16_u64": counts_cfg["enc64_bf16"], "bilstm_bf16_u256": counts_cfg["enc256"]}
    for kd in k_bilstm + k_bf16:
        kd["launches"] = runs[kd["name"]][kd["name"].partition("_u")[0]]
        require(kd["launches"] > 0, f"{kd['name']} did not launch on its path's run")
    # the beam step's kernels: the flagship's on phase 4, the other widths' on
    # phase 18 (f)
    runs = {"": counts, "_u64": counts_cfg["dec64"], "_u256": counts_cfg["dec256"],
            "_w10": counts_cfg["beam10"]}
    for kd in k_step:
        kernel, width = re.fullmatch(r"(beam_cell|beam_attend)(\w*)", kd["name"]).groups()
        kd["launches"] = runs[width][kernel]
        require(kd["launches"] > 0, f"{kd['name']} did not launch on its path's run")
    k_loop["launches"] = counts_loop["beam_loop"]
    k_dstep["launches"] = counts_greedy["decode_step"]
    # the loop and decode-step kernels at other widths: the figures of phases
    # 5 and 6 at the shape of each path of phase 18 (f), its launches
    k_widths = []
    for name, key, count in (
            ("beam_loop_u64", (64, 5, torch.float32), counts_cfg["loop64"]),
            ("beam_loop_u256", (256, 5, torch.bfloat16), counts_cfg["loop256"]),
            ("beam_loop_w10", (128, 10, torch.bfloat16), counts_cfg["loop_beam10"])):
        f = loop_widths[key]
        src = f"ravvent_tpu_torch/csrc/beam_loop{'_streamed' if f['layout'] == 'streamed' else ''}.cu"
        k_widths.append(dict(k_loop, name=name, source=src, launches=count["beam_loop"],
                             max_abs_err=f["err"], ms=f["ms"], plain_ms=f["plain_ms"],
                             bound_ms=f["bound"], bound_by=f["by"]))
    for name, key, count in (("decode_step_e128", (128, 128), counts_cfg["greedy_e128"]),
                             ("decode_step_u256", (256, 256), counts_cfg["greedy_u256"])):
        f = dstep_widths[key]
        k_widths.append(dict(k_dstep, name=name, launches=count["decode_step"],
                             max_abs_err=f["err"], ms=f["ms"], plain_ms=f["plain_ms"],
                             bound_ms=f["bound"], bound_by=f["by"]))
    for kd in k_widths:
        require(kd["launches"] > 0, f"{kd['name']} did not launch on its path's run")
    k_i8["launches"] = counts_i8["i8"]["beam_attend_i8"]
    k_i8mxu["launches"] = counts_i8["i8mxu"]["beam_attend_i8mxu"]
    k_peak["launches"] = counts_sig["peak_scan"]
    keys = ["name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"]
    print(json.dumps({"kernels": [{k: kd[k] for k in keys} for kd in (
        *k_bilstm, *k_step, k_loop, k_dstep, *k_widths, *k_bf16, k_i8, k_i8mxu, k_peak)]}))
    print(f"total: {time.perf_counter() - t_all:.2f} s")
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
