"""The decode kernels' wide instances, run on the CPU by the emulation of
tools/cuda_emu.py against their plain versions.

The attend kernel's instance of 32 beams (W = 17-32; csrc/beam_attend.cuh:
c' read from the cell's scratch, the top-W over the candidates that can
win, in shared memory) in its four memory modes at 64, 128 and 256 units,
with ties across hypotheses; the streamed loop's instance of 32 beams
(csrc/beam_loop_streamed.cu: two candidate columns a lane; at 256 units the
scores and candidates in the gates' dead columns); the shared memory each
takes at the main path's S = 232, within a Hopper block's 227 KB; the
padded route (ops/decoder_pad.py) into the emulated beam step and greedy
step, against the plain versions at the true widths; and what the C entries
refuse past the new sets. The card-only tests in test_torch_gpu.py stay the
yardstick of the kernels themselves. Needs g++."""

import ctypes
import functools

import numpy as np
import pytest
import torch
from cuda_emu_cases import (  # noqa: F401 (emu, emu_loop: fixtures)
    check_attend, decoder_weights, emu, emu_attend, emu_cell, emu_loop, memory,
    mid_decode_state,
)
from test_torch_cuda_emu_decode_step import emu_decode_step, emu_step  # noqa: F401
from test_torch_cuda_emu_loop import emu_loop_plan
import test_torch_cuda_emu_loop as loop_tests

from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_loop_cuda as tloop
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.ops import cuda_lib, decoder_pad
from ravvent_tpu_torch.ops import decode_step_cuda as tgreedy

torch.set_num_threads(1)
V = 7

# (U, B, W, S) of the 32-beam attend instance: W = 17 and 32 at 128 units
# (B = 5 rows walk the emulated card's CTAs), 32 at 64 and 256 units
ATTEND_CASES = [(128, 5, 17, 40), (128, 3, 32, 24), (64, 3, 32, 70), (256, 3, 32, 24)]


@pytest.mark.parametrize("U,B,W,S", ATTEND_CASES,
                         ids=[f"U{c[0]}-W{c[2]}-S{c[3]}" for c in ATTEND_CASES])
@pytest.mark.parametrize("mode", ["bf16", "f32", "quant", "quant_mxu"])
def test_emulated_wide_attend_matches_plain(emu, mode, U, B, W, S):
    """The attend kernel's 32-beam instance against attend_plain
    (cuda_emu_cases.check_attend: picks, parents, finished flags and the
    permuted state equal, att and the scores within 1e-5)."""
    check_attend(emu, mode, U, B, W, S)


@pytest.mark.parametrize("mode", ["bf16", "quant_mxu"])
def test_emulated_wide_attend_breaks_ties_by_first_index(emu, mode):
    """Every hypothesis of a row alike (the same token, state and score):
    each candidate ties across the 32 hypotheses, and the first index wins,
    hypothesis by hypothesis, as decode/beam.py:top_w picks."""
    rng = np.random.default_rng(32)
    B, W, U = 3, 32, 128
    mem = memory(rng, B, 24, mode)
    w = decoder_weights(rng, U)._replace(watt_h=mem.watt_h)
    one = mid_decode_state(rng, B, 1, U)
    st = tstep.StepState(one.tok.repeat_interleave(W), *(t.repeat_interleave(W, dim=0)
                                                         for t in one[1:4]),
                         one.cum.repeat(1, W), torch.zeros(B, W, dtype=torch.bool))
    cell = tstep.cell_plain(st, w)
    rc, got, gpar = emu_attend(emu, st, cell, mem, w, mode)
    assert rc == 0
    scales = (mem.kscale, mem.vscale) if mem.quantized else None
    ref, rpar = tstep.attend_plain(st, *cell, mem.keys, mem.values, mem.mask, w, 1, scales,
                                   mode == "quant_mxu")
    assert torch.equal(gpar, rpar) and torch.equal(got.tok, ref.tok)
    assert torch.equal(gpar[:, :W], torch.arange(W, dtype=torch.int32).expand(B, W))


# the streamed loop's instance of 32 beams: (memory, B, S, W, T, eff, end
# token pushed down, U); at 256 units and W = 32 its scores and candidates
# lie in the gates' dead columns
LOOP_CASES = [("bf16", 2, 8, 17, 4, 3, True, 128), ("f32", 2, 8, 32, 4, 3, False, 64),
              ("bf16", 2, 8, 32, 3, 2, True, 256), ("f32", 2, 24, 32, 3, 2, True, 256),
              ("f32", 3, 40, 20, 5, 4, True, 128)]


@pytest.mark.parametrize("case", LOOP_CASES,
                         ids=[f"U{c[7]}-{c[0]}-B{c[1]}-S{c[2]}-W{c[3]}" for c in LOOP_CASES])
def test_emulated_wide_loop_matches_plain(emu_loop, case):
    """rv_beam_loop's streamed layout at 17-32 beams against beam_loop_plain
    and replay_plain, as test_torch_cuda_emu_loop.py holds the narrower
    widths."""
    loop_tests.test_emulated_beam_loop_matches_plain(emu_loop, case)


def test_wide_instances_fit_a_hopper_block_at_the_main_paths_s(emu, emu_loop):
    """At S = 232 every 32-beam instance's CTA fits in 227 KB: the attend
    kernel's in its four modes (c' read from global memory; 205 KB at 256
    units on f32) and the streamed loop's (at 256 units the scores and
    candidates in the gates' dead columns: 230,128 B, not 267 KB)."""
    info = (ctypes.c_int * 3)()
    for mode_no in range(4):
        for U in tstep.STEP_UNITS:
            for W in (17, 32):
                assert emu.rv_beam_attend_info(mode_no, U, W, 232, V, ctypes.addressof(info)) == 0
                assert info[0] <= tstep.SMEM_LIMIT, (mode_no, U, W, info[0])
    for mode in ("bf16", "f32"):
        for U in tloop.LOOP_UNITS:
            for W in (17, 32):
                rc, layout, _, _, smem = emu_loop_plan(emu_loop, mode, U, W, 232)
                assert rc == 0 and layout == "streamed" and smem <= tstep.SMEM_LIMIT, (U, W, smem)
    assert emu_loop_plan(emu_loop, "f32", 256, 32, 232)[4] == 230128


def test_emulated_wide_entries_refuse_past_the_new_sets(emu, emu_loop):
    """W = 33 has no instance in the attend kernel or the loop; the loop
    refuses more than 32 tokens past 16 beams (a real column is its lane's)
    and V + W past 32 up to 16 beams."""
    rng = np.random.default_rng(5)
    mem = memory(rng, 2, 8, "bf16")
    w = decoder_weights(rng)._replace(watt_h=mem.watt_h)
    st = mid_decode_state(rng, 2, 5)
    rc, _, _ = emu_attend(emu, st, tstep.cell_plain(st, w), mem, w, "bf16", W=33)
    assert rc == 1 and 33 not in tstep.STEP_BEAMS
    info = (ctypes.c_int * 4)()
    for W, Vc in ((33, V), (20, 33), (16, 17)):
        assert emu_loop.rv_beam_loop_clusters(1, 128, W, 8, Vc, 0, ctypes.addressof(info)) == 1
    assert emu_loop.rv_beam_loop_clusters(1, 128, 32, 8, 32, 0, ctypes.addressof(info)) == 0
    assert tloop.max_candidates(16) == 32 and tloop.max_candidates(17) == 64


def emu_beam_step(lib, st, keys, values, mask, w, end_token, scales=None, mxu=False):
    """One step of the emulated kernels, as ops/beam_step_cuda.py:beam_step
    launches them: the cell, then the attend."""
    mode = tstep.attend_mode(keys, scales, mxu)
    rc, cell = emu_cell(lib, st, w)
    assert rc == 0
    mem = tattn.AttnMemory(keys, values, mask, w.watt_h,
                                *(scales if scales is not None else (None, None)))
    rc, nxt, parent = emu_attend(lib, st, cell, mem, w, mode)
    assert rc == 0
    return nxt, parent


@pytest.mark.parametrize("U,W,mode", [(96, 5, "f32"), (200, 17, "bf16"), (96, 32, "quant")],
                         ids=["U96-W5-f32", "U200-W17-bf16", "U96-W32-quant"])
def test_emulated_padded_beam_decode_gives_the_true_widths_beams(emu, monkeypatch, U, W, mode):
    """fused_beam_decode on the card's route (``on_card`` patched) at a
    decoder width the kernels are not compiled for: the weights and memory
    padded to the next compiled width (counted as ``decoder_padded``), each
    step the emulated cell and attend kernels; against the plain decode at
    the true width, tokens equal, scores within 1e-5."""
    rng = np.random.default_rng(U + W)
    mem = memory(rng, 3, 16, mode, U=U)
    dec = {"cells": [{"kernel": torch.from_numpy((0.1 * rng.standard_normal((V + U, 4 * U)))
                                                 .astype(np.float32)),
                      "recurrent": torch.from_numpy((0.1 * rng.standard_normal((U, 4 * U)))
                                                    .astype(np.float32)),
                      "bias": torch.from_numpy((0.1 * rng.standard_normal(4 * U))
                                               .astype(np.float32))}],
           "fc": {"kernel": torch.from_numpy((0.3 * rng.standard_normal((U, V)))
                                             .astype(np.float32)),
                  "bias": torch.zeros(V)},
           "attention_layer": {"kernel": torch.zeros(U + 4, U)},
           "attention": {"memory_kernel": torch.zeros(4, U)}}
    ref = tstep.beam_step_decode(dec, mem, V, W, 4, 4)
    monkeypatch.setattr(decoder_pad, "on_card", lambda t: True)
    cuda_lib.reset_launches()
    loop = functools.partial(tstep.step_loop, functools.partial(emu_beam_step, emu))
    got = tstep.fused_beam_decode(dec, mem, V, W, 4, 4, loop=loop)
    assert cuda_lib.launches["decoder_padded"] == 1
    np.testing.assert_array_equal(got.tokens.numpy(), ref.tokens.numpy())
    np.testing.assert_allclose(got.scores.numpy(), ref.scores.numpy(), rtol=1e-5, atol=1e-5)
    cuda_lib.reset_launches()


@pytest.mark.parametrize("U,E", [(96, 192), (200, 384)], ids=["U96-E192", "U200-E384"])
def test_emulated_padded_greedy_gives_the_true_widths_tokens(emu_step, monkeypatch, U, E):
    """fused_greedy_decode on the card's route (``on_card`` patched) at a
    decoder and a memory width the greedy step is not compiled for: the
    weights and keys padded to the next compiled units, the values' columns
    and the attention layer's context rows to the next memory width, each
    step the emulated kernel (decode_step.cu at (128, 256) and (256,
    512)); against the plain decode at the true widths, tokens equal, logits
    within chip_smoke.py phase 6's 1e-4."""
    rng = np.random.default_rng(U + E)
    B, S = 9, 16

    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    dec = {"cells": [{"kernel": f(V + U, 4 * U, s=0.1), "recurrent": f(U, 4 * U, s=0.1),
                      "bias": f(4 * U, s=0.1)}],
           "fc": {"kernel": f(U, V, s=0.3), "bias": f(V, s=0.1)},
           "attention_layer": {"kernel": f(U + E, U, s=0.1)},
           "attention": {"memory_kernel": f(E, U, s=0.1)}}
    enc = torch.tanh(f(B, S, E))
    mask = torch.from_numpy(rng.random((B, S)) > 0.2)
    mask[1] = False
    mem = tattn.setup_memory(dec["attention"], enc, mask)
    rt, rl = tgreedy.fused_greedy_decode(dec, mem, V, 6, 6)
    monkeypatch.setattr(decoder_pad, "on_card", lambda t: True)

    def step(w, tok, att, h, c, keys, values, mask):
        assert keys.shape[2] in tgreedy.GREEDY_UNITS and values.shape[2] in \
            tgreedy.GREEDY_MEMORY_DIMS
        rc, out = emu_decode_step(emu_step, w, tok, att, h, c, keys, values, mask)
        assert rc == 0
        return out

    monkeypatch.setattr(tgreedy, "fused_decode_step", step)
    cuda_lib.reset_launches()
    gt, gl = tgreedy.fused_greedy_decode(dec, mem, V, 6, 6)
    assert cuda_lib.launches["decoder_padded"] == 1
    assert cuda_lib.launches["greedy_memory_padded"] == 1
    assert torch.equal(gt, rt)
    torch.testing.assert_close(gl, rl, rtol=1e-4, atol=1e-4)
    cuda_lib.reset_launches()
