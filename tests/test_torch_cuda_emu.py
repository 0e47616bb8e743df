"""The beam step's CUDA kernels (csrc/beam_step_f.cu's cell, the attend
kernel of csrc/beam_attend.cuh in its four memory modes), the BiLSTM-layer
kernels (csrc/bilstm.cu, f32; csrc/bilstm_bf16.cu, bf16), the whole-loop
beam kernel (csrc/beam_loop.cu, clusters of 2 CTAs on the emulated card)
and the peak scan of event detection (csrc/peak_scan.cu), run on the CPU by
the emulation of tools/cuda_emu.py, against their plain versions. The peak
scan's traces (synth, coupling_failure_trace, memory_trace) are shared with
tests/test_torch_event_detect.py and tests/test_torch_gpu.py.

The emulation runs the kernels' own code (indexing, shared-memory layout,
the persistent grid's row walk, the warp shuffles, the mma fragments) one
CTA at a time on
host threads, so these tests hold the CUDA source's logic on a machine
without a card. The card's arithmetic (its expf, its FMA contraction) is
not the host's, so the card-only tests in test_torch_gpu.py stay the
yardstick of the kernels themselves. Needs g++; the emulated library is
built once into ravvent_tpu_torch/build/emu/."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.models.rnn import init_encoder, stream_weights
from ravvent_tpu_torch.ops import beam_loop_cuda as tloop
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.ops import event_detect as ted
from ravvent_tpu_torch.ops import peak_scan_cuda, rnn_cuda

torch.set_num_threads(1)
U, V = 128, 7


@pytest.fixture(scope="module")
def emu():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load(*cuda_emu.STEP_SOURCES)


@pytest.fixture(scope="module")
def emu_bilstm():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load("bilstm_bf16.cu")


@pytest.fixture(scope="module")
def emu_bilstm_f32():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load("bilstm.cu")


@pytest.fixture(scope="module")
def emu_loop():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load(*cuda_emu.LOOP_SOURCES)


def decoder_weights(rng, U: int = U) -> tstep.DecoderWeights:
    def f(*shape, s=0.1):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    return tstep.DecoderWeights(f(V + U, 4 * U), f(U, 4 * U), f(4 * U), f(U, U), f(U, V, s=0.3),
                                f(V))


def mid_decode_state(rng, B: int, W: int, U: int = U) -> tstep.StepState:
    """Tokens in [0, V + 2) (ids >= V embed to zeros), spread h, c, att and
    scores, a fifth of the beams finished."""
    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return tstep.StepState(torch.from_numpy(rng.integers(0, V + 2, B * W).astype(np.int32)),
                           torch.tanh(f(B * W, U)), f(B * W, U), f(B * W, U),
                           torch.from_numpy((-5.0 * rng.random((B, W))).astype(np.float32)),
                           torch.from_numpy(rng.random((B, W)) < 0.2))


def memory(rng, B: int, S: int, mode: str, E: int = 32, U: int = U) -> tattn.AttnMemory:
    """setup_memory of a seeded encoder-like memory [B, S, E] in the mode's
    dtype, with pre-projected values; row 1 all padding."""
    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    mask = torch.from_numpy(rng.random((B, S)) > 0.2)
    mask[1] = False
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}.get(mode, "i8")
    return tattn.setup_memory({"memory_kernel": f(E, U, s=0.2)}, torch.tanh(f(B, S, E)), mask,
                              dtype, attention_layer={"kernel": f(U + E, U, s=0.1)})


def emu_attend(lib, st, cell, mem, w, mode: str, W=None, U=None) -> tuple:
    """The attend kernel's C entry on host tensors, as ops/beam_step_cuda.py
    launches it (``W``, ``U``: what the entry is told, the inputs' by
    default). Returns (return code, next state, parents)."""
    B, S, Um = mem.keys.shape
    Ws = st.cum.shape[1]
    h_new, c_new, att_h = cell
    nxt = tstep.StepState(torch.empty(B * Ws, dtype=torch.int32), torch.empty_like(h_new),
                          torch.empty_like(c_new), torch.empty_like(att_h),
                          torch.empty_like(st.cum), torch.empty_like(st.fin))
    parent = torch.empty(B, Ws, dtype=torch.int32)
    state_in = (h_new.data_ptr(), c_new.data_ptr(), att_h.data_ptr(), st.cum.data_ptr(),
                st.fin.data_ptr(), mem.keys.data_ptr(), mem.values.data_ptr())
    out = (w.wfc.data_ptr(), w.bfc.data_ptr(), nxt.tok.data_ptr(), parent.data_ptr(),
           nxt.h.data_ptr(), nxt.c.data_ptr(), nxt.att.data_ptr(), nxt.cum.data_ptr(),
           nxt.fin.data_ptr(), None)
    shape = (Um if U is None else U, Ws if W is None else W, B, S, V, tstep.VP, 1)
    if mode in ("bf16", "f32"):
        rc = lib.rv_beam_attend(int(mode == "bf16"), *shape, *state_in, mem.mask.data_ptr(),
                                *out)
    else:
        rc = lib.rv_beam_attend_i8(int(mode == "quant_mxu"), *shape, *state_in,
                                   mem.kscale.data_ptr(), mem.vscale.data_ptr(),
                                   mem.mask.data_ptr(), *out)
    return rc, nxt, parent


def emu_cell(lib, st, w, U=None) -> tuple:
    """The cell kernel's C entry on host tensors into NaN-filled scratch.
    Returns (return code, (h', c', att_h))."""
    got = tuple(torch.full_like(st.h, float("nan")) for _ in range(3))
    rc = lib.rv_beam_cell(st.h.shape[1] if U is None else U, st.h.shape[0], V, st.tok.data_ptr(),
                          st.att.data_ptr(), st.h.data_ptr(), st.c.data_ptr(), w.wx.data_ptr(),
                          w.wh.data_ptr(), w.b.data_ptr(), w.watt_h.data_ptr(),
                          *(g.data_ptr() for g in got), None)
    return rc, got


# (U, B, W) of the cell: the flagship's 128 units keep their ids; at 64
# units a CTA has 128 threads, at 256 it has 512 (Cell in beam_step_f.cu)
CELL_CASES = [(128, 9, 1), (128, 7, 5), (128, 4, 8), (64, 7, 5), (256, 9, 5)]
CELL_IDS = [("" if u == 128 else f"U{u}-") + f"{b}-{w}" for u, b, w in CELL_CASES]


@pytest.mark.parametrize("U,B,W", CELL_CASES, ids=CELL_IDS)
def test_emulated_beam_cell_matches_plain(emu, U, B, W):
    """h', c' and att_h of the cell kernel against cell_plain: f32 sums of
    2U and U terms in another order, within 1e-5; the last 32-hypothesis
    tile is ragged."""
    rng = np.random.default_rng(10 * B + W)
    w = decoder_weights(rng, U)
    st = mid_decode_state(rng, B, W, U)
    rc, got = emu_cell(emu, st, w)
    assert rc == 0
    for g, r in zip(got, tstep.cell_plain(st, w)):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5)


# (U, B, W, S) of the attend kernel: the flagship's 128 units at the exact
# and the bucket instances keep their ids (S = 70 and 300 end in a partial
# block, 300 in more blocks than 232); 64 and 256 units at W = 5 (at 64 an
# int8 row is 4 chunks, at 256 an f32 row 64, one position group); W = 6,
# 10 and 16 run the instances of 8 and 16 beams on a runtime W, over 2 and
# 4 hypothesis groups on int8, 1 and 2 on bf16/f32; B > 4 rows walk the
# emulated card's 4 CTAs, the last tile ragged
ATTEND_CASES = [(128, 5, 5, 8), (128, 6, 8, 70), (128, 9, 1, 232), (128, 5, 3, 300),
                (64, 6, 5, 70), (256, 5, 5, 40), (128, 6, 6, 40), (128, 5, 10, 70),
                (128, 6, 16, 24)]
ATTEND_IDS = ["S8", "S70", "S232", "S300", "U64-S70", "U256-S40", "W6-S40", "W10-S70",
              "W16-S24"]


@pytest.mark.parametrize("U,B,W,S", ATTEND_CASES, ids=ATTEND_IDS)
@pytest.mark.parametrize("mode", ["bf16", "f32", "quant", "quant_mxu"])
def test_emulated_beam_attend_matches_plain(emu, mode, U, B, W, S):
    """The attend kernel in each memory mode against attend_plain on the
    same cell outputs (row 1 all padding): the picks, parents and finished
    flags equal, the state rows copied exactly, att and the scores within
    1e-5 (f32 sums in another order; at these seeds no alignment crosses a
    bf16 or int8 rounding boundary). W > V = 7 re-picks a finfo.min column,
    as decode/beam.py:top_w does."""
    rng = np.random.default_rng(1000 * W + S + (U != 128) * U)
    mem = memory(rng, B, S, mode, U=U)
    w = decoder_weights(rng, U)._replace(watt_h=mem.watt_h)
    st = mid_decode_state(rng, B, W, U)
    cell = tstep.cell_plain(st, w)
    rc, got, gpar = emu_attend(emu, st, cell, mem, w, mode)
    assert rc == 0
    scales = (mem.kscale, mem.vscale) if mem.quantized else None
    ref, rpar = tstep.attend_plain(st, *cell, mem.keys, mem.values, mem.mask, w, 1, scales,
                                   mode == "quant_mxu")
    assert torch.equal(gpar, rpar) and torch.equal(got.tok, ref.tok)
    assert torch.equal(got.fin, ref.fin)
    assert torch.equal(got.h, ref.h) and torch.equal(got.c, ref.c)
    torch.testing.assert_close(got.att, ref.att, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.cum, ref.cum, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["bf16", "quant"])
def test_emulated_beam_step_refuses_shapes_not_compiled(emu, mode):
    """The C entries return cudaErrorInvalidValue (1 in the emulation),
    launching nothing, for what beam_step_shapes.cuh does not list: 96 units
    (the cell and the attend) and 17 or 0 beams; rv_beam_attend_info says
    a CTA of S = 4000 positions at 256 units and 16 beams does not fit."""
    rng = np.random.default_rng(3)
    mem = memory(rng, 3, 16, mode)
    w = decoder_weights(rng)._replace(watt_h=mem.watt_h)
    st = mid_decode_state(rng, 3, 5)
    cell = tstep.cell_plain(st, w)
    for u, beams in ((96, None), (None, 17), (None, 0)):
        rc, got, _ = emu_attend(emu, st, cell, mem, w, mode, W=beams, U=u)
        assert rc == 1, (u, beams)
    rc, got = emu_cell(emu, st, w, U=96)
    assert rc == 1 and all(g.isnan().all() for g in got)
    info = (ctypes.c_int * 3)()
    for mode_no, (u, beams, S, fits) in enumerate(((128, 5, 232, True), (256, 16, 232, True),
                                                    (256, 16, 4000, False), (64, 1, 8, True))):
        assert emu.rv_beam_attend_info(mode_no, u, beams, S, V, ctypes.addressof(info)) == 0
        assert (info[0] <= tstep.SMEM_LIMIT) == fits and (info[2] > 0) == fits, (u, beams, S)
    assert emu.rv_beam_attend_info(0, 96, 5, 8, V, ctypes.addressof(info)) == 1


# (U, F, T, B, seeded state): the emulated card has 2 SMs, so at 64 and 128
# units B picks 16, 32, 48 or 64 rows a CTA (13, 20, 37, then 70 in two
# tiles), none a multiple of it; at 256 units the f32 kernel takes 16 rows
# (B 13) or 32 (B 20, 37 in two tiles) and the bf16 kernel 16 (1, 2 and 3
# tiles); F = 1 and 5 run one partial x k-tile, F = 2U every k-tile
BILSTM_CASES = [(128, 1, 7, 13, False), (128, 1, 3, 70, True), (128, 5, 3, 37, True),
                (128, 5, 7, 20, False), (128, 256, 3, 37, True), (128, 256, 7, 20, False),
                (128, 256, 3, 70, False),
                (64, 1, 7, 13, False), (64, 5, 3, 37, True), (64, 128, 5, 20, True),
                (64, 128, 3, 70, False),
                (256, 1, 3, 13, True), (256, 5, 4, 20, False), (256, 512, 3, 37, True)]
# unit counts around the compiled ones (csrc/bilstm_units.cuh), which the
# C entries refuse
UNCOMPILED = (16, 32, 48, 96, 192, 512)
BILSTM_IDS = [("" if c[0] == 128 else f"U{c[0]}-")
              + f"F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}" for c in BILSTM_CASES]


def bilstm_case(U, F, T, B, seeded, dtype):
    """Seeded weights and inputs of one layer in the stream dtype, and
    NaN-filled outputs, so that an output no thread writes shows."""
    gen = torch.Generator().manual_seed(10 * F + T + U)
    wx, wh, b = stream_weights(init_encoder(gen, U, 1, F), dtype)[0]
    xs = torch.randn(B, T, F, generator=gen).to(dtype)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)) if seeded else torch.zeros(2, B, U)
              for _ in range(2))
    out = torch.full((B, T, 2 * U), float("nan"), dtype=dtype)
    hN, cN = torch.full((2, B, U), float("nan")), torch.full((2, B, U), float("nan"))
    return (xs, wx, wh, b, h0, c0), (out, hN, cN)


def emu_layer(entry, ins, outs) -> int:
    """A BiLSTM kernel's C entry on host tensors, as ops/rnn_cuda.py:launch
    calls it, on the weights in kernel_layout's order."""
    xs, wx, wh, b, h0, c0 = ins
    lay = rnn_cuda.kernel_layout(wx, wh)
    return entry(xs.data_ptr(), *xs.shape, lay.kx, wh.shape[1], lay.wx.data_ptr(),
                 lay.wh.data_ptr(), b.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                 *(t.data_ptr() for t in outs), None)


@pytest.mark.parametrize("U,F,T,B,seeded", BILSTM_CASES, ids=BILSTM_IDS)
def test_emulated_bilstm_bf16_matches_plain(emu_bilstm, U, F, T, B, seeded):
    """rv_bilstm_layer_bf16 on the weights in kernel_layout's fragment order
    against bilstm_layer_plain, at chip_smoke.py phase 9's bars: bf16 outputs
    within 1e-2 (two bf16 ulps at |h| <= 1), f32 final states within 1e-3.
    At 256 units Wh streams from L2 with Wx. Every output is written (the
    outputs start as NaN)."""
    ins, (out, hN, cN) = bilstm_case(U, F, T, B, seeded, torch.bfloat16)
    assert emu_layer(emu_bilstm.rv_bilstm_layer_bf16, ins, (out, hN, cN)) == 0
    ref = rnn_cuda.bilstm_layer_plain(*ins)
    assert (out.float() - ref[0].float()).abs().max().item() <= 1e-2
    assert (hN - ref[1]).abs().max().item() <= 1e-3
    assert (cN - ref[2]).abs().max().item() <= 1e-3


def test_emulated_bilstm_bf16_refuses_what_it_does_not_take(emu_bilstm):
    """The C entry returns cudaErrorInvalidValue (1 in the emulation) for a
    Kx that is not F rounded up to 16, for F > 16 not a multiple of 8, for F
    past 2U, and for a unit count it was not compiled for."""
    z = torch.zeros(1)
    args = (z.data_ptr(),) * 8
    entry = emu_bilstm.rv_bilstm_layer_bf16
    assert entry(z.data_ptr(), 4, 3, 5, 32, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 36, 48, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 300, 304, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 136, 144, 64, *args, None) == 1
    for U in UNCOMPILED:
        assert U not in rnn_cuda.KERNEL_UNITS
        assert entry(z.data_ptr(), 4, 3, 5, 16, U, *args, None) == 1


@pytest.mark.parametrize("U,F,T,B,seeded", BILSTM_CASES, ids=BILSTM_IDS)
def test_emulated_bilstm_f32_matches_plain(emu_bilstm_f32, U, F, T, B, seeded):
    """rv_bilstm_layer on the weights in kernel_layout's by-unit order
    against bilstm_layer_plain, within chip_smoke.py phase 2's 1e-4 (f32
    sums in another order). At 256 units the k-tiles are 8 rows. Every
    output is written (the outputs start as NaN)."""
    ins, outs = bilstm_case(U, F, T, B, seeded, torch.float32)
    assert emu_layer(emu_bilstm_f32.rv_bilstm_layer, ins, outs) == 0
    for got, ref in zip(outs, rnn_cuda.bilstm_layer_plain(*ins)):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)


def test_emulated_bilstm_f32_refuses_what_it_does_not_take(emu_bilstm_f32):
    """The C entry returns cudaErrorInvalidValue (1 in the emulation) for a
    Kx that is not F rounded up to 4, for F past 2U, for no rows, and for a
    unit count it was not compiled for."""
    z = torch.zeros(1)
    args = (z.data_ptr(),) * 8
    entry = emu_bilstm_f32.rv_bilstm_layer
    assert entry(z.data_ptr(), 4, 3, 5, 16, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 260, 260, 128, *args, None) == 1
    assert entry(z.data_ptr(), 0, 3, 5, 8, 128, *args, None) == 1
    assert entry(z.data_ptr(), 4, 3, 132, 132, 64, *args, None) == 1
    for U in UNCOMPILED:
        assert U not in rnn_cuda.KERNEL_UNITS
        assert entry(z.data_ptr(), 4, 3, 5, 8, U, *args, None) == 1


# (memory, B, S, W, T, eff, end token pushed down[, U, layout]): B is not a
# multiple of the emulated card's cluster of 2 but in the f32 case; W = 8 > V
# puts a repeated pick at finfo.min into step 1; eff < T leaves dead steps.
# The first six run the resident layout (128 units, clusters of 2); the
# others the streamed one (one CTA a row): at 64 and 256 units, at W = 10
# and 16 (the instance of at most 16 beams on a runtime W), at W = 7 on the
# instance of 8 at 64 units (8 beam groups of one beam), and at the
# flagship's shape with the layout asked for
WIDTH_CASES = [("bf16", 3, 8, 5, 5, 4, True, 64), ("f32", 3, 8, 5, 5, 4, True, 256),
               ("bf16", 3, 8, 10, 5, 4, True), ("f32", 2, 8, 16, 5, 3, False),
               ("bf16", 2, 8, 16, 4, 3, True, 256), ("f32", 3, 8, 7, 5, 4, False, 64),
               ("bf16", 3, 40, 5, 6, 4, True, 128, "streamed")]
LOOP_CASES = [("bf16", 3, 8, 5, 6, 4, True), ("f32", 4, 40, 5, 6, 4, True),
              ("bf16", 3, 40, 1, 6, 5, True), ("bf16", 5, 8, 8, 6, 3, True),
              ("f32", 3, 40, 8, 7, 4, False), ("bf16", 5, 40, 5, 5, 5, False)] + WIDTH_CASES
RESIDENT_BEAMS = (1, 2, 3, 4, 5, 8)  # the resident layout's instances (csrc/beam_loop.cu)
LOOP_IDS = [("" if len(c) < 8 or c[7] == U else f"U{c[7]}-") + (f"{c[8]}-" if len(c) > 8 else "")
            + f"{c[0]}-B{c[1]}-S{c[2]}-W{c[3]}-eff{c[5]}of{c[4]}" + ("-live" if c[6] else "")
            for c in LOOP_CASES]


def loop_inputs(rng, B: int, S: int, mode: str, live: bool, U: int = U):
    """A seeded memory (row 1 all padding) and decoder weights of U units;
    with ``live`` the end token's logit is pushed down, so that no beam
    ends."""
    mem = memory(rng, B, S, mode, U=U)
    w = decoder_weights(rng, U)._replace(watt_h=mem.watt_h)
    if live:
        bfc = w.bfc.clone()
        bfc[1] -= 20.0
        w = w._replace(bfc=bfc)
    return mem, w


def emu_loop_plan(lib, mode: str, U: int, W: int, S: int, layout: str = "auto"):
    """rv_beam_loop_clusters on the emulated card: (return code, the layout's
    name, cluster size, clusters at once, shared memory a CTA)."""
    info = (ctypes.c_int * 4)()
    rc = lib.rv_beam_loop_clusters(int(mode == "bf16"), U, W, S, V, tloop.LAYOUTS.index(layout),
                                   ctypes.addressof(info))
    return (rc, tloop.LAYOUTS[info[0]] if rc == 0 else None, *info[1:])


@pytest.mark.parametrize("case", LOOP_CASES, ids=LOOP_IDS)
def test_emulated_beam_loop_matches_plain(emu_loop, case):
    """rv_beam_loop against beam_loop_plain, in the layout the C entry
    picks (resident at 128 units and W in 1-5, 8: clusters of 2 sharing the
    weights' slices; streamed elsewhere) or the one asked for: the same
    tokens and parents at every live step, scores within 1e-5 relative (f32
    sums in another order, over cumulative log-probs); each live step
    replayed through the plain step (replay_plain) with every pick equal and
    distinct; the dead steps from eff on untouched (they start at a sentinel
    the kernel must not overwrite). The other widths' cases on bf16 memory
    hold the scores to chip_smoke.py's bf16 bar, 1e-2: h' rounds to bf16
    before the score dot, and the cell's f32 sums in another order move h'
    by a few f32 ulps, which flips that rounding where h' lies that close to
    a bf16 midpoint (at W = 16 some 4000 elements a step; one such element
    moves a beam's log-prob by ~4e-3 in the U = 128, W = 16 case's
    neighbour, seed 1, and the U = 256, W = 16 case here by 4.5e-4)."""
    mode, B, S, W, T, eff, live, Uc, layout = case + (U, "auto")[len(case) - 7:]
    rng = np.random.default_rng(100 * B + 10 * W + S + (Uc != U) * Uc)
    mem, w = loop_inputs(rng, B, S, mode, live, Uc)
    rc, chosen, _, _, _ = emu_loop_plan(emu_loop, mode, Uc, W, S, layout)
    assert rc == 0
    resident = Uc == U and W in RESIDENT_BEAMS and layout != "streamed"
    assert chosen == ("resident" if resident else "streamed")
    sentinel = -7
    out = [torch.full((T, B, W), sentinel, dtype=torch.int32),
           torch.full((T, B, W), sentinel, dtype=torch.int32),
           torch.full((T, B, W), float(sentinel))]
    rc = emu_loop.rv_beam_loop(int(mode == "bf16"), Uc, W, B, S, V, T, eff, 2, 1,
                               tloop.LAYOUTS.index(layout), mem.keys.data_ptr(),
                               mem.values.data_ptr(), mem.mask.data_ptr(), w.wx.data_ptr(),
                               w.wh.data_ptr(), w.b.data_ptr(), w.watt_h.data_ptr(),
                               w.wfc.data_ptr(), w.bfc.data_ptr(), *(o.data_ptr() for o in out),
                               None)
    assert rc == 0
    assert all((o[eff:] == sentinel).all() for o in out)
    tok, par, sc = (o.clone() for o in out)
    for o in (tok, par, sc):
        o[eff:] = 0
    rtok, rpar, rsc = tloop.beam_loop_plain(mem.keys, mem.values, mem.mask, w, W, T, eff, 2, 1)
    assert torch.equal(tok, rtok) and torch.equal(par, rpar)
    tol = 1e-2 if mode == "bf16" and case in WIDTH_CASES else 1e-5
    torch.testing.assert_close(sc, rsc, rtol=tol, atol=tol)
    rep = tloop.replay_plain(tok, par, sc, mem.keys, mem.values, mem.mask, w, eff, 2, 1)
    assert rep.exact == 1.0 and rep.distinct


def test_emulated_beam_loop_refuses_what_it_does_not_take(emu_loop):
    """The C entry returns cudaErrorInvalidValue (1 in the emulation),
    launching nothing, for a beam width or unit count it has no instance of
    (W = 0 and 17, U = 96), a layout that does not exist for the shape (the
    resident one at W = 6 or at 64 units, an unknown layout), V + W past 32,
    an S whose layout fits no shared memory (S = 2000 fits the emulated
    card's 1 MiB only streamed, S = 40000 not even so), eff past T, and
    weights that are not 16-byte aligned. rv_beam_loop_clusters refuses the
    same shapes and names the layout of the others."""
    rng = np.random.default_rng(0)
    mem, w = loop_inputs(rng, 2, 8, "bf16", False)
    out = [torch.zeros(4, 2, 8, dtype=torch.int32) for _ in range(2)] + [torch.zeros(4, 2, 8)]

    def call(W=5, S=8, V=V, T=4, eff=3, wx=w.wx.data_ptr(), U=U, layout=0):
        return emu_loop.rv_beam_loop(1, U, W, 2, S, V, T, eff, 2, 1, layout, mem.keys.data_ptr(),
                                     mem.values.data_ptr(), mem.mask.data_ptr(), wx,
                                     w.wh.data_ptr(), w.b.data_ptr(), w.watt_h.data_ptr(),
                                     w.wfc.data_ptr(), w.bfc.data_ptr(),
                                     *(o.data_ptr() for o in out), None)

    for W in (0, 17):
        assert W not in tloop.LOOP_BEAMS and call(W=W) == 1
    assert 96 not in tloop.LOOP_UNITS and call(U=96) == 1
    assert call(W=6, layout=1) == 1
    assert call(U=64, layout=1) == 1
    assert call(layout=3) == 1
    assert call(W=8, V=25) == 1
    assert call(S=2000, layout=1) == 1
    assert call(S=40000) == 1
    assert call(eff=5) == 1
    assert call(wx=w.wx.data_ptr() + 4) == 1
    assert all(not o.any() for o in out)  # nothing launched
    for U_, W, S, layout in ((96, 5, 8, "auto"), (128, 17, 8, "auto"), (128, 6, 8, "resident"),
                             (128, 5, 40000, "auto")):
        assert emu_loop_plan(emu_loop, "bf16", U_, W, S, layout)[0] == 1, (U_, W, S, layout)
    assert emu_loop_plan(emu_loop, "bf16", 128, 5, 232)[1:3] == ("resident", 2)
    assert emu_loop_plan(emu_loop, "bf16", 128, 5, 2000)[1:3] == ("streamed", 1)
    assert emu_loop_plan(emu_loop, "f32", 256, 16, 232)[1:3] == ("streamed", 1)


def test_replay_holds_the_plain_loop_at_w8():
    """At W = 8 > V the reference's iterated argmax picks a candidate at
    finfo.min again at step 1; replay_plain holds the plain loop's own
    result as exact, distinct and without error."""
    rng = np.random.default_rng(8)
    mem, w = loop_inputs(rng, 3, 16, "bf16", False)
    res = tloop.beam_loop_plain(mem.keys, mem.values, mem.mask, w, 8, 6, 5, 2, 1)
    assert (res[2][0, :, 7] == tloop.NEG_INF).all()  # the repeat at step 1
    rep = tloop.replay_plain(*res, mem.keys, mem.values, mem.mask, w, 5, 2, 1)
    assert rep == tloop.Replay(1.0, 0.0, 0.0, True)


def synth(rng, n_events=200, noise=8.0):
    """tests/test_device_event_detect.py's synthetic read: events of 4-19
    samples at levels in [400, 700) with Gaussian noise."""
    parts = []
    for _ in range(n_events):
        parts.append(rng.uniform(400, 700) + rng.normal(0, noise, rng.integers(4, 20)))
    return np.round(np.concatenate(parts)).astype(np.int64)


def coupling_failure_trace():
    """tests/test_device_event_detect.py's trace: an ancient dip the
    sequential state remembers past any warm-up (the blocked check fails,
    though no sample fires)."""
    t = np.full(4096, 1.0, np.float32)
    t[:50] = 5.0
    t[60] = 0.1
    return t


def memory_trace():
    """A trace whose blocked scan is wrong where the sequential one fires:
    a peak leaves the short detector's valid flag set, a slow rise keeps
    moving its peak for 1400 samples (no fire), and a drop of 0.1 fires it
    at sample 1503. A block that starts from the default state mid-rise never
    sets the flag, so only the fallback gives the fire."""
    t = np.full(2048, 1.0, np.float32)
    t[100], t[101] = 2.0, 1.7
    k = np.arange(102, 1500)
    t[102:1500] = (2.1 + 0.001 * (k - 102)).astype(np.float32)
    t[1500:] = t[1499] - np.float32(0.1)
    return t


def peak_scan_inputs(case):
    """(t1, t2 [B, S] f32, n_valid [B] int32) of a peak-scan case: two
    zero-padded synthetic reads of 300 and 150 events, or a trace as both
    statistics."""
    if case == "reads":
        rng = np.random.default_rng(0)
        r1, r2 = synth(rng, 300), synth(rng, 150)
        x = np.zeros((2, len(r1) + 700), np.float32)
        x[0, :len(r1)], x[1, :len(r2)] = r1, r2
        nv = torch.tensor([len(r1), len(r2)], dtype=torch.int32)
        xt = torch.from_numpy(x)
        return ted.compute_tstats_device(xt, 6, 9, nv), ted.compute_tstats_device(xt, 9, 9, nv), nv
    t = torch.from_numpy((coupling_failure_trace() if case == "coupling_failure"
                          else memory_trace())[None])
    return t, t.clone(), torch.tensor([t.shape[1]], dtype=torch.int32)


@pytest.fixture(scope="module")
def emu_peak():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load("peak_scan.cu")


def emu_peak_scan(lib, t1, t2, nv):
    """Both kernels of csrc/peak_scan.cu, as ops/peak_scan_cuda.py launches
    them; the fired mask starts all True, so an unwritten sample shows."""
    B, S = t1.shape
    C = -(-S // peak_scan_cuda.BLOCK)
    fired = torch.ones(B, S, dtype=torch.bool)
    states = torch.empty(B, C, 2, peak_scan_cuda.STATE_WORDS, dtype=torch.int32)
    ok = torch.empty(B, dtype=torch.uint8)
    args = (B, S, 6, 9, 1.4, 9.0, 0.2, t1.data_ptr(), t2.data_ptr(), nv.data_ptr(),
            fired.data_ptr())
    assert lib.rv_peak_scan_blocks(*args, states.data_ptr(), None) == 0
    assert lib.rv_peak_scan_check(*args, states.data_ptr(), ok.data_ptr(), None) == 0
    return fired, ok.bool()


@pytest.mark.parametrize("case", ["reads", "coupling_failure", "memory"])
def test_emulated_peak_scan_matches_plain(emu_peak, case):
    """The scan and the check against peak_scan_plain, bit for bit: two
    padded reads (the check passes; nothing fires from n_valid on), and the
    two traces whose check fails, where the rescan gives the sequential
    answer (on the memory trace the blocked fires are wrong)."""
    t1, t2, nv = peak_scan_inputs(case)
    fired, ok = emu_peak_scan(emu_peak, t1, t2, nv)
    assert emu_peak.rv_peak_scan_state_bytes() == 4 * peak_scan_cuda.STATE_WORDS
    assert torch.equal(fired, ted.peak_scan_plain(t1, t2, 6, 9, n_valid=nv))
    assert ok.tolist() == ([True, True] if case == "reads" else [False])
    if case == "reads":
        assert not fired[1, int(nv[1]):].any() and fired.sum() > 400
    if case == "memory":
        assert torch.nonzero(fired[0]).flatten().tolist() == [1503]


def test_emulated_peak_scan_refuses_what_it_does_not_take(emu_peak):
    t = torch.zeros(1, 8)
    nv = torch.tensor([8], dtype=torch.int32)
    for B, S in ((0, 8), (1, 0), (70000, 8)):
        assert emu_peak.rv_peak_scan_blocks(B, S, 6, 9, 1.4, 9.0, 0.2, t.data_ptr(), t.data_ptr(),
                                            nv.data_ptr(), t.data_ptr(), t.data_ptr(), None) != 0
