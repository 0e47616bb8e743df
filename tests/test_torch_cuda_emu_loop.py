"""The whole-loop beam kernel (csrc/beam_loop.cu, the resident layout on
clusters of 2 CTAs on the emulated card, linked with
csrc/beam_loop_streamed.cu, one CTA a row) run on the CPU by the emulation
of tools/cuda_emu.py against ``beam_loop_plain`` and ``replay_plain``
(ops/beam_loop_cuda.py), what its C entry refuses, and the replay of the
plain loop at W = 8. The emulation runs the kernel's own code (the
cluster barrier, distributed shared memory, mbarriers and the multicast
bulk copy) one cluster at a time, each CUDA thread a fiber; the card-only
tests in test_torch_gpu.py stay the yardstick of the kernel itself. Needs
g++."""

import ctypes

import numpy as np
import pytest
import torch

from cuda_emu_cases import U, V, decoder_weights, emu_loop, memory  # noqa: F401 (emu_loop)
from ravvent_tpu_torch.ops import beam_loop_cuda as tloop

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
    (W = 0 and 33, U = 96), a layout that does not exist for the shape (the
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

    for W in (0, 33):
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
    for U_, W, S, layout in ((96, 5, 8, "auto"), (128, 33, 8, "auto"), (128, 6, 8, "resident"),
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
