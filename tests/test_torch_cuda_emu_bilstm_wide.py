"""The BiLSTM-layer kernels past 256 units (csrc/bilstm_wide.cu, f32;
csrc/bilstm_bf16_wide.cu, bf16) at each of their compiled widths
(ops/rnn_cuda.py:WIDE_UNITS: 320, 384, 448, 512) and on a layer zero-padded
to one of them (300 units run at 320), run on the CPU by the emulation of
tools/cuda_emu.py against ``bilstm_layer_plain`` at the layer's own width;
and what their C entries refuse. The f32 source is two kernels: a
projection GEMM (x.Wx + b into an f32 scratch, a window of time steps at a
time; on inputs of more than 16 features) and a recurrence over a
thread-block cluster of C CTAs. Its C entry takes the cluster size C, the
rows R and the window Tw, which the wrapper takes from the card's plan;
here each f32 case gives its own. The emulation runs a cluster's CTAs
together whatever their count (its occupancy query alone stops at 2): the
f32 cases run clusters of 2, 4 and 8. The bf16 source takes the narrow
kernels' arguments. The card-only tests in test_torch_gpu.py stay the
yardstick of the kernels themselves. Needs g++."""

import ctypes

import pytest
import torch

from cuda_emu_cases import (  # noqa: F401 (fixtures)
    _load, bilstm_case, emu_bilstm, emu_bilstm_f32, emu_layer, nan_outputs,
)
from ravvent_tpu_torch.ops import rnn_cuda
from test_torch_cuda_emu_bilstm_widths import check, own_width, run_padded

STREAMS = {"f32": (torch.float32, "rv_bilstm_layer_wide", 4),
           "bf16": (torch.bfloat16, "rv_bilstm_layer_bf16_wide", 16)}
H100_BLOCK = 232448  # shared memory bytes a block can use on the H100


@pytest.fixture(scope="module")
def emu_wide():
    return _load("bilstm_wide.cu", "bilstm_bf16_wide.cu")


def entry_of(emu_wide, stream):
    dtype, name, _ = STREAMS[stream]
    return dtype, getattr(emu_wide, name)


def emu_wide_layer(entry, ins, outs, cfg, layout=None, parts=3, scratch=None) -> int:
    """The wide f32 C entry on host tensors, as ops/rnn_cuda.py:wide_launch
    calls it: the weights in kernel_layout's order (``layout``, made from
    ``ins``' weights when None), an f32 scratch of the window's steps
    (NaN-filled, made when None on an input of more than 16 features), and
    ``cfg`` = (C, R, Tw)."""
    xs, wx, wh, b, h0, c0 = ins
    lay = rnn_cuda.kernel_layout(wx, wh) if layout is None else layout
    B, T, F = xs.shape
    U = h0.shape[-1]
    if scratch is None and F > 16:
        scratch = torch.full((2, cfg[2], B, U, 4), float("nan"))
    return entry(xs.data_ptr(), B, T, F, lay.kx, U, lay.wx.data_ptr(), lay.wh.data_ptr(),
                 b.data_ptr(), h0.data_ptr(), c0.data_ptr(), *(t.data_ptr() for t in outs),
                 scratch.data_ptr() if scratch is not None else None, *cfg, parts, None)


def run_layer(stream, entry, ins, outs, cfg, layout=None) -> int:
    """One layer through a wide C entry: f32 on ``cfg``, bf16 as the narrow
    kernels take their arguments."""
    if stream == "f32":
        return emu_wide_layer(entry, ins, outs, cfg, layout)
    return emu_layer(entry, ins, outs, layout)


def run_padded_wide(stream, entry, ins, layout, cfg):
    """One layer padded to its compiled width through a wide C entry, as
    ops/rnn_cuda.py:bilstm_layer runs it (the layout's padded weights, the
    states padded with zeros, NaN-filled outputs). Returns (rc, out, hN, cN)
    at the compiled width."""
    if stream == "bf16":
        return run_padded(entry, ins, layout)
    xs, h0, c0 = ins[0], ins[4], ins[5]
    wx, wh, b = layout.padded
    Up = wh.shape[1]
    outs = nan_outputs(xs.shape[0], xs.shape[1], Up, xs.dtype)
    ins_p = (xs, wx, wh, b, rnn_cuda.pad_units(h0, Up), rnn_cuda.pad_units(c0, Up))
    return (emu_wide_layer(entry, ins_p, outs, cfg, layout),) + outs


# (U, F, T, B, seeded state) at each wide width, on raw (1), event (5) and a
# stacked layer's input (2U) features, then the f32 (C, R, Tw): ragged row
# tiles (B 13, 20, 37, 70 over R of 16 to 64), clusters of 2 to 8, and on
# the GEMM route windows of 1 step; the bf16 kernel takes 32 rows a CTA (13
# in one ragged tile, 37 in two, 70 in three)
WIDE_CASES = [
    (320, 1, 3, 13, True, (2, 16, 3)),
    (320, 5, 3, 37, False, (4, 32, 3)),
    (320, 640, 2, 20, True, (2, 16, 1)),
    (384, 1, 3, 37, False, (8, 64, 3)),
    (384, 5, 2, 70, True, (2, 16, 2)),
    (384, 768, 2, 13, False, (4, 32, 1)),
    (448, 1, 2, 20, True, (4, 32, 2)),
    (448, 5, 3, 13, False, (2, 16, 3)),
    (448, 896, 2, 37, True, (8, 64, 1)),
    (512, 1, 2, 70, False, (2, 16, 2)),
    (512, 5, 3, 20, True, (8, 64, 3)),
    (512, 1024, 2, 13, False, (4, 32, 1)),
]
WIDE_IDS = [f"U{c[0]}-F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}"
            for c in WIDE_CASES]
# (U, F, T, B, seeded, f32 cfg) of a layer the wrapper pads from 300 units
# to 320
PADDED_CASES = [(300, 1, 3, 37, False, (4, 32, 3)),
                (300, 5, 3, 20, True, (2, 16, 3)),
                (300, 600, 2, 13, True, (8, 64, 1))]
PADDED_IDS = [f"U{c[0]}-F{c[1]}-T{c[2]}-B{c[3]}-{'seeded' if c[4] else 'zero'}"
              for c in PADDED_CASES]


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=WIDE_IDS)
def test_emulated_wide_bilstm_matches_plain(emu_wide, stream, case):
    """The wide C entries on the weights in kernel_layout's order against
    bilstm_layer_plain: f32 within 1e-4 (chip_smoke.py phase 2's bar), bf16
    outputs within 1e-2 and final states within 1e-3 (phase 9's). Every
    output is written (the outputs start as NaN)."""
    U, F, T, B, seeded, cfg = case
    dtype, entry = entry_of(emu_wide, stream)
    ins, outs = bilstm_case(U, F, T, B, seeded, dtype)
    assert U in rnn_cuda.WIDE_UNITS
    assert run_layer(stream, entry, ins, outs, cfg) == 0
    check(stream, outs, rnn_cuda.bilstm_layer_plain(*ins))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("case", PADDED_CASES, ids=PADDED_IDS)
def test_emulated_wide_padded_layer_matches_plain_at_its_width(emu_wide, stream, case):
    """A 300-unit layer, laid out zero-padded to 320 units, run by the wide
    C entry: its padded units' outputs and final states are exactly zero,
    and its own units match bilstm_layer_plain at 300 units."""
    U, F, T, B, seeded, cfg = case
    dtype, entry = entry_of(emu_wide, stream)
    ins, _ = bilstm_case(U, F, T, B, seeded, dtype)
    layout = rnn_cuda.kernel_layout(*ins[1:4])
    assert layout.units == U and layout.padded[1].shape[1] == 320
    rc, *got = run_padded_wide(stream, entry, ins, layout, cfg)
    assert rc == 0
    check(stream, own_width(*got, U), rnn_cuda.bilstm_layer_plain(*ins))


@pytest.mark.parametrize("stream", ["f32", "bf16"])
@pytest.mark.parametrize("U", [264, 300])
def test_emulated_wide_padded_chain_matches_plain(emu_wide, stream, U):
    """Two stacked layers of 264 or 300 units as the encoder runs them on a
    card: layer 0 padded to 320 units, its [B, T, 640] outputs and padded
    final states fed to layer 1 (on f32 the projection GEMM's route), whose
    Wx rows sit at [0, U) and [320, 320 + U) (kernel_layout's ``in_units``:
    the gap 320 - U holds zero rows that meet the padded units' zero
    outputs), sliced to U once at the end; against the plain version of both
    layers at U units."""
    dtype, entry = entry_of(emu_wide, stream)
    T, B = 2, 20
    cfg = (4, 32, 1)
    ins0, _ = bilstm_case(U, 5, T, B, True, dtype)
    ins1, _ = bilstm_case(U, 2 * U, T, B, False, dtype)
    rc, out0, h0, c0 = run_padded_wide(stream, entry, ins0, rnn_cuda.kernel_layout(*ins0[1:4]),
                                       cfg)
    assert rc == 0
    layout1 = rnn_cuda.kernel_layout(*ins1[1:4], in_units=U)
    wx1 = layout1.padded[0]
    assert wx1.shape[1] == 640
    assert not wx1[:, U:320].any() and not wx1[:, 320 + U:].any()
    outs = nan_outputs(B, T, 320, dtype)
    assert run_layer(stream, entry, (out0, *layout1.padded, h0, c0), outs, cfg, layout1) == 0
    ref0 = rnn_cuda.bilstm_layer_plain(*ins0)
    ref1 = rnn_cuda.bilstm_layer_plain(ref0[0], *ins1[1:4], ref0[1], ref0[2])
    check(stream, own_width(*outs, U), ref1)


# (U, T, B, C, R, Tw) of an f32 layer on a stacked layer's input (F = 2U): T
# not a multiple of the window, so the last window is shorter, and the
# state carried from window to window through hN and cN
WINDOW_CASES = [(320, 5, 13, 4, 32, 2), (320, 3, 13, 8, 48, 2), (384, 4, 13, 2, 16, 3),
                (448, 3, 13, 8, 64, 2), (448, 3, 20, 4, 16, 2), (512, 3, 13, 8, 64, 2)]


@pytest.mark.parametrize("U,T,B,C,R,Tw", WINDOW_CASES,
                         ids=[f"U{c[0]}-T{c[1]}-B{c[2]}-Tw{c[5]}" for c in WINDOW_CASES])
def test_emulated_wide_windows_match_plain(emu_wide, U, T, B, C, R, Tw):
    """The f32 projection and recurrence a window of Tw steps at a time, T
    not a multiple of Tw, against bilstm_layer_plain at phase 2's bar; the
    window's projection alone (parts 1) and then its recurrence alone
    (parts 2) give the layer's bits when T fits one window."""
    _, entry = entry_of(emu_wide, "f32")
    ins, outs = bilstm_case(U, 2 * U, T, B, True, torch.float32)
    assert T % Tw != 0
    assert emu_wide_layer(entry, ins, outs, (C, R, Tw)) == 0
    check("f32", outs, rnn_cuda.bilstm_layer_plain(*ins))
    one = (C, R, T)
    whole = nan_outputs(B, T, U, torch.float32)
    assert emu_wide_layer(entry, ins, whole, one) == 0
    split = nan_outputs(B, T, U, torch.float32)
    scratch = torch.full((2, T, B, U, 4), float("nan"))
    assert emu_wide_layer(entry, ins, split, one, parts=1, scratch=scratch) == 0
    assert not scratch.isnan().any()
    assert split[0].isnan().all()  # the projection alone writes no output
    assert emu_wide_layer(entry, ins, split, one, parts=2, scratch=scratch) == 0
    for g, r in zip(split, whole):
        assert torch.equal(g, r)


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_emulated_wide_entries_refuse_what_they_do_not_take(request, emu_wide, stream):
    """The wide C entry returns cudaErrorInvalidValue (1 in the emulation)
    for a unit count outside WIDE_UNITS (the narrow kernels' 256, a padded
    300, 336, past the widest 520), for a Kx that is not F rounded up to the
    stream's k-step, for F past 2U, for no rows and (bf16) for F > 16 not a
    multiple of 8; on f32 also for a cluster size that is not a divisor of U
    up to 16, rows that are not a multiple of 8 up to 128 or give a CTA more
    than 512 threads, no window, parts outside 1-3, and no scratch on an
    input of more than 16 features. The narrow C entries refuse every wide
    width."""
    _, entry = entry_of(emu_wide, stream)
    step = STREAMS[stream][2]
    z = torch.zeros(1)
    args = (z.data_ptr(),) * 8
    kx = lambda F: -(-F // step) * step  # noqa: E731
    ok = (4, 32, 2)

    def call(U=384, F=5, B=4, Kx=None, cfg=ok, parts=3, scratch=z.data_ptr()):
        head = (z.data_ptr(), B, 3, F, kx(F) if Kx is None else Kx, U, *args)
        if stream == "bf16":
            return entry(*head, None)
        return entry(*head, scratch, *cfg, parts, None)

    for U in (256, 300, 336, 520):
        assert U not in rnn_cuda.WIDE_UNITS
        assert call(U=U) == 1
    assert call(Kx=kx(5) + step) == 1
    assert call(F=776) == 1
    assert call(B=0) == 1
    if stream == "bf16":
        assert call(F=20) == 1
    else:
        C, R, Tw = ok
        for cfg in [(5, R, Tw), (32, R, Tw), (0, R, Tw), (C, 12, Tw), (C, 136, Tw),
                    (1, 64, Tw), (C, R, 0)]:
            assert call(cfg=cfg) == 1, cfg
        assert call(parts=0) == 1 and call(parts=4) == 1
        assert call(F=768, scratch=None) == 1
    narrow = (request.getfixturevalue("emu_bilstm_f32").rv_bilstm_layer if stream == "f32"
              else request.getfixturevalue("emu_bilstm").rv_bilstm_layer_bf16)
    for U in rnn_cuda.WIDE_UNITS:
        assert narrow(z.data_ptr(), 4, 3, 5, kx(5), U, *args, None) == 1


# the f32 plan's rows at each wide width (clusters of 8, a CTA of at least 6
# warps; the emulated card holds no cluster of 8, so the rule's doubling
# where an H100 holds one CTA an SM does not arise here)
F32_RULE_ROWS = {320: 48, 384: 32, 448: 32, 512: 32}


@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_emulated_wide_cta_fits_a_block(emu_wide, stream):
    """rv_bilstm_layer_*_wide_cta at each wide width, on F = 1, 5 and 2U.
    f32: the plan's rule (C = 0) takes clusters of 8 and the rows of
    F32_RULE_ROWS, a recurrence CTA of U R / 64 threads (at least 192, at
    most 512) whose shared memory fits the 227 KB a block can use on the
    H100, and a window that keeps the scratch within 1 GiB at 4096 rows; a
    given (C, R) is described as given, and refused where the kernels do not
    take it. bf16: a CTA of U threads and 32 rows within the same 227 KB.
    Both refuse past the set."""
    name = "rv_bilstm_layer_wide_cta" if stream == "f32" else "rv_bilstm_layer_bf16_wide_cta"
    entry = getattr(emu_wide, name)
    step = STREAMS[stream][2]
    for U in rnn_cuda.WIDE_UNITS:
        for F in (1, 5, 2 * U):
            Kx = -(-F // step) * step
            if stream == "bf16":
                info = (ctypes.c_int * 5)()
                assert entry(U, Kx, info) == 0
                threads, smem, rows = info[0], info[1], info[2]
                assert threads == U and rows == 32
                assert 0 < smem <= H100_BLOCK - 16
                continue
            info = (ctypes.c_int * 9)()
            assert entry(U, Kx, 4096, 200, 0, 0, info) == 0
            plan = rnn_cuda.WidePlan(*info)
            assert (plan.cluster, plan.rows) == (8, F32_RULE_ROWS[U])
            assert 192 <= plan.threads == U * plan.rows // 64 <= 512
            assert 0 < plan.smem_bytes <= H100_BLOCK
            assert plan.window == (2 ** 30 // (32 * 4096 * U) if F > 16 else 200)
            # given: 4 CTAs of U / 4 units, 16 rows; the ring's 3 k-tiles of
            # 16 rows, A = [x_t | h] and the mbarrier in shared memory
            assert entry(U, Kx, 4096, 200, 4, 16, info) == 0
            kin = Kx if F <= 16 else 0
            given = rnn_cuda.WidePlan(*info)
            assert (given.cluster, given.rows, given.threads) == (4, 16, U // 2)
            assert given.smem_bytes == 3 * 16 * (U // 4) * 16 + (kin + U) * 16 * 4 + 16
    if stream == "bf16":
        info = (ctypes.c_int * 5)()
        assert entry(520, 16, info) == 1 and entry(300, 16, info) == 1
    else:
        assert entry(520, 16, 64, 30, 0, 0, info) == 1 and entry(300, 16, 64, 30, 0, 0, info) == 1
        assert entry(384, 16, 64, 30, 5, 32, info) == 1
