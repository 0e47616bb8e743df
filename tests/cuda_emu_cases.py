"""What the emulated kernel tests share (tests/test_torch_cuda_emu_*.py):
the module fixtures that build each kernel source's emulated library
(ravvent_tpu_torch/tools/cuda_emu.py, g++ into ravvent_tpu_torch/build/emu/,
once a source set), the beam step's seeded decoder weights, decode states
and attention memories, the step kernels' and the BiLSTM kernels' C entries
on host tensors and the BiLSTM layers' seeded cases, the
attend kernel's cases and check (both attend files run them), and the peak
scan's traces and inputs (synth, coupling_failure_trace, memory_trace,
peak_scan_inputs), which tests/test_torch_event_detect.py,
tests/test_torch_sigdev.py and tests/test_torch_gpu.py import too.

The emulated tests live in one file a kernel (and the attend kernel's in
two, by memory mode), so that a run's workers under ``--dist loadfile`` take
them side by side. Not a test module: pytest collects nothing here. It
imports no JAX, so the card's machine imports it too."""

import shutil

import numpy as np
import pytest
import torch

from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.models.rnn import init_encoder, stream_weights
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.ops import event_detect as ted
from ravvent_tpu_torch.ops import rnn_cuda

torch.set_num_threads(1)
U, V = 128, 7


def _load(*sources):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load(*sources)


@pytest.fixture(scope="module")
def emu():
    from ravvent_tpu_torch.tools import cuda_emu

    return _load(*cuda_emu.STEP_SOURCES)


@pytest.fixture(scope="module")
def emu_bilstm():
    return _load("bilstm_bf16.cu")


@pytest.fixture(scope="module")
def emu_bilstm_f32():
    return _load("bilstm.cu")


@pytest.fixture(scope="module")
def emu_loop():
    from ravvent_tpu_torch.tools import cuda_emu

    return _load(*cuda_emu.LOOP_SOURCES)


@pytest.fixture(scope="module")
def emu_peak():
    return _load("peak_scan.cu")


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


def check_attend(lib, mode: str, U: int, B: int, W: int, S: int) -> None:
    """The attend kernel in memory mode ``mode`` against attend_plain on the
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
    rc, got, gpar = emu_attend(lib, st, cell, mem, w, mode)
    assert rc == 0
    scales = (mem.kscale, mem.vscale) if mem.quantized else None
    ref, rpar = tstep.attend_plain(st, *cell, mem.keys, mem.values, mem.mask, w, 1, scales,
                                   mode == "quant_mxu")
    assert torch.equal(gpar, rpar) and torch.equal(got.tok, ref.tok)
    assert torch.equal(got.fin, ref.fin)
    assert torch.equal(got.h, ref.h) and torch.equal(got.c, ref.c)
    torch.testing.assert_close(got.att, ref.att, rtol=0, atol=1e-5)
    torch.testing.assert_close(got.cum, ref.cum, rtol=0, atol=1e-5)

def emu_cell(lib, st, w, U=None) -> tuple:
    """The cell kernel's C entry on host tensors into NaN-filled scratch.
    Returns (return code, (h', c', att_h))."""
    got = tuple(torch.full_like(st.h, float("nan")) for _ in range(3))
    rc = lib.rv_beam_cell(st.h.shape[1] if U is None else U, st.h.shape[0], V, st.tok.data_ptr(),
                          st.att.data_ptr(), st.h.data_ptr(), st.c.data_ptr(), w.wx.data_ptr(),
                          w.wh.data_ptr(), w.b.data_ptr(), w.watt_h.data_ptr(),
                          *(g.data_ptr() for g in got), None)
    return rc, got


def bilstm_case(U, F, T, B, seeded, dtype):
    """Seeded weights and inputs of one BiLSTM layer in the stream dtype, and
    NaN-filled outputs, so that an output no thread writes shows."""
    gen = torch.Generator().manual_seed(10 * F + T + U)
    wx, wh, b = stream_weights(init_encoder(gen, U, 1, F), dtype)[0]
    xs = torch.randn(B, T, F, generator=gen).to(dtype)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)) if seeded else torch.zeros(2, B, U)
              for _ in range(2))
    return (xs, wx, wh, b, h0, c0), nan_outputs(B, T, U, dtype)


def nan_outputs(B, T, U, dtype):
    """A BiLSTM layer's outputs (out, hN, cN) at U units, NaN-filled."""
    return (torch.full((B, T, 2 * U), float("nan"), dtype=dtype),
            torch.full((2, B, U), float("nan")), torch.full((2, B, U), float("nan")))


def emu_layer(entry, ins, outs, layout=None) -> int:
    """A BiLSTM kernel's C entry on host tensors, as ops/rnn_cuda.py:launch
    calls it, on the weights in kernel_layout's order (``layout``, made from
    ``ins``' weights when None)."""
    xs, wx, wh, b, h0, c0 = ins
    lay = rnn_cuda.kernel_layout(wx, wh) if layout is None else layout
    return entry(xs.data_ptr(), *xs.shape, lay.kx, wh.shape[1], lay.wx.data_ptr(),
                 lay.wh.data_ptr(), b.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                 *(t.data_ptr() for t in outs), None)


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
