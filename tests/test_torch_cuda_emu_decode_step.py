"""The greedy decode step's CUDA kernel (csrc/decode_step.cu), run on the CPU
by the emulation of tools/cuda_emu.py, against its plain version
(ops/decode_step_cuda.py:fused_decode_step_plain) at every decoder width U
of csrc/decode_step_shapes.cuh, at the smallest and the largest memory
width E and at the flagship's (128, 256).

The emulation runs the kernel's own code (the CTA's 8 rows, the cell's
columns, the scores' lanes, the context's position groups and their partial
sums, the attention layer's input-row groups) one CTA at a time, so these
tests hold the source's indexing on a machine without a card; the card-only
tests in test_torch_gpu.py stay the yardstick of the kernel itself. They
live in a file of their own so that a test run's workers take them beside
the other test_torch_cuda_emu_*.py files. Needs g++; the emulated library is built once
into ravvent_tpu_torch/build/emu/."""

import shutil

import numpy as np
import pytest
import torch

from ravvent_tpu_torch.ops import decode_step_cuda as tds

torch.set_num_threads(1)
V = 7


@pytest.fixture(scope="module")
def emu_step():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the emulation")
    from ravvent_tpu_torch.tools import cuda_emu

    return cuda_emu.load("decode_step.cu")


def step_inputs(rng, U: int, E: int, B: int, S: int):
    """Seeded weights and a mid-decode state: tokens in [0, V + 2) (ids >= V
    embed to zeros), spread att, h, c; keys and values of an encoder-like
    memory with a fifth of the positions masked and row 1 all padding."""
    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    w = tds.FusedDecodeWeights(f(V + U, 4 * U, s=0.1), f(U, 4 * U, s=0.1), f(4 * U, s=0.1),
                               f(U + E, U, s=0.1), f(U, V, s=0.3), f(V, s=0.1))
    tok = torch.from_numpy(rng.integers(0, V + 2, B).astype(np.int32))
    att, h, c = f(B, U), torch.tanh(f(B, U)), f(B, U)
    keys, values = torch.tanh(f(B, S, U)), torch.tanh(f(B, S, E))
    mask = torch.from_numpy(rng.random((B, S)) > 0.2)
    mask[1] = False
    return w, tok, att, h, c, keys, values, mask


def emu_decode_step(lib, w, tok, att, h, c, keys, values, mask, U=None, E=None):
    """rv_decode_step on host tensors, as ops/decode_step_cuda.py launches it
    (``U``, ``E``: what the entry is told, the inputs' by default), into
    NaN-filled outputs. Returns (return code, (h', c', att', logits))."""
    B, S, Uk = keys.shape
    out = tuple(torch.full((B, n), float("nan")) for n in (Uk, Uk, Uk, V))
    rc = lib.rv_decode_step(Uk if U is None else U, values.shape[2] if E is None else E, B, S,
                            V, tok.data_ptr(), att.data_ptr(), h.data_ptr(), c.data_ptr(),
                            keys.data_ptr(), values.data_ptr(), mask.data_ptr(), w.wx.data_ptr(),
                            w.wh.data_ptr(), w.b.data_ptr(), w.watt.data_ptr(), w.wfc.data_ptr(),
                            w.bfc.data_ptr(), *(o.data_ptr() for o in out), None)
    return rc, out


# (U, E, B, S): each decoder width at the smallest and the largest memory
# width (E = 64: four position groups of the context; E = 512: two columns a
# thread), and the flagship's shape; B not a multiple of the CTA's 8 rows
STEP_CASES = [(64, 64, 11, 8), (64, 512, 11, 12), (128, 64, 11, 16), (128, 512, 9, 8),
              (256, 64, 11, 8), (256, 512, 9, 12), (128, 256, 13, 16)]


@pytest.mark.parametrize("U,E,B,S", STEP_CASES, ids=[f"U{c[0]}-E{c[1]}-B{c[2]}-S{c[3]}"
                                                     for c in STEP_CASES])
def test_emulated_decode_step_matches_plain(emu_step, U, E, B, S):
    """h', c', the attention vector and the logits of the kernel against
    fused_decode_step_plain, within chip_smoke.py phase 6's 1e-4 (f32 sums
    in another order), the logits' argmax equal; every output written (they
    start as NaN), the all-padding row's too (its alignments uniform)."""
    rng = np.random.default_rng(10 * U + E + B)
    args = step_inputs(rng, U, E, B, S)
    rc, got = emu_decode_step(emu_step, *args)
    assert rc == 0
    ref = tds.fused_decode_step_plain(*args)
    for g, r in zip(got, ref):
        assert not g.isnan().any()
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[3].argmax(dim=1), ref[3].argmax(dim=1))


def test_emulated_decode_step_refuses_what_it_does_not_take(emu_step):
    """The C entry returns cudaErrorInvalidValue (1 in the emulation),
    writing nothing, for a unit count or memory width it has no instance of
    (U = 96, 32; E = 96, 384, 1024) and for no rows or positions."""
    rng = np.random.default_rng(0)
    args = step_inputs(rng, 128, 256, 3, 8)
    for U, E in ((96, 256), (32, 256), (128, 96), (128, 384), (128, 1024)):
        assert U not in tds.GREEDY_UNITS or E not in tds.GREEDY_MEMORY_DIMS
        rc, out = emu_decode_step(emu_step, *args, U=U, E=E)
        assert rc == 1 and all(o.isnan().all() for o in out), (U, E)
    w, tok, att, h, c, keys, values, mask = args
    z = torch.zeros(0)
    for B, S in ((0, 8), (3, 0)):
        assert emu_step.rv_decode_step(128, 256, B, S, V, *([z.data_ptr()] * 17), None) == 1
