"""The beam step's plain version split into the plain versions of its two
kernels, on the CPU.

``cell_plain`` (the LSTM cell and h'.watt_h, the cell kernel's function)
then ``attend_plain`` (the rest of the step, the attend kernel's function)
must return what the step's plain version returned before the split, bit
for bit; a copy of that version is kept here as the yardstick. On int8
memory the same split (``attend_plain`` with the scales, quant or
quant_mxu) and the CPU wrappers must equal ``beam_step_plain`` bit for bit.
The cell is also held against the JAX package's ``lstm_step`` on the same
numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.models.rnn import lstm_step as j_lstm_step
from ravvent_tpu_torch.decode.beam import NEG_INF, top_w
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_step_cuda as tstep

torch.set_num_threads(1)
U, V = 128, 7


def step_before_split(st, keys, values, mask, w, end_token):
    """The step's plain version as it stood before the split (bf16/f32
    memory): the cell, attention, logits, the candidate row, top-W and the
    permutation in one function."""
    B, S, _ = keys.shape
    W = st.cum.shape[1]
    h_new, c_new = tstep.lstm_cell_plain(st.tok, st.att, st.h, st.c, w.wx, w.wh, w.b)
    mem = tattn.AttnMemory(keys=keys, values=values, mask=mask)
    context, _ = tattn.attend_beams(None, "luong", h_new.reshape(B, W, U), mem)
    att_new = h_new @ w.watt_h + context.reshape(B * W, U)
    logits = att_new @ w.wfc + w.bfc
    lmax = logits.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(logits - lmax).sum(dim=1, keepdim=True)) + lmax
    step_lp = (logits - lse).reshape(B, W, V)
    fin_row = torch.full((V,), NEG_INF)
    fin_row[end_token] = 0.0
    step_lp = torch.where(st.fin[..., None], fin_row, step_lp)
    total = torch.full((B, W, tstep.VP), NEG_INF) + st.cum[..., None]
    total[..., :V] = st.cum[..., None] + step_lp
    new_cum, idx = top_w(total.reshape(B, W * tstep.VP), W)
    return tstep.advance(st, h_new, c_new, att_new, new_cum, idx, end_token)


def decoder_weights(rng) -> tstep.DecoderWeights:
    def f(*shape, s=0.1):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    return tstep.DecoderWeights(f(V + U, 4 * U), f(U, 4 * U), f(4 * U), f(U, U), f(U, V, s=0.3),
                                f(V))


def memory(rng, B: int, S: int, dtype):
    """Keys, pre-projected values and a mask of B rows; row 1 all padding."""
    keys = torch.from_numpy(np.tanh(rng.standard_normal((B, S, U))).astype(np.float32)).to(dtype)
    values = torch.from_numpy((0.5 * rng.standard_normal((B, S, U))).astype(np.float32)).to(dtype)
    mask = torch.from_numpy(rng.random((B, S)) > 0.2)
    mask[1] = False
    return keys, values, mask


def mid_decode_state(rng, B: int, W: int) -> tstep.StepState:
    """Tokens in [0, V + 2) (ids >= V embed to zeros), spread h, c, att and
    scores, a fifth of the beams finished."""
    f = lambda *shape: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))  # noqa: E731
    return tstep.StepState(torch.from_numpy(rng.integers(0, V + 2, B * W).astype(np.int32)),
                           torch.tanh(f(B * W, U)), f(B * W, U), f(B * W, U),
                           torch.from_numpy((-5.0 * rng.random((B, W))).astype(np.float32)),
                           torch.from_numpy(rng.random((B, W)) < 0.2))


@pytest.mark.parametrize("S", [8, 56, 232])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("W", [1, 5, 8])
def test_cell_then_attend_equal_the_step_before_the_split(W, dtype, S):
    """Three chained steps from a mid-decode state, each fed the yardstick's
    state: cell_plain then attend_plain, beam_step_plain and the CPU path of
    beam_step equal the pre-split step bit for bit."""
    rng = np.random.default_rng(100 * W + S)
    B = 6
    w = decoder_weights(rng)
    keys, values, mask = memory(rng, B, S, dtype)
    st = mid_decode_state(rng, B, W)
    for _ in range(3):
        ref = step_before_split(st, keys, values, mask, w, 1)
        split = tstep.attend_plain(st, *tstep.cell_plain(st, w), keys, values, mask, w, 1)
        for got in (split, tstep.beam_step_plain(st, keys, values, mask, w, 1),
                    tstep.beam_step(st, keys, values, mask, w, 1)):
            nxt, parent = got
            assert torch.equal(parent, ref[1])
            for g, r in zip(nxt, ref[0]):
                assert g.dtype == r.dtype and torch.equal(g, r)
        st = ref[0]


def int8_memory(rng, B: int, S: int, E: int = 32):
    """setup_memory(..., "i8") of a seeded encoder-like memory [B, S, E]
    with pre-projected values; row 1 all padding."""
    def f(*shape, s=1.0):
        return torch.from_numpy((s * rng.standard_normal(shape)).astype(np.float32))

    mask = torch.from_numpy(rng.random((B, S)) > 0.2)
    mask[1] = False
    return tattn.setup_memory({"memory_kernel": f(E, U, s=0.2)}, torch.tanh(f(B, S, E)), mask, "i8",
                              attention_layer={"kernel": f(U + E, U, s=0.1)})


@pytest.mark.parametrize("S", [8, 232])
@pytest.mark.parametrize("mxu", [False, True], ids=["quant", "quant_mxu"])
@pytest.mark.parametrize("W", [1, 5, 8])
def test_int8_cell_then_attend_equal_the_plain_step(W, mxu, S):
    """Three chained steps on int8 memory from a mid-decode state:
    cell_plain then attend_plain with the scales, and the CPU paths of
    beam_cell + beam_attend and of beam_step, equal beam_step_plain bit for
    bit, and launch nothing."""
    from ravvent_tpu_torch.ops import cuda_lib

    rng = np.random.default_rng(1000 * W + 10 * S + mxu)
    B = 6
    mem = int8_memory(rng, B, S)
    assert mem.keys.dtype == torch.int8 and mem.values.dtype == torch.int8
    w = decoder_weights(rng)._replace(watt_h=mem.watt_h)
    keys, values, mask = mem.keys, mem.values, mem.mask
    scales = (mem.kscale, mem.vscale)
    st = mid_decode_state(rng, B, W)
    before = dict(cuda_lib.launches)
    for _ in range(3):
        ref = tstep.beam_step_plain(st, keys, values, mask, w, 1, scales, mxu)
        split = tstep.attend_plain(st, *tstep.cell_plain(st, w), keys, values, mask, w, 1,
                                   scales, mxu)
        wrappers = tstep.beam_attend(st, *tstep.beam_cell(st, w), keys, values, mask, w, 1,
                                     scales, mxu)
        for got in (split, wrappers, tstep.beam_step(st, keys, values, mask, w, 1, scales, mxu)):
            nxt, parent = got
            assert torch.equal(parent, ref[1])
            for g, r in zip(nxt, ref[0]):
                assert g.dtype == r.dtype and torch.equal(g, r)
        st = ref[0]
    assert cuda_lib.launches == before


@pytest.mark.parametrize("B,W", [(3, 1), (4, 5), (2, 8)])
def test_cell_plain_matches_jax_lstm_step(B, W):
    """cell_plain's h', c' against the JAX package's lstm_step on [one-hot
    token | att] with the flagship's U = 128, and att_h against h'.watt_h in
    numpy: f32 sums in another order, within 1e-6."""
    rng = np.random.default_rng(B * 10 + W)
    w = decoder_weights(rng)
    st = mid_decode_state(rng, B, W)
    h_new, c_new, att_h = tstep.cell_plain(st, w)

    tok = st.tok.numpy()
    onehot = (tok[:, None] == np.arange(V)[None, :]).astype(np.float32)  # ids >= V: zeros
    x = np.concatenate([onehot, st.att.numpy()], axis=1)
    p = {"kernel": jnp.asarray(w.wx.numpy()), "recurrent": jnp.asarray(w.wh.numpy()),
         "bias": jnp.asarray(w.b.numpy())}
    (jh, jc), _ = j_lstm_step(p, (jnp.asarray(st.h.numpy()), jnp.asarray(st.c.numpy())),
                              jnp.asarray(x))
    np.testing.assert_allclose(h_new.numpy(), np.asarray(jh), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(c_new.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(att_h.numpy(), h_new.numpy() @ w.watt_h.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_cell_and_attend_wrappers_use_plain_versions_on_cpu():
    """On CPU tensors beam_cell and beam_attend run their plain versions and
    launch nothing."""
    from ravvent_tpu_torch.ops import cuda_lib

    rng = np.random.default_rng(7)
    w = decoder_weights(rng)
    keys, values, mask = memory(rng, 4, 24, torch.bfloat16)
    st = mid_decode_state(rng, 4, 5)
    before = dict(cuda_lib.launches)
    cell = tstep.beam_cell(st, w)
    for g, r in zip(cell, tstep.cell_plain(st, w)):
        assert torch.equal(g, r)
    nxt, parent = tstep.beam_attend(st, *cell, keys, values, mask, w, 1)
    ref, rpar = tstep.attend_plain(st, *cell, keys, values, mask, w, 1)
    assert torch.equal(parent, rpar) and all(torch.equal(g, r) for g, r in zip(nxt, ref))
    assert cuda_lib.launches == before
