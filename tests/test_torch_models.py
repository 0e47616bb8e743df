"""Masking, attention memory, encoder input and decoder step of the port
against the JAX package on the CPU (f32: 1e-5; bf16 storage: equal after
the same rounding, up to one bf16 step where the f32 inputs differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models import decoder as jdec
from ravvent_tpu.models.basecaller import encode_input as j_encode
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.utils.masking import input_mask as j_mask
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.models import decoder as tdec
from ravvent_tpu_torch.models.basecaller import encode_input as t_encode
from ravvent_tpu_torch.models.basecaller import init_basecaller as t_init
from ravvent_tpu_torch.utils.masking import input_mask as t_mask
from ravvent_tpu_torch.weights import flatten, from_jax_params

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(enc_units=16, dec_units=16, encoder_depth=2, decoder_depth=1, data_type="joint")


@pytest.fixture(scope="module")
def models():
    jp = j_init(jax.random.PRNGKey(0), JConfig(**CFG))
    return jp, from_jax_params(jax.tree_util.tree_map(np.asarray, jp))


def _snippets(B, seed=0):
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(B, 200, 1)).astype(np.float32)
    ev = rng.normal(size=(B, 30, 5)).astype(np.float32)
    for b in range(B):  # ragged padding, one all-padding row
        raw[b, 200 - 37 * b:] = 0.0
        ev[b, 30 - 6 * b:] = 0.0
    ev[1, 3, 2] = 0.0  # one zero feature inside an event
    return raw, ev


def test_input_mask_matches_jax():
    _, ev = _snippets(6)
    np.testing.assert_array_equal(t_mask(torch.from_numpy(ev)).numpy(),
                                  np.asarray(j_mask(jnp.asarray(ev))))


def test_seeded_init_has_the_jax_tree(models):
    jp, _ = models
    port = t_init(ModelConfig(**CFG), torch.Generator().manual_seed(0))
    ref = flatten(jax.tree_util.tree_map(np.asarray, jp))
    got = flatten(port)
    assert sorted(got) == sorted(ref)
    assert all(got[k].shape == ref[k].shape for k in ref)


def test_encode_input_matches_jax(models):
    jp, tp = models
    raw, ev = _snippets(6)
    jo, jm = j_encode(jp, jnp.asarray(raw), jnp.asarray(ev), JConfig(**CFG))
    to, tm = t_encode(tp, torch.from_numpy(raw), torch.from_numpy(ev), ModelConfig(**CFG))
    assert to.shape == (6, 230, 32)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("dtype", [None, "bf16"])
@pytest.mark.parametrize("project", [False, True])
def test_setup_memory_matches_jax(models, dtype, project):
    jp, tp = models
    rng = np.random.default_rng(2)
    memory = rng.normal(size=(3, 24, 32)).astype(np.float32)
    mask = rng.random((3, 24)) > 0.3
    mask[2] = False  # an all-padding row
    jd, td = jp["decoder"], tp["decoder"]
    jm = jattn.setup_memory(jd["attention"], jnp.asarray(memory), jnp.asarray(mask),
                            jnp.bfloat16 if dtype else None,
                            attention_layer=jd["attention_layer"] if project else None)
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(memory), torch.from_numpy(mask),
                            torch.bfloat16 if dtype else None,
                            attention_layer=td["attention_layer"] if project else None)
    assert tm.projected == project
    for j, t in ((jm.keys, tm.keys), (jm.values, tm.values)):
        assert t.dtype == (torch.bfloat16 if dtype else torch.float32)
        tol = dict(rtol=2 ** -7, atol=1e-6) if dtype else TOL
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)
    if project:
        np.testing.assert_array_equal(tm.watt_h.numpy(), np.asarray(jm.watt_h))


@pytest.mark.parametrize("project", [False, True])
def test_decoder_step_matches_jax(models, project):
    jp, tp = models
    rng = np.random.default_rng(3)
    B, S, U = 4, 24, 16
    memory = rng.normal(size=(B, S, 32)).astype(np.float32)
    mask = rng.random((B, S)) > 0.2
    mask[3] = False  # uniform alignments, not NaN
    jd, td = jp["decoder"], tp["decoder"]
    jm = jattn.setup_memory(jd["attention"], jnp.asarray(memory), jnp.asarray(mask),
                            attention_layer=jd["attention_layer"] if project else None)
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(memory), torch.from_numpy(mask),
                            attention_layer=td["attention_layer"] if project else None)
    h, c, att = (rng.normal(size=(B, U)).astype(np.float32) for _ in range(3))
    tok = np.array([2, 3, 6, 1])
    js = jdec.DecoderState(cells=((jnp.asarray(h), jnp.asarray(c)),), attention=jnp.asarray(att))
    ts = tdec.DecoderState(cells=((torch.from_numpy(h), torch.from_numpy(c)),),
                           attention=torch.from_numpy(att))
    jn, jl, ja = jdec.decoder_step(jd, js, jdec.embed(jnp.asarray(tok), 7), jm)
    tn, tl, ta = tdec.decoder_step(td, ts, tdec.embed(torch.from_numpy(tok), 7), tm)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(ta[:, 0].numpy(), np.asarray(ja), **TOL)
    np.testing.assert_allclose(tn.attention.numpy(), np.asarray(jn.attention), **TOL)
    np.testing.assert_allclose(tn.cells[0][1].numpy(), np.asarray(jn.cells[0][1]), **TOL)
    assert np.isfinite(ta.numpy()).all()
    np.testing.assert_allclose(ta[3, 0].numpy(), np.full(S, 1.0 / S), rtol=1e-6)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_setup_memory_on_a_bf16_stream_matches_jax(models, dtype):
    """A bf16 encoder output: the reference's ``bf16 @ f32`` promotes to f32,
    the port upcasts first; the same numbers."""
    jp, tp = models
    rng = np.random.default_rng(5)
    memory = jnp.asarray(rng.normal(size=(3, 24, 32)).astype(np.float32)).astype(jnp.bfloat16)
    mask = rng.random((3, 24)) > 0.3
    jd, td = jp["decoder"], tp["decoder"]
    jm = jattn.setup_memory(jd["attention"], memory, jnp.asarray(mask),
                            jnp.bfloat16 if dtype else None,
                            attention_layer=jd["attention_layer"])
    tmem = torch.from_numpy(np.asarray(memory, np.float32)).to(torch.bfloat16)
    tm = tattn.setup_memory(td["attention"], tmem, torch.from_numpy(mask),
                            torch.bfloat16 if dtype else None,
                            attention_layer=td["attention_layer"])
    for j, t in ((jm.keys, tm.keys), (jm.values, tm.values)):
        assert t.dtype == (torch.bfloat16 if dtype else torch.float32)
        tol = dict(rtol=2 ** -7, atol=1e-6) if dtype else TOL
        np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32), **tol)


def test_encode_input_on_a_bf16_stream_matches_jax(models):
    """Inputs cast to bf16 before the encoders, masks from the cast inputs,
    the joint output in bf16 (the JAX engine's _cast, basecall.py:366-370)."""
    jp, tp = models
    raw, ev = _snippets(6, seed=1)
    raw[0, :5, 0] = 1e-41  # nonzero in f32, zero in bf16: padding once cast
    jo, jm = j_encode(jp, jnp.asarray(raw).astype(jnp.bfloat16),
                      jnp.asarray(ev).astype(jnp.bfloat16), JConfig(**CFG))
    to, tm = t_encode(tp, torch.from_numpy(raw).to(torch.bfloat16),
                      torch.from_numpy(ev).to(torch.bfloat16), ModelConfig(**CFG))
    assert to.dtype == torch.bfloat16 and jo.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert not tm[0, :5].any()
    assert np.abs(to.float().numpy() - np.asarray(jo, np.float32)).max() <= 1e-2
