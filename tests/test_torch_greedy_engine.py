"""The port's BasecallEngine.predict_greedy against the JAX engine's on the
CPU, on the trained flagship: the engine's encoder, its pre-projected memory
and plain greedy steps, as the JAX engine decodes it with XLA
(ravvent_tpu/evaluation/basecall.py:413-420, 1328-1345).

f32 memory and encoder: equal tokens, logits within 1e-5 relative. bf16
memory (the CLI's f32 encoder, or the bench's bf16 stream): >= 99.8% of the
tokens. int8 memory is refused, as the JAX engine's XLA decode cannot read
it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from test_torch_engine import MAX_OUT, N_SNIP, _read_compact, _snippets, flagship  # noqa: F401

torch.set_num_threads(1)

# the JAX engine's and the port's settings
SETTINGS = {
    "f32": (dict(), dict(memory_dtype=None)),
    "cli": (dict(memory_dtype=jnp.bfloat16), dict(memory_dtype=torch.bfloat16)),
    "bench": (dict(memory_dtype=jnp.bfloat16, encoder_dtype=jnp.bfloat16),
              dict(memory_dtype=torch.bfloat16, encoder_dtype=torch.bfloat16)),
}


@pytest.fixture(scope="module")
def snippets():
    sigc, rr, ev, er = _read_compact()[:4]
    return _snippets(sigc, rr, ev, er)


def engines(flagship, setting, chunk_size):
    (jkw, tkw), (tree, params) = SETTINGS[setting], flagship
    jeng = JEngine(tree, JConfig(), chunk_size=chunk_size, project_values=True, beam_impl="xla",
                   **jkw)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=chunk_size, device="cpu", **tkw)
    return jeng, teng


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_predict_greedy_matches_jax_engine(flagship, snippets, setting):
    """Chunks of 8 rows, which the JAX engine runs unpadded, so the two
    decode the same batches and stop at the same step."""
    raw, event = snippets
    jeng, teng = engines(flagship, setting, 8)
    jt, jl = jeng.predict_greedy(raw, event, MAX_OUT)
    tt, tl = teng.predict_greedy(raw, event, MAX_OUT)
    assert tt.shape == jt.shape == (N_SNIP, MAX_OUT)
    assert tl.shape == jl.shape == (N_SNIP, MAX_OUT, 7) and tl.dtype == np.float32
    agree = (tt == jt).mean()
    scale = np.abs(jl).max()
    print(f"greedy, {setting}: tokens agree {agree:.5f}, logits max abs diff "
          f"{np.abs(tl - jl).max():.3e} (|logits| <= {scale:.2f})")
    if setting == "f32":
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5 * scale)
    else:
        assert agree >= 0.998
    assert np.isfinite(tl).all()


def test_predict_greedy_trims_and_chunks_as_jax(flagship, snippets):
    """The fetch width min(TOTAL_STEPS, round_up_8(max_output_len)) of
    basecall.py:1342-1345 (12 -> 16, 44 -> 47), and a last chunk of fewer
    rows than chunk_size: the JAX engine pads it, this engine does not, and
    every row's sequence up to its end token is the same."""
    raw, event = snippets
    jeng, teng = engines(flagship, "f32", 16)
    for max_out, width in ((12, 16), (44, 47)):
        jt, jl = jeng.predict_greedy(raw, event, max_out)
        tt, tl = teng.predict_greedy(raw, event, max_out)
        assert tt.shape == jt.shape == (N_SNIP, width) and tl.shape == jl.shape
        assert BasecallEngine.tokens_to_sequences(tt) == JEngine.tokens_to_sequences(jt)
        np.testing.assert_array_equal(tt[:16], jt[:16])  # the full first chunk
        np.testing.assert_allclose(tl[:16], jl[:16], rtol=1e-5, atol=1e-5 * np.abs(jl).max())


@pytest.mark.parametrize("memory", ["i8", "i8mxu"])
def test_predict_greedy_refuses_int8_memory(flagship, snippets, memory):
    raw, event = snippets
    teng = BasecallEngine(flagship[1], ModelConfig(), chunk_size=8, memory_dtype=memory,
                          device="cpu")
    with pytest.raises(ValueError, match="int8 memory"):
        teng.predict_greedy(raw, event, MAX_OUT)
