"""The fused greedy step's wide shapes against the JAX package on the CPU.

At the memory widths 192 and 384 (zero-padded to 256 and 512 on the card)
and the decoder widths 96 and 200 (padded to 128 and 256): the fused
greedy loop's plain version, which the kernel is held to on the card,
against the TPU kernel in interpret mode (fused_greedy_decode with
interpret=True) at the true widths, f32 memory: tokens equal, logits within
1e-5. Then the padded route (ops/decoder_pad.py) through the plain version,
with ``on_card`` patched so that the CPU takes it, against the true widths.
The models and memories are test_torch_beam_wide.py's."""

import numpy as np
import pytest
import torch
from test_torch_beam_wide import TOL, V, STEPS, memories, model, take_padded_route  # noqa: F401

from ravvent_tpu.ops import decode_step_pallas as jgreedy
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.ops import decode_step_cuda as tgreedy

torch.set_num_threads(1)


GREEDY_CASES = [(128, 384), (96, 192), (200, 384)]


@pytest.mark.parametrize("U,E", GREEDY_CASES, ids=[f"U{u}-E{e}" for u, e in GREEDY_CASES])
def test_fused_greedy_decode_wide_matches_pallas_interpret(model, U, E):
    """The fused greedy loop's plain version against the TPU kernel in
    interpret mode at memory widths between the compiled ones: tokens
    equal, logits within 1e-5."""
    jd, td, enc, mask = model(U, E)
    jm, tm = memories(jd, td, enc, mask, False)
    jt, jl = jgreedy.fused_greedy_decode(jd, jm, V, STEPS, STEPS, b_tile=8, interpret=True)
    tt, tl = tgreedy.fused_greedy_decode(td, tm, V, STEPS, STEPS)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("U,E", [(96, 192), (128, 384), (200, 64)],
                         ids=["U96-E192", "U128-E384", "U200-E64"])
def test_padded_greedy_gives_the_true_widths_tokens(model, monkeypatch, U, E):
    """The fused greedy decode on the padded route (the decoder's weights and
    keys, counted as ``decoder_padded``; the values' columns and the
    attention layer's context rows, counted as ``greedy_memory_padded``)
    against the true widths: tokens equal, logits within 1e-6 relative
    (1e-6 absolute near zero)."""
    _, td, enc, mask = model(U, E)
    tm = tattn.setup_memory(td["attention"], torch.from_numpy(enc), torch.from_numpy(mask))
    rt, rl = tgreedy.fused_greedy_decode(td, tm, V, STEPS, STEPS)
    take_padded_route(monkeypatch)
    gt, gl = tgreedy.fused_greedy_decode(td, tm, V, STEPS, STEPS)
    assert torch.equal(gt, rt)
    np.testing.assert_allclose(gl.numpy(), rl.numpy(), rtol=1e-6, atol=1e-6)
    assert cuda_lib.launches["decoder_padded"] == (U not in tgreedy.GREEDY_UNITS)
    assert cuda_lib.launches["greedy_memory_padded"] == (E not in tgreedy.GREEDY_MEMORY_DIMS)
