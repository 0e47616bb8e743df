"""How far bf16 beams part on a decoder whose beams never end.

On chip_smoke.py phase 5's set-up (flagship decoder widths on seeded
weights, the end token's logit pushed down by 20, bf16 pre-projected
memory shaped like the encoder's, 39 live steps, beam 5), three loops run
on the CPU: the JAX package's XLA ``beam_decode``, its TPU kernel's loop
``beam_step_decode(interpret=True)``, and the port's plain step loop. Each
is compared with the XLA path by top-beam token agreement and by the share
of (row, step) pairs on an agreeing prefix. The yardstick is the XLA path
against itself with its memory input moved by 1e-7 relative: f32 noise
ahead of the bf16 roundings of h and of the alignments. The port's gap must
stay within that one; the kernel's and XLA's shared summation order keeps
them closer than either is to an input 1e-7 away."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.decode.beam import beam_decode as j_beam_decode
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import beam_loop_pallas as jloop
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.ops import beam_step_cuda as tstep
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
B, S, E, V, W, T, EFF, END = 512, 232, 256, 7, 5, 47, 39, 1


def _agreement(a, b):
    """(top-beam token agreement, share of (row, step) on an agreeing prefix)."""
    eq = a == b
    return float(eq.mean()), float(np.cumprod(eq, axis=1).mean())


def test_bf16_beam_gap_is_within_the_references_own_noise():
    jp = j_init(jax.random.PRNGKey(0), JConfig())
    jd = jax.tree_util.tree_map(np.asarray, jp["decoder"])
    jd["fc"]["bias"] = jd["fc"]["bias"].copy()
    jd["fc"]["bias"][END] -= 20.0
    td = from_jax_params(jd)
    rng = np.random.default_rng(0)
    memory = np.tanh(rng.normal(size=(B, S, E))).astype(np.float32)
    pos = np.arange(S)
    n_raw, n_ev = rng.integers(120, 201, (B, 1)), rng.integers(15, 31, (B, 1))
    mask = (pos < n_raw) | ((pos >= 200) & (pos < 200 + n_ev))
    moved = (memory * (1 + 1e-7 * np.random.default_rng(1).normal(size=memory.shape))
             ).astype(np.float32)

    def j_mem(m):
        return jattn.setup_memory(jd["attention"], jnp.asarray(m), jnp.asarray(mask),
                                  jnp.bfloat16, attention_layer=jd["attention_layer"])

    def top(res):
        return np.asarray(res.tokens)[:, :EFF, 0]

    def t_mem(m, rows):
        return tattn.setup_memory(td["attention"], torch.from_numpy(m[rows]),
                                  torch.from_numpy(mask[rows]), torch.bfloat16,
                                  attention_layer=td["attention_layer"])

    xla = top(j_beam_decode(jd, j_mem(memory), V, W, T, EFF))
    xla_moved = top(j_beam_decode(jd, j_mem(moved), V, W, T, EFF))
    kernel = top(jloop.beam_step_decode(jd, j_mem(memory), V, W, T, EFF, interpret=True))
    port = top(tstep.beam_step_decode(td, t_mem(memory, slice(None)), V, W, T, EFF))
    assert not (xla == END).any()  # no beam ends: every step runs the whole cell

    # the smallest input that shows the port parting from the kernel: the
    # first such row alone (repeated to the kernel's 8-row tile)
    r = int(np.flatnonzero((port != kernel).any(axis=1))[0])
    rows = np.full(8, r)
    one_mem = jattn.setup_memory(jd["attention"], jnp.asarray(memory[rows]),
                                 jnp.asarray(mask[rows]), jnp.bfloat16,
                                 attention_layer=jd["attention_layer"])
    one_k = jloop.beam_step_decode(jd, one_mem, V, W, T, EFF, interpret=True)
    one_x = j_beam_decode(jd, one_mem, V, W, T, EFF)
    one_p = tstep.beam_step_decode(td, t_mem(memory, rows), V, W, T, EFF)
    k_sc, p_sc = np.asarray(one_k.scores)[0, :EFF], one_p.scores.numpy()[0, :EFF]
    split = np.flatnonzero(top(one_k)[0] != top(one_p)[0])
    if split.size:
        s0 = int(split[0])
        print(f"row {r} alone: top beams split at step {s0}, where the kernel's best two "
              f"beams stand {k_sc[s0, 0] - k_sc[s0, 1]:.3e} apart; top-beam score port - "
              f"kernel {p_sc[3, 0] - k_sc[3, 0]:.3e} at step 3, "
              f"{p_sc[s0 - 1, 0] - k_sc[s0 - 1, 0]:.3e} at step {s0 - 1}; XLA - kernel at "
              f"most {np.abs(np.asarray(one_x.scores)[0, :s0] - k_sc[:s0]).max():.3e}")

    noise = _agreement(xla_moved, xla)
    ref_kernel = _agreement(kernel, xla)
    ported = _agreement(port, xla)
    print(f"against JAX XLA beam_decode, top beam / prefix: JAX kernel {ref_kernel[0]:.5f} / "
          f"{ref_kernel[1]:.5f}; port plain loop {ported[0]:.5f} / {ported[1]:.5f}; XLA on "
          f"memory moved 1e-7 {noise[0]:.5f} / {noise[1]:.5f}")
    assert ref_kernel[0] >= 0.998
    assert ported[0] >= noise[0] and ported[1] >= noise[1]
    assert noise[0] < 0.998  # the set-up is as sensitive as claimed
