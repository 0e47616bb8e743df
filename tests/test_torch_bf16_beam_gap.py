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
them closer than either is to an input 1e-7 away.

The trained flagship on chip_smoke.py phase 15's input parts the same way:
its bf16 stream's tokens move with the f32 sums' order as far as the
card's kernels move them, and the JAX engine's further still."""

import json
from pathlib import Path

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


def test_trained_flagships_bf16_stream_parts_on_the_bench_read_within_its_own_noise(
        tmp_path, monkeypatch):
    """chip_smoke.py phase 15's trained-flagship input: the bench's settings
    (i8dev wire, bf16 encoder stream and memory, 4-bit probabilities, beam
    5) over the first 64 snippets of bench.py's first read. The flagship
    maps these reads at chance, so its decisions are near ties that follow
    the bf16 rounding of h at each encoder step. The yardstick: the JAX
    engine against itself with its encoders' f32 biases moved by 1e-7
    relative. Two things part the port from the JAX engine on the bf16
    stream: that noise, and the i8dev wire's event features, which the port
    evaluates exactly (f64) and the reference in f32 (tests/test_torch_wire.py).
    Given the port's features, the JAX engine stays within its own noise of
    the port; its own f32 features part it from itself further. The card's
    end-to-end bar in phase 15 (chip_smoke.TRAINED_BF16_NOISE) is no looser
    than that noise. On f32 the port and the JAX engine are equal."""
    import chip_smoke
    from ravvent_tpu.evaluation import basecall as jbc
    from ravvent_tpu.training.checkpoints import CheckpointManager
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.data.snippets import load_read_compact_ex
    from ravvent_tpu_torch.evaluation import basecall as tbc
    from ravvent_tpu_torch.tools import bench
    from ravvent_tpu_torch.weights import load_flagship

    fi, _ = bench.ensure_dataset(tmp_path / "bench", n_reads=1, n_stream_reads=1)
    p = json.loads(fi.read_text())[0]["signal_path"]
    sig, rr, ev, er, nuc, aux = load_read_compact_ex(p, p.replace(".signal", ".label"), 6)
    max_len, n = int((nuc != 0).sum(axis=1).max()), 64
    repo = Path(__file__).resolve().parents[1]
    tree = CheckpointManager(str(repo / "checkpoints")).restore_numpy("flagship")["params"]
    rng = np.random.default_rng(1)
    moved = {k: [{d: dict(cell, bias=(cell["bias"] * (1 + 1e-7 * rng.normal(
        size=cell["bias"].shape))).astype(np.float32)) for d, cell in layer.items()}
        for layer in v] if k.startswith("encoder") else v for k, v in tree.items()}

    def port_features(sig, lens, n_ev, hdr1, ovr):
        def f(*a):
            s, l, k, h, o = (torch.from_numpy(np.array(x)) for x in a)
            return tbc._device_event_features(s, l.long(), int(k), h, o).numpy()
        return jax.pure_callback(f, jax.ShapeDtypeStruct((lens.shape[0], 5), jnp.float32),
                                 sig, lens, n_ev, hdr1, ovr)

    def jax_tokens(params, dtype, features=None):
        if features is not None:
            monkeypatch.setattr(jbc, "_device_event_features", features)
        eng = jbc.BasecallEngine(params, JConfig(), chunk_size=n, memory_dtype=dtype,
                                 project_values=True, beam_impl="xla", encoder_dtype=dtype,
                                 pack_u8=True, transport_dtype="i8dev", prob_bits=4)
        out = eng.predict_beam_compact(sig, rr[:n], ev, er[:n], max_len, 5, aux=aux)[0]
        monkeypatch.undo()
        return np.asarray(out)

    def port_tokens(dtype):
        eng = tbc.BasecallEngine(load_flagship(), ModelConfig(), chunk_size=n,
                                 memory_dtype=dtype, encoder_dtype=dtype,
                                 transport_dtype="i8dev", prob_bits=4, device="cpu")
        return eng.predict_beam_compact(sig, rr[:n], ev, er[:n], max_len, 5, aux=aux)[0]

    jax_bf16, port = jax_tokens(tree, jnp.bfloat16), port_tokens(torch.bfloat16)
    noise = _agreement(jax_tokens(moved, jnp.bfloat16), jax_bf16)
    given = jax_tokens(tree, jnp.bfloat16, port_features)
    same_features, jax_features = _agreement(port, given), _agreement(given, jax_bf16)
    vs_jax = _agreement(port, jax_bf16)
    print(f"trained flagship, bench settings, bench read 0, 64 snippets, top beam, tokens / "
          f"prefix: the JAX engine against itself moved 1e-7 {noise[0]:.5f} / {noise[1]:.5f}; "
          f"the port against the JAX engine given the port's event features "
          f"{same_features[0]:.5f} / {same_features[1]:.5f}; the JAX engine given them against "
          f"itself {jax_features[0]:.5f} / {jax_features[1]:.5f}; the port against the JAX "
          f"engine {vs_jax[0]:.5f} / {vs_jax[1]:.5f} (phase 15's bar on the card "
          f"{chip_smoke.TRAINED_BF16_NOISE:.5f})")
    assert np.array_equal(port_tokens(None), jax_tokens(tree, None))
    assert noise[0] < 0.998  # the input is as sensitive as claimed
    assert same_features[0] >= noise[0] and same_features[1] >= noise[1]
    assert jax_features[0] < 1.0  # the reference's f32 features move its tokens
    assert chip_smoke.TRAINED_BF16_NOISE >= noise[0]
