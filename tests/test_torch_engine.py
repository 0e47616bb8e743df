"""The port's compact read path against the JAX engine on the CPU, with the
trained flagship checkpoint; weights carried across; the snippet gather.

f32 memory: equal tokens, step probabilities within 1e-5 relative (live
steps; the step past max_steps is a dead output). bf16 and int8 memory:
token agreement >= 99.8% and the merged read's identity within 0.3 points."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.assembly.merger import Merger as JMerger
from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.ops.gather_rows import gather_rows as j_gather_rows
from ravvent_tpu.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.assembly.alignment import banded_global_identity
from ravvent_tpu_torch.assembly.merger import Merger
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import simulator
from ravvent_tpu_torch.data.snippets import prepare_compact
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine, resolve_device
from ravvent_tpu_torch.ops.gather_rows import gather_rows
from ravvent_tpu_torch.weights import flatten, from_jax_params, load_npz, save_npz

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
N_SNIP, MAX_OUT = 24, 40


@pytest.fixture(scope="module")
def flagship():
    tree = CheckpointManager(str(REPO / "checkpoints")).restore_numpy("flagship")["params"]
    return tree, from_jax_params(tree)


@functools.lru_cache(maxsize=1)
def _read_compact():
    """First N_SNIP snippets of one simulated read, compact form, the bases
    those snippets cover, and the read's aux dict (the "i8dev" wire's)."""
    # in-distribution read: the bench's genome recipe and the flagship's
    # noisy training profile (bench.py:ensure_dataset)
    rng = np.random.default_rng(7)
    seq = simulator.generate_reduced_genome(43, 60_000, rng)[:900]
    profile = simulator.PROFILES["noisy"]
    pore = simulator.PoreModel(kmer_noise_sigma=profile.kmer_noise_sigma)
    sig, ranges = simulator.simulate_read(seq, rng, pore, profile=profile)
    sigc, rr, ev, er, _, aux = prepare_compact(sig, ranges, np.array(["a"] * len(ranges)), 6)
    rr, er = rr[:N_SNIP], er[:N_SNIP]
    lo, hi = rr[0, 0], rr[:, 1].max()
    truth = "".join(b for b, (s, e) in zip(seq, ranges) if s >= lo and e <= hi)
    return sigc, rr, ev, er, truth, aux


@pytest.fixture(scope="module")
def read():
    return _read_compact()[:5]


@pytest.fixture(scope="module")
def read_aux():
    return _read_compact()


def test_from_jax_params_on_flagship(flagship, tmp_path):
    tree, params = flagship
    flat = flatten(params)
    assert len(flat) == 31
    assert flat["decoder/cells/0/kernel"].shape == (135, 512)
    assert flat["encoder_raw/0/fwd/kernel"].shape == (1, 512)
    ref = flatten(tree)
    assert all(np.array_equal(flat[k], ref[k]) for k in ref)
    save_npz(tmp_path / "w.npz", params)
    back = flatten(load_npz(tmp_path / "w.npz"))
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    assert isinstance(load_npz(tmp_path / "w.npz")["encoder_event"], list)


def test_gather_rows_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    src = rng.normal(size=1000).astype(np.float32)
    starts = rng.integers(0, 1000, size=64).astype(np.int32)
    lens = rng.integers(0, 220, size=64).astype(np.int32)
    starts[:3] = [0, 999, 1000]  # rows starting at and past the end
    ref = np.asarray(j_gather_rows(jnp.asarray(src), jnp.asarray(starts), jnp.asarray(lens), 200))
    got = gather_rows(torch.from_numpy(src), torch.from_numpy(starts), torch.from_numpy(lens), 200)
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


def test_engine_needs_a_card_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _snippets(sigc, rr, ev, er):
    """The f16-wire snippets of the compact path, materialized (numpy)."""
    sig = torch.from_numpy(sigc.astype(np.float16).astype(np.float32))
    evs = torch.from_numpy(ev.astype(np.float16).astype(np.float32))
    rr_t, er_t = torch.from_numpy(rr), torch.from_numpy(er)
    raw = gather_rows(sig, rr_t[:, 0], rr_t[:, 1] - rr_t[:, 0], 200)[..., None]
    event = gather_rows(evs.reshape(-1), er_t[:, 0] * 5, (er_t[:, 1] - er_t[:, 0]) * 5,
                        150).reshape(-1, 30, 5)
    return raw.numpy(), event.numpy()


def test_compact_path_f32_memory_matches_jax_engine(flagship, read):
    tree, params = flagship
    sigc, rr, ev, er, _ = read
    jeng = JEngine(tree, JConfig(), chunk_size=32, project_values=True, beam_impl="xla",
                   pack_u8=True)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=32, memory_dtype=None,
                          device="cpu")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    assert tt.shape == (N_SNIP, MAX_OUT)
    np.testing.assert_array_equal(tt, jt)
    live = MAX_OUT - 1
    assert np.abs(tp[:, :live] - jp[:, :live]).max() <= 1 / 255 + 1e-6  # u8 wire

    # the same snippets materialized: unquantized f32 step probabilities
    raw, event = _snippets(sigc, rr, ev, er)
    jtok, jprob = jeng.predict_beam(raw, event, MAX_OUT, 5)
    ttok, tprob = teng.predict_beam(raw, event, MAX_OUT, 5)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(ttok, tt)
    np.testing.assert_allclose(tprob[:, :live], jprob[:, :live], rtol=1e-5, atol=1e-7)

    # the unpacked result buffer: int8 tokens, f16 step probabilities
    plain = BasecallEngine(params, ModelConfig(), chunk_size=32, memory_dtype=None,
                           pack_u8=False, device="cpu")
    ut, up = plain.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    np.testing.assert_array_equal(ut, tt)
    np.testing.assert_allclose(up[:, :live], tprob[:, :live], rtol=2 ** -11, atol=0)


def _merged_identity(merger, engine_cls, tokens, probs, rr, truth):
    seqs = engine_cls.tokens_to_sequences(tokens)
    rows = [p[: len(s)].astype(np.float64) for s, p in zip(seqs, probs)]
    merged = merger.merge_arrays(seqs, rows)
    matches, block, _ = banded_global_identity(merged.seq, truth)
    return 100.0 * matches / max(block, 1)


def test_compact_path_bf16_memory_close_to_jax_engine(flagship, read):
    tree, params = flagship
    sigc, rr, ev, er, truth = read
    jeng = JEngine(tree, JConfig(), chunk_size=32, memory_dtype=jnp.bfloat16,
                   project_values=True, beam_impl="xla", pack_u8=True)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=32, device="cpu")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5)
    assert (tt == jt).mean() >= 0.998
    id_jax = _merged_identity(JMerger(), JEngine, jt, jp, rr, truth)
    id_port = _merged_identity(Merger(), BasecallEngine, tt, tp, rr, truth)
    assert abs(id_port - id_jax) <= 0.3


def test_cli_writes_one_record_per_read(tmp_path):
    from ravvent_tpu_torch.data import chiron
    from ravvent_tpu_torch.tools.basecall import main

    rng = np.random.default_rng(3)
    for i in range(2):
        seq = simulator.random_genome(300, rng)
        sig, ranges = simulator.simulate_read(seq, rng, simulator.PoreModel())
        chiron.write_read(tmp_path / f"r{i}.signal", tmp_path / f"r{i}.label", sig, ranges, seq)
    out = tmp_path / "calls.fastq"
    main(["--cpu", "--seed", "1", "--input", str(tmp_path), "--out", str(out),
          "--format", "fastq", "--enc-units", "16", "--dec-units", "16",
          "--encoder-depth", "1"])
    lines = out.read_text().splitlines()
    assert [lines[0], lines[4]] == ["@r0", "@r1"]
    assert len(lines) == 8 and len(lines[1]) == len(lines[3]) and set(lines[1]) <= set("ACGT")


def interpret_jax_beam_step(monkeypatch):
    """The JAX engine's "step" path calls the Pallas beam-step kernel without
    interpret mode, which has no CPU lowering; it imports beam_step_decode
    at trace time, so the module attribute is patched to interpret mode."""
    from ravvent_tpu.ops import beam_loop_pallas

    monkeypatch.setattr(beam_loop_pallas, "beam_step_decode",
                        functools.partial(beam_loop_pallas.beam_step_decode, interpret=True))


# the bench's --memory choices: JAX engine memory and beam_impl, the port's memory
BENCH_MEMORY = {
    "bf16": (jnp.bfloat16, "xla", torch.bfloat16),
    "i8": ("i8", "step", "i8"),
    "i8mxu": ("i8mxu", "step", "i8mxu"),
}


@pytest.mark.parametrize("memory", list(BENCH_MEMORY))
def test_bench_settings_close_to_jax_engine(flagship, read_aux, memory, monkeypatch):
    """bench.py's main path: the i8dev wire, a bf16 encoder stream,
    pre-projected memory in bf16 or int8 (bench.py --memory i8|i8mxu), beam
    5, 4-bit probabilities. The JAX engine with the same settings decodes
    bf16 memory with XLA on the CPU, int8 memory with its beam-step kernel
    in interpret mode."""
    tree, params = flagship
    sigc, rr, ev, er, truth, aux = read_aux
    j_mem, j_impl, t_mem = BENCH_MEMORY[memory]
    if j_impl == "step":
        interpret_jax_beam_step(monkeypatch)
    jeng = JEngine(tree, JConfig(), chunk_size=16, memory_dtype=j_mem,
                   project_values=True, beam_impl=j_impl, encoder_dtype=jnp.bfloat16,
                   pack_u8=True, transport_dtype="i8dev", prob_bits=4)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=16, memory_dtype=t_mem,
                          encoder_dtype=torch.bfloat16, transport_dtype="i8dev", prob_bits=4,
                          device="cpu")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    assert tt.shape == jt.shape == (N_SNIP, MAX_OUT)
    id_jax = _merged_identity(JMerger(), JEngine, jt, jp, rr, truth)
    id_port = _merged_identity(Merger(), BasecallEngine, tt, tp, rr, truth)
    print(f"bench settings, {memory} memory: tokens agree {(tt == jt).mean():.5f}, identity "
          f"port {id_port:.3f} JAX {id_jax:.3f}")
    assert (tt == jt).mean() >= 0.998
    assert abs(id_port - id_jax) <= 0.3
    # 4-bit probabilities: 16 levels, and with bf16 memory one level apart
    # at most where the rows decode alike. A step's probability is read off
    # beam slot 0's cumulative score, which int8 memory lets follow another
    # near-tied hypothesis where one code of the two engines' memories
    # differs (their bf16 encoders differ in the last bit), with the same
    # decoded tokens; on the same int8 memory the two steps agree on tokens,
    # parents and scores (tests/test_torch_quant.py).
    if memory == "bf16":
        same = (tt == jt).all(axis=1)
        live = MAX_OUT - 1
        assert np.abs(tp[same, :live] - jp[same, :live]).max() <= 1 / 15 + 1e-6
    assert set(np.unique(np.round(tp * 15, 4))) <= set(range(16))
