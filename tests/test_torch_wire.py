"""The compact path's wires against the JAX engine on the CPU.

The "i8dev" wire's device functions (the event features recomputed from
the i8 signal, the snippet ranges derived from the event lengths) against
the JAX package's and the host's; each wire ("f16", "f32", "i8", "i8sig",
"i8dev") and 4-bit probabilities end to end against the JAX engine with the
same wire, on the trained flagship with f32 memory (the JAX engine decodes
with XLA). The wires' values are the JAX wire's: equal tokens, except on
i8dev, whose features the port evaluates in f64 (>= 99.8%)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_engine import MAX_OUT, N_SNIP, flagship, read_aux  # noqa: F401

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.evaluation.basecall import _device_event_features as j_features
from ravvent_tpu.evaluation.basecall import _device_snippet_ranges as j_ranges
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import simulator
from ravvent_tpu_torch.data.snippets import prepare_compact
from ravvent_tpu_torch.evaluation.basecall import (
    WIRES, BasecallEngine, _device_event_features, _device_snippet_ranges,
)

torch.set_num_threads(1)


def _simulated(seed: int, n_bases: int = 2000):
    """A simulated read in compact form with its aux dict
    (tests/test_compact_path.py's recipe)."""
    rng = np.random.default_rng(seed)
    genome = simulator.random_genome(n_bases, rng)
    sig, ranges = simulator.simulate_read(genome, rng, simulator.PoreModel())
    sigc, rr, ev, er, _, aux = prepare_compact(sig, ranges, np.array(["a"] * len(ranges)), 6)
    assert aux["contiguous"]
    return sigc, rr, ev, er, aux


def _i8dev_chunk(sigc, ev, rr, er, aux):
    """The i8dev wire's device inputs for the rows ``rr``/``er`` of one
    chunk, built as the JAX engine's dispatch builds them (basecall.py:
    870-909): the i8-dequantized signal through the last event's end, the
    u16 lengths, hdr1 and the two override rows."""
    lo_s, lo_e, hi_e = int(rr[0, 0]), int(er[0, 0]), int(er[:, 1].max())
    lens = aux["ev_lens"][lo_e:hi_e].astype(np.int64)
    hi_s = max(int(rr[:, 1].max()), min(lo_s + int(lens.sum()), sigc.shape[0]))
    sl = sigc[lo_s:hi_s]
    s_scale = max(float(np.abs(sl).max()), 1e-12) / 127.0
    sig = np.clip(np.round(sl / s_scale), -127, 127).astype(np.int8).astype(np.float32)
    sig = sig * np.float32(s_scale)
    hdr1 = np.zeros(16, np.float32)
    hdr1[0:5], hdr1[5:10] = aux["scaler_mean"], aux["scaler_std"]
    hdr1[10], hdr1[11] = aux["raw_mean"], aux["raw_std"]
    hdr1[12] = ev[lo_e, 1] * aux["scaler_std"][1] + aux["scaler_mean"][1]
    ovr = ev[[lo_e, hi_e - 1]].astype(np.float16).astype(np.float32)
    return sig, lens.astype(np.int32), hi_e - lo_e, hdr1, ovr


def _exact_features(sig, lens, hdr1, ovr):
    """The reference's event features, event by event in f64 (numpy)."""
    h = hdr1.astype(np.float64)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    seg = [sig[s:s + n].astype(np.float64) for s, n in zip(starts, lens)]
    mean = h[10] + h[11] * np.array([x.mean() for x in seg])
    var_z = np.array([(x * x).mean() - x.mean() ** 2 for x in seg])
    stdv = np.sqrt(np.maximum(h[11] ** 2 * var_z, 1.1754944e-38))
    chain = np.concatenate([[h[12]], mean[1:]])  # row 0's true mean leads the chain
    dmean = mean - np.concatenate([chain[:1], chain[:-1]])
    feats = (np.stack([lens, mean, stdv, mean ** 2, dmean], 1) - h[0:5]) / h[5:10]
    feats[0], feats[-1] = ovr
    return feats


@pytest.mark.parametrize("rows", ["whole read", "second chunk", "last chunk"])
def test_device_event_features_match_jax_and_host(rows):
    """The port evaluates the reference's formula in f64: it equals the
    exact features (1e-5), and so departs from the JAX function's f32
    evaluation by no more than that does from the exact features. The JAX
    function's own f32 error stays below 1e-3 on a 64-row chunk (3.5k
    samples); on a 22k-sample slab it reaches ~6e-3 in the stdv column."""
    sigc, rr, ev, er, aux = _simulated(11, 2500)
    s, n = {"whole read": (0, rr.shape[0]), "second chunk": (64, 64),
            "last chunk": (128, rr.shape[0] - 128)}[rows]
    rr, er = rr[s:s + n], er[s:s + n]
    sig, lens, n_ev, hdr1, ovr = _i8dev_chunk(sigc, ev, rr, er, aux)
    got = _device_event_features(torch.from_numpy(sig), torch.from_numpy(lens), n_ev,
                                 torch.from_numpy(hdr1), torch.from_numpy(ovr)).numpy()
    ref = np.asarray(j_features(jnp.asarray(sig), jnp.asarray(lens), jnp.int32(n_ev),
                                jnp.asarray(hdr1), jnp.asarray(ovr)))
    exact = _exact_features(sig, lens, hdr1, ovr)
    host = ev[int(er[0, 0]):int(er[:, 1].max())]
    assert got.shape == ref.shape == host.shape
    print(f"{rows} ({sig.shape[0]} samples): port - exact {np.abs(got - exact).max():.3e}, "
          f"JAX - exact {np.abs(ref - exact).max():.3e}, port - JAX {np.abs(got - ref).max():.3e}")
    assert np.abs(got - exact).max() <= 1e-5
    assert (np.abs(got - ref) <= np.abs(ref - exact) + 1e-5).all()
    if rows == "second chunk":
        assert np.abs(got - ref).max() <= 1e-3
    # the reference's own bars against the host features (i8 signal)
    assert np.abs(got - host).max() < 5e-2
    assert np.abs(got - host).mean() < 5e-3


_j_ranges = jax.jit(j_ranges, static_argnums=(3, 4))


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("chunk", [None, 64])
def test_device_snippet_ranges_bit_equal_to_jax_and_host(seed, chunk):
    """Per chunk of rows (the whole read, or the engine's chunks, the last
    one ending at the read's end): the port's ranges equal the JAX
    function's and the host's, in the chunk's coordinates; rows past
    n_snip are zero, and a zero-padded tail of lengths changes nothing."""
    sigc, rr, ev, er, aux = _simulated(seed)
    N = rr.shape[0]
    stride = int(aux["stride"])
    # fixed shapes for the JAX side: one compile for each kind of case
    n_rows, E_pad = (400, 4096) if chunk is None else (chunk + 5, 1024)
    assert N < 400
    for s in range(0, N, chunk or N):
        n = min(chunk or N, N - s)
        rr_c, er_c = rr[s:s + n], er[s:s + n]
        lo_s, lo_e, hi_e = int(rr_c[0, 0]), int(er_c[0, 0]), int(er_c[:, 1].max())
        lens = aux["ev_lens"][lo_e:hi_e].astype(np.int32)
        padded = np.zeros(E_pad, np.int32)
        padded[:lens.shape[0]] = lens
        n_ev = hi_e - lo_e
        got_r, got_e = (x.numpy() for x in _device_snippet_ranges(
            torch.from_numpy(lens), n, n_ev, n_rows, stride))
        pad_r, pad_e = (x.numpy() for x in _device_snippet_ranges(
            torch.from_numpy(padded), n, n_ev, n_rows, stride))
        ref_r, ref_e = (np.asarray(x) for x in _j_ranges(
            jnp.asarray(padded), jnp.int32(n), jnp.int32(n_ev), n_rows, stride))
        assert got_r.dtype == got_e.dtype == np.int32
        for r, e in ((pad_r, pad_e), (ref_r, ref_e)):
            np.testing.assert_array_equal(got_r, r)
            np.testing.assert_array_equal(got_e, e)
        np.testing.assert_array_equal(got_e[:n], er_c - lo_e)
        np.testing.assert_array_equal(got_r[:n], rr_c - lo_s)
        assert not got_r[n:].any() and not got_e[n:].any()


@pytest.mark.parametrize("wire", WIRES)
def test_each_wire_matches_jax_engine(flagship, read_aux, wire):
    """f32 memory and an f32 encoder: the port's wire against the JAX
    engine's over two chunks (16 + 8 rows), so the i8 wires' per-chunk
    scales are exercised."""
    tree, params = flagship
    sigc, rr, ev, er, _, aux = read_aux
    jeng = JEngine(tree, JConfig(), chunk_size=16, project_values=True, beam_impl="xla",
                   pack_u8=True, transport_dtype=wire)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=16, memory_dtype=None,
                          transport_dtype=wire, device="cpu")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=aux)
    assert tt.shape == (N_SNIP, MAX_OUT)
    if wire == "i8dev":
        assert (tt == jt).mean() >= 0.998
    else:
        np.testing.assert_array_equal(tt, jt)
    same = (tt == jt).all(axis=1)
    live = MAX_OUT - 1
    assert np.abs(tp[same, :live] - jp[same, :live]).max() <= 1 / 255 + 1e-6  # u8 wire


def test_i8dev_needs_the_contiguous_aux(flagship, read_aux):
    _, params = flagship
    sigc, rr, ev, er, _, aux = read_aux
    teng = BasecallEngine(params, ModelConfig(), memory_dtype=None, transport_dtype="i8dev",
                          device="cpu")
    for bad in (None, dict(aux, contiguous=False)):
        with pytest.raises(ValueError, match="aux"):
            teng.dispatch_beam_compact(sigc, rr, ev, er, MAX_OUT, 5, aux=bad)
        with pytest.raises(ValueError, match="aux"):
            teng.compact_snippets(sigc, rr, ev, er, aux=bad)
    with pytest.raises(ValueError, match="transport_dtype"):
        BasecallEngine(params, ModelConfig(), transport_dtype="i4", device="cpu")


@pytest.mark.parametrize("max_out", [MAX_OUT, 44], ids=["even", "odd fetch width"])
def test_prob_bits4_matches_jax_engine(flagship, read_aux, max_out):
    """4-bit probabilities (basecall.py:492-498 and :1044-1050): the JAX
    engine's nibbles, and the 8-bit values within half a step of each."""
    tree, params = flagship
    sigc, rr, ev, er, _, _ = read_aux
    jeng = JEngine(tree, JConfig(), chunk_size=16, project_values=True, beam_impl="xla",
                   pack_u8=True, prob_bits=4)
    t4 = BasecallEngine(params, ModelConfig(), chunk_size=16, memory_dtype=None, prob_bits=4,
                        device="cpu")
    t8 = BasecallEngine(params, ModelConfig(), chunk_size=16, memory_dtype=None, device="cpu")
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, max_out, 5)
    tt, tp = t4.predict_beam_compact(sigc, rr, ev, er, max_out, 5)
    tt8, tp8 = t8.predict_beam_compact(sigc, rr, ev, er, max_out, 5)
    assert tt.shape[1] == min(47, -(-max_out // 8) * 8)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tt, tt8)
    live = max_out - 1
    assert np.abs(tp[:, :live] - jp[:, :live]).max() <= 1 / 15 + 1e-6
    assert np.abs(tp - tp8).max() <= 0.5 / 15 + 0.5 / 255 + 1e-6
