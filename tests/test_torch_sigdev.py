"""The port's signal-only wire ("sigdev", "sigdev8") against the JAX package's
on the CPU: the engine's segmentation (BasecallEngine._segment /
_segment_batch) and predict_beam_signal on the trained flagship (cases of
tests/test_device_event_detect.py and tests/test_sigdev_parity.py); the
evaluators' wires are in tests/test_torch_sigdev_eval.py.

The JAX reference segmentation runs the JAX package's own functions with
its event detection op by op (``detect_boundaries_device`` as its tests call
it; ravvent_tpu/evaluation/basecall.py:653-699 is the same composition under
one ``jax.jit``, where XLA's CPU rewrites of ``x / w`` and ``a / sqrt(b)``
move a t-statistic by an ulp and, rarely, a boundary:
tests/test_torch_event_detect.py::test_jit_rewrites_move_few_boundaries).
Against it the meta (event and snippet counts), the raw and the event ranges
are bit-equal, on both sample wires. The features are not: the port sums
each event's integer samples exactly and takes the rest in f64, the JAX
function subtracts f32 cumsums over the whole read, which cancel; the port
is held to the features' f64 definition event by event (1e-5) and to no
further from the JAX features than those are from it."""

import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.data.snippets import compute_fitting_event_ranges
from ravvent_tpu.evaluation import basecall as jbc
from ravvent_tpu.evaluation.basecall import BasecallEngine as JEngine
from ravvent_tpu.models.basecaller import init_basecaller as j_init
from ravvent_tpu.ops import event_detect as jed
from ravvent_tpu.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.data.event_detector import StreamingEventDetector
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine, PendingSignal
from ravvent_tpu_torch.ops import event_detect as ted
from ravvent_tpu_torch.weights import from_jax_params
from test_torch_cuda_emu import synth

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CFG = dict(enc_units=8, dec_units=8, encoder_depth=1, decoder_depth=1, rnn_type="bilstm",
           data_type="joint")
MAX_OUT = 40


def simulated_read(bases, seed):
    rng = np.random.default_rng(seed)
    raw, _ = simulator.simulate_read(simulator.random_genome(bases, rng), rng,
                                     simulator.PoreModel())
    return np.asarray(raw)


@partial(jax.jit, static_argnames=("E_b", "N_max", "stride"))
def _jax_segment_rest(raw, fired, hdr, n_s, E_b, N_max, stride):
    """ravvent_tpu/evaluation/basecall.py:691-699: the integer and feature
    half of the JAX engine's segmentation."""
    lens, n_ev, n_true = jed.fired_to_event_lens(fired, 6, 9, E_b)
    sig = (raw - hdr[0]) / hdr[1]
    sig = jnp.where(jnp.arange(raw.shape[0]) < n_s, sig, 0.0)
    feats = jbc._device_event_features_selfscaled(sig, lens, n_ev, rm=hdr[0], rs=hdr[1])
    n_snip = jbc._device_snippet_count(lens, n_ev, N_max, stride)
    rr, er = jbc._device_snippet_ranges(lens, n_snip, n_ev, N_max, stride)
    return sig, feats, rr, er, jnp.stack([n_true, n_snip])


def jax_segment(buf, S_b, E_b, N_max, stride, sig_wire="i16"):
    """The JAX engine's ``_segment`` (basecall.py:653-699) with the event
    detection run op by op, on one read's uploaded buffer."""
    buf = np.asarray(buf)
    hdr = jnp.asarray(buf[:32].view(np.float32))
    n_s = int(buf[8:12].view(np.int32)[0])
    if sig_wire == "u8":
        raw = jnp.asarray(buf[32:32 + S_b]).astype(jnp.float32) * hdr[4] + hdr[3]
    else:
        raw = jnp.asarray(buf[32:32 + 2 * S_b].view(np.int16)).astype(jnp.float32)
    fired = jed.detect_boundaries_device(raw[None, :], n_valid=n_s, block=512)[0]
    return _jax_segment_rest(raw, fired, hdr, n_s, E_b=E_b, N_max=N_max, stride=stride)


def jax_segment_batch(buf, S_b, E_b, N_max, stride, sig_wire="i16"):
    """``_segment_batch`` (basecall.py:701-747) likewise: each row alone."""
    rows = [jax_segment(b, S_b, E_b, N_max, stride, sig_wire) for b in np.asarray(buf)]
    return tuple(jnp.stack(x) for x in zip(*rows))


def segment_op_by_op(jeng):
    """Point a JAX engine's segmentation at :func:`jax_segment`."""
    jeng._segment_jit = jax_segment
    jeng._segment_batch_jit = jax_segment_batch
    return jeng


def exact_features(raw, lens):
    """The self-scaled features of the reference's definition, event by
    event in f64 (numpy) on the wire's raw signal."""
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    seg = [raw[s:s + n] for s, n in zip(starts, lens)]
    mean = np.array([x.mean() for x in seg])
    stdv = np.array([np.sqrt(max(x.var(), 1.1754944e-38)) for x in seg])
    dmean = np.concatenate(([0.0], np.diff(mean)))
    feats = np.stack([lens.astype(np.float64), mean, stdv, mean * mean, dmean], axis=1)
    std = feats.std(axis=0)
    return (feats - feats.mean(axis=0)) / np.where(std == 0, 1.0, std)


@pytest.fixture(scope="module")
def small():
    jp = j_init(jax.random.PRNGKey(0), JConfig(**CFG))
    params = from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    return jp, BasecallEngine(params, ModelConfig(**CFG), chunk_size=512, device="cpu")


@pytest.mark.parametrize("sig_wire", ["i16", "u8"])
@pytest.mark.parametrize("read", ["synth", "simulated"])
def test_segment_matches_jax(small, read, sig_wire):
    """tests/test_device_event_detect.py:131's case (400 synthetic events)
    and a 3 kb simulated read: meta, raw and event ranges bit-equal to the
    JAX package's, on the i16 and the u8 wire; the features within 1e-5 of
    their f64 evaluation and no further from the JAX features than those
    are from it; on the i16 wire of the synthetic read, the events and the
    snippet rule of the host pipeline."""
    _, teng = small
    raw = synth(np.random.default_rng(13), 400) if read == "synth" else simulated_read(3000, 3)
    S_b = teng._bucket(raw.size, 65536)
    E_b, N_max = S_b // 2, S_b // 2 // 6 + 1 + teng.chunk_size
    buf = teng.signal_buffer([raw], S_b, sig_wire)[0]
    got = [x.numpy() for x in teng._segment(torch.from_numpy(buf), S_b, E_b, N_max, 6, sig_wire)]
    ref = [np.asarray(x) for x in jax_segment(buf, S_b, E_b, N_max, 6, sig_wire)]
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    n_ev, n_snip = int(got[4][0]), int(got[4][1])
    assert n_snip > 10 and not got[2][n_snip:].any()
    np.testing.assert_array_equal(got[0], ref[0])  # the z-scored signal
    # the event lengths: the port's detection of the same samples
    hdr = buf[:32].view(np.float32)
    raw_f = (buf[32:32 + S_b].astype(np.float32) * hdr[4] + hdr[3] if sig_wire == "u8"
             else buf[32:32 + 2 * S_b].view(np.int16).astype(np.float32))
    fired = ted.detect_boundaries_device(torch.from_numpy(raw_f)[None], n_valid=raw.size)
    lens = ted.fired_to_event_lens(fired, 6, 9, E_b)[0][0, :n_ev].numpy()
    raw64 = (buf[32:32 + S_b].astype(np.float64) * hdr[4] + hdr[3] if sig_wire == "u8"
             else raw.astype(np.float64))
    exact = exact_features(raw64, lens)
    port_err = np.abs(got[1][:n_ev] - exact).max()
    jax_err = np.abs(ref[1][:n_ev] - exact)
    print(f"{read} {sig_wire}: {raw.size} samples, {n_ev} events, {n_snip} snippets; features: "
          f"port - exact {port_err:.3e}, JAX - exact {jax_err.max():.3e}, port - JAX "
          f"{np.abs(got[1] - ref[1]).max():.3e}")
    assert port_err <= 1e-5
    assert (np.abs(got[1][:n_ev] - ref[1][:n_ev]) <= jax_err + 1e-5).all()
    assert not got[1][n_ev:].any()
    if read == "synth" and sig_wire == "i16":
        host = StreamingEventDetector(6, 9).run(raw)
        assert n_ev == len(host)
        host_lens = np.array([e.length for e in host], np.int64)
        np.testing.assert_array_equal(lens, host_lens)
        np.testing.assert_array_equal(got[3][:n_snip], compute_fitting_event_ranges(host_lens, 6))


def test_segment_batch_equals_single_reads(small):
    """tests/test_device_event_detect.py:307's case: three reads of
    different lengths in one batch (one bucket) segment as each alone, and
    decode alike through finish_beam_signal."""
    _, teng = small
    rng = np.random.default_rng(5)
    raws = [synth(rng, n // 9) for n in (3000, 5200, 1400)]
    S_b = teng._bucket(max(r.size for r in raws), 65536)
    E_b, N_max = S_b // 2, S_b // 2 // 6 + 1 + teng.chunk_size
    buf = torch.from_numpy(teng.signal_buffer(raws, S_b))
    batch = teng._segment_batch(buf, S_b, E_b, N_max, 6)
    for k in range(3):
        single = teng._segment(buf[k], S_b, E_b, N_max, 6)
        for b, s in zip(batch, single):
            assert torch.equal(b[k], s)
    for seg, raw in zip(teng.begin_beam_signal_batch(raws), raws):
        t1, p1 = teng.collect_beam_compact(teng.finish_beam_signal(seg, MAX_OUT, 2))
        t2, p2 = teng.predict_beam_signal(raw, MAX_OUT, 2)
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(p1, p2)


def test_overflow_and_empty_reads(small):
    """A segmentation with more events than its buffer holds finishes to
    None (callers take the compact wire); an empty read decodes to no
    rows."""
    _, teng = small
    seg = teng.begin_beam_signal(synth(np.random.default_rng(1), 60))
    assert isinstance(seg, PendingSignal) and teng.finish_beam_signal(seg, MAX_OUT, 2) is not None
    assert teng.finish_beam_signal(seg._replace(E_b=10), MAX_OUT, 2) is None
    tokens, probs = teng.predict_beam_signal(np.zeros(0, np.int64), MAX_OUT, 2)
    assert tokens.shape[0] == probs.shape[0] == 0
    assert teng.predict_beam_signal(np.zeros(0, np.int64), return_ranges=True)[2] is None
    with pytest.raises(ValueError, match="sig_wire"):
        teng.begin_beam_signal(np.ones(10), sig_wire="f16")


@pytest.fixture(scope="module")
def flagship():
    tree = CheckpointManager(str(REPO / "checkpoints")).restore_numpy("flagship")["params"]
    return tree, from_jax_params(tree)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Two simulated reads of 500-700 bases as chiron files, on the bench's
    genome recipe and the flagship's noisy training profile
    (tests/test_sigdev_parity.py's)."""
    d = tmp_path_factory.mktemp("reads")
    genome = simulator.generate_reduced_genome(43, 60_000, np.random.default_rng(7))
    simulator.generate_chiron_dataset(d, genome, n_reads=2, read_len_range=(500, 700), seed=12,
                                      profile=simulator.PROFILES["noisy"])
    paths = sorted(str(p) for p in d.glob("*.signal"))
    (d / "files_info.json").write_text(json.dumps([{"signal_path": p} for p in paths]))
    return d, paths


# the JAX engine's and the port's settings: f32 memory and encoder, and the
# bench's (bf16 memory and encoder stream, 4-bit probabilities)
SETTINGS = {
    "f32": (dict(), dict(memory_dtype=None)),
    "bench": (dict(memory_dtype=jnp.bfloat16, encoder_dtype=jnp.bfloat16, prob_bits=4),
              dict(memory_dtype=torch.bfloat16, encoder_dtype=torch.bfloat16, prob_bits=4)),
}


def engines(flagship, setting, chunk_size=64):
    (jkw, tkw), (tree, params) = SETTINGS[setting], flagship
    jeng = JEngine(tree, JConfig(), chunk_size=chunk_size, project_values=True, beam_impl="xla",
                   pack_u8=True, **jkw)
    teng = BasecallEngine(params, ModelConfig(), chunk_size=chunk_size, device="cpu", **tkw)
    return segment_op_by_op(jeng), teng


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_predict_beam_signal_close_to_jax_on_the_trained_flagship(flagship, reads, setting):
    """Both reads, raw samples in: the snippet rows and ranges equal the JAX
    engine's; with f32 memory and encoder the tokens agree >= 0.999. With
    the bench's bf16 settings the decode of the JAX segmentation agrees
    >= 0.998; end to end the port's f64 features (the JAX engine's f32
    cumsums stray by up to ~1e-2 on these reads, test_segment_matches_jax)
    meet bf16's near-tied beams, printed and held to >= 0.99."""
    jeng, teng = engines(flagship, setting)
    same = same_seg = total = 0
    for p in reads[1]:
        raw = chiron.load_signal(p)
        jt, _, jrr = jeng.predict_beam_signal(raw, MAX_OUT, 5, return_ranges=True)
        tt, _, rr = teng.predict_beam_signal(raw, MAX_OUT, 5, return_ranges=True)
        assert tt.shape == jt.shape and tt.shape[0] > 50
        np.testing.assert_array_equal(rr, jrr)
        assert np.all(np.diff(rr[:, 0]) > 0) and rr[:, 1].max() <= raw.size
        same += int((tt == jt).sum())
        total += tt.size
        # the port's decode half on the JAX engine's segmentation
        seg = jeng.begin_beam_signal(raw)
        arrays = [torch.from_numpy(np.array(x)[None]) for x in seg[:5]]
        js = PendingSignal(*arrays, arrays[2], None, seg[5], 0)
        ts, _ = teng.collect_beam_compact(teng.finish_beam_signal(js, MAX_OUT, 5))
        same_seg += int((ts == jt).sum())
    print(f"{setting}: tokens agree end to end {same}/{total} ({same / total:.5f}), on the JAX "
          f"segmentation {same_seg}/{total} ({same_seg / total:.5f})")
    assert same_seg / total >= 0.998
    assert same / total >= (0.999 if setting == "f32" else 0.99)


def reference_arm_features(hdr):
    """The signal-only wire's features computed the JAX engine's way
    (ravvent_tpu/evaluation/basecall.py:156-206, ``_device_event_features_selfscaled``):
    f32 cumsums of the z-scored signal over the whole read, subtracted at
    each event's ends, in f32 throughout; ``hdr`` is the read's upload header
    (z-score mean and std). A drop-in for the port's function of that name,
    which sums each event's integer samples exactly."""
    rm, rs = (torch.tensor(float(v), dtype=torch.float32) for v in hdr[:2])

    def features(x, lens, n_ev, lo, step):
        sig = (lo + step * x.float() - rm) / rs
        E, S = lens.shape[0], sig.shape[0]
        rows = torch.arange(E)
        valid = rows < n_ev
        lens_v = torch.where(valid, lens, torch.zeros_like(lens)).long()
        lens_safe = lens_v.clamp(min=1)
        cum = torch.cumsum(lens_v, 0)
        starts = cum - lens_v
        zero = torch.zeros(1)
        cs = torch.cat([zero, torch.cumsum(sig, 0)])
        cq = torch.cat([zero, torch.cumsum(sig * sig, 0)])
        s_idx, e_idx = starts.clamp(0, S), cum.clamp(0, S)
        mean_z = (cs[e_idx] - cs[s_idx]) / lens_safe
        var_z = (cq[e_idx] - cq[s_idx]) / lens_safe - mean_z * mean_z
        mean = rm + rs * mean_z
        stdv = torch.sqrt(torch.clamp(rs * rs * var_z, min=1.1754944e-38))
        dmean = torch.where(rows == 0, 0.0, mean - torch.cat([mean[:1], mean[:-1]]))
        feats = torch.stack([lens_v.float(), mean, stdv, mean * mean, dmean], dim=1)
        feats = torch.where(valid[:, None], feats, 0.0)
        n = torch.as_tensor(n_ev).clamp(min=1).float()
        fmean = feats.sum(dim=0) / n
        fvar = torch.where(valid[:, None], (feats - fmean) ** 2, 0.0).sum(dim=0) / n
        fstd = torch.sqrt(fvar)
        fstd = torch.where(fstd == 0.0, 1.0, fstd)
        return torch.where(valid[:, None], (feats - fmean) / fstd, 0.0)

    return features


def test_reference_arm_features_on_the_bench_setting(flagship, reads, monkeypatch):
    """The other arm of the bench setting's end-to-end gap (0.99673 in
    test_predict_beam_signal_close_to_jax_on_the_trained_flagship): the
    port's features computed as the JAX engine computes them (f32 cumsums
    over the whole read, then subtracted) in torch's summation order. They
    stray from the JAX engine's features as far as the port's exact ones do
    (up to ~3e-3, in the stdv column, whose variance cancels), since XLA's
    f32 cumsum rounds in another order; end to end the tokens agree 0.99774
    (7942/7960), below 0.998, where decoding the JAX engine's own
    segmentation agrees 0.99937. So the gap follows the f32 rounding of
    that column, which lands elsewhere under every summation order, and
    bf16's near-tied beams follow it; held to the existing test's 0.99."""
    from ravvent_tpu_torch.evaluation import basecall as tbc

    exact = tbc._device_event_features_selfscaled
    jeng, teng = engines(flagship, "bench")
    same = total = 0
    for p in reads[1]:
        raw = chiron.load_signal(p)
        S_b = teng._bucket(raw.size, 65536)
        E_b, N_max = S_b // 2, S_b // 2 // 6 + 1 + teng.chunk_size
        buf = teng.signal_buffer([raw], S_b)[0]
        ref = np.asarray(jax_segment(buf, S_b, E_b, N_max, 6)[1])
        port = teng._segment(torch.from_numpy(buf), S_b, E_b, N_max, 6)[1].numpy()
        monkeypatch.setattr(tbc, "_device_event_features_selfscaled",
                            reference_arm_features(buf[:32].view(np.float32)))
        arm = teng._segment(torch.from_numpy(buf), S_b, E_b, N_max, 6)[1].numpy()
        d_arm, d_port = np.abs(arm - ref).max(), np.abs(port - ref).max()
        print(f"features against the JAX engine's: the reference arm {d_arm:.3e}, the port's "
              f"exact ones {d_port:.3e}; arm against exact {np.abs(arm - port).max():.3e}")
        assert 1e-3 < d_arm < 1e-2 and d_arm <= 2 * d_port
        jt, _ = jeng.predict_beam_signal(raw, MAX_OUT, 5)
        tt, _ = teng.predict_beam_signal(raw, MAX_OUT, 5)
        monkeypatch.setattr(tbc, "_device_event_features_selfscaled", exact)
        assert tt.shape == jt.shape and tt.shape[0] > 50
        same += int((tt == jt).sum())
        total += tt.size
    print(f"bench, the reference arm's features: tokens agree end to end {same}/{total} "
          f"({same / total:.5f})")
    assert same / total >= 0.99
