"""On-device event detection in the port (ravvent_tpu_torch/ops/event_detect.py)
against the JAX package's (ravvent_tpu/ops/event_detect.py) on the CPU.

The cases of tests/test_device_event_detect.py: the same seeded reads go
through both packages. Every fired mask, t-statistic, event length and count
is compared bit for bit (no tolerance): the port's t-statistics evaluate the
reference's formula in IEEE f32, as the JAX functions do when run op by op,
the way the JAX package's own tests call ``detect_boundaries_device``. On the
CPU the port's peak scan runs its plain version (the blocked scan, its check
and the sequential fallback in tensor code); the kernel of
csrc/peak_scan.cu is held against it in tests/test_torch_cuda_emu_peak_scan.py and on
the card in tests/test_torch_gpu.py.

Under ``jax.jit`` XLA's CPU backend rewrites ``x / w`` as ``x * (1/w)`` and
``a / sqrt(b)`` as ``a * rsqrt(b)``, which moves some t-statistics by an ulp
and, rarely, a boundary; test_jit_rewrites_move_few_boundaries measures how
rarely."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ravvent_tpu.data.event_detector import StreamingEventDetector
from ravvent_tpu.ops import event_detect as jed
from ravvent_tpu_torch.ops import event_detect as ted
from cuda_emu_cases import coupling_failure_trace, memory_trace, synth

torch.set_num_threads(1)


def port_fired(x, **kw):
    return ted.detect_boundaries_device(torch.from_numpy(np.asarray(x, np.float32)), **kw).numpy()


def jax_fired(x, **kw):
    return np.asarray(jed.detect_boundaries_device(jnp.asarray(np.asarray(x, np.float32)), **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_boundaries_bit_equal_to_jax_and_the_streaming_detector(seed):
    """tests/test_device_event_detect.py:22's case: the port's fired mask
    equals the JAX package's (sequential scan and blocked scan alike), and
    its events the streaming detector's."""
    raw = synth(np.random.default_rng(seed))
    got = port_fired(raw[None])
    np.testing.assert_array_equal(got, jax_fired(raw[None]))
    np.testing.assert_array_equal(got, jax_fired(raw[None], block=512))
    events = ted.boundaries_to_events(raw, got[0])
    np.testing.assert_array_equal(events, jed.boundaries_to_events(raw, got[0]))
    ref = StreamingEventDetector(6, 9).run(raw)
    assert [(e.start, e.length) for e in ref] == [(int(s), int(n)) for s, n in events[:, :2]]


@pytest.mark.parametrize("w", [6, 9])
def test_tstats_bit_equal_to_jax(w):
    """Both windows' t-statistics, exact and padded with a per-read n_valid,
    bit for bit."""
    rng = np.random.default_rng(11)
    r1, r2 = synth(rng, 300), synth(rng, 180)
    x = np.zeros((2, len(r1) + 333), np.float32)
    x[0, :len(r1)], x[1, :len(r2)] = r1, r2
    nv = np.array([len(r1), len(r2)], np.int32)
    got = ted.compute_tstats_device(torch.from_numpy(x), w, 9, torch.from_numpy(nv)).numpy()
    ref = np.asarray(jed.compute_tstats_device(jnp.asarray(x), w, 9, jnp.asarray(nv)))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    got = ted.compute_tstats_device(torch.from_numpy(x[:1]), w, 9).numpy()
    ref = np.asarray(jed.compute_tstats_device(jnp.asarray(x[:1]), w, 9))
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed,n_events", [(0, 200), (3, 2000), (11, 8000)])
def test_blocked_scan_bit_equal_to_jax(seed, n_events):
    """tests/test_device_event_detect.py:196's cases: the port's blocked
    scan (fired, ok) equals the JAX package's on the same t-statistics, the
    check passes, and the whole detection equals the JAX package's with
    block=512 (the 8000-event read, 100k samples, through the blocked scan
    only; the port's per-sample loop is held on short traces)."""
    raw = synth(np.random.default_rng(seed), n_events)
    x = raw[None].astype(np.float32)
    t1, t2 = (ted.compute_tstats_device(torch.from_numpy(x), w, 9) for w in (6, 9))
    fired, ok = ted.peak_scan_device_blocked(t1, t2, 6, 9)
    jfired, jok = jed.peak_scan_device_blocked(jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy()),
                                               6, 9)
    assert bool(ok) and bool(jok)
    np.testing.assert_array_equal(fired.numpy(), np.asarray(jfired))
    np.testing.assert_array_equal(port_fired(x), jax_fired(x, block=512))


def test_sequential_scan_bit_equal_to_jax():
    """The per-sample loop (the blocked scan's fallback) on a short read."""
    raw = synth(np.random.default_rng(4), 120)
    x = raw[None].astype(np.float32)
    t1, t2 = (ted.compute_tstats_device(torch.from_numpy(x), w, 9) for w in (6, 9))
    got = ted.peak_scan_device(t1, t2, 6, 9).numpy()
    ref = np.asarray(jed.peak_scan_device(jnp.asarray(t1.numpy()), jnp.asarray(t2.numpy()), 6, 9))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, ted.peak_scan_device_blocked(t1, t2, 6, 9)[0].numpy())


@pytest.mark.parametrize("n_events,pad", [(120, 977), (1200, 7777)])
def test_padded_detection_equals_exact_length(n_events, pad):
    """tests/test_device_event_detect.py:115 and :215's cases: a read
    zero-padded with n_valid fires as the exact-length read does, nothing
    fires past it, and the result equals the JAX package's."""
    raw = synth(np.random.default_rng(9), n_events)
    S = len(raw)
    padded = np.zeros((1, S + pad), np.float32)
    padded[0, :S] = raw
    got = port_fired(padded, n_valid=S)
    np.testing.assert_array_equal(got, jax_fired(padded, n_valid=S, block=512))
    np.testing.assert_array_equal(got[0, :S], port_fired(raw[None])[0])
    assert not got[0, S:].any()


def test_batched_reads_with_their_lengths():
    """tests/test_device_event_detect.py:36's case, and the same batch with
    a [B] n_valid (the batched segmentation): each read as if alone, equal
    to the JAX package's."""
    rng = np.random.default_rng(7)
    r1, r2 = synth(rng, 80), synth(rng, 60)
    batch = np.zeros((2, max(len(r1), len(r2))), np.float32)
    batch[0, :len(r1)], batch[1, :len(r2)] = r1, r2
    got = port_fired(batch)
    np.testing.assert_array_equal(got, jax_fired(batch))
    np.testing.assert_array_equal(got[0], port_fired(r1[None])[0])
    nv = np.array([len(r1), len(r2)], np.int32)
    got = ted.detect_boundaries_device(torch.from_numpy(batch), n_valid=torch.from_numpy(nv))
    np.testing.assert_array_equal(got.numpy(), jax_fired(batch, n_valid=jnp.asarray(nv),
                                                         block=512))
    np.testing.assert_array_equal(got[1, :len(r2)].numpy(), port_fired(r2[None])[0])


@pytest.mark.parametrize("trace", ["coupling_failure", "memory"])
def test_coupling_failure_falls_back_to_the_sequential_scan(trace):
    """tests/test_device_event_detect.py:229's trace, and one whose blocked
    fires are wrong: the check fails (ok False, as the JAX package's), and
    the plain version returns the sequential answer (the JAX package's
    ``lax.cond`` fallback)."""
    t = (coupling_failure_trace() if trace == "coupling_failure" else memory_trace())[None]
    tt = torch.from_numpy(t)
    fired_b, ok = ted.peak_scan_device_blocked(tt, tt, 6, 9)
    jfired_b, jok = jed.peak_scan_device_blocked(jnp.asarray(t), jnp.asarray(t), 6, 9)
    assert not bool(ok) and not bool(jok)
    np.testing.assert_array_equal(fired_b.numpy(), np.asarray(jfired_b))
    seq = np.asarray(jed.peak_scan_device(jnp.asarray(t), jnp.asarray(t), 6, 9))
    got = ted.peak_scan_plain(tt, tt, 6, 9, n_valid=t.shape[1]).numpy()
    np.testing.assert_array_equal(got, seq)
    if trace == "memory":
        assert np.nonzero(seq[0])[0].tolist() == [1503] and not fired_b.any()


@pytest.mark.parametrize("max_events", [4096, 100])
def test_fired_to_event_lens_equals_jax(max_events):
    """tests/test_device_event_detect.py:90's case: lengths, the capped and
    the uncapped count equal the JAX package's, also when the events
    overflow ``max_events`` (the reference's scatter drops the rest); the
    lengths tile the events of boundaries_to_events."""
    raw = synth(np.random.default_rng(5), 150)
    fired = port_fired(raw[None])[0]
    lens, n_ev, n_true = ted.fired_to_event_lens(torch.from_numpy(fired), 6, 9, max_events)
    jlens, jn_ev, jn_true = jed.fired_to_event_lens(jnp.asarray(fired), 6, 9, max_events)
    np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
    assert (int(n_ev), int(n_true)) == (int(jn_ev), int(jn_true))
    ref = ted.boundaries_to_events(raw, fired)
    assert int(n_true) == ref.shape[0] and int(n_ev) == min(max_events, ref.shape[0])
    if max_events > ref.shape[0]:
        np.testing.assert_array_equal(lens.numpy()[:int(n_ev)], ref[:, 1].astype(int))
    batched = ted.fired_to_event_lens(torch.from_numpy(np.stack([fired, fired])), 6, 9,
                                      max_events)
    np.testing.assert_array_equal(batched[0][1].numpy(), lens.numpy())


def test_rejects_out_of_domain_windows():
    with pytest.raises(ValueError, match="w2 <= 2"):
        ted.detect_boundaries_device(torch.zeros(1, 100), w1=3, w2=21)


def test_jit_rewrites_move_few_boundaries():
    """The JAX package's detection under ``jax.jit`` (as its engine runs
    it): XLA's reciprocal and rsqrt rewrites move t-statistics by an ulp,
    so a few fires differ from the port's (and from the JAX functions run
    op by op). Printed; held to >= 99.9% of fires on a 100k-sample read."""
    raw = synth(np.random.default_rng(11), 8000)
    x = raw[None].astype(np.float32)
    got = port_fired(x)[0]
    jit = np.asarray(jax.jit(lambda r: jed.detect_boundaries_device(r, block=512))(
        jnp.asarray(x)))[0]
    both = (got & jit).sum()
    agree = both / max(got.sum(), jit.sum())
    print(f"fires: port {got.sum()}, JAX under jit {jit.sum()}, both {both} ({agree:.5f})")
    assert agree >= 0.999
