"""Two writers of one cache entry, or of one checkpoint, in one process.

``data/snippets.py:load_read_snippets`` and
``training/checkpoints.py:CheckpointManager.save`` publish each file through
a temporary file and ``os.replace``. Two threads that miss the same cache
entry (the batch generator's prefetch producer loads ahead while another
epoch loads the same read) write at once; each must write its own temporary
file, or the second ``os.replace`` finds the file gone. The writes are held
behind a barrier so that both finish before either publishes."""

import threading

import numpy as np
import pytest
import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator, snippets
from ravvent_tpu_torch.models.basecaller import init_basecaller
from ravvent_tpu_torch.training import checkpoints
from ravvent_tpu_torch.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.weights import flatten

TIMEOUT = 30  # seconds any one wait may take


def held_writes(monkeypatch, module, name: str) -> threading.Barrier:
    """``module.np.<name>`` writes, then waits until the other writer has
    written too."""
    barrier = threading.Barrier(2, timeout=TIMEOUT)
    real = getattr(np, name)

    def write_then_wait(file, *args, **kwargs):
        real(file, *args, **kwargs)
        barrier.wait()

    monkeypatch.setattr(module.np, name, write_then_wait)
    return barrier


def both(fn):
    """``fn()`` in two threads at once: their results; the first exception
    raised in either is raised here."""
    results, errors = [None, None], []

    def run(i):
        try:
            results[i] = fn()
        except BaseException as e:  # handed to the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a writer hung"
    if errors:
        raise errors[0]
    return results


@pytest.fixture(scope="module")
def read(tmp_path_factory):
    d = tmp_path_factory.mktemp("read")
    rng = np.random.default_rng(5)
    genome = simulator.random_genome(600, rng)
    sig, ranges = simulator.simulate_read(genome, rng, simulator.PoreModel())
    chiron.write_read(d / "r0.signal", d / "r0.label", sig, ranges, genome)
    return d / "r0.signal", d / "r0.label"


def test_two_threads_missing_one_cache_entry_both_load_it(read, tmp_path, monkeypatch):
    ref = snippets.load_read_snippets(*read, 6)  # uncached
    assert ref[0].shape[0] > 0
    cache = tmp_path / "cache"
    held_writes(monkeypatch, snippets, "savez_compressed")
    got = both(lambda: snippets.load_read_snippets(*read, 6, cache_dir=str(cache)))
    for arrays in got:
        for a, b in zip(arrays, ref):
            np.testing.assert_array_equal(a, b)
    entries = sorted(p.name for p in cache.iterdir())
    assert len(entries) == 1 and entries[0].endswith(".npz"), entries  # no temporary left
    monkeypatch.undo()
    hit = snippets.load_read_snippets(*read, 6, cache_dir=str(cache))  # from the entry
    for a, b in zip(hit, ref):
        np.testing.assert_array_equal(a, b)


def test_two_threads_saving_one_checkpoint_both_publish(tmp_path, monkeypatch):
    params = init_basecaller(ModelConfig(enc_units=8, dec_units=8, encoder_depth=1),
                             torch.Generator().manual_seed(0))
    cm = CheckpointManager(str(tmp_path))
    held_writes(monkeypatch, checkpoints, "savez")
    both(lambda: cm.save("run.01", params, epoch=1))
    assert sorted(p.name for p in (tmp_path / "run.01").iterdir()) == [
        checkpoints.PARAMS_FILE, checkpoints.STATE_FILE]
    back = cm.restore("run.01")
    assert back["epoch"] == 1
    want = flatten(params)
    got = flatten(back["params"])
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_a_failed_write_leaves_no_temporary_file(read, tmp_path, monkeypatch):
    def fail(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(snippets.np, "savez_compressed", fail)
    with pytest.raises(OSError, match="disk full"):
        snippets.load_read_snippets(*read, 6, cache_dir=str(tmp_path / "cache"))
    assert list((tmp_path / "cache").iterdir()) == []
    monkeypatch.setattr(checkpoints.np, "savez", fail)
    with pytest.raises(OSError, match="disk full"):
        CheckpointManager(str(tmp_path)).save("run.01", {"w": torch.zeros(2)})
    assert list((tmp_path / "run.01").iterdir()) == []
