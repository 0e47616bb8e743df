"""Multi-process runs of the port (ravvent_tpu_torch/parallel/distributed.py,
data-parallel training in training/loop.py, entry.py) on the CPU, ranks
spawned as gloo process groups (parallel.distributed.spawn, a file://
rendezvous under tmp_path, each spawning test bounded at 120 s).

- the file sharding and the result framing equal the JAX package's
  (ravvent_tpu/parallel/distributed.py) on the same index and payloads;
- gather_read_results over 2 ranks with a 10-byte and a >1 MB payload;
- data-parallel training over 2 and 4 ranks against one process's step on
  the global batch, at tests/test_training.py:66-86's bars (loss 1e-5
  relative; parameters rtol 2e-4, atol 1e-6; the ranks' parameters equal
  bit for bit), with scheduled sampling, on a batch whose shards differ in
  non-pad count and whose longest target lies in one shard; validation
  within 1e-5;
- the port's single-process step against the JAX Trainer's 8-device
  data-parallel step (the carried weights, p = 0: 1e-4 relative, as
  tests/test_torch_training.py holds the 1-device step);
- entry() against __graft_entry__.entry() with the same weights and
  jax.random's draws (loss 1e-5 relative), and the dry run on the CPU at 2
  ranks and on a 2 x 2 grid.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ravvent_tpu.data.generator import SnippetBatchGenerator as JGenerator
from ravvent_tpu.models import basecaller as jbc
from ravvent_tpu.parallel import distributed as jdist
from ravvent_tpu.parallel.mesh import make_mesh as jmake_mesh
from ravvent_tpu.training.loop import Trainer as JTrainer
from ravvent_tpu_torch import entry, weights
from ravvent_tpu_torch.parallel import distributed
from ravvent_tpu_torch.training.loop import Trainer
from tests import torch_ranks
from tests.test_torch_training import dataset, jax_draws, port_cfg  # noqa: F401
from tests.test_training import small_cfg

SPAWN_TIMEOUT = 120.0
INDEX = [{"signal_path": f"r{i}.signal", "snippets_num": n}
         for i, n in enumerate([100, 900, 300, 500, 250, 40, 0, 777])]
PAYLOADS = [[{"signal_path": "a.signal", "identity": 0.91}],  # a few bytes
            [{"signal_path": f"r{i}.signal", "seq": "ACGT" * 256} for i in range(1100)]]


@pytest.mark.parametrize("count", [1, 2, 3])
def test_file_sharding_matches_jax(tmp_path, count):
    p = tmp_path / "fi.json"
    p.write_text(json.dumps(INDEX))
    for pid in range(count):
        assert distributed.shard_files_info(p, pid, count) == jdist.shard_files_info(p, pid, count)
        assert (distributed.balanced_shard_files_info(p, pid, count)
                == jdist.balanced_shard_files_info(p, pid, count))
    # no process group: this process is rank 0 of 1 and owns every read
    assert distributed.process_info() == (0, 1)
    assert distributed.shard_files_info(p) == INDEX
    assert distributed.local_batch_slice(8) == jdist.local_batch_slice(8) == slice(0, 8)


def test_framing_round_trip_matches_jax():
    payloads = [json.dumps(r).encode() for r in PAYLOADS + [[]]]
    sizes = [len(p) for p in payloads]
    assert min(sizes) <= 10 and max(sizes) > (1 << 20)
    width = max(sizes)
    rows = np.stack([distributed.frame_payload(p, width) for p in payloads])
    assert np.array_equal(rows, np.stack([jdist.frame_payload(p, width) for p in payloads]))
    out = distributed.unframe_results(rows, sizes)
    assert out == PAYLOADS[0] + PAYLOADS[1] == jdist.unframe_results(rows, sizes)
    with pytest.raises(ValueError):
        distributed.frame_payload(payloads[1], 1 << 20)


def test_initialize_single_process_and_backend_checks():
    distributed.initialize("file:///nonexistent", 1, 0, "gloo")  # world size 1: a no-op
    assert distributed.process_info() == (0, 1)
    assert distributed.gather_read_results(PAYLOADS[0]) == PAYLOADS[0]
    with pytest.raises(ValueError, match="backend"):
        distributed.initialize("file:///nonexistent", 2, 0, "mpi")


def test_collectives_cross_on_the_backends_device(monkeypatch):
    """Under NCCL a host tensor (the trainer's generator state is a CPU
    ByteTensor on any device) crosses on the current card, under gloo a
    card's tensor crosses on the host: the collective gets a copy on that
    device and the result comes back into the tensor given. The
    collectives are faked; they record what they are given."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(distributed.dist, "get_backend", lambda: "nccl")
    assert distributed._wire_device() == torch.device("cuda", 3)
    monkeypatch.setattr(distributed.dist, "get_backend", lambda: "gloo")
    assert distributed._wire_device() == torch.device("cpu")
    seen = []
    monkeypatch.setattr(distributed.dist, "broadcast", lambda x, src: seen.append(x) or x.fill_(7))
    monkeypatch.setattr(distributed.dist, "all_reduce", lambda x, op: seen.append(x) or x.fill_(5))
    state = torch.Generator().get_state()
    # a wire device other than the tensor's (on the card's machine: cuda:r)
    monkeypatch.setattr(distributed, "_wire_device", lambda: torch.device("cpu", 0))
    assert distributed.broadcast(state, 0) is state and bool((state == 7).all())
    assert seen[-1] is not state and seen[-1].data_ptr() != state.data_ptr()
    assert distributed.all_reduce(state, "max") is state and bool((state == 5).all())
    assert seen[-1] is not state
    # the tensor already on the wire's device: the collective runs on it
    monkeypatch.setattr(distributed, "_wire_device", lambda: torch.device("cpu"))
    assert distributed.all_reduce(state) is state and seen[-1] is state


def test_gather_read_results_over_two_ranks(tmp_path):
    distributed.spawn(torch_ranks.gather_rank, 2, (str(tmp_path), PAYLOADS), init_dir=tmp_path,
                      timeout=SPAWN_TIMEOUT)
    for r in range(2):
        assert json.loads((tmp_path / f"gather{r}.json").read_text()) == PAYLOADS[0] + PAYLOADS[1]


def test_spawn_raises_when_a_rank_fails(tmp_path):
    with pytest.raises(Exception, match="subscriptable"):
        distributed.spawn(torch_ranks.gather_rank, 2, (str(tmp_path), None), init_dir=tmp_path,
                          timeout=SPAWN_TIMEOUT)


def skewed_batch(dataset):
    """8 rows of the JAX generator's first batch ordered by non-pad target
    count, so that every split of 2 or 4 shards differs in its count and
    the longest target lies in the last shard alone."""
    d, fi = dataset
    raw, event, targets = JGenerator(fi, stride=6, batch_size=8, shuffle=False,
                                     cache_dir=str(d / "jcache"))[0]
    order = np.argsort((targets != 0).sum(axis=1), kind="stable")
    return raw[order], event[order], targets[order]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("p", [0.0, 0.5], ids=["teacher", "sampled"])
def test_dp_trainer_matches_one_process(dataset, tmp_path, n, p):  # noqa: F811
    batch = skewed_batch(dataset)
    counts = (batch[2][:, 1:] != 0).sum(axis=1)
    shards = np.split(counts, n)
    assert len({int(s.sum()) for s in shards}) > 1  # the shards' normalizers differ
    assert counts.max() in shards[-1] and all(s.max() < counts.max() for s in shards[:-1])
    cfg = port_cfg(small_cfg())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                             teacher_forcing=p if p else 1.0))
    params = weights.flatten(Trainer(cfg, device="cpu", seed=7).params)
    dp_cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_data_shards=n))
    distributed.spawn(torch_ranks.dp_rank, n, (str(tmp_path), dp_cfg, params, batch, 2),
                      init_dir=tmp_path, timeout=SPAWN_TIMEOUT)

    one = Trainer(cfg, params=weights.unflatten(params), device="cpu")
    assert one.sampling_probability == p
    ms = [one.train_on_batch(batch) for _ in range(2)]
    v = one.validate_on_batch(batch)
    ref = weights.flatten(one.params)
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(n)]
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["loss"], [float(m["loss"]) for m in ms], rtol=1e-5)
        np.testing.assert_allclose(got["acc"], [float(m["acc"]) for m in ms], rtol=1e-6)
        np.testing.assert_allclose(got["val"], [float(v["loss"]), float(v["acc"])], rtol=1e-5)
        for k, want in ref.items():
            np.testing.assert_allclose(got["param/" + k], want, rtol=2e-4, atol=1e-6)
            assert np.array_equal(got["param/" + k], ranks[0]["param/" + k]), (r, k)


def test_dp_fit_writes_on_rank_zero_only(dataset, tmp_path):  # noqa: F811
    batch = skewed_batch(dataset)
    params = weights.flatten(Trainer(port_cfg(small_cfg()), device="cpu").params)
    cfg = port_cfg(small_cfg())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_data_shards=2,
                                                             teacher_forcing=0.5))
    fit_dir = tmp_path / "fit"
    fit_dir.mkdir()
    distributed.spawn(torch_ranks.dp_rank, 2, (str(tmp_path), cfg, params, batch, 1, str(fit_dir)),
                      init_dir=tmp_path, timeout=SPAWN_TIMEOUT)
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in range(2))
    assert np.array_equal(r0["fit"], r1["fit"]) and np.isfinite(r0["fit"]).all()
    assert (fit_dir / "log0.csv").exists() and not (fit_dir / "log1.csv").exists()
    assert len(list((fit_dir / "ckpt").iterdir())) == 1


def test_trainer_refuses_data_parallel_without_a_process_group():
    cfg = port_cfg(small_cfg())
    dp = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_data_shards=2))
    with pytest.raises(RuntimeError, match="parallel.distributed.initialize"):
        Trainer(dp, device="cpu")


def test_one_process_step_tracks_jax_dp_trainer(dataset):  # noqa: F811
    """The JAX trainer on its 8-device mesh (the batch sharded, XLA summing
    the gradients) against the port's one-process step from its weights."""
    batch = skewed_batch(dataset)
    cfg = small_cfg()
    jtr = JTrainer(cfg, mesh=jmake_mesh(8))
    tr = Trainer(port_cfg(cfg), params=weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jtr.params)), device="cpu")
    for _ in range(2):
        jm, tm = jtr.train_on_batch(batch), tr.train_on_batch(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]), atol=1e-6)
    jv, tv = jtr.validate_on_batch(batch), tr.validate_on_batch(batch)
    np.testing.assert_allclose(float(tv["loss"]), float(jv["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tv["acc"]), float(jv["acc"]), atol=1e-5)


def test_entry_matches_graft_entry():
    jfn, (jparams, raw, event, targets, rng) = graft.entry()
    fn, (params, traw, tevent, ttargets, gen) = entry.entry(device="cpu")
    assert np.array_equal(traw.numpy(), np.asarray(raw))
    assert np.array_equal(tevent.numpy(), np.asarray(event))
    assert np.array_equal(ttargets.numpy(), np.asarray(targets))
    jl, jacc = jax.jit(jfn)(jparams, raw, event, targets, rng)
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jparams))
    draws = jax_draws(rng, targets.shape[1] - 1, targets.shape[0], 0.5)
    tl, tacc = fn(tp, traw, tevent, ttargets, draws=draws)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tacc), float(jacc), atol=1e-6)
    # the port's own seeded weights and generator: a finite loss
    loss, acc = fn(params, traw, tevent, ttargets, gen)
    assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0


def test_dryrun_multichip_on_the_cpu(capfd):
    entry.dryrun_multichip(2, device="cpu", timeout=SPAWN_TIMEOUT)
    assert "bit-equal to one device" in capfd.readouterr().out


def test_dryrun_multichip_on_a_grid_on_the_cpu(capfd):
    """At 4 ranks the dry run trains on a 2 x 2 grid (model_shards=2), as
    __graft_entry__.dryrun_multichip(4) does, and rank 0's sharded decodes
    over that mesh stay bit-equal to one device."""
    entry.dryrun_multichip(4, device="cpu", timeout=SPAWN_TIMEOUT)
    out = capfd.readouterr().out
    assert "mesh={'data': 2, 'model': 2}" in out and "bit-equal to one device" in out


def test_greedy_all_finished_stop_is_the_global_batchs():
    """Validation's greedy stop under data parallelism: rows ending at
    steps 1, 2, 5 and 7, split into halves that end at 2 and 7. A half
    alone stops emitting after step 2; with ``reduce`` giving the other
    half's all-finished steps (what the all-reduce's minimum returns) it
    emits what the whole batch emits."""
    from ravvent_tpu_torch.decode.greedy import greedy_loop

    ends, V, T = torch.tensor([1, 2, 5, 7]), 7, 10

    def run(rows, reduce=None):
        t = 0

        def step(cur):
            nonlocal t
            logits = torch.zeros(len(rows), V)
            logits[:, 3 + t % 3] = 1.0
            logits[ends[rows] == t, 1] = 2.0  # the end token
            t += 1
            return logits

        return greedy_loop(step, len(rows), V, T, None, 2, 1, "cpu", reduce)

    whole = run([0, 1, 2, 3])
    seen = {}

    def recording(key):
        def reduce(t, op):
            assert op == "min"
            seen[key] = t.clone()
            return t
        return reduce

    alone = run([0, 1], recording("a"))
    run([2, 3], recording("b"))
    assert not torch.equal(alone[0], whole[0][:2])  # the half's own stop differs
    both = torch.minimum(seen["a"], seen["b"])
    halves = [run(rows, lambda t, op: t.copy_(both)) for rows in ([0, 1], [2, 3])]
    for i in range(2):
        assert torch.equal(torch.cat([h[i] for h in halves]), whole[i])
