"""Training in the port (ravvent_tpu_torch/training, models/basecaller.py's
train_forward, models/decoder.py's teacher_forced_decode, utils/masking.py's
losses, data/generator.py) against the JAX package on the CPU, on the same
numpy inputs and carried weights (weights.from_jax_params), at
tests/test_training.py's small config (enc 16, depth 1, batch 8).

Tolerances: losses 1e-6; decode logits 1e-5 with equal tokens;
train_forward's loss 1e-5 relative and each gradient leaf within 1e-4 of
that leaf's largest jax.grad magnitude; Adam's parameters 1e-6 relative;
three train steps' losses 1e-4 relative; validation loss and accuracy 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ravvent_tpu.data import chiron as jchiron
from ravvent_tpu.data import simulator as jsim
from ravvent_tpu.data.generator import SnippetBatchGenerator as JGenerator
from ravvent_tpu.models import attention as jattn
from ravvent_tpu.models import basecaller as jbc
from ravvent_tpu.models import decoder as jdec
from ravvent_tpu.parallel.mesh import make_mesh
from ravvent_tpu.training import checkpoints as jckpt
from ravvent_tpu.training.loop import Trainer as JTrainer
from ravvent_tpu.training.loop import per_leaf_clip_by_norm as jclip
from ravvent_tpu.utils import masking as jmask
from ravvent_tpu_torch import config as tconfig
from ravvent_tpu_torch import weights
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.models import attention as tattn
from ravvent_tpu_torch.models import basecaller as tbc
from ravvent_tpu_torch.models import decoder as tdec
from ravvent_tpu_torch.training.checkpoints import CheckpointManager, rename_model_epochs
from ravvent_tpu_torch.training.loop import (
    Trainer, make_optimizer, per_leaf_clip_by_norm, tree_leaves, tree_unflatten,
)
from ravvent_tpu_torch.utils import masking as tmask
from tests.test_training import small_cfg

V = 7


def port_cfg(jcfg):
    """The port's RunConfig with the JAX one's fields."""
    d = dataclasses.asdict(jcfg)
    return tconfig.RunConfig(data=tconfig.DataConfig(**d["data"]),
                             model=tconfig.ModelConfig(**d["model"]),
                             train=tconfig.TrainConfig(**d["train"]))


def flat(tree):
    """{"a/b/c": f32 array} of a tree with JAX, numpy or torch leaves."""
    return weights.flatten(tree)


def assert_leaves_close(got, ref, tol):
    """Each leaf of ``got`` within ``tol`` times the largest magnitude of
    the same leaf of ``ref``."""
    g, r = flat(got), flat(ref)
    assert g.keys() == r.keys()
    for k in r:
        scale = max(float(np.abs(r[k]).max()), 1e-30)
        err = float(np.abs(g[k] - r[k]).max())
        assert err <= tol * scale, f"{k}: {err:.3e} > {tol} * {scale:.3e}"


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    genome = jsim.random_genome(5000, np.random.default_rng(0))
    jsim.generate_chiron_dataset(d, genome, n_reads=3, read_len_range=(900, 1200), seed=1)
    return d, jchiron.create_files_info(d, stride=6, verbose=False)


@pytest.fixture(scope="module")
def batch(dataset):
    d, fi = dataset
    return JGenerator(fi, stride=6, batch_size=8, shuffle=False, cache_dir=str(d / "jcache"))[0]


@pytest.fixture(scope="module")
def jax_params():
    return jbc.init_basecaller(jax.random.PRNGKey(3), small_cfg().model)


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(6, 11, V)).astype(np.float32) * 3
    real = rng.integers(0, V, (6, 11))
    real[:, 8:] = 0  # pad tail
    pred = np.where(rng.random((6, 11)) < 0.5, real, rng.integers(0, V, (6, 11)))
    extra = rng.random((6, 11)) < 0.7
    jl, jr, jp, je = (jnp.asarray(x) for x in (logits, real, pred, extra))
    tl, tr, tp, te = (torch.from_numpy(x) for x in (logits, real, pred, extra))
    pairs = [
        (jmask.masked_ce_loss(jr, jl), tmask.masked_ce_loss(tr, tl)),
        (jmask.masked_ce_loss_sum(jr, jl), tmask.masked_ce_loss_sum(tr, tl)),
        (jmask.masked_accuracy(jr, jp, [0, 1, 2]), tmask.masked_accuracy(tr, tp, [0, 1, 2])),
        (jmask.masked_accuracy(jr, jp, [1, 2], extra_mask=je),
         tmask.masked_accuracy(tr, tp, [1, 2], extra_mask=te)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6, atol=1e-6)
    # all positions masked: 0, not a division by zero
    assert float(tmask.masked_ce_loss(torch.zeros(2, 3, dtype=torch.int64), tl[:2, :3])) == 0.0


def memories(jax_params, batch, cfg):
    """The un-projected f32 memory of ``batch`` in both packages."""
    raw, event, _ = batch
    jenc, jm = jbc.encode_input(jax_params, jnp.asarray(raw), jnp.asarray(event), cfg,
                                trainable=True)
    jmem = jattn.setup_memory(jax_params["decoder"]["attention"], jenc, jm)
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params))
    tenc, tm = tbc.encode_input(tp, torch.from_numpy(raw), torch.from_numpy(event), cfg,
                                trainable=True)
    return jmem, tattn.setup_memory(tp["decoder"]["attention"], tenc, tm), tp


def jax_draws(rng, T, B, p):
    """The draws jax's teacher_forced_decode makes from ``rng``: split into
    T keys, each split into (select, sample) keys."""
    select, gumbel = [], []
    for k in jax.random.split(rng, T):
        ksel, ksamp = jax.random.split(k)
        select.append(np.asarray(jax.random.bernoulli(ksel, p, (B,))))
        gumbel.append(np.asarray(jax.random.gumbel(ksamp, (B, V))))
    return torch.from_numpy(np.stack(select)), torch.from_numpy(np.stack(gumbel))


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_teacher_forced_decode_matches_jax(jax_params, batch, p):
    cfg = small_cfg().model
    jmem, tmem, tp = memories(jax_params, batch, cfg)
    dec_in = batch[2][:, :-1]
    rng = jax.random.PRNGKey(11)
    jlog, jids = jdec.teacher_forced_decode(jax_params["decoder"], jnp.asarray(dec_in), jmem, V,
                                            sampling_probability=p, rng=rng)
    draws = jax_draws(rng, dec_in.shape[1], dec_in.shape[0], p) if p else None
    tlog, tids = tdec.teacher_forced_decode(tp["decoder"], torch.from_numpy(dec_in), tmem, V,
                                            sampling_probability=p, draws=draws)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tlog.detach().numpy(), np.asarray(jlog), rtol=1e-5, atol=1e-5)
    if p:
        ids = tids.numpy()
        assert (ids == -1).any() and (ids >= 0).any()  # both kinds of step occur
        # the generator's own draws run and mark unsampled rows likewise
        glog, gids = tdec.teacher_forced_decode(
            tp["decoder"], torch.from_numpy(dec_in), tmem, V, sampling_probability=p,
            gen=torch.Generator().manual_seed(0))
        assert glog.shape == tlog.shape and ((gids == -1) | ((gids >= 0) & (gids < V))).all()
        with pytest.raises(ValueError):
            tdec.teacher_forced_decode(tp["decoder"], torch.from_numpy(dec_in), tmem, V,
                                       sampling_probability=p)


def test_trainable_encoder_matches_inference_path_and_takes_no_weights(jax_params, batch):
    cfg = small_cfg().model
    tp = weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jax_params))
    raw, event = (torch.from_numpy(x) for x in batch[:2])
    got, mask = tbc.encode_input(tp, raw, event, cfg, trainable=True)
    ref, ref_mask = tbc.encode_input(tp, raw, event, cfg)
    assert torch.equal(got, ref) and torch.equal(mask, ref_mask)
    with pytest.raises(ValueError):
        from ravvent_tpu_torch.models.rnn import encoder_apply, stream_weights

        encoder_apply(tp["encoder_raw"], raw, stream_weights(tp["encoder_raw"]), trainable=True)


@pytest.mark.parametrize("p", [0.0, 0.5])
def test_train_forward_loss_and_grads_match_jax(jax_params, batch, p):
    cfg = small_cfg().model
    raw, event, targets = batch
    rng = jax.random.PRNGKey(5)

    def jloss(params):
        out = jbc.train_forward(params, jnp.asarray(raw), jnp.asarray(event),
                                jnp.asarray(targets), cfg, p, rng if p else None)
        return out.loss, out.acc

    (jl, jacc), jg = jax.value_and_grad(jloss, has_aux=True)(jax_params)
    tp = jax.tree_util.tree_map(
        lambda x: torch.tensor(np.asarray(x), requires_grad=True), jax_params)
    draws = jax_draws(rng, targets.shape[1] - 1, targets.shape[0], p) if p else None
    out = tbc.train_forward(tp, torch.from_numpy(raw), torch.from_numpy(event),
                            torch.from_numpy(targets), cfg, p, draws=draws)
    grads = torch.autograd.grad(out.loss, tree_leaves(tp))
    np.testing.assert_allclose(float(out.loss.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(out.acc), float(jacc), rtol=1e-6)
    assert all(float(g.abs().max()) > 0 for g in grads)  # every leaf learns
    assert_leaves_close(tree_unflatten(tp, grads), jg, 1e-4)
    loss, aux = tbc.loss_fn(tp, tuple(torch.from_numpy(x) for x in batch), cfg)
    if not p:
        assert torch.equal(loss, out.loss) and torch.equal(aux.acc, out.acc)


def test_val_metrics_and_batch_max_len_match_jax(batch):
    rng = np.random.default_rng(1)
    targets = batch[2]
    B, T = targets.shape
    logits = rng.normal(size=(B, T - 1, V)).astype(np.float32)
    tokens = np.where(rng.random((B, T - 1)) < 0.6, targets[:, 1:],
                      rng.integers(0, V, (B, T - 1))).astype(np.int32)
    jl, ja = jbc.val_metrics(jnp.asarray(targets[:, 1:]), jnp.asarray(tokens),
                             jnp.asarray(logits), jnp.asarray(targets))
    tt = torch.from_numpy(targets)
    tl, ta = tbc.val_metrics(tt[:, 1:], torch.from_numpy(tokens), torch.from_numpy(logits), tt)
    np.testing.assert_allclose([float(tl), float(ta)], [float(jl), float(ja)], rtol=1e-6)
    assert int(tbc.batch_max_target_len(tt)) == int(jbc.batch_max_target_len(jnp.asarray(targets)))


def test_per_leaf_clip_by_norm():
    t = jclip(1.0)
    g = {"a": np.array([3.0, 4.0], np.float32), "b": np.array([0.1, 0.1], np.float32)}
    jc, _ = t.update(jax.tree_util.tree_map(jnp.asarray, g), t.init(g))
    tc = per_leaf_clip_by_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    np.testing.assert_allclose(tc["a"].numpy(), [0.6, 0.8], rtol=1e-6)
    np.testing.assert_allclose(tc["b"].numpy(), [0.1, 0.1], rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-6)


def test_adam_matches_optax():
    rng = np.random.default_rng(2)
    shapes = {"w": (5, 9), "b": (9,), "cells": [(3, 4)]}
    params = {"w": rng.normal(size=(5, 9)), "b": rng.normal(size=9) * 0.1,
              "cells": [rng.normal(size=(3, 4))]}
    params = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), params)
    jopt = optax.chain(jclip(1.0), optax.adam(1e-2))
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jopt.init(jp)
    topt = make_optimizer(1e-2, clipnorm=1.0)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    ts = topt.init(tp)
    for step in range(5):
        # large gradients clip; the small ones do not
        scale = 10.0 if step % 2 else 0.01
        g = jax.tree_util.tree_map(
            lambda s: (rng.normal(size=s) * scale).astype(np.float32), shapes,
            is_leaf=lambda s: isinstance(s, tuple))
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update(jax.tree_util.tree_map(torch.from_numpy, g), ts)
        tp = jax.tree_util.tree_map(lambda p, u: p + u, tp, tu)
    assert ts.count == 5
    for a, b in zip(jax.tree_util.tree_leaves(jp), jax.tree_util.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-7)


def test_trainer_steps_track_jax_trainer(batch):
    cfg = small_cfg()
    jtr = JTrainer(cfg, mesh=make_mesh(1))
    tr = Trainer(port_cfg(cfg), params=weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jtr.params)), device="cpu")
    assert tr.sampling_probability == jtr.sampling_probability == 0.0
    for _ in range(3):
        jm, tm = jtr.train_on_batch(batch), tr.train_on_batch(batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["acc"]), float(jm["acc"]), atol=1e-6)
    assert tr.opt_state.count == 3
    jv, tv = jtr.validate_on_batch(batch), tr.validate_on_batch(batch)
    np.testing.assert_allclose(float(tv["loss"]), float(jv["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tv["acc"]), float(jv["acc"]), atol=1e-5)


def test_validate_on_batch_matches_jax_val_step(jax_params, batch):
    cfg = small_cfg()
    jtr = JTrainer(cfg, mesh=make_mesh(1))
    jtr.params = jax_params
    tr = Trainer(port_cfg(cfg), params=weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jax_params)), device="cpu")
    jv, tv = jtr.validate_on_batch(batch), tr.validate_on_batch(batch)
    np.testing.assert_allclose(float(tv["loss"]), float(jv["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tv["acc"]), float(jv["acc"]), atol=1e-5)


def test_trainer_options():
    cfg = port_cfg(small_cfg())
    sched = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, teacher_forcing=0.5))
    assert Trainer(sched, device="cpu").sampling_probability == 0.5
    dp = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_data_shards=2))
    with pytest.raises(RuntimeError, match="initialize a process group"):
        Trainer(dp, device="cpu")  # data-parallel needs an initialized process group
    # seeded weights repeat
    a, b = Trainer(cfg, device="cpu", seed=4), Trainer(cfg, device="cpu", seed=4)
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a.params), tree_leaves(b.params)))


def test_fit_learns_validates_and_checkpoints(dataset, tmp_path):
    d, fi = dataset
    cfg = port_cfg(small_cfg())
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, teacher_forcing=0.5))
    tr = Trainer(cfg, device="cpu")
    gen = SnippetBatchGenerator(fi, stride=6, batch_size=8, cache_dir=str(d / "tcache"))
    val = SnippetBatchGenerator(fi, stride=6, batch_size=8, cache_dir=str(d / "tcache"))
    steps = []
    hist = tr.fit(gen, val, epochs=2, steps_per_epoch=25, validation_steps=4,
                  csv_log_path=str(tmp_path / "log.csv"),
                  checkpoint_manager=CheckpointManager(str(tmp_path)),
                  batch_callbacks=[lambda i, m: steps.append(m["loss"])], verbose=False)
    assert hist["loss"][-1] < hist["loss"][0]
    assert np.isfinite(hist["val_loss"][-1]) and 0.0 <= hist["val_acc"][-1] <= 1.0
    np.testing.assert_allclose(hist["loss"], [np.mean(steps[:25]), np.mean(steps[25:])],
                               rtol=1e-6)
    lines = open(tmp_path / "log.csv").read().strip().splitlines()
    assert len(lines) == 3 and lines[0] == "epoch,acc,loss,val_acc,val_loss"
    run_dir, _, last = cfg.checkpoint_path(2).rpartition("/")
    assert CheckpointManager(str(tmp_path)).latest_epoch(run_dir, last[:-3]) == 2


def test_generator_matches_jax(dataset):
    d, fi = dataset
    kw = dict(stride=6, batch_size=8, initial_random_seed=3)
    jg = JGenerator(fi, cache_dir=str(d / "jcache"), **kw)
    tg = SnippetBatchGenerator(fi, cache_dir=str(d / "tcache"), **kw)
    for _ in range(2):
        np.testing.assert_array_equal(tg.fetch_ids, jg.fetch_ids)
        got, ref = list(tg.epoch()), list(jg.epoch())  # each runs to its plan's end
        assert len(got) == len(ref) == len(jg) > 0
        for a, b in zip(got, ref):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert tg.random_seed == jg.random_seed == 5


def test_checkpoint_roundtrip(dataset, batch, jax_params, tmp_path):
    d, fi = dataset
    cfg = port_cfg(small_cfg())
    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    tr = Trainer(cfg, params=weights.from_jax_params(tree), device="cpu")
    tr.train_on_batch(batch)
    cm = CheckpointManager(str(tmp_path))
    path = cfg.checkpoint_path(1)
    cm.save(path, tr.params, tr.opt_state, epoch=1, rng=tr.rng, data_seed=7)
    got = cm.restore(path)
    assert got["epoch"] == 1 and got["data_seed"] == 7 and got["opt_state"].count == 1
    assert torch.equal(got["rng"], tr.rng.get_state())
    for a, b in ((got["params"], tr.params), (got["opt_state"].mu, tr.opt_state.mu),
                 (got["opt_state"].nu, tr.opt_state.nu)):
        assert flat(a).keys() == flat(b).keys()
        for k, v in flat(b).items():
            np.testing.assert_array_equal(flat(a)[k], v)
    # the CLI's --weights reads the checkpoint's npz
    assert flat(weights.load_npz(tmp_path / path / "params.npz")).keys() == flat(tr.params).keys()
    # a new trainer from the checkpoint validates and trains exactly as the old
    tr2 = Trainer(cfg, device="cpu", seed=99)
    tr2.load_state(got)
    assert float(tr2.validate_on_batch(batch)["loss"]) == float(tr.validate_on_batch(batch)["loss"])
    assert float(tr2.train_on_batch(batch)["loss"]) == float(tr.train_on_batch(batch)["loss"])
    # untrained carried weights saved by the port read back as the JAX tree
    cm.save("carried", weights.from_jax_params(tree))
    back = cm.restore_numpy("carried")
    assert "opt_state" not in back and back["epoch"] == 0
    for k, v in flat(tree).items():
        np.testing.assert_array_equal(flat(back["params"])[k], v)


def test_latest_epoch_and_rename_model_epochs(tmp_path):
    cm = CheckpointManager(str(tmp_path))
    assert cm.latest_epoch("run", "model.1.x") is None
    for ep in (1, 2, 10):
        cm.save(f"run/model.1.x.{ep:02d}", {"w": torch.ones(2)}, epoch=ep)
    (tmp_path / "run" / "model.1.x.notes").mkdir()
    assert cm.latest_epoch("run", "model.1.x") == 10
    before = sorted(p.name for p in (tmp_path / "run").iterdir())
    got = rename_model_epochs(str(tmp_path / "run"), 5, dry_run=True)
    assert got == jckpt.rename_model_epochs(str(tmp_path / "run"), 5, dry_run=True)
    assert [new.rsplit(".", 1)[1] for _, new in got] == ["15", "07", "06"]
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == before
    rename_model_epochs(str(tmp_path / "run"), 5)
    assert cm.latest_epoch("run", "model.1.x") == 15
    assert cm.restore("run/model.1.x.06")["epoch"] == 1
