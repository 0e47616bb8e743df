"""The port's 'model' mesh axis (sequence-parallel attention memory,
ravvent_tpu_torch/parallel/{mesh,distributed}.py, models/attention.py,
training/loop.py with ``model_shards``) on the CPU, ranks spawned as gloo
process groups (tests/torch_ranks.py; each spawn bounded at 120 s):

- the attention over a memory sharded over 2 and 3 ranks against one
  process on the same memory, query and parameters, Luong and Bahdanau, S
  odd (uneven slices), a row whose positions are all masked and a row
  whose positions in one slice are all masked: context and alignments
  within 1e-6, and the gradients of the query, the memory and every
  attention parameter within 1e-5 of each one's largest magnitude;
- a 1 x 2 and a 2 x 2 grid's validation and train step against one
  process's, at teacher forcing 1.0 and at p = 0.5: the loss within 1e-5
  relative, each gradient leaf within 1e-5 of its largest magnitude, the
  validation's loss within 1e-5 relative and its accuracy within 1e-6,
  every rank's parameters bit-equal;
- the 2 x 2 grid against the JAX package's ``Trainer(small_cfg(),
  mesh=make_mesh(8, model_shards=2))`` on the same batch from its weights
  at teacher forcing 1.0, at tests/test_training.py:104-110's bars (loss
  1e-5, validation loss 1e-4, parameters rtol 2e-4 / atol 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.parallel.mesh import make_mesh as jmake_mesh
from ravvent_tpu.training.loop import Trainer as JTrainer
from ravvent_tpu_torch import weights
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.parallel import distributed
from ravvent_tpu_torch.parallel.mesh import memory_sharding
from ravvent_tpu_torch.training.loop import Trainer
from tests import torch_ranks
from tests.test_torch_distributed import SPAWN_TIMEOUT, skewed_batch
from tests.test_torch_training import dataset, port_cfg  # noqa: F401
from tests.test_training import small_cfg

torch.set_num_threads(1)
B, W, S, E, U = 4, 2, 7, 6, 5  # S odd: the slices are uneven


def attention_case(kind: str, seed: int):
    """(name, type, params, memory, mask, query, cotangent) as numpy: row 0
    all masked, row 1 masked past position 2 (so a later slice is all
    masked), rows 2-3 with a few masked positions."""
    rng = np.random.default_rng(seed)
    params = {"memory_kernel": rng.normal(size=(E, U)).astype(np.float32) * 0.5}
    if kind == "bahdanau":
        params["query_kernel"] = rng.normal(size=(U, U)).astype(np.float32) * 0.5
        params["attention_v"] = rng.normal(size=(U,)).astype(np.float32)
    mask = rng.random((B, S)) < 0.8
    mask[0], mask[1] = False, np.arange(S) < 2
    memory = rng.normal(size=(B, S, E)).astype(np.float32)
    query = rng.normal(size=(B, W, U)).astype(np.float32)
    cot = rng.normal(size=(B, W, E)).astype(np.float32)
    return kind, kind, params, memory, mask, query, cot


CASES = [attention_case("luong", 0), attention_case("bahdanau", 1)]


@pytest.fixture(scope="module")
def attention_runs(tmp_path_factory):
    """Each row size k's ranks' outputs, spawned once for both cases."""
    runs = {}
    for k in (2, 3):
        d = tmp_path_factory.mktemp(f"attn{k}")
        distributed.spawn(torch_ranks.attention_rank, k, (str(d), CASES), init_dir=d,
                          timeout=SPAWN_TIMEOUT)
        runs[k] = [dict(np.load(d / f"attn{r}.npz")) for r in range(k)]
    return runs


def assert_close_to_scale(got, want, tol, what):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} * {scale:.3e}"


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_sharded_attention_matches_one_process(attention_runs, case, k):
    name, kind, params, memory, mask, query, cot = case
    p = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    m = torch.tensor(memory, requires_grad=True)
    q = torch.tensor(query, requires_grad=True)
    context, align = attn.attend_beams(p, kind, q, attn.setup_memory(p, m, torch.tensor(mask)))
    grads = torch.autograd.grad((context * torch.tensor(cot)).sum(), [q, m] + list(p.values()))
    # the all-masked row stays uniform over the real S positions
    np.testing.assert_allclose(align[0].detach().numpy(), 1.0 / S, rtol=1e-6)
    ranks = attention_runs[k]
    got_align = np.zeros_like(align.detach().numpy())
    for j, r in enumerate(ranks):
        np.testing.assert_allclose(r[name + "/context"], context.detach().numpy(), rtol=1e-6,
                                   atol=1e-6)
        got_align[:, :, memory_sharding(k, j, S)] = r[name + "/align"]
        for key, g in zip(["query", "memory"] + list(p), grads):
            got = r[f"{name}/grad/{key}"]
            assert np.array_equal(got, ranks[0][f"{name}/grad/{key}"]), (j, key)
            assert_close_to_scale(got, g.numpy(), 1e-5, key)
    np.testing.assert_allclose(got_align, align.detach().numpy(), rtol=1e-6, atol=1e-6)


def test_memory_sharding_splits_any_s():
    assert memory_sharding(1, 0, 230) is None
    assert [memory_sharding(2, j, 7) for j in range(2)] == [slice(0, 4), slice(4, 7)]
    assert [memory_sharding(3, j, 230) for j in range(3)] == [slice(0, 77), slice(77, 154),
                                                               slice(154, 230)]
    with pytest.raises(ValueError, match="model shards"):
        memory_sharding(4, 0, 3)


P_VALUES = (0.0, 0.5)


@pytest.fixture(scope="module")
def grid_runs(dataset, tmp_path_factory):  # noqa: F811
    """Runs of tests/torch_ranks.py:grid_rank from the JAX trainer's
    weights, one spawn for each grid (data shards, model shards) making
    every p of ``P_VALUES``: ``run(n_data, n_model)[p]`` is its ranks'."""
    batch = skewed_batch(dataset)
    jtr = JTrainer(small_cfg(), mesh=jmake_mesh(8, model_shards=2))
    start = weights.flatten(weights.from_jax_params(
        jax.tree_util.tree_map(np.asarray, jtr.params)))
    runs = {}

    def run(n_data: int, n_model: int):
        if (n_data, n_model) not in runs:
            d = tmp_path_factory.mktemp(f"grid{n_data}x{n_model}")
            cfgs = [grid_cfg(p, n_data) for p in P_VALUES]
            distributed.spawn(torch_ranks.grid_rank, n_data * n_model,
                              (str(d), cfgs, n_model, start, batch), init_dir=d,
                              timeout=SPAWN_TIMEOUT)
            runs[n_data, n_model] = {p: [np.load(d / f"rank{r}_{i}.npz")
                                         for r in range(n_data * n_model)]
                                     for i, p in enumerate(P_VALUES)}
        return runs[n_data, n_model]

    return run, jtr, start, batch


def grid_cfg(p: float, n_data: int = 1):
    cfg = port_cfg(small_cfg())
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, teacher_forcing=p if p else 1.0, num_data_shards=n_data))


@pytest.mark.parametrize("grid", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
@pytest.mark.parametrize("p", P_VALUES, ids=["teacher", "sampled"])
def test_grid_step_matches_one_process(grid_runs, grid, p):
    run, _, start, batch = grid_runs
    ranks = run(*grid)[p]
    one = Trainer(grid_cfg(p), params=weights.unflatten(start), device="cpu")
    assert one.sampling_probability == p
    v = one.validate_on_batch(batch)
    out, grads = one.loss_and_grads(batch)
    one.apply_gradients(grads)
    g1, p1 = weights.flatten(grads), weights.flatten(one.params)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(float(got["loss"]), float(out.loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(float(got["acc"]), float(out.acc), atol=1e-6)
        np.testing.assert_allclose(got["val"][0], float(v["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["val"][1], float(v["acc"]), atol=1e-6)
        for k, want in g1.items():
            assert_close_to_scale(got["grad/" + k], want, 1e-5, k)
        for k, want in p1.items():
            np.testing.assert_allclose(got["param/" + k], want, rtol=2e-4, atol=1e-6)
            assert np.array_equal(got["param/" + k], ranks[0]["param/" + k]), (r, k)


def test_grid_step_matches_jax_sequence_parallel_trainer(grid_runs):
    """The 2 x 2 grid against the JAX trainer on its (4 data x 2 model)
    mesh, both from the JAX trainer's weights, at teacher forcing 1.0."""
    run, jtr, _, batch = grid_runs
    assert jtr.mesh.shape == {"data": 4, "model": 2}
    ranks = run(2, 2)[0.0]
    jv = jtr.validate_on_batch(batch)
    jm = jtr.train_on_batch(batch)
    jp = weights.flatten(weights.from_jax_params(jax.tree_util.tree_map(np.asarray, jtr.params)))
    for got in ranks:
        np.testing.assert_allclose(float(got["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(got["val"][0], float(jv["loss"]), rtol=1e-4)
        for k, want in jp.items():
            np.testing.assert_allclose(got["param/" + k], want, rtol=2e-4, atol=1e-6)
