"""The port's multi-device code across distinct cards (NCCL process groups,
a mesh of cards), which the CPU tests (test_torch_parallel.py,
test_torch_distributed.py) and chip_smoke.py's phase 19 on one card cannot
show:

- NCCL moves a host tensor (the trainer's generator state) over the card
  (one card);
- gather_read_results over 2 NCCL ranks, one card each, with a 10-byte and
  a >1 MB payload;
- data-parallel training over 2 and 4 NCCL ranks, one card each, at the
  flagship's widths and TrainConfig's defaults (global batch 128, p = 0.5):
  a validation, then one step, against one process's on cuda:0; loss and
  validation within 1e-5 relative, the all-reduced gradients within 1e-5 of
  each leaf's largest magnitude, the ranks' parameters bit-equal; and the
  same on a 2 x 2 grid of NCCL ranks (data x model: the attention memory's
  positions sharded over each model row);
- the sharded engine over a mesh of every card, the flagship's widths and
  the bench's settings, against one card on 4 simulated reads: tokens and
  probabilities bit-equal on the compact wire (i8dev with its aux dict,
  dispatch/collect with every read in flight) and on sigdev; each replica's
  parameters and encoder weights on its own card. It prints both engines'
  ``run_pipelined`` walls.

Run them on a machine with cards (a one-card machine runs the first test
and skips the others with their reason):

    python -m pytest --noconftest tests/test_torch_multigpu.py -m gpu -q -s

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
lacks; this file needs neither.)
"""

import json
import subprocess
import time

import numpy as np
import pytest
import torch

from ravvent_tpu_torch.config import ModelConfig, RunConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.data.snippets import load_read_compact_ex
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from ravvent_tpu_torch.models.basecaller import init_basecaller
from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.parallel import distributed
from ravvent_tpu_torch.parallel.inference import ShardedBasecallEngine
from ravvent_tpu_torch.parallel.mesh import make_mesh
from ravvent_tpu_torch.tools.profile_decode import simulated_reads
from ravvent_tpu_torch.training.loop import Trainer
from ravvent_tpu_torch.weights import flatten
import torch_ranks  # tests/ is on pytest's path; a "tests" package may be installed

pytestmark = pytest.mark.gpu
SEED = 0
SPAWN_TIMEOUT = 600.0
PAYLOADS = [[{"signal_path": "a.signal", "identity": 0.91}],  # a few bytes
            [{"signal_path": f"r{i}.signal", "seq": "ACGT" * 256} for i in range(1100)]]
BENCH = dict(chunk_size=4096, memory_dtype=torch.bfloat16, beam_impl="step",
             encoder_dtype=torch.bfloat16, pack_u8=True, transport_dtype="i8dev", prob_bits=4)


def cards(n: int) -> int:
    """The machine's card count; skips when it has fewer than ``n``."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count < n:
        pytest.skip(f"needs {n} CUDA device(s), the machine has {count}")
    return count


def smi() -> str:
    """The cards' names and power limits, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().replace("\n", "; ")


def test_nccl_moves_host_tensors_over_the_card(tmp_path):
    cards(1)
    torch.distributed.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                                         world_size=1, rank=0)
    try:
        state = torch.Generator(device="cuda").manual_seed(5).get_state()
        assert state.device.type == "cpu"
        assert torch.equal(distributed.broadcast(state.clone(), 0), state)
        x = torch.arange(4.0)
        assert torch.equal(distributed.all_reduce(x.clone(), "sum"), x)
        y = torch.arange(4.0, device="cuda")
        assert torch.equal(distributed.all_reduce(y.clone(), "max"), y)
    finally:
        torch.distributed.destroy_process_group()


def test_nccl_gather_read_results_across_cards(tmp_path):
    cards(2)
    distributed.spawn(torch_ranks.gather_rank, 2, (str(tmp_path), PAYLOADS, "nccl"),
                      init_dir=tmp_path, timeout=SPAWN_TIMEOUT)
    for r in range(2):
        assert json.loads((tmp_path / f"gather{r}.json").read_text()) == PAYLOADS[0] + PAYLOADS[1]


@pytest.mark.parametrize("n", [2, 4])
def test_nccl_dp_step_matches_one_process(tmp_path, n):
    cards(n)
    step_against_one_process(tmp_path, n, 1)


def test_nccl_grid_step_matches_one_process(tmp_path):
    cards(4)
    step_against_one_process(tmp_path, 4, 2)


def step_against_one_process(tmp_path, n: int, model_shards: int):
    """n NCCL ranks, one card each, in a grid of n / model_shards data
    shards by model_shards model ranks, against one process on cuda:0."""
    params = init_basecaller(ModelConfig(), torch.Generator().manual_seed(SEED))
    start = flatten(params)
    genome = simulator.random_genome(20_000, np.random.default_rng(SEED))
    simulator.generate_chiron_dataset(tmp_path / "ds", genome, n_reads=2,
                                      read_len_range=(1500, 1800), seed=SEED + 1)
    fi = chiron.create_files_info(tmp_path / "ds", stride=6, verbose=False)
    cfg = RunConfig()
    batch = SnippetBatchGenerator(fi, stride=6, batch_size=cfg.train.batch_size, shuffle=False,
                                  cache_dir=str(tmp_path / "ds" / "cache"))[0]
    assert batch[2].shape[0] == 128 and cfg.train.teacher_forcing == 0.5

    one = Trainer(cfg, params=params)  # cuda:0; builds the kernels the ranks load
    v = one.validate_on_batch(batch)
    out, grads = one.loss_and_grads(batch)
    one.apply_gradients(grads)
    g1, p1 = flatten(grads), flatten(one.params)
    t0 = time.perf_counter()
    distributed.spawn(torch_ranks.card_dp_rank, n, (str(tmp_path), start, batch, model_shards),
                      init_dir=tmp_path, timeout=SPAWN_TIMEOUT)
    spawn_s = time.perf_counter() - t0
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(n)]
    loss1, lr = float(out.loss.detach()), cfg.train.learning_rate
    rel = abs(float(ranks[0]["loss"]) - loss1) / abs(loss1)
    gerr = {k: float(np.abs(ranks[0]["grad/" + k] - g1[k]).max())
            / max(float(np.abs(g1[k]).max()), 1e-30) for k in g1}
    worst = max(gerr, key=gerr.get)
    pdiff = max(float(np.abs(ranks[0]["param/" + k] - p1[k]).max()) for k in p1)
    print(f"\n  NCCL, {n // model_shards} x {model_shards} ranks (data x model) on cards "
          f"{[int(r['card']) for r in ranks]}, {128 // (n // model_shards)} rows each: loss "
          f"{float(ranks[0]['loss']):.7f} vs one process "
          f"{loss1:.7f}, rel {rel:.3e}; val {ranks[0]['val'].tolist()} vs "
          f"{[float(v['loss']), float(v['acc'])]}; gradients: worst leaf {worst} "
          f"{gerr[worst]:.3e} of its largest magnitude; parameters' largest difference from "
          f"one process {pdiff / lr:.4f} lr; spawn with its step {spawn_s:.2f} s [{smi()}]")
    assert [int(r["card"]) for r in ranks] == list(range(n))
    assert rel <= 1e-5
    assert abs(float(ranks[0]["acc"]) - float(out.acc)) <= 1e-6
    np.testing.assert_allclose(ranks[0]["val"], [float(v["loss"]), float(v["acc"])],
                               rtol=1e-5, atol=1e-6)
    assert gerr[worst] <= 1e-5, worst
    for r in ranks[1:]:
        for k in p1:
            assert np.array_equal(r["param/" + k], ranks[0]["param/" + k]), k


def on_card(tree, card: int) -> bool:
    if isinstance(tree, dict):
        return all(on_card(v, card) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(on_card(v, card) for v in tree)
    return not isinstance(tree, torch.Tensor) or tree.device == torch.device("cuda", card)


def test_sharded_engine_over_distinct_cards(tmp_path):
    n = cards(2)
    cfg = ModelConfig()
    params = init_basecaller(cfg, torch.Generator().manual_seed(SEED))
    one = BasecallEngine(params, cfg, **BENCH)
    mesh = make_mesh()
    sharded = ShardedBasecallEngine(params, cfg, mesh, **BENCH)
    assert mesh.devices == tuple(torch.device("cuda", i) for i in range(n))
    for i, shard in enumerate(sharded._shards):
        assert shard.device == torch.device("cuda", i)
        assert on_card(shard.params, i) and on_card(shard._enc_weights, i)
    reads = simulated_reads(SEED)
    paths = []
    for i, (raw, ranges, seq) in enumerate(reads):
        chiron.write_read(tmp_path / f"r{i}.signal", tmp_path / f"r{i}.label", raw, ranges, seq)
        paths.append(tmp_path / f"r{i}.signal")

    # the compact wire: every read in flight, then collected
    loaded = [load_read_compact_ex(p, p.with_suffix(".label"), stride=6) for p in paths]
    args = [(sig, rr, ev, er, int((nuc != 0).sum(axis=1).max()), 5)
            for sig, rr, ev, er, nuc, _ in loaded]
    auxes = [aux for *_, aux in loaded]
    wants = [one.predict_beam_compact(*a, aux=aux) for a, aux in zip(args, auxes)]
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    handles = [sharded.dispatch_beam_compact(*a, aux=aux) for a, aux in zip(args, auxes)]
    gots = [sharded.collect_beam_compact(h) for h in handles]
    counts = dict(cuda_lib.launches)
    for want, got in zip(wants, gots):
        for w, g in zip(want, got):
            assert w.shape == g.shape
            np.testing.assert_array_equal(w, g)
    cuda_lib.reset_launches()
    for a, aux in zip(args, auxes):
        one.predict_beam_compact(*a, aux=aux)
    for k in ("bilstm_bf16", "beam_cell", "beam_attend"):  # one chunk a read, on every card
        assert counts[k] == n * cuda_lib.launches[k] > 0, k

    # sigdev: the segmentation on cuda:0, each card its rows
    for raw, _, _ in reads:
        want = one.predict_beam_signal(raw, 40, 5, return_ranges=True)
        got = sharded.predict_beam_signal(raw, 40, 5, return_ranges=True)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)

    # the pipelined path's wall, one card against the mesh (no gain is required)
    for wire in ("compact", "sigdev"):
        line = []
        for name, engine in (("1 card", one), (f"{n} cards", sharded)):
            pe = PerformanceEvaluator(engine, beam_width=5, cache_dir=str(tmp_path / "cache"),
                                      wire=wire)
            pe.run_pipelined([str(p) for p in paths], inflight=8, finishers=4)  # warm-up
            rec = pe.run_pipelined([str(p) for p in paths], inflight=8, finishers=4)
            line.append(f"{name} wall {rec['wall_s']:.4f} s, {rec['bases_per_s']:.1f} bases/s")
        print(f"\n  {wire} run_pipelined over 4 reads: " + "; ".join(line) + f" [{smi()}]")
