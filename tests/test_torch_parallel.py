"""The port's sharded engine (ravvent_tpu_torch/parallel/{mesh,inference}.py,
BasecallEngine(mesh=)) on the CPU: ShardedBasecallEngine over
make_mesh(devices=["cpu"] * 8) against the single-device port engine, the
cases of tests/test_parallel_inference.py plus the signal-only wire,
uneven and short chunks, greedy decode and the evaluators; and against the
JAX package's ShardedBasecallEngine on its 8-device mesh.

Every shard runs the single-device program on its rows, which it treats
independently, so tokens and probabilities are bit-equal to one device's
(greedy decode: each row's tokens up to its end token, since the
all-finished stop is a shard's, and its logits within 1e-5 relative).
Against the JAX sharded engine (the trained flagship, f32 memory,
pre-projected values): equal tokens.
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.config import ModelConfig as JConfig
from ravvent_tpu.parallel.inference import ShardedBasecallEngine as JShardedEngine
from ravvent_tpu.parallel.mesh import make_mesh as jmake_mesh
from ravvent_tpu.training.checkpoints import CheckpointManager
from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.data.snippets import load_read_compact, load_read_compact_ex
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.evaluation.performance import PerformanceEvaluator
from ravvent_tpu_torch.models.basecaller import init_basecaller
from ravvent_tpu_torch.parallel.inference import ShardedBasecallEngine
from ravvent_tpu_torch.parallel.mesh import make_mesh, replicate, row_bounds, shard_batch
from ravvent_tpu_torch.weights import from_jax_params

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]
CFG = ModelConfig(enc_units=16, dec_units=16, encoder_depth=1, data_type="joint")
N_SHARDS = 8


@pytest.fixture(scope="module")
def params():
    return init_basecaller(CFG, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(devices=["cpu"] * N_SHARDS)


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """Three simulated reads as chiron files: (signal path, raw samples)."""
    d = tmp_path_factory.mktemp("reads")
    rng = np.random.default_rng(11)
    out = []
    for i, n in enumerate([2500, 1200, 1500]):
        genome = simulator.random_genome(n, rng)
        sig, ranges = simulator.simulate_read(genome, rng, simulator.PoreModel())
        chiron.write_read(d / f"r{i}.signal", d / f"r{i}.label", sig, ranges, genome)
        out.append((d / f"r{i}.signal", np.asarray(sig)))
    return out


def compact_ex(path):
    sig, rr, ev, er, nuc, aux = load_read_compact_ex(path, path.with_suffix(".label"), stride=6)
    return sig, rr, ev, er, int((nuc != 0).sum(axis=1).max()), aux


def pair(params, mesh, **kw):
    """(one device, the mesh) engines with the same settings."""
    return (BasecallEngine(params, CFG, device="cpu", **kw),
            ShardedBasecallEngine(params, CFG, mesh, **kw))


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_make_mesh(monkeypatch):
    m = make_mesh(devices=["cpu"] * 3)
    assert m.shape == {"data": 3} and m.axis_names == ("data",) and m.size == 3
    assert m.devices == (torch.device("cpu"),) * 3
    assert make_mesh(2, devices=["cpu"] * 5).shape == {"data": 2}
    assert m.data_devices == m.devices
    # the ('data', 'model') mesh, laid out as JAX's devices.reshape(-1, k)
    devs = ["cpu", "cpu:0"] * 4
    g = make_mesh(devices=devs, model_shards=2)
    assert g.shape == {"data": 4, "model": 2} and g.axis_names == ("data", "model")
    assert g.size == 8 and g.devices == tuple(torch.device(d) for d in devs)
    # JAX's mesh holds device i at (i // 2, i % 2); a data shard's device is
    # the first of its model row
    ids = np.array([[d.id for d in row] for row in jmake_mesh(8, model_shards=2).devices])
    assert np.array_equal(ids, np.arange(8).reshape(4, 2))
    assert g.data_devices == tuple(g.devices[i] for i in ids[:, 0])
    assert make_mesh(6, devices=["cpu"] * 8, model_shards=3).shape == {"data": 2, "model": 3}
    assert make_mesh(devices=["cpu"] * 4, model_shards=1).axis_names == ("data",)
    with pytest.raises(ValueError, match="model_shards=3"):
        make_mesh(devices=["cpu"] * 4, model_shards=3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices=\\['cpu'\\]"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError):
        make_mesh(devices=[])


@pytest.mark.parametrize("n", [0, 3, 8, 13, 64])
def test_row_bounds_shard_batch_and_replicate(n):
    mesh = make_mesh(devices=["cpu"] * N_SHARDS)
    x = torch.arange(n * 2).reshape(n, 2)
    pieces = torch.tensor_split(x, N_SHARDS)
    bounds = row_bounds(n, N_SHARDS)
    assert [hi - lo for lo, hi in bounds] == [p.shape[0] for p in pieces]
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    shards = shard_batch({"x": x, "y": [x[:, 0]]}, mesh)
    assert len(shards) == N_SHARDS
    for s, p in zip(shards, pieces):
        assert torch.equal(s["x"], p) and torch.equal(s["y"][0], p[:, 0])
    reps = replicate({"w": x}, mesh)
    assert len(reps) == N_SHARDS and all(torch.equal(r["w"], x) for r in reps)


def test_engine_over_a_model_axis_mesh_splits_rows_over_data(params):
    """A ('data', 'model') mesh (training's) serves the engine as its
    'data' axis: 4 data shards, each on the first device of its model row,
    results bit-equal to one device."""
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(13, 200, 1)).astype(np.float32)
    event = rng.normal(size=(13, 30, 5)).astype(np.float32)
    mesh = make_mesh(devices=["cpu", "cpu:0"] * 4, model_shards=2)
    one, sharded = pair(params, mesh, chunk_size=16, total_steps=12)
    assert [e.device for e in sharded._shards] == [torch.device("cpu")] * 4
    assert len(shard_batch({"x": torch.zeros(13)}, mesh)) == 4
    assert [len(r["w"]) for r in replicate({"w": torch.zeros(3)}, mesh)] == [3] * 4
    assert_same(one.predict_beam(raw, event, 12, beam_width=3),
                sharded.predict_beam(raw, event, 12, beam_width=3))


@pytest.mark.parametrize("beam_impl", ["step", "loop", "xla"])
def test_sharded_predict_beam_matches_single_device(params, mesh, beam_impl):
    """45 rows in chunks of 16: the last chunk's 13 rows split unevenly."""
    rng = np.random.default_rng(0)
    raw = rng.normal(size=(45, 200, 1)).astype(np.float32)
    event = rng.normal(size=(45, 30, 5)).astype(np.float32)
    one, sharded = pair(params, mesh, chunk_size=16, total_steps=12, beam_impl=beam_impl)
    assert_same(one.predict_beam(raw, event, 12, beam_width=3),
                sharded.predict_beam(raw, event, 12, beam_width=3))


@pytest.mark.parametrize("memory", [torch.bfloat16, None, "i8", "i8mxu"],
                         ids=["bf16", "f32", "i8", "i8mxu"])
def test_sharded_compact_matches_single_device(params, mesh, reads, memory):
    """The f32 wire, chunks of 64 (the last uneven), every memory type."""
    sig, rr, ev, er, nuc = load_read_compact(reads[0][0], reads[0][0].with_suffix(".label"), 6)
    max_len = int((nuc != 0).sum(axis=1).max())
    one, sharded = pair(params, mesh, chunk_size=64, transport_dtype="f32", memory_dtype=memory)
    assert rr.shape[0] % 64 % N_SHARDS
    assert_same(one.predict_beam_compact(sig, rr, ev, er, max_len, 3),
                sharded.predict_beam_compact(sig, rr, ev, er, max_len, 3))


@pytest.mark.parametrize("n_beams", [1, 2])
def test_sharded_fast_path_matches_single_device(params, mesh, reads, n_beams):
    """i8dev (features and ranges derived on each device) with its aux
    dict, the packed fetch, 4-bit probabilities, pre-projected values."""
    sig, rr, ev, er, max_len, aux = compact_ex(reads[0][0])
    fast = dict(chunk_size=512, transport_dtype="i8dev", pack_u8=True, prob_bits=4,
                project_values=True, n_beams=n_beams, encoder_dtype=torch.bfloat16)
    one, sharded = pair(params, mesh, **fast)
    t1, p1 = one.predict_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux)
    t2, p2 = sharded.predict_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux)
    assert t2.shape[0] == rr.shape[0] and (t2.ndim == 3) == (n_beams > 1)
    assert_same((t1, p1), (t2, p2))


def test_sharded_dispatch_collect_two_reads_in_flight(params, mesh, reads):
    one, sharded = pair(params, mesh, chunk_size=96, pack_u8=True, project_values=True,
                        transport_dtype="i8dev")
    handles, wants = [], []
    for path, _ in reads[:2]:
        sig, rr, ev, er, max_len, aux = compact_ex(path)
        handles.append(sharded.dispatch_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux))
        wants.append(one.predict_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux))
        chunks = -(-rr.shape[0] // 96)
        # one result buffer a shard of each chunk; the last chunk's shards may be fewer
        assert (chunks - 1) * N_SHARDS < len(handles[-1].pending) <= chunks * N_SHARDS
    for h, want in zip(handles, wants):
        assert_same(sharded.collect_beam_compact(h), want)


def test_sharded_multibeam_matches_single_device(params, mesh, reads):
    sig, rr, ev, er, nuc = load_read_compact(reads[1][0], reads[1][0].with_suffix(".label"), 6)
    max_len = int((nuc != 0).sum(axis=1).max())
    one, sharded = pair(params, mesh, chunk_size=64, transport_dtype="f32", n_beams=2)
    t1, p1 = one.predict_beam_compact(sig, rr, ev, er, max_len, 3)
    assert t1.ndim == 3 and t1.shape[1] == 2
    assert_same((t1, p1), sharded.predict_beam_compact(sig, rr, ev, er, max_len, 3))


def test_sharded_short_chunks(params, mesh, reads):
    """Fewer rows than shards: the empty shards launch nothing."""
    sig, rr, ev, er, max_len, aux = compact_ex(reads[0][0])
    one, sharded = pair(params, mesh, chunk_size=64, transport_dtype="f16")
    for n in (1, 5):
        handle = sharded.dispatch_beam_compact(sig, rr[:n], ev, er[:n], max_len, 3)
        assert len(handle.pending) == n and all(rows == 1 for _, _, rows in handle.pending)
        assert_same(sharded.collect_beam_compact(handle),
                    one.predict_beam_compact(sig, rr[:n], ev, er[:n], max_len, 3))
    empty = sharded.predict_beam_compact(sig, rr[:0], ev, er[:0], max_len, 3)
    assert empty[0].shape[0] == 0
    rng = np.random.default_rng(1)
    raw = rng.normal(size=(3, 200, 1)).astype(np.float32)
    event = rng.normal(size=(3, 30, 5)).astype(np.float32)
    assert_same(one.predict_beam(raw, event, 20, 3), sharded.predict_beam(raw, event, 20, 3))


@pytest.mark.parametrize("sig_wire", ["i16", "u8"])
def test_sharded_signal_wire_matches_single_device(params, mesh, reads, sig_wire):
    """The segmentation runs on the mesh's first device; each shard gathers
    and decodes its rows of every chunk."""
    fast = dict(chunk_size=128, pack_u8=True, prob_bits=4, project_values=True,
                encoder_dtype=torch.bfloat16)
    one, sharded = pair(params, mesh, **fast)
    raws = [r for _, r in reads]
    for raw in raws[:2]:
        assert_same(one.predict_beam_signal(raw, 40, 3, sig_wire=sig_wire, return_ranges=True),
                    sharded.predict_beam_signal(raw, 40, 3, sig_wire=sig_wire,
                                                return_ranges=True))
    segs = sharded.begin_beam_signal_batch(raws, sig_wire=sig_wire)
    for seg, raw in zip(segs, raws):
        handle = sharded.finish_beam_signal(seg, 40, 3)
        assert_same(sharded.collect_beam_compact(handle),
                    one.predict_beam_signal(raw, 40, 3, sig_wire=sig_wire))


def test_sharded_predict_greedy(params, mesh):
    rng = np.random.default_rng(2)
    raw = rng.normal(size=(21, 200, 1)).astype(np.float32)
    event = rng.normal(size=(21, 30, 5)).astype(np.float32)
    one, sharded = pair(params, mesh, chunk_size=16, total_steps=24, beam_impl="xla",
                        memory_dtype=None)
    t1, l1 = one.predict_greedy(raw, event, 24)
    t2, l2 = sharded.predict_greedy(raw, event, 24)
    assert t1.shape == t2.shape and l1.shape == l2.shape
    # the all-finished stop is a shard's: each row up to its end token; the
    # plain decoder's f32 GEMMs on the CPU take another path at another row
    # count, so the logits agree to f32 rounding (the beam paths above are
    # bit-equal)
    for a, b, la, lb in zip(t1, t2, l1, l2):
        n = int(np.argmax(a == 1)) + 1 if (a == 1).any() else a.size
        np.testing.assert_array_equal(a[:n], b[:n])
        np.testing.assert_allclose(la[:n], lb[:n], rtol=1e-5, atol=1e-7)


def test_sharded_engine_refuses_a_device_beside_its_mesh(params, mesh):
    with pytest.raises(ValueError, match="mesh"):
        BasecallEngine(params, CFG, device="cpu", mesh=mesh)
    engine = ShardedBasecallEngine(params, CFG, mesh)
    assert engine.device == torch.device("cpu") and engine.mesh is mesh
    assert len(engine._shards) == N_SHARDS and all(s is engine for s in engine._shards)


def test_sharded_engine_over_distinct_devices(params, reads, monkeypatch):
    """A mesh of two distinct devices, ``cpu`` and ``cpu:0``, four shards
    each, as a mesh of cards is: a replica engine holds its own parameters
    and kernel-layout encoder weights on the second device, each chunk
    goes up once a device, and the results are bit-equal to one device's
    on the materialized rows, the f16 compact wire, i8dev with its aux
    dict through dispatch/collect, and sigdev."""
    mesh = make_mesh(devices=["cpu", "cpu:0"] * 4)
    uploads = []
    upload = BasecallEngine.upload_chunk

    def recording(self, *a, **k):
        uploads.append(self.device)
        return upload(self, *a, **k)

    monkeypatch.setattr(BasecallEngine, "upload_chunk", recording)
    for wire in ("f16", "i8dev"):
        one, sharded = pair(params, mesh, chunk_size=128, transport_dtype=wire, pack_u8=True,
                            prob_bits=4, project_values=True, encoder_dtype=torch.bfloat16)
        first, second = sharded._shards[:2]
        assert [s.device for s in sharded._shards] == [torch.device("cpu"),
                                                       torch.device("cpu", 0)] * 4
        assert first is sharded and second is not sharded
        assert sharded._shards == [first, second] * 4
        assert second.mesh is None and second._shards == [second]
        assert second.params is not sharded.params
        assert second._enc_weights.keys() == sharded._enc_weights.keys()
        assert all(second._enc_weights[k] is not sharded._enc_weights[k]
                   for k in sharded._enc_weights)
        sig, rr, ev, er, max_len, aux = compact_ex(reads[0][0])
        aux = aux if wire == "i8dev" else None
        chunks = -(-rr.shape[0] // 128)
        uploads.clear()
        handle = sharded.dispatch_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux)
        assert uploads == [torch.device("cpu"), torch.device("cpu", 0)] * chunks
        assert_same(sharded.collect_beam_compact(handle),
                    one.predict_beam_compact(sig, rr, ev, er, max_len, 3, aux=aux))
    raw = reads[1][1]
    assert_same(one.predict_beam_signal(raw, 40, 3, return_ranges=True),
                sharded.predict_beam_signal(raw, 40, 3, return_ranges=True))
    rng = np.random.default_rng(3)
    raw = rng.normal(size=(21, 200, 1)).astype(np.float32)
    event = rng.normal(size=(21, 30, 5)).astype(np.float32)
    assert_same(one.predict_beam(raw, event, 20, 3), sharded.predict_beam(raw, event, 20, 3))


def test_evaluators_take_the_sharded_engine(params, mesh, reads, tmp_path):
    """PerformanceEvaluator.run_pipelined (compact and sigdev) and
    MappingEvaluator.evaluate_files over the sharded engine, their code
    unchanged: the same merged reads and results as one device's."""
    paths = [str(p) for p, _ in reads]
    info = tmp_path / "files_info.json"
    info.write_text(json.dumps([{"signal_path": p} for p in paths]))
    kw = dict(chunk_size=128, transport_dtype="i8dev", prob_bits=4, encoder_dtype=torch.bfloat16)
    one, sharded = pair(params, mesh, **kw)
    for wire in ("compact", "sigdev"):
        merged = {}
        for name, eng in (("one", one), ("sharded", sharded)):
            pe = PerformanceEvaluator(eng, beam_width=3, cache_dir=str(tmp_path / "cache"),
                                      wire=wire)
            store = []
            orig = pe.merger.merge_flat
            pe.merger.merge_flat = lambda *a, **k: store.append(orig(*a, **k).seq) or orig(*a, **k)
            rec = pe.run_pipelined(paths, inflight=2, finishers=2)
            merged[name] = (sorted(store), rec["bases_num"])
        assert merged["one"] == merged["sharded"] and len(merged["one"][0]) == len(paths)
    results = []
    for name, eng in (("one", one), ("sharded", sharded)):
        me = MappingEvaluator(eng, beam_width=3, cache_dir=str(tmp_path / "cache"))
        res = me.evaluate_files(info, tmp_path / f"{name}.json", verbose=False)
        results.append([{k: v for k, v in r.items() if not k.startswith("t_")} for r in res])
    assert results[0] == results[1]


def test_sharded_engine_matches_jax_sharded_engine():
    """The trained flagship, f32 memory, pre-projected values, the packed
    f16 wire: the port's 8 CPU shards and the JAX engine's 8-device mesh
    give the same tokens."""
    tree = CheckpointManager(str(REPO / "checkpoints")).restore_numpy("flagship")["params"]
    rng = np.random.default_rng(7)
    seq = simulator.random_genome(1000, rng)
    sig, ranges = simulator.simulate_read(seq, rng, simulator.PoreModel())
    from ravvent_tpu_torch.data.snippets import prepare_compact

    sigc, rr, ev, er, _, _ = prepare_compact(sig, ranges, np.array(["a"] * len(ranges)), 6)
    rr, er = rr[:27], er[:27]
    jeng = JShardedEngine(tree, JConfig(), jmake_mesh(8), chunk_size=32, project_values=True,
                          beam_impl="xla", pack_u8=True)
    teng = ShardedBasecallEngine(from_jax_params(jax.tree_util.tree_map(np.asarray, tree)),
                                 ModelConfig(), make_mesh(devices=["cpu"] * 8), chunk_size=32,
                                 memory_dtype=None)
    jt, jp = jeng.predict_beam_compact(sigc, rr, ev, er, 40, 5)
    tt, tp = teng.predict_beam_compact(sigc, rr, ev, er, 40, 5)
    assert tt.shape == jt.shape == (27, 40)
    np.testing.assert_array_equal(tt, jt)
    assert np.abs(tp - jp)[:, :39].max() <= 1 / 255 + 1e-6  # the u8 wire
