"""The port's accuracy tools against the JAX package's (tools/*.py), on the
CPU, each called in process through ``main``: ``make_results_table``,
``crosscheck_mapper``, ``analyze_beam1_gap`` and ``exp_conf_gate``.

The trained ``checkpoints/flagship`` and ``checkpoints/best.raw21`` serve
the JAX tools from their Orbax directories and the port's as npz files
(``restore_numpy`` through ``from_jax_params``), over 2 reads of 400-600
bases that ravvent_tpu_torch/tools/make_dataset.py builds. The flagship
maps these reads near chance, so besides the tables the merged reads
themselves are held equal. The JAX engine pads a read's snippets to 512
rows, which costs seconds a decode on the CPU: its ``predict_beam_compact``
runs once for each distinct input (weights, configuration, read, bound and
beam width) and serves the JAX tools' repeats of it from memory
(``jax_decodes_once``). The port's decodes all run. No tool writes under
``results/``, ``tests/fixtures/`` or ``checkpoints/``
(``committed_files_untouched``).
"""

import hashlib
import importlib
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ravvent_tpu.evaluation.basecall import BasecallEngine as JBasecallEngine
from ravvent_tpu.models import basecaller as jbasecaller
from ravvent_tpu.evaluation.mapping import MappingEvaluator as JMappingEvaluator
from ravvent_tpu.training.checkpoints import CheckpointManager as JCheckpointManager
from ravvent_tpu_torch import weights
from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator
from ravvent_tpu_torch.tools import (
    analyze_beam1_gap, crosscheck_mapper, exp_conf_gate, make_dataset, make_results_table,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
COMMITTED = [REPO / "results", REPO / "tests" / "fixtures", REPO / "checkpoints"]
JAX_DECODES = {}
JAX_INITS = {}
init_basecaller = jbasecaller.init_basecaller


def init_once(key, cfg):
    """The JAX tools' template for restoring a checkpoint
    (``init_basecaller(PRNGKey(0), cfg)``), made once for each configuration."""
    k = (np.asarray(jax.random.key_data(key) if jax.dtypes.issubdtype(
        key.dtype, jax.dtypes.prng_key) else key).tobytes(), repr(cfg))
    if k not in JAX_INITS:
        JAX_INITS[k] = init_basecaller(key, cfg)
    return JAX_INITS[k]


def run_jax_tool(name, argv, monkeypatch, **attrs):
    """tools/<name>.py's main() on ``argv`` with ``--cpu``, its module
    attributes ``attrs`` patched and its model template made once for each
    configuration (``init_once``). Its import sets JAX's compilation-cache
    directory, which is put back."""
    monkeypatch.setattr(jbasecaller, "init_basecaller", init_once)
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setattr(sys, "argv", [f"tools/{name}.py", "--cpu"] + argv)
    mod = importlib.import_module(f"tools.{name}")
    jax.config.update("jax_compilation_cache_dir", before)
    for k, v in attrs.items():
        monkeypatch.setattr(mod, k, v)
    return mod.main()


def digest(*arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.fixture
def jax_decodes_once(monkeypatch):
    """The JAX engine's ``predict_beam_compact`` computed once for each
    distinct input and served again from memory."""
    predict = JBasecallEngine.predict_beam_compact

    def once(self, signal, raw_ranges, events, event_ranges, max_output_len, beam_width=5,
             aux=None):
        if not hasattr(self, "_params_digest"):
            self._params_digest = digest(*jax.tree_util.tree_leaves(self.params))
        aux_arrays = [v for _, v in sorted((aux or {}).items()) if isinstance(v, np.ndarray)]
        key = (self._params_digest, repr(self.cfg), self.chunk_size,
               digest(signal, raw_ranges, events, event_ranges, *aux_arrays),
               int(max_output_len), int(beam_width))
        if key not in JAX_DECODES:
            JAX_DECODES[key] = predict(self, signal, raw_ranges, events, event_ranges,
                                       max_output_len, beam_width, aux=aux)
        return tuple(np.array(x, copy=True) for x in JAX_DECODES[key])

    monkeypatch.setattr(JBasecallEngine, "predict_beam_compact", once)


def committed_state():
    """(path, size, mtime) of every file under the committed trees, and the
    sha1 of each one under results/ and tests/fixtures/."""
    out = {}
    for root in COMMITTED:
        for p in sorted(root.rglob("*")):
            if p.is_file():
                st = p.stat()
                out[str(p)] = (st.st_size, st.st_mtime_ns,
                               None if root.name == "checkpoints"
                               else hashlib.sha1(p.read_bytes()).hexdigest())
    return out


@pytest.fixture(autouse=True)
def committed_files_untouched():
    before = committed_state()
    yield
    assert committed_state() == before, "a tool wrote under results/, tests/fixtures/ or " \
                                        "checkpoints/"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The flagship and best.raw21 as npz files (a port registry of both
    forms: ``flagship.npz`` and ``best.raw21/params.npz``), and two
    one-read datasets."""
    d = tmp_path_factory.mktemp("accuracy")
    cm = JCheckpointManager(str(REPO / "checkpoints"))
    registry = d / "registry"
    (registry / "best.raw21").mkdir(parents=True)
    weights.save_npz(registry / "flagship.npz",
                     weights.from_jax_params(cm.restore_numpy("flagship")["params"]))
    weights.save_npz(registry / "best.raw21" / "params.npz",
                     weights.from_jax_params(cm.restore_numpy("best.raw21")["params"]))
    make_dataset.build(d / "ds", 43, genome_len=20_000, train_reads=0, eval_reads=2,
                       read_len=(400, 600), seed=11)
    reads = json.loads((d / "ds" / "eval" / "files_info.snippets.stride_6.json").read_text())
    fi = {}
    for i, name in enumerate(("sim_lambda", "sim_ecoli")):
        fi[name] = d / f"files_info.{name}.json"
        fi[name].write_text(json.dumps(reads[i:i + 1]))
    return {"registry": registry, "npz": registry / "flagship.npz", "fi": fi}


def recording(cls, monkeypatch, store):
    """Record every (merged read, reference) the evaluator class maps."""
    map_identity = cls.map_identity

    def wrapped(self, pred_seq, ref_seq):
        store.append((pred_seq, ref_seq))
        return map_identity(self, pred_seq, ref_seq)

    monkeypatch.setattr(cls, "map_identity", wrapped)


def tree(d: Path) -> dict:
    return {str(p.relative_to(d)): p.read_text() for p in sorted(d.rglob("*")) if p.is_file()}


def assert_tables_equal(got: dict, ref: dict):
    """Two result directories: the same files; the JSONs equal, identities
    within 1e-9; ACCURACY.md equal."""
    assert sorted(got) == sorted(ref)
    for name in ref:
        if name.endswith(".md"):
            assert got[name] == ref[name], name
            continue
        g, r = json.loads(got[name]), json.loads(ref[name])
        if isinstance(r, list):  # per-read records
            assert [sorted(x) for x in g] == [sorted(x) for x in r], name
            for a, b in zip(g, r):
                assert abs(a.pop("identity") - b.pop("identity")) <= 1e-9, name
            assert g == r, name
            continue
        assert {k: sorted(v) for k, v in g.items()} == {k: sorted(v) for k, v in r.items()}
        for k in r:
            for dt in r[k]:
                np.testing.assert_allclose(g[k][dt], r[k][dt], rtol=0, atol=1e-9,
                                           err_msg=f"{name} {k} {dt}")


def test_make_results_table_equals_jax(data, tmp_path, monkeypatch, jax_decodes_once):
    """--configs joint:2:1,raw:2:1 --beams 1,5 over the two datasets, into
    directories that already hold a table (the fold), then a second run of
    one evaluation folding into the first's."""
    datasets = {k: str(v) for k, v in data["fi"].items()}
    seeded = {"(3, 2)": {"event": [70.5, 71.0, 2.0]}, "(2, 1)": {"event": [60.25, 61.0, 1.5]}}
    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
        (tmp_path / side / "accuracy_results_all.lambda.beam1.json").write_text(
            json.dumps(seeded, indent=2))
    merged = {"jax": [], "port": []}
    recording(JMappingEvaluator, monkeypatch, merged["jax"])
    recording(MappingEvaluator, monkeypatch, merged["port"])
    specs = [f"--dataset={k}={v}" for k, v in datasets.items()]
    for argv in (["--configs", "joint:2:1,raw:2:1", "--beams", "1,5"],
                 ["--configs", "raw:2:1", "--beams", "1", "--datasets", "sim_ecoli"]):
        run_jax_tool("make_results_table", argv + ["--results-dir", str(tmp_path / "jax")],
                     monkeypatch, DATASETS=datasets)
        tables = make_results_table.main(
            ["--cpu"] + argv + specs + ["--checkpoints-dir", str(data["registry"]),
                                        "--results-dir", str(tmp_path / "port")])
        got, ref = tree(tmp_path / "port"), tree(tmp_path / "jax")
        assert_tables_equal(got, ref)
        assert merged["port"] == merged["jax"] and merged["port"]
        for (ds, beam), table in tables.items():
            tag = make_results_table.TAGS[ds]
            written = json.loads(got[f"accuracy_results_all.{tag}.beam{beam}.json"])
            assert all(written[k][dt] == v for k, row in table.items() for dt, v in row.items())
    print(f"make_results_table: port {tables}; {len(merged['port'])} merged reads equal")
    lam = json.loads(got["accuracy_results_all.lambda.beam1.json"])
    assert lam["(3, 2)"] == seeded["(3, 2)"] and lam["(2, 1)"]["event"] == [60.25, 61.0, 1.5]
    assert sorted(lam["(2, 1)"]) == ["event", "joint", "raw"]
    assert sorted(got) == sorted(
        ["ACCURACY.md"] + [f"accuracy_results_all.{t}.beam{b}.json"
                           for t in ("lambda", "ecoli") for b in (1, 5)]
        + [f"per_read/mapping.{ds}.{dt}.encd2.decd1.beam{b}.json"
           for ds in datasets for dt in ("joint", "raw") for b in (1, 5)])
    assert "| (3, 2) | - | 70.5 | - |" in got["ACCURACY.md"]


def test_make_results_table_registry(tmp_path, monkeypatch, capsys):
    """best.<dt><e><d> before the fallbacks, a directory with params.npz or
    an npz; an Orbax directory is skipped, and the line says why. The
    tables go to info/accuracy_table, not to the committed results/."""
    reg = tmp_path / "ck"
    for d in ("best.joint21", "flagship", "flagship32", "best.raw32"):
        (reg / d).mkdir(parents=True)
    (reg / "flagship" / "params.npz").write_bytes(b"")
    (reg / "flagship32.npz").write_bytes(b"")
    (reg / "best.event21.npz").write_bytes(b"")
    cf = make_results_table.checkpoint_for
    assert cf(reg, "joint", 2, 1) == (reg / "flagship", "")
    assert cf(reg, "joint", 3, 2) == (reg / "flagship32.npz", "")
    assert cf(reg, "event", 2, 1) == (reg / "best.event21.npz", "")
    path, why = cf(reg, "raw", 3, 2)
    assert path is None and "best.raw32 holds no params.npz (an Orbax checkpoint" in why
    path, why = cf(reg, "raw", 2, 1)
    assert path is None and "none of best.raw21" in why
    (reg / "flagship" / "params.npz").unlink()
    path, why = cf(reg, "joint", 2, 1)
    assert path is None and "best.joint21 holds no" in why and "flagship holds no" in why
    monkeypatch.chdir(tmp_path)
    assert make_results_table.main(["--cpu", "--configs", "joint:2:1,raw:3:2", "--dataset",
                                    "x=missing.json", "--checkpoints-dir", str(reg)]) == {}
    err = capsys.readouterr().err.splitlines()
    assert [ln.split(":")[0] for ln in err] == ["skip joint (2,1)", "skip raw (3,2)"]
    assert all("no checkpoint: " in ln and "Orbax" in ln for ln in err)
    table = tmp_path / "info" / "accuracy_table"
    assert (table / "ACCURACY.md").read_text().startswith("# Accuracy results")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck", "info"]


def jax_crosscheck(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["tools/crosscheck_mapper.py"])
    return importlib.import_module("tools.crosscheck_mapper")


def test_crosscheck_self_check_equals_jax(tmp_path, monkeypatch, capsys):
    """The self-check case by case; with --minimap2 and no minimap2 on PATH,
    the skip line, and the return 0."""
    jtool = jax_crosscheck(monkeypatch)
    assert jtool.self_check() == 0
    ref = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("PATH", str(tmp_path))
    assert crosscheck_mapper.main(["--minimap2"]) == 0
    got = capsys.readouterr().out.splitlines()
    print(*got, sep="\n")
    assert got[0].startswith("sce mapper self-check") and got[-1] == "PASS"
    assert got[1:9] == ref and len(ref) == 8 and all(ln.endswith(" OK") for ln in ref)
    assert got[9:-1] == ["cross-check vs minimap2 -x map-ont -c:",
                         "minimap2 not on PATH — skipping external check "
                         "(run this on a machine that has it)"]


def test_crosscheck_regen_equals_the_committed_fixtures(tmp_path):
    out = tmp_path / "fx"
    assert crosscheck_mapper.main(["--regen", "--fixtures", str(out)]) == 0
    for name in ("ref.fasta", "pred.fastq"):
        assert (out / name).read_bytes() == (crosscheck_mapper.FIXTURES / name).read_bytes()
    assert (json.loads((out / "expected.json").read_text())
            == json.loads((crosscheck_mapper.FIXTURES / "expected.json").read_text()))


def test_crosscheck_regen_refuses_the_committed_fixtures(capsys):
    with pytest.raises(SystemExit):
        crosscheck_mapper.main(["--regen"])
    assert "--regen needs --fixtures" in capsys.readouterr().err
    rel = os.path.relpath(crosscheck_mapper.FIXTURES)
    with pytest.raises(ValueError, match="does not write the committed fixtures"):
        crosscheck_mapper.main(["--regen", "--fixtures", rel])


# 1260 matches over 1400 columns: identity 0.9 for every case
STUB_PAF = ("q\t1000\t0\t1000\t+\tt\t20000\t0\t1000\t930\t1000\t60\n"
            "q\t1000\t0\t400\t+\tt\t20000\t0\t400\t330\t400\t60\n"
            "not a PAF line\n")


def test_crosscheck_minimap2_leg_equals_jax(tmp_path, monkeypatch, capsys):
    """A stub minimap2 on PATH prints fixed PAF lines: the port's leg prints
    and returns what the JAX tool's does."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    (bin_dir / "paf").write_text(STUB_PAF)
    stub = bin_dir / "minimap2"
    stub.write_text(f"#!/bin/sh\ncat {bin_dir / 'paf'}\n")
    stub.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    jbad = jax_crosscheck(monkeypatch).minimap2_check()
    ref = capsys.readouterr().out.splitlines()
    bad = crosscheck_mapper.minimap2_check()
    got = capsys.readouterr().out.splitlines()
    print(*got, sep="\n")
    # the JAX rule: a case diverges when one side maps and the other does not,
    # their identities more than 0.03 apart
    assert got == ref and len(ref) == 8 and bad == jbad == 1
    assert [ln.split()[-1] for ln in got] == ["OK"] * 4 + ["DIVERGES"] + ["OK"] * 3


def test_crosscheck_without_minimap2_skips(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))
    assert crosscheck_mapper.minimap2_check() == 0
    assert capsys.readouterr().out.startswith("minimap2 not on PATH — skipping external check")


def test_analyze_beam1_gap_equals_jax(data, tmp_path, monkeypatch, jax_decodes_once):
    common = ["--data-type", "joint", "--encoder-depth", "2", "--files-info",
              str(data["fi"]["sim_lambda"]), "--reads", "1"]
    run_jax_tool("analyze_beam1_gap", common + [
        "--checkpoint", str(REPO / "checkpoints" / "flagship"), "--cache-dir",
        str(tmp_path / "jc"), "--out", str(tmp_path / "jax.json")], monkeypatch)
    summary = analyze_beam1_gap.main(["--cpu"] + common + [
        "--checkpoint", str(data["npz"]), "--cache-dir", str(tmp_path / "pc"), "--out",
        str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "jax.json").read_text())
    print(f"analyze_beam1_gap: port {json.dumps({k: v for k, v in got.items() if k != 'rows'})}")
    assert json.loads(json.dumps(summary)) == got
    assert got.pop("checkpoint") == str(data["npz"])
    assert ref.pop("checkpoint") == str(REPO / "checkpoints" / "flagship")
    assert got == ref and got["reads"] == 1
    assert 0 < got["snippet_identity_mean"]["5"] < 1


def test_exp_conf_gate_equals_jax(data, tmp_path, monkeypatch, jax_decodes_once):
    common = ["--data-type", "joint", "--encoder-depth", "2", "--files-info",
              str(data["fi"]["sim_lambda"]), "--reads", "1"]
    run_jax_tool("exp_conf_gate", common + [
        "--checkpoint", str(REPO / "checkpoints" / "flagship"), "--cache-dir",
        str(tmp_path / "jc"), "--out", str(tmp_path / "jax.json")], monkeypatch)
    results = exp_conf_gate.main(["--cpu"] + common + [
        "--checkpoint", str(data["npz"]), "--cache-dir", str(tmp_path / "pc"), "--out",
        str(tmp_path / "port.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    print(f"exp_conf_gate: port {got}")
    assert got == json.loads((tmp_path / "jax.json").read_text()) == results
    assert list(got) == ["baseline", "g0.12_-0.15_0.12", "g0.12_-0.15_0.25_2"]
    assert list(got["g0.12_-0.15_0.12"]) == ["beam5", "beam1", "mean_drop_frac"]


@pytest.mark.parametrize("tool,argv", [
    (make_results_table, []),
    (analyze_beam1_gap, ["--checkpoint", "c", "--files-info", "x.json"]),
    (exp_conf_gate, ["--checkpoint", "c", "--files-info", "x.json"]),
], ids=lambda v: getattr(v, "__name__", "").rsplit(".", 1)[-1])
def test_accuracy_tool_needs_a_card_unless_asked_for_the_cpu(tool, argv):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main(argv)


@pytest.mark.parametrize("flag", [["--cpu"], ["--device", "cuda:0"]])
def test_crosscheck_mapper_takes_no_device(flag, capsys):
    """The mapper is host code (its self-check runs on this machine without
    a card, test_crosscheck_self_check_equals_jax): the tool takes no device
    flag."""
    with pytest.raises(SystemExit):
        crosscheck_mapper.main(flag)
    assert "unrecognized arguments" in capsys.readouterr().err


def test_flagship_npz_equals_the_checkpoint():
    """ravvent_tpu_torch/assets/flagship.npz is checkpoints/flagship through
    from_jax_params, array by array and bit for bit."""
    tree = JCheckpointManager(str(REPO / "checkpoints")).restore_numpy("flagship")["params"]
    ref = weights.flatten(weights.from_jax_params(tree))
    with np.load(weights.FLAGSHIP_NPZ) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(ref) and len(got) == 31
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
        assert got[k].tobytes() == ref[k].tobytes(), k
    loaded = weights.flatten(weights.load_flagship())
    assert all(loaded[k].tobytes() == ref[k].tobytes() for k in ref)
    assert sum(v.size for v in got.values()) == 1_276_807


def test_load_flagship_raises_without_the_file(tmp_path, monkeypatch):
    monkeypatch.setattr(weights, "FLAGSHIP_NPZ", tmp_path / "flagship.npz")
    with pytest.raises(FileNotFoundError, match="flagship"):
        weights.load_flagship()
