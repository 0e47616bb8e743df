"""ravvent_tpu_torch/tools/profile_decode.py on the CPU: the tool runs as a
module at a narrow configuration, prints every leg of a read's decode on the
compact and the signal-only wire and imports no JAX; the trace's summary
(idle share, top device operations, idle gaps with their host operations) on
a synthetic Chrome trace. The trace itself needs the card (chip_smoke.py
phase 16)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from ravvent_tpu_torch.tools.profile_decode import WINDOW, trace_summary

REPO = Path(__file__).resolve().parents[1]
LEGS = ["host pack+unpack", "H2D upload", "device compute", "D2H fetch", "sum of legs",
        "end-to-end", "host pack", "host unpack", "device encode+decode+pack"]
WIRE_LEGS = {"compact": ["device unpack+gather"],
             "sigdev": ["device segmentation", "begin_beam_signal", "meta wait", "finish+collect"]}
RUN = ("import runpy, sys; sys.argv = ['profile_decode'] + sys.argv[1:]; "
       "runpy.run_module('ravvent_tpu_torch.tools.profile_decode', run_name='__main__'); "
       "assert not {'jax', 'ravvent_tpu'} & set(sys.modules), 'imported JAX'")


@pytest.mark.parametrize("wire", list(WIRE_LEGS))
def test_profile_decode_on_the_cpu_prints_every_leg(wire):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    args = ["--cpu", "--seed", "0", "--enc-units", "8", "--dec-units", "8", "--encoder-depth",
            "1", "--chunk", "1024", "--read", "3", "--repeats", "1", "--wire", wire,
            "--trace", "unused"]
    res = subprocess.run([sys.executable, "-c", RUN, *args], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    print(res.stdout)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    for leg in LEGS + WIRE_LEGS[wire]:
        line = [ln for ln in lines if ln.strip().startswith(leg + " ")]
        assert line and float(line[0].split(":")[1].split()[0]) >= 0, leg
    assert "CPU (host times only)" in lines[0]
    assert "trace skipped" in lines[-1]


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def test_trace_summary_on_a_synthetic_trace():
    """A 1000 us window: kernels over [100, 400) (two overlapping) and a copy
    over [600, 700) keep the device busy 400 us, an idle share of 0.6; the
    gaps are [700, 1000), [400, 600) and [0, 100), each named by the
    innermost host operation of each thread at its middle."""
    events = [
        _x(WINDOW, "user_annotation", 0, 1000),
        _x("beam_attend", "kernel", 100, 200, tid=7),
        _x("beam_cell", "kernel", 250, 150, tid=7),
        _x("Memcpy DtoH", "gpu_memcpy", 600, 100, tid=7),
        _x("beam_cell", "kernel", 1500, 100, tid=7),  # outside the window
        _x("engine.dispatch_beam_compact", "user_annotation", 380, 300),
        _x("aten::copy_", "cpu_op", 450, 100),
        _x("merger.merge_flat", "user_annotation", 420, 200, tid=2),
        _x("evaluator._load", "user_annotation", 650, 350),
        {"ph": "i", "name": "marker", "ts": 10},
    ]
    s = trace_summary({"traceEvents": events}, thread=1)
    assert s["window_ms"] == 1.0 and s["device_events"] == 4
    assert s["device_busy_ms"] == pytest.approx(0.4)
    assert s["idle_share"] == pytest.approx(0.6)
    assert [(o["name"], o["count"]) for o in s["top_ops"]] == [
        ("beam_cell", 2), ("beam_attend", 1), ("Memcpy DtoH", 1)]
    assert s["top_ops"][0]["ms"] == pytest.approx(0.25)
    gaps = s["gaps"]
    assert [(g["ms"], g["start_ms"]) for g in gaps] == [
        pytest.approx((0.3, 0.7)), pytest.approx((0.2, 0.4)), pytest.approx((0.1, 0.0))]
    assert gaps[0]["host"] == {"1": "evaluator._load"}
    assert gaps[1]["host"] == {"1": "aten::copy_", "2": "merger.merge_flat"}
    assert gaps[2]["host"] == {}
    assert [(g["after"], g["before"]) for g in gaps] == [
        ("engine.dispatch_beam_compact", None), (None, "evaluator._load"),
        (None, "engine.dispatch_beam_compact")]
    with pytest.raises(ValueError, match="annotation"):
        trace_summary({"traceEvents": events[1:]})


def test_trace_pipelined_on_the_cpu_traces_the_window_and_the_seams(tmp_path):
    """trace_pipelined at a narrow configuration on the CPU: the trace file,
    the run's window, the engine's and the evaluator's seams annotated on
    the dispatching and the finishing threads; no device event, so an idle
    share of 1. The card's trace is chip_smoke.py phase 16."""
    import json

    import torch

    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import init_basecaller
    from ravvent_tpu_torch.tools.profile_decode import simulated_reads, trace_pipelined, write_reads

    torch.set_num_threads(1)
    cfg = ModelConfig(enc_units=8, dec_units=8, encoder_depth=1)
    engine = BasecallEngine(init_basecaller(cfg, torch.Generator().manual_seed(0)), cfg,
                            chunk_size=1024, memory_dtype=torch.bfloat16,
                            encoder_dtype=torch.bfloat16, transport_dtype="i8dev", prob_bits=4,
                            device="cpu")
    reads = []
    for raw, ranges, seq in simulated_reads(0):  # each read's first 30k samples
        keep = ranges[:, 1] <= 30_000
        reads.append((raw[:30_000], ranges[keep], seq[:int(keep.sum())]))
    paths = write_reads(reads, tmp_path)
    s = trace_pipelined(engine, paths, tmp_path / "trace", cache_dir=str(tmp_path / "cache"))
    names = {e["name"] for e in json.loads((tmp_path / "trace" / "trace.json").read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    assert {WINDOW, "engine.dispatch_beam_compact", "engine.upload_chunk", "engine._enqueue",
            "engine.collect_beam_compact", "evaluator._load", "merger.merge_flat"} <= names
    assert s["record"]["reads"] == s["untraced"]["reads"] == 4 and s["record"]["bases_num"] > 0
    assert s["window_ms"] > 0 and s["device_events"] == 0 and s["idle_share"] == 1.0
    assert s["top_ops"] == [] and len(s["gaps"]) == 1 and s["gaps"][0]["host"]
