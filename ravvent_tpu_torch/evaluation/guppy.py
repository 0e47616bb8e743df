"""External-baseline evaluation: ONT guppy_basecaller (a copy of
ravvent_tpu/evaluation/guppy.py).

Rebuild of the reference's guppy comparison harness
(reference: guppy_evaluation.py): run ``guppy_basecaller`` per read
directory, map its FASTQ output against the per-read reference with the same
identity machinery as our own evaluator, and parse the guppy log for init /
caller time and samples-called to compute bases/s and samples/s. Gated on the
binary being installed (it is closed-source and absent here); everything
around the subprocess is importable and unit-tested.
"""

from __future__ import annotations

import re
import shlex
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

GUPPY_CONFIG = "dna_r9.4.1_450bps_hac.cfg"


def guppy_available() -> bool:
    return shutil.which("guppy_basecaller") is not None


def run_guppy_single_dir(
    fast5_dir, out_dir, device: Optional[str] = None, config: str = GUPPY_CONFIG
) -> subprocess.CompletedProcess:
    """reference: guppy_evaluation.py:30-41 (``-x auto`` selects GPU)."""
    cmd = f"guppy_basecaller -i {fast5_dir} -s {out_dir} -c {config}"
    if device:
        cmd += f" -x {device}"
    return subprocess.run(shlex.split(cmd), capture_output=True, text=True)


def parse_guppy_log(log_text: str) -> Dict[str, float]:
    """Extract init/caller wall time and samples called
    (reference: guppy_evaluation.py:54-72)."""
    out: Dict[str, float] = {}
    m = re.search(r"Init time:\s*([0-9.]+)\s*ms", log_text)
    if m:
        out["init_time_ms"] = float(m.group(1))
    m = re.search(r"Caller time:\s*([0-9.]+)\s*ms", log_text)
    if m:
        out["caller_time_ms"] = float(m.group(1))
    m = re.search(r"Samples called:\s*([0-9]+)", log_text)
    if m:
        out["samples_called"] = float(m.group(1))
    return out


def calculate_speed(stats: Dict[str, float], bases_num: int) -> Dict[str, float]:
    """bases/s and samples/s over caller time
    (reference: guppy_evaluation.py:87-100)."""
    caller_s = stats.get("caller_time_ms", 0.0) / 1000.0
    if caller_s <= 0:
        return {"bases_per_s": 0.0, "samples_per_s": 0.0}
    return {
        "bases_per_s": bases_num / caller_s,
        "samples_per_s": stats.get("samples_called", 0.0) / caller_s,
    }


def read_fastq_sequences(out_dir) -> List[str]:
    seqs = []
    for p in sorted(Path(out_dir).glob("*.fastq")):
        lines = p.read_text().splitlines()
        seqs.extend(lines[i] for i in range(1, len(lines), 4))
    return seqs


def evaluate_guppy_output(out_dir, ref_seq: str) -> Dict:
    """Identity of guppy's basecalls against the per-read reference using the
    same mapping machinery as our evaluator
    (reference: guppy_evaluation.py:43-52)."""
    from ravvent_tpu_torch.evaluation.mapping import MappingEvaluator

    seqs = read_fastq_sequences(out_dir)
    pred = "".join(seqs)
    me = MappingEvaluator(engine=None)
    return me.map_identity(pred, ref_seq)
