"""External validation harness for the built-in sce mapper.

Counterpart of the repo root's tools/crosscheck_mapper.py, which runs the
JAX package's copy of the mapper, with its flags. minimap2 defines the
identity metric of record (reference: ravvent_mapping_evaluator.py:85-108:
``minimap2 -x map-ont -c``, identity = sum(PAF matches) / sum(PAF
block_len)); where it is not installed the port maps with its
seed-chain-extend local mapper (assembly/sce_mapper.py). This tool makes
the substitution checkable on any machine that has minimap2:

  python -m ravvent_tpu_torch.tools.crosscheck_mapper            # self-check
  python -m ravvent_tpu_torch.tools.crosscheck_mapper --minimap2 # also vs minimap2
  python -m ravvent_tpu_torch.tools.crosscheck_mapper --regen --fixtures DIR

Fixtures (``--fixtures``, by default the committed tests/fixtures/crosscheck/,
which the tool only reads): ``ref.fasta`` (the reference of each case),
``pred.fastq`` (predicted reads with a map-ont-style error profile: ~12%
error, garbage tails, a reverse-complement read, a split read, unmappable
garbage) and ``expected.json`` (the mapper's (matches, block_len, identity)
per case). ``--regen`` writes them, from the same seeded cases, into the
``--fixtures`` directory the caller names, never into the committed one.

Self-check: the mapper's output must equal expected.json. minimap2 check:
each case's identity delta is printed, and a case whose |delta| exceeds 0.03
is flagged (seed heuristics differ, so small deltas are expected). The
mapper runs on the host, so unlike the other accuracy tools this one takes
no device. ``main`` returns the exit code: 0 when every case agrees.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

from ravvent_tpu_torch.assembly.sce_mapper import map_identity, revcomp
from ravvent_tpu_torch.data.simulator import read_fasta

REPO = Path(__file__).resolve().parents[2]
FIXTURES = REPO / "tests" / "fixtures" / "crosscheck"

BASES = "ACGT"


def _mutate(rng, seq, sub=0.06, ins=0.03, dele=0.03):
    out = []
    for c in seq:
        r = rng.random()
        if r < dele:
            continue
        if r < dele + sub:
            out.append(BASES[rng.integers(4)])
        else:
            out.append(c)
        if rng.random() < ins:
            out.append(BASES[rng.integers(4)])
    return "".join(out)


def _rand(rng, n):
    return "".join(BASES[i] for i in rng.integers(0, 4, n))


def build_cases():
    """Deterministic (ref, pred) pairs spanning map-ont behaviors (the JAX
    tool's seed and draw order)."""
    rng = np.random.default_rng(20260820)
    ref = _rand(rng, 20000)
    cases = {}
    # 1: plain read, ~12% error (the typical basecalled read)
    cases["plain"] = (ref, _mutate(rng, ref[2000:10000]))
    # 2: garbage tail (soft-clip semantics)
    cases["garbage_tail"] = (ref, _mutate(rng, ref[5000:11000]) + _rand(rng, 900))
    # 3: reverse-complement read (strand handling)
    cases["revcomp"] = (ref, _mutate(rng, revcomp(ref[3000:9000])))
    # 4: split read: two distant segments joined (split mapping / chimera)
    cases["split"] = (
        ref, _mutate(rng, ref[1000:4000]) + _mutate(rng, ref[14000:17000]))
    # 5: unmappable garbage (must count as invalid / unmapped)
    cases["garbage"] = (ref, _rand(rng, 3000))
    # 6: high-accuracy read (~2% error)
    cases["clean"] = (ref, _mutate(rng, ref[8000:16000], 0.01, 0.005, 0.005))
    # 7: low-accuracy read (~35% error), below the k=15 seed cliff: graded by
    # the exact-DP rescue stage
    cases["low_acc"] = (ref, _mutate(rng, ref[4000:8000], 0.21, 0.09, 0.09))
    # 8: repetitive reference (period-6, occurrence-cap seed starvation):
    # the coverage-triggered rescue path
    rep = ("ACGTGA" * 1200)[:7000]
    cases["repetitive"] = (rep, _mutate(rng, rep[500:6500], 0.02, 0.01, 0.01))
    return cases


def write_fixtures(fixtures: Path) -> None:
    if Path(fixtures).resolve() == FIXTURES.resolve():
        raise ValueError(f"--regen does not write the committed fixtures ({FIXTURES}); "
                         "name another --fixtures directory")
    fixtures = Path(fixtures)
    fixtures.mkdir(parents=True, exist_ok=True)
    expected = {}
    with open(fixtures / "ref.fasta", "wt") as fa, open(fixtures / "pred.fastq", "wt") as fq:
        for name, (ref, pred) in build_cases().items():
            fa.write(f">{name}\n")
            for i in range(0, len(ref), 80):
                fa.write(ref[i: i + 80] + "\n")
            fq.write(f"@{name}\n{pred}\n+\n" + "!" * len(pred) + "\n")
            expected[name] = map_identity(pred, ref)
    (fixtures / "expected.json").write_text(json.dumps(expected, indent=2))
    print(f"wrote fixtures + expected.json under {fixtures}")


def read_fixtures(fixtures: Path):
    fixtures = Path(fixtures)
    refs = dict(read_fasta(fixtures / "ref.fasta"))
    preds = {}
    lines = (fixtures / "pred.fastq").read_text().splitlines()
    for i in range(0, len(lines), 4):
        preds[lines[i][1:]] = lines[i + 1]
    expected = json.loads((fixtures / "expected.json").read_text())
    return refs, preds, expected


def self_check(fixtures: Path = FIXTURES) -> int:
    """The mapper against expected.json, a line a case; the number of
    mismatching cases."""
    refs, preds, expected = read_fixtures(fixtures)
    bad = 0
    for name in expected:
        got = map_identity(preds[name], refs[name])
        exp = expected[name]
        same = all(got[k] == exp[k] for k in ("matches", "total_block_len", "read_length"))
        print(f"  {name:13s} identity={got['identity']:.4f} "
              f"matches={got['matches']} block={got['total_block_len']} "
              f"{'OK' if same else 'MISMATCH vs expected.json'}")
        bad += 0 if same else 1
    return bad


def minimap2_check(fixtures: Path = FIXTURES) -> int:
    """minimap2 on PATH against expected.json, a line a case; the number of
    diverging cases (0, with a line saying so, without minimap2)."""
    if shutil.which("minimap2") is None:
        print("minimap2 not on PATH — skipping external check "
              "(run this on a machine that has it)")
        return 0
    refs, preds, expected = read_fixtures(fixtures)
    bad = 0
    with tempfile.TemporaryDirectory() as td:
        for name in expected:
            fa = Path(td) / "ref.fasta"
            fq = Path(td) / "pred.fastq"
            fa.write_text(f">{name}\n{refs[name]}\n")
            fq.write_text(f"@{name}\n{preds[name]}\n+\n" + "!" * len(preds[name]))
            paf = subprocess.run(
                ["minimap2", "-x", "map-ont", "-c", str(fa), str(fq)],
                capture_output=True, text=True).stdout
            matches = blocks = 0
            for line in paf.splitlines():
                parts = line.split("\t")
                if len(parts) >= 11:
                    matches += int(parts[9])
                    blocks += int(parts[10])
            mm = matches / blocks if blocks else 0.0
            ours = expected[name]["identity"]
            delta = abs(mm - ours)
            flag = "OK" if (delta <= 0.03 or (blocks == 0) ==
                            (expected[name]["read_length"] == 0)) else "DIVERGES"
            print(f"  {name:13s} sce={ours:.4f} minimap2={mm:.4f} "
                  f"Δ={delta:.4f} {flag}")
            bad += flag == "DIVERGES"
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--regen", action="store_true",
                    help="write the fixtures + expected.json into --fixtures")
    ap.add_argument("--minimap2", action="store_true",
                    help="also diff against a real minimap2 binary")
    ap.add_argument("--fixtures", default=None,
                    help=f"the fixtures' directory (default: {FIXTURES}, read only)")
    args = ap.parse_args(argv)
    if args.regen:
        if args.fixtures is None:
            ap.error("--regen needs --fixtures DIR: it never writes the committed fixtures")
        write_fixtures(Path(args.fixtures))
        return 0
    fixtures = Path(args.fixtures) if args.fixtures else FIXTURES
    print("sce mapper self-check vs committed expected.json:")
    bad = self_check(fixtures)
    if args.minimap2:
        print("cross-check vs minimap2 -x map-ont -c:")
        bad += minimap2_check(fixtures)
    print("PASS" if bad == 0 else f"FAIL ({bad} mismatches)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
