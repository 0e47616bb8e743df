"""Nanopore signal simulation and reduced-vocabulary genome generation.

Replaces the reference's external DeepSimulator pipeline
(reference: data/generate_simulator_reduced.py, data/generate_simulated_from_chiron.py)
with a self-contained simulator so the framework ships runnable train/eval
data: a deterministic 6-mer pore model assigns each context a current level;
per-base dwell times (~9 samples/base, matching the reference's 8-10
samples/base regime) and Gaussian noise produce chiron-format
``.signal``/``.label`` reads.

Genome construction mirrors the reference's reduced 6-mer-vocabulary recipe
(data/generate_simulator_reduced.py:86-106): a genome assembled from a
restricted set of 6-mers, so dataset difficulty scales with the number of
distinct 6-mers appearing.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, asdict
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

BASES = np.array(list("ACGT"))
KMER = 6


@dataclass(frozen=True)
class SimProfile:
    """Signal-realism knobs (DeepSimulator's role in the reference pipeline,
    reference: data/generate_simulator_reduced.py:75-77).

    The ``clean`` profile reproduces the round-1 simulator exactly (ideal
    step levels + white noise); ``realistic`` adds the physical effects that
    make real nanopore signal hard — per-kmer noise spread, per-event level
    jitter, low-pass-filtered level transitions, dwell-time outliers,
    near-skipped bases, and slow baseline drift — so accuracy numbers are
    earned on degraded signal rather than on an idealized one.
    """

    name: str = "realistic"
    dwell_mean: float = 9.0
    dwell_min: int = 2
    dwell_max: int = 40
    noise_std: float = 9.0           # white-noise floor (DAC units)
    kmer_noise_sigma: float = 0.35   # lognormal sigma of per-kmer noise scale
    level_jitter: float = 4.0        # per-event level re-draw stdv (DAC)
    filter_alpha: float = 0.35       # one-pole low-pass coeff (1 = no filter)
    stall_prob: float = 0.01         # long-dwell outlier probability
    stall_scale: float = 4.0         # dwell multiplier for stalls
    skip_prob: float = 0.03          # base emits a single sample ("skip")
    drift_std: float = 6.0           # slow baseline wander amplitude (DAC)
    drift_step: int = 2000           # drift random-walk knot spacing (samples)


CLEAN = SimProfile(
    name="clean", dwell_min=4, kmer_noise_sigma=0.0, level_jitter=0.0,
    filter_alpha=1.0, stall_prob=0.0, skip_prob=0.0, drift_std=0.0,
)
# Realism ladder: each rung adds one family of physical effects on top of
# the previous one, so the noise-sweep table isolates which effect costs
# how much identity (DeepSimulator's realism role in the reference,
# data/generate_simulator_reduced.py:75-77). ``harsh`` is the round-2
# original "realistic" parameterization, kept as the stress bound.
LOWPASS = SimProfile(
    name="lowpass", dwell_min=4, kmer_noise_sigma=0.0, level_jitter=0.0,
    filter_alpha=0.5, stall_prob=0.0, skip_prob=0.0, drift_std=0.0,
)
NOISY = SimProfile(
    name="noisy", dwell_min=4, kmer_noise_sigma=0.25, level_jitter=2.0,
    filter_alpha=0.5, stall_prob=0.0, skip_prob=0.0, drift_std=4.0,
)
DYNAMIC = SimProfile(
    name="dynamic", dwell_min=2, kmer_noise_sigma=0.25, level_jitter=2.0,
    filter_alpha=0.5, stall_prob=0.01, stall_scale=3.0, skip_prob=0.015,
    drift_std=4.0,
)
HARSH = SimProfile(name="harsh")
REALISTIC = HARSH

PROFILES = {
    "clean": CLEAN, "lowpass": LOWPASS, "noisy": NOISY, "dynamic": DYNAMIC,
    "harsh": HARSH,
    # round-2 alias: "realistic" was the original name of the harshest rung
    "realistic": HARSH,
}

# ordered mild -> harsh, for the noise-sweep ladder
LADDER = ["clean", "lowpass", "noisy", "dynamic", "harsh"]


class PoreModel:
    """Deterministic 6-mer -> (current level, noise scale) model (seeded).

    Per-kmer noise scales play DeepSimulator's per-kmer stdv table: some
    contexts are intrinsically noisier than others, so noise is
    level-context-dependent rather than white across the read.
    """

    def __init__(self, seed: int = 1234, level_mean: float = 550.0, level_spread: float = 60.0,
                 kmer_noise_sigma: float = 0.35):
        rng = np.random.default_rng(seed)
        self.levels = rng.normal(level_mean, level_spread, size=4**KMER)
        if kmer_noise_sigma > 0:
            self.noise_scales = rng.lognormal(0.0, kmer_noise_sigma, size=4**KMER)
        else:
            self.noise_scales = np.ones(4**KMER)

    @staticmethod
    def kmer_ids(seq_ids: np.ndarray) -> np.ndarray:
        """Central 6-mer id per base (sequence padded with A's at the ends)."""
        n = len(seq_ids)
        padded = np.concatenate((np.zeros(KMER // 2, dtype=np.int64), seq_ids,
                                 np.zeros(KMER - 1 - KMER // 2, dtype=np.int64)))
        ids = np.zeros(n, dtype=np.int64)
        for k in range(KMER):
            ids = ids * 4 + padded[k : k + n]
        return ids

    def base_levels(self, seq: str) -> np.ndarray:
        seq_ids = encode_bases(seq)
        return self.levels[self.kmer_ids(seq_ids)]

    def base_noise_scales(self, seq: str) -> np.ndarray:
        seq_ids = encode_bases(seq)
        return self.noise_scales[self.kmer_ids(seq_ids)]


def encode_bases(seq: str) -> np.ndarray:
    lut = np.full(128, -1, dtype=np.int64)
    for i, b in enumerate("ACGT"):
        lut[ord(b)] = i
        lut[ord(b.lower())] = i
    ids = lut[np.frombuffer(seq.upper().encode(), dtype=np.uint8)]
    if (ids < 0).any():
        raise ValueError("non-ACGT base in sequence")
    return ids


def _lowpass(x: np.ndarray, alpha: float) -> np.ndarray:
    """One-pole low-pass (FIR-truncated exponential kernel): the amplifier
    response that smears level transitions in real nanopore signal. alpha=1
    is a passthrough; smaller alpha = stronger smoothing."""
    if alpha >= 1.0:
        return x
    n_taps = int(np.ceil(np.log(1e-3) / np.log(1.0 - alpha))) + 1
    k = alpha * (1.0 - alpha) ** np.arange(n_taps)
    k /= k.sum()
    # pad left with the first level so the read start isn't a step from 0
    xp = np.concatenate((np.full(n_taps - 1, x[0]), x))
    return np.convolve(xp, k, mode="valid")


def simulate_read(
    seq: str,
    rng: np.random.Generator,
    pore: PoreModel,
    dwell_mean: float = 9.0,
    dwell_min: int = 4,
    dwell_max: int = 40,
    noise_std: float = 9.0,
    profile: Optional[SimProfile] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate raw signal for ``seq``.

    Returns (signal int array, ranges [len(seq), 2]) where ranges are the
    chiron label [start, end) raw-sample spans per base. With a ``profile``
    the explicit dwell/noise args are taken from it; without one the
    round-1 clean behavior is preserved (callers passing only noise_std).
    """
    n = len(seq)
    if profile is not None:
        dwell_mean, dwell_min, dwell_max = (
            profile.dwell_mean, profile.dwell_min, profile.dwell_max)
        noise_std = profile.noise_std
    else:
        profile = SimProfile(
            name="legacy", dwell_mean=dwell_mean, dwell_min=dwell_min,
            dwell_max=dwell_max, noise_std=noise_std, kmer_noise_sigma=0.0,
            level_jitter=0.0, filter_alpha=1.0, stall_prob=0.0, skip_prob=0.0,
            drift_std=0.0,
        )

    levels = pore.base_levels(seq)
    if profile.level_jitter > 0:
        # each traversal of a context sits at a slightly different level
        levels = levels + rng.normal(0.0, profile.level_jitter, n)

    dwells = np.clip(
        np.round(rng.exponential(dwell_mean - dwell_min, n) + dwell_min),
        dwell_min,
        dwell_max,
    ).astype(np.int64)
    if profile.stall_prob > 0:
        stall = rng.random(n) < profile.stall_prob
        dwells = np.where(stall, np.minimum(
            (dwells * profile.stall_scale).astype(np.int64), 4 * dwell_max),
            dwells)
    if profile.skip_prob > 0:
        # a "skipped" base translocates too fast to resolve: one sample only
        # (the label keeps the base, so the model must learn through it)
        skipped = rng.random(n) < profile.skip_prob
        dwells = np.where(skipped, 1, dwells)

    ends = np.cumsum(dwells)
    starts = ends - dwells
    total = int(ends[-1])

    trace = np.repeat(levels, dwells)
    trace = _lowpass(trace, profile.filter_alpha)

    noise_scale = np.repeat(pore.base_noise_scales(seq), dwells) \
        if profile.kmer_noise_sigma > 0 else 1.0
    signal = trace + rng.normal(0.0, 1.0, total) * (noise_std * noise_scale)

    if profile.drift_std > 0:
        # slow baseline wander: random-walk knots, linearly interpolated
        n_knots = max(2, total // profile.drift_step + 2)
        knots = np.cumsum(rng.normal(0.0, 1.0, n_knots))
        knots = (knots - knots.mean()) * (profile.drift_std / max(knots.std(), 1e-9))
        xs = np.linspace(0, total - 1, n_knots)
        signal = signal + np.interp(np.arange(total), xs, knots)

    return np.round(signal).astype(np.int64), np.column_stack((starts, ends))


def generate_reduced_genome(
    n_base_kmers: int, length: int, rng: np.random.Generator
) -> str:
    """Genome from a restricted 6-mer vocabulary
    (reference: data/generate_simulator_reduced.py:86-106)."""
    kmers = set()
    while len(kmers) < n_base_kmers:
        kmers.add("".join(rng.choice(BASES, KMER)))
    kmer_list = sorted(kmers)
    n_chunks = length // KMER
    picks = rng.integers(0, len(kmer_list), n_chunks)
    return "".join(kmer_list[i] for i in picks)


def base_kmer_vocab(genome: str) -> List[str]:
    """Recover the base 6-mer vocabulary of a reduced genome (which is a
    concatenation of aligned 6-mer chunks)."""
    return sorted({genome[i : i + KMER] for i in range(0, len(genome) - KMER + 1, KMER)})


def genome_from_vocab(kmer_list: List[str], length: int, rng: np.random.Generator) -> str:
    """New genome drawn from an existing base-6-mer vocabulary — the
    cross-genome analog of the reference's lambda→ecoli transfer (real
    genomes share their 6-mer vocabulary; a fresh vocabulary draw would
    test out-of-vocabulary generalization instead)."""
    picks = rng.integers(0, len(kmer_list), length // KMER)
    return "".join(kmer_list[i] for i in picks)


def random_genome(length: int, rng: np.random.Generator) -> str:
    return "".join(rng.choice(BASES, length))


def write_fasta(path, name: str, seq: str) -> None:
    with open(path, "wt") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i : i + 80] + "\n")


def read_fasta(path) -> List[Tuple[str, str]]:
    out, name, chunks = [], None, []
    with open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(chunks)))
                name, chunks = line[1:], []
            elif line:
                chunks.append(line)
    if name is not None:
        out.append((name, "".join(chunks)))
    return out


def generate_chiron_dataset(
    out_dir,
    genome: str,
    n_reads: int,
    read_len_range: Tuple[int, int] = (2000, 6000),
    seed: int = 0,
    pore_seed: int = 1234,
    noise_std: float = 9.0,
    prefix: str = "read",
    profile: Optional[SimProfile] = None,
) -> List[Tuple[Path, Path]]:
    """Sample reads from ``genome`` and write chiron ``.signal``/``.label``
    pairs (the format the whole pipeline consumes,
    reference: data/generate_simulated_from_chiron.py:43-73). ``profile``
    selects the signal-realism model (see :class:`SimProfile`); None keeps
    the round-1 clean signal with the given ``noise_std``."""
    from ravvent_tpu_torch.data import chiron

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    pore = PoreModel(
        seed=pore_seed,
        kmer_noise_sigma=profile.kmer_noise_sigma if profile else 0.0,
    )
    pairs = []
    for r in range(n_reads):
        rl = int(rng.integers(read_len_range[0], read_len_range[1] + 1))
        start = int(rng.integers(0, max(1, len(genome) - rl)))
        seq = genome[start : start + rl]
        signal, ranges = simulate_read(seq, rng, pore, noise_std=noise_std,
                                       profile=profile)
        sp = out / f"{prefix}_{r:04d}.signal"
        lp = out / f"{prefix}_{r:04d}.label"
        chiron.write_read(sp, lp, signal, ranges, seq)
        pairs.append((sp, lp))
    meta = {
        "genome_len": len(genome),
        "n_reads": n_reads,
        "read_len_range": list(read_len_range),
        "seed": seed,
        "pore_seed": pore_seed,
        "noise_std": noise_std,
        "profile": asdict(profile) if profile else None,
    }
    with open(out / "dataset_meta.json", "wt") as f:
        json.dump(meta, f, indent=2)
    return pairs
