"""Build the canonical simulated datasets (train/val/test chiron files).

Counterpart of tools/make_dataset.py of the JAX package, on the port's copies
of data/simulator.py and data/chiron.py: with the same arguments and seed it
writes the same files, byte for byte. It replaces the reference's external
DeepSimulator data-generation pipeline (reference:
data/generate_simulated_from_chiron.py, data/generate_simulator_reduced.py)
with the built-in simulator. Datasets are deterministic in their seeds, so
they are reproduced rather than committed.

Two genome sources:
  --ref-reduced {45,450,1024,2048,4096}  use the reference's committed
      reduced-vocabulary genomes (``seq.*.{train,eval}.fasta`` of its
      data/simulator/reduced, in the directory ``RAVVENT_REF_REDUCED_DIR``
      names): the exact train/eval genome split of the reference's accuracy
      protocol (reference: data/generate_simulator_reduced.py:86-106). Train
      reads are sampled from the train genome, the cross split from the
      eval genome.
  --n-kmers K  regenerate a fresh reduced genome (K base 6-mers; 0 = fully
      random genome), the round-1 recipe, kept for ablations.

Signal realism via --profile (see data/simulator.py:SimProfile);
"realistic" is the default. ``--read-len MIN MAX`` sets the reads' length
range in bases (``read_len`` of the build functions, 6000-10000 by default).

Usage:
  python -m ravvent_tpu_torch.tools.make_dataset --out datasets/sim_lambda --n-kmers 43
  RAVVENT_REF_REDUCED_DIR=<dir> python -m ravvent_tpu_torch.tools.make_dataset \
      --out datasets/ref45 --ref-reduced 45
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from ravvent_tpu_torch.data import chiron, simulator

# vocab size (distinct 6-mers appearing) -> committed reference FASTA prefix
REF_REDUCED_SETS = {
    45: "seq.3.25000.45",
    450: "seq.12.75000.450",
    1024: "seq.21.150000.1024",
    2048: "seq.43.300000.2048",
    4096: "seq.4096.600000.4096",
}
REF_REDUCED_ENV = "RAVVENT_REF_REDUCED_DIR"


def load_ref_reduced_genomes(vocab_size: int):
    """Load the reference's committed (train, eval) genome pair for a
    difficulty level from the directory ``RAVVENT_REF_REDUCED_DIR`` names.
    Returns (train_genome, eval_genome, set_name)."""
    prefix = REF_REDUCED_SETS[vocab_size]
    root = os.environ.get(REF_REDUCED_ENV)
    if not root:
        raise FileNotFoundError(
            f"set {REF_REDUCED_ENV} to the directory of the reference's reduced genomes "
            f"(its data/simulator/reduced, holding {prefix}.train.fasta)")
    d = Path(root)
    train = simulator.read_fasta(d / f"{prefix}.train.fasta")
    eval_ = simulator.read_fasta(d / f"{prefix}.eval.fasta")
    tg = "".join(seq for _, seq in train)
    eg = "".join(seq for _, seq in eval_)
    return tg, eg, prefix


def build(out_dir, n_kmers=0, genome_len=300_000, train_reads=24, eval_reads=8,
          read_len=(6000, 10000), noise_std=9.0, seed=7, profile=None,
          train_genome=None, eval_genome=None, genome_name=None,
          cross_genome=None):
    """Write a chiron train/val/test dataset under ``out_dir``.

    Train and val/test reads are all sampled from ``train_genome`` (held-out
    READS, not a held-out genome), the reference's evaluation semantics: its
    lambda/ecoli identity tables score test READS of the genome the training
    reads came from (train_val_test_split of one file set, reference:
    utils.py:45-69, data_loader.py:158-177). ``cross_genome`` additionally
    writes a ``cross/`` split of reads from a DIFFERENT genome, a stricter,
    separate generalization metric. Returns the train, val and test
    indexes."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    if train_genome is None:
        if n_kmers > 0:
            train_genome = simulator.generate_reduced_genome(n_kmers, genome_len, rng)
        else:
            train_genome = simulator.random_genome(genome_len, rng)
        genome_name = genome_name or f"sim.{n_kmers}.{genome_len}"
    if eval_genome is None:
        eval_genome = train_genome
    simulator.write_fasta(out / "genome.train.fasta",
                          f"{genome_name or 'genome'}.train", train_genome)
    simulator.write_fasta(out / "genome.eval.fasta",
                          f"{genome_name or 'genome'}.eval", eval_genome)
    if cross_genome is not None:
        simulator.write_fasta(out / "genome.cross.fasta",
                              f"{genome_name or 'genome'}.cross", cross_genome)

    prof = simulator.PROFILES[profile] if isinstance(profile, str) else profile
    simulator.generate_chiron_dataset(
        out / "train", train_genome, n_reads=train_reads, read_len_range=read_len,
        seed=seed + 1, noise_std=noise_std, profile=prof,
    )
    simulator.generate_chiron_dataset(
        out / "eval", eval_genome, n_reads=eval_reads, read_len_range=read_len,
        seed=seed + 2, noise_std=noise_std, profile=prof,
    )
    fi_train = chiron.create_files_info(out / "train", stride=6, verbose=False)
    fi_eval = chiron.create_files_info(out / "eval", stride=6, verbose=False)
    # reference-style val/test split of the eval set (data_loader.py:158-177)
    eval_named = out / "eval" / "files_info.eval.snippets.stride_6.json"
    eval_named.write_text(Path(fi_eval).read_text())
    val_path, test_path = chiron.split_eval_files_info_into_test_validation(
        0.25, str(eval_named), seed=seed
    )
    if cross_genome is not None:
        simulator.generate_chiron_dataset(
            out / "cross", cross_genome, n_reads=eval_reads,
            read_len_range=read_len, seed=seed + 3, noise_std=noise_std,
            profile=prof,
        )
        fi_cross = chiron.create_files_info(out / "cross", stride=6, verbose=False)
        print(f"cross index: {fi_cross}")
    print(f"train index: {fi_train}")
    print(f"val index:   {val_path}")
    print(f"test index:  {test_path}")
    return fi_train, val_path, test_path


def build_ref_reduced(out_dir, vocab_size, train_reads=None, eval_reads=8,
                      read_len=(6000, 10000), profile="realistic", seed=7,
                      coverage=8.0):
    """Dataset anchored on the reference's committed genomes for one
    difficulty level. ``train_reads=None`` sizes the read set to
    ~``coverage``x genome coverage (capped at 320 reads)."""
    tg, eg, name = load_ref_reduced_genomes(vocab_size)
    if train_reads is None:
        mean_len = (read_len[0] + read_len[1]) / 2
        train_reads = int(min(320, max(16, round(coverage * len(tg) / mean_len))))
    print(f"{name}: train genome {len(tg)}bp -> {train_reads} train reads + "
          f"{eval_reads} held-out reads; cross genome {len(eg)}bp -> "
          f"{eval_reads} reads; profile={profile}")
    return build(
        out_dir, train_reads=train_reads, eval_reads=eval_reads,
        read_len=read_len, seed=seed, profile=profile,
        train_genome=tg, eval_genome=tg, cross_genome=eg, genome_name=name,
    )


def build_cross_eval(out_dir, src_dataset, n_reads=8, genome_len=300_000,
                     read_len=(6000, 10000), seed=107, profile="realistic"):
    """Eval-only cross-genome dataset: a fresh genome drawn from the SOURCE
    dataset's base-6-mer vocabulary (the lambda->ecoli transfer analog: real
    genomes share their 6-mer vocabulary, so cross-genome eval tests
    sequence generalization, not out-of-vocabulary k-mers). Layout:
    ``<out>/test/files_info.snippets.stride_6.json`` (test split only)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    src = Path(src_dataset)
    src_genome = "".join(s for _, s in simulator.read_fasta(src / "genome.train.fasta"))
    vocab = simulator.base_kmer_vocab(src_genome)
    genome = simulator.genome_from_vocab(vocab, genome_len, rng)
    simulator.write_fasta(out / "genome.fasta", f"cross.{src.name}", genome)
    prof = simulator.PROFILES[profile] if isinstance(profile, str) else profile
    simulator.generate_chiron_dataset(
        out / "test", genome, n_reads=n_reads, read_len_range=read_len,
        seed=seed + 1, noise_std=9.0, profile=prof,
    )
    fi = chiron.create_files_info(out / "test", stride=6, verbose=False)
    print(f"cross-eval test index: {fi} ({len(vocab)} base 6-mers from {src})")
    return fi


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="datasets/sim_lambda")
    ap.add_argument("--cross-from", default=None,
                    help="build an eval-only cross-genome dataset drawn from "
                         "this source dataset's base-6-mer vocabulary")
    ap.add_argument("--ref-reduced", type=int, default=0,
                    choices=[0] + sorted(REF_REDUCED_SETS),
                    help="use the reference's committed reduced genome set "
                         f"of this vocab size (0 = generate a genome instead; "
                         f"read from ${REF_REDUCED_ENV})")
    ap.add_argument("--n-kmers", type=int, default=43)
    ap.add_argument("--genome-len", type=int, default=300_000)
    ap.add_argument("--train-reads", type=int, default=0,
                    help="0 = coverage-sized for --ref-reduced, 24 otherwise")
    ap.add_argument("--eval-reads", type=int, default=8)
    ap.add_argument("--read-len", type=int, nargs=2, default=(6000, 10000),
                    metavar=("MIN", "MAX"), help="read length range in bases")
    ap.add_argument("--coverage", type=float, default=8.0)
    ap.add_argument("--noise-std", type=float, default=9.0)
    ap.add_argument("--profile", default="realistic",
                    choices=sorted(simulator.PROFILES) + ["legacy"],
                    help="signal realism (legacy = round-1 white-noise model)")
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    profile = None if args.profile == "legacy" else args.profile
    read_len = tuple(args.read_len)
    if args.cross_from:
        return build_cross_eval(
            args.out, args.cross_from, n_reads=args.eval_reads,
            genome_len=args.genome_len, read_len=read_len, seed=args.seed + 100,
            profile=profile,
        )
    if args.ref_reduced:
        return build_ref_reduced(
            args.out, args.ref_reduced,
            train_reads=args.train_reads or None, eval_reads=args.eval_reads,
            read_len=read_len, profile=profile, seed=args.seed, coverage=args.coverage,
        )
    return build(args.out, args.n_kmers, args.genome_len, args.train_reads or 24,
                 args.eval_reads, read_len=read_len, noise_std=args.noise_std,
                 seed=args.seed, profile=profile)


if __name__ == "__main__":
    main()
