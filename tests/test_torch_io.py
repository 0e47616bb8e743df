"""The port's dataset IO (ravvent_tpu_torch/utils/io.py) against the JAX
package's (ravvent_tpu/utils/io.py), and fast5 input for the port's CLI.
Every comparison here is exact."""

import numpy as np
import pytest

from ravvent_tpu.utils import io as jio
from ravvent_tpu_torch.data import chiron, simulator
from ravvent_tpu_torch.utils import io as tio

pytest.importorskip("h5py")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_fast5_signal_matches_jax(tmp_path, writer):
    sig = np.random.default_rng(0).integers(-2000, 2000, 5000).astype(np.int16)
    p = tmp_path / "x.fast5"
    (jio if writer == "jax" else tio).create_minimal_fast5(sig, p, read_id="7")
    got, ref = tio.read_fast5_signal(p), jio.read_fast5_signal(p)
    assert got.dtype == ref.dtype == np.int64
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, sig)


@pytest.mark.parametrize("shuffle", [True, False])
def test_train_val_test_split_matches_jax(shuffle):
    data = [f"f{i}" for i in range(37)]
    for sizes in ((0.8, 0.1, 0.1), (0.5, 0.25, 0.25), (1.0, 0.0, 0.0)):
        assert (tio.train_val_test_split(data, *sizes, random_state=3, shuffle=shuffle)
                == jio.train_val_test_split(data, *sizes, random_state=3, shuffle=shuffle))
    with pytest.raises(ValueError):
        tio.train_val_test_split(data, 0.5, 0.5, 0.5)


def test_bases_sequence_from_chiron_dir_matches_jax(tmp_path):
    genome = simulator.random_genome(800, np.random.default_rng(2))
    simulator.generate_chiron_dataset(tmp_path, genome, n_reads=3, read_len_range=(100, 150))
    for max_length in (None, 50, 10_000):
        got = tio.get_bases_sequence_from_chiron_dir(tmp_path, max_length)
        assert got == jio.get_bases_sequence_from_chiron_dir(tmp_path, max_length)
    assert len(got) >= 300 and set(got) <= set("ACGT")


def test_cli_reads_fast5_as_signal_files(tmp_path):
    """The same reads as fast5 files and as unlabelled .signal files: the
    whole read is the region either way, so the FASTA is the same."""
    from ravvent_tpu_torch.tools.basecall import main

    rng = np.random.default_rng(5)
    f5, sg = tmp_path / "fast5", tmp_path / "signal"
    f5.mkdir()
    sg.mkdir()
    for i in range(2):
        seq = simulator.random_genome(300, rng)
        sig, _ = simulator.simulate_read(seq, rng, simulator.PoreModel())
        tio.create_minimal_fast5(sig, f5 / f"r{i}.fast5", read_id=str(i))
        np.savetxt(sg / f"r{i}.signal", np.asarray(sig)[None, :], fmt="%d")
        np.testing.assert_array_equal(chiron.load_signal(sg / f"r{i}.signal"), sig)
    outs = {}
    for d in (f5, sg):
        outs[d.name] = tmp_path / f"{d.name}.fasta"
        main(["--cpu", "--seed", "0", "--input", str(d), "--out", str(outs[d.name]),
              "--enc-units", "16", "--dec-units", "16", "--encoder-depth", "1"])
    fasta = outs["fast5"].read_text()
    assert fasta == outs["signal"].read_text()
    lines = fasta.splitlines()
    assert lines[0::2] == [">r0", ">r1"] and all(set(s) <= set("ACGT") and s for s in lines[1::2])


def test_cli_names_both_kinds_when_input_is_empty(tmp_path, capsys):
    from ravvent_tpu_torch.tools.basecall import main

    with pytest.raises(SystemExit) as e:
        main(["--cpu", "--input", str(tmp_path), "--out", str(tmp_path / "x.fasta"),
              "--enc-units", "16", "--dec-units", "16", "--encoder-depth", "1"])
    assert ".fast5" in str(e.value) and ".signal" in str(e.value)
    with pytest.raises(SystemExit):
        main(["--help"])
    assert ".fast5" in capsys.readouterr().out
