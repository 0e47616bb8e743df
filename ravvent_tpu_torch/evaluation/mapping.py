"""Read-level accuracy evaluation: mapping identity.

Counterpart of ravvent_tpu/evaluation/mapping.py on the compact wire: per
read, the snippets of its signal are beam-decoded by the engine, their
tokens and step probabilities merged into one read (confidence gate, merge
fold with the raw-range positional prior), and the merged read mapped
against the read's reference sequence for a PAF-style (matches, block_len)
identity. ``compute_total_results`` is the reference's aggregation
(ref-length-weighted identity, unmapped reads scored 0).

Mapping backend: ``minimap2 -x map-ont -c`` through a subprocess when the
binary is on PATH (the metric of record); otherwise the built-in
seed-chain-extend mapper (assembly/sce_mapper.py), flagged in each record
as ``mapper``. With ``wire="sigdev"`` or ``"sigdev8"`` a read's raw samples
are the only upload and the device segments it
(BasecallEngine.predict_beam_signal); the decode bound still comes from the
labels, and the merge's gate and positional prior from the device's snippet
ranges. With an engine of ``n_beams > 1`` the compact wire picks one beam a
snippet by junction overlap agreement before the gate and the fold
(:meth:`MappingEvaluator._select_beams`); the signal-only wire takes the top
beam, as the reference does.
"""

from __future__ import annotations

import json
import os
import shlex
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ravvent_tpu_torch.assembly import sce_mapper
from ravvent_tpu_torch.assembly.merger import (
    CONF_GATE_DEFAULT, Merger, SeqLogitsPair, expected_overlaps_from_ranges,
)
from ravvent_tpu_torch.data import chiron
from ravvent_tpu_torch.data.snippets import load_read_compact_ex
from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
from ravvent_tpu_torch.evaluation.performance import (
    EVALUATOR_WIRES, flatten_calls, gate_snippets, merge_snippets,
)
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER

BEAM_WIDTH_DEFAULT = 5


def minimap2_available() -> bool:
    return shutil.which("minimap2") is not None


class MappingEvaluator:
    def __init__(
        self,
        engine: Optional[BasecallEngine] = None,
        merger_scores_id: int = 0,
        stride: int = 6,
        beam_width: int = BEAM_WIDTH_DEFAULT,
        cache_dir: Optional[str] = None,
        use_minimap2: Optional[bool] = None,
        wire: str = "compact",
        geom_arbitration="default",
        conf_gate="default",
    ) -> None:
        """``geom_arbitration``: the merge fold's geometry gate, "default"
        (the Merger's) or None (the reference fold). ``conf_gate``: the
        confidence gate's parameters, "default" or None (off).
        ``use_minimap2``: None maps with minimap2 when it is on PATH.
        ``wire``: "compact", "sigdev" (i16 raw samples) or "sigdev8" (u8
        window-quantized samples)."""
        if wire not in EVALUATOR_WIRES:
            raise ValueError(f"wire must be one of {EVALUATOR_WIRES}, got {wire!r}")
        if geom_arbitration == "default":
            geom_arbitration = Merger.DEFAULT_GEOM_ARBITRATION
        self.conf_gate = CONF_GATE_DEFAULT if conf_gate == "default" else conf_gate
        self.merger = Merger(scores_id=merger_scores_id, geom_arbitration=geom_arbitration)
        self.stride = stride
        self.engine = engine
        self.beam_width = beam_width
        self.cache_dir = cache_dir
        self.use_minimap2 = minimap2_available() if use_minimap2 is None else use_minimap2
        self.wire = wire
        self.sig_wire = "u8" if wire == "sigdev8" else "i16"

    def basecall_read(self, signal_path, label_path=None) -> SeqLogitsPair:
        """Snippets, chunked beam decode and merge of one read; the decode
        is bounded by the ground truth's widest target, as in the
        reference. On the signal-only wire a read whose segmentation buffer
        overflows takes the compact wire."""
        if label_path is None:
            label_path = Path(signal_path).with_suffix(".label")
        if self.wire != "compact":
            out = self._basecall_read_sigdev(signal_path, label_path)
            if out is not None:
                return out
        sig, rr, ev, er, nuc, aux = load_read_compact_ex(signal_path, label_path, self.stride,
                                                         cache_dir=self.cache_dir)
        if rr.shape[0] == 0:
            return SeqLogitsPair("", [])
        max_output_len = int((nuc != 0).sum(axis=1).max())
        tokens, probs = self.engine.predict_beam_compact(sig, rr, ev, er, max_output_len,
                                                         self.beam_width, aux=aux)
        if tokens.ndim == 3:  # n_beams > 1: the phase-aware beam selection
            tokens, probs = self._select_beams(tokens, probs, rr)
        return self._merge(tokens, probs, rr)

    def _merge(self, tokens, probs, rr) -> SeqLogitsPair:
        return merge_snippets(self.merger,
                              *gate_snippets(self.conf_gate, *flatten_calls(tokens, probs), rr))

    def _select_beams(self, tokens, probs, rr):
        """Pick one beam per snippet by junction overlap agreement (Viterbi;
        assembly/merger.py:Merger.select_beams_by_overlap), the reference's
        fix for the decode phase on periodic genomes
        (ravvent_tpu/evaluation/mapping.py:156-176). tokens/probs
        [N, K, T] -> [N, T]."""
        N, K, T = tokens.shape
        flat = tokens.reshape(N * K, T)
        seqs, _, offs = NUC_TOKENIZER.sequences_to_texts_flat(flat)
        beam_seqs = [seqs[i * K:(i + 1) * K] for i in range(N)]
        cnts = np.diff(offs).reshape(N, K)
        p = np.asarray(probs, np.float64).reshape(N * K, T)
        step_mask = np.arange(T)[None, :] < np.diff(offs)[:, None]
        lp = np.where(step_mask, np.log(np.clip(p, 1e-9, 1.0)), 0.0)
        lp = lp.sum(axis=1).reshape(N, K)
        eo = expected_overlaps_from_ranges(rr, cnts[:, 0]) if N > 1 else None
        sel = self.merger.select_beams_by_overlap(beam_seqs, lp, eo)
        idx = np.arange(N)
        return tokens[idx, sel], np.asarray(probs)[idx, sel]

    def _basecall_read_sigdev(self, signal_path, label_path) -> Optional[SeqLogitsPair]:
        """The signal-only wire (ravvent_tpu/evaluation/mapping.py:178-227):
        the raw samples are the only upload; the decode bound comes from the
        labels when they exist. None when the segmentation buffer
        overflows."""
        raw = chiron.load_signal(signal_path)
        max_output_len = None
        if Path(label_path).exists():
            nuc = load_read_compact_ex(signal_path, label_path, self.stride,
                                       cache_dir=self.cache_dir)[4]
            if nuc.shape[0]:
                max_output_len = int((nuc != 0).sum(axis=1).max())
        out = self.engine.predict_beam_signal(raw, max_output_len=max_output_len,
                                              beam_width=self.beam_width, stride=self.stride,
                                              sig_wire=self.sig_wire, return_ranges=True)
        if out is None:
            return None
        tokens, probs, rr = out
        if tokens.ndim == 3:
            # n_beams > 1: the reference selects no beam on this wire and
            # takes the top one (ravvent_tpu/evaluation/mapping.py:200-205)
            tokens, probs = tokens[:, 0], probs[:, 0]
        if tokens.shape[0] == 0:
            return SeqLogitsPair("", [])
        return self._merge(tokens, probs, rr)

    def run(self, signal_data_source, chunk_size: int = 1024) -> Dict:
        """Per-read identity record (``chunk_size`` is the reference's
        argument and unused: the engine has its own)."""
        label_path = Path(signal_data_source).with_suffix(".label")
        _, syms = chiron.load_label(label_path)
        merged_seq = self.basecall_read(signal_data_source, label_path).seq
        return self.map_identity(merged_seq, "".join(syms))

    def map_identity(self, pred_seq: str, ref_seq: str) -> Dict:
        if self.use_minimap2:
            return self._minimap2_identity(pred_seq, ref_seq)
        return self._native_identity(pred_seq, ref_seq)

    def _minimap2_identity(self, pred_seq: str, ref_seq: str) -> Dict:
        with tempfile.TemporaryDirectory() as td:
            fasta = os.path.join(td, "ref.fasta")
            fastq = os.path.join(td, "pred.fastq")
            paf = os.path.join(td, "mapping.paf")
            with open(fasta, "wt") as f:
                f.write(f">{ref_seq[:10]}\n{ref_seq}")
            with open(fastq, "wt") as f:
                f.write(f"@{pred_seq[:10]}\n{pred_seq}\n+\n" + "!" * len(pred_seq))
            cmd = f"minimap2 -x map-ont -c {fasta} {fastq}"
            with open(paf, "wt") as f:
                subprocess.run(shlex.split(cmd), stdout=f, stderr=subprocess.DEVNULL)
            res = self._read_mapping_identity(paf)
        res["mapper"] = "minimap2"
        return res

    @staticmethod
    def _read_mapping_identity(mapping_path) -> Dict:
        """PAF: identity = sum(matches) / sum(block_len) over all mapping
        lines."""
        matches, total_blocks_len, read_length = 0, 0, 0
        with open(mapping_path, "rt") as paf:
            for line in paf:
                parts = line.strip().split("\t")
                if len(parts) < 11:
                    continue
                read_length = int(parts[1])
                matches += int(parts[9])
                total_blocks_len += int(parts[10])
        return {
            "read_length": read_length,
            "matches": matches,
            "total_block_len": total_blocks_len,
            "identity": matches / total_blocks_len if total_blocks_len != 0 else 0.0,
        }

    @staticmethod
    def _native_identity(pred_seq: str, ref_seq: str) -> Dict:
        """The built-in minimap2 substitute (assembly/sce_mapper.py): soft
        clipping, split mapping, both strands; a read with no chain is
        unmapped (read_length 0), the reference's 'invalid read'."""
        return sce_mapper.map_identity(pred_seq, ref_seq)

    @staticmethod
    def compute_total_results(results_path) -> tuple:
        """(identity_total %, identity_valid %, invalid %) over per-read
        records, each rounded to 3 places, as the reference aggregates."""
        with open(results_path, "rt") as f:
            results = json.load(f)
        wx_total = w_total = wx_valid = w_valid = 0.0
        invalid_num = 0
        for res in results:
            identity = 0.0
            if res["read_length"] != 0:
                identity = res["matches"] / res["total_block_len"]
                wx_valid += identity * res["ref_length"]
                w_valid += res["ref_length"]
            else:
                invalid_num += 1
            wx_total += identity * res["ref_length"]
            w_total += res["ref_length"]
        identity_score_total = wx_total / w_total * 100 if w_valid > 0 else 0
        identity_score_valid = wx_valid / w_valid * 100 if w_valid > 0 else 0
        invalid_frac = invalid_num / len(results) * 100
        return (round(identity_score_total, 3), round(identity_score_valid, 3),
                round(invalid_frac, 3))

    def evaluate_files(self, files_info_path, results_path, verbose: bool = True) -> List[Dict]:
        """Every read of a files-info JSON, the results written to
        ``results_path`` after each read (an interrupted sweep loses at most
        one read)."""
        with open(files_info_path, "rt") as f:
            val_files = [v["signal_path"] for v in json.load(f)]
        os.makedirs(os.path.dirname(str(results_path)) or ".", exist_ok=True)
        res: List[Dict] = []
        for v in val_files:
            if verbose:
                print(f"Running {v}", flush=True)
            ident_read = self.run(v)
            ident_read["path"] = v
            label = np.loadtxt(str(v).replace(".signal", ".label"), dtype=object)
            ident_read["ref_length"] = int(label.shape[0])
            res.append(ident_read)
            with open(results_path, "wt") as f:
                json.dump(res, f, indent=2)
        return res
