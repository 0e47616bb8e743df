"""Character tokenizer for nucleotide sequences.

Reproduces the reference's fixed keras Tokenizer vocabulary
(data_loader.py:20-26): ``{'':0, '^':1, '$':2, 'a':3, 'c':4, 'g':5, 't':6}``
with ``$`` = start, ``^`` = end, ``''`` = pad, and the reference's
token->string conversion (basecaller.py:289-294): join, strip start/end/pad,
uppercase.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


class NucTokenizer:
    WORD_INDEX = {"": 0, "^": 1, "$": 2, "a": 3, "c": 4, "g": 5, "t": 6}

    def __init__(self) -> None:
        self.word_index = dict(self.WORD_INDEX)
        self.index_word = {v: k for k, v in self.word_index.items()}
        self.pad_id = self.word_index[""]
        self.end_id = self.word_index["^"]
        self.start_id = self.word_index["$"]
        # Fast lookup table over ASCII codes (lowercased input).
        self._lut = np.zeros(128, dtype=np.int64)
        for ch, idx in self.word_index.items():
            if ch:
                self._lut[ord(ch)] = idx

    @property
    def vocab_size(self) -> int:
        return len(self.word_index)

    def texts_to_sequences(self, texts: Iterable[str]) -> List[np.ndarray]:
        """Char-level tokenization, lowercasing like the reference tokenizer."""
        out = []
        for t in texts:
            codes = np.frombuffer(t.lower().encode("ascii"), dtype=np.uint8)
            out.append(self._lut[codes])
        return out

    def pad_sequences(
        self, seqs: Sequence[np.ndarray], maxlen: int | None = None
    ) -> np.ndarray:
        """Post-pad with the pad token (reference: data_loader.py:124).

        ``maxlen=None`` pads to the batch max (reference behavior); a fixed
        ``maxlen`` gives the static shapes the TPU path needs (post-truncating,
        matching keras ``pad_sequences(..., truncating='post')``).
        """
        if maxlen is None:
            maxlen = max((len(s) for s in seqs), default=0)
        out = np.full((len(seqs), maxlen), self.pad_id, dtype=np.int64)
        for i, s in enumerate(seqs):
            n = min(len(s), maxlen)
            out[i, :n] = s[:n]
        return out

    def sequences_to_texts(self, tokens: np.ndarray) -> List[str]:
        """Token rows -> uppercase base strings, start/end/pad stripped
        (reference: basecaller.py:289-294)."""
        seqs, _, _ = self.sequences_to_texts_flat(tokens)
        return seqs

    def sequences_to_texts_flat(self, tokens: np.ndarray):
        """Vectorized token->string conversion returning, alongside the per-row
        strings, the flat base-call blob and row offsets: one whole-array
        compress + one decode, with rows recovered as slices of the big string
        (per-row numpy masking costs ~10ms/read at production sizes; the flat
        blob also feeds the native merge without re-joining the rows).

        Returns ``(seqs, blob, offsets)``: ``blob`` is the concatenation of
        all rows as ASCII bytes, ``offsets[i]:offsets[i+1]`` delimits row i in
        it (and in any array compressed with :meth:`base_mask`)."""
        tokens = np.asarray(tokens)
        mask = self.base_mask(tokens)
        lut = np.zeros(256, dtype=np.uint8)
        for b in "acgt":
            lut[self.word_index[b]] = ord(b.upper())
        offsets = np.zeros(tokens.shape[0] + 1, dtype=np.int64)
        np.cumsum(mask.sum(axis=1), out=offsets[1:])
        blob = lut[tokens.astype(np.uint8)][mask].tobytes()
        big = blob.decode("ascii")
        seqs = [big[offsets[i] : offsets[i + 1]] for i in range(tokens.shape[0])]
        return seqs, blob, offsets

    def base_mask(self, tokens: np.ndarray) -> np.ndarray:
        """Boolean mask of base (a/c/g/t) tokens — the positions that survive
        sequences_to_texts stripping."""
        tokens = np.asarray(tokens)
        return (tokens >= self.word_index["a"]) & (
            tokens <= self.word_index["t"]
        )


NUC_TOKENIZER = NucTokenizer()
