"""Inference engine: snippets in, per-snippet basecalls out.

Counterpart of ravvent_tpu/evaluation/basecall.py's ``BasecallEngine`` on
the settings of the basecalling CLI (tools/basecall.py): f32 encoder,
attention memory pre-projected and stored in bf16 (or f32), beam search by
one fused CUDA step kernel per decode step (``beam_impl="step"``) or by one
whole-loop kernel launch per chunk (``beam_impl="loop"``), the compact per-read input
gathered into snippets on the device, signal and event features sent as
f16 (the JAX engine's default wire), and the result packed into one u8
buffer per chunk (tokens as nibbles, step probabilities quantized to u8).

On a CUDA device the encoder runs the BiLSTM kernel (ops/rnn_cuda.py) and
the decoder the beam-step kernel (ops/beam_step_cuda.py) or the beam-loop
kernel (ops/beam_loop_cuda.py); on the CPU each runs its plain version. The
JAX engine pads each slab to a small ladder of row counts to bound
recompilation; PyTorch does not recompile, and rows are independent, so
this engine runs each chunk at its own row count.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ravvent_tpu_torch.config import MAX_TARGET_LEN, ModelConfig
from ravvent_tpu_torch.decode.beam import beam_scores_to_step_probs
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.basecaller import check_config, encode_input
from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop
from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop, fused_beam_decode
from ravvent_tpu_torch.ops.gather_rows import gather_rows
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.weights import to_device

TOTAL_STEPS = MAX_TARGET_LEN - 1  # static decode length; max_steps bounds it per call


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class PendingBeamCompact(NamedTuple):
    """In-flight read from :meth:`BasecallEngine.dispatch_beam_compact`: per
    chunk, the host buffer the packed result is being copied into, the CUDA
    event that marks the copy's end (None on the CPU) and the row count."""

    pending: list
    T_fetch: int


class BasecallEngine:
    def __init__(
        self,
        params,
        cfg: ModelConfig,
        chunk_size: int = 4096,
        memory_dtype: Optional[torch.dtype] = torch.bfloat16,
        pack_u8: bool = True,
        device: Union[str, torch.device, None] = None,
        beam_impl: str = "step",
    ) -> None:
        """``params``: the JAX tree's layout with tensor leaves (see
        weights.py). ``memory_dtype``: bf16 or None (f32) attention memory.
        ``pack_u8``: tokens as nibbles and step probabilities as u8 in the
        result buffer (else int8 tokens and f16 probabilities).
        ``beam_impl``: "step" (one kernel launch per decode step) or "loop"
        (one launch per chunk for the whole loop); both give the same beams."""
        check_config(cfg)
        if cfg.decoder_depth != 1:
            raise NotImplementedError("the fused beam kernels support decoder_depth=1")
        if memory_dtype not in (None, torch.bfloat16, torch.float32):
            raise ValueError("memory_dtype must be torch.bfloat16, torch.float32 or None")
        if beam_impl not in ("step", "loop"):
            raise ValueError(f"beam_impl must be 'step' or 'loop', got {beam_impl!r}")
        self.beam_impl = beam_impl
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.chunk_size = chunk_size
        self.memory_dtype = memory_dtype
        self.pack_u8 = pack_u8

    # ------------------------------------------------------------------ model

    @torch.inference_mode()
    def memory(self, raw: torch.Tensor, event: torch.Tensor,
               project: bool = True) -> attn.AttnMemory:
        """Encode device snippets raw [N, 200, 1], event [N, 30, 5] and set
        up the attention memory, S padded to a multiple of 8 as the
        reference pads it. ``project``: keys and pre-projected values in the
        engine's memory dtype, as the beam kernels take them; else
        un-projected f32 keys and values, as fused greedy decode takes them."""
        dec = self.params["decoder"]
        enc_out, mask = encode_input(self.params, raw, event, self.cfg)
        pad = (-enc_out.shape[1]) % 8
        enc_out = torch.nn.functional.pad(enc_out, (0, 0, 0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
        if not project:
            return attn.setup_memory(dec["attention"], enc_out, mask, torch.float32)
        return attn.setup_memory(dec["attention"], enc_out, mask, self.memory_dtype,
                                 attention_layer=dec["attention_layer"])

    @torch.inference_mode()
    def beam(self, raw: torch.Tensor, event: torch.Tensor, max_steps: int,
             beam_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode + beam decode device snippets raw [N, 200, 1], event
        [N, 30, 5]. Returns the top beam's (tokens [N, T] int32, step probs
        [N, T] f32) with T = TOTAL_STEPS."""
        loop = beam_loop if self.beam_impl == "loop" else beam_step_loop
        res = fused_beam_decode(self.params["decoder"], self.memory(raw, event),
                                self.cfg.vocab_size, beam_width, TOTAL_STEPS, max_steps,
                                start_token=NUC_TOKENIZER.start_id,
                                end_token=NUC_TOKENIZER.end_id, loop=loop)
        return res.tokens[:, :, 0], beam_scores_to_step_probs(res.scores[:, :, 0])

    def _fetch_width(self, max_output_len: int) -> int:
        return min(TOTAL_STEPS, ((max_output_len + 7) // 8) * 8)

    def predict_beam(self, raw: np.ndarray, event: np.ndarray, max_output_len: int,
                     beam_width: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """Beam decode materialized snippets; returns (tokens [N, T],
        step_probs [N, T]) of the top beam, T the fetch width."""
        T = self._fetch_width(max_output_len)
        toks, probs = [], []
        for s in range(0, raw.shape[0], self.chunk_size):
            r = torch.from_numpy(np.ascontiguousarray(raw[s:s + self.chunk_size], np.float32))
            e = torch.from_numpy(np.ascontiguousarray(event[s:s + self.chunk_size], np.float32))
            t, p = self.beam(r.to(self.device), e.to(self.device), max_output_len - 1, beam_width)
            toks.append(t[:, :T].cpu().numpy())
            probs.append(p[:, :T].cpu().numpy())
        return np.concatenate(toks), np.concatenate(probs)

    # ---------------------------------------------------------- compact path

    def predict_beam_compact(self, signal: np.ndarray, raw_ranges: np.ndarray,
                             events: np.ndarray, event_ranges: np.ndarray,
                             max_output_len: int, beam_width: int = 5,
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Beam decode a read from its compact representation
        (data/snippets.py:prepare_compact)."""
        return self.collect_beam_compact(self.dispatch_beam_compact(
            signal, raw_ranges, events, event_ranges, max_output_len, beam_width))

    @torch.inference_mode()
    def compact_snippets(self, signal: np.ndarray, raw_ranges: np.ndarray, events: np.ndarray,
                         event_ranges: np.ndarray):
        """Per chunk of a read in compact form: upload its signal and event
        slices over the f16 wire, gather its snippets on the device and
        yield them as raw [n, 200, 1], event [n, 30, 5]."""
        # ranges may extend past the arrays; slicing clips them, as the
        # materialized path does
        raw_ranges = np.minimum(raw_ranges, signal.shape[0])
        event_ranges = np.minimum(event_ranges, events.shape[0])
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)  # noqa: E731
        for s in range(0, raw_ranges.shape[0], self.chunk_size):
            rr = raw_ranges[s:s + self.chunk_size].astype(np.int64)
            er = event_ranges[s:s + self.chunk_size].astype(np.int64)
            lo_s, hi_s = int(rr[0, 0]), int(rr[:, 1].max())
            lo_e, hi_e = int(er[0, 0]), int(er[:, 1].max())
            sig = up(signal[lo_s:hi_s].astype(np.float16)).float()
            ev = up(events[lo_e:hi_e].astype(np.float16)).float()
            rr, er = up((rr - lo_s).astype(np.int32)), up((er - lo_e).astype(np.int32))
            raw = gather_rows(sig, rr[:, 0], rr[:, 1] - rr[:, 0], 200)[..., None]
            event = gather_rows(ev.reshape(-1), er[:, 0] * 5, (er[:, 1] - er[:, 0]) * 5,
                                150).reshape(-1, 30, 5)
            yield raw, event

    @torch.inference_mode()
    def _pack(self, tokens: torch.Tensor, probs: torch.Tensor, T_fetch: int) -> torch.Tensor:
        """The result bytes of one chunk: tokens as nibbles and step
        probabilities as u8 (pack_u8), else int8 tokens and f16 probs."""
        tokens, probs = tokens[:, :T_fetch], probs[:, :T_fetch]
        if not self.pack_u8:
            return torch.cat([tokens.to(torch.int8).view(torch.uint8),
                              probs.to(torch.float16).contiguous().view(torch.uint8)], dim=1)
        tok = tokens.to(torch.uint8)
        if T_fetch % 2:
            tok = torch.nn.functional.pad(tok, (0, 1))
        tok_b = tok[:, 0::2] | (tok[:, 1::2] << 4)
        prob_b = torch.round(probs.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        return torch.cat([tok_b, prob_b], dim=1)

    def dispatch_beam_compact(self, signal: np.ndarray, raw_ranges: np.ndarray,
                              events: np.ndarray, event_ranges: np.ndarray,
                              max_output_len: int, beam_width: int = 5) -> PendingBeamCompact:
        """Upload and enqueue all of a read's chunks, starting each result's
        copy to (pinned) host memory without waiting for it; pair with
        :meth:`collect_beam_compact`."""
        T_fetch = self._fetch_width(max_output_len)
        cuda = self.device.type == "cuda"
        pending = []
        for raw, event in self.compact_snippets(signal, raw_ranges, events, event_ranges):
            packed = self._pack(*self.beam(raw, event, max_output_len - 1, beam_width), T_fetch)
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=cuda)
            host.copy_(packed, non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            pending.append((host, done, raw.shape[0]))
        return PendingBeamCompact(pending, T_fetch)

    def collect_beam_compact(self, handle: PendingBeamCompact) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched read's copies and unpack the result bytes."""
        T = handle.T_fetch
        if not handle.pending:
            return np.zeros((0, T), np.int64), np.zeros((0, T), np.float32)
        toks, prbs = [], []
        for host, done, n in handle.pending:
            if done is not None:
                done.synchronize()
            arr = host.numpy()[:n]
            if self.pack_u8:
                Tb = (T + 1) // 2
                tok = np.empty((n, 2 * Tb), np.int64)
                tok[:, 0::2] = arr[:, :Tb] & 0xF
                tok[:, 1::2] = arr[:, :Tb] >> 4
                toks.append(tok[:, :T])
                prbs.append(arr[:, Tb:].astype(np.float32) / 255.0)
            else:
                toks.append(arr[:, :T].copy().view(np.int8).astype(np.int64))
                prbs.append(arr[:, T:].copy().view(np.float16).astype(np.float32))
        return np.concatenate(toks), np.concatenate(prbs)

    @staticmethod
    def tokens_to_sequences(tokens: np.ndarray) -> List[str]:
        return NUC_TOKENIZER.sequences_to_texts(tokens)
