"""Inference engine: snippets in, per-snippet basecalls out.

Counterpart of ravvent_tpu/evaluation/basecall.py's ``BasecallEngine``, beam
decode on the compact path. The encoder runs in f32 or on a bf16 stream
(``encoder_dtype``); the attention memory is pre-projected and stored in
bf16, f32 or int8 (``memory_dtype="i8"|"i8mxu"``, the step kernel's int8
variants); beam search runs one fused CUDA step kernel per decode step
(``beam_impl="step"``) or one whole-loop kernel launch per chunk
(``beam_impl="loop"``). A read in compact form travels to the device once
per chunk, as one u8 buffer in the wire format ``transport_dtype`` (the JAX
engine's "f16", "f32", "i8", "i8sig" or "i8dev", basecall.py:839-1021),
is unpacked and gathered into snippets there, and the result comes back as
one u8 buffer per chunk (tokens as nibbles, step probabilities quantized to
8 or 4 bits). The defaults are the basecalling CLI's settings (f32 encoder,
f16 wire, 8-bit probabilities); bench.py's main path is
``encoder_dtype=torch.bfloat16, transport_dtype="i8dev", prob_bits=4``.

On a CUDA device the encoder runs the BiLSTM kernel of its stream
(ops/rnn_cuda.py) and the decoder the beam-step kernel
(ops/beam_step_cuda.py) or the beam-loop kernel (ops/beam_loop_cuda.py); on
the CPU each runs its plain version. The JAX engine pads each slab to a
small ladder of row counts to bound recompilation; PyTorch does not
recompile, and rows are independent, so this engine runs each chunk at its
own row count. Both split a read at the same rows (multiples of
``chunk_size``), so the i8 wires' per-chunk scales are the JAX slabs'.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ravvent_tpu_torch.config import MAX_TARGET_LEN, ModelConfig
from ravvent_tpu_torch.decode.beam import beam_scores_to_step_probs
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.basecaller import check_config, encode_input
from ravvent_tpu_torch.models.rnn import kernel_weights, stream_weights
from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop
from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop, fused_beam_decode
from ravvent_tpu_torch.ops.gather_rows import gather_rows
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.weights import to_device

TOTAL_STEPS = MAX_TARGET_LEN - 1  # static decode length; max_steps bounds it per call
WIRES = ("f16", "f32", "i8", "i8sig", "i8dev")
_TORCH_DTYPES = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32, np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``cuda`` unless the caller asks for another device; raises when CUDA
    is asked for (or defaulted to) and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def _device_event_features(sig: torch.Tensor, lens: torch.Tensor, n_ev: int,
                           hdr1: torch.Tensor, ovr: torch.Tensor) -> torch.Tensor:
    """The 5 scaled event features [E, 5] f32 recomputed from the uploaded
    z-scored signal ``sig`` [S] and the (patched) event lengths ``lens`` [E]
    of a chunk — the "i8dev" wire (ravvent_tpu/evaluation/basecall.py:42-90).

    Events tile the chunk's signal from local coordinate 0, so their starts
    are an exclusive cumsum of the lengths. Segment mean and variance of the
    z-scored signal map back to raw units through the affine (hdr1[10],
    hdr1[11]); hdr1[0:5] and hdr1[5:10] are the scaler's mean and std, and
    hdr1[12] is the true raw-unit mean of the chunk's first event, for row
    1's delta mean. ``ovr`` [2, 5] holds the host features of rows 0 and
    n_ev - 1, whose host spans were not the patched ones.

    The reference's formula, evaluated in f64: a segment's variance is a
    difference of two signal cumsums, which cancels badly in f32 once a
    chunk's cumsums grow (tests/test_torch_wire.py prints how far the
    reference's f32 features stray from the exact ones)."""
    E, S = lens.shape[0], sig.shape[0]
    rows = torch.arange(E, device=sig.device)
    lens_v = torch.where(rows < n_ev, lens, torch.zeros_like(lens)).long()
    lens_safe = lens_v.clamp(min=1)
    ends = torch.cumsum(lens_v, 0)
    starts = ends - lens_v
    x = sig.double()
    zero = x.new_zeros(1)
    cs = torch.cat([zero, torch.cumsum(x, 0)])
    cq = torch.cat([zero, torch.cumsum(x * x, 0)])
    s_idx, e_idx = starts.clamp(0, S), ends.clamp(0, S)
    mean_z = (cs[e_idx] - cs[s_idx]) / lens_safe
    var_z = (cq[e_idx] - cq[s_idx]) / lens_safe - mean_z * mean_z
    h = hdr1.double()
    rm, rs = h[10], h[11]
    mean = rm + rs * mean_z
    # the host's FLT_MIN clamp, in raw units
    stdv = torch.sqrt(torch.clamp(rs * rs * var_z, min=1.1754944e-38))
    chain_mean = torch.where(rows == 0, h[12], mean)
    dmean = mean - torch.cat([chain_mean[:1], chain_mean[:-1]])
    feats = torch.stack([lens_v.double(), mean, stdv, mean * mean, dmean], dim=1)
    feats = ((feats - h[None, 0:5]) / h[None, 5:10]).float()
    feats = torch.where(rows[:, None] == 0, ovr[0][None, :], feats)
    return torch.where(rows[:, None] == n_ev - 1, ovr[1][None, :], feats)


def _device_snippet_ranges(lens: torch.Tensor, n_snip: int, n_ev: int, n_rows: int,
                           stride: int, raw_max_len: int = 200, max_window: int = 256,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-snippet (raw [n_rows, 2], event [n_rows, 2]) int32 index ranges
    derived from the (patched) event lengths, in integers, as the host rule
    gives them (data/snippets.py:compute_fitting_event_ranges and
    convert_events_ranges_to_raw_ranges; ravvent_tpu/evaluation/basecall.py:93-153):
    every ``stride`` events, the window is the longest run of events whose
    cumulative length stays <= raw_max_len, never past event ``n_ev``; the
    raw range runs from the first event's start to the *start* of the last
    event. Rows >= ``n_snip`` are zero. Each row scans ``max_window``
    cumsum values, exact while a window holds fewer events (events are >= 1
    sample each, so a window holds <= raw_max_len + 1)."""
    dev = lens.device
    row = torch.arange(n_rows, device=dev)
    es = row * stride  # the window's first event
    cum = torch.cumsum(lens.long(), 0)
    W = max_window
    need = (n_rows - 1) * stride + W + 2
    # arr[j + 2] = cum[j], arr[0] = arr[1] = 0: w[r, k] = cum[es + k - 2]
    arr = torch.cat([cum.new_zeros(2), cum, cum.new_zeros(max(need - cum.shape[0] - 2, 0))])
    w = arr.unfold(0, W + 2, stride)[:n_rows]  # [n_rows, W + 2]
    offset = w[:, 1]  # cum[es - 1]: the first event's start
    k = torch.arange(W, device=dev)[None, :]
    fits = (w[:, 2:] <= (raw_max_len + offset)[:, None]) & (es[:, None] + k < n_ev)
    cnt = fits.sum(dim=1)
    ee = es + cnt  # the window's end event (exclusive)
    r_hi = w.gather(1, cnt[:, None])[:, 0]  # cum[ee - 2]: the last event's start
    valid = row < n_snip
    zero = torch.zeros((), dtype=torch.long, device=dev)
    er = torch.stack([torch.where(valid, es, zero), torch.where(valid, ee, zero)], dim=1)
    rr = torch.stack([torch.where(valid, offset, zero), torch.where(valid, r_hi, zero)], dim=1)
    return rr.to(torch.int32), er.to(torch.int32)


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
        memory_dtype: Union[torch.dtype, str, None] = torch.bfloat16,
        pack_u8: bool = True,
        device: Union[str, torch.device, None] = None,
        beam_impl: str = "step",
        encoder_dtype: Optional[torch.dtype] = None,
        transport_dtype: str = "f16",
        prob_bits: int = 8,
    ) -> None:
        """``params``: the JAX tree's layout with tensor leaves (see
        weights.py). ``memory_dtype``: bf16 or None (f32) attention memory,
        or int8 codes with per-(row, position) scales: "i8" (the step's
        dequantized dots) or "i8mxu" (its s8 x s8 -> s32 dots), with
        ``beam_impl="step"`` only (basecall.py:322-328 of the JAX package).
        ``pack_u8``: tokens as nibbles and step probabilities as u8 in the
        result buffer (else int8 tokens and f16 probabilities); with
        ``prob_bits=4`` the probabilities are nibbles too.
        ``beam_impl``: "step" (one kernel launch per decode step) or "loop"
        (one launch per chunk for the whole loop); both give the same beams.
        ``encoder_dtype``: None (f32) or torch.bfloat16, the encoder stream:
        bf16 inputs, weights and inter-layer sequences, f32 state and
        accumulation. ``transport_dtype``: the compact path's wire, one of
        ``WIRES`` — "f16" and "f32" send the signal and event features in
        that type; "i8" quantizes both with per-chunk max-abs scales, "i8sig"
        only the signal; "i8dev" sends the i8 signal and u16 event lengths
        and recomputes the features and snippet ranges on the device (needs
        the ``aux`` dict of data/snippets.py:load_read_compact_ex)."""
        check_config(cfg)
        if cfg.decoder_depth != 1:
            raise NotImplementedError("the fused beam kernels support decoder_depth=1")
        if memory_dtype not in (None, torch.bfloat16, torch.float32, "i8", "i8mxu"):
            raise ValueError("memory_dtype must be torch.bfloat16, torch.float32, None, "
                             "'i8' or 'i8mxu'")
        if beam_impl not in ("step", "loop"):
            raise ValueError(f"beam_impl must be 'step' or 'loop', got {beam_impl!r}")
        if isinstance(memory_dtype, str) and beam_impl != "step":
            raise ValueError("int8 memory requires beam_impl='step'")
        if encoder_dtype not in (None, torch.bfloat16):
            raise ValueError("encoder_dtype must be None (f32) or torch.bfloat16")
        if transport_dtype not in WIRES:
            raise ValueError(f"transport_dtype must be one of {WIRES}, got {transport_dtype!r}")
        if prob_bits not in (8, 4):
            raise ValueError(f"prob_bits must be 8 or 4, got {prob_bits!r}")
        self.beam_impl = beam_impl
        self.device = resolve_device(device)
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.chunk_size = chunk_size
        self.quant_mxu = memory_dtype == "i8mxu"
        self.memory_dtype = "i8" if self.quant_mxu else memory_dtype
        self.pack_u8 = pack_u8
        self.encoder_dtype = encoder_dtype
        self.transport_dtype = transport_dtype
        self.prob_bits = prob_bits
        # the encoders' weights in the stream dtype, cast once, and in the
        # stream's kernel layout, laid out once
        self._enc_weights = {
            k: kernel_weights(stream_weights(self.params[k], encoder_dtype or torch.float32))
            for k in ("encoder_raw", "encoder_event")}

    # ------------------------------------------------------------------ model

    @torch.inference_mode()
    def memory(self, raw: torch.Tensor, event: torch.Tensor,
               project: bool = True) -> attn.AttnMemory:
        """Encode device snippets raw [N, 200, 1], event [N, 30, 5] and set
        up the attention memory, S padded to a multiple of 8 as the
        reference pads it. ``project``: keys and pre-projected values in the
        engine's memory dtype (int8 with scales for "i8"/"i8mxu"), as the
        beam kernels take them; else
        un-projected f32 keys and values, as fused greedy decode takes them."""
        dec = self.params["decoder"]
        if self.encoder_dtype is not None:  # the masks come from the cast inputs
            raw, event = raw.to(self.encoder_dtype), event.to(self.encoder_dtype)
        enc_out, mask = encode_input(self.params, raw, event, self.cfg, self._enc_weights)
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
                                end_token=NUC_TOKENIZER.end_id, loop=loop,
                                quant_mxu=self.quant_mxu)
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
                             aux: Optional[dict] = None,
                             ) -> Tuple[np.ndarray, np.ndarray]:
        """Beam decode a read from its compact representation
        (data/snippets.py:prepare_compact; the "i8dev" wire also needs
        ``aux`` from data/snippets.py:load_read_compact_ex)."""
        return self.collect_beam_compact(self.dispatch_beam_compact(
            signal, raw_ranges, events, event_ranges, max_output_len, beam_width, aux=aux))

    def _check_aux(self, aux: Optional[dict]) -> None:
        if self.transport_dtype == "i8dev" and not (aux is not None and aux.get("contiguous")):
            raise ValueError("transport_dtype='i8dev' requires the aux dict from "
                             "load_read_compact_ex (with contiguous events)")

    def compact_snippets(self, signal: np.ndarray, raw_ranges: np.ndarray, events: np.ndarray,
                         event_ranges: np.ndarray, aux: Optional[dict] = None):
        """Per chunk of a read in compact form: upload its slices over the
        engine's wire, unpack them and gather its snippets on the device,
        and yield them as raw [n, 200, 1], event [n, 30, 5] (f32)."""
        self._check_aux(aux)
        return self._chunks(signal, raw_ranges, events, event_ranges, aux)

    @torch.inference_mode()
    def _chunks(self, signal, raw_ranges, events, event_ranges, aux):
        # ranges may extend past the arrays; slicing clips them, as the
        # materialized path does
        raw_ranges = np.minimum(raw_ranges, signal.shape[0])
        event_ranges = np.minimum(event_ranges, events.shape[0])
        for s in range(0, raw_ranges.shape[0], self.chunk_size):
            sig, ev, rr, er = self.upload_chunk(signal, events, raw_ranges[s:s + self.chunk_size],
                                                event_ranges[s:s + self.chunk_size], aux)
            raw = gather_rows(sig, rr[:, 0], rr[:, 1] - rr[:, 0], 200)[..., None]
            event = gather_rows(ev.reshape(-1), er[:, 0] * 5, (er[:, 1] - er[:, 0]) * 5,
                                150).reshape(-1, 30, 5)
            yield raw, event

    def upload_chunk(self, signal, events, rr, er, aux=None):
        """One chunk of rows (``rr``, ``er`` [n, 2]) over the engine's wire:
        the host side of the JAX engine's dispatch (basecall.py:839-1021),
        one u8 buffer uploaded, then its unpack (:534-645) on the device.
        Returns (signal [S] f32, event features [E, 5] f32, raw ranges
        [n, 2] int32, event ranges [n, 2] int32) in the chunk's local
        coordinates; with "i8dev" the device derives the features and the
        ranges."""
        wire = self.transport_dtype
        rr, er = rr.astype(np.int64), er.astype(np.int64)
        lo_s, hi_s = int(rr[0, 0]), int(rr[:, 1].max())
        lo_e, hi_e = int(er[0, 0]), int(er[:, 1].max())
        if wire == "i8dev":
            # the features need samples through the last event's end (a
            # snippet's raw range stops at its last event's start)
            ev_lens = aux["ev_lens"][lo_e:hi_e].astype(np.int64)
            hi_s = max(hi_s, min(lo_s + int(ev_lens.sum()), signal.shape[0]))
        sl, el = signal[lo_s:hi_s], events[lo_e:hi_e]
        scales = np.zeros(8, np.float32)  # [0] the signal's, [1:6] the event features' (i8)
        parts = {"scales": scales}
        if wire in ("f16", "f32"):
            wdt = np.float16 if wire == "f16" else np.float32
            parts["sig"], parts["ev"] = sl.astype(wdt), el.astype(wdt)
        else:
            s_scale = max(float(np.abs(sl).max()) if sl.size else 0.0, 1e-12) / 127.0
            scales[0] = s_scale
            parts["sig"] = np.clip(np.round(sl / s_scale), -127, 127).astype(np.int8)
            if wire == "i8sig":
                parts["ev"] = el.astype(np.float16)
            elif wire == "i8":
                e_scale = np.maximum(np.abs(el).max(axis=0) if el.shape[0] else np.zeros(5),
                                     1e-12) / 127.0
                scales[1:6] = e_scale
                parts["ev"] = np.clip(np.round(el / e_scale), -127, 127).astype(np.int8)
            else:
                hdr1 = np.zeros(16, np.float32)
                hdr1[0:5] = aux["scaler_mean"]
                hdr1[5:10] = aux["scaler_std"]
                hdr1[10] = aux["raw_mean"]
                hdr1[11] = aux["raw_std"]
                # true (unpatched) raw-unit mean of the chunk's first event
                hdr1[12] = events[lo_e, 1] * aux["scaler_std"][1] + aux["scaler_mean"][1]
                parts["hdr1"] = hdr1
                parts["ovr"] = events[[lo_e, hi_e - 1]].astype(np.float16)
                parts["lens"] = ev_lens.astype(np.uint16).view(np.int16)
        if wire != "i8dev":
            parts["rr"], parts["er"] = (rr - lo_s).astype(np.int32), (er - lo_e).astype(np.int32)
        dev = self._upload(parts)

        scales = dev["scales"]
        if wire in ("f16", "f32"):
            return dev["sig"].float(), dev["ev"].float(), dev["rr"], dev["er"]
        sig = dev["sig"].float() * scales[0]
        if wire == "i8sig":
            return sig, dev["ev"].float(), dev["rr"], dev["er"]
        if wire == "i8":
            return sig, dev["ev"].float() * scales[1:6], dev["rr"], dev["er"]
        lens = dev["lens"].to(torch.int32) & 0xFFFF
        n_ev, n = lens.shape[0], rr.shape[0]
        ev = _device_event_features(sig, lens, n_ev, dev["hdr1"], dev["ovr"].float())
        rr_d, er_d = _device_snippet_ranges(lens, n, n_ev, n, int(aux["stride"]))
        return sig, ev, rr_d, er_d

    def _upload(self, parts: dict) -> dict:
        """Numpy arrays -> tensors on the device, by one copy of one u8
        buffer (pinned on CUDA) that holds them back to back at 16-byte
        offsets; each comes back as a view of its own dtype and shape."""
        layout, off = {}, 0
        for k, a in parts.items():
            layout[k] = (off, a)
            off += -(-a.nbytes // 16) * 16
        cuda = self.device.type == "cuda"
        host = torch.empty(off, dtype=torch.uint8, pin_memory=cuda)
        buf = host.numpy()
        for o, a in layout.values():
            buf[o:o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        dev = host.to(self.device, non_blocking=cuda)
        return {k: dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype]).reshape(a.shape)
                for k, (o, a) in layout.items()}

    @torch.inference_mode()
    def _pack(self, tokens: torch.Tensor, probs: torch.Tensor, T_fetch: int) -> torch.Tensor:
        """The result bytes of one chunk: tokens as nibbles and step
        probabilities as u8 or nibbles (pack_u8), else int8 tokens and f16
        probs (basecall.py:477-498)."""
        tokens, probs = tokens[:, :T_fetch], probs[:, :T_fetch]
        if not self.pack_u8:
            return torch.cat([tokens.to(torch.int8).view(torch.uint8),
                              probs.to(torch.float16).contiguous().view(torch.uint8)], dim=1)

        def nibbles(x):
            if T_fetch % 2:
                x = torch.nn.functional.pad(x, (0, 1))
            return x[:, 0::2] | (x[:, 1::2] << 4)

        levels = 15.0 if self.prob_bits == 4 else 255.0
        prob_q = torch.round(probs.clamp(0.0, 1.0) * levels).to(torch.uint8)
        prob_b = nibbles(prob_q) if self.prob_bits == 4 else prob_q
        return torch.cat([nibbles(tokens.to(torch.uint8)), prob_b], dim=1)

    def dispatch_beam_compact(self, signal: np.ndarray, raw_ranges: np.ndarray,
                              events: np.ndarray, event_ranges: np.ndarray,
                              max_output_len: int, beam_width: int = 5,
                              aux: Optional[dict] = None) -> PendingBeamCompact:
        """Upload and enqueue all of a read's chunks, starting each result's
        copy to (pinned) host memory without waiting for it; pair with
        :meth:`collect_beam_compact`."""
        self._check_aux(aux)
        if raw_ranges.shape[0] == 0:
            return PendingBeamCompact([], TOTAL_STEPS)
        T_fetch = self._fetch_width(max_output_len)
        cuda = self.device.type == "cuda"
        pending = []
        for raw, event in self._chunks(signal, raw_ranges, events, event_ranges, aux):
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
        """Wait for a dispatched read's copies and unpack the result bytes.
        Waits on CUDA events only, so any thread may collect."""
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

                def unnibble(b, dtype):
                    x = np.empty((n, 2 * Tb), dtype)
                    x[:, 0::2] = b & 0xF
                    x[:, 1::2] = b >> 4
                    return x[:, :T]

                toks.append(unnibble(arr[:, :Tb], np.int64))
                if self.prob_bits == 4:
                    prbs.append(unnibble(arr[:, Tb:], np.float32) / 15.0)
                else:
                    prbs.append(arr[:, Tb:].astype(np.float32) / 255.0)
            else:
                toks.append(arr[:, :T].copy().view(np.int8).astype(np.int64))
                prbs.append(arr[:, T:].copy().view(np.float16).astype(np.float32))
        return np.concatenate(toks), np.concatenate(prbs)

    @staticmethod
    def tokens_to_sequences(tokens: np.ndarray) -> List[str]:
        return NUC_TOKENIZER.sequences_to_texts(tokens)
