"""Inference engine: snippets in, per-snippet basecalls out.

Counterpart of ravvent_tpu/evaluation/basecall.py's ``BasecallEngine``, beam
decode on the compact path. The encoder runs in f32 or on a bf16 stream
(``encoder_dtype``); the attention memory is pre-projected and stored in
bf16, f32 or int8 (``memory_dtype="i8"|"i8mxu"``, the step kernel's int8
variants); beam search runs one fused CUDA step kernel per decode step
(``beam_impl="step"``, this engine's default) or one whole-loop kernel
launch per chunk (``beam_impl="loop"``), both for a depth-1 LSTM decoder
with Luong attention, or the plain decode loop (``beam_impl="xla"``, the JAX
engine's default and its path for every configuration: GRU or unidirectional
encoders, Bahdanau attention, deeper decoders), whose memory is
pre-projected only with ``project_values``. A read in compact form travels
to the device once per chunk, as one u8 buffer in the wire format
``transport_dtype`` (the JAX engine's "f16", "f32", "i8", "i8sig" or
"i8dev", basecall.py:839-1021), is unpacked and gathered into snippets
there, and the result comes back as one u8 buffer per chunk (tokens as
nibbles, step probabilities quantized to 8 or 4 bits). The defaults are the
basecalling CLI's settings (f32 encoder, f16 wire, 8-bit probabilities);
bench.py's main path is ``encoder_dtype=torch.bfloat16,
transport_dtype="i8dev", prob_bits=4``.

The signal-only wire (the JAX engine's "sigdev", basecall.py:653-747 and
1062-1289) sends a read's raw samples and nothing else: one upload of a
32-byte header and the i16 samples (or u8 window-quantized ones), then event
detection (ops/event_detect.py, its peak scan the kernel of
csrc/peak_scan.cu on the card), self-scaled event features, the snippet
count and ranges, all on the device (:meth:`BasecallEngine.begin_beam_signal`);
the snippets are then gathered from the device-resident arrays and decoded
chunk by chunk (:meth:`BasecallEngine.finish_beam_signal`).

On a CUDA device a bidirectional LSTM encoder runs the BiLSTM kernel of its
stream (ops/rnn_cuda.py) and the decoder the beam-step kernel
(ops/beam_step_cuda.py) or the beam-loop kernel (ops/beam_loop_cuda.py); on
the CPU each runs its plain version. GRU and unidirectional encoders run
their plain scan, and ``beam_impl="xla"`` the plain beam decode
(decode/beam.py), on any device, as the JAX package runs ``lax.scan`` and
XLA for them. The JAX engine pads each slab to a
small ladder of row counts to bound recompilation; PyTorch does not
recompile, and rows are independent, so this engine runs each chunk at its
own row count. Both split a read at the same rows (multiples of
``chunk_size``), so the i8 wires' per-chunk scales are the JAX slabs'.

With a ``mesh`` (parallel/mesh.py) the engine runs data-parallel over the
mesh's ``'data'`` axis, as the JAX engine's ``shard_map`` over ``'data'``
does (basecall.py:293-316 there; on a ``('data', 'model')`` mesh each data
shard runs on the first device of its model row): every shard's device
holds the parameters and the encoders' kernel-layout weights, each chunk's
rows split over the shards
(``torch.tensor_split``'s rule; a shard of no rows is skipped), and each
shard runs the single-device program on its rows: the compact wire's upload
and unpack once per device, then its own rows' gather, encode, decode and
packed result. The host concatenates the shards' results in row order; no
collective runs. On the signal-only wire the segmentation runs once, on the
mesh's first device, and each shard's device receives the read's signal,
features and ranges.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ravvent_tpu_torch.config import MAX_TARGET_LEN, ModelConfig
from ravvent_tpu_torch.decode.beam import beam_decode, beam_scores_to_step_probs
from ravvent_tpu_torch.decode.greedy import greedy_decode
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.basecaller import check_config, encode_input
from ravvent_tpu_torch.models.rnn import kernel_weights, stream_weights
from ravvent_tpu_torch.ops.beam_loop_cuda import LOOP_BEAMS, LOOP_UNITS, beam_loop
from ravvent_tpu_torch.ops.beam_step_cuda import (
    STEP_BEAMS, STEP_UNITS, beam_step_loop, fused_beam_decode, widths,
)
from ravvent_tpu_torch.ops.decode_step_cuda import GREEDY_MEMORY_DIMS, GREEDY_UNITS
from ravvent_tpu_torch.ops.event_detect import detect_boundaries_device, fired_to_event_lens
from ravvent_tpu_torch.ops.gather_rows import gather_rows
from ravvent_tpu_torch.parallel.mesh import Mesh, replicate, row_bounds, shard_batch
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.weights import to_device

TOTAL_STEPS = MAX_TARGET_LEN - 1  # default decode length; max_steps bounds it per call
BEAM_IMPLS = ("step", "loop", "xla")
WIRES = ("f16", "f32", "i8", "i8sig", "i8dev")
SIG_WIRES = ("i16", "u8")  # the signal-only wire's sample types
SIG_BUCKET = 65536  # the signal-only wire pads a read to a multiple of this
_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8,
                 np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32, np.dtype(np.float16): torch.float16,
                 np.dtype(np.float32): torch.float32}


# the decoder units and beam widths each implementation's kernels are
# compiled for: the beam step's two kernels, the whole-loop kernel, and the
# fused greedy step (no beams; its memory widths are GREEDY_MEMORY_DIMS)
KERNEL_SHAPES = {"step": (STEP_UNITS, STEP_BEAMS), "loop": (LOOP_UNITS, LOOP_BEAMS),
                 "greedy": (GREEDY_UNITS, ())}


def kernels_serve(cfg: ModelConfig, beams: Iterable[int] = (),
                  device: Union[str, torch.device, None] = None, greedy: bool = False,
                  impl: str = "step") -> bool:
    """Whether the decode kernels of ``impl`` ("step", the beam step; "loop",
    the whole-loop kernel; or, with ``greedy``, the fused greedy step) serve
    ``cfg``'s decoder, a depth-1 LSTM with Luong attention, and every beam
    width in ``beams`` (:data:`KERNEL_SHAPES`). On a CUDA ``device`` the
    kernels' compiled decoder widths too, and for the fused greedy step an
    encoder output (``enc_out_dim``) in :data:`GREEDY_MEMORY_DIMS`; their
    plain versions, which a CPU tensor runs, take any width."""
    units, kernel_beams = KERNEL_SHAPES["greedy" if greedy else impl]
    serve = (cfg.cell_type == "lstm" and cfg.effective_attention == "luong"
             and cfg.decoder_depth == 1 and all(b in kernel_beams for b in beams))
    if device is None or torch.device(device).type != "cuda":
        return serve
    return (serve and cfg.dec_units in units
            and (not greedy or cfg.enc_out_dim in GREEDY_MEMORY_DIMS))


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


def _device_event_features_selfscaled(x: torch.Tensor, lens: torch.Tensor, n_ev,
                                      lo: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """The 5 event features [E, 5] f32 of the signal-only wire, with the
    scaler fit on the device (ravvent_tpu/evaluation/basecall.py:156-206):
    length, mean, stdv, mean^2 and delta mean of each event in raw units,
    standardized by their column means and population stds over the read's
    ``n_ev`` events. Rows from ``n_ev`` on are zero. Raw units matter:
    mean^2 is not invariant under the standardization.

    ``x`` [S] holds the wire's integer samples, the raw signal being
    ``lo + step * x`` (i16 wire: the samples, lo 0, step 1; u8 wire: the
    codes and the header's lo and step). The reference takes segment sums
    of the z-scored f32 signal from two cumsums over the whole read, which
    cancel (its features stray by up to ~1e-2 on a 26k-sample read,
    tests/test_torch_sigdev.py); here the segment sums of x and x^2 come
    from int64 cumsums, exact and the same in any order on any device, and
    the rest is f64, so the card's features equal the CPU's."""
    E, S = lens.shape[0], x.shape[0]
    dev = x.device
    rows = torch.arange(E, device=dev)
    valid = rows < n_ev
    lens_v = torch.where(valid, lens, torch.zeros_like(lens)).long()
    n = lens_v.clamp(min=1)
    cum = torch.cumsum(lens_v, 0)
    starts = cum - lens_v
    xi = x.long()
    zero = xi.new_zeros(1)
    cs = torch.cat([zero, torch.cumsum(xi, 0)])
    cq = torch.cat([zero, torch.cumsum(xi * xi, 0)])
    s_idx, e_idx = starts.clamp(0, S), cum.clamp(0, S)
    ssum = cs[e_idx] - cs[s_idx]
    sqsum = cq[e_idx] - cq[s_idx]
    mean_x = ssum.double() / n
    var_x = (n * sqsum - ssum * ssum).double() / (n * n).double()
    lo, step = lo.double(), step.double()
    mean = lo + step * mean_x
    # the host's FLT_MIN clamp, in raw units
    stdv = torch.sqrt(torch.clamp(step * step * var_x, min=1.1754944e-38))
    dmean = torch.where(rows == 0, 0.0, mean - torch.cat([mean[:1], mean[:-1]]))
    feats = torch.stack([lens_v.double(), mean, stdv, mean * mean, dmean], dim=1)
    feats = torch.where(valid[:, None], feats, 0.0)
    n_feat = torch.as_tensor(n_ev, device=dev).clamp(min=1).double()
    fmean = feats.sum(dim=0) / n_feat
    fvar = torch.where(valid[:, None], (feats - fmean) ** 2, 0.0).sum(dim=0) / n_feat
    fstd = torch.sqrt(fvar)
    fstd = torch.where(fstd == 0.0, 1.0, fstd)
    return torch.where(valid[:, None], (feats - fmean) / fstd, 0.0).float()


def _device_snippet_count(lens: torch.Tensor, n_ev, n_rows: int, stride: int,
                          raw_max_len: int = 200, max_window: int = 256) -> torch.Tensor:
    """The number of snippet windows (0-d int32) by the host's stopping
    rule (data/snippets.py:compute_fitting_event_ranges;
    ravvent_tpu/evaluation/basecall.py:209-239): a window every ``stride``
    events until the first whose end event reaches the event count (or a
    first window of no event); a window whose stride step passes the last
    event is the last. The windows' cumsum values come from one strided
    view, as in :func:`_device_snippet_ranges`; the end event is counted
    without the ``n_ev`` cap (the host's searchsorted), since the padded
    cumsum plateau only pushes it past ``n_ev``, which fails anyway."""
    dev = lens.device
    es = torch.arange(n_rows, device=dev) * stride
    cum = torch.cumsum(lens.long(), 0)
    W = max_window
    need = (n_rows - 1) * stride + W + 2
    arr = torch.cat([cum.new_zeros(2), cum, cum.new_zeros(max(need - cum.shape[0] - 2, 0))])
    w = arr.unfold(0, W + 2, stride)[:n_rows]  # [n_rows, W + 2]: w[r, k] = cum[es + k - 2]
    offset = w[:, 1]
    cnt = (w[:, 2:] <= (raw_max_len + offset)[:, None]).sum(dim=1)
    end_id = es + cnt
    fail = (end_id >= n_ev) | (end_id == 0)
    stop_after = (es + stride - 1 >= n_ev).long()
    ok = torch.cumsum(fail.long(), 0) == 0
    prev_stop = torch.cat([stop_after.new_zeros(1), torch.cumsum(stop_after, 0)[:-1]]) == 0
    return (ok & prev_stop).sum().to(torch.int32)


def _gather_snippets(sig: torch.Tensor, feats: torch.Tensor, rr: torch.Tensor,
                     er: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Snippets raw [n, 200, 1], event [n, 30, 5] gathered from a signal
    [S], event features [E, 5] and their ranges [n, 2]."""
    raw = gather_rows(sig, rr[:, 0], rr[:, 1] - rr[:, 0], 200)[..., None]
    event = gather_rows(feats.reshape(-1), er[:, 0] * 5, (er[:, 1] - er[:, 0]) * 5,
                        150).reshape(-1, 30, 5)
    return raw, event


class PendingBeamCompact(NamedTuple):
    """In-flight read from :meth:`BasecallEngine.dispatch_beam_compact`: per
    chunk (per shard of a chunk under a mesh), in row order, the host
    buffer the packed result is being copied into, the CUDA event that
    marks the copy's end (None on the CPU) and the row count; ``n_beams``
    beams a row on the wire, each ``T_fetch`` steps wide."""

    pending: list
    T_fetch: int
    n_beams: int = 1


class PendingSignal(NamedTuple):
    """A read's segmentation on the signal-only wire, from
    :meth:`BasecallEngine.begin_beam_signal_batch`: row ``k`` of the batch's
    device arrays (z-scored signal [K, S_b], features [K, E_b, 5], raw and
    event ranges [K, N_max, 2]), the (n_true, n_snip) meta [K, 2] and the
    raw ranges on their way to (pinned) host memory, and the CUDA event that
    marks the copies' end (None on the CPU)."""

    sig: torch.Tensor
    feats: torch.Tensor
    rr: torch.Tensor
    er: torch.Tensor
    meta_host: torch.Tensor
    rr_host: torch.Tensor
    done: Optional[torch.cuda.Event]
    E_b: int
    k: int


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
        n_beams: int = 1,
        total_steps: int = TOTAL_STEPS,
        project_values: bool = False,
        mesh: Optional[Mesh] = None,
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
        (one launch per chunk for the whole loop), which give the same beams
        and take a depth-1 LSTM decoder with Luong attention (raising
        ``ValueError`` on any other); or "xla", the plain beam decode of
        decode/beam.py on the engine's device for any configuration, the
        JAX engine's default (basecall.py:369-411 there). This engine
        defaults to "step", so that a flagship engine built with the
        defaults runs the kernels.
        ``total_steps``: the decode length, ``MAX_TARGET_LEN - 1`` by
        default; a call's ``max_output_len - 1`` bounds it.
        ``project_values``: pre-project the values through the attention
        layer on the "xla" path (the memory the kernels take); "step" and
        "loop" always do.
        ``encoder_dtype``: None (f32) or torch.bfloat16, the encoder stream:
        bf16 inputs, weights and inter-layer sequences, f32 state and
        accumulation. ``transport_dtype``: the compact path's wire, one of
        ``WIRES`` — "f16" and "f32" send the signal and event features in
        that type; "i8" quantizes both with per-chunk max-abs scales, "i8sig"
        only the signal; "i8dev" sends the i8 signal and u16 event lengths
        and recomputes the features and snippet ranges on the device (needs
        the ``aux`` dict of data/snippets.py:load_read_compact_ex).
        ``n_beams``: beams returned a snippet, min(n_beams, beam_width); with
        more than one, the results are [N, n_beams, T] (beam 0 the top
        beam), for the merge fold's beam selection
        (evaluation/mapping.py:MappingEvaluator._select_beams).
        ``mesh``: run data-parallel over the mesh's ``'data'`` axis (see the
        module's docstring); ``device`` is then the mesh's first device and
        may not be given."""
        check_config(cfg)
        if memory_dtype not in (None, torch.bfloat16, torch.float32, "i8", "i8mxu"):
            raise ValueError("memory_dtype must be torch.bfloat16, torch.float32, None, "
                             "'i8' or 'i8mxu'")
        if beam_impl not in BEAM_IMPLS:
            raise ValueError(f"beam_impl must be one of {BEAM_IMPLS}, got {beam_impl!r}")
        if beam_impl != "xla":
            project_values = True
        if isinstance(memory_dtype, str) and beam_impl != "step":
            raise ValueError("int8 memory requires beam_impl='step'")
        if encoder_dtype not in (None, torch.bfloat16):
            raise ValueError("encoder_dtype must be None (f32) or torch.bfloat16")
        if transport_dtype not in WIRES:
            raise ValueError(f"transport_dtype must be one of {WIRES}, got {transport_dtype!r}")
        if prob_bits not in (8, 4):
            raise ValueError(f"prob_bits must be 8 or 4, got {prob_bits!r}")
        if n_beams < 1:
            raise ValueError(f"n_beams must be at least 1, got {n_beams!r}")
        if mesh is not None:
            if device is not None:
                raise ValueError("with a mesh the engine runs on the mesh's devices: "
                                 "pass no device")
            device = mesh.devices[0]
        self.beam_impl = beam_impl
        self.total_steps = total_steps
        self.project_values = project_values
        self.device = resolve_device(device)
        # the JAX engine asserts the same for the cell, attention and depth
        # (basecall.py:334-337 there); on a card the width is the kernels' too
        if beam_impl != "xla" and not kernels_serve(cfg, device=self.device, impl=beam_impl):
            units, beams = KERNEL_SHAPES[beam_impl]
            raise ValueError(
                f"beam_impl={beam_impl!r} runs the beam kernels, which take a depth-1 LSTM "
                f"decoder with Luong attention, of {widths(units)} units on a card (beam "
                f"widths {widths(beams)}); got rnn_type={cfg.rnn_type!r}, attention "
                f"{cfg.effective_attention!r}, decoder_depth={cfg.decoder_depth}, "
                f"dec_units={cfg.dec_units} on {self.device}: use beam_impl='xla'")
        self.params = to_device(params, self.device)
        self.cfg = cfg
        self.chunk_size = chunk_size
        self.quant_mxu = memory_dtype == "i8mxu"
        self.memory_dtype = "i8" if self.quant_mxu else memory_dtype
        self.pack_u8 = pack_u8
        self.encoder_dtype = encoder_dtype
        self.transport_dtype = transport_dtype
        self.prob_bits = prob_bits
        self.n_beams = n_beams
        # the BiLSTM encoders' weights in the stream dtype, cast once, and in
        # the stream's kernel layout, laid out once; other encoders run their
        # plain scan on the layers themselves
        self._enc_weights = self._encoder_weights()
        self.mesh = mesh
        self._shards = [self]
        if mesh is not None:
            # one engine a shard, on its device: this one on the first
            # device, a copy holding the parameters on each other device
            replicas = {self.device: self}
            for d, p in zip(mesh.data_devices, replicate(self.params, mesh)):
                if d not in replicas:
                    replicas[d] = self._replica(d, p)
            self._shards = [replicas[d] for d in mesh.data_devices]

    def _encoder_weights(self) -> dict:
        return {k: kernel_weights(stream_weights(self.params[k],
                                                 self.encoder_dtype or torch.float32))
                for k in ("encoder_raw", "encoder_event")} if self.cfg.rnn_type == "bilstm" else {}

    def _replica(self, device: torch.device, params) -> "BasecallEngine":
        """This engine's single-device program on ``device``: its settings,
        with ``params`` (its parameters there) and encoder weights laid out
        from them."""
        r = copy.copy(self)
        r.device, r.mesh = device, None
        r.params = params
        r._enc_weights = r._encoder_weights()
        r._shards = [r]
        return r

    def _shard_rows(self, n: int) -> List[Tuple["BasecallEngine", int, int]]:
        """(engine, lo, hi) of each shard that holds rows of a chunk of
        ``n`` rows, in row order; one shard of all rows without a mesh."""
        bounds = row_bounds(n, len(self._shards))
        return [(eng, lo, hi) for eng, (lo, hi) in zip(self._shards, bounds) if hi > lo]

    def _on_device(self):
        """The CUDA runtime's current device set to the engine's, for its
        kernels' launches and events."""
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    # ------------------------------------------------------------------ model

    @torch.inference_mode()
    def memory(self, raw: torch.Tensor, event: torch.Tensor,
               project: bool = True) -> attn.AttnMemory:
        """Encode device snippets raw [N, 200, 1], event [N, 30, 5] and set
        up the attention memory; for the kernels ("step", "loop") S is
        padded to a multiple of 8 as the reference pads it there, the "xla"
        path keeps S as the reference's XLA path does. ``project``: the
        engine's memory: keys and values in its memory dtype (int8 with
        scales for "i8"/"i8mxu"), the values pre-projected with
        ``project_values`` (always for the kernels), as the JAX engine's
        ``_setup`` makes it; else un-projected f32 keys and values, as fused
        greedy decode takes them."""
        dec = self.params["decoder"]
        if self.encoder_dtype is not None:  # the masks come from the cast inputs
            raw, event = raw.to(self.encoder_dtype), event.to(self.encoder_dtype)
        enc_out, mask = encode_input(self.params, raw, event, self.cfg, self._enc_weights)
        if self.beam_impl != "xla":
            pad = (-enc_out.shape[1]) % 8
            enc_out = torch.nn.functional.pad(enc_out, (0, 0, 0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        if not project:
            return attn.setup_memory(dec["attention"], enc_out, mask, torch.float32)
        return attn.setup_memory(dec["attention"], enc_out, mask, self.memory_dtype,
                                 attention_layer=dec["attention_layer"] if self.project_values
                                 else None)

    @torch.inference_mode()
    def beam(self, raw: torch.Tensor, event: torch.Tensor, max_steps: int,
             beam_width: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Encode + beam decode device snippets raw [N, 200, 1], event
        [N, 30, 5]. Returns the top beam's (tokens [N, T] int32, step probs
        [N, T] f32) with T = total_steps; with K = min(n_beams, beam_width)
        > 1, the top K beams' [N, K, T], beam-major
        (ravvent_tpu/evaluation/basecall.py:398-411)."""
        mem, cfg = self.memory(raw, event), self.cfg
        if self.beam_impl == "xla":
            res = beam_decode(self.params["decoder"], mem, cfg.vocab_size, beam_width,
                              self.total_steps, max_steps, cfg.effective_attention,
                              cfg.cell_type, NUC_TOKENIZER.start_id, NUC_TOKENIZER.end_id)
        else:
            loop = beam_loop if self.beam_impl == "loop" else beam_step_loop
            res = fused_beam_decode(self.params["decoder"], mem, cfg.vocab_size, beam_width,
                                    self.total_steps, max_steps,
                                    start_token=NUC_TOKENIZER.start_id,
                                    end_token=NUC_TOKENIZER.end_id, loop=loop,
                                    quant_mxu=self.quant_mxu)
        K = min(self.n_beams, beam_width)
        if K == 1:
            return res.tokens[:, :, 0], beam_scores_to_step_probs(res.scores[:, :, 0])
        tokens = res.tokens[:, :, :K].movedim(2, 1)
        scores = res.scores[:, :, :K].movedim(2, 1)
        probs = beam_scores_to_step_probs(scores.reshape(-1, scores.shape[2]))
        return tokens, probs.reshape(scores.shape)

    def _fetch_width(self, max_output_len: int) -> int:
        return min(self.total_steps, ((max_output_len + 7) // 8) * 8)

    def _device_chunks(self, raw: np.ndarray, event: np.ndarray):
        """Materialized snippets raw [N, 200, 1], event [N, 30, 5],
        ``chunk_size`` rows at a time, per shard: (engine, raw, event) on
        the shard's device; a shard of no rows is skipped."""
        mesh = self.mesh or Mesh((self.device,))
        for s in range(0, raw.shape[0], self.chunk_size):
            r = torch.from_numpy(np.ascontiguousarray(raw[s:s + self.chunk_size], np.float32))
            e = torch.from_numpy(np.ascontiguousarray(event[s:s + self.chunk_size], np.float32))
            for eng, (rs, es) in zip(self._shards, shard_batch((r, e), mesh)):
                if rs.shape[0]:
                    yield eng, rs, es

    def predict_beam(self, raw: np.ndarray, event: np.ndarray, max_output_len: int,
                     beam_width: int = 5) -> Tuple[np.ndarray, np.ndarray]:
        """Beam decode materialized snippets; returns (tokens [N, T],
        step_probs [N, T]) of the top beam, T the fetch width ([N, K, T]
        with K > 1 beams)."""
        T = self._fetch_width(max_output_len)
        toks, probs = [], []
        for eng, r, e in self._device_chunks(raw, event):
            with eng._on_device():
                t, p = eng.beam(r, e, max_output_len - 1, beam_width)
            toks.append(t[..., :T].cpu().numpy())
            probs.append(p[..., :T].cpu().numpy())
        return np.concatenate(toks), np.concatenate(probs)

    @torch.inference_mode()
    def predict_greedy(self, raw: np.ndarray, event: np.ndarray, max_output_len: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy decode materialized snippets
        (ravvent_tpu/evaluation/basecall.py:1328-1345): the engine's encoder
        and memory (:meth:`memory`), then plain PyTorch greedy steps
        (decode/greedy.py) with the config's cell and attention, as the JAX
        engine's ``_greedy`` decodes with XLA (:413-420). Returns (tokens
        [N, T], logits [N, T, V] f32), T the fetch width. The JAX engine
        pads a chunk's rows to ``chunk_size``, this engine runs the chunk's
        own rows (a shard's rows under a mesh). The all-finished stop
        couples a call's rows: the two agree on every step until all of this
        engine's rows have ended; from there this engine emits zeros, where
        the JAX engine goes on while a padded row has not ended. A row's
        sequence, up to its end token, is the same."""
        if self.memory_dtype == "i8":
            raise ValueError("greedy decode reads bf16 or f32 memory: int8 memory ('i8', "
                             "'i8mxu') needs a consumer that understands quantized memory, the "
                             "fused beam-step kernel (ravvent_tpu/models/attention.py:96-98)")
        T = self._fetch_width(max_output_len)
        toks, logits = [], []
        for eng, r, e in self._device_chunks(raw, event):
            with eng._on_device():
                t, lg = greedy_decode(eng.params["decoder"], eng.memory(r, e), self.cfg.vocab_size,
                                      self.total_steps, max_output_len - 1,
                                      self.cfg.effective_attention, self.cfg.cell_type,
                                      NUC_TOKENIZER.start_id, NUC_TOKENIZER.end_id)
            toks.append(t[:, :T].cpu().numpy())
            logits.append(lg[:, :T].cpu().numpy())
        return np.concatenate(toks), np.concatenate(logits)

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
        """Per chunk of a read in compact form (per shard of a chunk under a
        mesh): upload its slices over the engine's wire, unpack them and
        gather its snippets on the device, and yield them as raw
        [n, 200, 1], event [n, 30, 5] (f32)."""
        self._check_aux(aux)
        return ((raw, event) for _, raw, event in
                self._chunks(signal, raw_ranges, events, event_ranges, aux))

    @torch.inference_mode()
    def _chunks(self, signal, raw_ranges, events, event_ranges, aux):
        """Per chunk, per shard: (engine, raw, event) on the shard's device;
        a chunk's upload and unpack run once on each device."""
        # ranges may extend past the arrays; slicing clips them, as the
        # materialized path does
        raw_ranges = np.minimum(raw_ranges, signal.shape[0])
        event_ranges = np.minimum(event_ranges, events.shape[0])
        for s in range(0, raw_ranges.shape[0], self.chunk_size):
            rr_c, er_c = raw_ranges[s:s + self.chunk_size], event_ranges[s:s + self.chunk_size]
            uploads = {}
            for eng, lo, hi in self._shard_rows(rr_c.shape[0]):
                if eng.device not in uploads:
                    uploads[eng.device] = eng.upload_chunk(signal, events, rr_c, er_c, aux)
                sig, ev, rr, er = uploads[eng.device]
                yield (eng, *_gather_snippets(sig, ev, rr[lo:hi], er[lo:hi]))

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
        probs (basecall.py:477-498). K beams [N, K, T] travel as rows of
        K * T_fetch steps, padded to whole bytes at the row's end."""
        tokens, probs = tokens[..., :T_fetch], probs[..., :T_fetch]
        if tokens.dim() == 3:
            tokens = tokens.reshape(tokens.shape[0], -1)
            probs = probs.reshape(probs.shape[0], -1)
        if not self.pack_u8:
            return torch.cat([tokens.to(torch.int8).view(torch.uint8),
                              probs.to(torch.float16).contiguous().view(torch.uint8)], dim=1)

        def nibbles(x):
            if x.shape[1] % 2:
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
            return PendingBeamCompact([], self.total_steps)
        T_fetch = self._fetch_width(max_output_len)
        pending = [eng._enqueue(raw, event, max_output_len - 1, beam_width, T_fetch)
                   for eng, raw, event in self._chunks(signal, raw_ranges, events, event_ranges,
                                                       aux)]
        return PendingBeamCompact(pending, T_fetch, min(self.n_beams, beam_width))

    def _enqueue(self, raw: torch.Tensor, event: torch.Tensor, max_steps: int, beam_width: int,
                 T_fetch: int) -> tuple:
        """Decode one chunk of device snippets and start its packed result's
        copy to (pinned) host memory: (host buffer, CUDA event or None, rows)."""
        cuda = self.device.type == "cuda"
        with self._on_device():
            packed = self._pack(*self.beam(raw, event, max_steps, beam_width), T_fetch)
            host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=cuda)
            host.copy_(packed, non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
        return host, done, raw.shape[0]

    def collect_beam_compact(self, handle: PendingBeamCompact) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a dispatched read's copies and unpack the result bytes.
        Waits on CUDA events only, so any thread may collect. With
        ``n_beams`` > 1 the arrays are [N, n_beams, T_fetch]
        (ravvent_tpu/evaluation/basecall.py:1024-1060)."""
        T = handle.n_beams * handle.T_fetch
        toks, prbs = [np.zeros((0, T), np.int64)], [np.zeros((0, T), np.float32)]
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
        out_t, out_p = np.concatenate(toks), np.concatenate(prbs)
        if handle.n_beams > 1:
            shape = (-1, handle.n_beams, handle.T_fetch)
            out_t, out_p = out_t.reshape(shape), out_p.reshape(shape)
        return out_t, out_p

    # ------------------------------------------------------ signal-only wire

    @staticmethod
    def _bucket(n: int, base: int) -> int:
        return max(base, ((n + base - 1) // base) * base)

    @torch.inference_mode()
    def _segment_batch(self, buf: torch.Tensor, S_b: int, E_b: int, N_max: int, stride: int,
                       sig_wire: str = "i16") -> tuple:
        """The signal-only wire's device half for K reads
        (ravvent_tpu/evaluation/basecall.py:653-747), from the uploaded
        buffer [K, 32 + payload] u8. Each row: a header of 8 f32 (z-score
        mean and std, [2] the sample count as i32, [3] lo and [4] step of
        the u8 wire) and the samples, i16 or u8 (raw = u8 * step + lo).
        Returns (z-scored signal [K, S_b] f32, zero past each read; event
        features [K, E_b, 5]; raw and event ranges [K, N_max, 2] int32;
        meta [K, 2] int32: the uncapped event count and the snippet
        count). The event count is n_true, which exceeds E_b when the
        segmentation buffer overflows."""
        K = buf.shape[0]
        hdr = buf[:, :32].view(torch.float32)  # [K, 8]
        n_s = buf[:, 8:12].view(torch.int32)[:, 0]  # [K]
        if sig_wire == "u8":
            x = buf[:, 32:32 + S_b]
            raw = x.float() * hdr[:, 4:5] + hdr[:, 3:4]
            lo, step = hdr[:, 3], hdr[:, 4]
        else:
            x = buf[:, 32:32 + 2 * S_b].view(torch.int16)
            raw = x.float()
            lo, step = torch.zeros_like(hdr[:, 3]), torch.ones_like(hdr[:, 4])
        fired = detect_boundaries_device(raw, n_valid=n_s)
        lens, n_ev, n_true = fired_to_event_lens(fired, 6, 9, E_b)
        sig = (raw - hdr[:, 0:1]) / hdr[:, 1:2]
        sig = torch.where(torch.arange(S_b, device=buf.device)[None, :] < n_s[:, None], sig, 0.0)
        feats = torch.stack([_device_event_features_selfscaled(x[k], lens[k], n_ev[k], lo[k],
                                                               step[k])
                             for k in range(K)])
        n_snip = torch.stack([_device_snippet_count(lens[k], n_ev[k], N_max, stride)
                              for k in range(K)])
        ranges = [_device_snippet_ranges(lens[k], n_snip[k], n_ev[k], N_max, stride)
                  for k in range(K)]
        rr = torch.stack([r for r, _ in ranges])
        er = torch.stack([e for _, e in ranges])
        return sig, feats, rr, er, torch.stack([n_true, n_snip], dim=1)

    def _segment(self, buf: torch.Tensor, S_b: int, E_b: int, N_max: int, stride: int,
                 sig_wire: str = "i16") -> tuple:
        """:meth:`_segment_batch` for one read's buffer [32 + payload]:
        (sig [S_b], feats [E_b, 5], rr, er [N_max, 2], meta [2])."""
        return tuple(x[0] for x in self._segment_batch(buf[None], S_b, E_b, N_max, stride,
                                                        sig_wire))

    def signal_buffer(self, raws: list, S_b: int, sig_wire: str = "i16") -> np.ndarray:
        """The upload of K reads' raw samples: [K, 32 + payload] u8, each row
        a header of 8 f32 and the samples padded to S_b
        (ravvent_tpu/evaluation/basecall.py:1080-1115, 1147-1174). The
        z-score affine is computed in float64 on the host; on the u8 wire
        the samples are window-quantized to 255 levels over [min, max] and
        the affine is that of the dequantized values."""
        item = 1 if sig_wire == "u8" else 2
        buf = np.zeros((len(raws), 32 + S_b * item), np.uint8)
        for i, raw in enumerate(raws):
            n_s = int(raw.size)
            if n_s == 0:
                continue
            hdr = np.zeros(8, np.float32)
            hdr[2:3].view(np.int32)[0] = n_s
            rf = raw.astype(np.float64)
            if sig_wire == "u8":
                lo, hi = float(rf.min()), float(rf.max())
                step = max((hi - lo) / 255.0, 1e-12)
                q = np.round((rf - lo) / step)
                rf = q * step + lo
                hdr[3], hdr[4] = lo, step
                buf[i, 32:32 + n_s] = q.astype(np.uint8)
            else:
                buf[i, 32:32 + n_s * 2] = raw.astype(np.int16).view(np.uint8).reshape(-1)
            hdr[0] = float(rf.mean())
            rstd = float(rf.std())
            hdr[1] = rstd if rstd != 0.0 else 1.0
            buf[i, :32] = hdr.view(np.uint8)
        return buf

    def begin_beam_signal(self, raw_signal: np.ndarray, stride: int = 6,
                          sig_wire: str = "i16") -> Union[PendingSignal, PendingBeamCompact]:
        """Upload a read's raw samples and enqueue its segmentation on the
        device; returns at once, the (n_events, n_snippets) meta and the raw
        ranges on their way to the host. Pair with
        :meth:`finish_beam_signal`. An empty read gives the empty
        :class:`PendingBeamCompact`."""
        return self.begin_beam_signal_batch([raw_signal], stride, sig_wire)[0]

    def begin_beam_signal_batch(self, raw_signals, stride: int = 6, sig_wire: str = "i16"
                                ) -> List[Union[PendingSignal, PendingBeamCompact]]:
        """K reads' signal-only dispatch as one upload and one segmentation,
        every read padded to the largest read's bucket
        (ravvent_tpu/evaluation/basecall.py:1129-1188): S_b =
        _bucket(n_s, 65536) samples, E_b = S_b // 2 events (an event is >= 1
        sample), N_max = E_b // stride + 1 + chunk_size snippet rows. Waits
        on nothing: the meta and the raw ranges are copied to pinned host
        memory behind a CUDA event. Returns one handle per read for
        :meth:`finish_beam_signal`."""
        if sig_wire not in SIG_WIRES:
            raise ValueError(f"sig_wire must be one of {SIG_WIRES}, got {sig_wire!r}")
        raws = [np.asarray(r) for r in raw_signals]
        ns = [int(r.size) for r in raws]
        if not raws:
            return []
        empty = PendingBeamCompact([], self.total_steps)
        if max(ns) == 0:
            return [empty] * len(raws)
        S_b = self._bucket(max(ns), SIG_BUCKET)
        E_b = S_b // 2
        N_max = E_b // stride + 1 + self.chunk_size
        buf = self._upload({"buf": self.signal_buffer(raws, S_b, sig_wire)})["buf"]
        with self._on_device():
            sig, feats, rr, er, meta = self._segment_batch(buf, S_b, E_b, N_max, stride, sig_wire)
            done = None
            if self.device.type == "cuda":
                meta_host = torch.empty(meta.shape, dtype=meta.dtype, pin_memory=True)
                meta_host.copy_(meta, non_blocking=True)
                rr_host = torch.empty(rr.shape, dtype=rr.dtype, pin_memory=True)
                rr_host.copy_(rr, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            else:
                meta_host, rr_host = meta, rr
        return [PendingSignal(sig, feats, rr, er, meta_host, rr_host, done, E_b, k) if ns[k]
                else empty for k in range(len(raws))]

    @staticmethod
    def _signal_meta(seg: PendingSignal) -> Tuple[int, int]:
        if seg.done is not None:
            seg.done.synchronize()
        n_true, n_snip = (int(v) for v in seg.meta_host[seg.k])
        return n_true, n_snip

    @torch.inference_mode()
    def finish_beam_signal(self, seg: Union[PendingSignal, PendingBeamCompact],
                           max_output_len: Optional[int] = None, beam_width: int = 5
                           ) -> Optional[PendingBeamCompact]:
        """Wait for a segmentation's meta, then gather and decode its
        snippets chunk by chunk from the device-resident signal and
        features (rows split at multiples of ``chunk_size``, where the JAX
        engine's slabs start), each chunk's result copied to pinned host
        memory. Returns a handle for :meth:`collect_beam_compact`, or None
        when the segmentation buffer overflowed (more than E_b events): the
        caller then takes the compact wire. Under a mesh each shard's
        device receives the read's signal, features and ranges once, and
        each shard gathers and decodes its rows of every chunk."""
        if isinstance(seg, PendingBeamCompact):  # an empty read
            return seg
        n_true, n_snip = self._signal_meta(seg)
        if max_output_len is None:
            max_output_len = self.total_steps + 1
        if n_true > seg.E_b:
            return None
        if n_snip == 0:
            return PendingBeamCompact([], self.total_steps)
        T_fetch = self._fetch_width(max_output_len)
        resident = {}  # device -> the read's (signal, features, raw ranges, event ranges)
        pending = []
        for s in range(0, n_snip, self.chunk_size):
            for eng, lo, hi in self._shard_rows(min(s + self.chunk_size, n_snip) - s):
                if eng.device not in resident:
                    resident[eng.device] = tuple(x[seg.k].to(eng.device)
                                                 for x in (seg.sig, seg.feats, seg.rr, seg.er))
                sig, feats, rr, er = resident[eng.device]
                pending.append(eng._enqueue(
                    *_gather_snippets(sig, feats, rr[s + lo:s + hi], er[s + lo:s + hi]),
                    max_output_len - 1, beam_width, T_fetch))
        return PendingBeamCompact(pending, T_fetch, min(self.n_beams, beam_width))

    @torch.inference_mode()
    def signal_snippets(self, seg: PendingSignal, start: int, end: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Snippet rows [start, end) of a segmented read, gathered on the
        device from its signal and features: raw [n, 200, 1], event
        [n, 30, 5] (f32)."""
        return _gather_snippets(seg.sig[seg.k], seg.feats[seg.k], seg.rr[seg.k, start:end],
                                seg.er[seg.k, start:end])

    def signal_ranges(self, seg: Union[PendingSignal, PendingBeamCompact]) -> Optional[np.ndarray]:
        """The device's snippet raw ranges of a segmented read, [n_snip, 2]
        int32 sample indices on the host (None for an empty read): the merge
        fold's positional prior."""
        if isinstance(seg, PendingBeamCompact):
            return None
        _, n_snip = self._signal_meta(seg)
        return seg.rr_host[seg.k, :n_snip].numpy().copy()

    def dispatch_beam_signal(self, raw_signal: np.ndarray, max_output_len: Optional[int] = None,
                             beam_width: int = 5, stride: int = 6, sig_wire: str = "i16"
                             ) -> Optional[PendingBeamCompact]:
        """:meth:`begin_beam_signal`, then :meth:`finish_beam_signal`."""
        return self.finish_beam_signal(self.begin_beam_signal(raw_signal, stride, sig_wire),
                                       max_output_len, beam_width)

    def predict_beam_signal(self, raw_signal: np.ndarray, max_output_len: Optional[int] = None,
                            beam_width: int = 5, stride: int = 6, sig_wire: str = "i16",
                            return_ranges: bool = False) -> Optional[tuple]:
        """Raw samples in, per-snippet (tokens [N, T], step probs [N, T];
        [N, K, T] with K > 1 beams) out, segmentation, features and
        snippets all on the device. None when the segmentation buffer
        overflows (take the compact wire).
        ``return_ranges`` appends the device's snippet raw ranges
        ([N, 2], None for an empty read)."""
        seg = self.begin_beam_signal(raw_signal, stride, sig_wire)
        handle = self.finish_beam_signal(seg, max_output_len, beam_width)
        if handle is None:
            return None
        tokens, probs = self.collect_beam_compact(handle)
        if not return_ranges:
            return tokens, probs
        return tokens, probs, self.signal_ranges(seg)

    @staticmethod
    def tokens_to_sequences(tokens: np.ndarray) -> List[str]:
        return NUC_TOKENIZER.sequences_to_texts(tokens)
