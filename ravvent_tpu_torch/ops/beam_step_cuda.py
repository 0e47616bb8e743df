"""One beam-search step: the CUDA kernels, their plain versions, and the
decode entry point that runs the step once per step or runs the whole-loop
kernel (ops/beam_loop_cuda.py).

Counterpart of ravvent_tpu/ops/beam_loop_pallas.py (the TPU kernel
``_beam_step_kernel`` and its loop ``beam_step_decode``, bf16, f32 or int8
memory) and of ``pack_decoder_weights`` (ops/decode_step_pallas.py). A step
is two kernels on every memory: :func:`beam_cell` (``csrc/beam_step_f.cu``,
the LSTM cell and ``h'.watt_h`` of every hypothesis, plain version
:func:`cell_plain`; it never reads the memory) and then :func:`beam_attend`
(``csrc/beam_attend.cuh``, one source a memory mode: attention, logits,
top-W and the permutation of each batch row, plain version
:func:`attend_plain`), whose kernel is templated on the memory mode. Both
are compiled for the decoder units :data:`STEP_UNITS` and the beam widths
:data:`STEP_BEAMS` (``csrc/beam_step_shapes.cuh``). :func:`beam_step`
launches them for CUDA tensors and runs :func:`beam_step_plain`, the
composition of the two plain versions, for CPU tensors only; a CUDA tensor
of another shape raises ValueError, naming it. :func:`fused_beam_decode`
runs a decoder of any other width up to the widest compiled one on the
next compiled width, its weights and memory zero-padded
(ops/decoder_pad.py), and counts it as ``decoder_padded``.

int8 memory (``setup_memory(dtype="i8")``) comes with its per-(row,
position) scales ``scales = (kscale, vscale)`` and runs one of the
reference's two int8 branches (beam_loop_pallas.py:374-425): ``mxu=False``
("quant") or ``mxu=True`` ("quant_mxu"); :func:`attend_quantized` says what
each computes.

The step state, per batch row b and beam w (hypothesis ``b * W + w``):
  tok [B*W] int32 (the token fed to this step), h, c, att [B*W, U] f32,
  cum [B, W] f32 (cumulative log-probs), fin [B, W] bool (finished).
A step returns the next state plus the parents [B, W] int32. The reference
kernel fed a one-hot [B*W, 136] embedding; a token id carries the same
information, and ids >= V embed to zeros as an all-zero one-hot would.
Top-W runs over the flattened ``W x VP`` row (VP = 128 columns, those >= V
being padding with logit finfo.min), so parents are ``idx // VP`` and
tokens ``idx % VP`` exactly as in the reference.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple, Optional, Tuple

import torch

from ravvent_tpu_torch.decode.beam import (
    NEG_INF, BeamResult, effective_steps, gather_tree, initial_cum, reconstruct_lengths, top_w,
)
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.ops import decoder_pad


def _compiled_shapes() -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The decoder units and beam widths the step's kernels are compiled
    for, from their one list (``csrc/beam_step_shapes.cuh``)."""
    text = (cuda_lib.CSRC / "beam_step_shapes.cuh").read_text()
    units = re.search(r"^#define RV_STEP_UNITS\(X\) (.*)$", text, re.M).group(1)
    max_beams = int(re.search(r"^#define RV_STEP_MAX_BEAMS (\d+)$", text, re.M).group(1))
    return (tuple(int(u) for u in re.findall(r"X\((\d+)\)", units)),
            tuple(range(1, max_beams + 1)))


STEP_UNITS, STEP_BEAMS = _compiled_shapes()  # (64, 128, 256), (1, ..., 32)
VP = 128  # padded vocabulary width of the flattened top-W row
SMEM_LIMIT = 232_448  # shared memory one block may use on Hopper (227 KB)
ATTEND_MODES = ("bf16", "f32", "quant", "quant_mxu")  # rv_beam_attend_info's mode numbers


class DecoderWeights(NamedTuple):
    """Depth-1 LSTM decoder weights as the step consumes them."""

    wx: torch.Tensor  # [V+U, 4U] cell kernel (one-hot rows, then attention rows)
    wh: torch.Tensor  # [U, 4U]
    b: torch.Tensor  # [4U]
    watt_h: torch.Tensor  # [U, U] cell-output half of the attention layer
    wfc: torch.Tensor  # [U, V]
    bfc: torch.Tensor  # [V]


def pack_decoder_weights(dec_params, mem: attn.AttnMemory) -> DecoderWeights:
    if len(dec_params["cells"]) != 1:
        raise ValueError("the beam step supports decoder_depth=1")
    if not mem.projected:
        raise ValueError("the beam step requires pre-projected memory")
    cell = dec_params["cells"][0]
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    return DecoderWeights(f32(cell["kernel"]), f32(cell["recurrent"]), f32(cell["bias"]),
                          f32(mem.watt_h), f32(dec_params["fc"]["kernel"]),
                          f32(dec_params["fc"]["bias"]))


class StepState(NamedTuple):
    tok: torch.Tensor
    h: torch.Tensor
    c: torch.Tensor
    att: torch.Tensor
    cum: torch.Tensor
    fin: torch.Tensor


def lstm_cell_plain(tok, att, h, c, wx, wh, b):
    """The decoder's LSTM cell on [one-hot(tok) | att]: ids >= V embed to
    zeros. Returns (h', c')."""
    U = wh.shape[0]
    V = wx.shape[0] - U
    emb = (tok[:, None] == torch.arange(V, device=tok.device)).to(torch.float32)
    z = torch.cat([emb, att], dim=1) @ wx + h @ wh + b
    i, f, g, o = z.split(U, dim=1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def attend_quantized(query, keys, values, mask, kscale, vscale, mxu: bool):
    """Luong attention of query [B, W, U] (f32) on int8 keys and values
    [B, S, U] with f32 scales [B, S], as the reference's int8 branches
    compute it. quant (``mxu=False``): scores = (bf16(q) . codes) * kscale,
    then the mask; context = bf16(align * vscale) . codes. quant_mxu:
    scores = (rn(q * 127) . codes) * (1/127) * kscale, then the mask;
    af = align * vscale, amax = max(max_s af, 1e-30), context =
    (rn(af * (127 / amax)) . codes) * (amax / 127). Every product of two
    codes is at most 127^2 and a sum over U <= 256 or S = 232 of them stays
    below 2^24, so the f32 products of integer codes here are exact in any
    order, as the kernel's integer dots are. Returns context [B, W, U]."""
    f32 = torch.float32
    kt = keys.to(f32).transpose(1, 2)
    if mxu:
        scores = torch.bmm(torch.round(query * 127.0), kt) * (1.0 / 127.0)
    else:
        scores = torch.bmm(query.to(torch.bfloat16).to(f32), kt)
    scores = scores * kscale[:, None, :]
    scores = torch.where(mask[:, None, :], scores, torch.full((), NEG_INF, device=keys.device))
    m = scores.max(dim=2, keepdim=True).values
    e = torch.exp(scores - m)
    af = e / e.sum(dim=2, keepdim=True) * vscale[:, None, :]
    if not mxu:
        return torch.bmm(af.to(torch.bfloat16).to(f32), values.to(f32))
    amax = torch.clamp(af.amax(dim=2, keepdim=True), min=1e-30)
    aq = torch.round(af * (127.0 / amax))
    # amax / 127 as a true division: on the card torch multiplies by the
    # reciprocal of a Python-scalar divisor
    return torch.bmm(aq, values.to(f32)) * (amax / torch.full((), 127.0, device=amax.device))


def cell_plain(st: StepState, w: DecoderWeights):
    """Plain version of the cell kernel: the LSTM cell of every hypothesis
    and the cell-output half of the attention layer. Returns h', c' and
    att_h = h'.watt_h, each [B*W, U] f32."""
    h_new, c_new = lstm_cell_plain(st.tok, st.att, st.h, st.c, w.wx, w.wh, w.b)
    return h_new, c_new, h_new @ w.watt_h


def candidates(st: StepState, h_new, att_h, keys, values, mask, w: DecoderWeights,
               end_token: int, scales=None, mxu: bool = False):
    """The step after the cell, up to its choice: attention and logits of
    every hypothesis, and the flattened candidate row. Returns att' [B*W, U]
    and total [B, W*VP], the cumulative log-prob of each (beam, token)
    candidate, padding columns at cum + finfo.min. ``scales``: (kscale,
    vscale) of int8 memory, else None."""
    B, S, U = keys.shape
    W = st.cum.shape[1]
    V = w.wfc.shape[1]
    if scales is None:
        mem = attn.AttnMemory(keys=keys, values=values, mask=mask)
        context, _ = attn.attend_beams(None, "luong", h_new.reshape(B, W, U), mem)
    else:
        context = attend_quantized(h_new.reshape(B, W, U), keys, values, mask, *scales, mxu)
    att_new = att_h + context.reshape(B * W, U)
    logits = att_new @ w.wfc + w.bfc  # [B*W, V]

    lmax = logits.max(dim=1, keepdim=True).values
    lse = torch.log(torch.exp(logits - lmax).sum(dim=1, keepdim=True)) + lmax
    step_lp = (logits - lse).reshape(B, W, V)
    fin_row = torch.full((V,), NEG_INF, device=keys.device)
    fin_row[end_token] = 0.0
    step_lp = torch.where(st.fin[..., None], fin_row, step_lp)
    # padding columns V..VP-1: logit finfo.min, log-prob finfo.min - lse ==
    # finfo.min, finished or not
    total = torch.full((B, W, VP), NEG_INF, device=keys.device) + st.cum[..., None]
    total[..., :V] = st.cum[..., None] + step_lp
    return att_new, total.reshape(B, W * VP)


def step_candidates(st: StepState, keys, values, mask, w: DecoderWeights, end_token: int,
                    scales=None, mxu: bool = False):
    """The plain step up to its choice: :func:`cell_plain`, then
    :func:`candidates`. Returns h', c', att' [B*W, U] and total [B, W*VP]."""
    h_new, c_new, att_h = cell_plain(st, w)
    att_new, total = candidates(st, h_new, att_h, keys, values, mask, w, end_token, scales, mxu)
    return h_new, c_new, att_new, total


def advance(st: StepState, h_new, c_new, att_new, new_cum, idx, end_token: int):
    """The step's beam permutation for the chosen candidates ``idx`` [B, W]
    of the flattened row. Returns (next state, parents [B, W] int32)."""
    B, W = new_cum.shape
    parent, token = idx // VP, idx % VP
    flat_parent = (parent + (torch.arange(B, device=idx.device) * W)[:, None]).reshape(-1)
    new_fin = torch.gather(st.fin, 1, parent) | (token == end_token)
    nxt = StepState(token.reshape(-1).to(torch.int32), h_new[flat_parent], c_new[flat_parent],
                    att_new[flat_parent], new_cum, new_fin)
    return nxt, parent.to(torch.int32)


def attend_plain(st: StepState, h_new, c_new, att_h, keys, values, mask, w: DecoderWeights,
                 end_token: int, scales=None, mxu: bool = False):
    """Plain version of the attend kernel: the step after the cell, from
    the cell's h', c', att_h. Returns (next state, parents [B, W])."""
    att_new, total = candidates(st, h_new, att_h, keys, values, mask, w, end_token, scales, mxu)
    new_cum, idx = top_w(total, st.cum.shape[1])
    return advance(st, h_new, c_new, att_new, new_cum, idx, end_token)


def beam_step_plain(st: StepState, keys, values, mask, w: DecoderWeights, end_token: int,
                    scales=None, mxu: bool = False):
    """Plain PyTorch version of one step: :func:`cell_plain`, then
    :func:`attend_plain`. Returns (next state, parents)."""
    return attend_plain(st, *cell_plain(st, w), keys, values, mask, w, end_token, scales, mxu)


def widths(sizes) -> str:
    """A set of compiled sizes as a message names it: ``1-32`` for a run."""
    sizes = tuple(sizes)
    if len(sizes) > 2 and sizes == tuple(range(sizes[0], sizes[-1] + 1)):
        return f"{sizes[0]}-{sizes[-1]}"
    return ", ".join(map(str, sizes))


def check_kernel_inputs(name: str, keys, values, mask, w: DecoderWeights, W: int,
                        end_token: int, state=(), scales=None, units=STEP_UNITS,
                        beams=STEP_BEAMS) -> None:
    """What a beam kernel (the step's, or the loop's with its own ``units``
    and ``beams``) takes: U in ``units``, W in ``beams``, bf16 or f32
    memory, or int8 memory with f32 [B, S] ``scales`` (kscale, vscale),
    contiguous tensors on the memory's device, 16-byte aligned keys and
    values. Raises ValueError otherwise, naming the shape."""
    B, S, U = keys.shape
    V = w.wfc.shape[1]
    if U not in units:
        raise ValueError(f"{name} kernel is compiled for {widths(units)} units, got U = {U}")
    if W not in beams:
        raise ValueError(f"{name} kernel is compiled for beam widths {widths(beams)}, "
                         f"got W = {W}")
    mem_dtypes = (torch.int8,) if scales is not None else (torch.bfloat16, torch.float32)
    if keys.dtype not in mem_dtypes or values.dtype != keys.dtype:
        raise ValueError(f"{name}: keys and values must both be bf16 or both f32, or both int8 "
                         f"with their scales")
    if not 0 <= end_token < V <= VP:
        raise ValueError(f"{name}: need 0 <= end_token < V <= {VP}")
    f32 = torch.float32
    if scales is not None:
        state = list(state) + [("kscale", scales[0], f32, (B, S)),
                               ("vscale", scales[1], f32, (B, S))]
    cuda_lib.check_tensors(name, keys.device, list(state) + [
        ("keys", keys, keys.dtype, (B, S, U)), ("values", values, keys.dtype, (B, S, U)),
        ("mask", mask, torch.bool, (B, S)), ("wx", w.wx, f32, (V + U, 4 * U)),
        ("wh", w.wh, f32, (U, 4 * U)), ("b", w.b, f32, (4 * U,)),
        ("watt_h", w.watt_h, f32, (U, U)), ("wfc", w.wfc, f32, (U, V)), ("bfc", w.bfc, f32, (V,)),
    ])
    if keys.data_ptr() % 16 or values.data_ptr() % 16:
        raise ValueError(f"{name}: keys and values must be 16-byte aligned")


class AttendInfo(NamedTuple):
    """An attend instance's CTA on the card: shared memory in bytes (dynamic
    and static), threads, and the CTAs an SM holds (0: it does not fit)."""

    smem: int
    threads: int
    per_sm: int


@functools.lru_cache(maxsize=None)
def attend_info(mode: str, U: int, W: int, S: int, V: int) -> AttendInfo:
    """What the attend kernel's instance for ``mode`` (one of
    :data:`ATTEND_MODES`), U units and W beams needs at S positions
    (rv_beam_attend_info; on the card)."""
    info = (ctypes.c_int * 3)()
    rc = cuda_lib.lib().rv_beam_attend_info(ATTEND_MODES.index(mode), U, W, S, V,
                                            ctypes.addressof(info))
    cuda_lib.check(rc, "beam_attend (info)")
    return AttendInfo(*info)


def attend_mode(keys, scales, mxu: bool) -> str:
    if scales is not None:
        return "quant_mxu" if mxu else "quant"
    return "bf16" if keys.dtype == torch.bfloat16 else "f32"


def check_attend_fits(name: str, keys, W: int, V: int, scales=None, mxu: bool = False) -> None:
    """Raise ValueError, naming the shape, when the attend kernel's CTA for
    these inputs needs more shared memory than a block has (long S)."""
    _, S, U = keys.shape
    mode = attend_mode(keys, scales, mxu)
    info = attend_info(mode, U, W, S, V)
    if info.smem > SMEM_LIMIT or info.per_sm < 1:
        raise ValueError(f"{name}: the attend kernel at U = {U}, W = {W}, S = {S} on {mode} "
                         f"memory needs {info.smem} B of shared memory a CTA (> {SMEM_LIMIT})")


def check_aligned(name: str, *tensors) -> None:
    """csrc/beam_step_f.cu reads the weights and the [B*W, U] state 16 bytes
    at a time. Raises ValueError unless each tensor is 16-byte aligned."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the weights and the [B*W, U] state must be 16-byte aligned")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch_cell(st: StepState, w: DecoderWeights):
    h_new, c_new, att_h = (torch.empty_like(st.h) for _ in range(3))
    rc = cuda_lib.lib().rv_beam_cell(
        st.h.shape[1], st.h.shape[0], w.wfc.shape[1], st.tok.data_ptr(), st.att.data_ptr(),
        st.h.data_ptr(), st.c.data_ptr(), w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(),
        w.watt_h.data_ptr(), h_new.data_ptr(), c_new.data_ptr(), att_h.data_ptr(),
        _stream(st.h.device))
    cuda_lib.check(rc, "beam_cell")
    cuda_lib.launches["beam_cell"] += 1
    return h_new, c_new, att_h


def _launch_attend(st: StepState, h_new, c_new, att_h, keys, values, mask, w: DecoderWeights,
                   end_token: int, scales=None, mxu: bool = False):
    B, S, U = keys.shape
    W = st.cum.shape[1]
    dev = keys.device
    nxt = StepState(torch.empty(B * W, dtype=torch.int32, device=dev), torch.empty_like(h_new),
                    torch.empty_like(c_new), torch.empty_like(att_h), torch.empty_like(st.cum),
                    torch.empty_like(st.fin))
    parent = torch.empty(B, W, dtype=torch.int32, device=dev)
    state_in = (h_new.data_ptr(), c_new.data_ptr(), att_h.data_ptr(), st.cum.data_ptr(),
                st.fin.data_ptr(), keys.data_ptr(), values.data_ptr())
    out = (w.wfc.data_ptr(), w.bfc.data_ptr(), nxt.tok.data_ptr(), parent.data_ptr(),
           nxt.h.data_ptr(), nxt.c.data_ptr(), nxt.att.data_ptr(), nxt.cum.data_ptr(),
           nxt.fin.data_ptr(), _stream(dev))
    V = w.wfc.shape[1]
    if scales is None:
        name = "beam_attend"
        rc = cuda_lib.lib().rv_beam_attend(int(keys.dtype == torch.bfloat16), U, W, B, S, V,
                                           VP, end_token, *state_in, mask.data_ptr(), *out)
    else:
        name = "beam_attend_i8mxu" if mxu else "beam_attend_i8"
        rc = cuda_lib.lib().rv_beam_attend_i8(int(mxu), U, W, B, S, V, VP, end_token,
                                              *state_in, scales[0].data_ptr(),
                                              scales[1].data_ptr(), mask.data_ptr(), *out)
    cuda_lib.check(rc, name)
    cuda_lib.launches[name] += 1
    return nxt, parent


def beam_cell(st: StepState, w: DecoderWeights):
    """The cell kernel for CUDA tensors, :func:`cell_plain` for CPU tensors.
    Returns h', c', att_h [B*W, U] f32 (the kernel's scratch)."""
    if not st.h.is_cuda:
        return cell_plain(st, w)
    N, U = st.h.shape
    V = w.wfc.shape[1]
    f32 = torch.float32
    if U not in STEP_UNITS:
        raise ValueError(f"beam_cell kernel is compiled for {widths(STEP_UNITS)} units, "
                         f"got U = {U}")
    cuda_lib.check_tensors("beam_cell", st.h.device, [
        ("tok", st.tok, torch.int32, (N,)), ("h", st.h, f32, (N, U)), ("c", st.c, f32, (N, U)),
        ("att", st.att, f32, (N, U)), ("wx", w.wx, f32, (V + U, 4 * U)),
        ("wh", w.wh, f32, (U, 4 * U)), ("b", w.b, f32, (4 * U,)),
        ("watt_h", w.watt_h, f32, (U, U)),
    ])
    check_aligned("beam_cell", st.h, st.c, st.att, w.wx, w.wh, w.b, w.watt_h)
    return _launch_cell(st, w)


def beam_attend(st: StepState, h_new, c_new, att_h, keys, values, mask, w: DecoderWeights,
                end_token: int, scales=None, mxu: bool = False):
    """The attend kernel for CUDA tensors, :func:`attend_plain` for CPU
    tensors, from the cell's h', c', att_h; ``scales`` and ``mxu`` as
    :func:`beam_step` takes them. Returns (next state, parents [B, W])."""
    if not keys.is_cuda:
        return attend_plain(st, h_new, c_new, att_h, keys, values, mask, w, end_token, scales,
                            mxu)
    B, S, U = keys.shape
    W = st.cum.shape[1]
    f32 = torch.float32
    check_kernel_inputs("beam_attend", keys, values, mask, w, W, end_token, [
        ("h_new", h_new, f32, (B * W, U)), ("c_new", c_new, f32, (B * W, U)),
        ("att_h", att_h, f32, (B * W, U)), ("cum", st.cum, f32, (B, W)),
        ("fin", st.fin, torch.bool, (B, W))], scales)
    check_aligned("beam_attend", h_new, c_new, att_h)
    check_attend_fits("beam_attend", keys, W, w.wfc.shape[1], scales, mxu)
    return _launch_attend(st, h_new, c_new, att_h, keys, values, mask, w, end_token, scales, mxu)


def beam_step(st: StepState, keys, values, mask, w: DecoderWeights, end_token: int,
              scales=None, mxu: bool = False):
    """One beam step: for CUDA tensors the two kernels, beam_cell then
    beam_attend (on int8 memory its quant or quant_mxu instance); for CPU
    tensors the plain version. ``scales``: (kscale, vscale) of int8 memory,
    whose step runs the quant_mxu branch when ``mxu``. Returns (next state,
    parents [B, W])."""
    if not keys.is_cuda:
        return beam_step_plain(st, keys, values, mask, w, end_token, scales, mxu)
    B, S, U = keys.shape
    W = st.cum.shape[1]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    check_kernel_inputs("beam_step", keys, values, mask, w, W, end_token, [
        ("tok", st.tok, i32, (B * W,)), ("h", st.h, f32, (B * W, U)), ("c", st.c, f32, (B * W, U)),
        ("att", st.att, f32, (B * W, U)), ("cum", st.cum, f32, (B, W)), ("fin", st.fin, b8, (B, W)),
    ], scales)
    check_aligned("beam_step", st.h, st.c, st.att, w.wx, w.wh, w.b, w.watt_h)
    check_attend_fits("beam_step", keys, W, w.wfc.shape[1], scales, mxu)
    nxt, parent = _launch_attend(st, *_launch_cell(st, w), keys, values, mask, w, end_token,
                                 scales, mxu)
    step = "beam_step" if scales is None else "beam_step_i8mxu" if mxu else "beam_step_i8"
    cuda_lib.launches[step] += 1
    return nxt, parent


def initial_state(B: int, W: int, U: int, start_token: int, device) -> StepState:
    z = lambda: torch.zeros(B * W, U, device=device)  # noqa: E731
    return StepState(torch.full((B * W,), start_token, dtype=torch.int32, device=device),
                     z(), z(), z(), initial_cum(B, W, device),
                     torch.zeros(B, W, dtype=torch.bool, device=device))


def step_loop(step, keys, values, mask, w: DecoderWeights, W: int, total_steps: int, eff: int,
              start_token: int, end_token: int, scales=None, mxu: bool = False):
    """``eff`` beam steps of ``step`` (beam_step or beam_step_plain) from the
    initial state; ``scales`` and ``mxu`` as :func:`beam_step` takes them.
    Returns tokens, parents [T, B, W] int32 and scores [T, B, W] f32, zero
    at steps >= eff."""
    B = keys.shape[0]
    dev = keys.device
    tokens = torch.zeros(total_steps, B, W, dtype=torch.int32, device=dev)
    parents = torch.zeros_like(tokens)
    scores = torch.zeros(total_steps, B, W, device=dev)
    st = initial_state(B, W, w.wh.shape[0], start_token, dev)
    for t in range(eff):
        st, parent = step(st, keys, values, mask, w, end_token, scales, mxu)
        tokens[t] = st.tok.reshape(B, W)
        parents[t] = parent
        scores[t] = st.cum
    return tokens, parents, scores


def backtrack(tokens, parents, scores, eff: int, end_token: int) -> BeamResult:
    """Lengths, then gather_tree from step eff - 1, of [T, B, W] trajectories;
    the result is batch-major [B, T, W]."""
    lengths = reconstruct_lengths(tokens, parents, end_token)
    final = gather_tree(tokens, parents, lengths, eff, end_token)
    return BeamResult(tokens=final.permute(1, 0, 2), scores=scores.permute(1, 0, 2))


beam_step_loop = functools.partial(step_loop, beam_step)  # one beam-step launch per step


def fused_beam_decode(dec_params, mem: attn.AttnMemory, vocab_size: int, beam_width: int,
                      total_steps: int, max_steps: Optional[int] = None, start_token: int = 2,
                      end_token: int = 1, *, loop, quant_mxu: bool = False) -> BeamResult:
    """Beam search through a fused kernel's loop: ``loop`` is
    :data:`beam_step_loop` (one launch per step) or
    ops/beam_loop_cuda.py:beam_loop (one launch for the whole loop). Runs
    ``eff = min(max_steps, total_steps)`` steps (the tail is never computed:
    tokens, parents and scores stay 0 there), then rebuilds the lengths and
    backtracks. Requires pre-projected memory, a depth-1 LSTM decoder and
    Luong attention. On int8 memory ``quant_mxu`` picks the step's integer
    dots, as the reference's ``beam_step_decode(..., quant_mxu=)``; it is
    ignored otherwise. On the card a decoder of a width the kernels are not
    compiled for, up to the widest, runs the next compiled width on its
    weights and memory zero-padded (ops/decoder_pad.py; counted as
    ``decoder_padded``); a wider one raises ValueError."""
    if vocab_size > VP:
        raise ValueError(f"vocab_size must be <= {VP}")
    U = mem.keys.shape[2]
    if decoder_pad.on_card(mem.keys) and U not in STEP_UNITS:
        Up = decoder_pad.padded_width(U, STEP_UNITS, "the beam kernels' decoder width")
        dec_params = decoder_pad.pad_decoder_params(dec_params, Up)
        mem = decoder_pad.pad_memory_units(mem, Up)
        cuda_lib.launches["decoder_padded"] += 1
    w = pack_decoder_weights(dec_params, mem)
    eff = effective_steps(total_steps, max_steps)
    scales = (mem.kscale.contiguous(), mem.vscale.contiguous()) if mem.quantized else None
    tokens, parents, scores = loop(mem.keys.contiguous(), mem.values.contiguous(),
                                   mem.mask.contiguous(), w, beam_width, total_steps, eff,
                                   start_token, end_token, scales, quant_mxu and mem.quantized)
    return backtrack(tokens, parents, scores, eff, end_token)


# counterpart of beam_loop_pallas.py:beam_step_decode
beam_step_decode = functools.partial(fused_beam_decode, loop=beam_step_loop)
