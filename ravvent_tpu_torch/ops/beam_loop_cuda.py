"""The whole beam-search loop in one kernel launch: the CUDA kernel, its plain
version, the decode entry point, and a replay that holds a loop's result
against the plain step.

Counterpart of ravvent_tpu/ops/beam_loop_pallas.py (the TPU kernel
``_beam_loop_kernel``, its call ``_beam_loop_call`` and the entry
``beam_loop_decode``). The kernel is ``csrc/beam_loop.cu``;
:func:`beam_loop` launches it for CUDA tensors and runs
:func:`beam_loop_plain` for CPU tensors only.

Each step has the semantics of the per-step kernel (ops/beam_step_cuda.py):
the two TPU kernels compute the same step, one launch per step or one launch
for the whole loop. So the plain version is ``eff`` steps of
``beam_step_plain``. The kernel runs one batch row per CTA for all ``eff =
min(max_steps, total_steps)`` steps, in one of two layouts (:data:`LAYOUTS`):
"resident" (csrc/beam_loop.cu, 128 units and W in 1-5 or 8), the row's keys
(and, for bf16 memory, its values) resident in shared memory and the decoder
weights resident across the CTAs of a thread-block cluster, each computing
its slice of the products for every row of the cluster; "streamed"
(csrc/beam_loop_streamed.cu, every width of :data:`LOOP_UNITS` and
:data:`LOOP_BEAMS`), nothing resident but the step's state. The C entry
takes the resident layout where it exists and fits the card, else the
streamed one, unless the caller asks for one. It writes the token, parent
and cumulative score of every live step, and leaves the steps from ``eff``
on at zero, as the per-step loop does. The reference kernel also recomputed
those dead steps from frozen state; the backtracked tokens do not read them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from ravvent_tpu_torch.decode.beam import NEG_INF, top_w
from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.ops.beam_step_cuda import (
    STEP_BEAMS, STEP_UNITS, VP, DecoderWeights, advance, beam_step_plain, check_aligned,
    check_kernel_inputs, fused_beam_decode, initial_state, step_candidates, step_loop,
)

# the shapes the loop's kernels are compiled for: the beam step's one list
# (csrc/beam_step_shapes.cuh), so that the two cannot drift
LOOP_UNITS, LOOP_BEAMS = STEP_UNITS, STEP_BEAMS
MAX_CANDIDATES = 32  # V + W: a beam's candidates that can win lie on one warp's lanes
# the C entry's layout numbers: "auto" is the resident layout where it exists
# and fits the card, else the streamed one
LAYOUTS = ("auto", "resident", "streamed")


class LoopPlan(NamedTuple):
    """The layout a launch takes on the card: its name, the cluster size (1
    when streamed), the clusters (CTAs when streamed) the card holds at once
    and the dynamic shared memory a CTA in bytes."""

    layout: str
    cluster: int
    active: int
    smem: int


def plan(mem_dtype, U: int, W: int, S: int, V: int, layout: str = "auto") -> LoopPlan:
    """The layout rv_beam_loop takes on memory of ``mem_dtype`` for this
    shape (rv_beam_loop_clusters, with cudaOccupancyMaxActiveClusters; on
    the card). Raises ValueError, naming the shape, where the layout asked
    for does not exist or no layout fits the card."""
    if layout not in LAYOUTS:
        raise ValueError(f"beam_loop: layout must be one of {LAYOUTS}, got {layout!r}")
    info = (ctypes.c_int * 4)()
    rc = cuda_lib.lib().rv_beam_loop_clusters(int(mem_dtype == torch.bfloat16), U, W, S, V,
                                              LAYOUTS.index(layout), ctypes.addressof(info))
    if rc != 0:
        raise ValueError(f"beam_loop: no {'' if layout == 'auto' else layout + ' '}layout of the "
                         f"kernel takes U = {U}, W = {W}, S = {S}, V = {V} on "
                         f"{str(mem_dtype).replace('torch.', '')} memory on this card (cudaError "
                         f"{rc}); use the per-step kernels (beam_impl='step')")
    return LoopPlan(LAYOUTS[info[0]], info[1], info[2], info[3])


def beam_loop_plain(keys, values, mask, w: DecoderWeights, W: int, total_steps: int, eff: int,
                    start_token: int, end_token: int):
    """Plain PyTorch version: ``eff`` steps of beam_step_plain. Returns
    tokens, parents [T, B, W] int32 and scores [T, B, W] f32 (zero from
    step eff on)."""
    return step_loop(beam_step_plain, keys, values, mask, w, W, total_steps, eff,
                     start_token, end_token)


def beam_loop(keys, values, mask, w: DecoderWeights, W: int, total_steps: int, eff: int,
              start_token: int, end_token: int, scales=None, mxu: bool = False,
              layout: str = "auto"):
    """The whole loop: the CUDA kernel (one launch, in ``layout``, one of
    :data:`LAYOUTS`) for CUDA tensors, the plain version for CPU tensors.
    Returns tokens, parents, scores [T, B, W]. int8 memory (``scales``
    given) raises ValueError: the reference has no int8 loop
    (beam_loop_pallas.py:297)."""
    if scales is not None or keys.dtype == torch.int8:
        raise ValueError("beam_loop: int8 memory runs only on the beam step "
                         "(beam_step_decode, beam_impl='step')")
    if not keys.is_cuda:
        return beam_loop_plain(keys, values, mask, w, W, total_steps, eff, start_token, end_token)
    B, S, U = keys.shape
    V = w.wfc.shape[1]
    check_kernel_inputs("beam_loop", keys, values, mask, w, W, end_token, units=LOOP_UNITS,
                        beams=LOOP_BEAMS)
    check_aligned("beam_loop", w.wx, w.wh, w.b, w.watt_h)
    if not 0 <= start_token < VP:
        raise ValueError(f"beam_loop: need 0 <= start_token < {VP}")
    if V + W > MAX_CANDIDATES:
        raise ValueError(f"beam_loop: the kernel takes V + W <= {MAX_CANDIDATES}, got {V + W}")
    if not 0 <= eff <= total_steps:
        raise ValueError(f"beam_loop: need 0 <= eff <= total_steps, got {eff}, {total_steps}")
    plan(keys.dtype, U, W, S, V, layout)  # raises, naming the shape, where none fits
    dev = keys.device
    tokens = torch.zeros(total_steps, B, W, dtype=torch.int32, device=dev)
    parents = torch.zeros_like(tokens)
    scores = torch.zeros(total_steps, B, W, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = cuda_lib.lib().rv_beam_loop(
        int(keys.dtype == torch.bfloat16), U, W, B, S, V, total_steps, eff, start_token,
        end_token, LAYOUTS.index(layout), keys.data_ptr(), values.data_ptr(), mask.data_ptr(),
        w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(), w.watt_h.data_ptr(), w.wfc.data_ptr(),
        w.bfc.data_ptr(), tokens.data_ptr(), parents.data_ptr(), scores.data_ptr(), stream,
    )
    cuda_lib.check(rc, "beam_loop")
    cuda_lib.launches["beam_loop"] += 1
    return tokens, parents, scores


# counterpart of beam_loop_pallas.py:beam_loop_decode: pre-projected,
# non-quantized memory (bf16 or f32), a depth-1 LSTM decoder, Luong attention
beam_loop_decode = functools.partial(fused_beam_decode, loop=beam_loop)


class Replay(NamedTuple):
    """A whole-loop result held against the plain step at each live step."""

    exact: float  # share of live picks equal to the plain top-W pick
    rank_err: float  # max |picks' plain scores, sorted - plain top-W scores|
    score_err: float  # max |the result's score - its cum before + the plain step log-prob|
    distinct: bool  # no candidate above finfo.min picked twice in a row's step


def replay_plain(tokens, parents, scores, keys, values, mask, w: DecoderWeights, eff: int,
                 start_token: int, end_token: int) -> Replay:
    """Replay the live steps of a whole-loop result (tokens, parents,
    scores [T, B, W]) through the plain step. Each step starts from the
    result's own cumulative scores and the plain state of its own earlier
    picks; the plain step scores every candidate, and the result's picks
    and scores are held against them. So every live step of every row is
    checked, also after a near-tie that the result broke the other way
    (which lowers ``exact`` but not the two errors), and an error shows at
    the step that makes it rather than summed over the steps before.
    ``distinct``: no candidate above finfo.min is picked twice in a step."""
    _, B, W = tokens.shape
    st = initial_state(B, W, w.wh.shape[0], start_token, keys.device)
    same = lambda a, b: torch.where(a == b, 0.0, (a - b).abs()).max().item()  # noqa: E731
    exact, rank_err, score_err, distinct = 0, 0.0, 0.0, True
    for t in range(eff):
        h, c, att, total = step_candidates(st, keys, values, mask, w, end_token)
        ref_cum, ref_idx = top_w(total, W)
        idx = parents[t].long() * VP + tokens[t].long()
        # each pick's total, every earlier pick replaced by finfo.min, as
        # the reference's iterated argmax sees it: where fewer than W
        # candidates are above finfo.min (W = 8 > V at step 1), a pick at
        # finfo.min comes again, as in the reference
        cur, picked = total.clone(), torch.empty_like(scores[t])
        for k in range(W):
            picked[:, k] = torch.gather(cur, 1, idx[:, k:k + 1])[:, 0]
            cur.scatter_(1, idx[:, k:k + 1], NEG_INF)
        exact += (idx == ref_idx).sum().item()
        rank_err = max(rank_err, same(picked.sort(dim=1, descending=True).values, ref_cum))
        score_err = max(score_err, same(scores[t], picked))
        # no candidate above finfo.min picked twice
        key = torch.where(picked > NEG_INF, idx, -1 - torch.arange(W, device=idx.device))
        distinct &= bool((key.sort(dim=1).values.diff(dim=1) != 0).all())
        st, _ = advance(st, h, c, att, scores[t], idx, end_token)
    return Replay(exact / max(1, eff * B * W), rank_err, score_err, distinct)
