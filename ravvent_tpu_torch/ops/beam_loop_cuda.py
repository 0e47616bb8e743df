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
``beam_step_plain``. The kernel runs one batch row per CTA with the row's
keys (and, for bf16 memory, its values) resident in shared memory for all
``eff = min(max_steps, total_steps)`` steps; the CTAs of a thread-block
cluster keep the decoder weights resident between them, each computing its
slice of the products for every row of the cluster. It writes the token,
parent and cumulative score of every live step, and leaves the steps from
``eff`` on at zero, as the per-step loop does. The reference kernel also recomputed
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
    SMEM_LIMIT, VP, DecoderWeights, advance, beam_step_plain, check_aligned, check_kernel_inputs,
    fused_beam_decode, initial_state, step_candidates, step_loop,
)

# the shapes csrc/beam_loop.cu is compiled for: the flagship's 128 units and
# these beam widths (its own sets; the step's kernels take more)
LOOP_UNITS = (128,)
LOOP_BEAMS = (1, 2, 3, 4, 5, 8)
MAX_CANDIDATES = 32  # V + W: a beam's candidates that can win lie on one warp's lanes


def beam_loop_plain(keys, values, mask, w: DecoderWeights, W: int, total_steps: int, eff: int,
                    start_token: int, end_token: int):
    """Plain PyTorch version: ``eff`` steps of beam_step_plain. Returns
    tokens, parents [T, B, W] int32 and scores [T, B, W] f32 (zero from
    step eff on)."""
    return step_loop(beam_step_plain, keys, values, mask, w, W, total_steps, eff,
                     start_token, end_token)


def beam_loop(keys, values, mask, w: DecoderWeights, W: int, total_steps: int, eff: int,
              start_token: int, end_token: int, scales=None, mxu: bool = False):
    """The whole loop: the CUDA kernel (one launch) for CUDA tensors, the
    plain version for CPU tensors. Returns tokens, parents, scores
    [T, B, W]. int8 memory (``scales`` given) raises ValueError: the
    reference has no int8 loop (beam_loop_pallas.py:297)."""
    if scales is not None or keys.dtype == torch.int8:
        raise ValueError("beam_loop: int8 memory runs only on the beam step "
                         "(beam_step_decode, beam_impl='step')")
    if not keys.is_cuda:
        return beam_loop_plain(keys, values, mask, w, W, total_steps, eff, start_token, end_token)
    B, S, _ = keys.shape
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
    mem_bf16 = int(keys.dtype == torch.bfloat16)
    lib = cuda_lib.lib()
    smem = lib.rv_beam_loop_smem(mem_bf16, W, S, V)
    if smem > SMEM_LIMIT:
        raise ValueError(f"beam_loop: one row of S={S} needs {smem} B of shared memory "
                         f"(> {SMEM_LIMIT}); use the per-step kernel (beam_impl='step')")
    dev = keys.device
    tokens = torch.zeros(total_steps, B, W, dtype=torch.int32, device=dev)
    parents = torch.zeros_like(tokens)
    scores = torch.zeros(total_steps, B, W, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.rv_beam_loop(
        mem_bf16, W, B, S, V, total_steps, eff, start_token, end_token,
        keys.data_ptr(), values.data_ptr(), mask.data_ptr(), w.wx.data_ptr(), w.wh.data_ptr(),
        w.b.data_ptr(), w.watt_h.data_ptr(), w.wfc.data_ptr(), w.bfc.data_ptr(),
        tokens.data_ptr(), parents.data_ptr(), scores.data_ptr(), stream,
    )
    cuda_lib.check(rc, "beam_loop")
    cuda_lib.launches["beam_loop"] += 1
    return tokens, parents, scores


def clusters(mem_dtype, W: int, S: int, V: int) -> Tuple[int, int]:
    """(cluster size, clusters the card holds at once) with which the kernel
    launches on memory of ``mem_dtype`` (cudaOccupancyMaxActiveClusters)."""
    size, active = ctypes.c_int(0), ctypes.c_int(0)
    rc = cuda_lib.lib().rv_beam_loop_clusters(int(mem_dtype == torch.bfloat16), W, S, V,
                                              ctypes.addressof(size), ctypes.addressof(active))
    cuda_lib.check(rc, "beam_loop (occupancy)")
    return size.value, active.value


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
