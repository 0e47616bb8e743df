"""One bidirectional LSTM layer: the CUDA kernels and their plain version.

Counterpart of ravvent_tpu/ops/rnn_pallas.py (the TPU kernel
``_bilstm_kernel``, entry point ``run_bidi_lstm_pallas``). The stream dtype
is the input's: an f32 stream runs ``csrc/bilstm.cu``, a bf16 stream
``csrc/bilstm_bf16.cu`` (bf16 x, Wx and Wh, f32 bias, state and
accumulation, bf16 outputs, as the TPU kernel runs it when its input is
bf16); past 256 units (:data:`WIDE_UNITS`) ``csrc/bilstm_bf16_wide.cu``,
which takes the same layouts and arguments, and ``csrc/bilstm_wide.cu``: on
an input of more than 16 features a GEMM kernel computes x.Wx + b into an
f32 scratch a window of time steps at a time, then a kernel runs the
recurrence over thread-block clusters, its cluster size C, rows R and
window taken from the card's plan (:func:`wide_plan`). :func:`bilstm_layer`
launches the kernels for CUDA tensors (one counted launch a layer) and runs
:func:`bilstm_layer_plain` for CPU tensors only.

Layouts (batch-major, as the model passes them):
  xs [B, T, F] in the stream dtype; wx [2, F, 4U], wh [2, U, 4U] in the
  stream dtype, b [2, 4U] f32 (forward, backward); h0, c0 [2, B, U] f32.
  Returns (out [B, T, 2U] in the stream dtype, time-aligned — forward units
  first —, h [2, B, U] f32, c [2, B, U] f32).
  Each kernel reads its weights in its own layout (:func:`kernel_layout`:
  f32 grouped by unit, bf16 in mma-fragment order), which the engine makes
  once and passes as ``layout``. Both kernels are compiled for U in
  :data:`KERNEL_UNITS`; a layer of another width U up to the widest runs at
  the next compiled width Up (:func:`padded_units`), its weights
  zero-padded once by :func:`kernel_layout` (:func:`pad_weights`): a padded
  unit's pre-activations are exactly 0, so its c and h stay 0 and it adds
  only exact zeros to the real units' sums. :func:`kernel_takes` states the
  shapes the kernels take.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple, Optional, Tuple

import torch

from ravvent_tpu_torch.ops import cuda_lib


def _compiled_units(macro: str) -> Tuple[int, ...]:
    """The unit counts of one of the kernels' lists in
    ``csrc/bilstm_units.cuh`` (``RV_BILSTM_UNITS``, ``RV_BILSTM_WIDE_UNITS``)."""
    text = (cuda_lib.CSRC / "bilstm_units.cuh").read_text()
    line = re.search(rf"^#define {macro}\(X\) (.*)$", text, re.M).group(1)
    return tuple(int(u) for u in re.findall(r"X\((\d+)\)", line))


# the widths csrc/bilstm_wide.cu and csrc/bilstm_bf16_wide.cu run: (320,
# 384, 448, 512)
WIDE_UNITS = _compiled_units("RV_BILSTM_WIDE_UNITS")
# every compiled width, increasing: (32, 64, 96, 128, 192, 256) in
# csrc/bilstm.cu and csrc/bilstm_bf16.cu, then WIDE_UNITS
KERNEL_UNITS = _compiled_units("RV_BILSTM_UNITS") + WIDE_UNITS
STREAMS = (torch.float32, torch.bfloat16)


def padded_units(U: int) -> Optional[int]:
    """The compiled width a layer of ``U`` units runs at: the least of
    :data:`KERNEL_UNITS` that is at least U; None past the widest."""
    return next((u for u in KERNEL_UNITS if u >= U), None) if U > 0 else None


def bilstm_layer_plain(xs, wx, wh, b, h0, c0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version, the reference scan (models/rnn.py:run_bidi_layer
    in the JAX package): the input projection hoisted out of the time loop,
    one batched recurrent product per step for both directions. On a bf16
    stream the products take bf16 operands (x, the weights and bf16(h))
    upcast to f32, so they accumulate in f32 as the kernels do; a bf16
    ``@`` on the CPU would round its output to bf16."""
    B, T, F = xs.shape
    U = wh.shape[1]
    bf16 = xs.dtype == torch.bfloat16
    x2 = xs.reshape(B * T, F).float()
    wx, wh = wx.float(), wh.float()
    proj_f = (x2 @ wx[0] + b[0]).reshape(B, T, 4 * U)
    proj_b = (x2 @ wx[1] + b[1]).reshape(B, T, 4 * U)
    h, c = h0, c0
    out = xs.new_empty(B, T, 2 * U)
    for t in range(T):
        hr = h.to(torch.bfloat16).float() if bf16 else h
        z = torch.stack([proj_f[:, t], proj_b[:, T - 1 - t]]) + torch.bmm(hr, wh)
        i, f, g, o = z.split(U, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[:, t, :U] = h[0]
        out[:, T - 1 - t, U:] = h[1]
    return out, h, c


class KernelLayout(NamedTuple):
    """A layer's weights as its stream's kernel reads them
    (:func:`kernel_layout`), at the compiled width U the kernel runs. f32
    (``csrc/bilstm.cu``, ``csrc/bilstm_wide.cu``): ``kx`` is F rounded up to
    4; ``wx`` [2, kx, U, 4] and ``wh`` [2, U, U, 4] f32, row k's gate
    columns i, f, g, o grouped by unit. bf16 (``csrc/bilstm_bf16.cu``,
    ``csrc/bilstm_bf16_wide.cu``): ``kx`` is F rounded up to 16; ``wx`` and
    ``wh`` bf16 [2, U / 8 warps, k-tiles, 4 gates, 32 lanes, 4] in
    mma-fragment order. Wx's rows past F are zero. ``units``: the layer's
    own width (U, or less where the layer is padded). ``padded``: the padded
    layer's (wx, wh, b) in the plain layout (:func:`pad_weights`), which the
    kernel runs; None where nothing is padded."""
    kx: int
    wx: torch.Tensor
    wh: torch.Tensor
    units: int
    padded: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = None


def padded_k(F: int, dtype) -> int:
    """The kernel's Wx rows for an input of F features: F rounded up to the
    stream's k-step (4 for f32, 16 for bf16)."""
    step = 4 if dtype == torch.float32 else 16
    return -(-F // step) * step


def _by_unit(w: torch.Tensor) -> torch.Tensor:
    """[2, K, 4U] as [2, K, U, 4]: row k's four gates of unit u adjacent."""
    return w.reshape(2, w.shape[1], 4, w.shape[2] // 4).transpose(2, 3).contiguous()


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """[2, K, 4U] (K a multiple of 16) as mma.m16n8k16 B fragments: for warp
    w of U / 8 (units [8w, 8w + 8)), k-tile kt, gate and lane (g = lane // 4,
    tg = lane % 4), 4 bf16 = registers b0, b1; register r holds rows
    k = 16 kt + 2 tg + 8 r + e (e = 0, 1) of column n = gate * U + 8 w + g."""
    kt_n, U = w.shape[1] // 16, w.shape[2] // 4
    ar = lambda n, dim: torch.arange(n, device=w.device).view([n if i == dim else 1 for i in range(6)])
    warp, kt, gate, lane, r, e = (ar(n, i) for i, n in enumerate((U // 8, kt_n, 4, 32, 2, 2)))
    k = 16 * kt + 2 * (lane % 4) + 8 * r + e
    n = gate * U + 8 * warp + lane // 4
    return w[:, k, n].reshape(2, U // 8, kt_n, 4, 32, 4).contiguous()


def _pad_gates(w: torch.Tensor, U: int, Up: int) -> torch.Tensor:
    """[..., 4U] as [..., 4Up]: each gate's block of U columns followed by
    Up - U zero columns."""
    lead = w.shape[:-1]
    return torch.nn.functional.pad(w.reshape(*lead, 4, U), (0, Up - U)).reshape(*lead, 4 * Up)


def pad_weights(wx, wh, b, in_units: Optional[int] = None):
    """A layer of U units as the layer of ``padded_units(U)`` = Up units
    that the kernel runs: each gate's columns of ``wx`` [2, F, 4U], ``wh``
    [2, U, 4U] and ``b`` [2, 4U] zero-padded to Up, and Wh's rows past U
    zero. With ``in_units`` I, the layer's input is the previous padded
    layer's output [B, T, 2 Ip] (Ip = padded_units(I), each direction's I
    units first in its half): Wx's 2I rows go to those places and the rows
    between are zero. Returns (wx [2, F or 2 Ip, 4Up], wh [2, Up, 4Up], b [2,
    4Up])."""
    U = wh.shape[1]
    Up = padded_units(U)
    if in_units is not None:
        ip = padded_units(in_units)
        if wx.shape[1] != 2 * in_units:
            raise ValueError(f"pad_weights: Wx has {wx.shape[1]} rows, not 2 x {in_units} units")
        placed = wx.new_zeros(2, 2 * ip, 4 * U)
        placed[:, :in_units] = wx[:, :in_units]
        placed[:, ip:ip + in_units] = wx[:, in_units:]
        wx = placed
    wh = torch.nn.functional.pad(_pad_gates(wh, U, Up), (0, 0, 0, Up - U))
    return _pad_gates(wx, U, Up), wh, _pad_gates(b, U, Up)


def kernel_layout(wx: torch.Tensor, wh: torch.Tensor, b: Optional[torch.Tensor] = None,
                  in_units: Optional[int] = None) -> KernelLayout:
    """The stream's kernel's layout of plain ``wx`` [2, F, 4U] and ``wh``
    [2, U, 4U] (the stream is their dtype), Wx zero-padded to
    :func:`padded_k` rows. A layer of an uncompiled width U is laid out at
    its compiled width from :func:`pad_weights` of ``wx``, ``wh`` and ``b``
    (``in_units``: the width of the padded layer before it, whose outputs it
    takes), which it keeps as ``padded``. Made once per engine
    (models/rnn.py:kernel_weights); the wrapper makes it on each call when it
    is not given."""
    U = wh.shape[1]
    Up = padded_units(U)
    if Up is None:
        raise ValueError(f"bilstm kernels are compiled for {KERNEL_UNITS} units, got {U}")
    padded = None
    if Up != U:
        if b is None:
            raise ValueError(f"kernel_layout: a layer padded to {Up} units needs its bias")
        padded = pad_weights(wx, wh, b, in_units)
        wx, wh = padded[:2]
    kx = padded_k(wx.shape[1], wx.dtype)
    wx = torch.nn.functional.pad(wx, (0, 0, 0, kx - wx.shape[1]))
    if wx.dtype == torch.float32:
        return KernelLayout(kx, _by_unit(wx), _by_unit(wh), U, padded)
    return KernelLayout(kx, _fragments(wx), _fragments(wh), U, padded)


def launch(entry, xs, layout: KernelLayout, b, h0, c0, out, hN, cN, *extra) -> int:
    """Call a BiLSTM kernel's C entry ``entry`` (both streams take the same
    arguments) on PyTorch's current stream; ``extra`` arguments go before the
    stream (the wide kernels' scratch and plan, the timing build's stamps)."""
    B, T, F = xs.shape
    return entry(xs.data_ptr(), B, T, F, layout.kx, h0.shape[-1], layout.wx.data_ptr(),
                 layout.wh.data_ptr(), b.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                 out.data_ptr(), hN.data_ptr(), cN.data_ptr(), *extra,
                 torch.cuda.current_stream(xs.device).cuda_stream)


def bf16_wide_cta(U: int, F: int) -> dict:
    """What one CTA of the wide bf16 kernel (csrc/bilstm_bf16_wide.cu) takes
    for a layer of ``U`` units (one of :data:`WIDE_UNITS`) on ``F`` input
    features: threads, dynamic shared memory bytes, batch rows, registers
    and local memory bytes a thread. Needs the card."""
    info = (ctypes.c_int * 5)()
    entry = "rv_bilstm_layer_bf16_wide_cta"
    cuda_lib.check(getattr(cuda_lib.lib(), entry)(U, padded_k(F, torch.bfloat16), info), entry)
    return dict(zip(("threads", "smem_bytes", "rows", "registers", "local_bytes"), info))


class WidePlan(NamedTuple):
    """How the wide f32 kernels (csrc/bilstm_wide.cu) run a layer on this
    card (its C entry ``rv_bilstm_layer_wide_cta``): the recurrence's CTA
    (threads, dynamic shared memory bytes, batch rows R, registers and local
    memory bytes a thread), the cluster size C, the time steps a window (the
    scratch holds one), the clusters the card holds at once and the
    projection GEMM's registers a thread."""
    threads: int
    smem_bytes: int
    rows: int
    registers: int
    local_bytes: int
    cluster: int
    window: int
    clusters: int
    proj_registers: int


@functools.lru_cache(maxsize=None)
def _plan(U: int, kx: int, B: int, T: int, cluster: int, rows: int, device: int) -> WidePlan:
    info = (ctypes.c_int * 9)()
    entry = "rv_bilstm_layer_wide_cta"
    with torch.cuda.device(device):
        cuda_lib.check(getattr(cuda_lib.lib(), entry)(U, kx, B, T, cluster, rows, info), entry)
    return WidePlan(*info)


def wide_plan(U: int, F: int, B: int, T: int, device=None, cluster: int = 0,
              rows: int = 0) -> WidePlan:
    """The card's plan for an f32 layer of ``U`` units (one of
    :data:`WIDE_UNITS`) on ``F`` input features, ``B`` rows and ``T`` steps
    (made once a shape and card): the C entry's rule, or, with ``cluster``
    > 0, the given cluster size and ``rows``. Needs the card."""
    cuda_lib.lib()  # the kernels built and loaded before the card is asked
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return _plan(U, padded_k(F, torch.float32), B, T, cluster, rows, index)


def wide_launch(xs, layout: "KernelLayout", b, h0, c0, parts: int = 3, bufs=None,
                entry=None, extra=(), plan: Optional[WidePlan] = None):
    """Launch the wide f32 kernels on a layer at a compiled width of
    :data:`WIDE_UNITS` (``layout`` not padded, the tensors checked by the
    caller) on ``plan`` (:func:`wide_plan`'s rule when None): ``parts`` 1
    the projection alone, 2 the recurrence alone (on the scratch as it
    stands), 3 both. ``bufs`` (out, hN, cN, scratch) are allocated when None
    (the scratch [2, Tw, B, U, 4] f32 on an input of more than 16 features,
    else None) and returned. ``entry``: another C entry of the same
    arguments (the timing build), ``extra`` pointers after them (its
    stamps)."""
    B, T, F = xs.shape
    U = h0.shape[-1]
    if plan is None:
        plan = wide_plan(U, F, B, T, xs.device)
    if bufs is None:
        scratch = (torch.empty(2, plan.window, B, U, 4, device=xs.device)
                   if F > 16 else None)
        bufs = (torch.empty(B, T, 2 * U, device=xs.device),
                torch.empty(2, B, U, device=xs.device), torch.empty(2, B, U, device=xs.device),
                scratch)
    out, hN, cN, scratch = bufs
    if entry is None:
        entry = cuda_lib.lib().rv_bilstm_layer_wide
    cuda_lib.check(launch(entry, xs, layout, b, h0, c0, out, hN, cN,
                          scratch.data_ptr() if scratch is not None else None, plan.cluster,
                          plan.rows, plan.window, parts, *extra), "bilstm")
    return bufs


def kernel_takes(U: int, F: int, dtype) -> bool:
    """Whether the kernels take a layer of ``U`` units on ``F`` input
    features on a stream of ``dtype``: the shapes :func:`bilstm_layer`
    accepts on a CUDA tensor (it raises on any other). U at most the widest
    of :data:`KERNEL_UNITS` (a width between runs zero-padded to the next,
    Up = :func:`padded_units`), F <= 2 Up (what the C entries take at Up),
    an f32 or bf16 stream, and on bf16 F <= 16 or a multiple of 8 (the bf16
    kernel also needs such an input 16-byte aligned, which a contiguous
    tensor of its own allocation is)."""
    Up = padded_units(U)
    return (Up is not None and 0 < F <= 2 * Up and dtype in STREAMS
            and (dtype == torch.float32 or F <= 16 or F % 8 == 0))


def pad_units(t: torch.Tensor, Up: int) -> torch.Tensor:
    """A state [2, B, U] as [2, B, Up], the padded units zero."""
    return torch.nn.functional.pad(t, (0, Up - t.shape[-1])).contiguous()


def unpad_outputs(out: torch.Tensor, U: int) -> torch.Tensor:
    """Outputs [B, T, 2 Up] of a padded layer as [B, T, 2U]: each
    direction's first U units."""
    Up = out.shape[-1] // 2
    return torch.cat([out[..., :U], out[..., Up:Up + U]], dim=-1)


def bilstm_layer(xs, wx, wh, b, h0, c0, layout: Optional[KernelLayout] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One BiLSTM layer: the CUDA kernel of the stream dtype for CUDA tensors,
    the plain version for CPU tensors. ``layout``: :func:`kernel_layout` of
    the layer's ``wx`` and ``wh`` (and ``b``), made once by the caller; made
    here when None. A layer of an uncompiled width runs the kernel at its
    compiled width on the layout's padded weights, its states padded with
    zeros, and returns its own width."""
    if not xs.is_cuda:
        return bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    B, T, F = xs.shape
    U = wh.shape[1]
    dt, f32 = xs.dtype, torch.float32
    if not kernel_takes(U, F, dt):
        Up = padded_units(U) or U
        raise ValueError(f"bilstm: the kernels take no layer of U = {U} units on F = {F} "
                         f"features of {dt} (kernel_takes: U <= {KERNEL_UNITS[-1]}, run at the "
                         f"next of {KERNEL_UNITS}, F <= {2 * Up}, an f32 or bf16 stream, on bf16 "
                         f"F <= 16 or a multiple of 8)")
    cuda_lib.check_tensors("bilstm", xs.device, [
        ("xs", xs, dt, (B, T, F)), ("wx", wx, dt, (2, F, 4 * U)), ("wh", wh, dt, (2, U, 4 * U)),
        ("b", b, f32, (2, 4 * U)), ("h0", h0, f32, (2, B, U)), ("c0", c0, f32, (2, B, U)),
    ])
    if dt == torch.bfloat16 and F > 16 and xs.data_ptr() % 16:  # rows copied 16 bytes at a time
        raise ValueError("bilstm_bf16: xs must be 16-byte aligned")
    if layout is None:
        layout = kernel_layout(wx, wh, b)
    Up = padded_units(U)
    if Up != U:  # the compiled width's kernel on the padded layer
        if layout.padded is None or layout.units != U:
            raise ValueError(f"bilstm: the layout was not padded from {U} units")
        out, h, c = bilstm_layer(xs, *layout.padded, pad_units(h0, Up), pad_units(c0, Up),
                                 layout)
        return unpad_outputs(out, U), h[..., :U].contiguous(), c[..., :U].contiguous()
    kx = padded_k(F, dt)
    name = "bilstm" if dt == f32 else "bilstm_bf16"
    if layout.kx != kx:
        raise ValueError(f"{name}: the layout was made for kx {layout.kx}, F = {F} needs {kx}")
    wide = U in WIDE_UNITS
    lay_shape = ((lambda k: (2, k, U, 4)) if dt == f32
                 else (lambda k: (2, U // 8, k // 16, 4, 32, 4)))
    cuda_lib.check_tensors(name, xs.device, [
        ("layout.wx", layout.wx, dt, lay_shape(kx)), ("layout.wh", layout.wh, dt, lay_shape(U)),
    ])
    if layout.wx.data_ptr() % 16 or layout.wh.data_ptr() % 16:  # read 16 bytes at a time
        raise ValueError(f"{name}: the layout's tensors must be 16-byte aligned")
    if wide and dt == f32:
        out, hN, cN, _ = wide_launch(xs, layout, b, h0, c0)
    else:
        out = torch.empty(B, T, 2 * U, device=xs.device, dtype=dt)
        hN = torch.empty(2, B, U, device=xs.device, dtype=f32)
        cN = torch.empty_like(hN)
        entry = ("rv_bilstm_layer" if dt == f32 else "rv_bilstm_layer_bf16") + (
            "_wide" if wide else "")
        cuda_lib.check(launch(getattr(cuda_lib.lib(), entry), xs, layout, b, h0, c0, out, hN,
                              cN), name)
    cuda_lib.launches[name] += 1
    if layout.padded is not None:
        cuda_lib.launches["bilstm_padded"] += 1
    return out, hN, cN
