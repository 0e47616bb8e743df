"""One fused greedy decode step on un-projected memory: the CUDA kernel, its
plain version, and the greedy loop that launches it once per step.

Counterpart of ravvent_tpu/ops/decode_step_pallas.py (the TPU kernel
``_fused_step_kernel``, its entry ``fused_decode_step`` and the loop
``fused_greedy_decode``). The kernel is ``csrc/decode_step.cu``, compiled
for every pair of the decoder units :data:`GREEDY_UNITS` and the memory
widths :data:`GREEDY_MEMORY_DIMS` (``csrc/decode_step_shapes.cuh``);
:func:`fused_decode_step` launches it for CUDA tensors, raises ValueError
naming the shape for a CUDA tensor of another width, and runs
:func:`fused_decode_step_plain`, which takes any width, for CPU tensors
only. :func:`fused_greedy_decode` runs any decoder width up to the widest
compiled one and any memory width up to the widest on the next compiled
ones, zero-padded (ops/decoder_pad.py): the decoder's weights (and a
true-width memory's keys) once a decode, counted as ``decoder_padded``, and
the values' columns with the attention layer's context rows, a copy of the
f32 values a decode (about one step's value bytes over the decode's
steps), counted as ``greedy_memory_padded``.

Per row: LSTM cell on [one-hot token | previous attention vector], Luong
scores of h against the keys [S, U], softmax masked with finfo(f32).min,
context from the raw values [S, E], ``att = [h; context] . W_att``
(W_att [U+E, U]) and logits ``att . W_fc + b_fc`` over the V vocabulary
columns. The reference kernel took a one-hot [B, V] input and padded the
vocabulary to 128 columns with a finfo.min bias, then sliced them away;
here a token id carries the input (an id >= V embeds to zeros) and only the
V columns exist. Everything is f32: the reference casts keys and values to
f32 before the loop.
"""

from __future__ import annotations

import re
from typing import NamedTuple, Optional, Tuple

import torch

from ravvent_tpu_torch.decode.greedy import greedy_loop
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.ops.beam_step_cuda import lstm_cell_plain, widths
from ravvent_tpu_torch.ops import decoder_pad


def _compiled_shapes() -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The decoder units and memory widths the kernel is compiled for, from
    their one list (``csrc/decode_step_shapes.cuh``)."""
    text = (cuda_lib.CSRC / "decode_step_shapes.cuh").read_text()

    def listed(name: str) -> Tuple[int, ...]:
        line = re.search(rf"^#define {name}\(X\) (.*)$", text, re.M).group(1)
        return tuple(int(x) for x in re.findall(r"X\((\d+)\)", line))

    return listed("RV_GREEDY_UNITS"), listed("RV_GREEDY_MEMORY_DIMS")


# the decoder units U and memory widths E (enc_out_dim) the kernel is
# compiled for, every pair of them: (64, 128, 256), (64, 128, 256, 512)
GREEDY_UNITS, GREEDY_MEMORY_DIMS = _compiled_shapes()


class FusedDecodeWeights(NamedTuple):
    """Depth-1 LSTM decoder weights as the fused step consumes them."""

    wx: torch.Tensor  # [V+U, 4U] cell kernel (one-hot rows, then attention rows)
    wh: torch.Tensor  # [U, 4U]
    b: torch.Tensor  # [4U]
    watt: torch.Tensor  # [U+E, U] attention layer over [cell output; context]
    wfc: torch.Tensor  # [U, V]
    bfc: torch.Tensor  # [V]


def pack_decoder_weights(dec_params) -> FusedDecodeWeights:
    if len(dec_params["cells"]) != 1:
        raise ValueError("the fused decode step supports decoder_depth=1")
    cell = dec_params["cells"][0]
    f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
    return FusedDecodeWeights(f32(cell["kernel"]), f32(cell["recurrent"]), f32(cell["bias"]),
                              f32(dec_params["attention_layer"]["kernel"]),
                              f32(dec_params["fc"]["kernel"]), f32(dec_params["fc"]["bias"]))


def fused_decode_step_plain(w: FusedDecodeWeights, tok, att, h, c, keys, values, mask
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of one step. tok [B] int32; att, h, c [B, U];
    keys [B, S, U], values [B, S, E] f32; mask [B, S] bool. Returns
    (h', c', attention vector, logits [B, V])."""
    h_new, c_new = lstm_cell_plain(tok, att, h, c, w.wx, w.wh, w.b)
    context, _ = attn.attend_beams(None, "luong", h_new[:, None],
                                   attn.AttnMemory(keys, values, mask))
    att_new = torch.cat([h_new, context[:, 0]], dim=1) @ w.watt
    return h_new, c_new, att_new, att_new @ w.wfc + w.bfc


def fused_decode_step(w: FusedDecodeWeights, tok, att, h, c, keys, values, mask
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One greedy step: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if not keys.is_cuda:
        return fused_decode_step_plain(w, tok, att, h, c, keys, values, mask)
    B, S, U = keys.shape
    E = values.shape[2]
    V = w.wfc.shape[1]
    if U not in GREEDY_UNITS or E not in GREEDY_MEMORY_DIMS:
        raise ValueError(f"decode_step kernel is compiled for {widths(GREEDY_UNITS)} units and "
                         f"memory widths {widths(GREEDY_MEMORY_DIMS)}; got U = {U}, E = {E}")
    f32 = torch.float32
    expect = [
        ("tok", tok, torch.int32, (B,)), ("att", att, f32, (B, U)), ("h", h, f32, (B, U)),
        ("c", c, f32, (B, U)), ("keys", keys, f32, (B, S, U)), ("values", values, f32, (B, S, E)),
        ("mask", mask, torch.bool, (B, S)), ("wx", w.wx, f32, (V + U, 4 * U)),
        ("wh", w.wh, f32, (U, 4 * U)), ("b", w.b, f32, (4 * U,)), ("watt", w.watt, f32, (U + E, U)),
        ("wfc", w.wfc, f32, (U, V)), ("bfc", w.bfc, f32, (V,)),
    ]
    cuda_lib.check_tensors("decode_step", keys.device, expect)
    if keys.data_ptr() % 16 or values.data_ptr() % 16:
        raise ValueError("decode_step: keys and values must be 16-byte aligned")
    h_out, c_out, att_out = torch.empty_like(h), torch.empty_like(c), torch.empty_like(att)
    logits = torch.empty(B, V, dtype=f32, device=keys.device)
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    rc = cuda_lib.lib().rv_decode_step(
        U, E, B, S, V, tok.data_ptr(), att.data_ptr(), h.data_ptr(), c.data_ptr(), keys.data_ptr(),
        values.data_ptr(), mask.data_ptr(), w.wx.data_ptr(), w.wh.data_ptr(), w.b.data_ptr(),
        w.watt.data_ptr(), w.wfc.data_ptr(), w.bfc.data_ptr(), h_out.data_ptr(),
        c_out.data_ptr(), att_out.data_ptr(), logits.data_ptr(), stream,
    )
    cuda_lib.check(rc, "decode_step")
    cuda_lib.launches["decode_step"] += 1
    return h_out, c_out, att_out, logits


def fused_greedy_decode(dec_params, mem: attn.AttnMemory, vocab_size: int, total_steps: int,
                        max_steps: Optional[int] = None, start_token: int = 2,
                        end_token: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode with one fused step per iteration, the semantics of
    decode/greedy.py:greedy_decode. Requires un-projected memory and a
    depth-1 LSTM decoder with Luong attention; keys and values are cast to
    f32. On the card a decoder or memory width the kernel is not compiled
    for, up to the widest, runs the next compiled one, zero-padded (the
    module's docstring); a wider one raises ValueError. Returns (tokens
    [B, total_steps] int32, logits [B, total_steps, V])."""
    if mem.projected:
        raise ValueError("fused_greedy_decode takes un-projected memory "
                         "(setup_memory without attention_layer)")
    U, E = mem.keys.shape[2], mem.values.shape[2]
    Ep = E
    if decoder_pad.on_card(mem.keys):
        Up = decoder_pad.padded_width(U, GREEDY_UNITS, "the greedy step's decoder width")
        Ep = decoder_pad.padded_width(E, GREEDY_MEMORY_DIMS, "the greedy step's memory width")
        if Up != U:
            dec_params = decoder_pad.pad_decoder_params(dec_params, Up)
            mem = decoder_pad.pad_memory_units(mem, Up)
            cuda_lib.launches["decoder_padded"] += 1
    w = pack_decoder_weights(dec_params)
    if w.wfc.shape[1] != vocab_size:
        raise ValueError(f"vocab_size {vocab_size} != the decoder's {w.wfc.shape[1]}")
    B = mem.mask.shape[0]
    U = w.wh.shape[0]
    dev = mem.keys.device
    keys = mem.keys.to(torch.float32).contiguous()
    values = mem.values.to(torch.float32).contiguous()
    if Ep != E:
        values, watt = decoder_pad.pad_values(values, w.watt, Ep)
        w = w._replace(watt=watt.contiguous())
        cuda_lib.launches["greedy_memory_padded"] += 1
    mask = mem.mask.contiguous()
    h = torch.zeros(B, U, device=dev)
    c = torch.zeros(B, U, device=dev)
    att = torch.zeros(B, U, device=dev)

    def step(cur: torch.Tensor) -> torch.Tensor:
        nonlocal h, c, att
        h, c, att, logits = fused_decode_step(w, cur, att, h, c, keys, values, mask)
        return logits

    return greedy_loop(step, B, vocab_size, total_steps, max_steps, start_token, end_token, dev)
