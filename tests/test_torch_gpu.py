"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc; without a card each one skips with
its reason. Run them on the machine with the card:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
lacks; this file needs neither.)
"""

import functools

import numpy as np
import pytest
import torch

from ravvent_tpu_torch.decode.greedy import greedy_decode
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.decoder import init_decoder
from ravvent_tpu_torch.models.rnn import init_encoder, stacked_weights, stream_weights
from ravvent_tpu_torch.ops import (
    beam_loop_cuda, beam_step_cuda, cuda_lib, decode_step_cuda, event_detect, peak_scan_cuda,
    rnn_cuda,
)
from ravvent_tpu_torch.weights import to_device
from cuda_emu_cases import peak_scan_inputs, synth

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


# (U, F, T, seeded) of the BiLSTM kernels' card tests: each compiled width
# (ops/rnn_cuda.py:KERNEL_UNITS) on raw (1), event (5) and a stacked layer's
# input (2U), then two widths the wrapper pads to a compiled one (48 to 64,
# 200 to 256); the flagship's 128 units keep their ids
LAYERS = [(128, 1, 200, False), (128, 5, 30, False), (128, 256, 40, True),
          (64, 1, 200, False), (64, 5, 30, False), (64, 128, 40, True),
          (256, 1, 200, False), (256, 5, 30, False), (256, 512, 40, True),
          (32, 1, 200, False), (32, 5, 30, False), (32, 64, 40, True),
          (96, 1, 200, False), (96, 5, 30, False), (96, 192, 40, True),
          (192, 1, 200, False), (192, 5, 30, False), (192, 384, 40, True),
          (48, 5, 30, False), (48, 96, 40, True), (200, 1, 200, False), (200, 400, 40, True)]
LAYER_IDS = [("" if U == 128 else f"U{U}-") + f"{F}-{T}-{seeded}" for U, F, T, seeded in LAYERS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("B", [37, 130, 2858], ids=["one ragged tile", "ragged tiles", "2858 rows"])
@pytest.mark.parametrize("U,F,T,seeded", LAYERS, ids=LAYER_IDS)
def test_bilstm_kernel_matches_plain(cuda, U, F, T, seeded, B):
    """The f32 stream within 1e-4 (chip_smoke.py phase 2's bar). At 32 to
    128 units 37, 130 and 2858 rows run 3, 9 and 60 tiles of 16, 16 and 48
    rows; at 192 and 256, 3 and 9 of 16 and 90 of 32; the last one ragged.
    A padded width runs its compiled one's kernel, counted under
    ``bilstm_padded``, and returns its own. The weights laid out once
    (kernel_layout, as the engine does) give the same result as the layout
    the wrapper makes."""
    gen = torch.Generator().manual_seed(F)
    wx, wh, b = stacked_weights(init_encoder(gen, U, 1, F, cuda)[0])
    xs = torch.randn(B, T, F, generator=gen).to(cuda)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)).to(cuda) if seeded
              else torch.zeros(2, B, U, device=cuda) for _ in range(2))
    before = dict(cuda_lib.launches)
    got = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0)
    assert cuda_lib.launches["bilstm"] == before["bilstm"] + 1
    padded = U not in rnn_cuda.KERNEL_UNITS
    assert cuda_lib.launches["bilstm_padded"] == before["bilstm_padded"] + padded
    assert got[0].shape == (B, T, 2 * U) and got[1].shape == got[2].shape == (2, B, U)
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    again = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0, rnn_cuda.kernel_layout(wx, wh, b))
    for g, r in zip(again, got):
        assert torch.equal(g, r)


def test_bilstm_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """F past 256, and a layout made for another F, raise before any launch."""
    B, T, U = 2, 3, 128
    z = torch.zeros(2, B, U, device=cuda)
    b = torch.zeros(2, 4 * U, device=cuda)
    wh = torch.zeros(2, U, 4 * U, device=cuda)

    def wx(F):
        return torch.zeros(2, F, 4 * U, device=cuda)

    def xs(F):
        return torch.zeros(B, T, F, device=cuda)

    before = cuda_lib.launches["bilstm"]
    with pytest.raises(ValueError, match="F <= 256"):
        rnn_cuda.bilstm_layer(xs(264), wx(264), wh, b, z, z)
    with pytest.raises(ValueError, match="layout"):
        rnn_cuda.bilstm_layer(xs(5), wx(5), wh, b, z, z, rnn_cuda.kernel_layout(wx(1), wh))
    assert cuda_lib.launches["bilstm"] == before


@pytest.mark.parametrize("U", [16, 520])
def test_encoder_of_another_width_runs_its_plain_layers_on_the_card(cuda, U):
    """A 16-unit BiLSTM encoder, an uncompiled width: encode_input on the
    card runs its 4 layers on the f32 kernel at 32 units, padded (bilstm and
    bilstm_padded 4, no plain route); a 520-unit one, past the widest
    compiled width (512), on the plain route (bilstm_plain_route 4, no
    kernel). Either equals the CPU's within 1e-5 relative."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.models.basecaller import encode_input, init_basecaller

    cfg = ModelConfig(enc_units=U)
    params = init_basecaller(cfg, torch.Generator().manual_seed(16))
    gen = torch.Generator().manual_seed(17)
    raw, event = torch.randn(64, 200, 1, generator=gen), torch.randn(64, 30, 5, generator=gen)
    ref, ref_mask = encode_input(params, raw, event, cfg)
    before = dict(cuda_lib.launches)
    got, mask = encode_input(to_device(params, cuda), raw.to(cuda), event.to(cuda), cfg)
    torch.cuda.synchronize()
    delta = {k: v - before[k] for k, v in cuda_lib.launches.items() if v != before[k]}
    assert delta == ({"bilstm": 4, "bilstm_padded": 4} if U == 16 else {"bilstm_plain_route": 4})
    assert got.shape == ref.shape and torch.equal(mask.cpu(), ref_mask)
    scale = ref.abs().max().item()
    assert (got.cpu() - ref).abs().max().item() <= 1e-5 * scale


# (U, F, T, seeded) of the wide kernels' card tests (csrc/bilstm_wide.cu,
# csrc/bilstm_bf16_wide.cu): each compiled width past 256 units
# (ops/rnn_cuda.py:WIDE_UNITS) on raw (1), event (5) or a stacked layer's
# input (2U), and 300 units, which the wrapper pads to 320; the last, a
# stacked 448-unit layer over 200 steps, crosses the projection's windows at
# 4096 rows (18 steps a window: eleven, then one of 2)
WIDE_LAYERS = [(320, 1, 200, False), (320, 640, 40, True), (384, 5, 30, False),
               (384, 768, 40, True), (448, 1, 200, True), (448, 896, 30, False),
               (512, 5, 30, True), (512, 1024, 40, False), (300, 1, 200, False),
               (300, 600, 40, True), (448, 896, 200, True)]


@pytest.mark.parametrize("B", [37, 130, 4096], ids=["one ragged tile", "ragged tiles", "4096 rows"])
@pytest.mark.parametrize("U,F,T,seeded", WIDE_LAYERS,
                         ids=[f"U{U}-{F}-{T}-{seeded}" for U, F, T, seeded in WIDE_LAYERS])
@pytest.mark.parametrize("stream", ["f32", "bf16"])
def test_bilstm_wide_kernel_matches_plain(cuda, stream, U, F, T, seeded, B):
    """Past 256 units, each stream against its plain version at phase 2's /
    phase 9's bars (f32 1e-4; bf16 outputs two bf16 ulps, f32 final states
    1e-3), on the card's plan (ops/rnn_cuda.py:wide_plan: clusters of R
    rows, the last tile ragged; on F = 2U the projection a window of steps
    at a time). One launch counted under the stream's kernel (and
    ``bilstm_padded`` at 300 units), whatever the inner kernels, and the
    layout made once gives the same bits."""
    dtype = torch.float32 if stream == "f32" else torch.bfloat16
    kernel = "bilstm" if stream == "f32" else "bilstm_bf16"
    gen = torch.Generator().manual_seed(U + F)
    wx, wh, b = stream_weights([init_encoder(gen, U, 1, F, cuda)[0]], dtype)[0]
    xs = torch.randn(B, T, F, generator=gen).to(cuda, dtype)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)).to(cuda) if seeded
              else torch.zeros(2, B, U, device=cuda) for _ in range(2))
    before = dict(cuda_lib.launches)
    out, h, c = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0)
    assert cuda_lib.launches[kernel] == before[kernel] + 1
    padded = U not in rnn_cuda.KERNEL_UNITS
    assert cuda_lib.launches["bilstm_padded"] == before["bilstm_padded"] + padded
    assert out.dtype == dtype and h.dtype == c.dtype == torch.float32
    assert out.shape == (B, T, 2 * U) and h.shape == c.shape == (2, B, U)
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    if stream == "f32":
        for g, r in zip((out, h, c), ref):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
    else:
        assert (out.float() - ref[0].float()).abs().max().item() <= 1e-2
        for g, r in zip((h, c), ref[1:]):
            assert (g - r).abs().max().item() <= 1e-3
    again = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0, rnn_cuda.kernel_layout(wx, wh, b))
    for g, r in zip(again, (out, h, c)):
        assert torch.equal(g, r)


@pytest.mark.parametrize("B", [37, 130, 2858], ids=["one ragged tile", "three tiles", "2858 rows"])
@pytest.mark.parametrize("U,F,T,seeded", LAYERS, ids=LAYER_IDS)
def test_bilstm_bf16_kernel_matches_plain(cuda, U, F, T, seeded, B):
    """The bf16 stream: outputs within two bf16 ulps, f32 final states 1e-3
    (chip_smoke.py phase 9's bars). At 32 to 128 units 37, 130 and 2858
    rows run 3, 9 and 60 tiles of 16, 16 and 48 rows (the ids name the
    64-row tiles of an earlier design); at 192 and 256, 3, 9 and 179 tiles
    of 16; the last one ragged. At 192 and 256 units Wh streams from L2. A
    padded width runs its compiled one's kernel, counted under
    ``bilstm_padded``. The weights laid out once (kernel_layout, as the
    engine passes them) give the same bits."""
    gen = torch.Generator().manual_seed(100 + F)
    wx, wh, b = stream_weights([init_encoder(gen, U, 1, F, cuda)[0]], torch.bfloat16)[0]
    xs = torch.randn(B, T, F, generator=gen).to(cuda, torch.bfloat16)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)).to(cuda) if seeded
              else torch.zeros(2, B, U, device=cuda) for _ in range(2))
    before = dict(cuda_lib.launches)
    out, h, c = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0)
    assert cuda_lib.launches["bilstm_bf16"] == before["bilstm_bf16"] + 1
    padded = U not in rnn_cuda.KERNEL_UNITS
    assert cuda_lib.launches["bilstm_padded"] == before["bilstm_padded"] + padded
    assert out.dtype == torch.bfloat16 and h.dtype == c.dtype == torch.float32
    assert out.shape == (B, T, 2 * U) and h.shape == c.shape == (2, B, U)
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    assert (out.float() - ref[0].float()).abs().max().item() <= 1e-2
    for g, r in zip((h, c), ref[1:]):
        assert (g - r).abs().max().item() <= 1e-3
    again = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0, rnn_cuda.kernel_layout(wx, wh, b))
    for g, r in zip(again, (out, h, c)):
        assert torch.equal(g, r)


def test_bilstm_bf16_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    """F past 16 that is not a multiple of 8, and a layout made for another F,
    raise before any launch."""
    B, T, U = 2, 3, 128
    z = torch.zeros(2, B, U, device=cuda)
    b = torch.zeros(2, 4 * U, device=cuda)
    wh = torch.zeros(2, U, 4 * U, device=cuda, dtype=torch.bfloat16)

    def wx(F):
        return torch.zeros(2, F, 4 * U, device=cuda, dtype=torch.bfloat16)

    def xs(F):
        return torch.zeros(B, T, F, device=cuda, dtype=torch.bfloat16)

    before = cuda_lib.launches["bilstm_bf16"]
    with pytest.raises(ValueError, match="multiple of 8"):
        rnn_cuda.bilstm_layer(xs(20), wx(20), wh, b, z, z)
    with pytest.raises(ValueError, match="layout"):
        rnn_cuda.bilstm_layer(xs(5), wx(5), wh, b, z, z, rnn_cuda.kernel_layout(wx(256), wh))
    assert cuda_lib.launches["bilstm_bf16"] == before


def test_bilstm_bf16_wrapper_rejects_mixed_dtypes(cuda):
    B, T, F, U = 2, 3, 5, 128
    xs = torch.zeros(B, T, F, device=cuda, dtype=torch.bfloat16)
    z = torch.zeros(2, B, U, device=cuda)
    with pytest.raises(ValueError, match="wx"):  # f32 weights on a bf16 stream
        rnn_cuda.bilstm_layer(xs, torch.zeros(2, F, 4 * U, device=cuda),
                              torch.zeros(2, U, 4 * U, device=cuda),
                              torch.zeros(2, 4 * U, device=cuda), z, z)
    with pytest.raises(ValueError, match="stream"):
        rnn_cuda.bilstm_layer(xs.half(), torch.zeros(2, F, 4 * U, device=cuda).half(),
                              torch.zeros(2, U, 4 * U, device=cuda).half(),
                              torch.zeros(2, 4 * U, device=cuda), z, z)


@pytest.mark.parametrize("mem_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("W", [1, 5])
def test_beam_step_kernel_matches_plain(cuda, mem_dtype, W):
    gen = torch.Generator().manual_seed(W)
    B, S, U = 9, 232, 128
    dec_p = init_decoder(gen, 7, 1, U, 256, cuda)
    memory = torch.tanh(torch.randn(B, S, 256, generator=gen)).to(cuda)
    mask = (torch.rand(B, S, generator=gen) > 0.2).to(cuda)
    mask[3] = False  # all padding: uniform alignments
    mem = attn.setup_memory(dec_p["attention"], memory, mask, mem_dtype,
                            attention_layer=dec_p["attention_layer"])
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = beam_step_cuda.initial_state(B, W, U, 2, cuda)
    agree = n = 0
    for _ in range(12):
        got, gpar = beam_step_cuda.beam_step(st, mem.keys, mem.values, mask, w, 1)
        ref, rpar = beam_step_cuda.beam_step_plain(st, mem.keys, mem.values, mask, w, 1)
        same = (got.tok.reshape(B, W) == ref.tok.reshape(B, W)) & (gpar == rpar)
        agree += same.sum().item()
        n += B * W
        torch.testing.assert_close(got.cum[same], ref.cum[same], rtol=0, atol=1e-2)
        st = ref
    assert agree / n >= 0.99


def test_beam_step_decode_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(0)
    B, S, U = 16, 56, 128
    dec_p = init_decoder(gen, 7, 1, U, 256)
    memory = torch.tanh(torch.randn(B, S, 256, generator=gen))
    mask = torch.rand(B, S, generator=gen) > 0.1
    mem = attn.setup_memory(dec_p["attention"], memory, mask, None,
                            attention_layer=dec_p["attention_layer"])
    cpu = beam_step_cuda.beam_step_decode(dec_p, mem, 7, 5, 47, 20)
    mem_c = mem.to(cuda)
    dec_c = {k: v for k, v in dec_p.items()}
    dec_c["cells"] = [{k: v.to(cuda) for k, v in dec_p["cells"][0].items()}]
    dec_c["fc"] = {k: v.to(cuda) for k, v in dec_p["fc"].items()}
    card = beam_step_cuda.beam_step_decode(dec_c, mem_c, 7, 5, 47, 20)
    assert (card.tokens.cpu() == cpu.tokens).float().mean().item() >= 0.99


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    """The BiLSTM wrapper raises for a width past the widest the kernels
    are compiled for (520 units; they pad any width up to 512), naming the
    shape."""
    B, T, F, U = 2, 3, 4, 520
    xs = torch.zeros(B, T, F, device=cuda)
    with pytest.raises(ValueError, match="U = 520 units on F = 4 features"):
        rnn_cuda.bilstm_layer(xs, torch.zeros(2, F, 4 * U, device=cuda),
                              torch.zeros(2, U, 4 * U, device=cuda),
                              torch.zeros(2, 4 * U, device=cuda),
                              torch.zeros(2, B, U, device=cuda), torch.zeros(2, B, U, device=cuda))


def _decoder_and_memory(seed, B, S, mem_dtype, projected, device, U=128, E=256):
    gen = torch.Generator().manual_seed(seed)
    dec_p = init_decoder(gen, 7, 1, U, E, device)
    memory = torch.tanh(torch.randn(B, S, E, generator=gen)).to(device)
    mask = (torch.rand(B, S, generator=gen) > 0.2).to(device)
    mask[3] = False  # all padding: uniform alignments
    mem = attn.setup_memory(dec_p["attention"], memory, mask, mem_dtype,
                            attention_layer=dec_p["attention_layer"] if projected else None)
    return dec_p, mem


# (B, W, memory dtype[, U, layout]) of the whole-loop kernel's card test:
# the resident layout's cases at 128 units keep their ids; then the streamed
# layout at the other decoder widths, at W = 6, 10 and 16, asked for at the
# flagship's shape, and its instance of 32 beams at W = 17 and 32 on f32 (at
# 256 units its scores and candidates in the gates' dead columns; on bf16
# in test_beam_loop_wide_bf16_kernel_matches_plain)
LOOP_DTYPES = (torch.bfloat16, torch.float32)
LOOP_CASES = ([(B, W, d) for B, W in ((9, 1), (9, 5), (130, 1), (130, 5), (130, 8))
               for d in LOOP_DTYPES]
              + [(130, W, d, U, layout) for U, W, layout in (
                  (64, 5, "auto"), (256, 5, "auto"), (128, 6, "auto"), (128, 10, "auto"),
                  (128, 16, "auto"), (64, 16, "auto"), (256, 16, "auto"), (128, 5, "streamed"))
                 for d in LOOP_DTYPES]
              + [(130, W, torch.float32, U, "auto") for U, W in ((128, 17), (128, 32), (256, 32))])
LOOP_IDS = [f"{c[0]}-{c[1]}-mem_dtype{LOOP_DTYPES.index(c[2])}" if len(c) == 3 else
            f"U{c[3]}-W{c[1]}-{c[4]}-{'bf16' if c[2] == torch.bfloat16 else 'f32'}"
            for c in LOOP_CASES]


@pytest.mark.parametrize("case", LOOP_CASES, ids=LOOP_IDS)
def test_beam_loop_kernel_matches_plain(cuda, case):
    """9 and 130 rows are not whole clusters of 8: the rows past B run and
    write nothing. At W = 8 step 1 has fewer finite candidates (V = 7) than
    beams: the eighth pick is a repeat at finfo.min, as in the reference.
    W = 8 runs at 130 rows: with 56 contested candidates a step one row in
    9 can part from the plain loop at a near-tie, and at 9 rows one row is
    1/9 of the prefix share; the replay holds every step either way. The
    other widths run the streamed layout (beam_loop_cuda.plan says which),
    at the replay's bars; their free-running prefix is held on f32 memory.
    On bf16 memory (as chip_smoke.py phase 5 holds its no-beam-ending run)
    it is not: at W = 16 and 256 units a row has ~8x the contested
    candidates of the W = 8 case above, and rounding parts 8.5% of the
    (step, row) pairs at a near-tie (measured on an H100)."""
    B, W, mem_dtype, U, layout = case + (128, "auto")[len(case) - 3:]
    S, T, eff = 232, 14, 12
    dec_p, mem = _decoder_and_memory(W, B, S, mem_dtype, True, cuda, U=U)
    resident = U == 128 and W in (1, 2, 3, 4, 5, 8) and layout == "auto"
    chosen = beam_loop_cuda.plan(mem_dtype, U, W, S, 7, layout)
    assert chosen.layout == ("resident" if resident else "streamed") and chosen.active > 0
    # as drawn, most beams end within a few steps; with the end token's logit
    # pushed down every live step runs the whole cell and attention
    live_p = dict(dec_p, fc=dict(dec_p["fc"], bias=dec_p["fc"]["bias"].clone()))
    live_p["fc"]["bias"][1] -= 20.0
    for dec in (dec_p, live_p):
        w = beam_step_cuda.pack_decoder_weights(dec, mem)
        before = cuda_lib.launches["beam_loop"]
        tok, par, sc = beam_loop_cuda.beam_loop(mem.keys, mem.values, mem.mask, w, W, T, eff,
                                                2, 1, layout=layout)
        assert cuda_lib.launches["beam_loop"] == before + 1
        rtok, rpar, rsc = beam_loop_cuda.beam_loop_plain(mem.keys, mem.values, mem.mask, w, W,
                                                         T, eff, 2, 1)
        assert not tok[eff:].any() and not par[eff:].any() and not sc[eff:].any()
        # every live step, replayed through the plain step on the kernel's picks
        rep = beam_loop_cuda.replay_plain(tok, par, sc, mem.keys, mem.values, mem.mask, w, eff,
                                          2, 1)
        assert rep.distinct and rep.exact >= 0.99
        assert rep.rank_err <= 1e-2 and rep.score_err <= 1e-2
        # free-running: a row's trajectories agree up to its first flipped
        # near-tie; scores are compared over each row's agreeing prefix
        same = ((tok == rtok) & (par == rpar)).all(dim=2)  # [T, B]
        prefix = torch.cumprod(same.int(), dim=0).bool()
        if len(case) == 3 or mem_dtype == torch.float32:
            assert prefix[:eff].float().mean().item() >= 0.95
        torch.testing.assert_close(sc[prefix], rsc[prefix], rtol=0, atol=1e-2)


@pytest.mark.parametrize("U,W", [(128, 17), (128, 32), (256, 32)],
                         ids=["U128-W17", "U128-W32", "U256-W32"])
def test_beam_loop_wide_bf16_kernel_matches_plain(cuda, U, W):
    """The streamed layout's instance of 32 beams on bf16 memory, 130 rows,
    the end token pushed down: every live step replayed through the plain
    step (replay_plain), picks distinct, rank and score errors within 1e-2,
    as test_beam_loop_kernel_matches_plain holds the narrower widths. Its
    share of picks equal to the plain top-W measures how dense the near ties
    are past 16 beams (an h' a few f32 ulps off rounds to another bf16
    query): the plain loop itself, run on the CPU on the same inputs and
    replayed on the card, does not reach 0.99 there (0.99125 at 128 units,
    W = 32, 0.98627 at 256; 4096 rows on an H100). So the kernel's share is
    held to that of the plain loop on the CPU, less 0.01."""
    B, S, T, eff = 130, 232, 14, 12
    dec_p, mem = _decoder_and_memory(W, B, S, torch.bfloat16, True, cuda, U=U)
    assert beam_loop_cuda.plan(torch.bfloat16, U, W, S, 7).layout == "streamed"
    dec_p["fc"]["bias"][1] -= 20.0
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    got = beam_loop_cuda.beam_loop(mem.keys, mem.values, mem.mask, w, W, T, eff, 2, 1)
    assert not any(x[eff:].any() for x in got)
    rep = beam_loop_cuda.replay_plain(*got, mem.keys, mem.values, mem.mask, w, eff, 2, 1)
    cpu = beam_loop_cuda.beam_loop_plain(*(t.cpu() for t in (mem.keys, mem.values, mem.mask)),
                                         beam_step_cuda.DecoderWeights(*(t.cpu() for t in w)), W,
                                         T, eff, 2, 1)
    ref = beam_loop_cuda.replay_plain(*(x.to(cuda) for x in cpu), mem.keys, mem.values, mem.mask,
                                      w, eff, 2, 1)
    assert rep.distinct and rep.exact >= ref.exact - 0.01
    assert rep.rank_err <= 1e-2 and rep.score_err <= 1e-2


def test_beam_loop_decode_on_card_matches_cpu(cuda):
    B, S = 16, 56
    dec_p, mem = _decoder_and_memory(0, B, S, None, True, "cpu")
    cpu = beam_loop_cuda.beam_loop_decode(dec_p, mem, 7, 5, 47, 20)
    mem_c = mem.to(cuda)
    card = beam_loop_cuda.beam_loop_decode(to_device(dec_p, cuda), mem_c, 7, 5, 47, 20)
    assert (card.tokens.cpu() == cpu.tokens).float().mean().item() >= 0.99


def test_decode_step_kernel_matches_plain(cuda, U=128, E=256):
    B, S = 37, 232  # a ragged last tile
    dec_p, mem = _decoder_and_memory(7, B, S, None, False, cuda, U=U, E=E)
    w = decode_step_cuda.pack_decoder_weights(dec_p)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, 9, (B,), generator=gen, dtype=torch.int32).to(cuda)  # ids >= 7 too
    att, h, c = ((0.5 * torch.randn(B, U, generator=gen)).to(cuda) for _ in range(3))
    keys, values = mem.keys.contiguous(), mem.values.contiguous()
    for _ in range(5):  # chained, each step fed the plain version's state
        before = cuda_lib.launches["decode_step"]
        got = decode_step_cuda.fused_decode_step(w, tok, att, h, c, keys, values, mem.mask)
        assert cuda_lib.launches["decode_step"] == before + 1
        ref = decode_step_cuda.fused_decode_step_plain(w, tok, att, h, c, keys, values, mem.mask)
        for g, r in zip(got, ref):
            torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)
        h, c, att, logits = ref
        tok = torch.argmax(logits, dim=-1).to(torch.int32)


# (U, E) the greedy step also takes: each decoder width at the smallest and
# the largest memory width
STEP_WIDTHS = [(64, 64), (64, 512), (128, 64), (128, 512), (256, 64), (256, 512)]


@pytest.mark.parametrize("U,E", STEP_WIDTHS, ids=[f"U{u}-E{e}" for u, e in STEP_WIDTHS])
def test_decode_step_kernel_at_other_widths_matches_plain(cuda, U, E):
    test_decode_step_kernel_matches_plain(cuda, U, E)


def test_fused_greedy_decode_on_card_matches_cpu(cuda):
    B, S = 24, 64
    dec_p, mem = _decoder_and_memory(3, B, S, None, False, "cpu")
    cpu_tok, _ = greedy_decode(dec_p, mem, 7, 47, 39)
    mem_c = attn.AttnMemory(*(t.to(cuda) for t in mem[:3]))
    card_tok, card_logits = decode_step_cuda.fused_greedy_decode(to_device(dec_p, cuda), mem_c,
                                                                 7, 47, 39)
    assert torch.isfinite(card_logits).all()
    assert (card_tok.cpu() == cpu_tok).float().mean().item() >= 0.99


@pytest.mark.parametrize("U,W,mem_dtype", [(96, 5, torch.bfloat16), (200, 17, torch.float32)],
                         ids=["U96-W5-bf16", "U200-W17-f32"])
@pytest.mark.parametrize("impl", ["step", "loop"])
def test_beam_decode_of_another_decoder_width_runs_the_padded_kernels(cuda, impl, U, W,
                                                                      mem_dtype):
    """A decoder width between the compiled ones on the card: the decode pads
    the weights and the memory to the next compiled width once
    (decoder_padded), and the beam step's kernels once a step, or the loop
    kernel once, run there; against the plain decode at the true width on
    the CPU, tokens >= 0.99 (bf16: near ties)."""
    B, S = 24, 64
    dec_p, mem = _decoder_and_memory(U, B, S, mem_dtype, True, "cpu", U=U)
    decode = beam_step_cuda.beam_step_decode if impl == "step" else beam_loop_cuda.beam_loop_decode
    cpu = decode(dec_p, mem, 7, W, 47, 20)
    before = dict(cuda_lib.launches)
    card = decode(to_device(dec_p, cuda), mem.to(cuda), 7, W, 47, 20)
    assert cuda_lib.launches["decoder_padded"] == before["decoder_padded"] + 1
    if impl == "step":
        assert cuda_lib.launches["beam_step"] - before["beam_step"] == 20
    else:
        assert cuda_lib.launches["beam_loop"] == before["beam_loop"] + 1
    assert torch.isfinite(card.scores).all()
    assert (card.tokens.cpu() == cpu.tokens).float().mean().item() >= 0.99


@pytest.mark.parametrize("U,E", [(96, 192), (128, 384), (200, 64)],
                         ids=["U96-E192", "U128-E384", "U200-E64"])
def test_fused_greedy_decode_of_other_widths_runs_the_padded_kernel(cuda, U, E):
    """Fused greedy decode at a decoder or memory width between the compiled
    ones: the weights and keys padded to the next compiled units once
    (decoder_padded), the values' columns to the next memory width once
    (greedy_memory_padded), the kernel once a step; against plain
    greedy_decode on the CPU at the true widths, tokens >= 0.99."""
    B, S = 24, 64
    dec_p, mem = _decoder_and_memory(E, B, S, None, False, "cpu", U=U, E=E)
    cpu_tok, _ = greedy_decode(dec_p, mem, 7, 47, 39)
    before = dict(cuda_lib.launches)
    card_tok, card_logits = decode_step_cuda.fused_greedy_decode(to_device(dec_p, cuda),
                                                                 mem.to(cuda), 7, 47, 39)
    assert cuda_lib.launches["decoder_padded"] == before["decoder_padded"] + (U == 96 or U == 200)
    assert cuda_lib.launches["greedy_memory_padded"] == before["greedy_memory_padded"] + (E != 64)
    assert cuda_lib.launches["decode_step"] > before["decode_step"]
    assert torch.isfinite(card_logits).all()
    assert (card_tok.cpu() == cpu_tok).float().mean().item() >= 0.99


def test_loop_and_decode_step_wrappers_reject_what_the_kernels_do_not_take(cuda):
    dec_p, mem = _decoder_and_memory(0, 4, 16, torch.bfloat16, True, cuda)
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    for W in (0, 33):  # the step's kernels and the loop's take 1-32
        with pytest.raises(ValueError, match=f"beam widths 1-32, got W = {W}"):
            beam_loop_cuda.beam_loop(mem.keys, mem.values, mem.mask, w, W, 5, 5, 2, 1)
    with pytest.raises(ValueError, match="no resident layout .* W = 6"):
        beam_loop_cuda.beam_loop(mem.keys, mem.values, mem.mask, w, 6, 5, 5, 2, 1,
                                 layout="resident")
    dec_w, mem_w = _decoder_and_memory(0, 4, 16, torch.bfloat16, True, cuda, U=96)
    with pytest.raises(ValueError, match="compiled for 64, 128, 256 units, got U = 96"):
        beam_loop_cuda.beam_loop(mem_w.keys, mem_w.values, mem_w.mask,
                                 beam_step_cuda.pack_decoder_weights(dec_w, mem_w), 5, 5, 5, 2, 1)
    with pytest.raises(ValueError, match="both be bf16 or both f32"):
        beam_loop_cuda.beam_loop(mem.keys, mem.values.float(), mem.mask, w, 5, 5, 5, 2, 1)
    with pytest.raises(ValueError, match="no layout .* S = 40000"):
        big = torch.zeros(1, 40000, 128, dtype=torch.bfloat16, device=cuda)
        beam_loop_cuda.beam_loop(big, big, torch.ones(1, 40000, dtype=torch.bool, device=cuda),
                                 w, 5, 5, 5, 2, 1)
    dec_f, mem_f = _decoder_and_memory(0, 4, 16, None, False, cuda)
    wf = decode_step_cuda.pack_decoder_weights(dec_f)
    z = torch.zeros(4, 128, device=cuda)
    tok = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="got U = 128, E = 96"):
        decode_step_cuda.fused_decode_step(wf, tok, z, z, z, mem_f.keys, mem_f.values[..., :96],
                                           mem_f.mask)
    with pytest.raises(ValueError, match="keys must be a contiguous"):
        decode_step_cuda.fused_decode_step(wf, tok, z, z, z, mem_f.keys.bfloat16(),
                                           mem_f.values, mem_f.mask)
    with pytest.raises(ValueError, match="tok must be a contiguous"):
        decode_step_cuda.fused_decode_step(wf, tok.long(), z, z, z, mem_f.keys, mem_f.values,
                                           mem_f.mask)



@pytest.mark.parametrize("mxu", [False, True], ids=["quant", "quant_mxu"])
@pytest.mark.parametrize("B", [37, 130], ids=["one ragged tile", "33 tiles"])
def test_beam_step_int8_kernels_match_plain(cuda, B, mxu):
    """Both int8 variants against their plain versions over 5 chained steps,
    each fed the plain version's state (chip_smoke.py phase 11's bars)."""
    dec_p, mem = _decoder_and_memory(11, B, 232, "i8", True, cuda)
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    scales = (mem.kscale, mem.vscale)
    step, attend = ("beam_step_i8mxu", "beam_attend_i8mxu") if mxu else ("beam_step_i8",
                                                                         "beam_attend_i8")
    st = beam_step_cuda.initial_state(B, 5, 128, 2, cuda)
    agree = n = 0
    for _ in range(5):
        before = dict(cuda_lib.launches)
        got, gpar = beam_step_cuda.beam_step(st, mem.keys, mem.values, mem.mask, w, 1, scales, mxu)
        for name in (step, attend, "beam_cell"):  # a step: beam_cell, then the int8 attend
            assert cuda_lib.launches[name] == before[name] + 1
        for name in ("beam_step", "beam_attend"):
            assert cuda_lib.launches[name] == before[name]
        ref, rpar = beam_step_cuda.beam_step_plain(st, mem.keys, mem.values, mem.mask, w, 1,
                                                   scales, mxu)
        same = (got.tok.reshape(B, 5) == ref.tok.reshape(B, 5)) & (gpar == rpar)
        agree += same.sum().item()
        n += B * 5
        torch.testing.assert_close(got.cum[same], ref.cum[same], rtol=0, atol=1e-2)
        st = ref
    assert agree / n >= 0.998


@pytest.mark.parametrize("memory", ["i8", "i8mxu"])
def test_int8_engine_on_card_matches_cpu(cuda, memory):
    import numpy as np

    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.data import simulator
    from ravvent_tpu_torch.data.snippets import prepare_compact
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import init_basecaller

    cfg = ModelConfig()
    params = init_basecaller(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    seq = simulator.random_genome(1500, rng)
    sig, ranges = simulator.simulate_read(seq, rng, simulator.PoreModel())
    sigc, rr, ev, er, _, _ = prepare_compact(sig, ranges, np.array(["a"] * len(ranges)), 6)
    rr, er = rr[:64], er[:64]
    step, attend = ("beam_step_i8mxu", "beam_attend_i8mxu") if memory == "i8mxu" else (
        "beam_step_i8", "beam_attend_i8")
    card = BasecallEngine(params, cfg, memory_dtype=memory)
    before = dict(cuda_lib.launches)
    t_card, p_card = card.predict_beam_compact(sigc, rr, ev, er, 40, 5)
    steps = cuda_lib.launches[step] - before[step]
    assert steps > 0
    for name in (attend, "beam_cell"):
        assert cuda_lib.launches[name] - before[name] == steps
    for name in ("beam_step", "beam_attend"):
        assert cuda_lib.launches[name] == before[name]
    t_cpu, _ = BasecallEngine(params, cfg, memory_dtype=memory,
                              device="cpu").predict_beam_compact(sigc, rr, ev, er, 40, 5)
    assert np.isfinite(p_card).all()
    assert (t_card == t_cpu).mean() >= 0.998
    with pytest.raises(ValueError, match="beam_impl='step'"):
        BasecallEngine(params, cfg, memory_dtype=memory, beam_impl="loop")


def test_int8_step_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    B = 4
    dec_p, mem = _decoder_and_memory(0, B, 16, "i8", True, cuda)
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    ks, vs = mem.kscale, mem.vscale
    step = functools.partial(beam_step_cuda.beam_step, keys=mem.keys, values=mem.values,
                             mask=mem.mask, w=w, end_token=1)
    st = beam_step_cuda.initial_state(B, 5, 128, 2, cuda)
    with pytest.raises(ValueError, match="kscale has shape"):
        step(st, scales=(ks[:, :8].contiguous(), vs))
    with pytest.raises(ValueError, match="vscale must be a contiguous"):
        step(st, scales=(ks, vs.double()))
    with pytest.raises(ValueError, match="both int8"):
        step(st)  # int8 memory without its scales
    with pytest.raises(ValueError, match="beam widths"):
        step(beam_step_cuda.initial_state(B, 33, 128, 2, cuda), scales=(ks, vs))
    with pytest.raises(ValueError, match="int8 memory"):
        beam_loop_cuda.beam_loop(mem.keys, mem.values, mem.mask, w, 5, 5, 5, 2, 1, (ks, vs))


def _mid_decode_state(gen, B: int, W: int, V: int, device, U: int = 128
                      ) -> beam_step_cuda.StepState:
    """A state in the middle of a decode: tokens in [0, V + 2) (ids >= V embed
    to zeros), spread h, c, att and cumulative scores, a fifth of the beams
    finished."""
    st = beam_step_cuda.StepState(
        torch.randint(0, V + 2, (B * W,), generator=gen, dtype=torch.int32),
        torch.tanh(torch.randn(B * W, U, generator=gen)), torch.randn(B * W, U, generator=gen),
        torch.randn(B * W, U, generator=gen), -5.0 * torch.rand(B, W, generator=gen),
        torch.rand(B, W, generator=gen) < 0.2)
    return beam_step_cuda.StepState(*(t.to(device) for t in st))


# (U, B, W) of the beam step's kernels on the card: the flagship's 128 units
# at W 1, 5, 8 keep their ids "B-W"; the other compiled decoder widths (ids
# U64-, U256-) and beam widths (W10-, W16-: the attend kernel's instance of
# 16 beams on a runtime W); then the attend kernel's instance of 32 beams
# (WIDE_CASES: W17-, W32-, U64-37-32, U256-37-32)
STEP_CASES = ([(128, B, W) for B in (9, 37, 130) for W in (1, 5, 8)]
              + [(64, 37, 5), (64, 130, 5), (256, 37, 5), (256, 130, 5), (128, 37, 10),
                 (128, 130, 16)])
WIDE_CASES = [(128, 37, 17), (128, 130, 32), (64, 37, 32), (256, 37, 32)]


def step_ids(cases) -> list:
    return [f"{B}-{W}" if U == 128 and W <= 8 else
            (f"U{U}-{B}-{W}" if U != 128 else f"W{W}-{B}") for U, B, W in cases]


STEP_IDS = step_ids(STEP_CASES)


@pytest.mark.parametrize("U,B,W", STEP_CASES + WIDE_CASES, ids=step_ids(STEP_CASES + WIDE_CASES))
def test_beam_cell_kernel_matches_plain(cuda, U, B, W):
    """h', c' and att_h against cell_plain: f32 sums of 2U (cell) and U
    (att_h) terms in another order, within 1e-5; the last tile is ragged."""
    gen = torch.Generator().manual_seed(10 * B + W + (U != 128) * U)
    dec_p, mem = _decoder_and_memory(B, B, 8, torch.float32, True, cuda, U=U)
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = _mid_decode_state(gen, B, W, 7, cuda, U)
    before = dict(cuda_lib.launches)
    got = beam_step_cuda.beam_cell(st, w)
    assert cuda_lib.launches["beam_cell"] == before["beam_cell"] + 1
    assert cuda_lib.launches["beam_step"] == before["beam_step"]
    ref = beam_step_cuda.cell_plain(st, w)
    for g, r in zip(got, ref):  # the kernel's scratch
        assert g.shape == (B * W, U) and g.dtype == torch.float32 and g.is_contiguous()
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [8, 232, 300], ids=["S8", "S232", "S300 (position loop)"])
@pytest.mark.parametrize("mem_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("U,B,W", STEP_CASES, ids=STEP_IDS)
def test_beam_attend_kernel_matches_plain(cuda, U, B, W, mem_dtype, S):
    """beam_attend against attend_plain on the same cell outputs. Picks may
    part on a near-tie, at most one in a hundred (and one at least); where
    the parents agree the state rows are copied exactly and att within
    1e-4 (f32 memory) or 1e-3 (bf16: an alignment may round the other way
    after sums in another order); where the picks agree the scores within
    the same bars. Row 3 is all padding."""
    gen = torch.Generator().manual_seed(1000 + 10 * B + W + (U != 128) * U)
    dec_p = init_decoder(gen, 7, 1, U, 256, cuda)
    memory = torch.tanh(torch.randn(B, S, 256, generator=gen)).to(cuda)
    mask = (torch.rand(B, S, generator=gen) > 0.2).to(cuda)
    mask[3] = False
    mem = attn.setup_memory(dec_p["attention"], memory, mask, mem_dtype,
                            attention_layer=dec_p["attention_layer"])
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = _mid_decode_state(gen, B, W, 7, cuda, U)
    cell = beam_step_cuda.cell_plain(st, w)
    before = dict(cuda_lib.launches)
    got, gpar = beam_step_cuda.beam_attend(st, *cell, mem.keys, mem.values, mask, w, 1)
    assert cuda_lib.launches["beam_attend"] == before["beam_attend"] + 1
    ref, rpar = beam_step_cuda.attend_plain(st, *cell, mem.keys, mem.values, mask, w, 1)
    par_eq = gpar == rpar
    same = (got.tok.reshape(B, W) == ref.tok.reshape(B, W)) & par_eq
    assert (~same).sum().item() <= max(1, B * W // 100)
    rows = lambda t: t.reshape(B, W, U)[par_eq]  # noqa: E731
    assert torch.equal(rows(got.h), rows(ref.h)) and torch.equal(rows(got.c), rows(ref.c))
    tol = 1e-3 if mem_dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(rows(got.att), rows(ref.att), rtol=0, atol=tol)
    torch.testing.assert_close(got.cum[same], ref.cum[same], rtol=0, atol=tol)
    assert torch.equal(got.fin[same], ref.fin[same])


@pytest.mark.parametrize("S", [8, 232, 300], ids=["S8", "S232", "S300 (position loop)"])
@pytest.mark.parametrize("mem_dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("U,B,W", WIDE_CASES, ids=step_ids(WIDE_CASES))
def test_beam_attend_wide_kernel_matches_plain(cuda, U, B, W, mem_dtype, S):
    """The attend kernel's instance of 32 beams against attend_plain on the
    same cell outputs, as test_beam_attend_kernel_matches_plain holds the
    others: picks part on a near-tie at most one in a hundred; where the
    parents agree the state rows are copied exactly; on f32 memory att and
    (where the picks agree) the scores within 1e-4. On bf16 memory an
    alignment that rounds the other way (the softmax's sums in another
    order) moves its hypothesis's att by one bf16 ulp of that alignment
    times the value row; over the 4160 hypotheses of W = 32 at B = 130 that
    is more than 1e-3 for one hypothesis (measured on an H100: 2.4e-3, one
    row of 4160). So on bf16 at most one hypothesis in a thousand (and one
    at least) may pass 1e-3, and none one bf16 ulp of an alignment of 1
    (2^-8) times the largest |value|; the scores where the picks agree
    within 1e-3 but on those hypotheses' rows, and within phase 3's
    cumulative bar of 1e-2 there. Row 3 is all padding."""
    gen = torch.Generator().manual_seed(1000 + 10 * B + W + (U != 128) * U)
    dec_p = init_decoder(gen, 7, 1, U, 256, cuda)
    memory = torch.tanh(torch.randn(B, S, 256, generator=gen)).to(cuda)
    mask = (torch.rand(B, S, generator=gen) > 0.2).to(cuda)
    mask[3] = False
    mem = attn.setup_memory(dec_p["attention"], memory, mask, mem_dtype,
                            attention_layer=dec_p["attention_layer"])
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = _mid_decode_state(gen, B, W, 7, cuda, U)
    cell = beam_step_cuda.cell_plain(st, w)
    before = dict(cuda_lib.launches)
    got, gpar = beam_step_cuda.beam_attend(st, *cell, mem.keys, mem.values, mask, w, 1)
    assert cuda_lib.launches["beam_attend"] == before["beam_attend"] + 1
    ref, rpar = beam_step_cuda.attend_plain(st, *cell, mem.keys, mem.values, mask, w, 1)
    par_eq = gpar == rpar
    same = (got.tok.reshape(B, W) == ref.tok.reshape(B, W)) & par_eq
    assert (~same).sum().item() <= max(1, B * W // 100)
    rows = lambda t: t.reshape(B, W, U)[par_eq]  # noqa: E731
    assert torch.equal(rows(got.h), rows(ref.h)) and torch.equal(rows(got.c), rows(ref.c))
    if mem_dtype == torch.float32:
        torch.testing.assert_close(rows(got.att), rows(ref.att), rtol=0, atol=1e-4)
        torch.testing.assert_close(got.cum[same], ref.cum[same], rtol=0, atol=1e-4)
    else:
        d_att = (got.att - ref.att).reshape(B, W, U).abs().amax(dim=2)  # [B, W]
        moved = par_eq & (d_att > 1e-3)
        assert moved.sum().item() <= max(1, B * W // 1000)
        ulp_bound = 2.0 ** -8 * mem.values.float().abs().max().item()
        assert d_att[par_eq].max().item() <= ulp_bound
        d_cum = (got.cum - ref.cum).abs()
        assert d_cum[same & ~moved].max().item() <= 1e-3
        assert d_cum[same].max().item() <= 1e-2
    assert torch.equal(got.fin[same], ref.fin[same])


@pytest.mark.parametrize("S", [8, 232, 300], ids=["S8", "S232", "S300 (position loop)"])
@pytest.mark.parametrize("mxu", [False, True], ids=["quant", "quant_mxu"])
@pytest.mark.parametrize("U,B,W", STEP_CASES + WIDE_CASES, ids=step_ids(STEP_CASES + WIDE_CASES))
def test_beam_attend_int8_kernel_matches_plain(cuda, U, B, W, mxu, S):
    """The int8 attend kernel against attend_plain with the scales, on the
    same cell outputs. The scores are computed in the reference's order, so
    picks part only on a near-tie, at most one in a hundred (and one at
    least); where the parents agree the state rows are copied exactly, and
    att and (where the picks agree) the scores are within 1e-2: summing in
    another order can move a folded alignment across a rounding boundary (a
    bf16 ulp for quant, one int8 code for quant_mxu), which moves a unit of
    the context by at most the row's largest folded alignment. Row 3 is
    all padding."""
    gen = torch.Generator().manual_seed(2000 + 10 * B + W + (U != 128) * U)
    dec_p = init_decoder(gen, 7, 1, U, 256, cuda)
    memory = torch.tanh(torch.randn(B, S, 256, generator=gen)).to(cuda)
    mask = (torch.rand(B, S, generator=gen) > 0.2).to(cuda)
    mask[3] = False
    mem = attn.setup_memory(dec_p["attention"], memory, mask, "i8",
                            attention_layer=dec_p["attention_layer"])
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    scales = (mem.kscale, mem.vscale)
    st = _mid_decode_state(gen, B, W, 7, cuda, U)
    cell = beam_step_cuda.cell_plain(st, w)
    name = "beam_attend_i8mxu" if mxu else "beam_attend_i8"
    before = dict(cuda_lib.launches)
    got, gpar = beam_step_cuda.beam_attend(st, *cell, mem.keys, mem.values, mask, w, 1, scales,
                                           mxu)
    assert cuda_lib.launches[name] == before[name] + 1
    assert cuda_lib.launches["beam_attend"] == before["beam_attend"]
    ref, rpar = beam_step_cuda.attend_plain(st, *cell, mem.keys, mem.values, mask, w, 1, scales,
                                            mxu)
    par_eq = gpar == rpar
    same = (got.tok.reshape(B, W) == ref.tok.reshape(B, W)) & par_eq
    assert (~same).sum().item() <= max(1, B * W // 100)
    rows = lambda t: t.reshape(B, W, U)[par_eq]  # noqa: E731
    assert torch.equal(rows(got.h), rows(ref.h)) and torch.equal(rows(got.c), rows(ref.c))
    torch.testing.assert_close(rows(got.att), rows(ref.att), rtol=0, atol=1e-2)
    torch.testing.assert_close(got.cum[same], ref.cum[same], rtol=0, atol=1e-2)
    assert torch.equal(got.fin[same], ref.fin[same])


def test_beam_step_launches_cell_then_attend(cuda):
    """On bf16/f32 memory a step is one beam_cell and one beam_attend launch
    and counts one beam_step."""
    B = 9
    dec_p, mem = _decoder_and_memory(3, B, 56, torch.bfloat16, True, cuda)
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = beam_step_cuda.initial_state(B, 5, 128, 2, cuda)
    before = dict(cuda_lib.launches)
    beam_step_cuda.beam_step(st, mem.keys, mem.values, mem.mask, w, 1)
    for name in ("beam_step", "beam_cell", "beam_attend"):
        assert cuda_lib.launches[name] == before[name] + 1
    for name in ("beam_step_i8", "beam_attend_i8", "beam_attend_i8mxu"):
        assert cuda_lib.launches[name] == before[name]


def test_beam_cell_and_attend_launch_failures_raise(cuda):
    """The C entry points refuse what they do not take (no rows, 96 units,
    beam widths 33 and 0, an end token outside the vocabulary), and
    cuda_lib.check raises on their return code; the wrappers refuse it
    before launching, naming the shape, and never take a plain route."""
    lib = cuda_lib.lib()
    for U, N in ((128, 0), (96, 5)):
        with pytest.raises(RuntimeError, match="beam_cell"):
            cuda_lib.check(lib.rv_beam_cell(U, N, 7, *[None] * 12), "beam_cell")
    for U, W, end in ((128, 33, 1), (128, 0, 1), (96, 5, 1), (128, 5, 7)):
        with pytest.raises(RuntimeError, match="beam_attend"):
            cuda_lib.check(lib.rv_beam_attend(1, U, W, 2, 8, 7, 128, end, *[None] * 18),
                           "beam_attend")
    B = 4
    dec_p, mem = _decoder_and_memory(0, B, 16, torch.bfloat16, True, cuda)
    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = beam_step_cuda.initial_state(B, 5, 128, 2, cuda)
    cell = beam_step_cuda.beam_cell(st, w)
    with pytest.raises(ValueError, match="h_new has shape"):
        beam_step_cuda.beam_attend(st, cell[0][:-1], *cell[1:], mem.keys, mem.values, mem.mask,
                                   w, 1)
    with pytest.raises(ValueError, match="both be bf16"):
        beam_step_cuda.beam_attend(st, *cell, mem.keys, mem.values.float(), mem.mask, w, 1)
    with pytest.raises(ValueError, match="64, 128, 256 units, got U = 96"):
        beam_step_cuda.beam_cell(st._replace(h=st.h[:, :96].contiguous()), w)
    before = dict(cuda_lib.launches)
    wide = beam_step_cuda.initial_state(B, 33, 128, 2, cuda)
    with pytest.raises(ValueError, match="beam widths 1-32, got W = 33"):
        beam_step_cuda.beam_step(wide, mem.keys, mem.values, mem.mask, w, 1)
    long_keys = torch.zeros(B, 4000, 256, dtype=torch.float32, device=cuda)
    dec_w, mem_w = _decoder_and_memory(0, B, 16, torch.float32, True, cuda, U=256)
    w_w = beam_step_cuda.pack_decoder_weights(dec_w, mem_w)
    with pytest.raises(ValueError, match="U = 256, W = 16, S = 4000 on f32 memory needs"):
        beam_step_cuda.beam_step(beam_step_cuda.initial_state(B, 16, 256, 2, cuda), long_keys,
                                 long_keys, torch.ones(B, 4000, dtype=torch.bool, device=cuda),
                                 w_w, 1)
    assert cuda_lib.launches == before  # nothing launched, no plain route taken
    shifted = torch.zeros(st.h.numel() + 1, device=cuda)[1:].view_as(st.h)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        beam_step_cuda.beam_cell(st._replace(h=shifted), w)


def test_beam_attend_int8_launch_failures_raise(cuda):
    """The int8 attend's C entry refuses beam width 33, 96 units, an end token
    outside the vocabulary, missing scales and a state that is not 16-byte
    aligned (none of these launches); the wrapper refuses missing or
    misshapen scales and a misaligned state before launching."""
    B = 4
    dec_p, mem = _decoder_and_memory(0, B, 16, "i8", True, cuda)
    ks, vs = mem.kscale, mem.vscale
    lib = cuda_lib.lib()
    P = [None] * 5  # h_new, c_new, att_h, cum_in, fin_in

    def entry(W, end, kscale, vscale, h_new=None, U=128):
        # mxu, U, W, B, S, V, VP, end; the state, keys, values, the scales,
        # mask, wfc, bfc, the seven outputs, the stream
        return lib.rv_beam_attend_i8(1, U, W, B, 16, 7, 128, end, h_new, *P[1:],
                                     mem.keys.data_ptr(), mem.values.data_ptr(), kscale, vscale,
                                     *[None] * 11)

    scales = (ks.data_ptr(), vs.data_ptr())
    with pytest.raises(RuntimeError, match="beam_attend_i8"):  # no 96-unit instance
        cuda_lib.check(entry(5, 1, *scales, U=96), "beam_attend_i8")
    for args, why in (((33, 1, *scales), "no beam width 33"),
                      ((5, 7, *scales), "end token outside the vocabulary"),
                      ((5, 1, None, vs.data_ptr()), "no key scales"),
                      ((5, 1, ks.data_ptr(), None), "no value scales")):
        with pytest.raises(RuntimeError, match="beam_attend_i8"):
            cuda_lib.check(entry(*args), "beam_attend_i8")
    shifted = torch.zeros(B * 5 * 128 + 1, device=cuda)[1:]  # 4 bytes off
    with pytest.raises(RuntimeError, match="beam_attend_i8"):
        cuda_lib.check(entry(5, 1, *scales, h_new=shifted.data_ptr()), "beam_attend_i8")

    w = beam_step_cuda.pack_decoder_weights(dec_p, mem)
    st = beam_step_cuda.initial_state(B, 5, 128, 2, cuda)
    cell = beam_step_cuda.beam_cell(st, w)
    attend = functools.partial(beam_step_cuda.beam_attend, st, keys=mem.keys, values=mem.values,
                               mask=mem.mask, w=w, end_token=1, mxu=True)
    with pytest.raises(ValueError, match="both int8"):
        attend(*cell)  # int8 memory without its scales
    with pytest.raises(ValueError, match="kscale has shape"):
        attend(*cell, scales=(ks[:, :8].contiguous(), vs))
    with pytest.raises(ValueError, match="vscale must be a contiguous"):
        attend(*cell, scales=(ks, vs.double()))
    with pytest.raises(ValueError, match="16-byte aligned"):
        attend(shifted.view(B * 5, 128), *cell[1:], scales=(ks, vs))


def long_reads():
    """Two synthetic reads of ~138k and ~57k samples padded to 196608, the
    signal-only wire's bucket for the longer: t1, t2 [2, S] and n_valid."""
    rng = np.random.default_rng(3)
    r1, r2 = synth(rng, 12000), synth(rng, 5000)
    x = np.zeros((2, 196608), np.float32)
    x[0, :len(r1)], x[1, :len(r2)] = r1, r2
    nv = torch.tensor([len(r1), len(r2)], dtype=torch.int32)
    xt = torch.from_numpy(x)
    return (event_detect.compute_tstats_device(xt, 6, 9, nv),
            event_detect.compute_tstats_device(xt, 9, 9, nv), nv)


@pytest.mark.parametrize("case", ["reads", "long", "coupling_failure", "memory"])
def test_peak_scan_kernel_matches_plain(cuda, case):
    """csrc/peak_scan.cu's scan and check against peak_scan_plain on the
    card, bit for bit: padded reads (the check passes), two long reads in
    one batch, and the two traces whose check fails (the rescan gives the
    sequential answer). event_detect.peak_scan launches both kernels and
    nothing else."""
    t1, t2, nv = long_reads() if case == "long" else peak_scan_inputs(case)
    t1, t2, nv = t1.to(cuda), t2.to(cuda), nv.to(cuda)
    before = cuda_lib.launches["peak_scan"]
    fired, ok = peak_scan_cuda.peak_scan_cuda(t1, t2, nv, 6, 9)
    assert cuda_lib.launches["peak_scan"] == before + 2
    ref = event_detect.peak_scan_plain(t1, t2, 6, 9, n_valid=nv)
    assert torch.equal(fired, ref)
    assert ok.all().item() == (case in ("reads", "long"))
    assert torch.equal(event_detect.peak_scan(t1, t2, 6, 9, n_valid=nv), ref)
    assert cuda_lib.launches["peak_scan"] == before + 4
    assert torch.equal(ref.cpu(), event_detect.peak_scan_plain(t1.cpu(), t2.cpu(), 6, 9,
                                                               n_valid=nv.cpu()))


def test_peak_scan_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    t = torch.zeros(2, 600, device=cuda)
    nv = torch.full((2,), 600, dtype=torch.int32, device=cuda)
    bad = [
        (t.cpu(), t.cpu(), nv.cpu()),  # the CPU's tensors go to the plain version
        (t.double(), t.double(), nv),
        (t, t, nv.long()),
        (t, t, nv[:1]),
        (t[:, ::2], t[:, ::2], nv),
        (t[:0], t[:0], nv[:0]),
        (t, t[:1], nv),
    ]
    for t1, t2, n in bad:
        with pytest.raises(ValueError):
            peak_scan_cuda.peak_scan_cuda(t1, t2, n, 6, 9)


@pytest.mark.parametrize("sig_wire", ["i16", "u8"])
def test_signal_wire_segmentation_on_card_matches_cpu(cuda, sig_wire):
    """The engine's segmentation of a ~57k-sample read on the card against
    the CPU engine: the signal, the meta and the ranges equal, the features
    within 1e-5 (both f64, the cumsums added in other orders), two peak_scan
    launches a segmentation."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import init_basecaller

    cfg = ModelConfig()
    params = init_basecaller(cfg, torch.Generator().manual_seed(0))
    raw = synth(np.random.default_rng(8), 5000)
    S_b = BasecallEngine._bucket(raw.size, 65536)
    E_b, N_max = S_b // 2, S_b // 2 // 6 + 1 + 4096
    out = {}
    for dev in ("cuda", "cpu"):
        eng = BasecallEngine(params, cfg, device=dev)
        buf = eng._upload({"b": eng.signal_buffer([raw], S_b, sig_wire)})["b"]
        before = cuda_lib.launches["peak_scan"]
        out[dev] = [x.cpu() for x in eng._segment(buf[0], S_b, E_b, N_max, 6, sig_wire)]
        assert cuda_lib.launches["peak_scan"] == before + (2 if dev == "cuda" else 0)
    (sig, feats, rr, er, meta), ref = out["cuda"], out["cpu"]
    assert torch.equal(sig, ref[0]) and torch.equal(meta, ref[4]) and meta[1] > 500
    assert torch.equal(rr, ref[2]) and torch.equal(er, ref[3])
    assert (feats - ref[1]).abs().max().item() <= 1e-5


def test_begin_beam_signal_does_not_wait_on_the_card(cuda):
    """begin_beam_signal enqueues the upload, the segmentation and the meta's
    copy without a synchronizing call that torch's sync debug mode knows
    (it raises on one; the mode is a prototype and does not know every
    call); finish_beam_signal then decodes every snippet."""
    from ravvent_tpu_torch.config import ModelConfig
    from ravvent_tpu_torch.evaluation.basecall import BasecallEngine
    from ravvent_tpu_torch.models.basecaller import init_basecaller

    cfg = ModelConfig()
    eng = BasecallEngine(init_basecaller(cfg, torch.Generator().manual_seed(0)), cfg,
                         memory_dtype=torch.bfloat16, encoder_dtype=torch.bfloat16)
    raw = synth(np.random.default_rng(2), 1500)
    eng.begin_beam_signal(raw)  # first use: the kernel library is built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        seg = eng.begin_beam_signal(raw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tokens, probs = eng.collect_beam_compact(eng.finish_beam_signal(seg, 40, 5))
    assert tokens.shape[0] == eng._signal_meta(seg)[1] > 100 and np.isfinite(probs).all()


def test_analyze_beam1_gap_on_card_matches_cpu(cuda, tmp_path):
    """tools/analyze_beam1_gap.py on the trained flagship (assets/
    flagship.npz) over one read of 800-1200 bases, on the card and with
    --cpu: each beam's merged and per-snippet identities within 0.3 points
    (chip_smoke.py phase 23's bar), the f32 BiLSTM kernel 4 times a chunk
    and the beam step's kernels once a step."""
    from ravvent_tpu_torch.tools import analyze_beam1_gap, make_dataset
    from ravvent_tpu_torch.weights import FLAGSHIP_NPZ

    make_dataset.build(tmp_path / "ds", 43, genome_len=20_000, train_reads=0, eval_reads=2,
                       read_len=(800, 1200), seed=11)
    argv = ["--checkpoint", str(FLAGSHIP_NPZ), "--data-type", "joint", "--encoder-depth", "2",
            "--files-info", str(tmp_path / "ds" / "eval" / "files_info.snippets.stride_6.json"),
            "--reads", "1", "--cache-dir", str(tmp_path / "cache")]
    cuda_lib.reset_launches()
    card = analyze_beam1_gap.main(argv)
    launches = dict(cuda_lib.launches)
    cpu = analyze_beam1_gap.main(argv + ["--cpu"])
    assert card["reads"] == cpu["reads"] == 1
    for beam in ("beam5", "beam1"):
        for key in ("snippet_identity_mean", "merged_identity"):
            assert abs(card["rows"][0][beam][key] - cpu["rows"][0][beam][key]) <= 0.003, \
                (beam, key)
    # 2 decodes a beam width (the study's, then the evaluator's), a chunk each
    assert launches["bilstm"] == 4 * 4 and launches["bilstm_plain_route"] == 0
    assert launches["beam_cell"] == launches["beam_attend"] == launches["beam_step"] > 0
    assert launches["bilstm_bf16"] == launches["beam_loop"] == launches["decode_step"] == 0
