"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA device and nvcc; without a card each one skips with
its reason. Run them on the machine with the card:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu -q

(``--noconftest``: tests/conftest.py imports JAX, which the card's machine
lacks; this file needs neither.)
"""

import pytest
import torch

from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.decoder import init_decoder
from ravvent_tpu_torch.models.rnn import init_encoder, stacked_weights
from ravvent_tpu_torch.ops import beam_step_cuda, cuda_lib, rnn_cuda

pytestmark = pytest.mark.gpu
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("F,T,seeded", [(1, 200, False), (5, 30, False), (256, 40, True)])
def test_bilstm_kernel_matches_plain(cuda, F, T, seeded):
    gen = torch.Generator().manual_seed(F)
    B, U = 37, 128  # a ragged last tile
    wx, wh, b = stacked_weights(init_encoder(gen, U, 1, F, cuda)[0])
    xs = torch.randn(B, T, F, generator=gen).to(cuda)
    h0, c0 = ((0.5 * torch.randn(2, B, U, generator=gen)).to(cuda) if seeded
              else torch.zeros(2, B, U, device=cuda) for _ in range(2))
    before = cuda_lib.launches["bilstm"]
    got = rnn_cuda.bilstm_layer(xs, wx, wh, b, h0, c0)
    assert cuda_lib.launches["bilstm"] == before + 1
    ref = rnn_cuda.bilstm_layer_plain(xs, wx, wh, b, h0, c0)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4)


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
    mem_c = attn.AttnMemory(*(t.to(cuda) for t in mem))
    dec_c = {k: v for k, v in dec_p.items()}
    dec_c["cells"] = [{k: v.to(cuda) for k, v in dec_p["cells"][0].items()}]
    dec_c["fc"] = {k: v.to(cuda) for k, v in dec_p["fc"].items()}
    card = beam_step_cuda.beam_step_decode(dec_c, mem_c, 7, 5, 47, 20)
    assert (card.tokens.cpu() == cpu.tokens).float().mean().item() >= 0.99


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    B, T, F, U = 2, 3, 4, 64
    xs = torch.zeros(B, T, F, device=cuda)
    with pytest.raises(ValueError, match="128 units"):
        rnn_cuda.bilstm_layer(xs, torch.zeros(2, F, 4 * U, device=cuda),
                              torch.zeros(2, U, 4 * U, device=cuda),
                              torch.zeros(2, 4 * U, device=cuda),
                              torch.zeros(2, B, U, device=cuda), torch.zeros(2, B, U, device=cuda))
