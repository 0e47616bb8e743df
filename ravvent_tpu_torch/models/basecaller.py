"""The basecaller model (counterpart of ravvent_tpu/models/basecaller.py):
raw and event encoders, attention decoder, losses. Both encoders always
exist (raw: 1 feature, event: 5), as in the reference; joint mode
concatenates their outputs and masks along time (200 raw + 30 event = 230
memory positions). Train metrics: masked CE (pad excluded, mean over
non-pad) and accuracy omitting pad, start and end. Validation metrics: loss
on the greedy decode's logits, accuracy omitting start and end only (not
pad, a reference quirk, basecaller.py:267-279) within the batch-max target
width. Data-parallel training passes ``reduce`` (utils/masking.py), so
that every count and the batch-max width are the global batch's; a rank of
a model row passes its ``model_axis`` too (:func:`shard_attention`).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models import decoder as dec
from ravvent_tpu_torch.models.rnn import encoder_apply, init_encoder
from ravvent_tpu_torch.parallel.mesh import memory_sharding
from ravvent_tpu_torch.tokenizer import NUC_TOKENIZER
from ravvent_tpu_torch.utils.masking import Reduce, input_mask, masked_accuracy, masked_ce_loss

Params = Dict[str, Any]

PAD, END, START = NUC_TOKENIZER.pad_id, NUC_TOKENIZER.end_id, NUC_TOKENIZER.start_id


RNN_TYPES = ("bilstm", "bigru", "lstm", "gru")
ATTENTION_TYPES = ("luong", "bahdanau")


def check_config(cfg: ModelConfig) -> None:
    """The configurations ModelConfig allows: ``rnn_type`` one of
    ``RNN_TYPES`` and the effective attention one of ``ATTENTION_TYPES``."""
    if cfg.rnn_type not in RNN_TYPES:
        raise ValueError(f"rnn_type must be one of {RNN_TYPES}, got {cfg.rnn_type!r}")
    if cfg.effective_attention not in ATTENTION_TYPES:
        raise ValueError(f"attention_type must be one of {ATTENTION_TYPES}, got "
                         f"{cfg.effective_attention!r}")


def init_basecaller(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Seeded weights at the config's widths (the JAX tree's layout; the
    numbers differ from jax.random's for the same seed)."""
    check_config(cfg)
    enc = dict(device=device, cell_type=cfg.cell_type, bidirectional=cfg.bidirectional)
    return {
        "encoder_raw": init_encoder(gen, cfg.enc_units, cfg.encoder_depth, 1, **enc),
        "encoder_event": init_encoder(gen, cfg.enc_units, cfg.encoder_depth, 5, **enc),
        "decoder": dec.init_decoder(gen, cfg.vocab_size, cfg.decoder_depth, cfg.dec_units,
                                    cfg.enc_out_dim, device, cfg.effective_attention,
                                    cfg.cell_type),
    }


def encode_input(params: Params, raw: torch.Tensor, event: torch.Tensor,
                 cfg: ModelConfig, weights: Optional[Dict[str, list]] = None,
                 trainable: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (enc_output [B, S, enc_out_dim], input_mask [B, S]). The
    encoders run on the inputs' dtype (f32, or the bf16 stream); the caller
    casts raw and event first, so the masks come from the cast inputs.
    ``weights``: per encoder key, its layers' ``stream_weights`` (or
    ``kernel_weights``) in that dtype (made here when None; bidirectional
    LSTM encoders only, the others run their plain scan).
    ``trainable=True`` keeps the encoders on their differentiable plain
    version on every device (see encoder_apply); it takes no ``weights``."""
    weights = weights or {}

    def enc(key, xs):
        return encoder_apply(params[key], xs, weights.get(key), trainable, cfg.cell_type,
                             cfg.bidirectional)[0]

    if cfg.data_type == "raw":
        return enc("encoder_raw", raw), input_mask(raw)
    if cfg.data_type == "event":
        return enc("encoder_event", event), input_mask(event)
    out_raw = enc("encoder_raw", raw)
    out_event = enc("encoder_event", event)
    out = torch.cat([out_raw, out_event], dim=1)
    mask = torch.cat([input_mask(raw), input_mask(event)], dim=-1)
    return out, mask


def shard_attention(dec_params: Params, enc_out: torch.Tensor, mask: torch.Tensor,
                    model_axis=None) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """The counterpart of the JAX trainer's memory constraint: this model
    rank's positions of the memory and its mask
    (parallel/mesh.py:memory_sharding), and the decoder's parameters with
    the attention's entering the sharded region
    (parallel/distributed.py:Axis). The memory and those parameters act
    only on this rank's slice there, so their gradients sum the slices'
    shares across the row, and the encoders' gradients are whole on every
    rank. Unchanged without a ``model_axis``."""
    if model_axis is None:
        return dec_params, enc_out, mask
    s = memory_sharding(model_axis.size, model_axis.index, enc_out.shape[1])
    attention = {k: model_axis.enter(v) for k, v in dec_params["attention"].items()}
    return {**dec_params, "attention": attention}, model_axis.enter(enc_out)[:, s], mask[:, s]


class TrainOutput(NamedTuple):
    loss: torch.Tensor
    acc: torch.Tensor
    logits: torch.Tensor


def train_forward(params: Params, raw: torch.Tensor, event: torch.Tensor, targets: torch.Tensor,
                  cfg: ModelConfig, sampling_probability: float = 0.0,
                  gen: Optional[torch.Generator] = None,
                  draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  reduce: Optional[Reduce] = None, model_axis=None) -> TrainOutput:
    """Teacher-forced forward pass with loss and train accuracy
    (reference: basecaller.py:225-253): the trainable encoders, un-projected
    f32 memory, then :func:`decoder.teacher_forced_decode` over
    ``targets[:, :-1]`` against ``targets[:, 1:]``. An unsampled position's
    -1 counts as a miss, as in the reference. With ``reduce`` (a
    data-parallel rank's rows) the loss is this rank's share of the global
    batch's loss and the accuracy the global batch's. With ``model_axis``
    the attention memory is sharded over it (:func:`shard_attention`); the
    outputs are the whole row's on every rank of the axis."""
    check_config(cfg)
    enc_out, mask = encode_input(params, raw, event, cfg, trainable=True)
    dec_params, enc_out, mask = shard_attention(params["decoder"], enc_out, mask, model_axis)
    mem = attn.setup_memory(dec_params["attention"], enc_out, mask)
    logits, sample_ids = dec.teacher_forced_decode(
        dec_params, targets[:, :-1], mem, cfg.vocab_size, sampling_probability, gen,
        draws, cfg.effective_attention, cfg.cell_type, model_axis)
    real = targets[:, 1:]
    loss = masked_ce_loss(real, logits, PAD, reduce)
    acc = masked_accuracy(real, sample_ids, [PAD, START, END], reduce=reduce)
    return TrainOutput(loss=loss, acc=acc, logits=logits)


def loss_fn(params: Params, batch: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
            cfg: ModelConfig, sampling_probability: float = 0.0,
            gen: Optional[torch.Generator] = None):
    raw, event, targets = batch
    out = train_forward(params, raw, event, targets, cfg, sampling_probability, gen)
    return out.loss, out


def batch_max_target_len(targets: torch.Tensor, pad_token: int = PAD,
                         reduce: Optional[Reduce] = None) -> torch.Tensor:
    """The batch-max token width: the width the reference would have padded
    this batch to (data_loader.py:124); the global batch's with ``reduce``."""
    width = torch.max(torch.sum(targets != pad_token, dim=1))
    return width if reduce is None else reduce(width, "max")


def val_metrics(real: torch.Tensor, pred_tokens: torch.Tensor, logits: torch.Tensor,
                targets: torch.Tensor, reduce: Optional[Reduce] = None):
    """Validation loss and accuracy (reference: basecaller.py:267-279):
    ``real`` = targets[:, 1:], ``pred_tokens`` [B, T-1] the greedy tokens,
    ``logits`` [B, T-1, V]; the loss masks pad, the accuracy omits start and
    end within the batch-max width, ``targets`` [B, T] giving that width.
    With ``reduce`` both are the global batch's."""
    loss = masked_ce_loss(real, logits, PAD, reduce)
    if reduce is not None:
        loss = reduce(loss, "sum")
    width = batch_max_target_len(targets, reduce=reduce) - 1
    in_width = torch.arange(real.shape[1], device=real.device)[None, :] < width
    acc = masked_accuracy(real, pred_tokens, [START, END], extra_mask=in_width, reduce=reduce)
    return loss, acc
