"""The basecaller model (counterpart of ravvent_tpu/models/basecaller.py):
raw and event encoders, attention decoder. Both encoders always exist (raw:
1 feature, event: 5), as in the reference; joint mode concatenates their
outputs and masks along time (200 raw + 30 event = 230 memory positions).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ravvent_tpu_torch.config import ModelConfig
from ravvent_tpu_torch.models import decoder as dec
from ravvent_tpu_torch.models.rnn import encoder_apply, init_encoder
from ravvent_tpu_torch.utils.masking import input_mask

Params = Dict[str, Any]


def check_config(cfg: ModelConfig) -> None:
    """The port runs bidirectional-LSTM encoders with a Luong LSTM decoder."""
    if cfg.rnn_type != "bilstm" or cfg.effective_attention != "luong":
        raise NotImplementedError(
            f"ravvent_tpu_torch ports rnn_type='bilstm' with Luong attention, got "
            f"{cfg.rnn_type!r}/{cfg.effective_attention!r}")


def init_basecaller(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Seeded weights at the config's widths (the JAX tree's layout; the
    numbers differ from jax.random's for the same seed)."""
    check_config(cfg)
    return {
        "encoder_raw": init_encoder(gen, cfg.enc_units, cfg.encoder_depth, 1, device),
        "encoder_event": init_encoder(gen, cfg.enc_units, cfg.encoder_depth, 5, device),
        "decoder": dec.init_decoder(gen, cfg.vocab_size, cfg.decoder_depth, cfg.dec_units,
                                    cfg.enc_out_dim, device),
    }


def encode_input(params: Params, raw: torch.Tensor, event: torch.Tensor,
                 cfg: ModelConfig, weights: Optional[Dict[str, list]] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (enc_output [B, S, enc_out_dim], input_mask [B, S]). The
    encoders run on the inputs' dtype (f32, or the bf16 stream); the caller
    casts raw and event first, so the masks come from the cast inputs.
    ``weights``: per encoder key, its layers' ``stream_weights`` (or
    ``kernel_weights``) in that dtype (made here when None)."""
    weights = weights or {}

    def enc(key, xs):
        return encoder_apply(params[key], xs, weights.get(key))[0]

    if cfg.data_type == "raw":
        return enc("encoder_raw", raw), input_mask(raw)
    if cfg.data_type == "event":
        return enc("encoder_event", event), input_mask(event)
    out_raw = enc("encoder_raw", raw)
    out_event = enc("encoder_event", event)
    out = torch.cat([out_raw, out_event], dim=1)
    mask = torch.cat([input_mask(raw), input_mask(event)], dim=-1)
    return out, mask
