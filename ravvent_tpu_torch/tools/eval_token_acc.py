"""Per-snippet token test accuracy, the reference's reduced-curve metric, on
the GPU.

Counterpart of tools/eval_token_acc.py of the JAX package. The reference's
headline accuracy-vs-#6-mers curve (make_plots.py:54-78) reports model TEST
ACCURACY, not merged-read mapping identity: the masked exact-match accuracy
of utils.py:15-24 over a test split. This tool computes it for one
checkpoint over a files_info index:

- ``strict``: omit start/end AND pad (the reference's train-step metric,
  basecaller.py:247);
- ``val_style``: omit start/end only (the reference's val-step quirk,
  basecaller.py:277: pads counted);
- ``teacher_forced``: the train step's accuracy, conditioned on the gold
  prefix (``train_forward`` under ``no_grad``).

Per batch: the encoders (the f32 BiLSTM kernel on the card), un-projected
f32 memory, and a greedy decode of ``T - 1`` steps bounded by ``T - 1``:
the fused decode-step kernel (ops/decode_step_cuda.py:fused_greedy_decode)
for a depth-1 LSTM decoder with Luong attention (on a card, of the
kernel's widths: 128 decoder units, an encoder output of 256), else the
plain ``greedy_decode``; then ``train_forward``. Results are folded into
``<out_dir>/token_acc.<tag>.json`` keyed like the accuracy_results_all
schema: {"(encd, decd)": {data_type: {...}}}. ``--checkpoint`` is a port
checkpoint directory or an npz of weights. Runs on the first CUDA device
unless ``--cpu`` is given.

  python -m ravvent_tpu_torch.tools.eval_token_acc --checkpoint checkpoints/ref45_joint \
      --files-info datasets/ref45/eval/files_info.test.snippets.stride_6.json \
      --data-type joint --tag ref45 --out-dir results/ref_sweep
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Tuple

import torch

from ravvent_tpu_torch.config import DataConfig, ModelConfig
from ravvent_tpu_torch.data.generator import SnippetBatchGenerator
from ravvent_tpu_torch.decode.greedy import greedy_decode
from ravvent_tpu_torch.evaluation.basecall import kernels_serve, resolve_device
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models.basecaller import encode_input, train_forward
from ravvent_tpu_torch.ops.decode_step_cuda import fused_greedy_decode
from ravvent_tpu_torch.tools.common import add_model_flags, device_name, load_params, model_config
from ravvent_tpu_torch.utils.masking import masked_accuracy
from ravvent_tpu_torch.weights import to_device


@torch.no_grad()
def memory(params, cfg: ModelConfig, raw: torch.Tensor, event: torch.Tensor) -> attn.AttnMemory:
    """The encoders, then un-projected f32 attention memory."""
    enc_out, mask = encode_input(params, raw, event, cfg)
    return attn.setup_memory(params["decoder"]["attention"], enc_out, mask)


@torch.no_grad()
def greedy_tokens(params, cfg: ModelConfig, mem: attn.AttnMemory, steps: int) -> torch.Tensor:
    """Greedy tokens [B, steps] over ``mem``, bounded by ``steps``: the fused
    decode step where the decode kernels serve the decoder on the memory's
    device (evaluation/basecall.py:kernels_serve, its widths on a card),
    else the plain decode."""
    if kernels_serve(cfg, device=mem.keys.device, greedy=True):
        return fused_greedy_decode(params["decoder"], mem, cfg.vocab_size, steps, steps)[0]
    return greedy_decode(params["decoder"], mem, cfg.vocab_size, steps, steps,
                         cfg.effective_attention, cfg.cell_type)[0]


@torch.no_grad()
def batch_counts(params, cfg: ModelConfig, raw: torch.Tensor, event: torch.Tensor,
                 targets: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One batch's (strict matches, strict count, val-style matches,
    val-style count, teacher-forced matches), device scalars; the
    JAX tool's jitted ``step``."""
    T = targets.shape[1]
    tokens = greedy_tokens(params, cfg, memory(params, cfg, raw, event), T - 1)
    y = targets[:, 1:]
    n_strict = torch.sum((y != 0) & (y != 1) & (y != 2))
    n_val = torch.sum((y != 1) & (y != 2))
    # teacher-forced per-step accuracy: conditioned on the gold prefix, so a
    # single greedy insertion/deletion doesn't shift-penalize every later
    # position (the free-running metrics above do)
    tf_out = train_forward(params, raw, event, targets, cfg)
    return (masked_accuracy(y, tokens, [0, 1, 2]) * n_strict, n_strict,
            masked_accuracy(y, tokens, [1, 2]) * n_val, n_val,
            tf_out.acc * n_strict)


def main(argv=None) -> dict:
    """Evaluate; returns the row written for this data type."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True, help="port checkpoint dir or npz of weights")
    ap.add_argument("--files-info", required=True)
    add_model_flags(ap)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-batches", type=int, default=24)
    ap.add_argument("--out-dir", default="results/ref_sweep")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the GPU")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    mcfg = model_config(args)
    params = to_device(load_params(args.checkpoint), device)
    gen = SnippetBatchGenerator.from_config(
        args.files_info, DataConfig(batch_size=args.batch_size),
        cache_dir=args.cache_dir,
    )

    sums = torch.zeros(5, dtype=torch.float64)
    n_batches = 0
    for i, (raw, event, nuc) in enumerate(gen.epoch()):
        if i >= args.max_batches:
            break
        counts = batch_counts(params, mcfg, torch.as_tensor(raw, device=device),
                              torch.as_tensor(event, device=device),
                              torch.as_tensor(nuc, dtype=torch.int64, device=device))
        sums += torch.stack([c.to(torch.float64) for c in counts]).cpu()
        n_batches += 1
    s_num, s_den, v_num, v_den, t_num = (float(v) for v in sums)
    strict = s_num / max(s_den, 1.0)
    val_style = v_num / max(v_den, 1.0)
    tf_acc = t_num / max(s_den, 1.0)
    print(f"[{args.tag} {args.data_type}] token acc strict={strict:.4f} "
          f"val_style={val_style:.4f} tf={tf_acc:.4f} over {n_batches} batches "
          f"on {device_name(device)}")

    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"token_acc.{args.tag}.json"
    data = json.loads(out.read_text()) if out.exists() else {}
    depth_key = f"({args.encoder_depth}, {args.decoder_depth})"
    row = {
        "strict": round(strict, 5), "val_style": round(val_style, 5),
        "teacher_forced": round(tf_acc, 5), "batches": n_batches,
    }
    data.setdefault(depth_key, {})[args.data_type] = row
    out.write_text(json.dumps(data, indent=2))
    print(f"-> {out}")
    return row


if __name__ == "__main__":
    main()
