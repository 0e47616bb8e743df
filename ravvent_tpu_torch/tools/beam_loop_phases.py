"""Where a step of the whole-loop beam kernel (B3) spends its cycles.

Builds ``csrc/beam_loop.cu`` a second time with ``-DRV_BEAM_LOOP_PHASES``
into the gitignored ``ravvent_tpu_torch/build/``, beside the production
library, which it leaves alone. In that build lane 0 of every warp sums
``clock64()`` cycles over the phases of each step that the source names
(``rv_beam_loop_phase_names``) and writes its sums when the loop ends. For
each memory type and batch size it runs chip_smoke.py phase 5's decoder
(beam 5, 39 live steps of 47, S = 232) with the end token's logit pushed
down, so that every live step runs the whole cell and attention, and prints
each phase's cycles a step (mean and max over the warps), the production
kernel's ms a chunk and the timing build's (CUDA events), the clock that
the timing build implies, 39 launches of the beam step on the same memory,
and, where the source has clusters, the cluster size and how many clusters
the card holds at once. Needs a CUDA device and nvcc.

Usage: python -m ravvent_tpu_torch.tools.beam_loop_phases [--memory bf16 f32]
       [--batch 4096 2858] [--json out.json]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys

import torch

from ravvent_tpu_torch.ops import cuda_lib
from ravvent_tpu_torch.tools.bilstm_phases import (
    production_registers, smi_line, time_ms, timing_build,
)

U, V, W, E, S, T, EFF, START, END = 128, 7, 5, 256, 232, 47, 39, 2, 1
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def decoder_and_memory(B: int, dtype, seed: int = 2):
    """chip_smoke.py phase 5's decoder (end token pushed down) on an
    encoder-like memory of B rows: (keys, values, mask, weights)."""
    from ravvent_tpu_torch.models import attention as attn
    from ravvent_tpu_torch.models.decoder import init_decoder
    from ravvent_tpu_torch.ops.beam_step_cuda import pack_decoder_weights

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed)
    dec = init_decoder(gen, V, 1, U, E, dev)
    dec["fc"]["bias"][END] -= 20.0
    memory = torch.tanh(torch.randn(B, S, E, generator=gen)).to(dev)
    pos = torch.arange(S)
    n_raw = torch.randint(120, 201, (B, 1), generator=gen)
    n_ev = torch.randint(15, 31, (B, 1), generator=gen)
    mask = ((pos < n_raw) | ((pos >= 200) & (pos < 200 + n_ev))).to(dev)
    mem = attn.setup_memory(dec["attention"], memory, mask, dtype,
                            attention_layer=dec["attention_layer"])
    return mem.keys.contiguous(), mem.values.contiguous(), mask, pack_decoder_weights(dec, mem)


def clusters(handle, mem: str):
    """(cluster size, clusters the card holds at once) with which the
    library ``handle`` launches, or None where its source has no clusters."""
    if not hasattr(handle, "rv_beam_loop_clusters"):
        return None
    size, active = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(handle.rv_beam_loop_clusters(int(mem == "bf16"), W, S, V,
                                                ctypes.addressof(size), ctypes.addressof(active)),
                   "beam_loop (occupancy)")
    return size.value, active.value


def split(entry, names, handle, mem: str, B: int) -> dict:
    """One memory type at batch B: phase cycles a step, both builds' ms."""
    from ravvent_tpu_torch.ops.beam_loop_cuda import beam_loop, replay_plain
    from ravvent_tpu_torch.ops.beam_step_cuda import beam_step_loop

    keys, values, mask, w = decoder_and_memory(B, DTYPES[mem])
    mem_bf16 = int(mem == "bf16")
    dev = keys.device
    out = [torch.zeros(T, B, W, dtype=dt, device=dev)
           for dt in (torch.int32, torch.int32, torch.float32)]
    stamps = torch.zeros(-(-B // 8) * 8 * 32, len(names), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def timed():
        cuda_lib.check(entry(mem_bf16, W, B, S, V, T, EFF, START, END, keys.data_ptr(),
                             values.data_ptr(), mask.data_ptr(), w.wx.data_ptr(),
                             w.wh.data_ptr(), w.b.data_ptr(), w.watt_h.data_ptr(),
                             w.wfc.data_ptr(), w.bfc.data_ptr(), *(o.data_ptr() for o in out),
                             stamps.data_ptr(), stream), "beam_loop (timing build)")

    ms = time_ms(lambda: beam_loop(keys, values, mask, w, W, T, EFF, START, END), reps=3)
    step_ms = time_ms(lambda: beam_step_loop(keys, values, mask, w, W, T, EFF, START, END),
                      reps=2)
    stamps.zero_()
    timed()
    torch.cuda.synchronize()
    per_warp = stamps.cpu()
    per_warp = per_warp[per_warp.sum(1) > 0].double() / EFF  # the warps that ran
    ms_timed = time_ms(timed, reps=3)
    # the timing build's result, each live step replayed through the plain step
    rows = slice(0, min(B, 256))
    rep = replay_plain(*(o[:, rows].contiguous() for o in out), keys[rows], values[rows],
                       mask[rows], w, EFF, START, END)
    mean, peak = per_warp.mean(0).tolist(), per_warp.max(0).values.tolist()
    total = sum(mean)
    cl = clusters(handle, mem)
    at_once = cl[0] * cl[1] if cl else torch.cuda.get_device_properties(0).multi_processor_count
    waves = -(-(per_warp.shape[0] // 16) // at_once)  # one CTA an SM, 16 warps a CTA
    return {"memory": mem, "B": B, "ms": ms, "ms_timing_build": ms_timed,
            "beam_step_x39_ms": step_ms, "clusters": cl, "waves": waves,
            "implied_sm_ghz": total * EFF * waves / (ms_timed * 1e6),
            "cycles_per_step": dict(zip(names, mean)),
            "cycles_per_step_max": dict(zip(names, peak)), "cycles_per_step_total": total,
            "warps": int(per_warp.shape[0]),
            "timing_build_replay": {"exact": rep.exact, "distinct": rep.distinct,
                                    "score_err": max(rep.rank_err, rep.score_err)}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--memory", nargs="+", choices=sorted(DTYPES), default=["bf16", "f32"])
    ap.add_argument("--batch", type=int, nargs="+", default=[4096, 2858])
    ap.add_argument("--json", help="also write the rows to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("beam_loop_phases: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print("production build:", production_registers("beam_loop.cu"))
    entry, names, handle = timing_build("beam_loop.cu", ["RV_BEAM_LOOP_PHASES"], "rv_beam_loop",
                                        "rv_beam_loop_phase_names")
    smi = smi_line()
    rows = []
    for mem in args.memory:
        for B in args.batch:
            r = split(entry, names, handle, mem, B)
            rows.append(r)
            ph = "  ".join(f"{k} {v:.0f} (max {r['cycles_per_step_max'][k]:.0f})"
                           for k, v in r["cycles_per_step"].items())
            cl = r["clusters"]
            print(f"{mem} B={B}: {r['ms']:.3f} ms a chunk (timing build "
                  f"{r['ms_timing_build']:.3f} ms; beam step x {EFF} {r['beam_step_x39_ms']:.3f} "
                  f"ms); clusters " + (f"of {cl[0]}, {cl[1]} at once" if cl else "none")
                  + f"; cycles a step: {ph}; total {r['cycles_per_step_total']:.0f} over "
                  f"{r['warps']} warps in {r['waves']} waves, {r['implied_sm_ghz']:.3f} GHz "
                  f"implied; timing build replayed {r['timing_build_replay']}",
                  flush=True)
    print(smi)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
