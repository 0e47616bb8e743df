"""How fast the H100 reads a beam step's memory in three access patterns.

The beam step's attention reads every batch row's keys and values once
(487 MB a step at B = 4096, S = 232, U = 128 in bf16), so the way its
threads read them bounds the step. tools/read_patterns.cu times three
patterns over the same bf16 [B, S, 128] keys and values, one batch row a
CTA of 64 threads: ``thread_row`` (a thread reads its position's 256-byte
row, 16 loads of 16 bytes in flight), ``coalesced`` (consecutive threads,
consecutive 16-byte chunks) and ``cp_async_blocks`` (coalesced cp.async
into shared-memory blocks of 32 positions, as csrc/beam_step_f.cu's
beam_attend reads them). Prints each pattern's mean ms and TB/s (CUDA
events, 20 launches after one warm-up) and the card's name and power limit.
Needs a CUDA device and nvcc.

Usage: python -m ravvent_tpu_torch.tools.read_patterns [--batch 4096] [--positions 232]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ravvent_tpu_torch.ops import cuda_lib

PATTERNS = ("thread_row", "coalesced", "cp_async_blocks")


def build() -> ctypes.CDLL:
    src = Path(__file__).with_suffix(".cu")
    lib = cuda_lib.BUILD / "libravvent_read_patterns.so"
    cuda_lib.BUILD.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_lib.nvcc_path(), cuda_lib.ARCH, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", str(src), "-o", str(lib)], check=True, timeout=600)
    handle = ctypes.CDLL(str(lib))
    handle.rv_read_pattern.restype = ctypes.c_int
    handle.rv_read_pattern.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    return handle


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--positions", type=int, default=232)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("read_patterns: no CUDA device", file=sys.stderr)
        return 1
    lib = build()
    B, S = args.batch, args.positions
    gen = torch.Generator(device="cuda").manual_seed(0)
    keys = torch.randn(B, S, 128, generator=gen, device="cuda").bfloat16()
    values = torch.randn(B, S, 128, generator=gen, device="cuda").bfloat16()
    out = torch.empty(B * 64, device="cuda")
    nbytes = 2 * keys.numel() * keys.element_size()
    stream = torch.cuda.current_stream().cuda_stream
    for kind, name in enumerate(PATTERNS):
        def run(kind=kind, name=name):
            cuda_lib.check(lib.rv_read_pattern(kind, B, S, keys.data_ptr(), values.data_ptr(),
                                               out.data_ptr(), stream), name)
        run()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 20
        print(f"{name}: {ms:.4f} ms for {nbytes / 1e6:.1f} MB, {nbytes / ms / 1e9:.3f} TB/s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
