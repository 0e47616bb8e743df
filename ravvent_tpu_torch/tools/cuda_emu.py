"""Run a kernel source of ``csrc/`` on the CPU, to rehearse its logic.

The source and ``csrc/common.cuh`` are translated into C++ against
``tools/cuda_emu.h``, compiled with g++ into a shared library in the
gitignored ``ravvent_tpu_torch/build/emu/``, and loaded with ctypes. The
library has the source's C entry points, bound as ``ops/cuda_lib.py`` binds
them, and takes host pointers (CPU tensors' ``data_ptr()``; the stream is
ignored). Each CTA runs as one thread per CUDA thread, one CTA at a time;
``cp.async`` copies at once, and so does a 1-D bulk copy (TMA,
``cp.async.bulk`` on an mbarrier), whose mbarrier wait returns at once;
``mma.sync.m16n8k16`` on bf16 (f32 accumulator) exchanges the warp's
fragments as ``__shfl_sync`` does. So the emulation shows a kernel's
indexing, shared-memory and fragment layouts and control flow against its
plain version, on a machine with no card and no nvcc. It says nothing of
speed, of races between asynchronous copies or of mbarrier phases, and it
knows no other inline PTX (no ``ldmatrix``, ``wgmma``, TMA tensor maps or
clusters).

Usage::

    lib = cuda_emu.load("beam_step_f.cu")
    rc = lib.rv_beam_attend_i8(...)  # as cuda_lib.lib().rv_beam_attend_i8
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

from ravvent_tpu_torch.ops import cuda_lib

HEADER = Path(__file__).resolve().with_name("cuda_emu.h")
BUILD = cuda_lib.BUILD / "emu"

# csrc/'s cp.async helpers: "cp.async.c{a,g}.shared.global [dst], [src], bytes"
_CP_ASYNC = (r'asm volatile\("cp\.async\.c[ag]\.shared\.global \[%0\], \[%1\], (\d+);\\n"'
             r' ::"r"\(s\), "l"\(src\)\);')
# the bf16 tensor-core tile: asm volatile("mma.sync...f32 {...};\n" : outputs : inputs);
_MMA = re.compile(r'asm volatile\("mma\.sync\.aligned\.m16n8k16\.row\.col\.f32\.bf16\.bf16\.f32 '
                  r'[^"]*"\s*:(.*?);', re.S)


# a bulk copy (TMA) into shared memory on an mbarrier: a copy here
_BULK = re.compile(r'asm volatile\("cp\.async\.bulk\.shared::cluster\.global\.mbarrier::complete_tx::bytes '
                   r'[^"]*"\s*::[^;]*\);')
# an mbarrier's try_wait into its output register: done at once here
_TRY_WAIT = re.compile(r'asm volatile\("[^"]*mbarrier\.try_wait[^"]*"\s*:\s*"=r"\((\w+)\)[^;]*\);')


def _mma_call(m: re.Match) -> str:
    """The emulation's call for one mma asm statement: its ten operands
    (four accumulators, four A words, two B words) in order."""
    ops = re.findall(r'"[+=]?[frl]"\(([^()]*)\)', m.group(1))
    if len(ops) != 10:
        raise ValueError(f"cuda_emu: cannot read the mma operands of {m.group(0)!r}")
    return f"emu_mma_m16n8k16_bf16({', '.join(ops)});"


def translate(text: str) -> str:
    """A CUDA source as C++ for the emulation: no CUDA headers, cp.async and
    the bulk copy as copies, an mbarrier's try_wait as done, mma as the
    emulation's call, other inline PTX dropped, ``k<<<grid, threads, smem, stream>>>(...)``
    as ``emu_launch(k, grid, threads, smem, stream, ...)``, the dynamic
    shared buffer from the emulated CTA."""
    text = text.replace("#include <cuda_bf16.h>", "").replace("#include <cuda_runtime.h>", "")
    text = text.replace('#include "common.cuh"', '#include "common_emu.cuh"')
    text = re.sub(_CP_ASYNC, r"memcpy(dst, src, \1); (void)s;", text)
    text = _MMA.sub(_mma_call, text)
    text = _BULK.sub("memcpy(dst, src, bytes);", text)
    text = _TRY_WAIT.sub(r"\1 = 1;", text)
    text = re.sub(r'asm volatile\(".*?"[^;\n]*\);', ";", text)
    text = re.sub(r"([\w:]+(?:<[^<>()]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text,
                  flags=re.S)
    for decl in ("extern __shared__ __align__(16) float smem[];",
                 "extern __shared__ float smem[];"):
        text = text.replace(decl, "float* smem = emu_smem();")
    return f'#include "{HEADER}"\n' + text


def load(source: str) -> ctypes.CDLL:
    """The emulation of ``csrc/<source>``, built when the source, the
    shared header or the emulation header is newer than the library."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the emulation is built with g++")
    src = cuda_lib.CSRC / source
    lib_path = BUILD / f"lib{src.stem}_emu.so"
    inputs = [src, HEADER, Path(__file__)] + cuda_lib.headers()
    if not lib_path.exists() or any(p.stat().st_mtime > lib_path.stat().st_mtime for p in inputs):
        tag = f"{src.stem}.{os.getpid()}"
        work = BUILD / tag
        work.mkdir(parents=True, exist_ok=True)
        for h in cuda_lib.headers():  # the shared header, translated alike
            (work / f"{h.stem}_emu.cuh").write_text(translate(h.read_text()))
        cpp = work / f"{src.stem}.cpp"
        cpp.write_text(translate(src.read_text()))
        tmp = work / lib_path.name
        res = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
                              "-Wno-unknown-pragmas", f"-I{work}", "-o", str(tmp), str(cpp)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed for the emulation of {source}:\n{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent process never sees half a file
        shutil.rmtree(work)
    return cuda_lib.bind(ctypes.CDLL(str(lib_path)))
