"""Run a kernel source of ``csrc/`` on the CPU, to rehearse its logic.

The source and the ``csrc/*.cuh`` headers are translated into C++ against
``tools/cuda_emu.h``, compiled with g++ into a shared library in the
gitignored ``ravvent_tpu_torch/build/emu/``, and loaded with ctypes. The
library has the source's C entry points, bound as ``ops/cuda_lib.py`` binds
them, and takes host pointers (CPU tensors' ``data_ptr()``; the stream is
ignored). Each CUDA thread is a fiber on the launching host thread (its
own stack; a switch saves registers, with no system call), and a CTA's
fibers run in turn, each until it waits at a barrier; a launch makes its
fibers once and runs them again for each CTA, one CTA at a time, or one
cluster at a time, its CTAs' fibers together (``cudaLaunchKernelEx`` with
a cluster dimension; the emulated card holds clusters of 2 CTAs at most,
and 1 MiB of shared memory a block). A launch so takes one core, whatever
the CTA's threads, and a loaded host does not stall its barriers; a
barrier no thread can complete aborts the process with
``cuda_emu: deadlock`` on stderr; ``cp.async`` copies at once, and so does a
1-D bulk copy (TMA, ``cp.async.bulk`` on an mbarrier), whose mbarrier wait
returns at once. The cluster kernels' PTX (csrc/beam_loop.cu: the cluster
barrier, ``mapa.u64`` to a peer CTA's shared memory, read and written as
distributed shared memory, the multicast bulk copy into every CTA of its
mask; the wide f32 BiLSTM kernel's h exchange: ``mapa.shared::cluster.u32`` and
the bulk copy from a CTA's shared memory into a peer's) runs on mbarriers
that keep their phase and transaction count, whose waits block until the
phase completes;
``mma.sync.m16n8k16`` on bf16 (f32 accumulator) exchanges the warp's
fragments as ``__shfl_sync`` does. So the emulation shows a kernel's
indexing, shared-memory and fragment layouts and control flow against its
plain version, on a machine with no card and no nvcc. It says nothing of
speed or of races between asynchronous copies (a copy lands when it is
issued), and it knows no other inline PTX (no ``ldmatrix``, ``wgmma`` or TMA
tensor maps).

Usage::

    lib = cuda_emu.load(*cuda_emu.STEP_SOURCES)  # the beam step's nine sources
    rc = lib.rv_beam_attend_i8(...)  # as cuda_lib.lib().rv_beam_attend_i8
    loop = cuda_emu.load(*cuda_emu.LOOP_SOURCES)  # the whole-loop kernel's two layouts
    step = cuda_emu.load("decode_step.cu")  # the greedy decode step
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
# the beam step's sources: the cell and the C entries, then the attend
# kernel's instances a memory mode, those of 32 beams apart
STEP_SOURCES = ("beam_step_f.cu", "beam_attend_bf16.cu", "beam_attend_f32.cu",
                "beam_attend_i8.cu", "beam_attend_i8mxu.cu", "beam_attend_bf16_w32.cu",
                "beam_attend_f32_w32.cu", "beam_attend_i8_w32.cu", "beam_attend_i8mxu_w32.cu")
# the whole-loop kernel's sources: the resident layout and the C entries,
# then the streamed layout
LOOP_SOURCES = ("beam_loop.cu", "beam_loop_streamed.cu")
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

# The cluster kernels' PTX (csrc/beam_loop.cu; the wide f32 BiLSTM kernel's h
# exchange, csrc/bilstm_wide.cu), each as the emulation's call on the
# statement's operands, in order; their mbarriers keep real phases.
_OPERAND = r'\s*"[+=]?[rlh]"\((\w+)\)'
_CLUSTER_PTX = [
    (r"mbarrier\.init\.shared::cta\.b64 \[%0\], %1;", "emu_mbar_init({0}, {1});"),
    (r"mbarrier\.arrive\.expect_tx\.release\.cta\.shared::cta\.b64 _, \[%0\], %1;",
     "emu_mbar_arrive_tx({0}, {1});"),
    (r"mapa\.u64 %0, %1, %2;", "{0} = emu_mapa({1}, {2});"),
    (r"[^\"]*mbarrier\.try_wait\.parity\.acquire\.cta[^\"]*", "{0} = emu_mbar_try_wait({1}, {2});"),
    (r"cp\.async\.bulk\.shared::cluster\.global\.mbarrier::complete_tx::bytes\.multicast::cluster "
     r"\[%0\], \[%1\], %2, \[%3\], %4;", "emu_bulk_multicast({0}, {1}, {2}, {3}, {4});"),
    (r"mapa\.shared::cluster\.u32 %0, %1, %2;", "{0} = emu_rank({1}, {2});"),
    (r"cp\.async\.bulk\.shared::cluster\.shared::cta\.mbarrier::complete_tx::bytes "
     r"\[%0\], \[%1\], %2, \[%3\];", "emu_bulk_to_peer({0}, {1}, {2}, {3});"),
    (r"barrier\.cluster\.arrive\.release\.aligned;", "emu_cluster_arrive();"),
    (r"barrier\.cluster\.wait\.acquire\.aligned;", "emu_cluster_wait();"),
]


def _cluster_ptx(text: str) -> str:
    for ptx, call in _CLUSTER_PTX:
        pattern = re.compile(r'asm volatile\("' + ptx + r'(?:\\n)?"([^;]*?)\);', re.S)

        def sub(m, call=call):
            return call.format(*re.findall(_OPERAND, m.group(1)))
        text = pattern.sub(sub, text)
    return text


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
    text = re.sub(r'#include "(\w+)\.cuh"', r'#include "\1_emu.cuh"', text)
    text = _cluster_ptx(text)
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
    text = text.replace("extern __shared__ __align__(16) unsigned char smem_raw[];",
                        "unsigned char* smem_raw = reinterpret_cast<unsigned char*>(emu_smem());")
    return f'#include "{HEADER}"\n' + text


def load(source: str, *more: str) -> ctypes.CDLL:
    """The emulation of ``csrc/<source>``, linked with the sources ``more``
    whose entry points it calls (the beam step: ``load(*STEP_SOURCES)``),
    built when a source, the shared headers or the emulation header is newer
    than the library. Each source is compiled by its own g++ process, all
    started together."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the emulation is built with g++")
    srcs = [cuda_lib.CSRC / s for s in (source, *more)]
    lib_path = BUILD / f"lib{'+'.join(s.stem for s in srcs)}_emu.so"
    inputs = srcs + [HEADER, Path(__file__)] + cuda_lib.headers()
    if not lib_path.exists() or any(p.stat().st_mtime > lib_path.stat().st_mtime for p in inputs):
        work = BUILD / f"{srcs[0].stem}.{os.getpid()}"
        work.mkdir(parents=True, exist_ok=True)
        for h in cuda_lib.headers():  # the shared headers, translated alike
            (work / f"{h.stem}_emu.cuh").write_text(translate(h.read_text()))
        flags = ["-std=c++20", "-O1", "-fPIC", "-pthread", "-fsanitize=alignment",
                 "-fno-sanitize-recover=alignment", "-Wno-unknown-pragmas", f"-I{work}"]
        objs, procs = [], []
        for src in srcs:
            cpp, obj = work / f"{src.stem}.cpp", work / f"{src.stem}.o"
            cpp.write_text(translate(src.read_text()))
            objs.append(obj)
            procs.append(subprocess.Popen([gxx, *flags, "-c", "-o", str(obj), str(cpp)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate(timeout=600)[0] for p in procs]
        errors = [f"{s.name}:\n{out}" for s, p, out in zip(srcs, procs, outs) if p.returncode]
        if errors:
            raise RuntimeError("g++ failed for the emulation of " + "\n".join(errors))
        tmp = work / lib_path.name
        res = subprocess.run([gxx, *flags, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to link the emulation of {source}:\n{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: a concurrent process never sees half a file
        shutil.rmtree(work)
    return cuda_lib.bind(ctypes.CDLL(str(lib_path)))
