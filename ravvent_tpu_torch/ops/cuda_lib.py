"""Build and bind the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain ``extern "C"`` interface and includes
no PyTorch header (only the ``csrc/*.cuh`` helpers), so it compiles in
seconds. On first use each source is
compiled by its own ``nvcc`` process (all started together) for ``sm_90a``,
the objects are linked into one shared library in the gitignored
``ravvent_tpu_torch/build/`` directory, and the library is loaded with
``ctypes``. Every pointer and the stream cross as ``ctypes.c_void_p``.

``launches`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel, so a run can show that it went through the kernels.
``beam_step`` counts the steps on bf16/f32 memory, each one ``beam_cell``
and one ``beam_attend`` launch; ``beam_step_i8`` / ``beam_step_i8mxu`` the
steps on int8 memory, each one ``beam_cell`` and one ``beam_attend_i8`` /
``beam_attend_i8mxu`` launch. ``peak_scan`` counts both kernels of
``csrc/peak_scan.cu``, so a call of its wrapper adds two (the scan, then the
check). ``bilstm_plain_route`` is no kernel: it counts the BiLSTM layers
of CUDA tensors that ran their plain version because the kernels do not take
their shape (models/rnn.py:encoder_apply, ops/rnn_cuda.py:kernel_takes).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
LIB_PATH = BUILD / "libravvent_kernels.so"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"

launches: Dict[str, int] = {"bilstm": 0, "bilstm_bf16": 0, "beam_step": 0, "beam_cell": 0,
                             "beam_attend": 0, "beam_step_i8": 0, "beam_step_i8mxu": 0,
                             "beam_attend_i8": 0, "beam_attend_i8mxu": 0, "beam_loop": 0,
                             "decode_step": 0, "peak_scan": 0, "bilstm_plain_route": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_log = ""


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine with the card")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build(force: bool = False) -> str:
    """Compile every source (one nvcc each, in parallel) and link the shared
    library. Returns the compilers' output, which includes ``-Xptxas -v``'s
    registers and shared memory per kernel. Raises on any compiler error."""
    global _build_log
    srcs = sources()
    if (not force and LIB_PATH.exists()
            and all(LIB_PATH.stat().st_mtime >= s.stat().st_mtime for s in srcs + headers())):
        return _build_log
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    tag = f"{os.getpid()}"
    objs = [BUILD / f"{s.stem}.{tag}.o" for s in srcs]
    procs = [
        subprocess.Popen(
            [nvcc, ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-c", str(s), "-o", str(o)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for s, o in zip(srcs, objs)
    ]
    logs = []
    failed = []
    for s, p in zip(srcs, procs):
        out, _ = p.communicate(timeout=600)
        logs.append(f"== {s.name}\n{out}")
        if p.returncode != 0:
            failed.append(s.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
    tmp = BUILD / f"{LIB_PATH.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", str(tmp)] + [str(o) for o in objs],
        capture_output=True, text=True, timeout=300,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}\n{link.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent process never sees half a file
    for o in objs:
        o.unlink()
    _build_log = "\n".join(logs)
    return _build_log


# argtypes of each C entry point: ctypes.c_int for an int, c_float for a
# float, c_void_p for each pointer and the stream (without them ctypes passes a pointer as a 32-bit
# int and cuts it)
_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
ENTRIES = {
    "rv_bilstm_layer": [_P] + [_I] * 5 + [_P] * 8 + [_P],
    "rv_bilstm_layer_bf16": [_P] + [_I] * 5 + [_P] * 8 + [_P],
    "rv_beam_cell": [_I] * 3 + [_P] * 12,
    "rv_beam_attend": [_I] * 8 + [_P] * 18,
    "rv_beam_attend_i8": [_I] * 8 + [_P] * 20,
    "rv_beam_attend_info": [_I] * 5 + [_P],
    "rv_beam_loop": [_I] * 11 + [_P] * 13,
    "rv_beam_loop_clusters": [_I] * 6 + [_P],
    "rv_decode_step": [_I] * 5 + [_P] * 18,
    "rv_peak_scan_blocks": [_I] * 4 + [_F] * 3 + [_P] * 6,
    "rv_peak_scan_check": [_I] * 4 + [_F] * 3 + [_P] * 7,
    "rv_peak_scan_state_bytes": [],
}


def bind(handle: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of each entry point ``handle`` has."""
    for name, argtypes in ENTRIES.items():
        if hasattr(handle, name):
            fn = getattr(handle, name)
            fn.restype = _I
            fn.argtypes = argtypes
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            _lib = bind(ctypes.CDLL(str(LIB_PATH)))
        return _lib


def check_tensors(name: str, device, expect) -> None:
    """Raise ValueError unless every ``(label, tensor, dtype, shape)`` of
    ``expect`` is a contiguous tensor of that dtype and shape on ``device``."""
    for label, t, dt, shape in expect:
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous {dt} tensor on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {label} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")
