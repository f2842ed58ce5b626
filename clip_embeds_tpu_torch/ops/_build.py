"""Build and bind the port's CUDA kernels (``clip_embeds_tpu_torch/csrc``).

At first use, ``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a``, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with ``ctypes``.
The library's file name carries a hash of the sources and the compiler
flags, so an edit rebuilds; the output goes to ``clip_embeds_tpu_torch/
_build/`` (git-ignored). There is no fallback: a missing ``nvcc`` or a
failed build raises.

Each C entry launches on the caller's stream and returns
``cudaGetLastError()``; :func:`launch` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_p, _i, _f, _ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
# C signature of each entry; the trailing pointer is the CUDA stream.
_ARGTYPES = {
    "cet_layernorm": [_p, _p, _p, _p, _i, _i, _f, _p],
    "cet_gemm": [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
    "cet_attention": [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _f,
                      _ll, _ll, _ll, _ll, _ll, _ll, _p],
    "cet_attention_bwd": [_p] * 10 + [_i] * 6 + [_f] + [_ll] * 12 + [_p],
    "cet_layernorm_s8": [_p, _p, _p, _p, _i, _p, _i, _i, _f, _p],
    "cet_quantize_s8": [_p, _p, _i, _p, _ll, _p],
    "cet_gemm_s8": [_p, _p, _p, _p, _p, _i, _p, _p, _i, _i, _i, _i, _i, _p],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> str:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libcet_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless the library for these sources exists."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(cmd, proc.communicate()[0], proc.returncode)
                for cmd, proc in procs]
        so = os.path.join(tmp, "lib.so")
        if all(rc == 0 for _, _, rc in logs):
            cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            logs.append((cmd, proc.stdout + proc.stderr, proc.returncode))
        failed = [(cmd, log, rc) for cmd, log, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("\n".join(
                f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{log}"
                for cmd, log, rc in failed))
        os.replace(so, out)  # atomic: a concurrent build sees all or nothing
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current CUDA stream; raise on error."""
    import torch

    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(library(), name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
