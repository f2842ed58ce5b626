"""Build and load the native image library (counterpart of
``clip_embeds_tpu/native/build.py``).

At first use ``g++`` compiles ``resize.cpp`` and ``decode.cpp`` (byte-equal
copies of the JAX package's) into one shared library under
``clip_embeds_tpu_torch/_build/`` (git-ignored), never into the source
directory. The file name carries a hash of the sources, the command and the
CPU that ``-march=native`` resolves to, so an edit or another host
rebuilds. Each build writes a temporary file and renames it into place, so
processes that build at once all load a whole library.

Without the library (no ``g++``, no libjpeg/libpng/libwebp headers) the
image loader decodes with PIL. That is never silent: a failed build prints
the compiler's error once on stderr, and the CLIs name the decoder that ran
(:func:`decoder_name`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading
from typing import Optional

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build")
_SOURCES = ("resize.cpp", "decode.cpp")
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
          "-pthread"]
_LINK_LIBS = ["-ljpeg", "-lpng", "-lwebp"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_FAILED = False

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "resize_normalize_batch": ([_p, _i, _i, _i, _p, _i, _i, _p, _p, _i, _i],
                               None),
    "resize_normalize_one": ([_p, _i, _i, _p, _i, _i, _p, _p, _i], None),
    "decode_preprocess_batch": ([ctypes.POINTER(_p), _p, _i, _p, _i, _p, _p,
                                 _i, _i, _i, _i, _p], _i),
    "probe_image": ([_p, ctypes.c_size_t, _p, _p], _i),
}


def _target_cpu() -> str:
    """What ``-march=native`` resolves to on this host."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, check=True, text=True).stdout
    return "".join(ln for ln in out.splitlines(True)
                   if ln.strip().startswith(("-march=", "-mtune=")))


def library_path() -> str:
    """Path of the library for the current sources, command and CPU."""
    h = hashlib.sha256(" ".join(_FLAGS + _LINK_LIBS).encode())
    h.update(_target_cpu().encode())
    for src in _SOURCES:
        with open(os.path.join(_SRC_DIR, src), "rb") as fh:
            h.update(src.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libcet_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless the one for these sources exists; raise
    ``subprocess.CalledProcessError`` (with g++'s output) on failure."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(
            ["g++", *_FLAGS, "-o", tmp,
             *(os.path.join(_SRC_DIR, s) for s in _SOURCES), *_LINK_LIBS],
            check=True, capture_output=True, text=True)
        os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load_library() -> Optional[ctypes.CDLL]:
    """Build (once) and load the library; None if it cannot be, after
    printing why on stderr the first time."""
    global _LIB, _FAILED
    with _LOCK:
        if _LIB is None and not _FAILED:
            try:
                lib = ctypes.CDLL(build())
            except (OSError, subprocess.CalledProcessError) as exc:
                detail = getattr(exc, "stderr", None) or str(exc)
                print(f"native image library unavailable, decoding with "
                      f"PIL:\n{detail}", file=sys.stderr)
                _FAILED = True
                return None
            for name, (argtypes, restype) in _ARGTYPES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _LIB = lib
    return _LIB


def decoder_name() -> str:
    """'native' when the library loads, else 'pil'."""
    return "native" if load_library() is not None else "pil"
