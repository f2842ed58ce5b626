#!/usr/bin/env python3
"""Times of the bf16 GEMM behind fused_block (#1) and fused_block_residuals
(#2), of #1 and #2, and of the int8 GEMM behind fused_block_int8 (#3), in
the checkout this script sits in, on one NVIDIA GPU:

    python3 scripts/chip_gemm_times.py [label] [--tiles] [--int8]

For each projection of CASES (chip_smoke.py's GEMM_CASES and the text
serving rows) it times the ``cet_gemm`` C entry (called straight, so that
checkouts whose Python wrappers differ compare) and
``torch.nn.functional.linear`` at the same shape (the yardstick, timed
only); then #1 and #2 at chip_smoke.py's BLOCK_CASES.
Each per call as chip_smoke.py takes it (CUDA events over back-to-back
calls after a warm-up, host work included), repeated, and on the device
alone (torch.profiler, summed over the calls). With ``--tiles`` it also
builds variants of this checkout's ``csrc/fused_block.cu`` with the
launcher's tile width fixed (128, 64), each with its persistent grid
(one block per SM) and with a plain grid (one block per output tile), and
times their ``cet_gemm`` on the device at the same shapes. Run it from two
checkouts in turns (A, B, B, A) to compare them on one card (a checkout
older than chip_smoke.py's GEMM_CASES takes this checkout's chip_smoke.py
beside the script). Then the int8 GEMM the same way at chip_smoke.py's
GEMM_S8_CASES: the ``cet_gemm_s8`` C entry called straight (quick GELU)
and ``torch._int_mm`` (cuBLASLt's int8 product without the epilogue, the
yardstick, timed only), and with ``--tiles`` the int8 launcher's
variants likewise; ``--int8`` times only the int8 cases. Exits with code
2 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from scripts.chip_attention_times import device_ms  # noqa: E402

REPEATS, ITERS = 3, 20
# chip_smoke.py's GEMM_CASES, and the text tower's rows of the CLI's
# requests of 8 (640 = 8 x 80, d 768), where the launcher takes the
# narrower tile
CASES = cs.GEMM_CASES + tuple(
    (f"{name} 640x{n}x{k}", 640, n, k, epilogue) for name, n, k, epilogue in (
        ("qkv", 2304, 768, "bias"), ("out", 768, 768, "residual"),
        ("fc", 3072, 768, "act"), ("proj", 768, 3072, "residual")))
# csrc/fused_block.cu's epilogue codes (0-3 since the GEMM was written)
EPI = {"bias": 0, "act": 1, "residual": 2, "act_pre": 3}
# csrc/fused_block_int8.cu's epilogue codes (0-2 since the GEMM was written)
EPI_S8 = {"bf16": 0, "act_q8": 1, "residual": 2}
# the launcher's choices that a variant fixes
TILE_CHOICE = re.compile(r"switch \(pick_bn\([^)]*\)\)")
GRID_CHOICE = "std::min(tiles, sms)"


def gemm_launch(entry, epilogue, a, w, bias, res):
    """A call of one cet_gemm launch through the C function ``entry``
    (stream last) into preallocated outputs, quick GELU."""
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty(m, n, dtype=a.dtype, device=a.device)
    pre = torch.empty_like(out) if epilogue == "act_pre" else None
    res = res if epilogue == "residual" else None
    ptrs = (a.data_ptr(), w.data_ptr(), bias.data_ptr(),
            None if res is None else res.data_ptr(), out.data_ptr(),
            None if pre is None else pre.data_ptr())

    def call():
        rc = entry(*ptrs, m, n, k, EPI[epilogue], 0,
                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cet_gemm: CUDA error {rc}")
    return call


def gemm_s8_launch(entry, epilogue, a_idx, a, w, wscale, bias, scales,
                   res):
    """A call of one cet_gemm_s8 launch through the C function ``entry``
    (stream last) into a preallocated output, quick GELU."""
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty(m, n, device=a.device, dtype=torch.int8
                      if epilogue == "act_q8" else torch.bfloat16)
    ptrs = (a.data_ptr(), w.data_ptr(), wscale.data_ptr(), bias.data_ptr(),
            scales.data_ptr(), a_idx,
            res.data_ptr() if epilogue == "residual" else None,
            out.data_ptr())

    def call():
        rc = entry(*ptrs, m, n, k, EPI_S8[epilogue], 0,
                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"cet_gemm_s8: CUDA error {rc}")
    return call


def time_gemms_s8(label, gpu, rng, tiles=False):
    """The int8 GEMM and torch._int_mm at GEMM_S8_CASES; with ``tiles``
    also the int8 launcher's fixed-width and plain-grid variants."""
    from clip_embeds_tpu_torch.ops import _build

    entry = _build.library().cet_gemm_s8
    variants = (build_variants("fused_block_int8.cu", "cet_gemm_s8")
                if tiles else {})
    for name, m, n, k, epilogue, a_idx in cs.GEMM_S8_CASES:
        a, w, wscale, bias, scales, res = cs.gemm_s8_inputs(rng, m, n, k)
        tops = 2 * m * n * k / 1e9
        calls = {"cet_gemm_s8": gemm_s8_launch(
            entry, epilogue, a_idx, a, w, wscale, bias, scales, res),
                 "_int_mm": lambda: torch._int_mm(a, w.t())}
        for what, fn in calls.items():
            try:
                per_call = [cs.cuda_ms(fn) for _ in range(REPEATS)]
            except RuntimeError as e:  # the yardstick only
                if what == "cet_gemm_s8":
                    raise
                print(f"[times] {label} {what} {name}: none ({e})")
                continue
            dev = device_ms(fn, ITERS)
            print(f"[times] {label} {what} {name} {epilogue}: per call "
                  f"{' '.join(f'{t:.4f}' for t in per_call)} ms (CUDA "
                  f"events, 10 calls each), device {dev:.4f} ms, "
                  f"{rate(tops, dev).replace('FLOP', 'OP')} on {gpu}")
        for (bn, plain), fn in variants.items():
            dev = device_ms(gemm_s8_launch(fn, epilogue, a_idx, a, w, wscale,
                                           bias, scales, res), ITERS)
            print(f"[tiles] {label} cet_gemm_s8 BN={bn} "
                  f"{'plain' if plain else 'persistent'} {name} {epilogue}: "
                  f"device {dev:.4f} ms, "
                  f"{rate(tops, dev).replace('FLOP', 'OP')} on {gpu}")
        del a, w, wscale, bias, scales, res, calls


def rate(tflops, ms):
    """TFLOP/s of ``tflops`` * 1e12 operations in ``ms``; the profiler
    misses a kernel now and then and reports no device time."""
    return f"{tflops / ms:.1f} TFLOP/s" if ms > 0 else "TFLOP/s not measured"


def build_variants(source="fused_block.cu", entry="cet_gemm"):
    """{(tile width, plain grid): C entry ``entry``} of variants of this
    checkout's GEMM in ``source``, built in parallel with ops/_build.py's
    flags."""
    from clip_embeds_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, source)) as fh:
        src = fh.read()
    if not TILE_CHOICE.search(src) or GRID_CHOICE not in src:
        raise RuntimeError("the launcher's tile and grid choices moved")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    for header in ("hopper.cuh", "common.cuh"):
        shutil.copy(os.path.join(_build.CSRC_DIR, header), tmp)
    procs = {}
    for bn in (128, 64):
        for plain in (False, True):
            text = TILE_CHOICE.sub(f"switch ({bn})", src)
            if plain:
                text = text.replace(GRID_CHOICE, "tiles")
            stem = os.path.join(tmp, f"gemm_{bn}_{int(plain)}")
            with open(stem + ".cu", "w") as fh:
                fh.write(text)
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                   stem + ".so", stem + ".cu"]
            procs[bn, plain] = (stem, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    variants = {}
    for key, (stem, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key} failed to build:\n{log}")
        fn = getattr(ctypes.CDLL(stem + ".so"), entry)
        fn.argtypes = _build._ARGTYPES[entry]
        fn.restype = ctypes.c_int
        variants[key] = fn
    return variants


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_gemm_times: no CUDA device", file=sys.stderr)
        return 2
    from clip_embeds_tpu_torch.ops import _build
    from clip_embeds_tpu_torch.ops.fused_block import (
        fused_block, fused_block_residuals)

    args = [a for a in sys.argv[1:] if a not in ("--tiles", "--int8")]
    label = args[0] if args else "this checkout"
    gpu = cs.gpu_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    entry = _build.library().cet_gemm
    rng = np.random.default_rng(0)
    tiles = "--tiles" in sys.argv
    if "--int8" in sys.argv:
        with torch.no_grad():
            time_gemms_s8(label, gpu, rng, tiles)
        return 0
    variants = build_variants() if tiles else {}
    with torch.no_grad():
        for name, m, n, k, epilogue in CASES:
            a, w, bias, res = cs.gemm_inputs(rng, m, n, k)
            tflops = 2 * m * n * k / 1e9
            calls = {"cet_gemm": gemm_launch(entry, epilogue, a, w, bias,
                                             res),
                     "F.linear": lambda: F.linear(a, w, bias)}
            for what, fn in calls.items():
                per_call = [cs.cuda_ms(fn) for _ in range(REPEATS)]
                dev = device_ms(fn, ITERS)
                print(f"[times] {label} {what} {name} {epilogue}: per call "
                      f"{' '.join(f'{t:.4f}' for t in per_call)} ms (CUDA "
                      f"events, 10 calls each), device {dev:.4f} ms, "
                      f"{rate(tflops, dev)} on {gpu}")
            for (bn, plain), fn in variants.items():
                dev = device_ms(gemm_launch(fn, epilogue, a, w, bias, res),
                                ITERS)
                print(f"[tiles] {label} BN={bn} "
                      f"{'plain' if plain else 'persistent'} {name} "
                      f"{epilogue}: device {dev:.4f} ms, "
                      f"{rate(tflops, dev)} on {gpu}")
            del a, w, bias, res, calls
        for (b, n, d, heads, kv, causal), *_ in cs.BLOCK_CASES:
            block = cs.block_inputs(rng, b, n, d, 4 * d)
            kw = dict(heads=heads, kv_valid=kv, quick_gelu=True,
                      causal=causal)
            for what, fn in (
                    ("fused_block", lambda: fused_block(*block, **kw)),
                    ("fused_block_residuals",
                     lambda: fused_block_residuals(*block, **kw))):
                per_call = [cs.cuda_ms(fn) for _ in range(REPEATS)]
                dev = device_ms(fn, ITERS)
                print(f"[times] {label} {what} {b}x{n}x{d} causal={causal}:"
                      f" per call {' '.join(f'{t:.4f}' for t in per_call)} "
                      f"ms (CUDA events, 10 calls each), device {dev:.4f} ms"
                      f" on {gpu}")
        time_gemms_s8(label, gpu, rng, tiles)
    return 0


if __name__ == "__main__":
    sys.exit(main())
