"""Matrix products in a lower precision than the configuration states, for
the control of the correctness check, as fp8 training computes them
(NVIDIA Transformer Engine's recipe): the forward's operands rounded to
float8 e4m3 and the backward's incoming gradient to e5m2, each under a
per-tensor scale that maps its largest magnitude to the format's largest
value; every product then taken in fp32."""

from __future__ import annotations

import torch

FORMATS = {"e4m3": (torch.float8_e4m3fn, 448.0),
           "e5m2": (torch.float8_e5m2, 57344.0)}


def rounded(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under a per-tensor scale, back in fp32."""
    dtype, top = FORMATS[fmt]
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).float() / scale


class _FP8MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a8, b8 = rounded(a, "e4m3"), rounded(b, "e4m3")
        ctx.save_for_backward(a8, b8)
        return torch.matmul(a8, b8)

    @staticmethod
    def backward(ctx, grad):
        a8, b8 = ctx.saved_tensors
        g8 = rounded(grad, "e5m2")
        ga = torch.matmul(g8, b8.transpose(-1, -2))
        gb = torch.matmul(a8.transpose(-1, -2), g8)
        # undo the broadcast of a batched product, as matmul's own backward
        while ga.dim() > 0 and ga.dim() > a8.dim():
            ga = ga.sum(0)
        while gb.dim() > 0 and gb.dim() > b8.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _FP8MatMul.apply(a, b)


MATMULS = {"fp32": torch.matmul, "fp8": fp8_matmul}
