"""The comparisons that decide ``correct``, and the numbers they read.

* Embeddings (every row the entry returned, each against the reference's
  embedding of the pool row it came from): the worst row's
  1 - cos(port, reference), and the norm of the rows' mean error.
* Training (the first three steps of the window's own state and feed):
  the largest gap of a step's loss; the first gradient's and the three
  updates' change by the worst leaf, each leaf's gap between the port's
  norm and the reference's, over the larger of the reference's norm of
  that leaf and of the median leaf. A packed q/k/v bias counts as its
  three vectors. Leaves whose reference gradient is under a thousandth of
  the median leaf's (a key's bias under softmax) move by round-off alone
  and are left out of the change.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

NOUGHT = 1e-3   # a reference gradient under this x the median leaf's


@contextlib.contextmanager
def fp32_reference():
    """Plain fp32 products for the reference (no TF32), restored after."""
    mm, cd = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def embedding_checks(out: np.ndarray, ref: torch.Tensor,
                     chunk: int = 65536) -> Dict[str, float]:
    """Every row of ``out`` (the entry's float32 [N, D] on the host)
    against ``ref`` (the reference's [P, D] rows of the pool, in pool
    order): the pool is offered whole and cycled, so row j embeds pool row
    j % P. In fp64 on ``ref``'s device: 'worst_1mcos', the largest
    1 - cos(port row, reference row); 'mean_error', the norm of the rows'
    mean error (port - reference), which rounding spread over the rows
    averages away and a systematic error (weights held in a lower
    precision) does not; 'centered_error', the norm of the error of the
    rows less their mean over that of the reference's rows less theirs."""
    n, p = len(out), len(ref)
    if n == 0 or out.shape[1:] != tuple(ref.shape[1:]):
        return {"worst_1mcos": float("nan"), "mean_error": float("nan"),
                "centered_error": float("nan")}
    r = ref.double()
    worst, sdd, sbb = 0.0, 0.0, 0.0
    sd = torch.zeros(r.shape[1], dtype=torch.float64, device=r.device)
    sb = torch.zeros_like(sd)
    for s in range(0, n, chunk):
        a = torch.from_numpy(out[s:s + chunk]).to(r.device).double()
        b = r[torch.arange(s, s + len(a), device=r.device) % p]
        cos = (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1)
                                 ).clamp_min(1e-30)
        worst = max(worst, float((1.0 - cos).max()))
        d = a - b
        sd += d.sum(0)
        sb += b.sum(0)
        sdd += float((d * d).sum())
        sbb += float((b * b).sum())
    md, mb = sd / n, sb / n
    centred_d = max(sdd - n * float(md @ md), 0.0)
    centred_b = max(sbb - n * float(mb @ mb), 1e-300)
    return {"worst_1mcos": worst, "mean_error": float(md.norm()),
            "centered_error": (centred_d / centred_b) ** 0.5}


def leaf_views(model: torch.nn.Module) -> Dict[str, Tuple]:
    """state-dict name -> (parameter, element offset, shape): where each
    of the reference's leaves lies in the port's parameters (a split qkv
    bias is a slice of one parameter)."""
    by_storage = {p.untyped_storage().data_ptr(): p
                  for p in model.parameters()}
    out = {}
    for name, t in model.state_dict().items():
        p = by_storage.get(t.untyped_storage().data_ptr())
        if p is None:
            continue
        off = (t.data_ptr() - p.data_ptr()) // p.element_size()
        out[name] = (p, off, tuple(t.shape))
    return out


def view(x: torch.Tensor, off: int, shape: Tuple) -> torch.Tensor:
    n = int(np.prod(shape)) if shape else 1
    return x.reshape(-1)[off:off + n].view(shape)


def split(name: str, t: torch.Tensor) -> List[Tuple[str, torch.Tensor]]:
    """A leaf as the comparison counts it: a packed q/k/v bias as its three
    vectors (the key's gets no gradient under softmax), else itself."""
    if name.endswith("in_proj_bias"):
        return [(f"{name}[{p}]", c) for p, c in zip("qkv", t.chunk(3))]
    return [(name, t)]


def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each (split) leaf's fp64 norm."""
    return {k: float(c.double().norm())
            for name, t in tensors.items() for k, c in split(name, t)}


def leaf_norms(views: Dict[str, Tuple], tensors: Dict[int, torch.Tensor],
               names: Iterable[str]) -> Dict[str, float]:
    """Each (split) leaf's fp64 norm, read from the per-parameter
    ``tensors`` (keyed by ``id(parameter)``)."""
    picked = {}
    for k in names:
        p, off, shape = views[k]
        t = tensors.get(id(p))
        if t is not None:
            picked[k] = view(t, off, shape)
    return norms(picked)


def leaf_gaps(port: Dict[str, float], ref: Dict[str, float],
              leaves: List[str], median_over: List[str]) -> Dict[str, float]:
    """Each of ``leaves``' |port - ref| / max(ref, median of
    ``median_over``'s reference norms)."""
    med = float(np.median([ref[k] for k in median_over]))
    return {k: abs(port.get(k, 0.0) - ref[k]) / max(ref[k], med)
            for k in leaves}


def train_checks(port: Dict, ref: Dict) -> Dict[str, float]:
    """The three training numbers from each side's readings: 'losses'
    (per step), 'grad' (leaf -> first gradient's norm) and 'change'
    (leaf -> norm of the three updates' change)."""
    g_ref = ref["grad"]
    moved = list(g_ref)
    med_g = float(np.median([g_ref[k] for k in moved]))
    counted = [k for k in moved if g_ref[k] >= NOUGHT * med_g]
    frozen = [k for k in ref["change"] if k not in g_ref]
    grad = leaf_gaps(port["grad"], g_ref, moved, moved)
    change = leaf_gaps(port["change"], ref["change"], counted + frozen,
                       counted)
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(port["losses"],
                                                    ref["losses"])),
        "grad_gap": max(grad.values()),
        "change_gap": max(change.values()),
        "grad_gap_median": float(np.median([grad[k] for k in moved])),
        "change_gap_median": float(np.median([change[k] for k in counted])),
        "grad_worst_leaf": max(grad, key=grad.get),
        "change_worst_leaf": max(change, key=change.get),
    }
