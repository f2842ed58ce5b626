"""open_clip's contrastive losses, torch's AdamW equations written out, and
a few training steps of a CLIP computed with them.

* InfoNCE (open_clip ``ClipLoss``): logits = exp(logit_scale) x img @
  txt^T, cross-entropy with the diagonal as the target, both ways, halved.
* Hard-negative texts (the NegCLIP form of the paper's fork of open_clip,
  ``--usehardtext``): the images score against the B captions and the H
  hard negatives, target i; the captions score back against the B images.
* AdamW (Loshchilov and Hutter; ``torch.optim.AdamW``): p <- p (1 - lr wd),
  m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2) g^2,
  p <- p - lr / (1 - b1^t) x m / (sqrt(v / (1 - b2^t)) + eps). Weight decay
  skips what open_clip's ``main.py`` excludes: tensors of fewer than two
  dimensions and names with 'bn', 'ln', 'bias' or 'logit_scale'. After the
  update the logit scale is clamped to [0, ln 100].
* Learning rate: linear warm-up, lr (t + 1) / warmup for update t (0 first).

Gradients come in blocks of rows, as GradCache computes them: every
feature without gradient first, the loss's gradient with respect to the
features, then each block of rows again with gradient, back-propagated
from its features' gradient. The sum is the gradient of the whole batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional

import torch
import torch.nn.functional as F

from .towers import MatMul, encode_image, encode_text

Params = Dict[str, torch.Tensor]


def clip_loss(img: torch.Tensor, txt: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    logits = scale * img @ txt.t()
    labels = torch.arange(img.shape[0], device=img.device)
    return (F.cross_entropy(logits, labels)
            + F.cross_entropy(logits.t(), labels)) / 2


def hard_text_loss(img: torch.Tensor, txt: torch.Tensor, hard: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    labels = torch.arange(img.shape[0], device=img.device)
    logits_img = scale * img @ torch.cat([txt, hard]).t()
    logits_txt = scale * txt @ img.t()
    return (F.cross_entropy(logits_img, labels)
            + F.cross_entropy(logits_txt, labels)) / 2


def decays(name: str, p: torch.Tensor) -> bool:
    """open_clip's weight-decay rule (``main.py`` ``exclude``)."""
    return not (p.ndim < 2 or "bn" in name or "ln" in name
                or "bias" in name or "logit_scale" in name)


class AdamW:
    """torch's AdamW, one tensor at a time, in fp32."""

    def __init__(self, params: Params, lr: float, beta1: float, beta2: float,
                 eps: float, weight_decay: float):
        self.params, self.lr = params, lr
        self.b1, self.b2, self.eps, self.wd = beta1, beta2, eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Params, lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            if decays(k, p):
                p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def warmup_lr(base: float, warmup: int, step: int) -> float:
    return base * (step + 1) / max(warmup, 1) if step < warmup else base


def _features(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              chunk: int) -> torch.Tensor:
    with torch.no_grad():
        return torch.cat([fn(x[i:i + chunk]) for i in range(0, len(x), chunk)])


def _backward_chunks(fn: Callable[[torch.Tensor], torch.Tensor],
                     x: torch.Tensor, grad: torch.Tensor, chunk: int) -> None:
    for i in range(0, len(x), chunk):
        out = fn(x[i:i + chunk])
        torch.autograd.backward(out, grad[i:i + chunk])


def gradients(params: Params, trainable: Iterable[str], config: Dict,
              batch: Dict[str, torch.Tensor], chunk: int,
              lock_image: bool, mm: MatMul = torch.matmul) -> tuple:
    """(loss, gradients of the ``trainable`` names) of one batch: 'images',
    'texts' and optionally 'hard_texts' (the hard-negative loss); every
    matrix product of the towers through ``mm``."""
    names = list(trainable)
    for k, p in params.items():
        p.requires_grad_(k in names)
        p.grad = None
    img_fn = lambda x: encode_image(params, config, x, mm)
    txt_fn = lambda x: encode_text(params, config, x, mm)
    hard = batch.get("hard_texts")
    texts = batch["texts"] if hard is None else torch.cat([batch["texts"],
                                                           hard])
    img = _features(img_fn, batch["images"], chunk).requires_grad_(
        not lock_image)
    txt = _features(txt_fn, texts, chunk).requires_grad_(True)
    scale = params["logit_scale"].exp()
    b = batch["texts"].shape[0]
    if hard is None:
        loss = clip_loss(img, txt, scale)
    else:
        loss = hard_text_loss(img, txt[:b], txt[b:], scale)
    loss.backward()
    if not lock_image:
        _backward_chunks(img_fn, batch["images"], img.grad, chunk)
    _backward_chunks(txt_fn, texts, txt.grad, chunk)
    grads = {k: params[k].grad.detach().clone() if params[k].grad is not None
             else torch.zeros_like(params[k]) for k in names}
    for p in params.values():
        p.requires_grad_(False)
        p.grad = None
    return float(loss.detach()), grads


def train_steps(params: Params, config: Dict, recipe: Dict,
                batches: List[Dict[str, torch.Tensor]], chunk: int,
                trainable: Optional[Iterable[str]] = None,
                mm: MatMul = torch.matmul) -> Dict:
    """Run ``len(batches)`` updates of ``params`` in place (fp32 masters,
    fp32 compute). ``recipe`` holds lr, beta1, beta2, eps, wd, warmup and
    lock_image. Returns the loss of each step and the first step's
    gradients; ``params`` end as the last update leaves them. ``mm``: the
    towers' matrix product (the plain fp32 one, or the control's)."""
    lock = bool(recipe.get("lock_image", False))
    if trainable is None:
        trainable = [k for k in params
                     if not (lock and k.startswith("visual."))]
    trainable = list(trainable)
    opt = AdamW({k: params[k] for k in trainable}, recipe["lr"],
                recipe["beta1"], recipe["beta2"], recipe["eps"], recipe["wd"])
    losses, first = [], None
    for t, batch in enumerate(batches):
        loss, grads = gradients(params, trainable, config, batch, chunk, lock,
                                mm)
        losses.append(loss)
        if first is None:
            first = grads
        opt.step(grads, warmup_lr(recipe["lr"], recipe["warmup"], t))
        with torch.no_grad():
            params["logit_scale"].clamp_(0, math.log(100))
        del grads
    return {"losses": losses, "first_grads": first, "trainable": trainable}
