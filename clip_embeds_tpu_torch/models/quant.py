"""W8A8 int8 inference for the block projections (counterpart of
``clip_embeds_tpu/models/quant.py``).

:class:`QuantLinear` holds int8 weights in ``nn.Linear``'s [out, in] layout
with fp32 per-output-channel scales and an fp32 bias, and quantises its
input per tensor: on the fly in ``dynamic`` mode (recording the running
abs-max in a buffer, what flax's ``sow`` into ``quant_obs`` does), or with
the calibrated ``act_scale`` in ``static`` mode. The product is
``ops.fused_block.int8_linear``: on the CPU the exact int8 x int8 sum of
``qdot``; on the card the kernels behind ``fused_block_int8``
(``cet_quantize_s8`` then ``cet_gemm_s8`` with its bf16 epilogue), with
the scale kept on the device. ``bias=False`` is the JAX
``QuantDense(use_bias=False)`` of the Llama trunk's projections.

Scales, biases and activation statistics stay fp32 whatever the model's
compute dtype, as flax keeps QuantDense's params fp32: cast a quantised
model with :func:`cast_floating`, not ``.to(dtype)``.

:func:`quantize_llava_trunk` quantises the seven projections of each
layer of a LLaVA or Qwen2-VL Llama trunk (``LLAMA_QUANT_LAYER_NAMES``).

The unmaterialized LoRA side-path (``_lora_delta``, ``LoraDense`` and the
``lora_rank`` of ``QuantDense``): a layer built with ``lora_rank`` > 0
adds ``((x.float() @ a) @ b) * (alpha / rank)`` to its fp32 output before
the cast to the compute dtype, where JAX adds it, when an adapter is
attached (``models/lora.py attach_lora``: JAX's ``lora`` collection); a
layer with none adds nothing. On the card the int8 product comes out of
``cet_gemm_s8`` in bf16, so there the side-path is added to that rounded
product. With gradients, the int8 codes pass none (the round), and the
dynamic scale passes what JAX's does: ``y = acc * (a * scale)`` with
``a = max|x| / 127`` carries a gradient to the abs-max entry of ``x``.

:func:`quantize_clip_t5_trunk` quantises the T5 encoder's and decoder's
projections (``T5_QUANT_LAYER_NAMES``) of a CLIP-FlanT5 or an
InstructBLIP-FlanT5.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_block import int8_linear

Quant = Union[bool, str]
# the [out, in] weights a quantised block swaps: (fp name, QuantLinear path)
_BLOCK_LINEARS = (
    ("attn.in_proj_weight", "attn.in_proj"),
    ("attn.out_proj.weight", "attn.out_proj"),
    ("mlp.c_fc.weight", "mlp.c_fc"),
    ("mlp.c_proj.weight", "mlp.c_proj"),
)
# the Llama trunk's projections (attention q/k/v/o, SwiGLU gate/up/down);
# embeddings, RMSNorms and the lm_head stay floating point
LLAMA_QUANT_LAYER_NAMES = (
    "q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj",
    "down_proj",
)
# the T5 encoder's and decoder's projections (self/cross attention q/k/v/o,
# gated-GELU wi_0/wi_1/wo, the ReLU variant's wi); the shared embedding,
# the norms, the relative-position bias and the lm_head stay floating point
T5_QUANT_LAYER_NAMES = ("q", "k", "v", "o", "wi_0", "wi_1", "wi", "wo")


def quantize_weight(w: torch.Tensor):
    """fp weight [out, in] -> (int8 weight [out, in], fp32 scale [out]).

    Abs-max over ``in``; a zero row gets scale 1.0; round half to even.
    The JAX ``quantize_weight`` of the [in, out] kernel, transposed."""
    w = w.float()
    amax = w.abs().amax(dim=1)
    # divided by a tensor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, a rounding apart from the true
    # quotient the JAX package takes
    scale = amax / amax.new_full(amax.shape, 127.0)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(w / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


class _LoraSide:
    """The unmaterialized LoRA side-path shared by :class:`CastLinear` and
    :class:`QuantLinear`: ``lora_rank`` > 0 enables it, ``lora`` holds the
    attached (a [in, r], b [r, out]) fp32 pair or None (no delta)."""

    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def _with_lora(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """``y`` (this layer's output) plus ``alpha / rank * ((x @ a) @
        b)``, added in fp32 (one addmm) and cast to x's dtype; ``y`` as it
        is without an adapter."""
        if self.lora_rank <= 0 or self.lora is None:
            return y
        a, b = self.lora
        xa = x.float().reshape(-1, x.shape[-1]) @ a
        out = torch.addmm(y.float().reshape(-1, y.shape[-1]), xa, b,
                          alpha=self.lora_alpha / self.lora_rank)
        return out.view(y.shape).to(x.dtype)


class _ScaleGrad(torch.autograd.Function):
    """``y`` as it is, whose gradient also reaches the dynamic activation
    scale ``a``: ``y = acc * (a * scale) + bias`` gives ``dy/da = (y -
    bias) / a`` (the codes pass none: the round), JAX's one term through
    the int8 base."""

    @staticmethod
    def forward(ctx, y, a, bias):
        ctx.save_for_backward(y, a, bias)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        y, a, bias = ctx.saved_tensors
        acc = y.float() if bias is None else y.float() - bias.float()
        return g, (g.float() * acc).sum() / a, None


class QuantLinear(_LoraSide, nn.Module):
    """Drop-in ``nn.Linear`` with int8 weights and int8 activations
    (counterpart of ``QuantDense``); returns the input's dtype. On the card
    it takes bf16 inputs and K, N multiples of 16, and raises otherwise."""

    def __init__(self, in_features: int, out_features: int,
                 mode: str = "dynamic", bias: bool = True,
                 lora_rank: int = 0, lora_alpha: float = 16.0):
        super().__init__()
        if mode not in ("dynamic", "static"):
            raise ValueError(f"mode {mode!r}")
        self.mode = mode
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha
        f32 = torch.float32
        self.register_buffer(
            "weight_q", torch.zeros(out_features, in_features,
                                    dtype=torch.int8))
        self.register_buffer("scale", torch.ones(out_features, dtype=f32))
        self.register_buffer(
            "bias", torch.zeros(out_features, dtype=f32) if bias else None)
        self.register_buffer("act_scale", torch.ones((), dtype=f32))
        self.register_buffer("act_max", torch.zeros((), dtype=f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "static":
            a = self.act_scale.clamp_min(1e-8)
        else:
            if torch.is_grad_enabled() and x.requires_grad:
                # JAX's max(|x|): its gradient reaches the abs-max entry
                # (aminmax has no derivative in every torch release)
                observed = x.abs().amax().float()
            else:  # abs-max in one read of x, no |x| temporary
                lo, hi = torch.aminmax(x)
                observed = torch.maximum(hi, -lo).float()
            self.act_max.copy_(torch.maximum(self.act_max,
                                             observed.detach()))
            a = (observed / 127.0).clamp_min(1e-8)
        y = int8_linear(x.detach(), a.detach(), self.weight_q, self.scale,
                        self.bias)
        if a.requires_grad:
            y = _ScaleGrad.apply(y, a, self.bias)
        return self._with_lora(x, y)


class CastLinear(_LoraSide, nn.Linear):
    """``nn.Linear`` that computes in its input's dtype: the weight and bias
    are cast to it (flax's ``Dense(dtype=...)`` over fp32 params), so fp32
    master weights train in bf16 and the gradient flows back through the
    cast. When the dtypes already agree the cast is a no-op. With
    ``lora_rank`` > 0 and an attached adapter, JAX's ``LoraDense``."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, lora_rank: int = 0,
                 lora_alpha: float = 16.0, **kw):
        super().__init__(in_features, out_features, bias, **kw)
        self.lora_rank, self.lora_alpha = lora_rank, lora_alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._with_lora(
            x, F.linear(x, self.weight.to(x.dtype), bias))


def linear(quant: Quant, in_features: int, out_features: int,
           bias: bool = True, lora_rank: int = 0,
           lora_alpha: float = 16.0) -> nn.Module:
    """:class:`CastLinear`, or :class:`QuantLinear` when ``quant`` is True /
    'dynamic' / 'static' (counterpart of ``quant.dense``); ``lora_rank`` >
    0 enables the unmaterialized LoRA side-path on either."""
    if quant:
        mode = "static" if quant == "static" else "dynamic"
        return QuantLinear(in_features, out_features, mode, bias,
                           lora_rank, lora_alpha)
    return CastLinear(in_features, out_features, bias, lora_rank,
                      lora_alpha)


def quant_layers(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, QuantLinear)]


def quantize_state_dict(sd: Mapping[str, torch.Tensor],
                        dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, torch.Tensor]:
    """fp state dict -> the state dict of the same model built with
    ``quant`` (counterpart of ``quantize_dense_tree``): every block's
    ``in_proj``, ``out_proj``, ``c_fc`` and ``c_proj`` become int8 weights,
    fp32 scales and fp32 biases, quantised from the weights as given (fp32
    where ``sd`` is fp32); activation scales start at 1 and observations at
    0. Embeddings, LayerNorms, patchify and the projection heads keep their
    values, cast to ``dtype`` if given."""
    pairs = []
    for key in sd:
        for fp_name, q_name in _BLOCK_LINEARS:
            if key.endswith(fp_name):
                pairs.append((key, key[: -len(fp_name)] + q_name))
    return quantize_linears(sd, pairs, dtype)


def quantize_linears(sd: Mapping[str, torch.Tensor], pairs,
                     dtype: Optional[torch.dtype] = None
                     ) -> Dict[str, torch.Tensor]:
    """``sd`` with each (fp weight key, QuantLinear path) of ``pairs``
    quantised (the weight's bias, if ``sd`` has one, is the key with
    "bias" for "weight"), the other entries cast to ``dtype`` if given."""
    fp, quantised = dict(sd), {}
    for key, prefix in pairs:
        q, scale = quantize_weight(fp.pop(key))
        bias = fp.pop(key[: -len("weight")] + "bias", None)
        quantised.update({
            prefix + ".weight_q": q,
            prefix + ".scale": scale,
            prefix + ".act_scale": torch.ones((), device=q.device),
            prefix + ".act_max": torch.zeros((), device=q.device),
        })
        if bias is not None:
            quantised[prefix + ".bias"] = bias.float()
    if dtype is not None:
        fp = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in fp.items()}
    return {**fp, **quantised}


def quantize_model(model: nn.Module, mode: Quant = "dynamic",
                   dtype: Optional[torch.dtype] = None,
                   tower: Optional[str] = None) -> nn.Module:
    """A new CLIP built with ``quant=mode`` on ``model``'s device: its block
    projections quantised from ``model``'s own weights (as the JAX package
    quantises its fp32 params), every other weight copied and cast to
    ``dtype`` (default: ``model``'s). ``model`` is left as it is.

    With ``tower`` ('visual' or 'text') only that tower is quantised and
    copied; the other stays on the meta device and cannot run."""
    from .clip import CLIP

    if tower not in (None, "visual", "text"):
        raise ValueError(f"tower {tower!r}")
    dtype = dtype or model.visual.proj.dtype
    sd = model.state_dict()
    if tower is not None:
        sd = {k: v for k, v in sd.items()
              if k.startswith("visual.") == (tower == "visual")}
    with torch.device("meta"):
        qmodel = CLIP(model.cfg, quant=mode)
    qmodel.load_state_dict(quantize_state_dict(sd, dtype), assign=True,
                           strict=tower is None)
    return qmodel.eval()


def quantize_siglip(model: nn.Module, mode: Quant = "dynamic",
                    dtype: Optional[torch.dtype] = None,
                    tower: Optional[str] = None) -> nn.Module:
    """:func:`quantize_model` for the SigLIP dual encoder
    (``models/siglip.py``): a new ``Siglip`` built with ``quant=mode``
    whose blocks' ``in_proj``, ``out_proj``, ``fc1`` and ``fc2`` are
    quantised from ``model``'s weights; patchify, the embeddings, the
    LayerNorms and both heads (the MAP head's projections too) keep their
    values, cast to ``dtype`` (default: ``model``'s). With ``tower``
    ('vision_model' or 'text_model') only that tower is built; the other
    stays on the meta device and cannot run."""
    from .siglip import Siglip

    if tower not in (None, "vision_model", "text_model"):
        raise ValueError(f"tower {tower!r}")
    dtype = dtype or model.vision_model.position_embedding.dtype
    sd = model.state_dict()
    if tower is not None:
        sd = {k: v for k, v in sd.items() if k.startswith(tower + ".")}
    pairs = []
    for key in sd:
        parts = key.split(".")  # <tower>.blocks.<i>.<linear>.weight
        if (len(parts) == 5 and parts[1] == "blocks"
                and parts[3] in ("in_proj", "out_proj", "fc1", "fc2")
                and parts[4] == "weight"):
            pairs.append((key, key[: -len(".weight")]))
    with torch.device("meta"):
        qmodel = Siglip(model.cfg, quant=mode)
    qmodel.load_state_dict(quantize_linears(sd, pairs, dtype), assign=True,
                           strict=tower is None)
    return qmodel.eval()


def cast_floating(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model.to(dtype)`` that leaves every QuantLinear's fp32 scales,
    biases and activation statistics as they are; in place."""
    for m in model.modules():
        if isinstance(m, QuantLinear):
            continue
        for t in list(m._parameters.values()) + list(m._buffers.values()):
            if t is not None and t.is_floating_point():
                t.data = t.data.to(dtype)
    return model


def inject_act_scales(model: nn.Module) -> nn.Module:
    """Bake each QuantLinear's observed abs-max into its static activation
    scale, ``max(act_max / 127, 1e-8)``, and switch it to static mode.
    A layer that observed nothing gets the floor 1e-8. The quotient is a
    true division, as numpy's in JAX: the divisor is a tensor on the
    device (by a Python scalar, PyTorch's CUDA division multiplies by the
    reciprocal, an ulp apart)."""
    for q in quant_layers(model):
        q.act_scale.copy_((q.act_max / q.act_max.new_full((), 127.0))
                          .clamp_min(1e-8))
        q.mode = "static"
    return model


@torch.no_grad()
def calibrate_act_scales(model: nn.Module, batches: Iterable,
                         method: Optional[str] = None) -> nn.Module:
    """Run ``model`` in dynamic mode over ``batches`` (each one input, or a
    tuple of positional inputs, of ``model.<method>`` or of ``model``
    itself), then :func:`inject_act_scales`: the model is left static and
    calibrated (counterpart of ``calibrate_act_scales``)."""
    layers = quant_layers(model)
    for q in layers:
        q.mode = "dynamic"
        q.act_max.zero_()
    fn = getattr(model, method) if method else model
    for batch in batches:
        fn(*batch) if isinstance(batch, tuple) else fn(batch)
    return inject_act_scales(model)


def quantize_llava_trunk(model: nn.Module, mode: Quant = "dynamic",
                         dtype: Optional[torch.dtype] = None,
                         **llava_kw) -> nn.Module:
    """A new model of ``model``'s class (``models/llava.py Llava`` or
    ``models/qwen2_vl.py Qwen2VL``: the JAX ``quantize_llava_trunk`` serves
    both trees) on ``model``'s device whose Llama trunk's seven
    projections a layer (``LLAMA_QUANT_LAYER_NAMES``) are int8
    :class:`QuantLinear` quantised from ``model``'s weights, q/k/v
    biases kept fp32; the vision tower, projector, embeddings, norms and
    ``lm_head`` keep their tensors, cast to ``dtype`` (default:
    ``model``'s; with the same dtype they are shared, not copied).
    ``model`` is left as it is. ``llava_kw`` (``lora_rank``,
    ``lora_alpha``, ``remat``) go to the new model."""
    dtype = dtype or model.language_model.embed_tokens.weight.dtype
    sd = model.state_dict()
    with torch.device("meta"):
        qmodel = type(model)(model.cfg, quant_llm=mode, **llava_kw)
    qmodel.load_state_dict(quantize_linears(sd, llava_trunk_pairs(sd), dtype),
                           assign=True)
    return qmodel.eval()


def llava_trunk_pairs(sd: Iterable[str]):
    """The (fp weight key, QuantLinear path) pairs of a LLaVA state dict's
    Llama trunk: the ``LLAMA_QUANT_LAYER_NAMES`` projections of each
    layer, as :func:`quantize_linears` takes them."""
    pairs = []
    for key in sd:
        parts = key.split(".")
        # language_model.model.layers.<i>.<self_attn|mlp>.<proj>.weight
        if (key.startswith("language_model.model.layers.")
                and parts[-2] in LLAMA_QUANT_LAYER_NAMES
                and parts[-1] == "weight"):
            pairs.append((key, key[: -len(".weight")]))
    return pairs


def t5_trunk_pairs(sd: Iterable[str]):
    """The (fp weight key, QuantLinear path) pairs of the T5 encoder's and
    decoder's ``T5_QUANT_LAYER_NAMES`` projections in a CLIP-FlanT5 or
    InstructBLIP state dict (``t5.{encoder,decoder}.block.<i>...``)."""
    pairs = []
    for key in sd:
        parts = key.split(".")
        if (key.startswith(("t5.encoder.block.", "t5.decoder.block."))
                and parts[-2] in T5_QUANT_LAYER_NAMES
                and parts[-1] == "weight"):
            pairs.append((key, key[: -len(".weight")]))
    return pairs


def quantize_clip_t5_trunk(model: nn.Module, mode: Quant = "dynamic",
                           dtype: Optional[torch.dtype] = None) -> nn.Module:
    """A new model of ``model``'s class (``models/clip_t5.py CLIPT5`` or
    ``models/instructblip.py InstructBlipT5``) on its device, built with
    ``quant_t5=mode``, whose T5 projections are int8 :class:`QuantLinear`
    quantised from ``model``'s weights one at a time (counterpart of
    ``quantize_clip_t5_trunk``); the vision tower, projector or Q-Former,
    ``shared``, the norms and ``lm_head`` keep their tensors, cast to
    ``dtype`` (default: ``model``'s; with the same dtype they are shared,
    not copied). ``model`` is left as it is. Scoring CLIP-FlanT5-XXL on 8
    images x 4 texts peaks at 15.85 GiB with this trunk against 23.77 GiB
    in bf16 (``chip_smoke.py`` phase 13; NVIDIA H100 80GB HBM3, 700.00
    W)."""
    dtype = dtype or model.t5.shared.weight.dtype
    sd = model.state_dict()
    with torch.device("meta"):
        qmodel = type(model)(model.cfg, quant_t5=mode)
    qmodel.load_state_dict(quantize_linears(sd, t5_trunk_pairs(sd), dtype),
                           assign=True)
    return qmodel.eval()
