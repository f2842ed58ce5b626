"""VLM2Vec's backbone registry: an HF model name -> a backbone family ->
the port's model (counterpart of ``clip_embeds_tpu/models/backbones.py``).

Each family resolves to (model class, default config factory, HF
state-dict converter). The converters are the port's copies of the JAX
package's and return the same flax trees; ``core/convert.py``
``vlm_state_dict_from_jax_params`` carries such a tree into the model and
``core/factory.py init_vlm`` draws seeded weights for any family. ``train/arguments.py ModelArguments.model_backbone`` names a family
or an HF model name of this table.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

# the reference's table (vlm_dict.py) and the qwen entries its qwen2_vl /
# qwen2_5_vl backbone directories imply
HF_MODEL_TO_VLM_BACKBONE: Dict[str, str] = {
    "microsoft/Phi-3.5-vision-instruct": "phi3_v",
    "TIGER-Lab/VLM2Vec-Full": "phi3_v",
    "TIGER-Lab/VLM2Vec-LoRA": "phi3_v",
    "llava-hf/llava-v1.6-mistral-7b-hf": "llava_next",
    "TIGER-Lab/VLM2Vec-LLaVa-Next": "llava_next",
    "llava-hf/llava-1.5-7b-hf": "llava_15",
    "Qwen/Qwen2-VL-2B-Instruct": "qwen2_vl",
    "Qwen/Qwen2-VL-7B-Instruct": "qwen2_vl",
    "Qwen/Qwen2.5-VL-3B-Instruct": "qwen2_5_vl",
    "Qwen/Qwen2.5-VL-7B-Instruct": "qwen2_5_vl",
}


class Backbone(NamedTuple):
    model_cls: Any
    config_factory: Callable[[], Any]
    converter: Callable[[Dict[str, Any]], Dict[str, Any]]


def get_backbone(name: str) -> Backbone:
    """A backbone family (or an HF model name) -> its model class, default
    config and HF converter; KeyError for an unknown name."""
    family = HF_MODEL_TO_VLM_BACKBONE.get(name, name)
    if family == "llava_15":
        from ..core.convert import convert_llava_state_dict
        from .llava import Llava, LlavaConfig

        return Backbone(Llava, LlavaConfig, convert_llava_state_dict)
    if family == "llava_next":
        from ..core.convert import convert_llava_next_state_dict
        from .llava_next import LlavaNext, LlavaNextConfig

        return Backbone(LlavaNext, LlavaNextConfig,
                        convert_llava_next_state_dict)
    if family == "phi3_v":
        from ..core.convert import convert_phi3_v_state_dict
        from .phi3_v import Phi3V, Phi3VConfig

        return Backbone(Phi3V, Phi3VConfig, convert_phi3_v_state_dict)
    if family == "qwen2_vl":
        from ..core.convert import convert_qwen2_vl_state_dict
        from .qwen2_vl import Qwen2VL, Qwen2VLConfig

        return Backbone(Qwen2VL, Qwen2VLConfig, convert_qwen2_vl_state_dict)
    if family == "qwen2_5_vl":
        from ..core.convert import convert_qwen2_5_vl_state_dict
        from .qwen2_vl import Qwen25VL, Qwen25VLConfig

        return Backbone(Qwen25VL, Qwen25VLConfig,
                        convert_qwen2_5_vl_state_dict)
    raise KeyError(
        f"unknown backbone {name!r}; families: llava_15, llava_next, "
        "phi3_v, qwen2_vl, qwen2_5_vl"
    )
