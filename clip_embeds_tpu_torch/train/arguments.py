"""VLM2Vec-style dataclass CLI arguments (a copy of
``clip_embeds_tpu/train/arguments.py``, which imports no framework; the
port keeps its own so that it never imports the JAX package).

Reference: VLM2Vec/src/arguments.py (ModelArguments/DataArguments/
TrainingArguments/MTEBArguments, parsed with HfArgumentParser and consumed by
train.py:29-45 / eval.py). The field names are the reference's, so its run
scripts translate 1:1; TrainingArguments carries the mesh / bf16 /
grad-cache fields instead of subclassing the HF Trainer arguments
(``data_parallel``: the ranks of the data dimension, one a card under
torchrun; ``model_parallel``: the ranks of the model dimension, each a
whole replica, as JAX's mesh holds the state). ``pooling``,
``normalize`` and ``lora_dropout`` are read by nothing, here as in JAX.
``parse_dataclasses`` is the HfArgumentParser equivalent: it turns the
dataclass fields into an argparse parser (bool -> flag pairs, List[str] ->
nargs) and returns one populated instance per class.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Type


@dataclass
class ModelArguments:
    """Mirrors VLM2Vec/src/arguments.py:6-57."""

    model_name: str = field(
        default=None, metadata={"help": "model name or checkpoint path"}
    )
    model_backbone: str = field(
        default="llava_15",
        metadata={"help": "vlm backbone family or HF model name, resolved "
                  "by models/backbones.py get_backbone"}
    )
    processor_name: Optional[str] = field(
        default=None, metadata={"help": "processor name (defaults to model)"}
    )
    checkpoint_path: Optional[str] = field(
        default=None, metadata={"help": "local params path (.npz/orbax)"}
    )
    pooling: str = field(
        default="last", metadata={"help": "pooling method: last|mean|cls"}
    )
    normalize: bool = field(
        default=False, metadata={"help": "L2-normalize representations"}
    )
    temperature: float = field(
        default=0.02, metadata={"help": "contrastive softmax temperature"}
    )
    lora: bool = field(
        default=False, metadata={"help": "train a LoRA adapter tree"}
    )
    lora_r: int = field(default=16, metadata={"help": "lora rank"})
    lora_alpha: int = field(default=64, metadata={"help": "lora alpha"})
    lora_dropout: float = field(
        default=0.1, metadata={"help": "lora dropout"}
    )
    lora_target_modules: str = field(
        default="qkv_proj,o_proj,gate_up_proj,down_proj,k_proj,q_proj,out_proj,v_proj",
        metadata={"help": "comma-separated module-name suffixes to adapt"},
    )
    num_crops: int = field(
        default=16, metadata={"help": "HD crops for phi3_v image embedding"}
    )
    quant_base: bool = field(
        default=False, metadata={"help": (
            "rebuild-only: freeze the trunk as W8A8 int8 and train the LoRA "
            "adapters through the unmaterialized side-path (the QLoRA-shaped "
            "single-chip recipe; requires --lora). No reference equivalent "
            "— peft materializes merged weights."
        )}
    )

    @property
    def lora_targets(self) -> Tuple[str, ...]:
        return tuple(
            t for t in self.lora_target_modules.split(",") if t
        )


@dataclass
class DataArguments:
    """Mirrors VLM2Vec/src/arguments.py:60-85."""

    dataset_name: Optional[str] = field(
        default=None, metadata={"help": "dataset name (e.g. TIGER-Lab/MMEB-train)"}
    )
    subset_name: Optional[List[str]] = field(
        default=None, metadata={"help": "dataset subsets to mix"}
    )
    dataset_split: str = field(
        default="train", metadata={"help": "dataset split"}
    )
    num_sample_per_subset: int = field(
        default=100, metadata={"help": "training samples per subset"}
    )
    image_dir: Optional[str] = field(
        default=None, metadata={"help": "image root directory"}
    )
    encode_output_path: Optional[str] = field(
        default=None, metadata={"help": "eval embedding pickle directory"}
    )
    max_len: int = field(
        default=128, metadata={"help": "max tokenized sequence length"}
    )
    embedding_type: str = field(
        default="", metadata={"help": "embedding type tag for eval outputs"}
    )


@dataclass
class TrainingArguments:
    """Replacement for the HF TrainingArguments subclass
    (VLM2Vec/src/arguments.py:88-113): keeps the reference's fields
    (grad_cache, gc_*_chunk_size, image_encoder_freeze, ...) and adds the
    mesh/precision knobs that replace torchrun/DDP."""

    output_dir: Optional[str] = field(
        default=None, metadata={"help": "checkpoint directory"}
    )
    project_name: Optional[str] = field(
        default=None, metadata={"help": "wandb project name"}
    )
    learning_rate: float = field(
        default=2e-5, metadata={"help": "peak learning rate"}
    )
    per_device_train_batch_size: int = field(
        default=64, metadata={"help": "per-chip batch size"}
    )
    max_steps: int = field(
        default=1000, metadata={"help": "total optimizer steps"}
    )
    num_train_epochs: int = field(
        default=1, metadata={"help": "epochs (if max_steps <= 0)"}
    )
    warmup_steps: int = field(default=0, metadata={"help": "LR warmup steps"})
    lr_scheduler_type: str = field(
        default="linear", metadata={"help": "linear|cosine|const"}
    )
    logging_steps: int = field(default=1, metadata={"help": "log every N"})
    save_steps: int = field(
        default=500, metadata={"help": "checkpoint every N steps"}
    )
    seed: int = field(default=42, metadata={"help": "PRNG seed"})
    bf16: bool = field(
        default=True, metadata={"help": "bfloat16 params/compute"}
    )
    image_encoder_freeze: bool = field(
        default=False, metadata={"help": "freeze the vision tower"}
    )
    grad_cache: bool = field(
        default=False, metadata={"help": "use the 2-pass gradient cache"}
    )
    gc_q_chunk_size: int = field(
        default=2, metadata={"help": "query-side chunk size"}
    )
    gc_p_chunk_size: int = field(
        default=2, metadata={"help": "target-side chunk size"}
    )
    data_parallel: int = field(
        default=-1, metadata={"help": "data mesh axis size (-1 = all devices)"}
    )
    model_parallel: int = field(
        default=1, metadata={"help": "model (tensor) mesh axis size"}
    )


@dataclass
class MTEBArguments:
    """Mirrors VLM2Vec/src/arguments.py:116-122."""

    task_types: Optional[List[str]] = field(
        default=None, metadata={"help": "MTEB task types"}
    )
    tasks: Optional[List[str]] = field(
        default=None, metadata={"help": "MTEB task names"}
    )


def _add_dataclass_args(
    parser: argparse.ArgumentParser, cls: Type
) -> None:
    for f in dataclasses.fields(cls):
        if not f.init:
            continue
        name = "--" + f.name
        help_text = (f.metadata or {}).get("help", "")
        default = (
            f.default
            if f.default is not dataclasses.MISSING
            else (
                f.default_factory()  # type: ignore[misc]
                if f.default_factory is not dataclasses.MISSING
                else None
            )
        )
        ftype = f.type if isinstance(f.type, type) else str(f.type)
        is_list = "List[" in str(ftype) or ftype in (list, List)
        if ftype is bool or str(ftype) == "bool":
            # HfArgumentParser semantics: --flag sets True, --no_flag False
            parser.add_argument(
                name, dest=f.name, action="store_true", default=default,
                help=help_text,
            )
            parser.add_argument(
                "--no_" + f.name, dest=f.name, action="store_false",
                help=argparse.SUPPRESS,
            )
        elif is_list:
            parser.add_argument(
                name, nargs="+", default=default, help=help_text
            )
        else:
            caster = {
                "int": int, "float": float, "str": str,
                "Optional[int]": int, "Optional[float]": float,
                "Optional[str]": str,
            }.get(str(ftype).replace("typing.", ""), str)
            if isinstance(ftype, type) and ftype in (int, float, str):
                caster = ftype
            parser.add_argument(
                name, type=caster, default=default, help=help_text
            )


def parse_dataclasses(
    classes: Sequence[Type], argv: Optional[Sequence[str]] = None
):
    """HfArgumentParser.parse_args_into_dataclasses equivalent: one shared
    argparse namespace, split back into one instance per dataclass."""
    parser = argparse.ArgumentParser(allow_abbrev=False)
    for cls in classes:
        _add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    out = []
    for cls in classes:
        names = {f.name for f in dataclasses.fields(cls) if f.init}
        out.append(cls(**{k: v for k, v in vars(ns).items() if k in names}))
    return tuple(out)
