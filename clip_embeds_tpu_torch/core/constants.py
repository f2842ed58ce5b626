"""Shared constants: the port's own copy of
``clip_embeds_tpu/core/constants.py`` (open_clip's ``constants.py``)."""

OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

DEFAULT_CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
