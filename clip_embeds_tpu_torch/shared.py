"""Framework-free modules of the JAX package, loaded by file path.

Importing anything under ``clip_embeds_tpu`` runs its ``__init__``, which
imports jax. The few modules the port shares (the config registry, the
tokenizer, the constants) need only the standard library, numpy and
``regex``, so they are loaded straight from their files under private
module names, and the JAX package's ``__init__`` never runs. A shared
module must not import anything of its own package.
"""

from __future__ import annotations

import importlib.util
import os
import sys
from types import ModuleType

REFERENCE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "clip_embeds_tpu",
)


def load_shared(relpath: str) -> ModuleType:
    """Load ``clip_embeds_tpu/<relpath>`` once, without its package."""
    name = "_cet_shared_" + relpath[: -len(".py")].replace("/", "_")
    mod = sys.modules.get(name)
    if mod is not None:
        return mod
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REFERENCE_DIR, relpath))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up here
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod
