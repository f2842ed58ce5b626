"""The port stands without jax: importing every module of
clip_embeds_tpu_torch pulls in neither jax, flax nor clip_embeds_tpu, and
no file of the port (nor chip_smoke.py) reads a file of clip_embeds_tpu."""

import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, pkgutil, sys
import clip_embeds_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
pkg.create_model, pkg.get_model_config  # the lazy names resolve too
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "clip_embeds_tpu"))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 64 else 0)
"""

# Ways a file could reach into the JAX package without importing it: its
# directory name as a path component, a file opened or joined under it, a
# module loaded from a file, the removed path-loading helper, or an import.
# (A "file:line" string that names a TPU kernel, as chip_smoke.py's
# "replaces" fields do, reads nothing.)
_READS_JAX_PACKAGE = re.compile(
    r"""["']clip_embeds_tpu["']"""
    r"""|(?:open|join|Path|exists|listdir|load)\([^)]*["'][^"']*"""
    r"""\bclip_embeds_tpu[/\\]"""
    r"|spec_from_file_location|SourceFileLoader|load_shared|runpy"
    r"|^\s*(?:from|import)\s+clip_embeds_tpu(?:\.|\s|$)",
    re.MULTILINE,
)


def _port_files():
    pkg = os.path.join(ROOT, "clip_embeds_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_reads_no_file_of_the_jax_package():
    hits = []
    for path in _port_files():
        with open(path, encoding="utf-8") as fh:
            for lineno, line in enumerate(fh, 1):
                if _READS_JAX_PACKAGE.search(line):
                    hits.append(f"{os.path.relpath(path, ROOT)}:{lineno}: "
                                f"{line.strip()}")
    assert not hits, "\n".join(hits)
    assert not os.path.exists(
        os.path.join(ROOT, "clip_embeds_tpu_torch", "shared.py"))


def test_scan_catches_a_path_into_the_jax_package():
    for line in ('os.path.join(ROOT, "clip_embeds_tpu", "core")',
                 "spec = importlib.util.spec_from_file_location(n, p)",
                 "from clip_embeds_tpu.core import config",
                 "import clip_embeds_tpu",
                 "mod = load_shared('core/config.py')",
                 "open('clip_embeds_tpu/text/vocab.txt.gz')",
                 'os.path.join(root, "clip_embeds_tpu/core/config.py")'):
        assert _READS_JAX_PACKAGE.search(line), line
    for line in ("from clip_embeds_tpu_torch.ops import _build",
                 "import clip_embeds_tpu_torch as pkg",
                 '"replaces": "clip_embeds_tpu/ops/fused_block.py:170"',
                 "``clip_embeds_tpu/ops/flash_attention.py`` (forward)"):
        assert not _READS_JAX_PACKAGE.search(line), line
