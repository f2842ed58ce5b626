"""Nothing the benchmark runs may load JAX or the JAX package, and the
references may not load the port. Module names are compared by their
top-level name, whole: ``clip_embeds_tpu_torch`` is not
``clip_embeds_tpu``."""

import ast
import glob
import json
import os
import subprocess
import sys

from port_bench.harness import FORBIDDEN, HERE, ROOT


def _loaded_after(code: str):
    """Top-level names of every module loaded after running ``code`` in a
    fresh interpreter."""
    prog = ("import sys\n" + code +
            "\nimport json\nprint(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, cwd=ROOT, timeout=600,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_run_drivers_and_metrics_load_no_jax():
    code = """
import port_bench.run
from port_bench import harness, probe, faults
import clip_embeds_tpu_torch.cli.embed, clip_embeds_tpu_torch.train.steps
import glob, os
for kind in ("drivers", "metrics"):
    for f in glob.glob(os.path.join(harness.HERE, kind, "*.py")):
        name = os.path.basename(f)[:-3]
        if name != "__init__":
            harness.load_file(kind, name)
"""
    loaded = _loaded_after(code)
    assert "clip_embeds_tpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)


def test_references_load_nothing_of_the_port():
    mods = [os.path.basename(f)[:-3]
            for f in glob.glob(os.path.join(HERE, "reference", "*.py"))]
    code = "\n".join(f"import port_bench.reference.{m}" for m in mods)
    loaded = _loaded_after(code)
    assert not loaded & {"clip_embeds_tpu_torch", *FORBIDDEN}


def test_reference_sources_import_nothing_of_the_port():
    for f in glob.glob(os.path.join(HERE, "reference", "*.py")):
        tree = ast.parse(open(f).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module] if node.level == 0 else []
            for n in names:
                assert n.split(".")[0] not in ("clip_embeds_tpu_torch",
                                                *FORBIDDEN), (f, n)


def test_forbidden_names_compare_whole():
    from port_bench import harness

    fakes = ["clip_embeds_tpu_torch_fake", "clip_embeds_tpux.sub",
             "jaxlib.fake_sub"]
    saved = {k: sys.modules.get(k) for k in fakes}
    for k in fakes:
        sys.modules[k] = sys
    try:
        found = harness.forbidden_modules()
        assert "jaxlib" in found
        assert not {"clip_embeds_tpu_torch_fake", "clip_embeds_tpux"} & \
            set(found)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
