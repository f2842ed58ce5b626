"""Accuracy parity: the reference torch eval driver against the port's
(counterpart of ``clip_embeds_tpu/cli/parity.py``).

One command that, given a checkpoint and a dataset root, runs both

  * the reference eval driver: the ``eval`` / ``eval_4`` / ``eval_COCO_VG`` /
    ``eval_MMVP`` functions of Patch-Aligned-Contrastive-Learning's
    ``eval_clip.py``, ``eval_pacl.py`` or ``eval_sparc.py`` (``--driver``),
    run unmodified from the reference checkout at ``--reference-root`` with
    its torch model on the CPU, and
  * the port's ``cli/eval.py`` on ``--device`` (the card by default)

and diffs the two accuracy tables metric by metric:

    python -m clip_embeds_tpu_torch.cli.parity --model ViT-L-14-336 \\
        --checkpoint vitl336.pt --dataset a --root-dir whatsup \\
        --reference-root REF --out parity_report.json

    python -m clip_embeds_tpu_torch.cli.parity --driver sparc --local \\
        --model ViT-L-14-336 --checkpoint sparc.pth --dataset mmvpvlm \\
        --root-dir MMVP_VLM --reference-root REF

``--reference-root`` (default: ``$CLIP_EMBEDS_REFERENCE_ROOT``, else
``reference`` under the working directory) holds ``open_clip/`` and
``Patch-Aligned-Contrastive-Learning/``; without it the command exits
with an error naming the path and reports no parity. As in JAX's command:
the eval functions are extracted from the driver by AST (its module level
hardcodes cuda:0 and a download); the reference val transforms are
re-created on PIL and torch with torchvision's arithmetic (``_RefProcess``,
``_PaclRefProcess``; torchvision is absent); the tokenizer is the
reference's SimpleTokenizer; the report keeps JAX's keys ('tpu' names the
accelerator side); exit code 1 where a shared metric differs by more than
``--tol``.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys
import tempfile
import types
from typing import Dict

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
PACL_DIR = "Patch-Aligned-Contrastive-Learning"
DRIVERS = {"clip": "eval_clip.py", "pacl": "eval_pacl.py",
           "sparc": "eval_sparc.py"}


def default_reference_root() -> str:
    return os.environ.get("CLIP_EMBEDS_REFERENCE_ROOT", "reference")


def parse_args(argv=None):
    p = argparse.ArgumentParser("clip_embeds_tpu_torch parity runbook")
    p.add_argument("--driver", default="clip", choices=sorted(DRIVERS),
                   help="the reference eval driver to diff against: "
                        "eval_clip.py, eval_pacl.py or eval_sparc.py")
    p.add_argument("--model", default="ViT-L-14-336")
    p.add_argument("--checkpoint", required=True,
                   help="torch checkpoint evaluated by both sides: a CLIP "
                        ".pt for --driver clip, or the reference "
                        "DataParallel 'module.'-prefixed PACL/SPARC "
                        "checkpoint (tower and heads)")
    p.add_argument("--rope", default="none",
                   choices=["none", "before", "after"],
                   help="PACL/SPARC rope variant")
    p.add_argument("--local", action="store_true",
                   help="SPARC local (grouped-patch) scoring")
    p.add_argument("--dataset", default="a",
                   choices=["a", "b", "a4", "b4", "cocoone", "cocotwo",
                            "vgone", "vgtwo", "mmvp", "mmvpvlm"])
    p.add_argument("--root-dir", required=True)
    p.add_argument("--reference-root", default=default_reference_root(),
                   help="the reference checkout (open_clip/ and "
                        f"{PACL_DIR}/)")
    p.add_argument("--out", default=None, help="JSON report path")
    p.add_argument("--tol", type=float, default=1e-6,
                   help="max |reference - port| accuracy difference (pct)")
    p.add_argument("--precision", default="fp32", choices=["bf16", "fp32"],
                   help="the port's dtype (fp32 for exactness)")
    p.add_argument("--device", default="cuda",
                   help="where the port's driver runs: 'cuda' (the default: "
                        "exits if there is no card) or 'cpu'")
    return p.parse_args(argv)


def check_reference_root(root: str, driver: str = "clip") -> None:
    """Exit naming ``root`` where it does not hold the reference driver."""
    path = os.path.join(root, PACL_DIR, DRIVERS[driver])
    if not os.path.isfile(path):
        raise SystemExit(f"--reference-root {root}: no reference checkout "
                         f"there ({path} is missing), so parity cannot be "
                         "checked")


# -- reference side -----------------------------------------------------------


def _load_refoc(root: str):
    """The reference open_clip package under ``root``, with the stubs its
    imports need here (ftfy and torchvision are absent)."""
    import importlib
    import importlib.machinery

    import torch

    if "ftfy" not in sys.modules:
        stub = types.ModuleType("ftfy")
        stub.fix_text = lambda t: t
        stub.__spec__ = importlib.machinery.ModuleSpec("ftfy", None)
        sys.modules["ftfy"] = stub
    if "torchvision" not in sys.modules:
        for name in ("torchvision", "torchvision.ops",
                     "torchvision.ops.misc"):
            mod = types.ModuleType(name)
            mod.__spec__ = importlib.machinery.ModuleSpec(name, None)
            sys.modules[name] = mod
        sys.modules["torchvision.ops.misc"].FrozenBatchNorm2d = (
            torch.nn.BatchNorm2d)
    pkg = types.ModuleType("refoc")
    pkg.__path__ = [os.path.join(root, "open_clip", "src", "open_clip")]
    sys.modules.setdefault("refoc", pkg)
    return (importlib.import_module("refoc.model"),
            importlib.import_module("refoc.tokenizer"))


def _build_ref_tower(model_name: str, root: str):
    """A bare reference torch CLIP of ``model_name``'s architecture."""
    from ..core.config import get_model_config

    refoc_model, _ = _load_refoc(root)
    cfg = get_model_config(model_name)
    model = refoc_model.CLIP(
        embed_dim=cfg.embed_dim,
        vision_cfg=dict(
            image_size=cfg.vision.image_size,
            patch_size=cfg.vision.patch_size, width=cfg.vision.width,
            layers=cfg.vision.layers, head_width=cfg.vision.head_width,
            mlp_ratio=cfg.vision.mlp_ratio),
        text_cfg=dict(
            context_length=cfg.text.context_length,
            vocab_size=cfg.text.vocab_size, width=cfg.text.width,
            heads=cfg.text.heads, layers=cfg.text.layers),
        quick_gelu=cfg.quick_gelu)
    return model, cfg


def build_reference_model(model_name: str, checkpoint: str, root: str):
    """The reference torch CLIP with the checkpoint's weights, eval mode."""
    import torch

    model, cfg = _build_ref_tower(model_name, root)
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    model.load_state_dict(sd)
    return model.eval(), cfg


class _RefProcess:
    """The reference's ``prepare_data_clip`` without torchvision:
    shortest-edge bicubic resize (the ratio truncated with int(), as
    torchvision's F.resize), round()-offset center crop, ToTensor,
    Normalize(OpenAI stats); the reference tokenizer for text."""

    def __init__(self, image_size: int, tokenizer):
        self.image_size = image_size
        self.tokenizer = tokenizer

    def _one(self, image):
        import numpy as np
        import torch
        from PIL import Image as PILImage

        s = self.image_size
        image = image.convert("RGB")
        w, h = image.size
        if w <= h:
            ow, oh = s, int(s * h / w)
        else:
            ow, oh = int(s * w / h), s
        image = image.resize((ow, oh), PILImage.BICUBIC)
        left = int(round((ow - s) / 2.0))
        top = int(round((oh - s) / 2.0))
        image = image.crop((left, top, left + s, top + s))
        x = torch.from_numpy(
            np.asarray(image, np.float32).transpose(2, 0, 1) / 255.0)
        mean = torch.tensor(OPENAI_MEAN).view(3, 1, 1)
        std = torch.tensor(OPENAI_STD).view(3, 1, 1)
        return (x - mean) / std

    def preprocess_image(self, image):
        import torch

        if isinstance(image, list):
            return torch.stack([self._one(im) for im in image])
        return self._one(image)

    def preprocess_text(self, caption):
        return self.tokenizer(caption)


class _PaclRefProcess(_RefProcess):
    """The reference's ``prepare_data`` without torchvision: ToTensor, then
    T.Resize((S, S)) on the tensor (bilinear, antialiased, torchvision's
    F.resize), then Normalize with ImageNet's stats (the reference's
    choice); the reference tokenizer for text."""

    def _one(self, image):
        import numpy as np
        import torch
        import torch.nn.functional as F

        s = self.image_size
        x = torch.from_numpy(
            np.asarray(image.convert("RGB"), np.float32).transpose(2, 0, 1)
            / 255.0)
        x = F.interpolate(x[None], size=(s, s), mode="bilinear",
                          align_corners=False, antialias=True)[0]
        mean = torch.tensor(IMAGENET_MEAN).view(3, 1, 1)
        std = torch.tensor(IMAGENET_STD).view(3, 1, 1)
        return (x - mean) / std


def load_reference_eval_fns(ns: Dict, path: str) -> Dict:
    """The driver's eval / eval_4 / eval_COCO_VG / eval_MMVP, extracted by
    AST and run unmodified into ``ns``, without its module-level cuda and
    model set-up."""
    with open(path) as f:
        tree = ast.parse(f.read())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("eval", "eval_4", "eval_COCO_VG", "eval_MMVP")]
    exec(compile(ast.Module(body=fns, type_ignores=[]), path, "exec"), ns)
    return ns


def _load_ref_pacl_ns(model_name: str, root: str) -> Dict:
    """The class and function definitions of the reference
    ``model/pacl.py``, run unmodified, with its ``oc`` factory replaced by
    one that builds ``model_name``'s reference CLIP without weights (the
    checkpoint then sets every tower weight)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    _, ref_tok = _load_refoc(root)

    class _OC:
        @staticmethod
        def create_model_and_transforms(name, pretrained=None, **kw):
            return _build_ref_tower(model_name, root)[0], None, None

        @staticmethod
        def get_tokenizer(name):
            return ref_tok.SimpleTokenizer()

    try:
        from transformers import AutoConfig, AutoModel, AutoTokenizer
    except Exception:
        AutoConfig = AutoModel = AutoTokenizer = None
    ns: Dict = {"torch": torch, "nn": nn, "F": F, "oc": _OC,
                "AutoModel": AutoModel, "AutoConfig": AutoConfig,
                "AutoTokenizer": AutoTokenizer, "os": os, "sys": sys}
    path = os.path.join(root, PACL_DIR, "model", "pacl.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    defs = [n for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    exec(compile(ast.Module(body=defs, type_ignores=[]), path, "exec"), ns)
    return ns


def build_reference_pacl(args):
    """The reference PACL/SPARC model by rope variant, its DataParallel
    checkpoint loaded through the reference's 'module.' loop (a missing
    key raises)."""
    import torch

    from ..core.config import get_model_config

    ns = _load_ref_pacl_ns(args.model, args.reference_root)
    # the reference picks the ViT-L branch unless the tower is ViT-B-16
    base = "ViT-B-16" if args.model == "ViT-B-16" else "ViT-L-14-336"
    if args.driver == "pacl":
        cls = {"none": ns["open_clip_pacl"],
               "before": ns["open_clip_pacl_rope"],
               "after": ns["open_clip_pacl_rope_after"]}[args.rope]
    else:
        cls = ns["sparc_rope"] if args.rope != "none" else ns["sparc"]
    model = cls(base_model=base)
    saved = torch.load(args.checkpoint, map_location="cpu",
                       weights_only=True)
    weights = model.state_dict()
    for name in weights:
        weights[name] = saved["module." + name]
    for name in saved:
        if name[7:] not in weights:
            raise ValueError(f"{name} in weights is not included")
    model.load_state_dict(weights)
    for p in model.parameters():
        p.requires_grad = False
    return model.eval(), get_model_config(args.model)


def run_reference_driver(args, workdir: str) -> Dict[str, float]:
    """The reference driver on the CPU; its results file's table."""
    import torch
    from PIL import Image
    from tqdm import tqdm

    root = args.reference_root
    _, ref_tok = _load_refoc(root)
    if args.driver == "clip":
        model, cfg = build_reference_model(args.model, args.checkpoint, root)
        process = _RefProcess(cfg.vision.image_size,
                              ref_tok.SimpleTokenizer())
    else:
        model, cfg = build_reference_pacl(args)
        process = _PaclRefProcess(cfg.vision.image_size,
                                  ref_tok.SimpleTokenizer())
    ns = {"torch": torch, "os": os, "json": json,
          "csv": __import__("csv"), "tqdm": tqdm, "Image": Image,
          "device": torch.device("cpu"), "model": model, "process": process}
    load_reference_eval_fns(ns, os.path.join(root, PACL_DIR,
                                             DRIVERS[args.driver]))
    # eval_clip's functions read the global model; eval_pacl / eval_sparc
    # take it; eval_sparc also the local flag
    extra = () if args.driver == "clip" else (model,)
    tail = (args.local,) if args.driver == "sparc" else ()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        if args.dataset in ("mmvp", "mmvpvlm"):
            ns["eval_MMVP"](model, args.root_dir, args.dataset, *tail)
        else:
            with open(_annotation_file(args)) as f:
                dataset = json.load(f)
            fn = {"a": "eval", "b": "eval", "a4": "eval_4",
                  "b4": "eval_4"}.get(args.dataset, "eval_COCO_VG")
            ns[fn](*extra, dataset, args.root_dir, args.dataset, *tail)
    finally:
        os.chdir(cwd)
    return parse_results_file(os.path.join(workdir,
                                           "evaluation_results.txt"))


def _annotation_file(args) -> str:
    names = {"a": "controlled_images_dataset.json",
             "a4": "controlled_images_dataset.json",
             "b": "controlled_clevr_dataset.json",
             "b4": "controlled_clevr_dataset.json",
             "cocoone": "coco_qa_one_obj.json",
             "cocotwo": "coco_qa_two_obj.json",
             "vgone": "vg_qa_one_obj.json", "vgtwo": "vg_qa_two_obj.json"}
    return os.path.join(args.root_dir, names[args.dataset])


def parse_results_file(path: str) -> Dict[str, float]:
    """'<metric>: <value>' lines -> {metric: float}, both drivers'
    format (and MMVP's 'Pair: X, Individual: Y' line)."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if ":" not in line:
                continue
            key, _, value = line.rpartition(":")
            key = key.strip()
            for part in value.replace(",", " ").split():
                try:
                    out[key] = float(part)
                    break
                except ValueError:
                    continue
            if line.startswith("Pair:") and "Individual:" in line:
                bits = line.replace(",", "").split()
                out["Pair"] = float(bits[1])
                out["Individual"] = float(bits[3])
    return out


# -- the port's side ----------------------------------------------------------


def run_port_driver(args, workdir: str) -> Dict[str, float]:
    """The port's ``cli/eval.py`` on ``--device``; its results file's
    table. A PACL/SPARC checkpoint is split: the tower's state dict into a
    .pt for ``--pretrained``, the heads into the flax ``.npz`` of
    ``--model-path``."""
    from . import eval as port_eval

    results_file = os.path.join(workdir, "evaluation_results.txt")
    argv = ["--scorer", args.driver, "--model", args.model,
            "--dataset", args.dataset, "--root-dir", args.root_dir,
            "--results-file", results_file, "--precision", args.precision,
            "--device", args.device]
    if args.driver == "clip":
        argv += ["--pretrained", args.checkpoint]
    else:
        import torch

        from ..core.convert import split_pacl_checkpoint
        from ..core.factory import save_params_npz

        sd = torch.load(args.checkpoint, map_location="cpu",
                        weights_only=True)
        clip_sd, head_params = split_pacl_checkpoint(sd)
        tower_pt = os.path.join(workdir, "tower.pt")
        head_npz = os.path.join(workdir, "head.npz")
        torch.save(clip_sd, tower_pt)
        save_params_npz(head_params, head_npz)
        argv += ["--pretrained", tower_pt, "--model-path", head_npz,
                 "--rope", args.rope]
        if args.driver == "sparc" and args.local:
            argv += ["--sparc-local"]
    port_eval.main(argv)
    return parse_results_file(results_file)


# -- diff ---------------------------------------------------------------------


def diff_tables(ref: Dict[str, float], port: Dict[str, float],
                tol: float) -> Dict:
    """The shared metrics side by side; parity where every one is within
    ``tol`` and at least one is shared (JAX's report layout)."""
    shared = sorted(set(ref) & set(port))
    rows = []
    ok = True
    for key in shared:
        delta = port[key] - ref[key]
        match = abs(delta) <= tol
        ok = ok and match
        rows.append({"metric": key, "reference": ref[key], "tpu": port[key],
                     "delta": delta, "match": match})
    return {"metrics": rows,
            "only_reference": sorted(set(ref) - set(port)),
            "only_tpu": sorted(set(port) - set(ref)),
            "parity": ok and bool(shared)}


def main(argv=None):
    args = parse_args(argv)
    check_reference_root(args.reference_root, args.driver)
    from ..core.factory import resolve_device

    resolve_device(args.device)
    with tempfile.TemporaryDirectory() as ref_dir, \
            tempfile.TemporaryDirectory() as port_dir:
        ref = run_reference_driver(args, ref_dir)
        port = run_port_driver(args, port_dir)
    report = diff_tables(ref, port, args.tol)
    report.update(driver=args.driver, dataset=args.dataset, model=args.model,
                  checkpoint=args.checkpoint)
    width = max((len(r["metric"]) for r in report["metrics"]), default=6)
    print(f"{'metric':<{width}}  {'reference':>10}  {'port':>10}  "
          f"{'delta':>10}")
    for r in report["metrics"]:
        flag = "" if r["match"] else "  <-- MISMATCH"
        print(f"{r['metric']:<{width}}  {r['reference']:>10.4f}  "
              f"{r['tpu']:>10.4f}  {r['delta']:>10.4f}{flag}")
    print(f"parity: {report['parity']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["parity"] else 1)
