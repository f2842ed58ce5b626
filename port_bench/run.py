"""Run one cell of ``BENCHMARK.json`` once on the card and print its result
as the last line of standard output.

  python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Without a card, or with fewer cards than the cell asks for, it prints no
result and exits with 2. Set-up is timed from the start of this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")


def _fixed_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the
    checkout, so that only a checkout's first run builds; no library that
    the port pulls in may load JAX."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(CACHE, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def _card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, ROOT)
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    spec = next((w for w in harness.benchmark()["workloads"]
                 if w["name"] == args.workload), None)
    if spec is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec["chips"]:
        print(f"{args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    info = {"card": _card_line(), "torch": torch.__version__,
            "cuda": torch.version.cuda}
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0), T0,
                              info=info)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark "
              "runs the PyTorch port alone)", file=sys.stderr)
        return 3
    harness.report(result, info)
    return 0


if __name__ == "__main__":
    sys.exit(main())
