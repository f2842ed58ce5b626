"""The readings the correctness limits are set from, in one process: the
port's compared numbers on each of ``--seeds`` (runs of the cell with a
short window, as ``run.py`` makes them), and the control's on each of
``--control-seeds`` (the driver's ``control``: the port's own lower
precision, or the reference in a lower one). One JSON line a reading.

  python3 port_bench/probe.py --workload <cell> --seeds 1,2,3 \
      --control-seeds 4,5,6 [--control-kind int8|fp8] \
      [--faults rows_permuted,stale_batch --fault-seeds 7,8,9] \
      [--seconds 3] [--out FILE]
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def _ints(s: str):
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="",
                    help="faults of faults.py, comma-separated, each "
                    "planted for every one of --fault-seeds")
    ap.add_argument("--control-kind", default=None,
                    help="the driver's control to read ('int8': the port's "
                    "own path; 'fp8': the reference in float8)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from port_bench.run import _fixed_caches

    _fixed_caches()
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    spec = next(w for w in harness.benchmark()["workloads"]
                if w["name"] == args.workload)
    config = harness.read_json("configs", spec["config"] + ".json")
    traffic = harness.read_json("traffic", spec["traffic"] + ".json")
    driver = harness.load_file("drivers", traffic["kind"])
    out = open(args.out, "a") if args.out else None

    def emit(line):
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()

    import contextlib

    from port_bench.faults import FAULTS

    runs = [(s, "port", contextlib.nullcontext) for s in args.seeds]
    runs += [(s, f"fault:{f}", FAULTS[f])
             for f in args.faults.split(",") if f for s in args.fault_seeds]
    for seed, side, planted in runs:
        t0 = time.perf_counter()
        info = {}
        with planted():
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 device, t0, info=info)
        emit({"workload": args.workload, "side": side, "seed": seed,
              "checks": info["readings"],
              "metrics": {k: v["value"] for k, v in r["metrics"].items()},
              "peak": r["device"]["memory_peak_bytes"],
              "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        b = harness.Bench(args.workload, config, traffic, {}, seed,
                          args.seconds, False, device, t0)
        kw = {"kind": args.control_kind} if args.control_kind else {}
        c = driver.control(b, **kw)
        emit({"workload": args.workload,
              "side": "control:" + (args.control_kind or "default"),
              "seed": seed,
              "checks": c, "seconds": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
