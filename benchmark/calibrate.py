"""Readings that set a cell's limits, on the card: the program's gaps to the
reference over many seeds (the lower readings) and the control's (the
reference one precision step below the configuration's, in the program's
place) over a few (the upper readings), in one process.

  python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
      --control-seeds 7 8 9 --seconds 3 --out readings.json

Not run by the benchmark's runs; PERF.md gives the readings and the limits
set from them.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark.harness import core  # noqa: E402
from benchmark.reference import precision  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", action="store_true",
                   help="also read each of the driver's faults, planted in "
                        "the program, on the control seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--reference", choices=("configured", "exact"),
                   default="configured",
                   help="the reference's precision: the configuration's, "
                        "or float32 throughout")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    import torch

    out = {"workload": args.workload, "program": {}, "control": {},
           "faults": {},
           "device": torch.cuda.get_device_name()
           if args.device == "cuda" else "cpu", "power": core.power_limit()}
    def save():
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(out, indent=1))

    for seed in args.seeds:
        t0 = time.monotonic()
        run = core.Run(args.workload, seed, args.seconds, False, args.device)
        if args.reference == "exact":
            run.reference = precision.EXACT
        res = core.execute(run, t0)
        out["program"][seed] = {k: v["value"]
                                for k, v in res["checks"].items()}
        out["program"][seed]["_metrics"] = {k: v["value"] for k, v in
                                            res["metrics"].items()}
        print("program", seed, json.dumps(out["program"][seed]), flush=True)
        save()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        run = core.Run(args.workload, seed, args.seconds, False, args.device)
        if args.reference == "exact":
            run.reference = precision.EXACT
        low = precision.configured(run.config).lowered()
        t0 = time.monotonic()
        out["control"][seed] = run.driver.control(run, low)
        out["control"][seed]["_s"] = time.monotonic() - t0
        print("control", seed, json.dumps(out["control"][seed]), flush=True)
        save()
        del run
        gc.collect()
        torch.cuda.empty_cache()
    for seed in args.control_seeds if args.faults else ():
        run = core.Run(args.workload, seed, args.seconds, False, args.device)
        for name, fault in run.driver.faults().items():
            run = core.Run(args.workload, seed, args.seconds, False,
                           args.device)
            with fault():
                res = core.execute(run, time.monotonic())
            out["faults"].setdefault(name, {})[seed] = {
                k: v["value"] for k, v in res["checks"].items()}
            print("fault", name, seed, json.dumps(out["faults"][name][seed]),
                  flush=True)
            save()
            del run
            gc.collect()
            torch.cuda.empty_cache()
    names = sorted({k for r in out["program"].values() for k in r
                    if not k.startswith("_")}
                   | {k for r in out["control"].values() for k in r
                      if not k.startswith("_")})
    for n in names:
        lower = max((r[n] for r in out["program"].values() if n in r),
                    default=None)
        upper = min((r[n] for r in out["control"].values() if n in r),
                    default=None)
        out.setdefault("readings", {})[n] = {"lower": lower, "upper": upper}
        print(f"reading {n} lower {lower!r} upper {upper!r}", flush=True)
    save()
    return 0


if __name__ == "__main__":
    sys.exit(main())
