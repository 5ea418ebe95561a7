"""Readings that a cell's correctness limits are set from, many seeds in one
process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--control 3] [--out FILE]

For each seed: the cell's set-up (and, for a served cell, a short window of
whole calls), then the program's compared numbers against the reference.
For the first ``--control`` seeds also the control's: the reference computed
in float8 (e4m3, the nearest precision below the bf16 the configurations
state) put in the program's place; and, for a train cell, a planted fault:
half of each batch left out, the loss the mean over the rest.  One JSON line
a seed on standard output (and appended to ``--out``).  Needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--window", type=float, default=1.0,
                    help="seconds of whole calls a served cell runs before its readings")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch

    from benchmark.lib import registry
    from benchmark.lib.trace import Spans

    if not torch.cuda.is_available():
        print("calibrate.py needs a CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    kind = registry.traffic(wl["traffic"])
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",")]
    for n, seed in enumerate(seeds):
        t0 = time.perf_counter()
        tr = kind.Traffic(cfg, wl, seed, dev, getattr(torch, cfg["dtype"]), Spans(False))
        tr.setup()
        if hasattr(tr, "results"):
            tr.window(args.window)
        tr.release()
        ref = tr.reference()
        row = {"cell": args.workload, "seed": seed,
               "program": kind.readings(tr.program_readings(), ref)}
        if n < args.control:
            ctl = tr.reference("fp8")
            # a served cell's control serves nothing: its scores of the served
            # tokens, and the token it puts first at each of their positions
            row["control_fp8"] = kind.readings(kind.as_program(ctl) if hasattr(kind, "as_program")
                                               else ctl, ref)
            if wl["traffic"] == "mimic_train":
                row["fault_half_batch"] = kind.readings(tr.reference(rows=[0]), ref)
        row["seconds"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del tr, ref
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
