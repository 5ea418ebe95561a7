"""Device time of a benchmark cell's kernels by the operator that launched
them and the program span the host was in (its stage).

    python3 scripts/stage_kernels.py --workload <cell> --seed <n> [--units 3] [--out DIR]

Builds the cell as the benchmark does (``benchmark/traffic/<kind>.py``,
weights from the seed, its warm-up), then runs ``--units`` train steps or
generate calls inside ``mimic_tpu_torch.utils.tracing.profile``, which
records the host's operators and the device's kernels (``DIR/trace.json``)
and the program's spans (``DIR/spans.json``).  Each kernel is tied to the
innermost operator that launched it by the profiler's correlation id; that
operator to its outermost enclosing operator (the call the program made,
e.g. ``aten::layer_norm`` over ``aten::native_layer_norm``) and to the
innermost program span around it.  Prints one JSON object: the top kernels
by device seconds, and for each of them the (operator, stage) pairs behind
it.  Recording the host's operators slows the host by about a quarter, so
these seconds attribute device time; the benchmark's traced run measures it.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def innermost(intervals, points):
    """For each point, the index of the innermost (start, end) interval that
    holds it, or None; ``intervals`` nest or are disjoint."""
    order = sorted(range(len(intervals)), key=lambda i: (intervals[i][0], -intervals[i][1]))
    pts = sorted(range(len(points)), key=lambda j: points[j])
    out, stack, k = [None] * len(points), [], 0
    for j in pts:
        p = points[j]
        while k < len(order) and intervals[order[k]][0] <= p:
            while stack and intervals[stack[-1]][1] <= intervals[order[k]][0]:
                stack.pop()
            stack.append(order[k])
            k += 1
        while stack and intervals[stack[-1]][1] <= p:
            stack.pop()
        out[j] = stack[-1] if stack else None
    return out


def outermost(ops):
    """For each (start, end) operator of one thread, the index of its outermost
    enclosing operator (itself at top level)."""
    order = sorted(range(len(ops)), key=lambda i: (ops[i][0], -ops[i][1]))
    out, stack = [0] * len(ops), []
    for i in order:
        while stack and ops[stack[-1]][1] <= ops[i][0]:
            stack.pop()
        out[i] = stack[0] if stack else i
        stack.append(i)
    return out


def attribute(events, spans, top=12, pairs=8):
    """``events``: (name, is_device, start_ns, end_ns, correlation id, linked
    id, thread); ``spans``: the program's recorded spans.  Returns the top
    kernels with their (operator, stage) seconds."""
    from benchmark.lib.copied import kernel_group
    from benchmark.lib.trace import short_name

    ops = [e for e in events if not e[1] and e[0].startswith("aten::")]
    # the CUDA API calls (``cuda*`` and ``cu*``), by the correlation id a kernel
    # shares with its launch: the stage of a kernel no operator launched (ctypes)
    launch_at = {e[4]: e[2] for e in events if not e[1] and e[0].startswith("cu")}
    outer = [None] * len(ops)
    by_thread = defaultdict(list)
    for i, e in enumerate(ops):
        by_thread[e[6]].append(i)
    for idx in by_thread.values():
        top_of = outermost([(ops[i][2], ops[i][3]) for i in idx])
        for i, t in zip(idx, top_of):
            outer[i] = idx[t]
    kernels = [e for e in events if e[1]]
    op_of = {e[4]: i for i, e in enumerate(ops)}
    # where the host was when each kernel was launched: its operator's start,
    # else its runtime call's
    at = [ops[op_of[k[5]]][2] if k[5] in op_of else launch_at.get(k[4]) for k in kernels]
    span_of = innermost([(s["start_ns"], s["end_ns"]) for s in spans],
                        [-1 if t is None else t for t in at])
    seconds = defaultdict(float)
    behind = defaultdict(lambda: defaultdict(float))
    for (name, _, s, e, _, linked, _), j in zip(kernels, span_of):
        key = f"{short_name(name)} [{kernel_group(name)}]"
        seconds[key] += (e - s) / 1e9
        i = op_of.get(linked)
        op = "(no operator)" if i is None else ops[outer[i]][0]
        if i is not None and outer[i] != i:
            op += f" > {ops[i][0]}"
        stage = "(no span)" if j is None else spans[j]["name"]
        behind[key][(op, stage)] += (e - s) / 1e9
    out = []
    for key, sec in sorted(seconds.items(), key=lambda kv: -kv[1])[:top]:
        rows = sorted(behind[key].items(), key=lambda kv: -kv[1])[:pairs]
        out.append({"kernel": key, "seconds": sec,
                    "behind": [[op, stage, t] for (op, stage), t in rows]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--units", type=int, default=3)
    ap.add_argument("--out", default="results/stage_kernels")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.lib import registry
    from benchmark.lib.trace import Spans
    from mimic_tpu_torch.utils import tracing

    if not torch.cuda.is_available():
        print("stage_kernels needs a CUDA card", file=sys.stderr)
        return 2
    wl = registry.workload(args.workload)
    cfg = registry.config(wl["config"])
    dev = torch.device("cuda", 0)
    traffic = registry.traffic(wl["traffic"]).Traffic(cfg, wl, args.seed, dev,
                                                      getattr(torch, cfg["dtype"]), Spans(False))
    traffic.setup()
    torch.cuda.synchronize()
    out = os.path.join(args.out, args.workload)
    with tracing.profile(out) as prof:
        for i in range(args.units):
            if wl["traffic"] == "mimic_train":
                traffic.one_step()
            else:
                traffic.one_call(i % len(traffic.calls))
        torch.cuda.synchronize()
    events = [(e.name(), str(e.device_type()).endswith("CUDA"), e.start_ns(),
               e.start_ns() + e.duration_ns(), e.correlation_id(), e.linked_correlation_id(),
               e.start_thread_id()) for e in prof.profiler.kineto_results.events()]
    result = {"workload": args.workload, "units": args.units,
              "card": torch.cuda.get_device_name(0),
              "kernels": attribute(events, tracing.recorded()["spans"])}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
