"""Run one cell of the benchmark once, on the card.

    python3 -m rtbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints one JSON line (the last of standard
output): ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each compared
number beside its limit, which also end standard error. Without a card, or
with fewer cards than the cell asks for, it exits 2 and prints no result;
it never falls back to the CPU. Everything about a cell is found by name
from ``BENCHMARK.json``: this file names no configuration, traffic mix or
metric.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

#: top-level modules that may not be loaded in the measuring process: JAX
#: and the JAX package (compared whole: the port's name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "clraytracer_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, device=None, t0: float = T0):
    """Run the cell → the result's dict (``correct`` ... ``checks``)."""
    import torch

    from rtbench import cells, check, loops

    here = cells.HERE
    bench = cells.Benchmark(here.parent / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    traffic = cells.traffic(here, cell["traffic"])
    if device is None:
        device = torch.device("cuda", 0)
    run = loops.Run(cell=cell["name"], config=bench.config(cell), traffic=traffic,
                    seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                    device=device, root=here, t0=t0)
    out = cells.loop(here, traffic["loop"]).measure(run)
    correct, shown = check.verdict(out.numbers, check.limits(here, cell["name"]))
    metrics = {}
    if args.trace:
        ctx = dict(out.context, run=run)
        for m in bench.per_layer(cell):
            value = cells.reader(here, m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in bench.end_to_end(cell):
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": out.memory_peak_bytes}
    result = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = out.busy_s
        dev["window_s"] = out.window_s
        result["breakdown"] = out.breakdown
    if run.first_error:
        result["first_error"] = run.first_error
    if "leaf_gaps" in out.context:
        result["leaf_gaps"] = out.context["leaf_gaps"]
    result["checks"] = shown
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from rtbench import cells

    cell = cells.Benchmark(cells.HERE.parent / "BENCHMARK.json").cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"rtbench: {cell['name']} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(args)
    found = forbidden_modules()
    if found:
        print(f"rtbench: the measuring process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

