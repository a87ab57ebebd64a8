"""The control of the comparison: the plain reference put in the program's
place and computed one precision below the configuration's float32, in
bfloat16, on the cell's own sizes. Its numbers are the upper readings that
each limit has to stay below; the benchmark's runs never run it.

    python3 -m rtbench.control --workload <cell> --seed <n> [--seed <n> ...]

Prints one JSON line per seed: the cell's compared numbers of the control,
from the ``control(run)`` of the loop the cell's mix names. It needs the
card, as the cells do.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rtbench import cells, loops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m rtbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rtbench.control: needs a CUDA card", file=sys.stderr)
        return 2
    bench = cells.Benchmark(cells.HERE.parent / "BENCHMARK.json")
    cell = bench.cell(args.workload)
    traffic = cells.traffic(cells.HERE, cell["traffic"])
    for seed in args.seed:
        run = loops.Run(cell=cell["name"], config=bench.config(cell), traffic=traffic,
                        seed=seed, seconds=0.0, trace=False, device=torch.device("cuda", 0),
                        root=cells.HERE, t0=0.0)
        numbers = cells.loop(cells.HERE, traffic["loop"]).control(run)
        print(json.dumps({"workload": cell["name"], "seed": seed, "control": numbers}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
