"""Start a world of gloo ranks as processes of this machine.

``cli sweep`` and the layer's functions expect their caller to start the
ranks (``torchrun`` or by hand). ``run_ranks`` starts them itself, for a
caller that is one process: each rank a spawned process that joins one
gloo group through a file under a temporary directory, runs a function of
an importable module and hands back its result. Every group and every
process has a timeout, and a rank that fails fails the whole world.

On the card the ranks share it (NCCL refuses two ranks on one device;
gloo takes CUDA tensors in the collectives of ``parallel/``). The caller
builds the kernels before the ranks start (``runtime.kernels.build_all``),
so that each rank loads the same build instead of compiling its own.
"""

from __future__ import annotations

import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from clraytracer_tpu_torch.parallel.sharding import INIT_TIMEOUT


def _rank_main(fn, rank: int, world: int, tmp: str, device: str, args: tuple) -> None:
    if device == "cpu":
        torch.set_num_threads(1)  # the ranks share the machine's cores
    else:
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rdv", world_size=world,
                            rank=rank, timeout=INIT_TIMEOUT)
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, Path(tmp) / f"rank{rank}.pt")


def run_ranks(fn, world: int, args: tuple = (), device: str = "cpu") -> list:
    """``fn(*args)`` on each rank of a gloo world of ``world`` processes
    (``device``: ``"cpu"``, or ``"cuda"`` for ranks sharing card 0) →
    each rank's return value, in rank order. ``fn`` is a module-level
    function (the ranks are spawned, so it is sent by its import path) and
    finds its rank through ``torch.distributed``. Raises RuntimeError when
    a rank exits non-zero or the world outlasts ``INIT_TIMEOUT`` (which
    also bounds each rank's wait in a collective); the other ranks are
    killed."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, tmp, device, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + INIT_TIMEOUT.total_seconds()
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    raise RuntimeError(f"a world of {world} ranks outlasted {INIT_TIMEOUT}")
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(30)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks of a world of {world} exited with {codes}")
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
