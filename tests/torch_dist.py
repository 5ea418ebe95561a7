"""A world of ``gloo`` processes for the port's multi-rank tests, on the CPU.

``run_world("module:function", n, workdir)`` spawns n processes that join one
process group through a ``file://`` store in ``workdir`` (no TCP port, so
test workers never collide), each calls ``function(rank, n, workdir)`` with one
torch thread, and leaves the group.  The parent passes inputs as
``workdir/in.pt`` and reads each rank's ``workdir/out-{rank}.pt``.  A worker's
traceback is raised in the parent.

The worker modules import torch and the port only: JAX runs in the test
process, never in a worker.
"""

from __future__ import annotations

import contextlib
import importlib
import multiprocessing as mp
import os
import traceback
from pathlib import Path
from typing import Any, Dict, List

import torch
import torch.distributed as dist


def _entry(target: str, rank: int, n: int, workdir: str) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                                world_size=n)
        try:
            module, fn = target.split(":")
            getattr(importlib.import_module(module), fn)(rank, n, workdir)
        finally:
            dist.destroy_process_group()
    except BaseException:
        Path(workdir, f"error-{rank}.txt").write_text(traceback.format_exc())
        raise


def run_world(target: str, n: int, workdir, inputs: Any = None, timeout: float = 300.0
              ) -> List[Any]:
    """Run ``target`` on n ranks; returns each rank's ``out-{rank}.pt``."""
    workdir = str(workdir)
    os.makedirs(workdir, exist_ok=True)
    if inputs is not None:
        torch.save(inputs, os.path.join(workdir, "in.pt"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(target, r, n, workdir)) for r in range(n)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [Path(workdir, f"error-{r}.txt") for r in range(n)]
    msgs = [e.read_text() for e in errors if e.exists()]
    if msgs or hung or any(p.exitcode for p in procs):
        raise RuntimeError(f"world {target} failed (hung ranks {hung}, exit codes "
                           f"{[p.exitcode for p in procs]}):\n" + "\n".join(msgs))
    return [torch.load(os.path.join(workdir, f"out-{r}.pt"), weights_only=False)
            for r in range(n)]


def load_inputs(workdir: str) -> Dict[str, Any]:
    return torch.load(os.path.join(workdir, "in.pt"), weights_only=False)


def save_outputs(workdir: str, rank: int, out: Any) -> None:
    torch.save(out, os.path.join(workdir, f"out-{rank}.pt"))


@contextlib.contextmanager
def one_rank_group(workdir):
    """A process group of this process alone (for a one-rank mesh in a test)."""
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store1", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()
