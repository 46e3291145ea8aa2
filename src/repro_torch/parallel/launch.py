"""Start one process per rank: :func:`spawn_ranks`.

The tests, ``chip_smoke.py`` and ``python -m repro_torch.distributed.run``
all start their ranks here. Each rank is a process started with the
``spawn`` method; the ranks meet at a ``file://`` rendezvous in a
temporary directory (no port is picked), set one intra-op thread on the
CPU, build their :class:`~.sharding.RankMesh` and call ``fn(mesh,
*args)``. ``args`` reach the ranks through a file in that directory,
not through the pipe that starts each process: a start pipe blocks the
parent until the child has imported its modules, so large arguments
there would start the ranks one after another. What ``fn`` returns comes
back to the parent through a file (it must pickle). A rank that raises fails the whole run: the parent
kills every rank and raises with that rank's traceback. A run that
outlasts ``timeout`` is killed and raises ``TimeoutError``.

NCCL is refused on the CPU, and where two ranks would share a card (NCCL
rejects duplicate GPUs): four ranks on one card run under gloo, whose
collectives stage through the host (:mod:`.collectives`).
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import torch

from .sharding import BACKENDS, _normal


def _devices(world: int, backend: str, device) -> list:
    """One device per rank (module docstring's rules)."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA devices and none is "
                               "available; run the ranks under gloo")
        if device is None:
            if world > torch.cuda.device_count():
                raise ValueError(
                    f"{world} NCCL ranks need {world} cards, "
                    f"{torch.cuda.device_count()} are visible (NCCL "
                    f"rejects two ranks on one card; share a card under "
                    f"gloo)")
            return [torch.device("cuda", r) for r in range(world)]
        dev = _normal(device)
        if dev.type != "cuda":
            raise ValueError(f"NCCL runs on CUDA devices, not {dev}")
        if world > 1:
            raise ValueError(
                "NCCL rejects two ranks on one card: give each rank its own "
                "card (device=None), or share a card under gloo")
        return [dev]
    return [_normal("cpu" if device is None else device)] * world


def _rank_main(fn, rank: int, world: int, backend: str, device, init: str,
               tmp: str, timeout: float) -> None:
    """A rank's process: its arguments from ``tmp``, the process group,
    the mesh, ``fn`` and its result (or its traceback) in ``tmp``."""
    import torch.distributed as dist

    from .sharding import make_rank_mesh

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(device.index if device.type == "cuda"
                                     and device.index is not None else rank))
    torch.set_num_threads(1)
    try:
        with open(Path(tmp, "args.pkl"), "rb") as f:
            args = pickle.load(f)
        dist.init_process_group(
            backend, init_method=f"file://{init}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout))
        out = fn(make_rank_mesh(device=device), *args)
        with open(Path(tmp, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        Path(tmp, f"error-{rank}.txt").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + 5
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0))
        if p.is_alive():
            p.kill()
            p.join()


def _failure(procs, tmp: str, world: int, backend: str) -> str:
    """The failed run's report: the first rank to fail (the earliest
    traceback written: the others' collectives fail after it) with its
    traceback, and the other ranks that failed."""
    deadline = time.monotonic() + 2       # the others fail in its wake
    while time.monotonic() < deadline and any(p.is_alive() for p in procs):
        time.sleep(0.02)
    _stop(procs)
    errs = sorted((Path(tmp, f"error-{r}.txt").stat().st_mtime_ns, r)
                  for r in range(world)
                  if Path(tmp, f"error-{r}.txt").exists())
    failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
    first = errs[0][1] if errs else failed[0]
    err = Path(tmp, f"error-{first}.txt")
    tb = err.read_text() if err.exists() else \
        f"(no traceback: exit code {procs[first].exitcode})"
    return (f"rank {first} of {world} ({backend}) failed first (ranks "
            f"{failed} failed):\n{tb}")


def spawn_ranks(fn, world: int, *, backend: str = "gloo", device=None,
                timeout: float = 120.0, args: tuple = ()) -> list:
    """``fn(mesh, *args)`` in ``world`` rank processes; returns what each
    rank returned, in rank order (module docstring). ``device``: None
    (NCCL: ``cuda:<rank>``; gloo: the CPU), or the one device of every
    rank (NCCL: one rank). ``fn`` must be importable by name (a
    module-level function) and its result must pickle."""
    import multiprocessing as mp

    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    devs = _devices(world, backend, device)
    tmp = tempfile.mkdtemp(prefix="repro_ranks_")
    init = os.path.join(tmp, "rendezvous")
    with open(Path(tmp, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, name=f"rank-{r}", args=(
        fn, r, world, backend, devs[r], init, tmp, timeout))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while True:
            if any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError(_failure(procs, tmp, world, backend))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > deadline:
                alive = [r for r, p in enumerate(procs) if p.is_alive()]
                _stop(procs)
                raise TimeoutError(f"ranks {alive} of {world} ({backend}) "
                                   f"still ran after {timeout} s: killed")
            time.sleep(0.02)
        out = []
        for r in range(world):
            with open(Path(tmp, f"result-{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        _stop(procs)
        shutil.rmtree(tmp, ignore_errors=True)
