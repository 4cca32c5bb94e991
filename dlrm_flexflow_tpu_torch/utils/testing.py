"""Run a function on several ranks of a gloo process group, on the CPU:
the port's stand-in for the JAX package's virtual CPU devices
(``dlrm_flexflow_tpu.utils.testing.ensure_cpu_devices``), which torch
has no counterpart of. Each rank is a process of its own.

``spawn_ranks(fn, world, tmp_path, timeout_s, args)`` starts ``world``
processes (the ``spawn`` start method: a fresh interpreter each). Each
joins a gloo group through a ``file://`` store in ``tmp_path``
(``parallel.distributed.initialize_distributed``; no fixed port), sets
``torch.set_num_threads(1)``, runs ``fn(rank, world, *args)`` (``args``
reach it through a file) and writes what it returns (pickled) or its
traceback to a file in ``tmp_path``. The parent joins them under one
deadline: past it, it kills every rank and raises ``TimeoutError``
naming ``fn`` and the ranks still running; a rank that raised makes it
raise ``RuntimeError`` with that rank's traceback. ``fn`` must be a
module-level function (it is pickled by name).
"""

from __future__ import annotations

import multiprocessing
import pickle
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List


def _rank_main(fn, rank, world, store, out, args_path):
    import torch
    import torch.distributed as dist

    from ..parallel.distributed import initialize_distributed
    torch.set_num_threads(1)
    try:
        args = _load(Path(args_path))
        initialize_distributed(init_method=f"file://{store}",
                               num_processes=world, process_id=rank,
                               backend="gloo")
        try:
            # no rank runs, or closes its connections, before every rank
            # has connected
            dist.barrier()
            result = fn(rank, world, *args)
            dist.barrier()
        finally:
            dist.destroy_process_group()
        payload = ("ok", result)
    except BaseException:          # the traceback goes to the parent
        payload = ("error", traceback.format_exc())
    tmp = Path(f"{out}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    tmp.rename(out)


def _load(out: Path):
    with open(out, "rb") as f:
        return pickle.load(f)


def spawn_ranks(fn: Callable, world: int, tmp_path, timeout_s: float,
                args: tuple = ()) -> List[Any]:
    """``fn(rank, world, *args)`` on ``world`` gloo ranks; returns each
    rank's result, in rank order."""
    tmp = Path(tmp_path)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store-{fn.__name__}-{world}-{time.monotonic_ns()}"
    outs = [tmp / f"{store.name}.rank{r}.pkl" for r in range(world)]
    # the arguments go through a file: a start writes them down a pipe
    # that the child reads only once it has booted, so large ones through
    # the pipe would start the ranks one after another
    args_path = tmp / f"{store.name}.args.pkl"
    with open(args_path, "wb") as f:
        pickle.dump(args, f)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, str(store), str(outs[r]),
                               str(args_path)),
                         name=f"ff-rank{r}", daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        # poll: a rank that raised leaves its peers waiting in a
        # collective, so its error ends the run at once
        done = {}
        while any(p.is_alive() for p in procs):
            for r, out in enumerate(outs):
                if r not in done and out.exists():
                    done[r] = _load(out)[0]
            if any(v != "ok" for v in done.values()):
                break
            if time.monotonic() > deadline:
                alive = [r for r, p in enumerate(procs) if p.is_alive()]
                raise TimeoutError(
                    f"{fn.__name__} on {world} ranks: rank(s) {alive} "
                    f"still running after {timeout_s:.0f} s; killed")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
    results = []
    errors = [r for r, out in enumerate(outs)
              if out.exists() and _load(out)[0] != "ok"]
    for r, (p, out) in sorted(enumerate(zip(procs, outs)),
                              key=lambda x: x[0] not in errors):
        if not out.exists():
            raise RuntimeError(f"{fn.__name__}: rank {r} of {world} exited "
                               f"{p.exitcode} with no result")
        status, value = _load(out)
        if status != "ok":
            raise RuntimeError(f"{fn.__name__}: rank {r} of {world} "
                               f"raised:\n{value}")
        results.append(value)
    return results
