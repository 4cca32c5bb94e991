"""The process group: init, the rank's slice of a global batch, a probe,
and the collectives the training step runs. The counterpart of the part
of ``dlrm_flexflow_tpu.parallel.distributed`` that training across
ranks needs; ``MeshDegraded``, ``ParticipantRegistry`` and the elastic
loop come with the rest of ROADMAP queue 1 item 7.

Where the JAX package runs one SPMD program over a global device mesh
(``jax.distributed.initialize``), the port runs one process a rank under
``torch.distributed``. ``initialize_distributed`` reads the JAX
package's environment (``COORDINATOR_ADDRESS`` host:port,
``NUM_PROCESSES``, ``PROCESS_ID``), or torchrun's (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), or its arguments (a
test passes a ``file://`` init method). The backend follows from the
world size and the cards: NCCL when every rank has a card of its own,
gloo when ranks share one card (NCCL refuses two ranks on one GPU) or
run on the CPU. Gloo moves host memory, so ``Collectives`` stages a
card tensor through a host copy under it.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.logging import get_logger

log_dist = get_logger("distributed")


def _env_int(key: str) -> int:
    """An environment variable as an int, naming the variable when it is
    not one."""
    raw = os.environ[key]
    try:
        return int(raw.strip())
    except ValueError:
        raise ValueError(f"{key}={raw!r}: expected an integer") from None


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if is_initialized() else 0


def choose_backend(world: int) -> str:
    """"nccl" when each of the ``world`` ranks can have a card of its own,
    else "gloo" (ranks on the CPU, or sharing a card)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if cards >= world > 0 else "gloo"


def local_device(device: str = "cuda") -> torch.device:
    """The device this rank computes on: "cpu", or, for "cuda", its own
    card under NCCL (``LOCAL_RANK`` or the rank modulo the cards) and card
    0 where ranks share it under gloo."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if is_initialized() and dist.get_backend() == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank()))
        return torch.device("cuda", local % torch.cuda.device_count())
    return torch.device("cuda", 0)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           init_method: Optional[str] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group as the arguments or the environment say:
    ``COORDINATOR_ADDRESS`` (host:port of rank 0), ``NUM_PROCESSES`` and
    ``PROCESS_ID`` (the JAX package's names), else torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``; ``init_method``
    (e.g. ``file:///path``) replaces the address. Nothing set: a single
    process, and nothing happens; a world of 1 makes no group. No-op
    when the group exists. Raises ValueError naming what is missing."""
    if is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = _env_int("NUM_PROCESSES")
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = _env_int("PROCESS_ID")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        # torchrun's environment
        num_processes = _env_int("WORLD_SIZE")
        if process_id is None and "RANK" in os.environ:
            process_id = _env_int("RANK")
        if coordinator_address is None and init_method is None \
                and "MASTER_ADDR" in os.environ:
            init_method = "env://"
    if num_processes is None and coordinator_address is None \
            and init_method is None:
        return                                    # a single process
    if num_processes is None:
        raise ValueError("a multi-process launch needs NUM_PROCESSES (or "
                         "WORLD_SIZE): the number of ranks")
    if init_method is None and coordinator_address is None:
        raise ValueError(
            f"NUM_PROCESSES={num_processes} without COORDINATOR_ADDRESS "
            f"(host:port of rank 0), MASTER_ADDR/MASTER_PORT or an "
            f"init_method: the ranks have nowhere to meet")
    if process_id is None:
        raise ValueError(f"NUM_PROCESSES={num_processes} without "
                         f"PROCESS_ID (or RANK): this process's rank")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"PROCESS_ID={process_id} is not a rank of "
                         f"{num_processes}")
    if num_processes == 1:
        return
    if init_method is None:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or choose_backend(num_processes)
    log_dist.info("process group: rank %d of %d over %s (%s; %d card(s) "
                  "visible)", process_id, num_processes, backend,
                  init_method.split("://")[0],
                  torch.cuda.device_count() if torch.cuda.is_available()
                  else 0)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    if backend == "nccl":
        torch.cuda.set_device(local_device())


def host_local_slice(batch: Dict[str, np.ndarray]
                     ) -> Dict[str, np.ndarray]:
    """This rank's contiguous rows of a global batch (rank order: rank r
    holds rows [r·b, (r+1)·b)); the batch itself in a world of 1.
    Raises when a batch dimension does not divide over the ranks."""
    world = world_size()
    if world <= 1:
        return batch
    r = rank()
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % world:
            raise ValueError(
                f"global batch dim {v.shape[0]} of {k!r} must divide "
                f"evenly over {world} processes")
        per = v.shape[0] // world
        out[k] = v[r * per:(r + 1) * per]
    return out


def global_batch_from_host_local(batch: Dict[str, np.ndarray], model
                                 ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch (``batch``, as
    ``host_local_slice`` cut it), staged on ``model``'s device as its
    step takes them. Where the JAX package assembles one global array
    from every host's rows, each rank of the port keeps its own and the
    step's collectives join them. Checks that the model's mesh is the
    process group and that the rows are a rank's share."""
    world = world_size()
    if model.mesh is None or model.mesh.size != world:
        raise ValueError(f"a mesh of {getattr(model.mesh, 'size', None)} "
                         f"rank(s) over a process group of {world}")
    want = model.input_tensors[0].shape[0] // world
    for k, v in batch.items():
        if np.asarray(v).shape[0] != want:
            raise ValueError(f"{k!r}: {np.asarray(v).shape[0]} rows, a "
                             f"rank's share of the global batch is {want}")
    return model._device_batch(batch, local=True)


def probe_mesh(mesh, deadline_s: float = 30.0) -> float:
    """One all-reduce of ones over the process group, on a thread, under
    a deadline: its seconds. A dead or wedged rank makes a collective
    block forever; the caller gets ``TimeoutError`` at the deadline
    instead (the thread is abandoned). Raises RuntimeError when the sum
    is wrong or the collective fails."""
    done = threading.Event()
    result: list = []

    def _collective():
        try:
            ones = torch.ones(1)
            if world_size() > 1:
                dist.all_reduce(ones)
            result.append(float(ones))
        except BaseException as e:   # handed to the caller below
            result.append(e)
        finally:
            done.set()

    t0 = time.monotonic()
    threading.Thread(target=_collective, daemon=True,
                     name="ff-mesh-probe").start()
    if not done.wait(deadline_s):
        raise TimeoutError(f"mesh all-reduce did not complete within "
                           f"{deadline_s:.3g}s (a dead or stalled rank; "
                           f"mesh {mesh.shape})")
    out = result[0]
    if isinstance(out, BaseException):
        raise RuntimeError(f"mesh all-reduce failed: {out}") from out
    if out != float(mesh.size):
        raise RuntimeError(f"mesh all-reduce of ones over {mesh.size} "
                           f"ranks returned {out}")
    return time.monotonic() - t0


class Collectives:
    """The training step's collectives over the process group, each
    counted: ``stats[name]`` holds calls, bytes this rank sent and
    received, and host seconds (the copies through the host included
    under gloo). Under gloo a card tensor goes through a host copy, as
    gloo moves host memory; under NCCL it stays on the card."""

    def __init__(self):
        self.staged = dist.get_backend() == "gloo"
        self.stats = {k: {"calls": 0, "bytes": 0, "seconds": 0.0}
                      for k in ("all_to_all", "all_reduce")}

    def _count(self, name, nbytes, t0):
        s = self.stats[name]
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["seconds"] += time.perf_counter() - t0

    def all_to_all(self, chunks: torch.Tensor) -> torch.Tensor:
        """``chunks`` (world, ...): chunk j goes to rank j; returns
        (world, ...) whose chunk i came from rank i."""
        t0 = time.perf_counter()
        src = chunks.contiguous()
        host = self.staged and src.is_cuda
        send = src.cpu() if host else src
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send)
        out = recv.to(src.device) if host else recv
        # sent and received, less this rank's own chunk
        self._count("all_to_all", 2 * send.nbytes * (1 - 1 / len(src)), t0)
        return out

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same
        bits."""
        t0 = time.perf_counter()
        if self.staged and t.is_cuda:
            h = t.cpu()
            dist.all_reduce(h)
            t.copy_(h)
        else:
            dist.all_reduce(t)
        self._count("all_reduce", 2 * t.nbytes, t0)
        return t
