"""The process group: init, the rank's slice of a global batch, a probe,
the collectives the training step runs, and the rank-wide ones of the
training loops (rank 0's choice broadcast, host arrays gathered to rank
0). The counterpart of the part of ``dlrm_flexflow_tpu.parallel.
distributed`` that training across ranks needs; ``MeshDegraded``,
``ParticipantRegistry`` and the elastic loop come with ROADMAP queue 1
item 7.5.

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
from typing import Any, Dict, List, Optional

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
    """The training step's collectives over the process group or a group
    of its ranks (``group``, from ``axis_groups``), each counted:
    ``stats[name]`` holds calls, ``bytes`` this rank sent and received
    less the blocks it kept, ``sent`` (the buffers it handed over, its
    own block included where the collective takes one: the figure the
    row exchange's ``dense_exchange_hlo_bytes`` predicts) and host
    seconds (the copies through the host included under gloo). Under
    gloo a card tensor goes through a host copy, as gloo moves host
    memory; under NCCL it stays on the card."""

    NAMES = ("all_to_all", "all_reduce", "all_gather", "p2p",
             "reduce_scatter", "broadcast", "gather")

    def __init__(self):
        self.staged = dist.get_backend() == "gloo"
        # where a host array travels: itself under gloo, the rank's card
        # under NCCL (which moves no host memory)
        self._wire = None if self.staged else local_device()
        self.stats = {k: {"calls": 0, "bytes": 0, "sent": 0, "seconds": 0.0}
                      for k in self.NAMES}
        self._groups = {}

    def _count(self, name, nbytes, t0, sent=0):
        s = self.stats[name]
        s["calls"] += 1
        s["bytes"] += int(nbytes)
        s["sent"] += int(sent)
        s["seconds"] += time.perf_counter() - t0

    def _host(self, t):
        """(the tensor gloo moves, whether it is a host copy)."""
        host = self.staged and t.is_cuda
        return (t.cpu() if host else t), host

    def axis_groups(self, mesh, axes, rank: int):
        """(group, ranks) of ``rank`` over the mesh axes ``axes``: the
        ranks that differ from it only on those axes, in the order of
        their index over ``axes`` (ascending rank, as the mesh lays ranks
        out row-major). The group is None for the whole process group or
        for a rank alone (``axes`` empty). Every group over ``axes`` is
        made at the first call, by ``dist.new_group`` in one order on
        every rank (each rank must make every group, its own or not), and
        kept for later calls."""
        axes = tuple(axes)
        key = (mesh.axis_names, mesh.axis_sizes, mesh.ranks, axes)
        if key not in self._groups:
            others = [a for a in mesh.axis_names if a not in axes]
            blocks = {}
            for r in mesh.ranks:
                c = mesh.coords(r)
                blocks.setdefault(tuple(c[a] for a in others), []).append(r)
            made = {}
            for members in blocks.values():
                members = sorted(members,
                                 key=lambda r: mesh.linear_index(r, axes))
                whole = len(members) == world_size() or len(members) == 1
                g = None if whole else dist.new_group(members)
                for r in members:
                    made[r] = (g, members)
            self._groups[key] = made
        return self._groups[key][rank]

    def all_to_all(self, chunks: torch.Tensor, group=None) -> torch.Tensor:
        """``chunks`` (k, ...), k the ranks of ``group`` (None: of the
        process group): chunk j goes to its rank j; returns (k, ...) whose
        chunk i came from its rank i."""
        t0 = time.perf_counter()
        src = chunks.contiguous()
        send, host = self._host(src)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        out = recv.to(src.device) if host else recv
        # sent and received, less this rank's own chunk
        self._count("all_to_all", 2 * send.nbytes * (1 - 1 / len(src)), t0,
                    send.nbytes)
        return out

    def ring_all_to_all(self, chunks: torch.Tensor, peers, me: int
                        ) -> torch.Tensor:
        """``all_to_all`` over the ranks ``peers`` (global ranks, in
        group order; this rank is ``peers[me]``) in len(peers) - 1
        point-to-point rounds: round s sends chunk (me + s) mod k to that
        peer and receives peer (me - s) mod k's chunk into its slot; this
        rank's own chunk never leaves it. The result is position for
        position the fused collective's."""
        t0 = time.perf_counter()
        src = chunks.contiguous()
        buf, host = self._host(src)
        out = buf.clone()
        k = len(peers)
        for s in range(1, k):
            to, frm = (me + s) % k, (me - s) % k
            ops = [dist.P2POp(dist.irecv, out[frm], peers[frm]),
                   dist.P2POp(dist.isend, buf[to].contiguous(), peers[to])]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        nb = buf.nbytes * (k - 1) // k
        self._count("p2p", 2 * nb, t0, nb)
        return out.to(src.device) if host else out

    def all_gather(self, t: torch.Tensor, group=None, size: int = None
                   ) -> torch.Tensor:
        """Every rank's ``t`` of ``group`` (None: the process group; its
        ``size`` ranks), concatenated along dim 0 in group order."""
        t0 = time.perf_counter()
        src = t.contiguous()
        send, host = self._host(src)
        k = size if size is not None else world_size()
        parts = [torch.empty_like(send) for _ in range(k)]
        dist.all_gather(parts, send, group=group)
        out = torch.cat(parts)
        out = out.to(src.device) if host else out
        self._count("all_gather", 2 * send.nbytes * (k - 1), t0, send.nbytes)
        return out

    def all_reduce_sum_(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """Sum ``t`` over the ranks (of ``group``; None: the process
        group), in place; every rank gets the same bits."""
        return self._all_reduce(t, dist.ReduceOp.SUM, group)

    def all_reduce_max_(self, t: torch.Tensor, group=None) -> torch.Tensor:
        """The elementwise max of ``t`` over the ranks (of ``group``), in
        place. Counted under "all_reduce"."""
        return self._all_reduce(t, dist.ReduceOp.MAX, group)

    def _all_reduce(self, t: torch.Tensor, op, group) -> torch.Tensor:
        t0 = time.perf_counter()
        if self.staged and t.is_cuda:
            h = t.cpu()
            dist.all_reduce(h, op=op, group=group)
            t.copy_(h)
        else:
            dist.all_reduce(t, op=op, group=group)
        self._count("all_reduce", 2 * t.nbytes, t0, t.nbytes)
        return t

    def reduce_scatter_sum(self, chunks: torch.Tensor, group=None
                           ) -> torch.Tensor:
        """``chunks`` (k, ...), k the ranks of ``group`` (None: of the
        process group), chunk j this rank's part of rank j's share: the
        sum over the ranks of their chunk for this rank, added in group
        order from the first rank's (((c0 + c1) + c2) ...), so every
        position sums in one order whatever rank computes it. One
        all-to-all moves the chunks (gloo has no reduce-scatter); its
        bytes are counted here, under "reduce_scatter"."""
        t0 = time.perf_counter()
        src = chunks.contiguous()
        send, host = self._host(src)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        got = recv.to(src.device) if host else recv
        out = got[0].clone()
        for i in range(1, len(got)):
            out += got[i]
        self._count("reduce_scatter", 2 * send.nbytes * (1 - 1 / len(src)),
                    t0, send.nbytes)
        return out

    # ---- rank-wide decisions and host gathers (checkpoints, the loops) --
    # Like every collective here, each is issued by every rank in the same
    # order, on the main thread: a rank that skips one, or issues it from
    # another thread, hangs the others.
    def _on_wire(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t if self._wire is None else t.to(self._wire)

    def broadcast_object(self, obj: Any = None, src: int = 0) -> Any:
        """Rank ``src``'s ``obj`` (a picklable value: a manifest entry, a
        decision) on every rank; the other ranks' ``obj`` is ignored."""
        t0 = time.perf_counter()
        box = [obj if rank() == src else None]
        dist.broadcast_object_list(box, src=src, device=self._wire)
        self._count("broadcast", 0, t0)
        return box[0]

    def gather_host(self, a: np.ndarray, dst: int = 0
                    ) -> Optional[List[np.ndarray]]:
        """Every rank's host array ``a`` (the same shape and dtype on
        every rank) on rank ``dst``, in rank order, as fresh arrays; None
        on the other ranks."""
        t0 = time.perf_counter()
        src = self._on_wire(a)
        me = rank()
        parts = ([torch.empty_like(src) for _ in range(world_size())]
                 if me == dst else None)
        dist.gather(src, parts, dst=dst)
        nb = src.numel() * src.element_size()
        self._count("gather", nb * (world_size() - 1 if me == dst else 1),
                    t0, nb)
        return None if parts is None else [p.cpu().numpy() for p in parts]

    def all_gather_host(self, a: np.ndarray) -> np.ndarray:
        """Every rank's host array ``a`` (the same shape and dtype on
        every rank) joined along dim 0 in rank order, on every rank."""
        return self.all_gather(self._on_wire(a)).cpu().numpy()

    def all_true(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank (one all-reduce of an
        int)."""
        t = self._on_wire(np.asarray([0 if flag else 1], np.int64))
        return int(self.all_reduce_sum_(t)) == 0

