"""The mesh over ranks, the counterpart of
``dlrm_flexflow_tpu.parallel.mesh``.

The JAX package builds a ``jax.sharding.Mesh`` with one axis per prime
factor of the device count, largest first (8 devices: axes f0, f1, f2
of size 2), so that any degree made of a run of consecutive factors has
its axes (``parallel.sharding``). The port has no device mesh object:
its ranks are processes of one ``torch.distributed`` group, one card
each (or several on one card, ``parallel.distributed``). ``Mesh`` here
is the same shape over ranks: the same axis names and sizes in the same
order, the ranks laid out row-major over them in rank order (as the
JAX mesh reshapes its device list), and a rank's coordinate on each
axis. ``compile`` places every op on it; the collectives run on the
process group.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple


def _prime_factors(n: int) -> List[int]:
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


def structural_axis_sizes(n: int) -> List[int]:
    """The axis sizes ``make_mesh`` builds for n ranks (largest prime
    factor first), as the JAX package's."""
    return sorted(_prime_factors(n), reverse=True) or [1]


@dataclass(frozen=True)
class Mesh:
    """Named axes over ranks: ``axis_names`` ("f0", "f1", ...) of
    ``axis_sizes``, and ``ranks``, the ranks in row-major order over the
    axes."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    ranks: Tuple[int, ...]

    def __post_init__(self):
        n = 1
        for s in self.axis_sizes:
            n *= s
        if len(self.axis_names) != len(self.axis_sizes) \
                or n != len(self.ranks):
            raise ValueError(f"mesh axes {self.axis_names} of sizes "
                             f"{self.axis_sizes} do not hold "
                             f"{len(self.ranks)} ranks")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.ranks)

    def coords(self, rank: int) -> Dict[str, int]:
        """``rank``'s index on each axis."""
        if rank not in self.ranks:
            raise ValueError(f"rank {rank} is not on the mesh {self.ranks}")
        i, out = self.ranks.index(rank), {}
        for name, size in reversed(list(zip(self.axis_names,
                                            self.axis_sizes))):
            out[name] = i % size
            i //= size
        return {name: out[name] for name in self.axis_names}

    def linear_index(self, rank: int, axes: Sequence[str]) -> int:
        """``rank``'s index over ``axes`` taken together, in the given
        order (the first axis the slowest): its block of a dimension
        sharded over those axes."""
        c, i = self.coords(rank), 0
        for a in axes:
            i = i * self.shape[a] + c[a]
        return i


def make_mesh(devices: Optional[Sequence[int]] = None,
              num_devices: Optional[int] = None) -> Mesh:
    """A factorized mesh over ``devices`` (ranks; default every rank of
    the process group, or rank 0 without one), the first ``num_devices``
    of them when given; more than there are raises, as in the JAX
    package."""
    if devices is None:
        from .distributed import world_size
        devices = list(range(world_size()))
        if num_devices is not None:
            if num_devices > len(devices):
                raise ValueError(
                    f"requested {num_devices} devices but only "
                    f"{len(devices)} rank(s) are in the process group "
                    f"(launch more ranks with torchrun, or pass the "
                    f"ranks as devices=)")
            devices = devices[:num_devices]
    devices = tuple(int(d) for d in devices)
    sizes = tuple(structural_axis_sizes(len(devices)))
    names = tuple(f"f{i}" for i in range(len(sizes)))
    return Mesh(names, sizes, devices)


def mesh_axis_sizes(mesh: Mesh) -> List[int]:
    return list(mesh.axis_sizes)


def total_devices(mesh: Mesh) -> int:
    return mesh.size
