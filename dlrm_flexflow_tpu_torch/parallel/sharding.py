"""Partition degrees to mesh axes, the counterpart of
``dlrm_flexflow_tpu.parallel.sharding``.

The JAX package turns each op's degrees into a ``PartitionSpec`` over
the factorized mesh (parallel/mesh.py) and leaves the placement to
GSPMD. The port keeps the same assignment, as plain data: for each
dimension, the tuple of mesh axes it is split over (``()`` when whole).
``assign_indices`` is the one rule, shared by ``AxisAssigner``, the
feasibility checks and the strategy validation, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .mesh import Mesh

# for each dimension, the mesh axes it is split over
Placement = List[Tuple[str, ...]]


def feasible_degrees_for(axis_sizes: Sequence[int]) -> List[int]:
    """All degrees that are the product of a run of consecutive axes, and
    1 (what ``assign_indices`` accepts)."""
    out = {1}
    n = len(axis_sizes)
    for i in range(n):
        p = 1
        for j in range(i, n):
            p *= axis_sizes[j]
            out.add(p)
    return sorted(out)


def assign_indices(degrees: Sequence[int], axis_sizes: Sequence[int]
                   ) -> "Optional[List[Tuple[int, ...]]]":
    """Each degree takes a run of consecutive unused axes, searching
    forward from the last one taken, whose sizes multiply to it: the
    axis indices of each dimension, or None when the degrees cannot all
    be placed."""
    result: List[Tuple[int, ...]] = []
    cursor = 0
    for deg in degrees:
        if deg == 1:
            result.append(())
            continue
        start = cursor
        while start < len(axis_sizes):
            p, j = 1, start
            while j < len(axis_sizes) and p < deg:
                p *= axis_sizes[j]
                j += 1
            if p == deg:
                result.append(tuple(range(start, j)))
                cursor = j
                break
            start += 1
        else:
            return None
    return result


def assignable(degrees: Sequence[int], axis_sizes: Sequence[int]) -> bool:
    """True when ``assign_indices`` places the degrees."""
    return assign_indices(degrees, axis_sizes) is not None


def clamp_degrees(degrees: Sequence[int],
                  axis_sizes: Sequence[int]) -> Tuple[int, ...]:
    """Each degree down to the largest feasible one not above it; while
    the tuple cannot be placed, the last dims shed theirs first (the
    sample dim is the cheapest parallelism to keep). Always placeable
    (all 1 at worst)."""
    feas = feasible_degrees_for(axis_sizes)
    degs = [max((f for f in feas if f <= d), default=1) for d in degrees]
    for i in range(len(degs) - 1, -1, -1):
        if assignable(degs, axis_sizes):
            break
        degs[i] = 1
    if not assignable(degs, axis_sizes):
        degs = [1] * len(degs)
    return tuple(degs)


def clamp_param_degree(param_degree: int,
                       axis_sizes: Sequence[int],
                       rows: Optional[int] = None,
                       pack: int = 1) -> int:
    """A row-shard degree down to the largest feasible one not above it;
    with ``rows``/``pack`` it must also split the table into equal blocks
    (rows divisible by degree x pack). 1 when no degree above 1 fits."""
    if param_degree <= 1:
        return 1
    feas = feasible_degrees_for(axis_sizes)
    return max((f for f in feas
                if f <= param_degree
                and (rows is None or rows % (f * max(pack, 1)) == 0)),
               default=1)


def param_axis_indices(param_degree: int,
                       axis_sizes: Sequence[int]
                       ) -> Optional[Tuple[int, ...]]:
    """The axis indices a row-shard degree takes (``assign_indices`` for
    the one degree); None when it does not factorize the mesh."""
    idx = assign_indices((param_degree,), axis_sizes)
    return idx[0] if idx is not None else None


class AxisAssigner:
    """Maps partition degrees to tuples of mesh axes, taking axes in mesh
    order, so equal degrees on the same dimension get the same axes."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.axis_names = list(mesh.axis_names)
        self.axis_sizes = list(mesh.axis_sizes)

    def feasible_degrees(self) -> List[int]:
        return feasible_degrees_for(self.axis_sizes)

    def assign(self, degrees: Sequence[int]) -> Placement:
        """Each dimension's axes; raises ValueError when the degrees
        cannot all be placed."""
        idx = assign_indices(degrees, self.axis_sizes)
        if idx is None:
            raise ValueError(
                f"degrees {tuple(degrees)} not jointly expressible over "
                f"mesh axes {list(zip(self.axis_names, self.axis_sizes))}")
        return [tuple(self.axis_names[i] for i in t) for t in idx]

    def degree(self, axes: Sequence[str]) -> int:
        """The number of blocks a dimension split over ``axes`` has."""
        n = 1
        for a in axes:
            n *= self.mesh.shape[a]
        return n
