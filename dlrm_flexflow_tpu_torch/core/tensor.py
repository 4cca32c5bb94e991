"""Symbolic tensors for the FFModel graph.

The counterpart of ``dlrm_flexflow_tpu.core.tensor``: a Tensor is a node
in the model graph with a static shape (sample dim first), a torch dtype
and the op that produces it. Concrete values are ``torch.Tensor``s that
exist only while the graph runs.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from .op import Op

_tensor_guid = itertools.count(1000)

MAX_TENSOR_DIM = 5


@dataclass
class Tensor:
    shape: tuple
    dtype: torch.dtype = torch.float32
    owner_op: Optional["Op"] = None
    owner_idx: int = 0
    name: str = ""
    guid: int = field(default_factory=lambda: next(_tensor_guid))

    def __post_init__(self):
        self.shape = tuple(int(d) for d in self.shape)
        if len(self.shape) > MAX_TENSOR_DIM:
            raise ValueError(
                f"Tensor rank {len(self.shape)} exceeds MAX_TENSOR_DIM="
                f"{MAX_TENSOR_DIM}")
        if not self.name:
            self.name = f"tensor_{self.guid}"

    @property
    def num_dims(self) -> int:
        return len(self.shape)

    def __hash__(self):
        return hash(self.guid)

    def __eq__(self, other):
        return isinstance(other, Tensor) and other.guid == self.guid

    def __repr__(self):
        return (f"Tensor(name={self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, "
                f"op={self.owner_op.name if self.owner_op else None})")
