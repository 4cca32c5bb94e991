"""Carry a JAX model's weights into the port.

JAX's threefry and torch's Philox never draw the same numbers, so the
two packages agree only when the port runs the JAX model's own weights.
``params_from_jax`` takes the JAX ``FFModel.params`` as numpy
(``{op_name: {param_name: array}}``) and returns the port's parameters
for ``model``, ready for ``model.swap_params``:

- Linear and FusedDotInteraction parameters carry over as they are;
- an EmbeddingBagStacked kernel is stored by the JAX op lane-packed as
  (T, N/r, r·d) in storage order: it is reshaped to (T, N, d) and the
  op's ``_table_order`` (stored slot s holds logical table order[s]) is
  undone, giving the port's logical layout. Set the same order on the
  port's op (``set_table_order``) that the JAX op carries.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..ops.embedding import EmbeddingBagStacked


def params_from_jax(model, params_np: Dict[str, Dict[str, np.ndarray]]
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {}
    for op in model.ops:
        defs = op.param_defs()
        if not defs:
            continue
        if op.name not in params_np:
            raise KeyError(f"JAX params hold no op {op.name!r}")
        src = params_np[op.name]
        mine = {}
        for pn, d in defs.items():
            v = np.array(src[pn], dtype=np.float32)   # a writable copy
            if isinstance(op, EmbeddingBagStacked) and pn == "kernel":
                v = v.reshape(op.num_tables, op.num_entries, op.out_dim)
                if op._table_order is not None:
                    inv = np.argsort(np.asarray(op._table_order))
                    v = v[inv]
            if tuple(v.shape) != tuple(d.shape):
                raise ValueError(f"{op.name}.{pn}: JAX array of shape "
                                 f"{v.shape}, the port expects {d.shape}")
            mine[pn] = torch.from_numpy(np.ascontiguousarray(v)).to(
                device=model.device, dtype=d.dtype)
        out[op.name] = mine
    return out
