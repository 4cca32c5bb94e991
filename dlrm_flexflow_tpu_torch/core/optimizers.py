"""Optimizers (the counterpart of ``dlrm_flexflow_tpu.core.optimizers``):
``Optimizer`` and ``SGDOptimizer`` with momentum, nesterov and weight
decay. ``AdamOptimizer`` and the stateful touched-rows update
(``sparse_row_update``) are not ported yet (ROADMAP queue 1 item 3).

State mirrors the parameters: ``{slab: {op_name: {param_name:
tensor}}}``. Where the JAX package returns new arrays (and donates the
old ones), ``update`` here writes the parameters and the state IN PLACE
and returns them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch


class Optimizer:
    def init_state(self, params) -> Dict[str, Any]:
        raise NotImplementedError

    def update(self, params, grads, state):
        """Apply one step in place; returns (params, state)."""
        raise NotImplementedError

    def sparse_slab_names(self) -> tuple:
        """Table-shaped state slabs a touched-rows update must carry."""
        return ()


class SGDOptimizer(Optimizer):
    """SGD with momentum / nesterov / weight decay, as the reference's
    sgd_update kernel:

        gt = g + weight_decay * w
        v  = momentum * v + gt
        d  = gt + momentum * v (nesterov) | v (classic) | gt (no momentum)
        w  = w - lr * d
    """

    def __init__(self, lr=0.01, momentum=0.0, nesterov=False,
                 weight_decay=0.0):
        self.lr = float(lr)
        self.momentum = float(momentum)
        self.nesterov = bool(nesterov)
        self.weight_decay = float(weight_decay)

    def init_state(self, params):
        if self.momentum > 0.0:
            return {"v": {op: {pn: torch.zeros_like(v)
                               for pn, v in p.items()}
                          for op, p in params.items()}}
        return {}

    @torch.no_grad()
    def update(self, params, grads, state):
        lr, m, wd = self.lr, self.momentum, self.weight_decay
        for op, p in params.items():
            for pn, w in p.items():
                g = grads[op][pn]
                gt = g + wd * w if wd > 0.0 else g
                if m > 0.0:
                    v = state["v"][op][pn]
                    v.mul_(m).add_(gt)          # m * v + gt
                    d = gt + m * v if self.nesterov else v
                else:
                    d = gt
                # w - lr * d, as the JAX update writes it: lr * d rounds
                # once, then the subtraction (no fused multiply-add)
                w.sub_(lr * d)
        return params, state

    def sparse_slab_names(self):
        return ("v",) if self.momentum > 0.0 else ()
