"""Optimizers (the counterpart of ``dlrm_flexflow_tpu.core.optimizers``):
``SGDOptimizer`` with momentum, nesterov and weight decay, and
``AdamOptimizer``, each with its dense ``update``, its touched-rows
``sparse_row_update`` and that update's numpy twin for host-resident
tables, ``sparse_row_update_np``.

State mirrors the parameters: ``{slab: {op_name: {param_name:
tensor}}}``, plus Adam's int32 ``"step"`` (a 0-d tensor on the
parameters' device), as in the JAX package. Where the JAX package
returns new arrays (and donates the old ones), ``update`` here writes
the parameters and the state IN PLACE and returns them.

The row math lives in one place, ``ops.kernels.scatter_rows.
row_update_reference``, in the JAX optimizers' operation order: the
dense ``update`` runs it on whole parameters (``ops.kernels.
dense_update``: on the card one multi-tensor kernel launch for all of
them), the touched-rows kernel's plain version on gathered rows, and
both CUDA kernels repeat it (``csrc/row_math.cuh``).
``row_params()`` hands it the hyperparameters. Adam's step size alpha_t
is looked up on the device from the step (``alpha_t``), in a table of
the fp32 values that the CPU computes (``adam_step_sizes``), so no step
waits for the host and every device gives JAX's value.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops.kernels.dense_update import dense_update
from ..ops.kernels.scatter_rows import row_update_reference, slab_names


class Optimizer:
    def init_state(self, params) -> Dict[str, Any]:
        raise NotImplementedError

    def row_params(self) -> Dict[str, Any]:
        """The hyperparameters of the row math (see
        ``row_update_reference``)."""
        raise NotImplementedError

    def alpha_t(self, step) -> Optional[torch.Tensor]:
        """The step size for the pre-increment ``step``, where the row
        math needs one (Adam); else None."""
        return None

    @torch.no_grad()
    def update(self, params, grads, state, ok=None):
        """Apply one step in place, through ``dense_update`` over every
        parameter (one kernel launch on the card); returns (params,
        state). ``ok``, the anomaly sentinel's 0-d int32 flag on the
        parameters' device (None: no sentinel), guards the step: where it
        is 0 the parameters and the state keep their values and Adam's
        step does not advance (it advances by ``ok``), as the JAX step
        keeps its pre-step state, with no wait for the device."""
        names = self.sparse_slab_names()
        alpha_t = self.alpha_t(state["step"]) if "step" in state else None
        keys = [(op, pn) for op, ps in params.items() for pn in ps]
        dense_update([params[op][pn] for op, pn in keys],
                     [grads[op][pn] for op, pn in keys],
                     [{k: state[k][op][pn] for k in names}
                      for op, pn in keys],
                     self.row_params(), alpha_t, ok)
        if "step" in state:
            state["step"].add_(1 if ok is None else ok)
        return params, state

    def sparse_slab_names(self) -> tuple:
        """Table-shaped state slabs a touched-rows update must carry."""
        return slab_names(self.row_params())

    @torch.no_grad()
    def sparse_row_update(self, w, g, slabs, touched, step):
        """The JAX contract (core/optimizers.py:53 there): update gathered
        rows w by g (m, k) fp32 with state ``slabs`` {name: (m, k)}, only
        where ``touched`` (m, k) bool; ``step`` the pre-increment step.
        Untouched lanes keep their weight and state. Returns (new_w,
        new_slabs); the inputs are left as they were."""
        wn = w.clone()
        sn = {k: v.clone() for k, v in slabs.items()}
        row_update_reference(wn, g, sn, self.row_params(),
                             self.alpha_t(step))
        return (torch.where(touched, wn, w),
                {k: torch.where(touched, sn[k], slabs[k]) for k in sn})

    def sparse_row_update_np(self, w, g, slabs, step):
        """The host twin of the touched-rows update, for host-resident
        tables: numpy rows w, g (m, k), all touched and their duplicates
        summed, state ``slabs`` {name: (m, k)}, ``step`` the
        pre-increment step; the JAX optimizers' numpy expressions as
        they are. Returns (new_w, new_slabs)."""
        raise NotImplementedError


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

    def row_params(self):
        return {"kind": "sgd", "lr": self.lr, "momentum": self.momentum,
                "nesterov": self.nesterov,
                "weight_decay": self.weight_decay}

    def sparse_row_update_np(self, w, g, slabs, step):
        lr, m, wd = self.lr, self.momentum, self.weight_decay
        gt = g + wd * w if wd > 0.0 else g
        if m > 0.0:
            vn = m * slabs["v"] + gt
            d = gt + m * vn if self.nesterov else vn
            return w - lr * d, {"v": vn}
        return w - lr * gt, {}


class AdamOptimizer(Optimizer):
    """Adam (the reference's adam_update): an int32 step count in the
    state, and the bias correction folded into alpha_t = alpha *
    sqrt(1 - beta2^t) / (1 - beta1^t), t = step + 1, in fp32:

        gt = g + weight_decay * w
        m  = beta1 * m + (1 - beta1) * gt
        v  = beta2 * v + (1 - beta2) * gt * gt
        w  = w - alpha_t * m / (sqrt(v) + epsilon)
    """

    def __init__(self, alpha=0.001, beta1=0.9, beta2=0.999,
                 weight_decay=0.0, epsilon=1e-8):
        self.alpha = float(alpha)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self.weight_decay = float(weight_decay)
        self.epsilon = float(epsilon)
        self._step_sizes = adam_step_sizes(self.alpha, self.beta1,
                                           self.beta2)
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def init_state(self, params):
        def zeros():
            return {op: {pn: torch.zeros_like(v) for pn, v in p.items()}
                    for op, p in params.items()}

        w = next((v for p in params.values() for v in p.values()), None)
        return {"m": zeros(), "v": zeros(),
                "step": torch.zeros((), dtype=torch.int32,
                                    device=None if w is None else w.device)}

    def row_params(self):
        return {"kind": "adam", "beta1": self.beta1, "beta2": self.beta2,
                "weight_decay": self.weight_decay, "epsilon": self.epsilon}

    def sparse_row_update_np(self, w, g, slabs, step):
        t = float(step) + 1.0
        alpha_t = (self.alpha * np.sqrt(1.0 - self.beta2 ** t)
                   / (1.0 - self.beta1 ** t))
        wd, b1, b2, eps = (self.weight_decay, self.beta1, self.beta2,
                           self.epsilon)
        gt = g + wd * w if wd > 0.0 else g
        mn = b1 * slabs["m"] + (1.0 - b1) * gt
        vn = b2 * slabs["v"] + (1.0 - b2) * gt * gt
        return w - alpha_t * mn / (np.sqrt(vn) + eps), {"m": mn, "v": vn}

    def alpha_t(self, step):
        """alpha * sqrt(1 - beta2^t) / (1 - beta1^t) for t = step + 1, as
        fp32 tensor(s) of the step's shape on the step's device: a gather
        from ``adam_step_sizes``' table, whose last entry holds for every
        later step. Nothing is read back to the host, and the step on the
        device picks the value, so a captured step stays right."""
        table = self._tables.get(step.device)
        if table is None:
            table = torch.from_numpy(self._step_sizes).to(step.device)
            self._tables[step.device] = table
        idx = torch.clamp(step, 0, table.numel() - 1).to(torch.int64)
        return torch.take(table, idx)


def adam_step_sizes(alpha: float, beta1: float, beta2: float) -> np.ndarray:
    """Adam's fp32 step sizes alpha_t for steps 0, 1, 2, ... (t = step +
    1), computed on the host as JAX computes them under ``jit`` on the
    CPU: beta ** t by the C library's ``powf`` (numpy's float32 scalar
    power), then 1 - p, the square root, the product and the quotient in
    fp32, each correctly rounded. An fp32 power taken on the card, or a
    correctly rounded one, differs from it at some steps (ROADMAP queue
    3). The table ends at the first step whose beta1 ** t and beta2 ** t
    are both at most 2^-26: from there on 1 - p rounds to 1, so that last
    entry, fp32(alpha), is alpha_t for every later step: about 18,000
    entries for beta2 = 0.999 (20 ms), 180,000 for 0.9999."""
    if not (0.0 <= beta1 < 1.0 and 0.0 <= beta2 < 1.0):
        raise ValueError(f"Adam's betas must lie in [0, 1), got "
                         f"{beta1}, {beta2}")
    f32 = np.float32
    b1, b2, tiny = f32(beta1), f32(beta2), f32(2.0 ** -26)
    p1, p2 = [], []
    t = 1
    while True:
        p1.append(b1 ** f32(t))
        p2.append(b2 ** f32(t))
        if p1[-1] <= tiny and p2[-1] <= tiny:
            break
        t += 1
    one = f32(1.0)
    # the square root in float64, rounded once: exact for fp32
    root = np.sqrt((one - np.asarray(p2, np.float32)).astype(
        np.float64)).astype(np.float32)
    return (f32(alpha) * root / (one - np.asarray(p1, np.float32))
            ).astype(np.float32)
