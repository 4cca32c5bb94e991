"""Recurrent ops: ``LSTM`` and ``LSTMStack`` (the counterparts of
``dlrm_flexflow_tpu.ops.rnn``).

Names, parameter names (``wx``, ``wh``, ``bias``; ``wx{l}``, ``wh{l}``,
``bias{l}`` per layer), shapes, the (d, 4h) layouts and the i, f, g, o
gate order are the JAX ops', so ``utils.weights.params_from_jax``
carries weights across unchanged.

Each layer takes the JAX package's resident route (ops/rnn.py:318-335
there): the input projection ``xproj = x·wx + bias`` as one
sequence-wide product, then the recurrence alone on the scan kernels
(``ops/kernels/lstm.py``: one forward launch per layer, one backward
launch per layer in the gradient). The product is ``torch.matmul`` on
the compute-dtype-rounded operands in fp32, as the port's ``Linear``
computes it (JAX's ``preferred_element_type=float32``); the recurrent
weights are cast to the compute dtype once, outside the scan. The JAX
package's fused single-scan fallback answers XLA streaming wh on the
TPU and has no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..core.initializers import DEFAULT_KERNEL_INIT, ZeroInitializer
from ..core.op import Op, ParamDef
from .kernels.lstm import lstm_scan


def lstm_layer(x, wx, wh, bias, cdt):
    """One LSTM layer over (b, s, d) -> (b, s, h) fp32, time-major
    inside (the kernels' layout)."""
    xt = x.transpose(0, 1)                                  # (s, b, d)
    xproj = torch.matmul(xt.to(cdt).float(), wx.to(cdt).float()) + bias
    return lstm_scan(xproj, wh.to(cdt)).transpose(0, 1)


class LSTM(Op):
    """input (batch, seq, in_dim) -> output (batch, seq, hidden); the
    final state is discarded (sequence-to-sequence layer form)."""

    type_name = "LSTM"

    def __init__(self, model, input_tensor, hidden: int,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        if input_tensor.num_dims != 3:
            raise ValueError("LSTM expects (batch, seq, in_dim)")
        b, s, d = input_tensor.shape
        self.in_dim = d
        self.hidden = int(hidden)
        self.outputs = [self._make_output((b, s, self.hidden))]

    def param_defs(self) -> Dict[str, ParamDef]:
        h, d = self.hidden, self.in_dim
        return {
            "wx": ParamDef((d, 4 * h), torch.float32, DEFAULT_KERNEL_INIT()),
            "wh": ParamDef((h, 4 * h), torch.float32, DEFAULT_KERNEL_INIT()),
            "bias": ParamDef((4 * h,), torch.float32, ZeroInitializer()),
        }

    def apply(self, params, xs):
        (x,) = xs
        hs = lstm_layer(x, params["wx"], params["wh"], params["bias"],
                         self.model.compute_dtype)
        return [hs.to(x.dtype)]


class LSTMStack(Op):
    """``num_layers`` stacked LSTM layers: input (batch, seq, in_dim) ->
    output (batch, seq, hidden) of the top layer, run layer by layer."""

    type_name = "LSTMStack"

    def __init__(self, model, input_tensor, hidden: int, num_layers: int,
                 name: Optional[str] = None):
        super().__init__(model, [input_tensor], name)
        if input_tensor.num_dims != 3:
            raise ValueError("LSTMStack expects (batch, seq, in_dim)")
        if num_layers < 1:
            raise ValueError("num_layers must be >= 1")
        b, s, d = input_tensor.shape
        self.in_dim = d
        self.hidden = int(hidden)
        self.num_layers = int(num_layers)
        self.outputs = [self._make_output((b, s, self.hidden))]

    def param_defs(self) -> Dict[str, ParamDef]:
        h = self.hidden
        defs = {}
        for layer in range(self.num_layers):
            d = self.in_dim if layer == 0 else h
            defs[f"wx{layer}"] = ParamDef((d, 4 * h), torch.float32,
                                          DEFAULT_KERNEL_INIT())
            defs[f"wh{layer}"] = ParamDef((h, 4 * h), torch.float32,
                                          DEFAULT_KERNEL_INIT())
            defs[f"bias{layer}"] = ParamDef((4 * h,), torch.float32,
                                            ZeroInitializer())
        return defs

    def apply(self, params, xs):
        (x,) = xs
        cur = x
        for l in range(self.num_layers):
            cur = lstm_layer(cur, params[f"wx{l}"], params[f"wh{l}"],
                              params[f"bias{l}"], self.model.compute_dtype)
        return [cur.to(x.dtype)]
