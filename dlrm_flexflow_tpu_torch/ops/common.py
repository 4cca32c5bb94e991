"""Activation modes shared by the ops (the counterpart of
``dlrm_flexflow_tpu.ops.common``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

AC_MODE_NONE = "none"
AC_MODE_RELU = "relu"
AC_MODE_SIGMOID = "sigmoid"
AC_MODE_TANH = "tanh"
AC_MODE_ELU = "elu"

_ACTIVATIONS = {
    AC_MODE_NONE: lambda x: x,
    None: lambda x: x,
    AC_MODE_RELU: torch.relu,
    AC_MODE_SIGMOID: torch.sigmoid,
    AC_MODE_TANH: torch.tanh,
    AC_MODE_ELU: F.elu,
}


def apply_activation(x, activation):
    if callable(activation):
        return activation(x)
    try:
        return _ACTIVATIONS[activation](x)
    except KeyError:
        raise ValueError(f"unknown activation {activation!r}") from None
