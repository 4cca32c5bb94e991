"""Parameter initializers on an explicit ``torch.Generator``.

The counterparts of ``dlrm_flexflow_tpu.core.initializers``. JAX's
threefry and torch's Philox never draw the same numbers, so these match
the JAX initializers in distribution only; parity between the two
packages goes through ``utils.weights.params_from_jax``.

Each initializer is called as ``init(generator, shape, dtype, device)``
and draws on ``device`` from ``generator``, which must live there too.
"""

from __future__ import annotations

import torch


class Initializer:
    def __call__(self, generator: torch.Generator, shape, dtype,
                 device) -> torch.Tensor:
        raise NotImplementedError


class GlorotUniform(Initializer):
    """limit = sqrt(6 / (fan_in + fan_out)), fans from the last two dims
    (rank >= 3 scales them by the receptive field), as in the JAX
    package."""

    def __call__(self, generator, shape, dtype, device):
        if len(shape) >= 3:
            receptive = 1
            for d in shape[2:]:
                receptive *= d
            fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
        elif len(shape) == 2:
            fan_in, fan_out = shape[0], shape[1]
        else:
            fan_in = fan_out = shape[0]
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        return torch.empty(shape, dtype=dtype, device=device).uniform_(
            -limit, limit, generator=generator)


class ZeroInitializer(Initializer):
    def __call__(self, generator, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


class UniformInitializer(Initializer):
    def __init__(self, min_val: float = -0.05, max_val: float = 0.05):
        self.min_val = float(min_val)
        self.max_val = float(max_val)

    def __call__(self, generator, shape, dtype, device):
        return torch.empty(shape, dtype=dtype, device=device).uniform_(
            self.min_val, self.max_val, generator=generator)


DEFAULT_KERNEL_INIT = GlorotUniform
DEFAULT_BIAS_INIT = ZeroInitializer
