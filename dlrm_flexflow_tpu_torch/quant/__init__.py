"""Quantized storage for the port (the counterpart of
``dlrm_flexflow_tpu.quant``): the row-wise codec and ``QuantTable``.
The quant policy of the JAX package (master-resident simulated
quantization in training) is not ported yet."""

from .codec import (decode_q, dequantize_rows, encode_q, quantize_rows,
                    validate_scales)
from .store import QuantTable

__all__ = ["QuantTable", "decode_q", "dequantize_rows", "encode_q",
           "quantize_rows", "validate_scales"]
