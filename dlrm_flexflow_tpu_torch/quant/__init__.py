"""Quantized storage for the port (the counterpart of
``dlrm_flexflow_tpu.quant``): the per-table storage policy, the row-wise
codec (torch and numpy halves, and the training step's fake quantization
on the ``quant_rows`` kernel) and ``QuantTable``.

Training keeps each table as the fp32 image of its codes ("fake quant",
as the JAX package does): ``master_weight`` trains the exact fp32 master
and quantizes only at storage boundaries (delta publishes, the serving
cache, the shard tier); ``stochastic_rounding`` re-quantizes every
updated table in the step, with stochastic rounding for int8.
"""

from .codec import (decode_q, dequantize_rows, dequantize_rows_np,
                    encode_q, fake_quant, fake_quant_np,
                    fake_quant_stochastic, fake_quant_stochastic_np,
                    quantize_rows, quantize_rows_np, validate_scales)
from .policy import (DTYPES, FP32, SCALE_BYTES, UPDATE_RULES, QuantPolicy,
                     effective_policy, param_storage_bytes,
                     policy_from_config, policy_from_pc,
                     table_storage_bytes)
from .store import QuantTable

__all__ = ["DTYPES", "FP32", "SCALE_BYTES", "UPDATE_RULES", "QuantPolicy",
           "QuantTable", "decode_q", "dequantize_rows", "dequantize_rows_np",
           "effective_policy", "encode_q", "fake_quant", "fake_quant_np",
           "fake_quant_stochastic", "fake_quant_stochastic_np",
           "param_storage_bytes", "policy_from_config", "policy_from_pc",
           "quantize_rows", "quantize_rows_np", "table_storage_bytes",
           "validate_scales"]
