"""dlrm_flexflow_tpu_torch — the PyTorch/CUDA port of dlrm_flexflow_tpu.

A second package beside the JAX one, held against it op by op. It
imports torch and numpy and nothing of JAX or of ``dlrm_flexflow_tpu``.
Its hand-written CUDA kernels (``csrc/``) replace the JAX package's
Pallas TPU kernels and are built with nvcc at first use; on CPU tensors
every kernel wrapper runs its plain PyTorch version instead.

Ported so far: the DLRM serving path (``FFModel.forward_bucket`` under
``serve.InferenceEngine``) and the DLRM training step
(``FFModel.train_batch_device`` and ``fit``) under SGD (momentum,
nesterov, weight decay) and Adam, the tables on the lazy touched-rows
update, in the "cat" and the fused "dot" interaction, guarded by the
anomaly sentinel (``FFConfig.anomaly_policy``; ``AnomalyError``), with
``fit``'s checkpoints, rollback and whole-dataset staging and
``fit_stream`` over ``data.stream`` and ``data.replay`` sources; the
retrieve -> rank cascade (``retrieve``); NMT LSTM seq2seq training
(``models.nmt.build_nmt``); and DLRM training across ranks, one process
a rank, under the reference's strategy files (``parallel``).
"""

from .config import FFConfig
from .core.model import AnomalyError, FFModel
from .core.tensor import Tensor

__all__ = ["AnomalyError", "FFConfig", "FFModel", "Tensor"]
