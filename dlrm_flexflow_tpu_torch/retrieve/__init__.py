"""Retrieval stage for the port (the counterpart of
``dlrm_flexflow_tpu.retrieve``): two-tower serving heads, the sharded
int8 MIPS index on the top-k kernel, and the retrieve -> rank cascade.

 - model.py   : the two-tower train, user and item heads
 - index.py   : the sharded MIPS index, exact heap-merge on the host
 - cascade.py : retrieve -> rank behind one deadline budget
"""

from .cascade import (CascadeConfig, CascadeEngine, CascadePrediction,
                      dlrm_candidate_features)
from .index import RetrievalResult, ShardedMIPSIndex, merge_partials
from .model import (TwoTowerConfig, build_two_tower, in_batch_labels,
                    item_embeddings, synthetic_two_tower_batch,
                    transfer_tower_params, two_tower_strategy)

__all__ = [
    "CascadeConfig", "CascadeEngine", "CascadePrediction",
    "dlrm_candidate_features",
    "RetrievalResult", "ShardedMIPSIndex", "merge_partials",
    "TwoTowerConfig", "build_two_tower", "in_batch_labels",
    "item_embeddings", "synthetic_two_tower_batch",
    "transfer_tower_params", "two_tower_strategy",
]
