"""Online serving for the port: the dynamic-batching engine
(engine.py), its snapshot watcher (watcher.py), the host-table row cache
(cache.py) and the row-sharded lookup tier (shardtier.py)."""

from .cache import EmbeddingCache
from .engine import (DeadlineExceeded, InferenceEngine, Overloaded,
                     Prediction, ServeConfig)
from .shardtier import (EmbeddingShardSet, ShardTierConfig,
                        ShardTierUnavailable)
from .watcher import SnapshotWatcher

__all__ = ["DeadlineExceeded", "EmbeddingCache", "EmbeddingShardSet",
           "InferenceEngine", "Overloaded", "Prediction", "ServeConfig",
           "ShardTierConfig", "ShardTierUnavailable", "SnapshotWatcher"]
