"""Online serving for the port: the dynamic-batching engine
(engine.py), its snapshot watcher (watcher.py), the host-table row cache
(cache.py), the row-sharded lookup tier (shardtier.py), the wire
protocol and its transports (wire.py, transport.py, shard_server.py),
and the replica fleet with its router and autoscaler (fleet.py,
router.py, autoscale.py)."""

from .autoscale import AutoscaleConfig, Autoscaler
from .cache import EmbeddingCache
from .engine import (DeadlineExceeded, InferenceEngine, Overloaded,
                     Prediction, ReplicaDown, ServeConfig, percentile)
from .fleet import CircuitBreaker, Fleet, Replica
from .router import FleetRouter, FleetUnavailable, RouterConfig
from .shardtier import (EmbeddingShard, EmbeddingShardSet, ShardDown,
                        ShardLookupTimeout, ShardReplica, ShardTierConfig,
                        ShardTierUnavailable)
from .transport import (EngineServer, InprocTransport, RemoteEngineClient,
                        RemoteShard, ShardServer, SnapshotServer,
                        SnapshotWireSource, WireClient, WireError,
                        WireRemoteError, WireServer, measured_rtt_floor,
                        wire_stats)
from .watcher import SnapshotWatcher
from .wire import FrameError

__all__ = ["AutoscaleConfig", "Autoscaler", "CircuitBreaker",
           "DeadlineExceeded", "EmbeddingCache", "EmbeddingShard",
           "EmbeddingShardSet", "EngineServer", "Fleet", "FleetRouter",
           "FleetUnavailable", "FrameError", "InferenceEngine",
           "InprocTransport", "Overloaded", "Prediction", "RemoteEngineClient",
           "RemoteShard", "Replica", "ReplicaDown", "RouterConfig",
           "ServeConfig", "ShardDown", "ShardLookupTimeout", "ShardReplica",
           "ShardServer", "ShardTierConfig", "ShardTierUnavailable",
           "SnapshotServer", "SnapshotWatcher", "SnapshotWireSource",
           "WireClient", "WireError", "WireRemoteError", "WireServer",
           "measured_rtt_floor", "percentile", "wire_stats"]
