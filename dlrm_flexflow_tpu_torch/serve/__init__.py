"""Online serving for the port: the dynamic-batching engine
(engine.py) and its snapshot watcher (watcher.py)."""

from .engine import (DeadlineExceeded, InferenceEngine, Overloaded,
                     Prediction, ServeConfig)
from .watcher import SnapshotWatcher

__all__ = ["DeadlineExceeded", "InferenceEngine", "Overloaded",
           "Prediction", "ServeConfig", "SnapshotWatcher"]
