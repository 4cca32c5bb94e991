"""Online serving for the port (see engine.py)."""

from .engine import (DeadlineExceeded, InferenceEngine, Overloaded,
                     Prediction, ServeConfig)

__all__ = ["DeadlineExceeded", "InferenceEngine", "Overloaded",
           "Prediction", "ServeConfig"]
