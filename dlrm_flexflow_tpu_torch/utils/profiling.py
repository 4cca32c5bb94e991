"""Profiling hooks (the port of ``dlrm_flexflow_tpu.utils.profiling``).

- Whole-run tracing: ``TraceContext(profile_dir)`` runs a
  ``torch.profiler`` session (CPU and, where a card is visible, CUDA
  activities) around a training loop and writes its Chrome trace JSON
  into the directory; ``FFModel.fit`` and the DLRM launcher wrap their
  loops in it when ``FFConfig.profile_dir`` (``--profile-dir``) is set,
  as the JAX package wraps them in ``jax.profiler.trace``. An empty
  directory traces nothing.
- The per-op table of ``--profiling`` (``profile_ops``,
  ``format_profile``) times each op's subgraph through the strategy
  search's cost model (``search/cost_model.py``, ROADMAP queue 1 item 8)
  and is not ported yet: both raise, as the flag does (item 6).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

_PER_OP = ("the per-op profile (--profiling) times each op through the "
           "strategy search's cost model (search/cost_model.py, ROADMAP "
           "queue 1 item 8), not ported yet; it stays with ROADMAP queue 1 "
           "item 6")


def profile_ops(model, measure: bool = True) -> List[Dict]:
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_PER_OP)


def format_profile(rows: List[Dict]) -> str:
    """Not ported yet: raises ``NotImplementedError``."""
    raise NotImplementedError(_PER_OP)


class TraceContext:
    """A ``torch.profiler`` session that writes ``trace-<pid>-<ms>.json``
    (Chrome trace format) into ``profile_dir`` on exit, creating the
    directory; a no-op when ``profile_dir`` is empty. ``path`` is the
    file written, None before the exit or without a directory."""

    def __init__(self, profile_dir: Optional[str]):
        self.profile_dir = profile_dir
        self.path: Optional[str] = None
        self._prof = None

    def __enter__(self):
        if self.profile_dir:
            import torch
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        os.makedirs(self.profile_dir, exist_ok=True)
        self.path = os.path.join(
            self.profile_dir,
            f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        return False
