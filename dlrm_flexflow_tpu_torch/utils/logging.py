"""Category logging channels (own copy of
``dlrm_flexflow_tpu.utils.logging``).

Channels are stdlib loggers under the ``ff.`` namespace; verbosity comes
from ``$FF_LOG`` ("debug", "info", "warning", default "warning") or per
channel from ``$FF_LOG_<CHANNEL>``.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = {"debug": logging.DEBUG, "info": logging.INFO,
           "warning": logging.WARNING, "error": logging.ERROR,
           "spew": logging.DEBUG}

_configured = False


class _Strip(logging.Filter):
    """Drop the "ff." prefix from the channel tag."""

    def filter(self, record):
        record.name = record.name.removeprefix("ff.")
        return True


def _configure_root():
    global _configured
    if _configured:
        return
    root = logging.getLogger("ff")
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("[ff.%(name)s] %(levelname)s: %(message)s"))
    handler.addFilter(_Strip())
    root.addHandler(handler)
    root.propagate = False
    root.setLevel(_LEVELS.get(os.environ.get("FF_LOG", "warning").lower(),
                              logging.WARNING))
    _configured = True


def get_logger(channel: str) -> logging.Logger:
    """Channel logger, e.g. ``get_logger("checkpoint")``."""
    _configure_root()
    lg = logging.getLogger(f"ff.{channel}")
    env = os.environ.get(f"FF_LOG_{channel.upper()}")
    if env:
        lg.setLevel(_LEVELS.get(env.lower(), logging.WARNING))
    return lg
