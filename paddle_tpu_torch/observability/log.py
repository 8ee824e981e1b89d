"""Shared logger namespace. Every framework component logs under
`paddle_tpu_torch.<component>` so one env knob (PADDLE_TPU_LOG_LEVEL) controls
the whole tree and library users can re-route it with standard logging
config. A StreamHandler is attached to the root `paddle_tpu_torch` logger only
if the application hasn't configured one — never hijack an existing
logging setup."""
from __future__ import annotations

import logging
import os

_configured = False


def get_logger(name: str = "") -> logging.Logger:
    global _configured
    root = logging.getLogger("paddle_tpu_torch")
    if not _configured:
        _configured = True
        if not root.handlers and not logging.getLogger().handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname)s %(name)s: %(message)s"))
            root.addHandler(h)
        level = os.environ.get("PADDLE_TPU_LOG_LEVEL", "WARNING").upper()
        root.setLevel(getattr(logging, level, logging.WARNING))
    return root.getChild(name) if name else root
