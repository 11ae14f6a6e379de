"""Structured per-component logging (copy of ``easydl_tpu/utils/logging.py``
without its environment knob: the level is INFO)."""

from __future__ import annotations

import logging
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT))
    root = logging.getLogger("easydl_tpu_torch")
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    root.propagate = False
    _configured = True


def get_logger(component: str, role: Optional[str] = None) -> logging.Logger:
    """Logger named ``easydl_tpu_torch.<component>[.<role>]``."""
    _configure_root()
    name = f"easydl_tpu_torch.{component}" + (f".{role}" if role else "")
    return logging.getLogger(name)

