"""Leveled logging shim.

The reference uses logr verbosity levels DEBUG=4 / TRACE=5
(pkg/utils/logging/levels.go:17-20).  We map them onto stdlib logging with a
TRACE level below DEBUG so per-stage trace logs along the hot paths stay
cheap and filterable.

Copied from the JAX reference's ``utils/logging.py``.
"""

from __future__ import annotations

import logging
import os

TRACE = 5
logging.addLevelName(TRACE, "TRACE")


def get_logger(name: str) -> logging.Logger:
    logger = logging.getLogger(f"kvtpu.{name}")
    if not logging.getLogger("kvtpu").handlers:
        _configure_root()
    return logger


def _configure_root() -> None:
    root = logging.getLogger("kvtpu")
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    )
    root.addHandler(handler)
    level_name = os.environ.get("KVTPU_LOG_LEVEL", "INFO").strip().upper()
    try:
        root.setLevel(TRACE if level_name == "TRACE" else level_name)
    except ValueError:
        root.setLevel(logging.INFO)
        root.warning(
            "invalid KVTPU_LOG_LEVEL %r, falling back to INFO", level_name
        )
    root.propagate = False


def trace(logger: logging.Logger, msg: str, *args) -> None:
    if logger.isEnabledFor(TRACE):
        logger.log(TRACE, msg, *args)
