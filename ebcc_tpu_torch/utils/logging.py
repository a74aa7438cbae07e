"""Env-driven logging, parity with the reference's rxi log.c usage.

The reference vendors rxi/log.c with levels TRACE..FATAL selected by
``EBCC_LOG_LEVEL`` 0..5, default WARN (reference ``src/ebcc_codec.c:431-448``,
``src/log/log.h:31-38``).  We map that contract onto Python ``logging``.
"""

from __future__ import annotations

import logging
import os

_LEVEL_MAP = {
    0: 5,  # TRACE -> custom below DEBUG
    1: logging.DEBUG,
    2: logging.INFO,
    3: logging.WARNING,
    4: logging.ERROR,
    5: logging.CRITICAL,
}

TRACE = 5
logging.addLevelName(TRACE, "TRACE")

logger = logging.getLogger("ebcc_tpu_torch")


def trace(msg, *args):
    logger.log(TRACE, msg, *args)


def set_level_from_env() -> None:
    """Parity: ``log_set_level_from_env`` (ebcc_codec.c:431-448)."""
    level = logging.WARNING
    env = os.environ.get("EBCC_LOG_LEVEL")
    if env is not None:
        try:
            level = _LEVEL_MAP.get(int(env), logging.WARNING)
        except ValueError:
            logger.warning(
                "Ignore log level: %s, should be in [0, 5]: 0 - TRACE, 1 - DEBUG, "
                "2 - INFO, 3 - WARN, 4 - ERROR, 5 - FATAL", env)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)-5s %(name)s: %(message)s"))
        logger.addHandler(handler)


set_level_from_env()
