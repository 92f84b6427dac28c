"""stderr logger with verbosity levels (reference: src/utils.cpp:89-106).

Levels accepted by the CLI: debug | info | warning | error.
"""

import logging
import sys

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}

_LOGGER_NAME = "kmdiff"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                "[%(asctime)s.%(msecs)03d] [%(levelname)s] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


#: module-level logger shared by the pipeline
logger = get_logger()


def set_verbosity_level(level: str) -> None:
    if level not in _LEVELS:
        raise ValueError(f"unknown verbosity level: {level}")
    get_logger().setLevel(_LEVELS[level])

