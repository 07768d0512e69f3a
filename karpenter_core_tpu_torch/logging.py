"""Logging configuration (reference: pkg/operator/logging/logging.go:35-79):
level from --log-level, plus a NopLogger for muting simulations the way the
reference silences SimulateScheduling (helpers.go:82,91).
"""
from __future__ import annotations

import logging as _logging

_LEVELS = {
    "debug": _logging.DEBUG,
    "info": _logging.INFO,
    "warn": _logging.WARNING,
    "warning": _logging.WARNING,
    "error": _logging.ERROR,
}


def configure(level: str = "info") -> _logging.Logger:
    logger = _logging.getLogger("karpenter")
    if not logger.handlers:
        handler = _logging.StreamHandler()
        handler.setFormatter(
            _logging.Formatter(
                "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s"
            )
        )
        logger.addHandler(handler)
        logger.propagate = False
    logger.setLevel(_LEVELS.get(level.lower(), _logging.INFO))
    return logger


def nop_logger() -> _logging.Logger:
    """A logger that drops everything (logging.go:35 NopLogger)."""
    logger = _logging.getLogger("karpenter.nop")
    if not logger.handlers:
        logger.addHandler(_logging.NullHandler())
        logger.propagate = False
    logger.setLevel(_logging.CRITICAL + 1)
    return logger
