"""Uniform logging setup (reference parity: edl/utils/log_utils.py:21-33)."""

import logging
import os
import sys

_FMT = "[%(asctime)s %(levelname)s %(process)d %(filename)s:%(lineno)d] %(message)s"


def get_logger(name="edl_tpu", level=None, log_file=None):
    level = level or os.environ.get("EDL_TPU_LOG_LEVEL", "INFO")
    logger = logging.getLogger(name)
    if getattr(logger, "_edl_configured", False):
        return logger
    logger.setLevel(getattr(logging, str(level).upper(), logging.INFO))
    handler = (logging.FileHandler(log_file, mode="a")
               if log_file else logging.StreamHandler(sys.stderr))
    handler.setFormatter(logging.Formatter(_FMT))
    logger.addHandler(handler)
    logger.propagate = False
    logger._edl_configured = True
    return logger


logger = get_logger()
