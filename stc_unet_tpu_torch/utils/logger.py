"""Root logger (≙ ``stc_unet_tpu/utils/logger.py``, itself the reference's
``mmseg/utils/logger.py:7``): the port's loggers are named
``stc_unet_tpu_torch``. In a process group, as mmcv's ``get_logger``,
only rank 0 logs at ``log_level`` and writes ``log_file``; the other
ranks log errors only, so N ranks neither repeat every line nor race on
one file."""
from __future__ import annotations

import logging
import sys

from .util_distribution import get_dist_info

_LOGGERS = {}


def get_logger(name: str = 'stc_unet_tpu_torch', log_file: str = None,
               log_level: int = logging.INFO,
               file_mode: str = 'w') -> logging.Logger:
    logger = logging.getLogger(name)
    if get_dist_info()[0] != 0:
        log_file, log_level = None, logging.ERROR
        logger.setLevel(log_level)
    if name in _LOGGERS:
        if log_file is not None and not any(
                isinstance(h, logging.FileHandler) for h in logger.handlers):
            fh = logging.FileHandler(log_file, file_mode)
            fh.setFormatter(_formatter())
            fh.setLevel(log_level)
            logger.addHandler(fh)
        return logger

    sh = logging.StreamHandler(stream=sys.stdout)
    sh.setFormatter(_formatter())
    sh.setLevel(log_level)
    logger.addHandler(sh)
    if log_file is not None:
        fh = logging.FileHandler(log_file, file_mode)
        fh.setFormatter(_formatter())
        fh.setLevel(log_level)
        logger.addHandler(fh)
    logger.setLevel(log_level)
    logger.propagate = False
    _LOGGERS[name] = True
    return logger


def _formatter():
    return logging.Formatter('%(asctime)s - %(name)s - %(levelname)s - %(message)s')


def get_root_logger(log_file=None, log_level=logging.INFO) -> logging.Logger:
    """Equivalent of reference ``get_root_logger`` (``mmseg/utils/logger.py:7``)."""
    return get_logger('stc_unet_tpu_torch', log_file, log_level)


def print_log(msg, logger=None, level=logging.INFO):
    if logger is None:
        print(msg)
    elif isinstance(logger, logging.Logger):
        logger.log(level, msg)
    elif logger == 'silent':
        pass
    elif isinstance(logger, str):
        get_logger(logger).log(level, msg)
    else:
        raise TypeError(f'Invalid logger: {logger}')
