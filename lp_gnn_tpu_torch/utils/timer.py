"""Wall-clock timing helpers: the port's copy of
``lp_gnn_tpu/utils/timer.py`` (role of reference utils.py:27-78,
500-510). Host code: it times the host's clock and imports no torch;
device time is read with CUDA events where a caller needs it."""
from __future__ import annotations

import functools
import logging
import time


class Timer:
    """Wall-clock timer with named checkpoints.

    >>> t = Timer()
    >>> dt = t.since_last_check('stage-1')   # seconds since construction
    >>> total = t.since_start()
    """

    def __init__(self):
        self.start = time.time()
        self.last = self.start

    def since_start(self, msg: str = "", verbose: bool = False) -> float:
        dt = time.time() - self.start
        if verbose and msg:
            logging.info("%s %.3fs", msg, dt)
        return dt

    def since_last_check(self, msg: str = "", verbose: bool = False) -> float:
        now = time.time()
        dt = now - self.last
        self.last = now
        if verbose and msg:
            logging.info("%s %.3fs", msg, dt)
        return dt


def timed(func):
    """Decorator logging the execution time of ``func``."""

    @functools.wraps(func)
    def wrap(*args, **kwargs):
        t0 = time.time()
        result = func(*args, **kwargs)
        logging.info("%r executed in %.2fs", func.__name__, time.time() - t0)
        return result

    return wrap


# reference utils.py:500-510 name
timer_func = timed
