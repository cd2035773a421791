"""The run dir's logs (counterpart of ``lp_gnn_tpu/utils/log.py``; role of
reference utils.py:418-497): ``log-ing`` (the logging records),
``log-prt`` and ``log-prt-err`` (stdout and stderr, teed)."""
from __future__ import annotations

import contextlib
import logging
import os
import sys

_FMT = "%(asctime)s %(levelname).1s %(name)s: %(message)s"


class _Tee:
    """Duplicate a text stream into a file (role of reference ``Logger``,
    utils.py:418-449): raw prints and tracebacks land in the run dir too."""

    def __init__(self, console, path: str, mode: str = "a"):
        self.console = console
        self.file = open(path, mode)

    def write(self, msg):
        self.console.write(msg)
        self.file.write(msg)

    def flush(self):
        self.console.flush()
        self.file.flush()

    def isatty(self):
        return getattr(self.console, "isatty", lambda: False)()

    @property
    def encoding(self):
        return getattr(self.console, "encoding", "utf-8")

    def fileno(self):
        return self.console.fileno()

    def close(self):   # console stays open — it is the process's own stream
        self.file.close()


def set_file_logger_prt(log_dir: str) -> None:
    """Tee stdout to ``{log_dir}/log-prt`` and stderr to ``log-prt-err``
    (reference utils.py:452-456). Idempotent per directory."""
    os.makedirs(log_dir, exist_ok=True)
    out_path = os.path.join(log_dir, "log-prt")
    err_path = os.path.join(log_dir, "log-prt-err")
    if not (isinstance(sys.stdout, _Tee)
            and sys.stdout.file.name == out_path):
        sys.stdout = _Tee(getattr(sys.stdout, "console", sys.stdout), out_path)
    if not (isinstance(sys.stderr, _Tee)
            and sys.stderr.file.name == err_path):
        sys.stderr = _Tee(getattr(sys.stderr, "console", sys.stderr), err_path)


def set_file_logger(log_dir: str, fname: str = "log-ing",
                    level: int = logging.INFO) -> str:
    """Attach a file handler writing ``{log_dir}/{fname}`` to the root
    logger (reference utils.py:490-497). Idempotent per file."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, fname)
    root = logging.getLogger()
    root.setLevel(level)
    for h in root.handlers:
        if isinstance(h, logging.FileHandler) and \
                getattr(h, "baseFilename", None) == os.path.abspath(path):
            return path
    h = logging.FileHandler(path)
    h.setFormatter(logging.Formatter(_FMT))
    root.addHandler(h)
    return path


@contextlib.contextmanager
def run_dir_logs():
    """Take off again, when the block ends, the run-dir logs that the
    stages inside it attach (:func:`set_file_logger`,
    :func:`set_file_logger_prt`), so that the stages of one process that
    write to several run dirs keep each dir's logs to its own stage."""
    saved = sys.stdout, sys.stderr
    handlers = list(logging.getLogger().handlers)
    try:
        yield
    finally:
        for stream in (sys.stdout, sys.stderr):
            if stream not in saved:
                stream.flush()
                stream.close()   # a tee closes its file, not the console
        sys.stdout, sys.stderr = saved
        for h in logging.getLogger().handlers:
            if h not in handlers:
                logging.getLogger().removeHandler(h)
                h.close()
