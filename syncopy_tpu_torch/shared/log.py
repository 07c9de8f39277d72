# -*- coding: utf-8 -*-
#
# Logging setup for syncopy_tpu.
#
# Parity target: reference syncopy/shared/log.py:23-252 — session log files
# under $SPYLOGDIR (default ~/.spy/logs), env-var controlled levels, custom
# IMPORTANT level, a main logger plus a per-host "parallel" logger.
# Re-designed: single-process JAX runtime means the per-host worker logger is
# just an alias, but the env-var surface (SPYLOGDIR/SPYLOGLEVEL/SPYPARLOGLEVEL/
# SPYLOGMSECS) is kept.

import logging
import os
import platform
import sys

__all__ = [
    "setup_logging",
    "get_logger",
    "get_parallel_logger",
    "set_loglevel",
    "delete_all_logfiles",
    "loglevels",
]

#: custom level between INFO and WARNING (reference log.py:26)
IMPORTANT = 25
logging.addLevelName(IMPORTANT, "IMPORTANT")

loglevels = ["DEBUG", "INFO", "IMPORTANT", "WARNING", "ERROR", "CRITICAL"]

_LOGGER_NAME = "syncopy_tpu_torch"
_setup_done = False
_logfile = None


def _level_from_env(var, default="IMPORTANT"):
    lvl = os.environ.get(var, default).upper()
    if lvl == "IMPORTANT":
        return IMPORTANT
    return getattr(logging, lvl, IMPORTANT)


def get_log_dir():
    """Return the directory log files are written to ($SPYLOGDIR)."""
    spydir = os.environ.get("SPYDIR", os.path.join(os.path.expanduser("~"), ".spy"))
    return os.environ.get("SPYLOGDIR", os.path.join(spydir, "logs"))


def setup_logging(session_id="session"):
    """Initialize the package loggers (idempotent)."""
    global _setup_done, _logfile
    if _setup_done:
        return
    _setup_done = True

    logger = logging.getLogger(_LOGGER_NAME)
    logger.setLevel(_level_from_env("SPYLOGLEVEL"))

    msecs = os.environ.get("SPYLOGMSECS", "").lower() in ("1", "true", "yes")
    fmt = "%(asctime)s - %(levelname)s: %(message)s"
    datefmt = "%Y-%m-%d %H:%M:%S" + (".%f" if msecs else "")

    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(logging.Formatter(fmt))
    logger.addHandler(sh)

    logdir = get_log_dir()
    try:
        os.makedirs(logdir, exist_ok=True)
        _logfile = os.path.join(logdir, "syncopy_tpu_torch_{}.log".format(session_id))
        fh = logging.FileHandler(_logfile)
        fh.setFormatter(logging.Formatter(fmt))
        logger.addHandler(fh)
    except OSError:
        # read-only home etc. -- stream logging only
        _logfile = None

    # per-host logger (reference keeps a separate one for dask workers;
    # our runtime is single-controller so it shares handlers)
    par = logging.getLogger(_LOGGER_NAME + "_" + platform.node())
    par.setLevel(_level_from_env("SPYPARLOGLEVEL"))
    par.handlers = logger.handlers
    logger.propagate = False
    par.propagate = False


def get_logger():
    """The main syncopy_tpu logger (reference log.py:191)."""
    setup_logging()
    return logging.getLogger(_LOGGER_NAME)


def get_parallel_logger():
    """Per-host logger, kept for API parity (reference log.py:206)."""
    setup_logging()
    return logging.getLogger(_LOGGER_NAME + "_" + platform.node())


def set_loglevel(level, parallel_level=None):
    """Set log level(s) at runtime (reference log.py:218)."""
    lvl = IMPORTANT if str(level).upper() == "IMPORTANT" else getattr(logging, str(level).upper())
    get_logger().setLevel(lvl)
    if parallel_level is not None:
        plvl = (
            IMPORTANT
            if str(parallel_level).upper() == "IMPORTANT"
            else getattr(logging, str(parallel_level).upper())
        )
        get_parallel_logger().setLevel(plvl)


def delete_all_logfiles(silent=True):
    """Remove all log files in the log dir (reference log.py:233)."""
    logdir = get_log_dir()
    n = 0
    if os.path.isdir(logdir):
        for fname in os.listdir(logdir):
            if fname.endswith(".log"):
                try:
                    os.unlink(os.path.join(logdir, fname))
                    n += 1
                except OSError:
                    pass
    if not silent:
        print("Deleted {} log files from {}".format(n, logdir))
