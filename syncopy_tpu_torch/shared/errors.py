# -*- coding: utf-8 -*-
#
# Error hierarchy + user messaging for syncopy_tpu.
#
# Parity target: reference syncopy/shared/errors.py:22-473 (SPYError family,
# SPYWarning/SPYInfo/SPYLog helpers). Re-designed: no custom sys.excepthook
# (plays badly with JAX tracebacks); plain exception classes + logging.

import os
import sys
import warnings

from .log import get_logger

__all__ = [
    "SPYError",
    "SPYTypeError",
    "SPYValueError",
    "SPYIOError",
    "SPYParallelError",
    "SPYWarning",
    "SPYInfo",
    "SPYLog",
    "SPYExceptionHandler",
    "log",
]


class SPYError(Exception):
    """Base class for all syncopy_tpu errors."""


class SPYTypeError(SPYError):
    """
    Raised when an object of unexpected type is encountered.

    Mirrors reference errors.py:38-64: message format
    "Wrong type of <varname>: expected <expected> found <actual>".
    """

    def __init__(self, var, varname="", expected=""):
        self.varname = str(varname)
        self.found = str(type(var).__name__)
        self.expected = str(expected)
        super().__init__(
            "Wrong type of `{}`: expected {}, found {}".format(
                self.varname or "input", self.expected, self.found
            )
        )


class SPYValueError(SPYError):
    """
    Raised on invalid values.

    Mirrors reference errors.py:67-95: message format
    "Invalid value of <varname>: expected <legal> found <actual>".
    """

    def __init__(self, legal, varname="", actual=""):
        self.legal = str(legal)
        self.varname = str(varname)
        self.actual = str(actual)
        msg = "Invalid value of `{}`:".format(self.varname or "input")
        if actual != "":
            msg += " '{}';".format(self.actual)
        msg += " expected {}".format(self.legal)
        super().__init__(msg)


class SPYIOError(SPYError):
    """
    Raised on I/O failures (reference errors.py:98-116).
    `exists`: True -> "already exists", False -> "does not exist",
    None -> "cannot be read".
    """

    def __init__(self, fs_loc, exists=None):
        self.fs_loc = str(fs_loc)
        self.exists = exists
        if exists is None:
            state = "cannot be read"
        elif exists:
            state = "already exists"
        else:
            state = "does not exist"
        super().__init__("Cannot access `{}`: {}".format(self.fs_loc, state))


class SPYParallelError(SPYError):
    """Raised on problems with the parallel execution backend (mesh/devices)."""

    def __init__(self, msg, client=None):
        self.client = client
        super().__init__(str(msg))


def install_exception_handler():
    """
    Install a traceback-truncating excepthook for *interactive* sessions
    (reference errors.py:142-300, `SPYExceptionHandler`): SPYError family
    exceptions print a single concise line instead of the full stack.
    Inactive in scripts/pytest; disable entirely with SPYFULLTRACEBACK=1.
    """
    if os.environ.get("SPYFULLTRACEBACK"):
        return
    interactive = hasattr(sys, "ps1") or bool(getattr(sys, "__IPYTHON__", False))
    try:  # Jupyter/IPython
        get_ipython  # type: ignore # noqa: B018
        interactive = True
    except NameError:
        pass
    if not interactive:
        return

    default_hook = sys.excepthook

    def spy_excepthook(exc_type, exc, tb):
        if issubclass(exc_type, SPYError):
            print("{}: {}".format(exc_type.__name__, exc), file=sys.stderr)
        else:
            default_hook(exc_type, exc, tb)

    sys.excepthook = spy_excepthook


def SPYWarning(msg, caller=None):
    """Emit a standardized warning (reference errors.py:301-341)."""
    pre = "Syncopy{} WARNING: ".format(" <{}>".format(caller) if caller else "")
    logger = get_logger()
    logger.warning(pre + str(msg))
    warnings.warn(pre + str(msg), RuntimeWarning, stacklevel=2)


def SPYInfo(msg, caller=None):
    """Emit a standardized info message (reference errors.py:376-407)."""
    pre = "Syncopy{} INFO: ".format(" <{}>".format(caller) if caller else "")
    get_logger().info(pre + str(msg))


def SPYLog(msg, loglevel="INFO", caller=None):
    """Route a message to the package logger (reference errors.py:410-473)."""
    logger = get_logger()
    if caller:
        msg = "<{}> {}".format(caller, msg)
    level = str(loglevel).upper()
    if level == "IMPORTANT":
        # the custom level 25 — mapping it to INFO (20) would be filtered
        # by the default IMPORTANT logger threshold
        from .log import IMPORTANT

        logger.log(IMPORTANT, str(msg))
        return
    fn = {
        "DEBUG": logger.debug,
        "INFO": logger.info,
        "WARNING": logger.warning,
        "ERROR": logger.error,
        "CRITICAL": logger.critical,
    }.get(level, logger.info)
    fn(str(msg))


def log(msg, level="IMPORTANT", par=False, caller=None):
    """Log `msg` to the package logger.

    Parameters
    ----------
    msg : str
        The message.
    level : str
        Logging level name; the custom "IMPORTANT" level (25) is routed
        numerically so it clears the default threshold.
    par : bool
        Route to the per-host parallel logger instead.
    caller : str or None
        Prefixed onto the message for provenance.

    Reference: errors.py:398-473.
    """
    import logging

    from .log import IMPORTANT, get_parallel_logger

    if caller:
        msg = "<{}> {}".format(caller, msg)
    if par:
        logger = get_parallel_logger()
        lvl = str(level).upper()
        # the custom IMPORTANT level (25) has no Logger method — route by
        # numeric level or it is silently filtered at the default threshold
        num = IMPORTANT if lvl == "IMPORTANT" else getattr(logging, lvl, logging.INFO)
        logger.log(num, str(msg))
        return
    SPYLog(msg, loglevel=level)


def SPYExceptionHandler(*args, **kwargs):
    """Print the ACTIVE exception concisely (reference errors.py:142-300).

    The reference installs this as sys.excepthook / IPython showtraceback;
    here the equivalent hook is installed by
    :func:`install_exception_handler` — this callable is exported for API
    compatibility and handles either calling convention."""
    if len(args) >= 3 and isinstance(args[0], type):
        exc_type, exc, tb = args[:3]
    else:
        exc_type, exc, tb = sys.exc_info()
    if exc_type is not None and issubclass(exc_type, SPYError):
        print("{}: {}".format(exc_type.__name__, exc), file=sys.stderr)
    elif exc_type is not None:
        import traceback

        traceback.print_exception(exc_type, exc, tb)


def not_ported(what, roadmap_item):
    """The error raised where the PyTorch port has not reached a feature
    yet; `roadmap_item` names the ROADMAP entry that ports it."""
    return NotImplementedError(
        "{} is not ported to syncopy_tpu_torch yet; it lands with {}".format(what, roadmap_item)
    )
