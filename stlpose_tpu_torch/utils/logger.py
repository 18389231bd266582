"""Experiment file logger.

Port of ``stlpose_tpu/utils/logger.py``: ``logs.txt`` in the experiment
directory, a ``print_`` tee to console and file, a ``log_function``
decorator that records calls and re-raises errors after logging them, and
a ``for_all_methods`` class decorator.
"""

from __future__ import annotations

import datetime
import functools
import inspect
import os
import traceback

_LOGGER = None


class Logger:
    """File logger bound to an experiment directory (singleton via module
    global, like the reference's Logger at lib/logger.py:48-122)."""

    def __init__(self, exp_path: str, file_name: str = "logs.txt"):
        global _LOGGER
        self.path = os.path.join(exp_path, file_name)
        os.makedirs(exp_path, exist_ok=True)
        _LOGGER = self
        self.log_info("Starting new logging session", type="new_exp")

    def log_info(self, message: str, type: str = "info"):
        ts = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        with open(self.path, "a") as f:
            f.write(f"{ts}  [{type.upper()}]  {message}\n")

    def log_params(self, params: dict):
        self.log_info(f"Parameters: {params}", type="params")

    def log_error(self, message: str):
        self.log_info(message, type="error")


def get_logger() -> Logger | None:
    return _LOGGER


def print_(message: str, type: str = "info"):
    """Tee a message to console and the active log file
    (reference: lib/logger.py:37-45)."""
    print(message)
    if _LOGGER is not None:
        _LOGGER.log_info(str(message), type=type)


def log_function(func):
    """Log entry into a function and any exception it raises
    (reference: lib/logger.py:15-34 — minus the exit-on-error)."""

    @functools.wraps(func)
    def wrapper(*args, **kwargs):
        if _LOGGER is not None:
            _LOGGER.log_info(f"Calling: {func.__qualname__}")
        try:
            return func(*args, **kwargs)
        except Exception as e:
            if _LOGGER is not None:
                _LOGGER.log_error(
                    f"Error in {func.__qualname__}: {e}\n"
                    f"{traceback.format_exc()}")
            raise

    return wrapper


def for_all_methods(decorator):
    """Apply a decorator to every public method of a class
    (reference: lib/utils.py:409-418)."""

    def decorate(cls):
        for name, fn in inspect.getmembers(cls, inspect.isfunction):
            if not name.startswith("__"):
                setattr(cls, name, decorator(fn))
        return cls

    return decorate
