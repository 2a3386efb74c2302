"""Rank-gated logging and the ``info``-flag protocol.

Counterpart of :mod:`lightkrylov_tpu.utils.logger` (reference:
src/Utilities/Logger.f90): Python ``logging`` gated on
``constants.io_rank()``; positive ``info`` codes are benign events, negative
codes from the solvers mean "not converged" (a warning), other negative codes
raise :class:`LightKrylovError` (Logger.f90:316-748).
"""

from __future__ import annotations

import logging
import sys

from .. import constants

__all__ = [
    "logger",
    "logger_setup",
    "log_message",
    "log_information",
    "log_warning",
    "log_error",
    "log_debug",
    "stop_error",
    "check_info",
    "LightKrylovError",
]

logger = logging.getLogger("lightkrylov_tpu_torch")


class LightKrylovError(RuntimeError):
    """Raised where the reference's ``error_handler`` would abort
    (reference: src/Utilities/Logger.f90:750-765)."""


def logger_setup(
    logfile: str | None = None,
    log_level: int = logging.INFO,
    log_stdout: bool = True,
    log_timestamp: bool = True,
) -> None:
    """Configure the package logger (reference: Logger.f90:36-113); only the
    IO rank emits records (Logger.f90:122-241)."""
    logger.handlers.clear()
    logger.setLevel(log_level)
    if not constants.io_rank():
        logger.addHandler(logging.NullHandler())
        return
    fmt = "%(asctime)s %(levelname)s %(message)s" if log_timestamp else "%(levelname)s %(message)s"
    formatter = logging.Formatter(fmt)
    if log_stdout:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    if logfile is not None:
        fh = logging.FileHandler(logfile)
        fh.setFormatter(formatter)
        logger.addHandler(fh)


def _emit(level: int, msg: str, module: str | None, procedure: str | None) -> None:
    prefix = ""
    if module or procedure:
        prefix = f"[{module or ''}{'.' if module and procedure else ''}{procedure or ''}] "
    logger.log(level, prefix + msg)


def log_message(msg, module=None, procedure=None):
    _emit(logging.INFO, msg, module, procedure)


def log_information(msg, module=None, procedure=None):
    _emit(logging.INFO, msg, module, procedure)


def log_warning(msg, module=None, procedure=None):
    _emit(logging.WARNING, msg, module, procedure)


def log_error(msg, module=None, procedure=None):
    _emit(logging.ERROR, msg, module, procedure)


def log_debug(msg, module=None, procedure=None):
    _emit(logging.DEBUG, msg, module, procedure)


def stop_error(msg, module=None, procedure=None):
    """Log and raise (reference: Logger.f90:300-314)."""
    _emit(logging.CRITICAL, msg, module, procedure)
    raise LightKrylovError(msg)


_BENIGN = {
    "qr": "Colinear columns detected and replaced by random vectors.",
    "arnoldi": "Invariant subspace found after {info} steps.",
    "lanczos": "Invariant subspace found after {info} steps.",
    "gram_schmidt": "Zero vector encountered during orthogonalization.",
    "gmres": "Converged after {info} iterations.",
    "fgmres": "Converged after {info} iterations.",
    "cg": "Converged after {info} iterations.",
    "eigs": "Converged after {info} iterations.",
    "eighs": "Converged after {info} iterations.",
    "kexpm": "Converged after {info} iterations (info=-2: invariant subspace, exact result).",
}

#: Origins whose negative info means "did not converge within maxiter": a
#: logged warning, not a fatal error (reference: Logger.f90:653-667).
_SOLVER_ORIGINS = frozenset({"gmres", "fgmres", "cg", "eigs", "eighs", "kexpm"})


def check_info(info: int, origin: str, module: str | None = None, procedure: str | None = None) -> None:
    """Decode an ``info`` flag: log benign events, warn on solver
    non-convergence, raise on fatal (reference: Logger.f90:316-748)."""
    if info == 0:
        return
    origin_key = origin.lower()
    if info > 0 or (origin_key == "kexpm" and info == -2):
        msg = _BENIGN.get(origin_key, "info = {info}").format(info=info)
        log_information(f"{origin}: {msg}", module, procedure)
        return
    if origin_key in _SOLVER_ORIGINS:
        log_warning(
            f"{origin}: maximum iterations reached ({-info}); tolerance "
            "not achieved.", module, procedure)
        return
    stop_error(f"{origin}: fatal error, info = {info}.", module, procedure)
