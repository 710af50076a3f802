"""Logging and progress utilities (`configure_logging` and `get_tqdm`,
copied from the JAX package's `utils/__init__.py`) and the port's device
choice (`resolve_device`); `utils.profiling` has the stage timer and the
device trace."""

from __future__ import annotations

import logging

import torch

__all__ = ["configure_logging", "get_tqdm", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another. Raises when no CUDA device exists and none was named."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return torch.device("cuda")


def configure_logging(verbose: bool) -> None:
    """Configure the Python logging system with optional verbosity.

    Sets up a basic logging configuration with a standardized format for
    timestamps, logger names, and log levels.

    Args:
        verbose:
            If True, sets logging level to DEBUG to show all messages.
            If False, sets logging level to INFO which filters out DEBUG messages.
    """
    log_level = logging.DEBUG if verbose else logging.INFO
    logging.basicConfig(
        level=log_level,
        format="%(asctime)s - %(name)s - %(levelname)s :: %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )


def get_tqdm():
    """Return the appropriate tqdm implementation for the current environment.

    Returns:
        ``tqdm.notebook.tqdm`` inside Jupyter/IPython notebooks, plain
        ``tqdm.tqdm`` elsewhere, or a no-dependency fallback iterator wrapper
        if tqdm is not installed.
    """
    try:
        from IPython import get_ipython  # type: ignore

        in_ipython = get_ipython() is not None
    except ImportError:
        in_ipython = False

    try:
        if in_ipython:
            from tqdm.notebook import tqdm  # type: ignore
        else:
            from tqdm import tqdm  # type: ignore
        return tqdm
    except ImportError:
        return _fallback_tqdm


class _FallbackProgress:
    """Counter-style progress object (tqdm's total/update/close protocol)."""

    def update(self, n: int = 1) -> None:
        pass

    def close(self) -> None:
        pass


def _fallback_tqdm(iterable=None, **_kwargs):
    """Minimal stand-in used when tqdm is unavailable."""
    if iterable is None:
        return _FallbackProgress()
    return iterable
