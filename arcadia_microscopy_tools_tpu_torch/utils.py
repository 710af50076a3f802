"""Progress utilities (`get_tqdm`, copied from the JAX package's `utils/__init__.py`)."""

from __future__ import annotations


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
