"""Pipeline composition: `ImageOperation` and `Pipeline`.

Counterpart of `arcadia_microscopy_tools_tpu/ops/pipeline.py`, which traces
the operation fold into one jitted XLA program. Here the fold simply runs
its operations in order on tensors of one device; `parallel=True` runs it
once per frame of axis 0, as the reference's vmap does, so that every op
global over its input (percentiles, global thresholds, the constant-image
checks) sees one frame at a time.

Host dtype contract: NumPy in -> NumPy out, floating results widened to
float64 (the reference's output dtype); tensor in -> tensor out on the
input's device. `preserve_dtype=True` casts back to the input dtype in both
cases. NumPy input is copied onto the pipeline's device, the CUDA card
unless the caller names another. `max_workers` is accepted for API
compatibility and unused.
"""

from __future__ import annotations

import warnings
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import resolve_device

__all__ = ["ImageOperation", "Pipeline"]


class ImageOperation:
    """An image-processing step frozen together with its configuration:
    immutable and, when its configuration is, hashable."""

    __slots__ = ("func", "args", "kwargs")

    def __init__(self, func: Callable, *args: object, **kwargs: object) -> None:
        object.__setattr__(self, "func", func)
        object.__setattr__(self, "args", args)
        object.__setattr__(self, "kwargs", kwargs)

    def __setattr__(self, name: str, value: object) -> None:
        raise AttributeError("ImageOperation instances are immutable")

    def __delattr__(self, name: str) -> None:
        raise AttributeError("ImageOperation instances are immutable")

    def __call__(self, intensities):
        """Run the wrapped function on *intensities* with the bound config."""
        return self.func(intensities, *self.args, **self.kwargs)

    def _identity(self) -> tuple:
        return (self.func, self.args, tuple(sorted(self.kwargs.items())))

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ImageOperation):
            return NotImplemented
        return self._identity() == other._identity()

    def __hash__(self) -> int:
        return hash(self._identity())

    def __repr__(self) -> str:
        parts = [repr(a) for a in self.args]
        parts += [f"{k}={v!r}" for k, v in self.kwargs.items()]
        return f"{self.func.__name__}({', '.join(parts)})"


@dataclass
class Pipeline:
    """An ordered stack of ImageOperations.

        operations: the steps, in application order.
        copy: run the fold on a copy of tensor input (NumPy input is always
            copied onto the device); warns with parallel=True, as in the
            reference.
        preserve_dtype: cast the result back to the input dtype when True;
            otherwise the dtype follows the math (uint16 in, float out).
        parallel: run the fold once per frame of axis 0 (input must be
            >= 3D).
        max_workers: accepted for compatibility and unused. Must be >= 1
            when given.
        device: where NumPy input runs; None means the CUDA card, and
            raises when there is none (pass device="cpu" to run the plain
            versions of the kernels). Tensor input stays on its device.
    """

    operations: list[ImageOperation]
    copy: bool = False
    preserve_dtype: bool = False
    parallel: bool = False
    max_workers: int | None = None
    device: str | torch.device | None = None

    def __post_init__(self) -> None:
        self.operations = list(self.operations)
        if len(self.operations) == 0:
            raise ValueError("Pipeline must have at least one operation")
        for op in self.operations:
            if not callable(op):
                raise TypeError(
                    "All operations must be callable (wrap functions with ImageOperation)"
                )
        if self.max_workers is not None and self.max_workers < 1:
            raise ValueError(f"max_workers must be at least 1, got {self.max_workers}")
        if self.parallel and self.copy:
            warnings.warn(
                "copy=True has no effect when parallel=True. "
                "Parallel mode always produces a new output array.",
                UserWarning,
                stacklevel=2,
            )
        self.device = resolve_device(self.device)

    def _fold(self, x: torch.Tensor) -> torch.Tensor:
        out = x
        for operation in self.operations:
            out = operation(out)
        if self.preserve_dtype and out.dtype != x.dtype:
            out = out.to(x.dtype)
        return out

    def __call__(self, intensities):
        """Run the fold on *intensities* (per frame of axis 0 when
        parallel=True, which requires >= 3D input)."""
        if self.parallel and intensities.ndim < 3:
            raise ValueError(
                f"Parallel mode requires at least 3D input (got {intensities.ndim}D). "
                "The first axis is used to distribute work across devices."
            )
        is_host_input = isinstance(intensities, np.ndarray)
        if is_host_input:
            x = torch.tensor(intensities, device=self.device)
        else:
            x = intensities.clone() if self.copy else intensities
        if self.parallel:
            result = torch.stack([self._fold(frame) for frame in x])
        else:
            result = self._fold(x)
        if is_host_input:
            host = result.cpu().numpy()
            if not self.preserve_dtype and np.issubdtype(host.dtype, np.floating):
                host = host.astype(np.float64)
            return host
        return result

    def __len__(self) -> int:
        return len(self.operations)

    def __repr__(self) -> str:
        flags = {
            "copy": self.copy,
            "preserve_dtype": self.preserve_dtype,
            "parallel": self.parallel,
            "max_workers": self.max_workers,
        }
        shown = [f"{k}={v}" for k, v in flags.items() if v not in (False, None)]
        inner = ", ".join(repr(op) for op in self.operations)
        tail = (", " + ", ".join(shown)) if shown else ""
        return f"Pipeline([{inner}]{tail})"
