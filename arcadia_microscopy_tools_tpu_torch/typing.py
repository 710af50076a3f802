"""Array type aliases (the host-side part of the JAX package's `typing.py`,
plus the port's device-side alias).

Host-facing APIs speak NumPy dtypes (uint16 in, int64 labels and float64
out); device code speaks ``torch.Tensor``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
from numpy.typing import NDArray

BoolArray = NDArray[np.bool_]
UByteArray = NDArray[np.uint8]
UInt16Array = NDArray[np.uint16]
Int64Array = NDArray[np.int64]
Float32Array = NDArray[np.float32]
Float64Array = NDArray[np.float64]

# Union type for arrays with numeric or boolean scalar types.
ScalarArray = Union[BoolArray, UByteArray, UInt16Array, Int64Array, Float32Array, Float64Array]

# Device-side alias: a tensor on the card (or on the CPU for the plain path).
DeviceArray = torch.Tensor

# Either side of the host<->device boundary.
AnyArray = Union[np.ndarray, torch.Tensor]
