"""U-Net weights: the JAX parameter tree as numpy, and the port's state_dict.

The JAX package keeps weights as an orbax checkpoint of the `init_unet`
pytree (3x3 convs HWIO (3, 3, C, Co), 1x1 convs (1, 1, C, Co)). The port
reads the same tree from an `.npz` whose keys are the tree's paths joined
with dots ("down.0.conv1", "style_proj.2", ...) and whose arrays are the
leaves as they are, and converts it to the `UNet` state_dict: 3x3 convs to
(3, 3, Co, C), the layout the conv kernel stages, 1x1 convs to (C, Co).

`tree_from_state_dict` is the way back, which the port's trainer
(models/train.py) uses to write its `.npz`: the JAX package's trainer
writes an orbax checkpoint instead, which the port can neither read nor
write.

`load_state_dict` reads a torch state dict file as it is (Cellpose-SAM's
published `cpsam` checkpoint is one, in the key layout of
models/vit_sam.py), with `torch.load(weights_only=True)`: tensors only,
no pickled code.

`unet_checkpoint.npz` beside this module is the trained checkpoint
`checkpoints/unet` of the repository, exported leaf by leaf with
`np.savez(path, **flatten_tree(load_checkpoint("checkpoints/unet")))` (the
JAX package's loader, which needs orbax; the port needs neither).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = [
    "DEFAULT_WEIGHTS",
    "flatten_tree",
    "load_state_dict",
    "load_weights",
    "save_weights",
    "state_dict_from_tree",
    "tree_from_state_dict",
    "unflatten_tree",
]

# the 2-D state_dict entries with these last names are 1x1 convs, (1, 1, C, Co)
# in the JAX tree; the other 2-D entries (style_dense, style_proj.*) are dense
# layers, 2-D there as well
_ONE_BY_ONE = ("proj", "head")

DEFAULT_WEIGHTS = Path(__file__).resolve().parent / "unet_checkpoint.npz"


def flatten_tree(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """{dotted path: numpy leaf} of a nested dict / list parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for key, value in items:
        out.update(flatten_tree(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def unflatten_tree(flat: dict[str, Any]) -> Any:
    """The nested dict / list tree of {dotted path: leaf} (`flatten_tree`'s
    inverse; list indices are the numeric path parts)."""
    tree: dict = {}
    for key, leaf in flat.items():
        *path, last = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def _convert(name: str, leaf: np.ndarray) -> torch.Tensor:
    a = np.asarray(leaf, dtype=np.float32)
    if a.ndim == 4 and a.shape[:2] == (3, 3):
        a = a.transpose(0, 1, 3, 2)  # HWIO -> (3, 3, Co, C)
    elif a.ndim == 4 and a.shape[:2] == (1, 1):
        a = a[0, 0]  # 1x1 conv -> (C, Co)
    elif a.ndim == 4:
        raise ValueError(f"unexpected kernel shape {a.shape} for {name}")
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def state_dict_from_tree(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The `UNet` state_dict for a flattened JAX parameter tree."""
    return {name: _convert(name, leaf) for name, leaf in flat.items()}


def tree_from_state_dict(state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """The flattened JAX parameter tree (float32 numpy leaves, JAX layouts)
    of a `UNet` state_dict: the inverse of `state_dict_from_tree`."""
    flat = {}
    for name, value in state.items():
        a = value.detach().to("cpu", torch.float32).numpy()
        if a.ndim == 4:
            a = a.transpose(0, 1, 3, 2)  # (3, 3, Co, C) -> HWIO
        elif name.rsplit(".", 1)[-1] in _ONE_BY_ONE:
            a = a[None, None]  # (C, Co) -> (1, 1, C, Co)
        flat[name] = np.ascontiguousarray(a)
    return flat


def save_weights(path: str | Path, state: dict[str, torch.Tensor]) -> None:
    """Write a `UNet` state_dict as the `.npz` of the flattened JAX tree that
    `load_weights` reads."""
    with open(Path(path), "wb") as fh:  # np.savez would append ".npz" to a bare name
        np.savez(fh, **tree_from_state_dict(state))


def load_weights(path: str | Path = DEFAULT_WEIGHTS) -> dict[str, torch.Tensor]:
    """The `UNet` state_dict stored in an `.npz` of the flattened JAX tree."""
    with np.load(Path(path)) as data:
        return state_dict_from_tree({k: data[k] for k in data.files})


def load_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """A torch state dict file on the CPU, read with weights_only=True."""
    state = torch.load(Path(path), map_location="cpu", weights_only=True)
    if not isinstance(state, dict) or not all(isinstance(v, torch.Tensor) for v in state.values()):
        raise ValueError(f"{path} holds no state dict of tensors")
    return dict(state)
