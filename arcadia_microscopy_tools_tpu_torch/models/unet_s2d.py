"""Space-to-depth (S2D) form of the U-Net forward.

Counterpart of `arcadia_microscopy_tools_tpu/models/unet_s2d.py`. A stride-1
3x3 conv at (2H, 2W, C) is exactly a stride-1 3x3 conv at (H, W, 4C) whose
kernel re-indexes the taps per 2x2 sub-position, so the forward can run its
two full- and half-resolution levels as 128- and 256-channel convs at a
quarter of the pixels, with the trained weights rewritten once on the host:

- `s2d_params(params, gray_input=False)` rewrites the JAX parameter tree
  (numpy leaves, a nested dict / list or flattened to dotted keys as
  `models.weights` keeps it; `weights.tree_from_state_dict` gives it for a
  `UNet` state_dict) into the S2D tree, numpy leaves in the JAX layouts
  (HWIO), equal to the JAX package's leaf by leaf. Channel order is (c, a):
  flat channel = c * 4 + (ay * 2 + ax). The input S2D is folded into the
  stem convs (stride-2 4x4 convs and stride-2 2x2 projections), the
  decoder's nearest upsample, concatenation and depth-to-space into split
  and fractionally-strided kernels; `gray_input=True` folds a replicated
  grayscale input into the down0 stem, which then reads (B, H, W, 1).
- `s2d_supported(params, config)` says whether a tree has the level layout
  the S2D forward hardcodes.
- `UNetS2D(tree, config)(x, out_s2d=False)` is `apply_unet_s2d(sparams, x,
  config, out_s2d=out_s2d)` on its fused-conv route: (B, H, W, Cin) ->
  (B, H, W, 3) float32, H and W multiples of 8; with `out_s2d=True` the head
  output on the half-resolution grid, (B, H/2, W/2, 12) in (c, a) order,
  which `flows.compute_masks_sparse_compact_s2d` reads. The planar output
  is `_d2s` of that one, the same values permuted.

The route, in bfloat16 on the card:

- every stride-1 3x3 conv runs on `conv3x3_fused` (kernel 4; 13 calls),
  GroupNorm's affine + ReLU in the next conv's prologue, the decoder's
  split convs chained through `accum`, GN moments out of the kernel; the
  port's kernel takes any C, Co that are multiples of 32, so down2.conv1
  (64 -> 128) runs on it too;
- the stems' GN1 moments come from `lane_moments` (kernel 5; 2 calls);
- cuDNN runs the convs the JAX package runs outside its Pallas kernel: the
  stride-2 stems (`F.conv2d(stride=2)`) and the fractionally-strided up
  convs (`lhs_dilation=2` there; `F.conv_transpose2d(stride=2)` here, the
  kernel flipped in space and its in / out axes swapped), with cuDNN held
  to deterministic algorithms and no TF32;
- plain PyTorch runs the 1x1 projections (`unet._project`), the S2D
  max-pool, the style MLP and its per-sub-position bias, and the block
  tails with the rounding points of the JAX package's `_fused_tail`.

The blocks' conv, moments and tail calls are the planar `UNet`'s
(`unet._FusedBlocks`).

In any other dtype (float32) the same route runs the kernels' plain
versions, on any device; on the CPU the library convs are float32 convs
rounded to the compute dtype. The JAX package's `pallas_gn` /
`pallas_conv` switches and their environment variables are not ported: on
the card the kernels always run, on the CPU their plain versions.

Whether the S2D route pays on the card is measured, not assumed:
`chip_smoke.py` times it beside the planar forward (`PERF.md`). The plate
runner and `SegmentationModel` run the planar `UNet`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .unet import UNetConfig, _FusedBlocks, _max_pool2, _project, _Rows
from .weights import unflatten_tree

__all__ = ["UNetS2D", "s2d_params", "s2d_supported"]

Params = dict[str, Any]


def _nested(params: Params) -> Params:
    """A tree flattened to dotted keys ("down.0.conv1") as the nested tree;
    a nested tree as it is."""
    if isinstance(params, dict) and any("." in str(k) for k in params):
        return unflatten_tree(params)
    return params


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def s2d_supported(params: Params, config: UNetConfig | None = None) -> bool:
    """True when `params` has the level layout the S2D forward hardcodes:
    4 encoder levels / 3 decoder blocks with the config's base_channels
    widths. Other architectures run the planar `UNet`."""
    config = config or UNetConfig()
    nb = config.base_channels
    try:
        params = _nested(params)
        down, up = params["down"], params["up"]
        if len(down) != 4 or len(up) != 3 or len(nb) < 3:
            return False
        return all(
            down[i]["gn1_scale"].shape[0] == nb[i] for i in range(3)
        ) and up[1]["gn1_scale"].shape[0] == nb[1]
    except (KeyError, TypeError, IndexError, AttributeError):
        return False


def _sub(ay: int, ax: int) -> int:
    return ay * 2 + ax


def _s2d(x):
    """(B, 2H, 2W, C) -> (B, H, W, 4C) in (c, a) order, for numpy arrays and
    tensors (a testing helper: the forward folds this into its stems)."""
    b, h2, w2, c = x.shape
    x = x.reshape(b, h2 // 2, 2, w2 // 2, 2, c)
    x = x.transpose(0, 1, 3, 5, 2, 4) if isinstance(x, np.ndarray) else x.permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h2 // 2, w2 // 2, 4 * c)


def _d2s(x, c: int):
    """(B, H, W, 4C) -> (B, 2H, 2W, C), the inverse of `_s2d`, for numpy
    arrays and tensors."""
    b, h, w, _ = x.shape
    x = x.reshape(b, h, w, c, 2, 2)
    x = x.transpose(0, 1, 4, 2, 5, 3) if isinstance(x, np.ndarray) else x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, 2 * h, 2 * w, c)


def _s2d_conv_kernel(w: np.ndarray) -> np.ndarray:
    """A (kh, kw, cin, cout) stride-1 SAME kernel as its factor-2 S2D
    equivalent (3, 3, 4*cin, 4*cout); a 1x1 kernel gives the block-diagonal
    (1, 1, 4*cin, 4*cout)."""
    kh, kw, cin, cout = w.shape
    if (kh, kw) == (1, 1):
        out = np.zeros((1, 1, 4 * cin, 4 * cout), w.dtype)
        for a in range(4):
            out[0, 0, a::4, a::4] = w[0, 0]
        return out
    assert (kh, kw) == (3, 3), f"unsupported kernel {w.shape}"
    out = np.zeros((3, 3, 4 * cin, 4 * cout), w.dtype)
    for by in range(2):
        for bx in range(2):
            for ay in range(2):
                for ax in range(2):
                    for u in (-1, 0, 1):
                        for v in (-1, 0, 1):
                            ky = 2 * u + ay - by + 1
                            kx = 2 * v + ax - bx + 1
                            if 0 <= ky <= 2 and 0 <= kx <= 2:
                                out[u + 1, v + 1, _sub(ay, ax) :: 4, _sub(by, bx) :: 4] = w[ky, kx]
    return out


def _stem_conv_kernel(w: np.ndarray) -> np.ndarray:
    """(3, 3, cin, cout) stride-1 SAME kernel -> the (4, 4, cin, 4*cout)
    stride-2 kernel (padding 1) that computes the conv and its S2D at once:
    out[(i, j), co*4 + b] = sum over ty, tx in -1..2 of x[2i + ty, 2j + tx]
    * w[ty - by + 1, tx - bx + 1]."""
    _, _, cin, cout = w.shape
    out = np.zeros((4, 4, cin, 4 * cout), w.dtype)
    for by in range(2):
        for bx in range(2):
            for ty in range(-1, 3):
                for tx in range(-1, 3):
                    ky, kx = ty - by + 1, tx - bx + 1
                    if 0 <= ky <= 2 and 0 <= kx <= 2:
                        out[ty + 1, tx + 1, :, _sub(by, bx) :: 4] = w[ky, kx]
    return out


def _stem_proj_kernel(w: np.ndarray) -> np.ndarray:
    """(1, 1, cin, cout) -> (2, 2, cin, 4*cout) stride-2: the residual
    projection of an S2D level that reads full-resolution input."""
    _, _, cin, cout = w.shape
    out = np.zeros((2, 2, cin, 4 * cout), w.dtype)
    for by in range(2):
        for bx in range(2):
            out[by, bx, :, _sub(by, bx) :: 4] = w[0, 0]
    return out


def _head_kernel(w: np.ndarray) -> np.ndarray:
    """(1, 1, cin, cout) -> (2, 2, 4*cin, cout) for the fractionally-strided
    conv (input dilated by 2, padding 1) that applies a 1x1 conv and the
    depth-to-space at once: output (2i + ay, 2j + ax) reads tap (1 - ay,
    1 - ax) against input (i, j)."""
    _, _, cin, cout = w.shape
    out = np.zeros((2, 2, 4 * cin, cout), w.dtype)
    for t in range(2):
        for s in range(2):
            out[t, s, _sub(1 - t, 1 - s) :: 4, :] = w[0, 0]
    return out


def _compose_d2s_conv3_kernel(w3: np.ndarray) -> np.ndarray:
    """The depth-to-space folded into a following stride-1 3x3 SAME conv:
    conv3x3(d2s(x), w3) == the fractionally-strided 4x4 conv of x with this
    kernel, padding 2 (per axis, tap t collects (u, ry) pairs: t=0 (-1, 1);
    t=1 (-1, 0), (0, 1); t=2 (0, 0), (1, 1); t=3 (1, 0))."""
    _A = {0: [(-1, 1)], 1: [(-1, 0), (0, 1)], 2: [(0, 0), (1, 1)], 3: [(1, 0)]}
    kh, kw, c, co = w3.shape
    assert (kh, kw) == (3, 3)
    out = np.zeros((4, 4, 4 * c, co), w3.dtype)
    for t, vs in _A.items():
        for s, hs in _A.items():
            for u, ry in vs:
                for v, rx in hs:
                    out[t, s, (ry * 2 + rx) :: 4, :] += w3[u + 1, v + 1]
    return out


def _d2s_kernel(c: int, dtype) -> np.ndarray:
    """(2, 2, 4*c, c) identity kernel: depth-to-space as a
    fractionally-strided conv (the tap / sub-position relation of
    `_head_kernel`). The forward does not use it (nor does the reference's
    any more); it is kept, and tested, for parity with the reference."""
    out = np.zeros((2, 2, 4 * c, c), dtype)
    eye = np.eye(c, dtype=dtype)
    for t in range(2):
        for s in range(2):
            out[t, s, _sub(1 - t, 1 - s) :: 4, :] = eye
    return out


def _split_up_kernel(w: np.ndarray, c_up: int) -> tuple[np.ndarray, np.ndarray]:
    """A decoder conv's S2D kernel split so that the nearest-upsampled and
    concatenated input is never built: conv(concat([tile4(g), skip]), W') ==
    conv(g, W_up) + conv(skip, W_skip), W_up summing W''s four sub-position
    lanes of each up channel."""
    full = _s2d_conv_kernel(w)
    kh, kw, _, co4 = full.shape
    up = full[:, :, : 4 * c_up, :].reshape(kh, kw, c_up, 4, co4).sum(axis=3)
    return up, full[:, :, 4 * c_up :, :]


# tap-collapse matrix for conv3x3(nearest_up2(x)) == the fractionally-strided
# conv4x4 of x: per axis K4[t] = sum_k A[t, k] w[k]
_UP_TAPS = np.array([[1, 0, 0], [1, 1, 0], [0, 1, 1], [0, 0, 1]], dtype=np.float64)


def _up0_block(block: Params, c_up: int) -> Params:
    """The dense decoder block (up0) with the nearest upsample folded into
    fractionally-strided kernels: conv3x3(concat([upsample2(g), skip])) ==
    dconv4x4(g, A w A^T) + conv3x3(skip, w_skip)."""
    w1 = np.asarray(block["conv1"], np.float64)
    up, sk = w1[:, :, :c_up, :], w1[:, :, c_up:, :]
    conv1_up = np.einsum("ta,sb,abio->tsio", _UP_TAPS, _UP_TAPS, up)
    wp = np.asarray(block["proj"], np.float64)
    # the 1x1 projection of the upsampled tensor: every tap of the 2x2
    # transposed kernel reads the source pixel
    proj_up = np.broadcast_to(wp[0, 0, :c_up], (2, 2, c_up, wp.shape[3])).copy()
    out: Params = {
        "conv1_up": _f32(conv1_up),
        "conv1_skip": _f32(sk),
        "proj_up": _f32(proj_up),
        "proj_skip": _f32(wp[:, :, c_up:, :]),
        "conv2": _f32(block["conv2"]),
    }
    for name in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias"):
        out[name] = _f32(block[name])
    return out


def _s2d_up_block(block: Params, c_up: int) -> Params:
    """One decoder block in S2D form with split (up, skip) kernels; `c_up`
    is the channel count of the upsampled input before S2D."""
    up1, sk1 = _split_up_kernel(_f32(block["conv1"]), c_up)
    upp, skp = _split_up_kernel(_f32(block["proj"]), c_up)
    out: Params = {
        "conv1_up": up1,
        "conv1_skip": sk1,
        "proj_up": upp,
        "proj_skip": skp,
        "conv2": _s2d_conv_kernel(_f32(block["conv2"])),
    }
    for name in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias"):
        out[name] = np.repeat(_f32(block[name]), 4)
    return out


def _s2d_block(block: Params, stem: bool) -> Params:
    """One residual block in S2D form: GN scale / bias repeated 4x per
    channel; with `stem` the input S2D folded into conv1 (stride-2 4x4) and
    the projection (stride-2 2x2), for a full-resolution planar input."""
    w1 = _f32(block["conv1"])
    out: Params = {
        "conv1": _stem_conv_kernel(w1) if stem else _s2d_conv_kernel(w1),
        "conv2": _s2d_conv_kernel(_f32(block["conv2"])),
    }
    for name in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias"):
        out[name] = np.repeat(_f32(block[name]), 4)
    if "proj" in block:
        wp = _f32(block["proj"])
        out["proj"] = _stem_proj_kernel(wp) if stem else _s2d_conv_kernel(wp)
    return out


def _sum_inputs(w: np.ndarray) -> np.ndarray:
    """w summed over its input axis (2), keepdims, adding the inputs one
    after another in float32 (XLA's order for this reduction)."""
    total = w[:, :, :1].copy()
    for k in range(1, w.shape[2]):
        total += w[:, :, k : k + 1]
    return total


def s2d_params(params: Params, gray_input: bool = False) -> Params:
    """One-time host-side rewrite of a parameter tree for `UNetS2D`: levels
    0 and 1 of the encoder in stem form, the last two decoder blocks in S2D
    form (up2 with the depth-to-space folded into its up-part kernels),
    the deep levels unchanged, the head as the transposed-conv kernel and,
    for `out_s2d`, as a block-diagonal 1x1 on the S2D grid.

    `gray_input=True` folds a replicated grayscale input into the down0
    stem, conv(stack([x] * cin), W) == conv(x[..., None], sum_ci W): the
    caller feeds (B, H, W, 1), as the plate path does."""
    params = _nested(params)
    nb1 = params["down"][1]["gn1_scale"].shape[0]
    nb2 = params["down"][2]["gn1_scale"].shape[0]
    nb3 = params["down"][3]["gn1_scale"].shape[0]
    head = _f32(params["head"])
    down0 = _s2d_block(params["down"][0], stem=True)
    if gray_input:
        down0["conv1"] = _sum_inputs(down0["conv1"])
        down0["proj"] = _sum_inputs(down0["proj"])
    up2 = _s2d_up_block(params["up"][2], c_up=nb1)
    up1_w, _ = _split_up_kernel(_f32(params["up"][2]["conv1"]), nb1)
    up2["conv1_up"] = _compose_d2s_conv3_kernel(up1_w)
    upp_w, _ = _split_up_kernel(_f32(params["up"][2]["proj"]), nb1)
    up2["proj_up"] = _head_kernel(upp_w)
    return {
        "down0": down0,
        "down1": _s2d_block(params["down"][1], stem=True),
        "down_rest": [
            {k: _f32(v) for k, v in params["down"][i].items()}
            for i in range(2, len(params["down"]))
        ],
        "up0": _up0_block(params["up"][0], c_up=nb3),
        "up1": _s2d_up_block(params["up"][1], c_up=nb2),
        "up2": up2,
        "style_dense": _f32(params["style_dense"]),
        "style_proj": [_f32(p) for p in params["style_proj"]],
        "head": _head_kernel(head),
        "head_bias": _f32(params["head_bias"]),
        "head_s2d": _s2d_conv_kernel(head),
        "head_bias_s2d": np.repeat(_f32(params["head_bias"]), 4),
    }


# ---------------------------------------------------------------------------
# The forward


def _library_conv(x: torch.Tensor, w: torch.Tensor, pad: int, transposed: bool) -> torch.Tensor:
    """Stride-2 conv (OIHW `w`) or stride-2 transposed conv (IOHW `w`) of
    NHWC `x`, output NHWC in x's dtype. On the card cuDNN runs in x's dtype
    (float32 accumulation, one rounding), with deterministic algorithms (the
    transposed convs run its backward-data kernels, some of which add with
    atomics) and without TF32; elsewhere it is a float32 conv rounded once
    to x's dtype."""
    a = x.permute(0, 3, 1, 2)  # NCHW view of the NHWC tensor (channels_last)
    if x.device.type != "cuda":
        a, w = a.float(), w.float()
    fn = F.conv_transpose2d if transposed else F.conv2d
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        y = fn(a, w, stride=2, padding=pad)
    return y.permute(0, 2, 3, 1).to(x.dtype).contiguous()


def _pool_s2d(x: torch.Tensor, c: int) -> torch.Tensor:
    """2x2 stride-2 max-pool of the full-resolution tensor an S2D tensor in
    (c, a) order holds: the max over each channel's 4 sub-positions, the
    planar half-resolution tensor."""
    b, h, w, _ = x.shape
    q = x.reshape(b, h, w, c, 4)
    # two elementwise passes: a reduction over the 4 innermost values runs
    # as a slow reduce kernel on the card
    return torch.maximum(torch.maximum(q[..., 0], q[..., 1]), torch.maximum(q[..., 2], q[..., 3]))


# how each leaf of an S2D block is laid out for its call
_K4, _MATRIX, _STRIDE2, _UP = "kernel 4", "1x1", "stride-2", "transposed"


def _role(block: str, name: str, shape: tuple[int, ...]) -> str | None:
    if len(shape) != 4:
        return None
    if shape[:2] == (3, 3):
        return _K4
    if shape[:2] == (1, 1):
        return _MATRIX
    return _STRIDE2 if block.startswith("down") else _UP


def _layout(role: str | None, a: np.ndarray) -> torch.Tensor:
    """A leaf in its call's layout: kernel 4's (3, 3, Co, C), a (C, Co)
    matrix, cuDNN's OIHW, or the transposed conv's IOHW with the kernel
    flipped in space (an input dilated by 2 and padded p is conv_transpose2d
    with stride 2 and padding k - 1 - p)."""
    a = np.asarray(a, np.float32)
    if role == _K4:
        a = a.transpose(0, 1, 3, 2)
    elif role == _MATRIX:
        a = a[0, 0]
    elif role == _STRIDE2:
        a = a.transpose(3, 2, 0, 1)
    elif role == _UP:
        a = a[::-1, ::-1].transpose(2, 3, 0, 1)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


class _Leaves(nn.Module):
    """One block's tensors, as buffers in their call layouts."""

    def __init__(self, block: str, leaves: Params):
        super().__init__()
        for name, a in leaves.items():
            self.register_buffer(name, _layout(_role(block, name, np.shape(a)), a))


class UNetS2D(_FusedBlocks, nn.Module):
    """The S2D forward of an S2D tree (`s2d_params`); see the module
    docstring. `forward(x, out_s2d=False)` maps (B, H, W, Cin) float input,
    H and W multiples of 8, to (B, H, W, 3) float32, or with `out_s2d` to
    the (B, H/2, W/2, 12) head output on the S2D grid. Its blocks are the
    planar `UNet`'s (`unet._FusedBlocks`); a tensor at `level` holds H >>
    level rows, so the S2D form of level 0 is at level 1."""

    def __init__(self, sparams: Params, config: UNetConfig | None = None):
        super().__init__()
        self.config = config or UNetConfig()
        blocks = {
            "down0": sparams["down0"],
            "down1": sparams["down1"],
            "down2": sparams["down_rest"][0],
            "down3": sparams["down_rest"][1],
            "up0": sparams["up0"],
            "up1": sparams["up1"],
            "up2": sparams["up2"],
            "style": {"dense": sparams["style_dense"],
                      **{f"proj{i}": p for i, p in enumerate(sparams["style_proj"])}},
            "head": {"w": sparams["head_s2d"], "bias": sparams["head_bias_s2d"]},
        }
        self.blocks = nn.ModuleDict({k: _Leaves(k, v) for k, v in blocks.items()})

    @property
    def in_channels(self) -> int:
        return self.blocks["down0"].conv1.shape[1]

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.config.compute_dtype).contiguous()

    def _stem(self, rows: _Rows, blk: _Leaves, x: torch.Tensor, level: int) -> torch.Tensor:
        """An encoder level in stem form: full-resolution planar x in, the
        level's S2D tensor out; conv1 and the projection are cuDNN stride-2
        convs, GN1's moments come from kernel 5."""
        y1 = _library_conv(x, self._w(blk.conv1), 1, transposed=False)
        m1 = self._moments(rows, y1, level)
        skip = _library_conv(x, self._w(blk.proj), 0, transposed=False)
        return self._tail(blk, y1, m1, skip, rows, level)

    def _dense(self, rows: _Rows, blk: _Leaves, x: torch.Tensor, level: int) -> torch.Tensor:
        """A deep encoder level: both convs on kernel 4."""
        y1, m1 = self._conv_rows(rows, x, self._w(blk.conv1), level, moments=True)
        skip = _project(x, self._w(blk.proj)) if hasattr(blk, "proj") else x
        return self._tail(blk, y1, m1, skip, rows, level)

    def _up(self, rows: _Rows, blk: _Leaves, g: torch.Tensor, skip_t: torch.Tensor,
            level: int, dilated: bool) -> torch.Tensor:
        """A decoder block: the up part accumulated into kernel 4's skip conv.
        `dilated` (up0 and up2): the up parts are cuDNN transposed convs (the
        conv a 4x4 kernel, padding 1; the projection 2x2); else (up1) kernel
        4 and a 1x1 projection."""
        if dilated:
            a = _library_conv(g, self._w(blk.conv1_up), 1, transposed=True)
            skip = _library_conv(g, self._w(blk.proj_up), 0, transposed=True)
        else:
            a = self._conv_rows(rows, g, self._w(blk.conv1_up), level)
            skip = _project(g, self._w(blk.proj_up))
        y1, m1 = self._conv_rows(rows, skip_t, self._w(blk.conv1_skip), level, moments=True,
                                 accum=a)
        del a
        skip += _project(skip_t, self._w(blk.proj_skip))
        return self._tail(blk, y1, m1, skip, rows, level)

    @torch.no_grad()  # inference only: the kernels have no backward
    def forward(self, x: torch.Tensor, out_s2d: bool = False) -> torch.Tensor:
        b, h, w, cin = x.shape
        if h % 8 or w % 8:
            raise ValueError(f"the S2D forward takes H and W multiples of 8, got {h} x {w}")
        if cin != self.in_channels:
            raise ValueError(f"expected {self.in_channels} input channels, got {cin}")
        dt = self.config.compute_dtype
        nb = self.config.base_channels
        blk, style_p = self.blocks, self.blocks["style"]
        rows = _Rows(None, h)
        h0 = self._stem(rows, blk["down0"], x.to(dt), 1)
        h1 = self._stem(rows, blk["down1"], _pool_s2d(h0, nb[0]), 2)
        h2 = self._dense(rows, blk["down2"], _pool_s2d(h1, nb[1]), 2)
        deep = self._dense(rows, blk["down3"], _max_pool2(h2), 3)

        style = deep.float().mean((1, 2))
        style = style / (torch.linalg.vector_norm(style, dim=-1, keepdim=True) + 1e-6)
        style = torch.relu(style @ style_p.dense)

        h = self._up(rows, blk["up0"], deep, h2, 2, dilated=True)
        del deep, h2
        h += (style @ style_p.proj0).to(dt)[:, None, None, :]
        h = self._up(rows, blk["up1"], h, h1, 2, dilated=False)
        del h1
        h += (style @ style_p.proj1).to(dt).repeat_interleave(4, 1)[:, None, None, :]
        h = self._up(rows, blk["up2"], h, h0, 1, dilated=True)
        del h0
        h += (style @ style_p.proj2).to(dt).repeat_interleave(4, 1)[:, None, None, :]

        head = self.blocks["head"]
        out = _project(h, self._w(head.w)).float() + head.bias
        return out if out_s2d else _d2s(out, out.shape[-1] // 4)
