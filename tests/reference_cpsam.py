"""Plain reference of Cellpose-SAM's maps of one image, for the tests.

The published code written out straight in float32 PyTorch (TF32 off), one
image at a time, no kernel and no batching of tiles; it imports neither JAX
nor the port (arcadia_microscopy_tools_tpu_torch):

1. Cellpose's tiles (`make_tiles`): per axis n = ceil(1.2 L / bsize) tiles
   at np.linspace(0, L - bsize, n).astype(int), after a centred zero pad of
   an axis shorter than bsize;
2. per tile, SAM's image encoder as Cellpose-SAM runs it
   (`segment_anything/modeling/image_encoder.py`, `cellpose/vit_sam.py`):
   Conv2d patch embedding, + pos_embed, blocks of x + proj(attn(LN(x))) and
   x + lin2(GELU(lin1(LN(x)))) with global attention whose logits are
   (q * scale) k^T plus the materialised decomposed relative-position bias
   (`get_rel_pos` resize, `add_decomposed_rel_pos`), softmax, the neck
   (Conv1x1, LayerNorm2d, Conv3x3, LayerNorm2d), the readout Conv1x1 and
   `conv_transpose2d` with W2 at stride patch;
3. Cellpose's `average_tiles` with `_taper_mask`, then the pad cropped.

`state` is a state dict in the published layout; `sizes` gives tile,
patch, heads and the overlap and taper of the tiles.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-6


@contextlib.contextmanager
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        resized = F.interpolate(rel_pos.reshape(1, rel_pos.shape[0], -1).permute(0, 2, 1),
                                size=max_rel_dist, mode="linear")
        resized = resized.reshape(-1, max_rel_dist).permute(1, 0)
    else:
        resized = rel_pos
    q_coords = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    relative = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return resized[relative.long()]


def attention(x: torch.Tensor, p: str, state: dict, heads: int) -> torch.Tensor:
    b, h, w, _ = x.shape
    qkv = F.linear(x, state[p + "qkv.weight"], state[p + "qkv.bias"])
    qkv = qkv.reshape(b, h * w, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, h * w, -1).unbind(0)
    scale = q.shape[-1] ** -0.5
    attn = (q * scale) @ k.transpose(-2, -1)
    rh = get_rel_pos(h, h, state[p + "rel_pos_h"])
    rw = get_rel_pos(w, w, state[p + "rel_pos_w"])
    r_q = q.reshape(b * heads, h, w, -1)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
    attn = attn.softmax(dim=-1)
    x = (attn @ v).view(b, heads, h, w, -1).permute(0, 2, 3, 1, 4).reshape(b, h, w, -1)
    return F.linear(x, state[p + "proj.weight"], state[p + "proj.bias"])


def layer_norm_2d(x: torch.Tensor, weight, bias) -> torch.Tensor:
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(s + EPS)
    return weight[:, None, None] * x + bias[:, None, None]


def net(tile: torch.Tensor, state: dict, sizes: dict) -> torch.Tensor:
    """(3, tile, tile) -> (3, tile, tile) maps."""
    x = F.conv2d(tile[None], state["encoder.patch_embed.proj.weight"],
                 state["encoder.patch_embed.proj.bias"], stride=sizes["patch"])
    x = x.permute(0, 2, 3, 1) + state["encoder.pos_embed"]
    width = x.shape[-1]
    depth = 1 + max(int(k.split(".")[2]) for k in state if k.startswith("encoder.blocks."))
    for i in range(depth):
        p = f"encoder.blocks.{i}."
        shortcut = x
        x = F.layer_norm(x, (width,), state[p + "norm1.weight"], state[p + "norm1.bias"], EPS)
        x = shortcut + attention(x, p + "attn.", state, sizes["heads"])
        h = F.layer_norm(x, (width,), state[p + "norm2.weight"], state[p + "norm2.bias"], EPS)
        h = F.gelu(F.linear(h, state[p + "mlp.lin1.weight"], state[p + "mlp.lin1.bias"]))
        x = x + F.linear(h, state[p + "mlp.lin2.weight"], state[p + "mlp.lin2.bias"])
    x = x.permute(0, 3, 1, 2)
    x = F.conv2d(x, state["encoder.neck.0.weight"])
    x = layer_norm_2d(x, state["encoder.neck.1.weight"], state["encoder.neck.1.bias"])
    x = F.conv2d(x, state["encoder.neck.2.weight"], padding=1)
    x = layer_norm_2d(x, state["encoder.neck.3.weight"], state["encoder.neck.3.bias"])
    x1 = F.conv2d(x, state["out.weight"], state["out.bias"])
    return F.conv_transpose2d(x1, state["W2"], stride=sizes["patch"], padding=0)[0]


def taper_mask(ly: int, lx: int, sig: float) -> np.ndarray:
    bsize = max(224, max(ly, lx))
    xm = np.arange(bsize)
    xm = np.abs(xm - xm.mean())
    mask = 1 / (1 + np.exp((xm - (bsize / 2 - 20)) / sig))
    mask = mask * mask[:, np.newaxis]
    return mask[bsize // 2 - ly // 2 : bsize // 2 + ly // 2 + ly % 2,
                bsize // 2 - lx // 2 : bsize // 2 + lx // 2 + lx % 2]


def starts(length: int, bsize: int, overlap: float) -> np.ndarray:
    overlap = min(0.5, max(0.05, overlap))
    n = 1 if length <= bsize else int(np.ceil((1.0 + 2 * overlap) * length / bsize))
    return np.linspace(0, length - bsize, n).astype(int)


def maps(image: torch.Tensor, state: dict, sizes: dict) -> torch.Tensor:
    """(3, H, W) stretched image -> (H, W, 3) float32 maps."""
    state = {k: v.float() for k, v in state.items()}
    b = sizes["tile"]
    _, h, w = image.shape
    top, left = max(0, b - h) // 2, max(0, b - w) // 2
    img = F.pad(image.float(), (left, max(0, b - w) - left, top, max(0, b - h) - top))
    ly, lx = img.shape[1:]
    mask = torch.from_numpy(taper_mask(b, b, sizes["taper_sigma"]))
    yf = torch.zeros((3, ly, lx), dtype=torch.float64)
    navg = torch.zeros((ly, lx), dtype=torch.float64)
    with torch.no_grad(), no_tf32():
        for y0 in starts(ly, b, sizes["overlap"]):
            for x0 in starts(lx, b, sizes["overlap"]):
                out = net(img[:, y0 : y0 + b, x0 : x0 + b], state, sizes)
                yf[:, y0 : y0 + b, x0 : x0 + b] += out.double() * mask
                navg[y0 : y0 + b, x0 : x0 + b] += mask
    yf = (yf / navg)[:, top : top + h, left : left + w]
    return yf.float().permute(1, 2, 0)
