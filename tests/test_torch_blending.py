"""PyTorch port: overlays - twins of tests/test_blending.py run through the
port on the CPU, `create_overlay` and `overlay_channels` against the JAX
package, and on the card against the CPU (gpu-marked).

Both packages compute the overlay in float32 (the JAX package with x64
off); the port is held to the JAX package at atol 1e-6.
"""

import warnings

import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu_torch.blending import (
    BlendMode,
    Layer,
    _blend_additive,
    _blend_alpha,
    _build_colormap,
    _gray_to_rgb,
)
from arcadia_microscopy_tools_tpu_torch.blending import create_overlay as port_create_overlay
from arcadia_microscopy_tools_tpu_torch.blending import overlay_channels as port_overlay_channels
from arcadia_microscopy_tools_tpu_torch.channels import Channel

torch.set_num_threads(1)

CHAN_BLUE = Channel("Blue", "#0000FF")
CHAN_GREEN = Channel("Green", "#00FF00")


def create_overlay(background, layers, **kwargs):
    """The port's function on the CPU, where the twins run."""
    kwargs.setdefault("device", "cpu")
    return port_create_overlay(background, layers, **kwargs)


def overlay_channels(background, channel_intensities, **kwargs):
    kwargs.setdefault("device", "cpu")
    return port_overlay_channels(background, channel_intensities, **kwargs)


def t(a) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


@pytest.fixture
def background():
    return np.full((4, 4), 0.5, dtype=np.float64)


@pytest.fixture
def ones_layer():
    return np.ones((4, 4), dtype=np.float64)


@pytest.fixture
def zeros_layer():
    return np.zeros((4, 4), dtype=np.float64)


# -- twins of tests/test_blending.py --------------------------------------------------


class TestLayer:
    def test_valid_layer(self, ones_layer):
        layer = Layer(CHAN_BLUE, ones_layer)
        assert layer.opacity == 1.0
        assert layer.zero_transparent is True
        assert layer.blend_mode is BlendMode.ALPHA

    def test_non_2d_intensities_raises(self):
        with pytest.raises(ValueError, match="Expected 2D"):
            Layer(CHAN_BLUE, np.ones((4, 4, 3), dtype=np.float64))

    def test_opacity_out_of_range_raises(self, ones_layer):
        with pytest.raises(ValueError, match="Opacity must be in"):
            Layer(CHAN_BLUE, ones_layer, opacity=-0.1)
        with pytest.raises(ValueError, match="Opacity must be in"):
            Layer(CHAN_BLUE, ones_layer, opacity=1.5)

    def test_out_of_range_intensities_warns_and_clips(self):
        raw = np.array([[0.0, 2.0], [-0.5, 0.5]], dtype=np.float64)
        with pytest.warns(match="outside \\[0, 1\\]"):
            layer = Layer(CHAN_BLUE, raw)
        assert float(layer.intensities.min()) >= 0.0
        assert float(layer.intensities.max()) <= 1.0

    def test_in_range_intensities_no_warning(self, ones_layer):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Layer(CHAN_BLUE, ones_layer)


class TestBlendFunctions:
    def test_alpha_zero_returns_background(self):
        bg, fg, alpha = t(np.full((2, 2, 3), 0.3)), t(np.full((2, 2, 3), 0.9)), t(np.zeros((2, 2, 1)))
        np.testing.assert_allclose(_blend_alpha(bg, fg, alpha).numpy(), bg.numpy())
        np.testing.assert_allclose(_blend_additive(bg, fg, alpha).numpy(), bg.numpy())

    def test_alpha_one_returns_foreground(self):
        bg, fg, alpha = t(np.full((2, 2, 3), 0.3)), t(np.full((2, 2, 3), 0.9)), t(np.ones((2, 2, 1)))
        np.testing.assert_allclose(_blend_alpha(bg, fg, alpha).numpy(), fg.numpy(), atol=1e-7)

    def test_alpha_half_is_midpoint(self):
        bg, fg, alpha = t(np.zeros((2, 2, 3))), t(np.ones((2, 2, 3))), t(np.full((2, 2, 1), 0.5))
        np.testing.assert_allclose(_blend_alpha(bg, fg, alpha).numpy(), 0.5)

    def test_additive_accumulates_and_clips(self):
        bg, fg, alpha = t(np.full((2, 2, 3), 0.8)), t(np.full((2, 2, 3), 0.5)), t(np.ones((2, 2, 1)))
        np.testing.assert_allclose(_blend_additive(bg, fg, alpha).numpy(), 1.0)

    def test_additive_commutative(self, background):
        a = np.random.default_rng(0).random((4, 4))
        b = np.random.default_rng(1).random((4, 4))
        ab = overlay_channels(
            background, {CHAN_BLUE: a, CHAN_GREEN: b}, blend_mode=BlendMode.ADDITIVE
        )
        ba = overlay_channels(
            background, {CHAN_GREEN: b, CHAN_BLUE: a}, blend_mode=BlendMode.ADDITIVE
        )
        np.testing.assert_allclose(ab, ba, atol=1e-7)


class TestColormap:
    def test_lru_identity(self):
        assert _build_colormap("#00FF00", True) is _build_colormap("#00FF00", True)

    def test_transparent_anchor(self):
        cmap = _build_colormap("#FF0000", True)
        rgba0 = cmap(torch.zeros((1, 1))).numpy()
        rgba1 = cmap(torch.ones((1, 1))).numpy()
        assert rgba0[0, 0, 3] == 0.0
        np.testing.assert_allclose(rgba0[0, 0, :3], 0.5)
        assert rgba1[0, 0, 3] == 1.0
        np.testing.assert_allclose(rgba1[0, 0, :3], [1, 0, 0], atol=1e-6)

    def test_opaque_black_anchor(self):
        rgba0 = _build_colormap("#FF0000", False)(torch.zeros((1, 1))).numpy()
        np.testing.assert_allclose(rgba0[0, 0], [0, 0, 0, 1], atol=1e-7)


class TestCreateOverlay:
    def test_shape_and_range(self, background, ones_layer):
        out = create_overlay(background, [Layer(CHAN_BLUE, ones_layer)])
        assert out.shape == (4, 4, 3)
        assert out.dtype == np.float64
        assert out.min() >= 0 and out.max() <= 1

    def test_non_2d_background_raises(self, ones_layer):
        with pytest.raises(ValueError, match="Expected 2D background"):
            create_overlay(np.zeros((4, 4, 3)), [Layer(CHAN_BLUE, ones_layer)])

    def test_shape_mismatch_raises(self, background):
        with pytest.raises(ValueError, match="has shape"):
            create_overlay(background, [Layer(CHAN_BLUE, np.ones((5, 5)))])

    def test_out_of_range_background_warns(self, ones_layer):
        with pytest.warns(match="outside \\[0, 1\\]"):
            create_overlay(np.full((4, 4), 1.5), [Layer(CHAN_BLUE, ones_layer)])

    def test_zero_intensity_transparent_leaves_background(self, background, zeros_layer):
        out = create_overlay(background, [Layer(CHAN_BLUE, zeros_layer)])
        np.testing.assert_allclose(out, _gray_to_rgb(t(background)).numpy(), atol=1e-7)

    def test_full_intensity_opaque_is_channel_color(self, background, ones_layer):
        out = create_overlay(background, [Layer(CHAN_BLUE, ones_layer, opacity=1.0)])
        np.testing.assert_allclose(out[..., 2], 1.0, atol=1e-6)
        np.testing.assert_allclose(out[..., 0], 0.0, atol=1e-6)

    def test_opacity_scales_contribution(self, background, ones_layer):
        full = create_overlay(background, [Layer(CHAN_BLUE, ones_layer, opacity=1.0)])
        half = create_overlay(background, [Layer(CHAN_BLUE, ones_layer, opacity=0.5)])
        expected = 0.5 * full[..., 2] + 0.5 * np.asarray(background)
        np.testing.assert_allclose(half[..., 2], expected, atol=1e-6)

    def test_overlay_channels_wrapper(self, background, ones_layer, zeros_layer):
        out = overlay_channels(background, {CHAN_BLUE: ones_layer, CHAN_GREEN: zeros_layer})
        assert out.shape == (4, 4, 3)

    def test_device_input_returns_device_array(self, background, ones_layer):
        """A tensor background stays a tensor on its own device."""
        out = port_create_overlay(torch.from_numpy(background), [Layer(CHAN_BLUE, ones_layer)])
        assert isinstance(out, torch.Tensor)
        assert out.device == torch.device("cpu") and out.dtype == torch.float32


class TestEmptyLayers:
    def test_no_layers_returns_gray_rgb(self):
        bg = np.linspace(0, 1, 64 * 64).reshape(64, 64)
        out = create_overlay(bg, [])
        assert out.shape == (64, 64, 3)
        for c in range(3):
            np.testing.assert_allclose(out[..., c], bg, atol=1e-6)

    def test_overlay_channels_empty_dict(self):
        bg = np.full((32, 32), 0.5)
        out = overlay_channels(bg, {})
        assert out.shape == (32, 32, 3)
        np.testing.assert_allclose(out[..., 0], bg, atol=1e-6)


# -- the port against the JAX package ------------------------------------------------

COLORS = ["#0000FF", "#00FF00", "#FF00FF", "#F80"]


def _scene(seed: int, shape=(48, 64), n=3):
    rng = np.random.default_rng(seed)
    return rng.random(shape), [rng.random(shape) for _ in range(n)]


def _mixed_layers(layer_cls, channel_cls, mode_cls, planes):
    """Layers of mixed opacity, anchor and blend mode, built from one
    package's classes."""
    settings = [(0.9, True, "ALPHA"), (0.7, True, "ADDITIVE"), (0.5, False, "ALPHA"),
                (1.0, False, "ADDITIVE")]
    return [
        layer_cls(channel_cls(f"C{k}", COLORS[k]), p, opacity=o, zero_transparent=z,
                  blend_mode=getattr(mode_cls, m))
        for k, (p, (o, z, m)) in enumerate(zip(planes, settings))
    ]


@pytest.mark.parametrize("n_layers", [1, 3, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_create_overlay_matches_jax(seed, n_layers):
    from arcadia_microscopy_tools_tpu.blending import BlendMode as JaxBlendMode
    from arcadia_microscopy_tools_tpu.blending import Layer as JaxLayer
    from arcadia_microscopy_tools_tpu.blending import create_overlay as jax_create_overlay
    from arcadia_microscopy_tools_tpu.channels import Channel as JaxChannel

    bg, planes = _scene(seed, n=n_layers)
    want = jax_create_overlay(bg, _mixed_layers(JaxLayer, JaxChannel, JaxBlendMode, planes))
    got = create_overlay(bg, _mixed_layers(Layer, Channel, BlendMode, planes))
    assert got.dtype == np.float64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["ALPHA", "ADDITIVE"])
@pytest.mark.parametrize("zero_transparent", [True, False])
def test_overlay_channels_matches_jax(mode, zero_transparent):
    from arcadia_microscopy_tools_tpu.blending import BlendMode as JaxBlendMode
    from arcadia_microscopy_tools_tpu.blending import overlay_channels as jax_overlay_channels
    from arcadia_microscopy_tools_tpu.channels import Channel as JaxChannel

    bg, planes = _scene(2)
    # out-of-range values on both sides: the same warnings, the same clips
    bg[0, 0], planes[1][3, 3] = 1.25, -0.5
    kw = dict(opacity=0.8, zero_transparent=zero_transparent)
    with pytest.warns(UserWarning, match="outside"):
        want = jax_overlay_channels(
            bg, {JaxChannel(f"C{k}", COLORS[k]): p for k, p in enumerate(planes)},
            blend_mode=getattr(JaxBlendMode, mode), **kw,
        )
    with pytest.warns(UserWarning, match="outside"):
        got = overlay_channels(
            bg, {Channel(f"C{k}", COLORS[k]): p for k, p in enumerate(planes)},
            blend_mode=getattr(BlendMode, mode), **kw,
        )
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_no_device_means_the_card(monkeypatch, background, ones_layer):
    """A NumPy background without `device` asks for the CUDA card and raises
    where there is none; it never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_create_overlay(background, [Layer(CHAN_BLUE, ones_layer)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_overlay_channels(background, {CHAN_BLUE: ones_layer})


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_overlay_matches_cpu_and_warns(cuda_device):
    bg, planes = _scene(3, shape=(256, 320))
    bg[0, 0], planes[2][5, 5] = 1.5, 2.0
    with pytest.warns(UserWarning, match="outside"):
        layers = _mixed_layers(Layer, Channel, BlendMode, planes)
    with pytest.warns(UserWarning, match="outside"):
        card = port_create_overlay(bg, layers, device=cuda_device)
    with pytest.warns(UserWarning, match="outside"):
        cpu = create_overlay(bg, layers)
    np.testing.assert_allclose(card, cpu, rtol=0, atol=1e-6)
    on_card = port_create_overlay(torch.from_numpy(bg).to(cuda_device).clamp(0, 1), layers)
    assert on_card.device.type == "cuda"
    with pytest.warns(UserWarning, match="outside"):
        Layer(CHAN_BLUE, torch.full((4, 4), 1.5, device=cuda_device))
