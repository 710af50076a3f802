"""PyTorch port: the U-Net forward and its kernels' plain versions against
the JAX package.

The plain versions of the fused conv and the GroupNorm moments are held
against the Pallas kernels run in interpret mode; the port's forward
against `apply_unet` in float32 and against `apply_unet_s2d` (what the JAX
`SegmentationModel` runs) in bfloat16. Inputs come from numpy seeds. The
GPU-marked tests of the CUDA kernels are in test_torch_cuda_kernels.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcadia_microscopy_tools_tpu.models import conv_pallas, gn_pallas
from arcadia_microscopy_tools_tpu.models.unet import UNetConfig as JaxUNetConfig
from arcadia_microscopy_tools_tpu.models.unet import _group_norm, apply_unet, init_unet
from arcadia_microscopy_tools_tpu.models.unet_s2d import apply_unet_s2d, s2d_params
from arcadia_microscopy_tools_tpu_torch.models import conv_cuda, gn_cuda, tail_cuda
from arcadia_microscopy_tools_tpu_torch.models.unet import UNet, UNetConfig, _upsample2
from arcadia_microscopy_tools_tpu_torch.models.weights import flatten_tree, state_dict_from_tree

# the suite runs in several worker processes at once; one torch thread per
# process keeps them from oversubscribing the host's cores
torch.set_num_threads(1)


def _bf16_pair(a: np.ndarray):
    """The same bfloat16 values for JAX and for torch (both round to nearest even)."""
    return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)


def _f32(a) -> np.ndarray:
    return np.asarray(torch.as_tensor(a).float() if torch.is_tensor(a) else np.asarray(a, np.float32))


def _assert_within_one_bf16_ulp(got, want):
    """Tolerance for two bfloat16 results of the same f32 sums taken in another
    order: one bf16 step of the value (2^-7 relative) plus 1e-4 of the
    largest magnitude for sums that cancel."""
    got, want = _f32(got), _f32(want)
    tol = np.abs(want) / 128 + 1e-4 * np.abs(want).max()
    assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()


@pytest.fixture(scope="module")
def jax_params():
    return init_unet(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_state(jax_params):
    return state_dict_from_tree(flatten_tree(jax.tree.map(np.asarray, jax_params)))


class TestConvPlainMatchesPallas:
    """Plain `conv3x3_fused` vs the Pallas kernel in interpret mode, called
    as tests/test_conv_pallas.py calls it (C, Co lane-aligned, W = 128)."""

    def _case(self, seed, b, h, w, c, co):
        rng = np.random.default_rng(seed)
        x = rng.normal(size=(b, h, w, c)).astype(np.float32)
        wk = (rng.normal(size=(3, 3, c, co)) * 0.05).astype(np.float32)
        xj, xt = _bf16_pair(x)
        wj, _ = _bf16_pair(wk)
        wt = torch.from_numpy(wk.transpose(0, 1, 3, 2).copy()).to(torch.bfloat16)
        return rng, xj, xt, wj, wt

    @pytest.mark.parametrize("shape", [(1, 16, 128, 128, 128), (2, 16, 128, 128, 256)])
    def test_plain(self, shape):
        _, xj, xt, wj, wt = self._case(0, *shape)
        want = conv_pallas.conv3x3_fused(xj, wj, interpret=True)
        got = conv_cuda.conv3x3_fused(xt, wt)
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        _assert_within_one_bf16_ulp(got, np.asarray(want, np.float32))

    def test_prologue_relu(self):
        rng, xj, xt, wj, wt = self._case(1, 2, 16, 128, 128, 128)
        scale = (rng.normal(size=(2, 128)) * 0.5 + 1).astype(np.float32)
        bias = (rng.normal(size=(2, 128)) * 0.1).astype(np.float32)
        want = conv_pallas.conv3x3_fused(
            xj, wj, prologue=(jnp.asarray(scale), jnp.asarray(bias)), relu=True, interpret=True
        )
        got = conv_cuda.conv3x3_fused(
            xt, wt, prologue=(torch.from_numpy(scale), torch.from_numpy(bias)), relu=True
        )
        _assert_within_one_bf16_ulp(got, np.asarray(want, np.float32))

    def test_accum_and_moments(self):
        rng, xj, xt, wj, wt = self._case(2, 1, 16, 128, 128, 128)
        z = (rng.normal(size=(1, 16, 128, 128)) * 0.5).astype(np.float32)
        zj, zt = _bf16_pair(z)
        want, (s1w, s2w) = conv_pallas.conv3x3_fused(
            xj, wj, accum=zj, emit_moments=True, interpret=True
        )
        got, (s1, s2) = conv_cuda.conv3x3_fused(xt, wt, accum=zt, emit_moments=True)
        _assert_within_one_bf16_ulp(got, np.asarray(want, np.float32))
        # moments of outputs that may differ by one bf16 step in a few places,
        # summed in another order: 1e-4 of the sums of magnitudes
        y = _f32(got)
        np.testing.assert_allclose(s1.numpy(), np.asarray(s1w), rtol=0,
                                   atol=1e-4 * np.abs(y).sum((1, 2)).max())
        np.testing.assert_allclose(s2.numpy(), np.asarray(s2w), rtol=0,
                                   atol=1e-4 * (y * y).sum((1, 2)).max())

    def test_float32_input_runs_in_float32(self):
        x = torch.randn(1, 8, 8, 32, generator=torch.Generator().manual_seed(0))
        w = torch.randn(3, 3, 32, 32, generator=torch.Generator().manual_seed(1))
        y = conv_cuda.conv3x3_fused(x, w)
        ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w.permute(2, 3, 0, 1), padding=1)
        assert y.dtype == torch.float32
        torch.testing.assert_close(y, ref.permute(0, 2, 3, 1), rtol=1e-5, atol=1e-5)

    def test_rejects_bad_shapes(self):
        with pytest.raises(ValueError):
            conv_cuda.conv3x3_fused(torch.zeros(1, 8, 8, 32), torch.zeros(3, 3, 32, 16))
        with pytest.raises(ValueError):
            conv_cuda.conv3x3_fused(torch.zeros(1, 8, 8, 32), torch.zeros(3, 3, 32, 32), relu=True)


class TestGroupNormMatchesJax:
    def test_gn_affine_params(self):
        rng = np.random.default_rng(3)
        s1 = (rng.normal(size=(2, 64)) * 100).astype(np.float32)
        s2 = (np.abs(rng.normal(size=(2, 64))) * 1e4 + s1**2 / 500).astype(np.float32)
        scale = rng.normal(size=64).astype(np.float32)
        bias = rng.normal(size=64).astype(np.float32)
        want = conv_pallas.gn_affine_params(
            jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(scale), jnp.asarray(bias), 8, 4096
        )
        got = conv_cuda.gn_affine_params(
            torch.from_numpy(s1), torch.from_numpy(s2), torch.from_numpy(scale),
            torch.from_numpy(bias), 8, 4096,
        )
        for g, w in zip(got, want):  # float32 folds of the same values: 1e-5 relative
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)

    def test_lane_moments(self):
        rng = np.random.default_rng(4)
        xj, xt = _bf16_pair(rng.normal(size=(2, 16, 128, 128)).astype(np.float32))
        want = gn_pallas.lane_moments(xj, interpret=True)
        got = gn_cuda.lane_moments(xt)
        for g, w in zip(got, want):  # f32 sums in another order: 1e-5 relative
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-3)

    @pytest.mark.parametrize("c", [128, 256])
    def test_group_norm(self, c):
        rng = np.random.default_rng(5)
        xj, xt = _bf16_pair((rng.normal(size=(2, 16, 16, c)) * 3 + 1).astype(np.float32))
        scale = (rng.normal(size=c) * 0.5 + 1).astype(np.float32)
        bias = (rng.normal(size=c) * 0.1).astype(np.float32)
        got = gn_cuda.group_norm(xt, torch.from_numpy(scale), torch.from_numpy(bias), 8)
        for want in (
            gn_pallas.group_norm_pallas(xj, jnp.asarray(scale), jnp.asarray(bias), 8, interpret=True),
            _group_norm(xj, jnp.asarray(scale), jnp.asarray(bias), 8),
        ):
            _assert_within_one_bf16_ulp(got, np.asarray(want, np.float32))


class TestBlockTail:
    """The plain block tail against the PyTorch expressions the forward ran
    before it: `_upsample2(up) + skip` for the decoder's split residual,
    then GN2's affine in float32, the residual add and the ReLU in the
    compute dtype, then `+= style`."""

    @staticmethod
    def _operands(dtype, split: bool, style: bool):
        g = torch.Generator().manual_seed(11)
        b, h, w, c = 2, 12, 20, 32
        y = (torch.randn((b, h, w, c), generator=g) * 3).to(dtype)
        y[0, 0, :4] = -0.0  # signed zeros through the affine and the ReLU
        scale = torch.randn((b, c), generator=g) + 1
        bias = torch.randn((b, c), generator=g) * 0.5
        bias[0, :8] = -0.0
        skip = torch.randn((b, h, w, c), generator=g).to(dtype)
        skip[0, 0, :4] = -0.0
        up = torch.randn((b, h // 2, w // 2, c), generator=g).to(dtype) if split else None
        row = (torch.randn((b, c), generator=g) * 0.3).to(dtype) if style else None
        return y, scale, bias, skip, up, row

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
    @pytest.mark.parametrize("form", ["skip", "split skip", "split skip and style"])
    @pytest.mark.parametrize("in_place", [False, True])
    def test_plain_matches_the_replaced_expressions(self, dtype, form, in_place):
        y, scale, bias, skip, up, row = self._operands(dtype, "split" in form, "style" in form)
        r = skip if up is None else _upsample2(up) + skip
        f = y.float().clone()  # float32 y: y.float() is y itself
        f.mul_(scale[:, None, None, :]).add_(bias[:, None, None, :])
        want = f.to(dtype)
        want += r.to(dtype)
        want.relu_()
        if row is not None:
            want += row[:, None, None, :]
        y_in = y.clone()
        out = y if in_place else None
        got = tail_cuda.unet_tail(y, scale, bias, skip, up=up, style=row, out=out)
        assert got.dtype == dtype and (got is y) == in_place
        assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                           want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
        if not in_place:
            assert torch.equal(y, y_in)
        assert tail_cuda.launch_counts["unet_tail"] == 0

    def test_plain_reads_up_at_half_resolution_on_odd_shapes(self):
        """Odd H and W: `up` holds ceil(H / 2) x ceil(W / 2) pixels, each
        read by the 2 x 2 block at (y // 2, x // 2) that lies in the image."""
        g = torch.Generator().manual_seed(12)
        y = torch.randn((1, 5, 7, 8), generator=g).to(torch.bfloat16)
        one, zero = torch.ones((1, 8)), torch.zeros((1, 8))
        skip = torch.zeros_like(y)
        up = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4, 1).expand(1, 3, 4, 8)
        got = tail_cuda.unet_tail_plain(torch.zeros_like(y), one, zero, skip,
                                        up=up.to(torch.bfloat16).contiguous())
        yy, xx = torch.meshgrid(torch.arange(5), torch.arange(7), indexing="ij")
        assert torch.equal(got[0, ..., 0].float(), ((yy // 2) * 4 + xx // 2).float())

    def test_the_wrapper_refuses_a_device_without_a_kernel(self):
        y = torch.zeros((1, 4, 4, 8), dtype=torch.bfloat16, device="meta")
        rows = torch.zeros((1, 8), device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            tail_cuda.unet_tail(y, rows, rows, y)


class TestForwardMatchesJax:
    def test_float32_matches_apply_unet(self, jax_params, port_state):
        """Same parameters (converted from `init_unet(PRNGKey(0))`), float32.
        The port's GroupNorm is one-pass and the JAX f32 path two-pass, and
        the decoder sums its split convs in another order: 1e-4 absolute
        (outputs are O(5); measured ~1e-5)."""
        x = np.random.default_rng(6).random((2, 64, 64, 3)).astype(np.float32)
        want = apply_unet(jax_params, jnp.asarray(x), JaxUNetConfig(compute_dtype=jnp.float32))
        net = UNet(UNetConfig(compute_dtype=torch.float32))
        net.load_state_dict(port_state)
        got = net(torch.from_numpy(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 64, 3)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("size", [64, 96])
    def test_bfloat16_matches_apply_unet_s2d(self, jax_params, port_state, size):
        """bfloat16, against the S2D forward the JAX `SegmentationModel`
        runs. The two round to bf16 at different points (S2D kernels, split
        projections, fused GN), so they agree to bf16 noise: mean absolute
        difference within 0.6% and the largest within 5% of the output's
        largest magnitude (JAX's own plain and S2D forwards differ alike)."""
        x = np.random.default_rng(7).random((2, size, size, 3)).astype(np.float32)
        want = np.asarray(apply_unet_s2d(s2d_params(jax_params), jnp.asarray(x)))
        net = UNet()
        net.load_state_dict(port_state)
        got = net(torch.from_numpy(x)).numpy()
        scale = np.abs(want).max()
        d = np.abs(got - want)
        assert d.mean() <= 0.006 * scale, (d.mean(), scale)
        assert d.max() <= 0.05 * scale, (d.max(), scale)


class TestUNetModule:
    def test_parameter_names_and_shapes_follow_init_unet(self, jax_params):
        names = dict(UNet().named_parameters())
        flat = flatten_tree(jax.tree.map(np.asarray, jax_params))
        assert set(names) == set(flat)
        for name, leaf in flat.items():
            shape = tuple(leaf.shape)
            if len(shape) == 4 and shape[:2] == (3, 3):
                shape = (3, 3, shape[3], shape[2])
            elif len(shape) == 4:
                shape = shape[2:]
            assert tuple(names[name].shape) == shape, name

    def test_seeded_init_is_deterministic_with_he_scale(self):
        a = UNet(generator=torch.Generator().manual_seed(3))
        b = UNet(generator=torch.Generator().manual_seed(3))
        c = UNet(generator=torch.Generator().manual_seed(4))
        for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
            assert torch.equal(pa, pb), name
        assert not torch.equal(a.down[1].conv1, c.down[1].conv1)
        w = a.up[0].conv1  # (3, 3, 128, 384): fan-in 9 * 384
        assert abs(w.std().item() / np.sqrt(2 / (9 * 384)) - 1) < 0.02

    def test_forward_on_the_card_refuses_float32(self):
        """Off the CPU the float32 forward is no longer refused: it runs the
        kernels' plain versions (as the JAX package runs its float32 forward
        outside the bfloat16 Pallas conv) and launches no kernel. A device
        without data (meta) checks the dispatch and the output's shape."""
        net = UNet(UNetConfig(compute_dtype=torch.float32)).to("meta")
        conv_cuda.reset_launch_counts()
        gn_cuda.reset_launch_counts()
        out = net(torch.zeros(1, 16, 16, 3, device="meta"))
        assert out.shape == (1, 16, 16, 3) and out.dtype == torch.float32
        assert conv_cuda.launch_counts["conv3x3_fused"] == gn_cuda.launch_counts["lane_moments"] == 0
