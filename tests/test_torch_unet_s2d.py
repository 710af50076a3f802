"""PyTorch port: the space-to-depth U-Net (models/unet_s2d.py) and the S2D
compact mask route against the JAX package.

The host-side kernel rewrites and `s2d_params` equal the JAX package's
arrays bit for bit; `s2d_supported` agrees with it. The forward's library
convs (stride-2 stems, fractionally-strided up convs) equal
`lax.conv_general_dilated` within 1e-5 in float32. The float32 forward
agrees with `apply_unet_s2d` within 1e-4 absolute (outputs O(5); measured
~1e-5: the port's GroupNorm is one-pass, JAX's float32 path two-pass, and
the convs sum in other orders); the bfloat16 forward within the planar
tests' gate (mean difference within 0.6%, largest within 5% of the output's
largest magnitude). The planar output is the S2D head's permutation bit for
bit. `compute_masks_sparse_compact_s2d` equals the port's planar route on
the permuted tensor and the JAX S2D function bit for bit, including the S2D
segment budget above 2^20 pixels. Inputs come from numpy seeds; the sizes
are 64^2-128^2 but for the segment budget's 1024^2 masks.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from arcadia_microscopy_tools_tpu.models import flows as jflows
from arcadia_microscopy_tools_tpu.models import unet_s2d as J
from arcadia_microscopy_tools_tpu.models.synthetic import synthesize_cells
from arcadia_microscopy_tools_tpu.models.unet import UNetConfig as JaxUNetConfig
from arcadia_microscopy_tools_tpu.models.unet import init_unet
from arcadia_microscopy_tools_tpu.models.weights import load_checkpoint
from arcadia_microscopy_tools_tpu_torch.models import conv_cuda, flows, gn_cuda
from arcadia_microscopy_tools_tpu_torch.models import unet_s2d as P
from arcadia_microscopy_tools_tpu_torch.models.unet import UNetConfig
from arcadia_microscopy_tools_tpu_torch.models.weights import flatten_tree, load_weights
from arcadia_microscopy_tools_tpu_torch.models.weights import tree_from_state_dict, unflatten_tree

REPO = Path(__file__).resolve().parent.parent

# one torch thread per test worker process (the suite runs several at once)
torch.set_num_threads(1)

F32 = UNetConfig(compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def init_tree():
    return jax.tree.map(np.asarray, init_unet(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def trained_tree():
    """The trained checkpoint for JAX (orbax) and for the port (its `.npz`
    through the `UNet` state_dict and back)."""
    return (jax.tree.map(np.asarray, load_checkpoint(REPO / "checkpoints" / "unet")),
            tree_from_state_dict(load_weights()))


def _blobs(seed: int, size: int, n: int = 2) -> np.ndarray:
    """(n, size, size) synthetic cell images."""
    rng = np.random.default_rng(seed)
    return np.stack([synthesize_cells(rng, (size, size), n_cells=6)[0] for _ in range(n)]).astype(
        np.float32)


def _assert_bf16_gate(got: np.ndarray, want: np.ndarray) -> None:
    scale = np.abs(want).max()
    d = np.abs(got - want)
    assert d.mean() <= 0.006 * scale, (d.mean(), scale)
    assert d.max() <= 0.05 * scale, (d.max(), scale)


def _rewrite_cases():
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.normal(size=shape).astype(np.float32)

    block = {"conv1": w(3, 3, 5, 6), "conv2": w(3, 3, 6, 6), "proj": w(1, 1, 5, 6),
             **{k: w(6) for k in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")}}
    up_block = {"conv1": w(3, 3, 10, 4), "conv2": w(3, 3, 4, 4), "proj": w(1, 1, 10, 4),
                **{k: w(4) for k in ("gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")}}
    planar, s2d = w(2, 8, 12, 3), w(2, 4, 6, 12)
    return [
        ("_s2d_conv_kernel 3x3", lambda m: m._s2d_conv_kernel(block["conv1"])),
        ("_s2d_conv_kernel 1x1", lambda m: m._s2d_conv_kernel(block["proj"])),
        ("_stem_conv_kernel", lambda m: m._stem_conv_kernel(block["conv1"])),
        ("_stem_proj_kernel", lambda m: m._stem_proj_kernel(block["proj"])),
        ("_head_kernel", lambda m: m._head_kernel(block["proj"])),
        ("_compose_d2s_conv3_kernel", lambda m: m._compose_d2s_conv3_kernel(block["conv2"])),
        ("_d2s_kernel", lambda m: m._d2s_kernel(6, np.float32)),
        ("_split_up_kernel", lambda m: m._split_up_kernel(up_block["conv1"], 6)),
        ("_split_up_kernel 1x1", lambda m: m._split_up_kernel(up_block["proj"], 6)),
        ("_UP_TAPS", lambda m: m._UP_TAPS),
        ("_up0_block", lambda m: m._up0_block(up_block, 6)),
        ("_s2d_up_block", lambda m: m._s2d_up_block(up_block, 6)),
        ("_s2d_block stem", lambda m: m._s2d_block(block, stem=True)),
        ("_s2d_block", lambda m: m._s2d_block(block, stem=False)),
        ("_s2d", lambda m: m._s2d(planar)),
        ("_d2s", lambda m: m._d2s(s2d, 3)),
    ]


def _assert_trees_equal(got, want) -> None:
    got, want = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert set(got) == set(want)
    for name, leaf in want.items():
        assert got[name].dtype == leaf.dtype, name
        np.testing.assert_array_equal(got[name], leaf, err_msg=name)


class TestRewrites:
    @pytest.mark.parametrize("name, fn", _rewrite_cases(), ids=[c[0] for c in _rewrite_cases()])
    def test_rewrite_equals_jax(self, name, fn):
        """Each host-side rewrite, the same random float32 weights: the
        same arrays, dtypes included (the JAX package's, converted to
        numpy)."""
        _assert_trees_equal(fn(P), fn(J))

    def test_tensor_helpers_follow_the_numpy_ones(self):
        x = np.random.default_rng(1).normal(size=(2, 8, 12, 3)).astype(np.float32)
        s = P._s2d(torch.from_numpy(x))
        np.testing.assert_array_equal(s.numpy(), np.asarray(J._s2d(jnp.asarray(x))))
        np.testing.assert_array_equal(P._d2s(s, 3).numpy(), x)

    @pytest.mark.parametrize("gray_input", [False, True])
    @pytest.mark.parametrize("weights", ["init", "trained"])
    def test_s2d_params_equal_jax_leaf_by_leaf(self, init_tree, trained_tree, weights, gray_input):
        """The port takes the tree flattened to dotted keys (the trained one
        from its own `.npz` through the `UNet` state_dict); JAX the nested
        tree."""
        jax_tree, port_flat = ((init_tree, flatten_tree(init_tree)) if weights == "init"
                               else trained_tree)
        _assert_trees_equal(P.s2d_params(port_flat, gray_input=gray_input),
                            J.s2d_params(jax_tree, gray_input=gray_input))

    def test_unflatten_tree_inverts_flatten_tree(self, init_tree):
        """`s2d_params` and `s2d_supported` take the tree flattened to dotted
        keys through `weights.unflatten_tree`."""
        _assert_trees_equal(unflatten_tree(flatten_tree(init_tree)), init_tree)

    def test_s2d_supported_agrees_with_jax(self, init_tree):
        shallow = dict(init_tree, down=init_tree["down"][:3])
        narrow = jax.tree.map(np.asarray, init_unet(jax.random.PRNGKey(1),
                                                    JaxUNetConfig(base_channels=(16, 32, 64, 128))))
        for tree in (init_tree, shallow, narrow, {"not": "a unet tree"}, None, {"down": 3}):
            assert P.s2d_supported(tree) == J.s2d_supported(tree)
        assert P.s2d_supported(init_tree) and not P.s2d_supported(shallow)
        assert P.s2d_supported(flatten_tree(init_tree))
        assert P.s2d_supported(narrow, UNetConfig(base_channels=(16, 32, 64, 128))) == \
            J.s2d_supported(narrow, JaxUNetConfig(base_channels=(16, 32, 64, 128)))


def _lax_conv(x, w, strides, pad, lhs_dilation=(1, 1)):
    dn = lax.conv_dimension_numbers(x.shape, w.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), strides,
                                               ((pad, pad), (pad, pad)), lhs_dilation=lhs_dilation,
                                               dimension_numbers=dn))


@pytest.mark.parametrize("k, pad, transposed", [(4, 1, False), (2, 0, False), (4, 2, True),
                                                 (2, 1, True)])
def test_library_conv_forms_equal_lax(k, pad, transposed):
    """The stride-2 stems (`_conv_stride2`) and the fractionally-strided up
    convs (`_conv_up`: input dilated by 2, padding `pad`) against
    `lax.conv_general_dilated`, float32 within 1e-5."""
    rng = np.random.default_rng(k + pad)
    x = rng.normal(size=(2, 16, 24, 5)).astype(np.float32)
    w = (rng.normal(size=(k, k, 5, 7)) * 0.3).astype(np.float32)
    if transposed:
        want = _lax_conv(x, w, (1, 1), pad, lhs_dilation=(2, 2))
        role, tpad = P._UP, k - 1 - pad
    else:
        want = _lax_conv(x, w, (2, 2), pad)
        role, tpad = P._STRIDE2, pad
    got = P._library_conv(torch.from_numpy(x), P._layout(role, w), tpad, transposed)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


class TestForward:
    @pytest.mark.parametrize("inputs", ["random", "blobs"])
    def test_float32_matches_apply_unet_s2d(self, init_tree, inputs):
        """float32, 1e-4 absolute (outputs O(5); measured ~1e-5)."""
        x = (np.random.default_rng(6).random((2, 64, 64, 3)).astype(np.float32)
             if inputs == "random" else np.repeat(_blobs(3, 64)[..., None], 3, -1))
        sp = J.s2d_params(init_tree)
        want = np.asarray(J.apply_unet_s2d(sp, jnp.asarray(x), JaxUNetConfig(compute_dtype=jnp.float32)))
        got = P.UNetS2D(P.s2d_params(init_tree), F32)(torch.from_numpy(x))
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 64, 64, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)

    def test_gray_input_fold(self, init_tree):
        """`gray_input=True` on (B, H, W, 1) against the replicated
        three-channel input in float32 (the folded stem sums the three
        inputs' weights first): within 1e-4 absolute of each other (measured
        ~1e-5), and the gray forward against JAX's within 1e-4."""
        x = _blobs(4, 64)[..., None]
        gray = P.UNetS2D(P.s2d_params(init_tree, gray_input=True), F32)
        rgb = P.UNetS2D(P.s2d_params(init_tree), F32)
        got = gray(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), rgb(torch.from_numpy(np.repeat(x, 3, -1))).numpy(),
                                   rtol=0, atol=1e-4)
        want = J.apply_unet_s2d(J.s2d_params(init_tree, gray_input=True), jnp.asarray(x),
                                JaxUNetConfig(compute_dtype=jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)

    @pytest.mark.parametrize("size", [64, 128])
    def test_bfloat16_matches_apply_unet_s2d(self, trained_tree, size):
        """bfloat16 with the trained weights, against the JAX S2D forward:
        the planar tests' gate (the two round to bf16 at the same points but
        sum in other orders)."""
        jax_tree, port_flat = trained_tree
        x = np.repeat(_blobs(5, size)[..., None], 3, -1)
        want = np.asarray(J.apply_unet_s2d(J.s2d_params(jax_tree), jnp.asarray(x)))
        got = P.UNetS2D(P.s2d_params(port_flat))(torch.from_numpy(x)).numpy()
        _assert_bf16_gate(got, want)

    @pytest.mark.parametrize("config", [UNetConfig(), F32], ids=["bfloat16", "float32"])
    def test_planar_output_is_the_s2d_head_permuted(self, init_tree, config):
        net = P.UNetS2D(P.s2d_params(init_tree, gray_input=True), config)
        x = torch.from_numpy(np.random.default_rng(8).random((1, 64, 64, 1)).astype(np.float32))
        out_s2d = net(x, out_s2d=True)
        assert tuple(out_s2d.shape) == (1, 32, 32, 12) and out_s2d.dtype == torch.float32
        assert torch.equal(P._d2s(out_s2d, 3), net(x))

    def test_refuses_bad_input(self, init_tree):
        net = P.UNetS2D(P.s2d_params(init_tree), F32)
        with pytest.raises(ValueError, match="multiples of 8"):
            net(torch.zeros(1, 36, 64, 3))
        with pytest.raises(ValueError, match="input channels"):
            net(torch.zeros(1, 64, 64, 1))


def _compact_equal(got, k: int, want, names=("labels", "lab_c", "idx", "valid", "ok")) -> None:
    for name in names:
        w = getattr(want, name)
        w = w[k] if isinstance(w, torch.Tensor) else np.asarray(w)
        np.testing.assert_array_equal(getattr(got, name)[k].numpy(), np.asarray(w), err_msg=name)


class TestCompactS2D:
    @pytest.fixture(scope="class")
    def out_s2d(self, trained_tree):
        """The port's S2D head output for two 128^2 cell images (trained
        weights, the plate's gray input)."""
        net = P.UNetS2D(P.s2d_params(trained_tree[1], gray_input=True))
        return net(torch.from_numpy(_blobs(9, 128)[..., None]), out_s2d=True)

    @pytest.mark.parametrize("kwargs", [dict(flow_threshold=0.4, min_size=5),
                                        dict(flow_threshold=0.0, min_size=5,
                                             clear_border_labels=True)])
    def test_equals_planar_route_and_jax(self, out_s2d, kwargs):
        """The kwargs of the JAX package's own S2D equality test."""
        got = flows.compute_masks_sparse_compact_s2d(out_s2d, 8192, niter=200, max_cells=256,
                                                     **kwargs)
        planar = flows.compute_masks_sparse_compact(P._d2s(out_s2d, 3), 8192, niter=200,
                                                    max_cells=256, **kwargs)
        assert int(got.labels.max()) > 0
        for k in range(out_s2d.shape[0]):
            _compact_equal(got, k, planar)
            want = jflows.compute_masks_sparse_compact_s2d(jnp.asarray(out_s2d[k].numpy()), 8192,
                                                           niter=200, max_cells=256, **kwargs)
            _compact_equal(got, k, want)

    def test_core_equals_jax(self, out_s2d):
        """The listed pixels and `ok` of the S2D route, and the landings and
        predicted flows of the planar core on the permuted tensor, against
        the reference's S2D core."""
        got = flows.compute_masks_sparse_compact_s2d(out_s2d, 4096, flow_threshold=0.0,
                                                     max_cells=256)
        planar = P._d2s(out_s2d, 3)
        fl = planar[..., :2] * 0.2
        idx, valid, landing, _ = flows._follow_sparse_core(fl, planar[..., 2] > 0.0, 200, 4096)
        pred_c = torch.gather(fl.reshape(fl.shape[0], -1, 2), 1,
                              torch.where(valid, idx, 0)[..., None].expand(-1, -1, 2))
        # jitted, as the reference's entry points run it: XLA compiles its `/ 5.0`
        # into the product with 0.2 that the port computes (op by op it divides)
        core = jax.jit(jflows._follow_sparse_core_s2d, static_argnums=(1, 2, 3, 4))
        for k in range(out_s2d.shape[0]):
            w = core(jnp.asarray(out_s2d[k].numpy()), 0.0, 200, 4096, True)
            for g, want in zip((got.idx, got.valid, landing, got.ok, pred_c), w):
                np.testing.assert_array_equal(g[k].numpy(), np.asarray(want))

    @pytest.mark.parametrize("case, width, s2d_ok, planar_ok", [
        ("vertical pairs", 1024, True, False),
        ("horizontal pairs", 1024, False, True),
        ("vertical pairs, W/2 odd", 1026, True, False),
    ])
    def test_segment_budget(self, case, width, s2d_ok, planar_ok):
        """Above 2^20 pixels the reference compacts by segments and keeps at
        most cap // 4 of them: 8 row pixels on the planar route, 2 x 4 pixel
        blocks on the S2D route, and the latter only when W/2 is even. 1000
        pairs of pixels (2000 active, within the cap of 4096, whose segment
        budget is 1024): a vertical pair shares an S2D block but not a row
        segment, a horizontal pair (columns 8k + 3, 8k + 4) a row segment
        but not a block. Both packages give each route's `ok`, and the list
        where it holds."""
        h, cap = 1024, 4096
        act = np.zeros((h, width), bool)
        k = np.arange(1000)
        rows, cols = 2 * (k // 100) * 4, (k % 100) * 8 + 1
        if case.startswith("vertical"):
            act[rows, cols] = act[rows + 1, cols] = True
        else:
            act[rows, cols + 2] = act[rows, cols + 3] = True
        planar = np.zeros((1, h, width, 3), np.float32)
        planar[..., 2] = np.where(act, 4.0, -4.0)
        out = P._s2d(planar)  # (1, h/2, w/2, 12) in (c, a) order
        got = flows.compute_masks_sparse_compact_s2d(torch.from_numpy(out), cap, flow_threshold=0.0)
        want = jflows._follow_sparse_core_s2d(jnp.asarray(out[0]), 0.0, 200, cap, False)
        assert bool(got.ok[0]) == bool(want[3]) == s2d_ok
        fl = torch.zeros((1, h, width, 2))
        got_p = flows._follow_sparse_core(fl, torch.from_numpy(act[None]), 200, cap)
        want_p = jflows._follow_sparse_core(jnp.zeros((h, width, 2)), jnp.asarray(act), 200, cap)
        assert bool(got_p[3][0]) == bool(want_p[3]) == planar_ok
        assert int(act.sum()) == 2000
        np.testing.assert_array_equal(got.idx[0].numpy(), np.asarray(want[0]) if s2d_ok else
                                      got_p[0][0].numpy())
        np.testing.assert_array_equal(got_p[0][0].numpy(), got.idx[0].numpy())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_forward_against_the_cpu_and_its_launches(cuda_device):
    """The trained S2D forward on the card against its CPU plain version
    (bfloat16 gate), 13 conv and 2 moments launches per forward, the
    planar output the S2D head's permutation and the S2D compact tail equal
    to the CPU's bit for bit."""
    tree = P.s2d_params(tree_from_state_dict(load_weights()), gray_input=True)
    net_cpu = P.UNetS2D(tree)
    net = P.UNetS2D(tree).to(cuda_device)
    x = torch.from_numpy(_blobs(10, 256, 2)[..., None])
    conv_cuda.reset_launch_counts()
    gn_cuda.reset_launch_counts()
    out = net(x.to(cuda_device), out_s2d=True)
    assert conv_cuda.launch_counts["conv3x3_fused"] == 13
    assert gn_cuda.launch_counts["lane_moments"] == 2
    want = net_cpu(x, out_s2d=True)
    _assert_bf16_gate(out.cpu().numpy(), want.numpy())
    assert torch.equal(P._d2s(out, 3), net(x.to(cuda_device)))
    got = flows.compute_masks_sparse_compact_s2d(out, 16384, max_cells=256)
    cpu = flows.compute_masks_sparse_compact_s2d(out.cpu(), 16384, max_cells=256)
    for name, a, b in zip(cpu._fields, got, cpu):
        assert torch.equal(a.cpu(), b), name
