"""PyTorch port: the U-Net trainer (models/train.py) and its differentiable
forward (`UNet.training_forward`) against the JAX package's trainer.

The JAX side is built from the JAX module's own functions as its `train`
builds them: `make_batch`, `_flow_targets`, `jax.value_and_grad(loss_fn)`
and `optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.05))`, with
`apply_unet` given the test's small `UNetConfig` (its `loss_fn` otherwise
runs the default bfloat16 config). Both sides start from the same weights,
carried across by `state_dict_from_tree(flatten_tree(...))`, and see the
same numpy batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from arcadia_microscopy_tools_tpu.models import train as jtrain
from arcadia_microscopy_tools_tpu.models.unet import UNetConfig as JaxUNetConfig
from arcadia_microscopy_tools_tpu.models.unet import _group_norm, _max_pool, init_unet
from arcadia_microscopy_tools_tpu_torch import SegmentationModel
from arcadia_microscopy_tools_tpu_torch.models import flows, train
from arcadia_microscopy_tools_tpu_torch.models import unet as punet
from arcadia_microscopy_tools_tpu_torch.models.unet import UNet, UNetConfig
from arcadia_microscopy_tools_tpu_torch.models.weights import (
    flatten_tree,
    load_weights,
    state_dict_from_tree,
    tree_from_state_dict,
)

torch.set_num_threads(1)

BASE = (8, 16)  # two levels: small enough for the CPU, every layer kind present
STEPS, LR = 3, 3e-3
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(seed: int, n: int):
    """n (images, labels, flow targets, fg) batches of 2 64^2 images, the
    targets from the JAX `_flow_targets`."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images, labels = jtrain.make_batch(rng, 2, 64)
        flow_t, fg_t = jtrain._flow_targets(jnp.asarray(labels))
        out.append((images, labels, np.asarray(flow_t), np.asarray(fg_t, np.float32)))
    return out


@pytest.fixture(scope="module")
def batches():
    return _batches(1, STEPS)


@pytest.fixture(scope="module")
def runs(batches):
    """{dtype: both trainers' run in that compute dtype}."""
    return {dtype: _run(dtype, batches) for dtype in DTYPES}


def _run(dtype, batches):
    """Both trainers for STEPS steps from the same weights on the same
    batches: the JAX losses, gradients of step 0 and final parameters, and
    the port's."""
    jdt, tdt = DTYPES[dtype]
    params = init_unet(jax.random.PRNGKey(0), JaxUNetConfig(base_channels=BASE))
    net = UNet(UNetConfig(base_channels=BASE, compute_dtype=tdt))
    net.load_state_dict(state_dict_from_tree(flatten_tree(_np(params))))

    config = JaxUNetConfig(base_channels=BASE, compute_dtype=jdt)
    apply_unet = jtrain.apply_unet
    tx = optax.adam(optax.cosine_decay_schedule(LR, STEPS, alpha=0.05))

    @jax.jit
    def step_fn(params, opt_state, images, flow_t, fg_t):
        (loss, aux), grads = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
            params, images, flow_t, fg_t
        )
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss, aux, grads

    optimizer = train.make_optimizer(net)
    schedule = train.cosine_decay_schedule(LR, STEPS, alpha=0.05)
    opt_state = tx.init(params)
    jax_losses, port_losses = [], []
    jtrain.apply_unet = lambda p, x: apply_unet(p, x, config)
    try:
        for step, (images, _, flow_t, fg_t) in enumerate(batches):
            params, opt_state, loss, aux, grads = step_fn(params, opt_state, images, flow_t, fg_t)
            jax_losses.append([float(loss), *map(float, aux)])
            if step == 0:
                jax_grads = state_dict_from_tree(flatten_tree(_np(grads)))
                t_loss, (t_mse, t_bce) = train.loss_fn(
                    net, *(torch.from_numpy(np.array(a)) for a in (images, flow_t, fg_t))
                )
                t_loss.backward()
                port_grads = {k: p.grad.clone() for k, p in net.named_parameters()}
            got = train.train_step(net, optimizer, schedule(step),
                                   *map(torch.from_numpy, (images, flow_t, fg_t)))
            port_losses.append([float(v) for v in got])
    finally:
        jtrain.apply_unet = apply_unet
    return dict(
        init_params=state_dict_from_tree(flatten_tree(_np(
            init_unet(jax.random.PRNGKey(0), JaxUNetConfig(base_channels=BASE))))),
        jax_losses=np.array(jax_losses), port_losses=np.array(port_losses),
        jax_grads=jax_grads, port_grads=port_grads,
        first_loss=[float(t_loss.detach()), float(t_mse.detach()), float(t_bce.detach())],
        jax_params=state_dict_from_tree(flatten_tree(_np(params))),
        port_params={k: p.detach() for k, p in net.named_parameters()},
    )


# -- batch and targets --------------------------------------------------------------


@pytest.mark.parametrize("seed, n, size", [(0, 2, 64), (7, 3, 48)])
def test_make_batch_is_bit_exact(seed, n, size):
    rng_j, rng_t = np.random.default_rng(seed), np.random.default_rng(seed)
    want = jtrain.make_batch(rng_j, n, size)
    got = train.make_batch(rng_t, n, size)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert rng_t.bit_generator.state == rng_j.bit_generator.state


def test_flow_targets_agree(batches):
    """fg bit for bit; the flows within the tolerance of test_torch_flows.py's
    `_assert_flows_close`: 1e-5 away from a cell's centre, 0.02 next to it
    (an ulp of log1p turns the unit vector there)."""
    labels = np.concatenate([b[1] for b in batches])
    flow_t, fg = train._flow_targets(torch.from_numpy(labels))
    assert flow_t.dtype == torch.float32 and fg.dtype == torch.bool
    centres = flows._centre_sources(torch.from_numpy(labels), train.MAX_CELLS_TRAIN)
    near = torch.nn.functional.max_pool2d(centres[:, None], 3, 1, 1)[:, 0].bool().numpy()
    want_flow, want_fg = jtrain._flow_targets(jnp.asarray(labels))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(want_fg))
    d = np.abs(flow_t.numpy() - np.asarray(want_flow)).max(-1)
    assert d[~near].max() <= 1e-5
    assert d.max() <= 0.02


# -- the training forward's parts -----------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_group_norm_matches_jax(dtype):
    """Both variance forms, on channels with a mean far above their spread
    (where the float32 path's two-pass form matters): float32 within 1e-5,
    bfloat16 within one bf16 step of the value plus 0.01."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(2, 8, 12, 16)) + 50.0 * rng.random(16)).astype(np.float32)
    scale, bias = rng.normal(size=16).astype(np.float32), rng.normal(size=16).astype(np.float32)
    want = np.asarray(_group_norm(jnp.asarray(x).astype(jdt), scale, bias, 8), np.float32)
    got = punet._group_norm_train(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                                  torch.from_numpy(bias), 8)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else np.abs(want) / 128 + 1e-2
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_max_pool_gradient_breaks_ties_as_jax(dtype):
    """Equal values in a window: the gradient goes to the first in row-major
    order in both packages."""
    jdt, tdt = DTYPES[dtype]
    x = np.array([[1, 1, 2, 2], [1, 1, 2, 3], [5, 0, 0, 0], [5, 5, 0, 7]], np.float32)
    x = np.stack([x, x[::-1, ::-1], np.full_like(x, 2.0)], -1)[None]
    w = np.arange(1.0, 13.0, dtype=np.float32).reshape(1, 2, 2, 3)
    want = jax.grad(lambda a: (_max_pool(a.astype(jdt)).astype(jnp.float32) * w).sum())(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    (punet._max_pool2_first(t.to(tdt)).float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_schedule_matches_optax():
    want = optax.cosine_decay_schedule(3e-4, 10, alpha=0.05)
    got = train.cosine_decay_schedule(3e-4, 10, alpha=0.05)
    for count in (0, 1, 5, 9, 10, 14):
        assert got(count) == pytest.approx(float(want(count)), rel=1e-6)
    with pytest.raises(ValueError, match="positive decay_steps"):
        train.cosine_decay_schedule(3e-4, 0)


# -- loss, gradients and Adam steps -----------------------------------------------------


def test_loss_and_gradients_match_jax_float32(runs):
    """The loss and its parts within 1e-5 relative, every gradient leaf
    within 1e-4 of its largest magnitude."""
    run = runs["float32"]
    np.testing.assert_allclose(run["first_loss"], run["jax_losses"][0], rtol=1e-5)
    assert run["port_grads"].keys() == run["jax_grads"].keys()
    for name, want in run["jax_grads"].items():
        got = run["port_grads"][name]
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), name


def test_loss_and_gradients_match_jax_bfloat16(runs):
    """bfloat16 activations round each package's gradients apart (XLA on the
    CPU sums the broadcasts' bfloat16 cotangents in bfloat16, PyTorch in
    float32). The loss and its parts within 1e-3 relative; each gradient
    leaf at cosine similarity >= 0.99 with JAX's, and no further (L2) from
    the float32 gradient than 1.5 x JAX's own bfloat16 gradient is, plus
    1e-3 of its norm."""
    run, exact = runs["bfloat16"], runs["float32"]["jax_grads"]
    np.testing.assert_allclose(run["first_loss"], run["jax_losses"][0], rtol=1e-3)
    assert run["port_grads"].keys() == run["jax_grads"].keys()
    for name, want in run["jax_grads"].items():
        got, ref = run["port_grads"][name], exact[name]
        cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
        assert float(cos) >= 0.99, name
        limit = 1.5 * float((want - ref).norm()) + 1e-3 * float(ref.norm())
        assert float((got - ref).norm()) <= limit, name


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_three_adam_steps_match_optax(runs, dtype):
    """Each step's loss and parts: float32 within 1e-5 relative, bfloat16
    within 5e-3 relative. float32 parameters after three steps within 1e-4
    (1/90 of the most Adam can move a parameter in three steps at step size
    3e-3). bfloat16 rounds the two packages' gradients apart, so each
    bfloat16 leaf is held by its L2 distance from JAX's float32 parameters:
    within 1.5 x JAX's own bfloat16 leaf's distance from them, plus 5% of
    the distance the three float32 steps moved the leaf. Readings at this
    seed: the port's distance is 0.03-1.4 x JAX's on 24 of the 25 leaves and
    6.2 x on style_proj.0, where JAX's is 0.5% of the move (the port's 3%);
    a sign error moves a leaf twice the move away, and a constant step
    size about 45% of it."""
    run = runs[dtype]
    f32 = dtype == "float32"
    np.testing.assert_allclose(run["port_losses"], run["jax_losses"], rtol=1e-5 if f32 else 5e-3)
    assert run["port_losses"][-1][0] < run["port_losses"][0][0]
    if f32:
        for name, want in run["jax_params"].items():
            assert float((run["port_params"][name] - want).abs().max()) <= 1e-4, name
        return
    exact, init = runs["float32"]["jax_params"], run["init_params"]
    for name, want in run["jax_params"].items():
        ref = exact[name]
        limit = 1.5 * float((want - ref).norm()) + 0.05 * float((ref - init[name]).norm())
        assert float((run["port_params"][name] - ref).norm()) <= limit, name


def test_training_forward_reads_the_inference_parameters():
    """The float32 training forward and the float32 inference forward read
    the same parameters and agree (the inference GroupNorm is one-pass)."""
    net = UNet(UNetConfig(base_channels=BASE, compute_dtype=torch.float32),
               generator=torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(2).random((1, 32, 32, 3), np.float32))
    got = net.training_forward(x)
    assert got.dtype == torch.float32 and got.shape == (1, 32, 32, 3) and got.requires_grad
    torch.testing.assert_close(got.detach(), net(x), rtol=1e-4, atol=1e-4)


# -- the entry point ---------------------------------------------------------------------


def test_train_writes_weights_that_load(tmp_path, capsys):
    """Two full-width steps on the CPU: finite losses, the `.npz` holds the
    JAX tree's leaves in its layouts and reads back equal, and
    `SegmentationModel` segments with it."""
    out = tmp_path / "weights.npz"
    result = train.train(steps=2, batch=2, size=64, seed=3, out=out, log_every=1, device="cpu")
    assert len(result.history) == 2
    for record in result.history:
        assert record.keys() == {"loss", "flow_mse", "bce"}
        assert all(np.isfinite(v) for v in record.values())
    assert result.history[0]["loss"] == pytest.approx(
        result.history[0]["flow_mse"] + 2 * result.history[0]["bce"], rel=1e-5)
    assert "step     1 loss" in capsys.readouterr().out

    shapes = {k: v.shape for k, v in flatten_tree(_np(init_unet(jax.random.PRNGKey(0)))).items()}
    with np.load(out) as data:
        assert {k: data[k].shape for k in data.files} == shapes
    loaded = load_weights(out)
    state = result.network.state_dict()
    assert loaded.keys() == state.keys()
    for name, value in state.items():
        torch.testing.assert_close(loaded[name], value, rtol=0, atol=0)

    model = SegmentationModel(checkpoint_path=out, device="cpu")
    image = np.random.default_rng(0).random((64, 64)) * 1000
    labels = model.segment(image)
    assert labels.shape == (64, 64)


def test_tree_round_trip_is_exact():
    flat = flatten_tree(_np(init_unet(jax.random.PRNGKey(1))))
    back = tree_from_state_dict(state_dict_from_tree(flat))
    assert back.keys() == flat.keys()
    for name, leaf in flat.items():
        assert back[name].shape == leaf.shape, name
        np.testing.assert_array_equal(back[name], leaf)


def test_main_runs_one_step(tmp_path):
    out = tmp_path / "cli"  # no suffix: written as named
    train.main(["--steps", "1", "--batch", "1", "--size", "64", "--device", "cpu",
                "--out", str(out)])
    assert load_weights(out).keys() == state_dict_from_tree(
        flatten_tree(_np(init_unet(jax.random.PRNGKey(0))))).keys()


def test_default_device_is_the_card_or_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.train(steps=1, batch=1, size=64)
