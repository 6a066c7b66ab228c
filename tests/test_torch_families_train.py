"""Binary training of unet_plain, attention_unet and dualdense_unet: the port against JAX.

Narrow models (``base_channels`` 8, ``growth_rate`` 8) with the diff head
at 44^2, batch 2, in float32 on the CPU, the weights seeded by numpy
(``test_torch_families.seeded_variables``). The JAX side is
``make_binary_train_step`` with ``make_train_optimizer(param_dtype=float32)``;
the port's is its own ``make_binary_train_step`` with
``schedules.make_train_optimizer``. Then ``best.pth`` into the JAX forward,
and a train -> val -> predict smoke of each full-width family through the
port's CLIs.
"""

import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import jax
import jax.numpy as jnp

from test_torch_families import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    FAMILIES,
    SIZE,
    one_torch_thread,
    port_model,
    seeded_variables,
)
from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_tpu.utils import torch_interop
from unet_embroidery_seg_torch import predict as port_predict
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch import val as port_val
from unet_embroidery_seg_torch.engine import checkpoint, steps
from unet_embroidery_seg_torch.models import blocks
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

BATCH, STEPS, LR = 2, 3, 1e-4


def _batches(seed: int):
    """STEPS seeded batches: images in [0, 1], masks of discs (~30% foreground)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    out = []
    for _ in range(STEPS):
        images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        cx, cy, r = rng.uniform(0.2, 0.8, (3, BATCH, 1, 1))
        pngs = (((xx - cx) ** 2 + (yy - cy) ** 2) < (0.5 * r) ** 2).astype(np.int32)
        out.append((images, pngs, np.ones(BATCH, np.float32)))
    return out


def _port_step(model):
    opt = schedules.make_train_optimizer(model.parameters(), LR, momentum=0.9, weight_decay=1e-4)
    return steps.make_binary_train_step(model, opt, "bce", 3.0, amp=False)


def _stock_conv3x3_same(x, weight):
    return F.conv2d(x, weight, padding=1)


def _stock_upsample2x(x, align_corners):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


@pytest.fixture(scope="module", params=list(FAMILIES))
def trajectory(request):
    """BCE losses per step and (batch_stats + params) after steps 1 and STEPS, for three runs.

    "jax": the JAX package. "port": the port. "stock": the port's model with
    its two kernel Functions swapped for stock PyTorch ops (``F.conv2d``,
    ``F.interpolate``), the yardstick of how far PyTorch's own arithmetic
    lands from JAX's on this model.
    """
    name = request.param
    jcls, _, kwargs = FAMILIES[name]
    jmodel = jcls(num_classes=2, diff_head=True, **kwargs)
    variables = seeded_variables(jmodel, seed=0)
    tx = jax_schedules.make_train_optimizer(LR, momentum=0.9, weight_decay=1e-4,
                                            param_dtype=jnp.float32)
    state = TrainState.create(jax.tree.map(jnp.asarray, variables), tx)
    jstep = jax_steps.make_binary_train_step(jmodel, tx, "bce", 3.0)
    port = port_model(name, variables, diff_head=True)
    stock = port_model(name, variables, diff_head=True)
    pstep, sstep = _port_step(port), _port_step(stock)
    out = {"name": name, "variables": variables, "port": port,
           "loss": {"jax": [], "port": [], "stock": []}, "snapshots": {}}
    rng = jax.random.PRNGKey(1)
    for i, (images, pngs, sm) in enumerate(_batches(seed=1)):
        state, loss = jstep(state, jnp.asarray(images), jnp.asarray(pngs), jnp.asarray(sm), rng)
        out["loss"]["jax"].append(float(loss))
        out["loss"]["port"].append(float(pstep(images, pngs, sm)))
        with mock.patch.object(blocks, "conv3x3_same", _stock_conv3x3_same), \
                mock.patch.object(blocks, "upsample2x", _stock_upsample2x):
            out["loss"]["stock"].append(float(sstep(images, pngs, sm)))
        if i + 1 in (1, STEPS):
            out["snapshots"][i + 1] = {
                "jax": state_dict_from_jax(name, jax.tree.map(
                    np.asarray, {"params": state.opt_state.master,
                                 "batch_stats": state.batch_stats})),
                "port": {k: v.detach().clone() for k, v in port.state_dict().items()},
                "stock": {k: v.detach().clone() for k, v in stock.state_dict().items()},
            }
    return out


def _param_spread(a: dict, b: dict) -> tuple[float, float, float]:
    """(mean, share above 0.1, max) of |a - b| / lr over every parameter element."""
    d = torch.cat([(a[k] - b[k]).abs().flatten() / LR for k in b
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))])
    return d.mean().item(), (d > 0.1).float().mean().item(), d.max().item()


@pytest.mark.parametrize("after", [1, STEPS])
def test_train_steps_match_jax(trajectory, after):
    # As in test_torch_train.py: train-mode BN at the 2x2 bottom map with
    # batch 2 (8 values per channel) magnifies f32 rounding from stage to
    # stage, and Adam moves a weight whose gradient is that noise by +-lr.
    # So the port is held to JAX as closely as stock PyTorch ops are
    # ("stock"), with a margin of 2x, plus f32 floors.
    loss = {k: np.asarray(v[:after]) for k, v in trajectory["loss"].items()}
    # Step 1 sees identical weights: its loss agrees to f32 rounding.
    np.testing.assert_allclose(loss["port"][0], loss["jax"][0], rtol=1e-5)
    assert (np.abs(loss["port"] - loss["jax"])
            <= 2 * np.abs(loss["stock"] - loss["jax"]) + 1e-5 * np.abs(loss["jax"])).all(), loss
    snap = trajectory["snapshots"][after]
    jax_sd, port_sd, stock_sd = snap["jax"], snap["port"], snap["stock"]
    assert set(jax_sd) == set(port_sd)
    for k, want in jax_sd.items():
        if k.endswith(("running_mean", "running_var")):
            # flax's biased running variance; f32 floor: 1e-4 of the statistic's scale.
            ours = (port_sd[k] - want).abs().max().item()
            yardstick = (stock_sd[k] - want).abs().max().item()
            assert ours <= 2 * yardstick + 1e-4 * want.abs().max().item(), (k, ours, yardstick)
    # Master params in units of the learning rate: at most 2 lr per step
    # apart, and no further from JAX than stock PyTorch's, with margin.
    mean, share, biggest = _param_spread(port_sd, jax_sd)
    s_mean, s_share, _ = _param_spread(stock_sd, jax_sd)
    assert biggest <= 2.0 * after + 0.01
    assert mean <= 2 * s_mean + 1e-3 and share <= 2 * s_share + 1e-4, (mean, share, s_mean, s_share)


def test_every_parameter_gets_a_gradient(trajectory):
    params = dict(trajectory["port"].named_parameters())
    for name, p in params.items():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        if name.endswith("attn.psi.0.bias"):
            # A conv bias right before train-mode BN: BN removes any constant
            # shift, so its gradient is 0 but for rounding.
            scale = params[name.replace(".bias", ".weight")].grad.norm()
            assert p.grad.abs().max() <= 1e-5 * scale, name
        else:
            assert torch.count_nonzero(p.grad) > 0, name


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """An empty working directory, emptied again at teardown (full-width checkpoints)."""
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    for p in tmp_path.iterdir():
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()


def test_best_pth_round_trip_into_jax_forward(trajectory, workdir):
    # The port's trained weights and running statistics, through a .pth and
    # the JAX package's importer, give the JAX forward the port's logits.
    name = trajectory["name"]
    path = str(workdir / "best.pth")
    checkpoint.save_weights(path, trajectory["port"])
    sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    jcls, _, kwargs = FAMILIES[name]
    jmodel = jcls(num_classes=2, **kwargs)
    variables = torch_interop.import_state_dict(name, trajectory["variables"], sd)
    images = _batches(seed=2)[0][0]
    want = np.asarray(jax_steps.make_predict_fn(jmodel)(variables, jnp.asarray(images)))
    plain = port_model(name, trajectory["variables"])
    checkpoint.load_weights(path, plain)
    got = steps.make_predict_fn(plain, amp=False)(images).numpy()
    # f32 both sides: 1e-4 of the logit scale (test_torch_families).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


CLI_ARGS = ["--data-path", "synthetic:4", "--input-size", "32", "--batch-size", "2",
            "--max-train-batches", "1", "--max-val-batches", "1", "--max-test-batches", "1",
            "--device", "cpu", "--no-amp", "--loss", "bce", "--pos-weight", "3"]


def _images(folder):
    folder.mkdir()
    rng = np.random.RandomState(0)
    for i, (w, h) in enumerate([(40, 30), (25, 50)]):
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(folder / f"s{i}.png")
    return folder


@pytest.mark.parametrize("model", list(FAMILIES))
def test_train_val_predict_clis(model, workdir):
    exp = port_train.train(port_train.parse_args(
        CLI_ARGS + ["--epochs", "1", "--ckpt-every", "0", "--model", model]))
    best = os.path.join(exp, "weights", "best.pth")
    assert os.path.exists(best) and os.path.exists(os.path.join(exp, "test_metrics.json"))
    metrics = port_val.val(port_val.parse_args([
        "--data-path", "synthetic:4", "--input-size", "32", "--device", "cpu", "--no-amp",
        "--loss", "bce", "--model", model, "--weights", best]))
    assert set(metrics) == {"Dice", "IoU", "Precision", "Recall", "Accuracy", "Loss"}
    out = port_predict.predict(port_predict.parse_args([
        "--data_path", str(_images(workdir / "images")), "--weights", best, "--model", model,
        "--input-size", "32", "--no-amp", "--batch", "2", "--device", "cpu"]))
    assert sorted(os.listdir(out)) == ["s0_mask.png", "s1_mask.png"]


def test_train_cli_resume_and_weights_for_a_family(workdir, capsys):
    # Both are family-agnostic (a state_dict, an optimizer state): once, for
    # unet_plain. --resume continues the run; --weights loads every key.
    args = CLI_ARGS + ["--model", "unet_plain", "--ckpt-every", "1"]
    exp = port_train.train(port_train.parse_args(args + ["--epochs", "1"]))
    weights = os.path.join(exp, "weights")
    resumed = port_train.train(port_train.parse_args(
        args + ["--epochs", "2", "--resume", os.path.join(weights, "resume.pth")]))
    with open(os.path.join(resumed, "val_metrics_history.json")) as f:
        assert len(json.load(f)) == 2
    capsys.readouterr()
    port_train.train(port_train.parse_args(
        args + ["--epochs", "1", "--ckpt-every", "0", "--weights",
                os.path.join(weights, "best.pth")]))
    assert "Skipped: 0 keys" in capsys.readouterr().out
