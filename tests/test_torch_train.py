"""The port's binary unet_resnet50 training against the JAX package, in float32 on the CPU.

unet_resnet50 with the diff head at 64^2, batch 2. The JAX variables'
shapes come from ``jax.eval_shape`` of the model's init (no init is run);
numpy draws the weights from a seed (He-scaled kernels, non-trivial BN
statistics) and ``state_dict_from_jax`` carries the same numbers to the
port with ``strict=True``. The JAX side is ``make_binary_train_step`` with
``make_train_optimizer(param_dtype=float32)`` (TreeAdam with f32 params);
the port's is its own ``make_binary_train_step`` with
``schedules.make_train_optimizer`` (``torch.optim.Adam``), f32, no autocast.
"""

import contextlib
import importlib.util
import json
import os
import shutil
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_tpu.utils import torch_interop
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch import val as port_val
from unet_embroidery_seg_torch.engine import checkpoint, steps
from unet_embroidery_seg_torch.models import build_model, load_weights_flexible
from unet_embroidery_seg_torch.models import blocks
from unet_embroidery_seg_torch.models.blocks import BatchNorm
from unet_embroidery_seg_torch.ops import losses as port_losses
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE, BATCH, STEPS = 64, 2, 10
LR = 1e-4
MASKS = [[1.0, 1.0]] * STEPS
MASKS[3] = [1.0, 0.0]  # one padded tail batch in every run


def _seeded(tree, seed: int) -> dict:
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, tuple(leaf.shape)
        if name == "kernel":
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _batches(seed: int):
    """STEPS seeded batches: images in [0, 1], masks of smooth blobs (~30% foreground)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    out = []
    for step in range(STEPS):
        images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        cx, cy, r = rng.uniform(0.2, 0.8, (3, BATCH, 1, 1))
        pngs = (((xx - cx) ** 2 + (yy - cy) ** 2) < (0.5 * r) ** 2).astype(np.int32)
        out.append((images, pngs, np.asarray(MASKS[step], np.float32)))
    return out


@pytest.fixture(scope="module")
def ref():
    jmodel = jax_build_model("unet_resnet50", num_classes=2, diff_head=True)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = _seeded(dict(shapes), seed=0)
    return {"jmodel": jmodel, "variables": variables, "batches": _batches(seed=1)}


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    """An empty working directory, emptied again at teardown.

    The tests below write full-size unet_resnet50 checkpoints (a train CLI
    run ~0.5 GB), and pytest keeps its last sessions' temporary directories.
    """
    monkeypatch.chdir(tmp_path)
    yield tmp_path
    for p in tmp_path.iterdir():
        if p.is_dir():
            shutil.rmtree(p)
        else:
            p.unlink()


def _port_model(variables, diff_head=True):
    model = build_model("unet_resnet50", 2, diff_head=diff_head, device="cpu")
    model.load_state_dict(state_dict_from_jax("unet_resnet50", variables), strict=True)
    return model


def _port_step(model, loss_name, pos_weight):
    opt = schedules.make_train_optimizer(model.parameters(), LR, momentum=0.9, weight_decay=1e-4)
    return opt, steps.make_binary_train_step(model, opt, loss_name, pos_weight, amp=False)


def _stock_conv3x3_bias_relu(x, weight, bias):
    return torch.relu(F.conv2d(x, weight, bias, padding=1))


def _stock_upsample2x(x, align_corners):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


_trajectories: dict = {}


def _trajectory(ref, loss_name):
    """Losses per step and (batch_stats + params) after steps 1 and STEPS, for three runs.

    "jax": the JAX package. "port": the port. "stock": the port's model with
    its two kernel Functions swapped for stock PyTorch ops (``F.conv2d`` +
    ReLU, ``F.interpolate``), the yardstick of how far PyTorch's own
    arithmetic lands from JAX's on this model.
    """
    if loss_name in _trajectories:
        return _trajectories[loss_name]
    pos_weight = 3.0 if loss_name == "bce" else None
    tx = jax_schedules.make_train_optimizer(LR, momentum=0.9, weight_decay=1e-4,
                                            param_dtype=jnp.float32)
    state = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]), tx)
    jstep = jax_steps.make_binary_train_step(ref["jmodel"], tx, loss_name, pos_weight)
    port, stock = _port_model(ref["variables"]), _port_model(ref["variables"])
    _, pstep = _port_step(port, loss_name, pos_weight)
    _, sstep = _port_step(stock, loss_name, pos_weight)
    out = {"loss": {"jax": [], "port": [], "stock": []}, "snapshots": {}}
    rng = jax.random.PRNGKey(1)
    for i, (images, pngs, sm) in enumerate(ref["batches"]):
        state, loss = jstep(state, jnp.asarray(images), jnp.asarray(pngs), jnp.asarray(sm), rng)
        out["loss"]["jax"].append(float(loss))
        out["loss"]["port"].append(float(pstep(images, pngs, sm)))
        with mock.patch.object(blocks, "conv3x3_bias_relu", _stock_conv3x3_bias_relu), \
                mock.patch.object(blocks, "upsample2x", _stock_upsample2x):
            out["loss"]["stock"].append(float(sstep(images, pngs, sm)))
        if i + 1 in (1, STEPS):
            out["snapshots"][i + 1] = {
                "jax": state_dict_from_jax("unet_resnet50", jax.tree.map(
                    np.asarray, {"params": state.opt_state.master,
                                 "batch_stats": state.batch_stats})),
                "port": {k: v.detach().clone() for k, v in port.state_dict().items()},
                "stock": {k: v.detach().clone() for k, v in stock.state_dict().items()},
            }
    _trajectories[loss_name] = out
    return out


def _param_spread(a: dict, b: dict) -> tuple[float, float, float]:
    """(mean, share above 0.1, max) of |a - b| / lr over every parameter element."""
    d = torch.cat([(a[k] - b[k]).abs().flatten() / LR for k in b
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))])
    return d.mean().item(), (d > 0.1).float().mean().item(), d.max().item()


@pytest.mark.parametrize("after", [1, STEPS])
@pytest.mark.parametrize("loss_name", ["bce", "lovasz_hinge"])
def test_train_steps_match_jax(ref, loss_name, after):
    # In train mode at 64^2, batch 2, this model magnifies f32 rounding: BN
    # normalises with the moments of as few as 8 values per channel (the 2x2
    # bottom map), and f32 differences in the encoder's forward grow ~8x per
    # stage (measured: feat5 2e-3 apart between PyTorch and JAX, the encoder's
    # gradients 2-5%). Adam then moves a weight whose gradient is only that
    # noise by +-lr either way. So the port is held to JAX as closely as stock
    # PyTorch ops are ("stock"), with a margin of 2x, plus f32 floors.
    t = _trajectory(ref, loss_name)
    loss = {k: np.asarray(v[:after]) for k, v in t["loss"].items()}
    # Step 1 sees identical weights: its loss agrees to f32 rounding.
    np.testing.assert_allclose(loss["port"][0], loss["jax"][0], rtol=1e-5)
    assert (np.abs(loss["port"] - loss["jax"])
            <= 2 * np.abs(loss["stock"] - loss["jax"]) + 1e-5 * np.abs(loss["jax"])).all(), loss
    snap = t["snapshots"][after]
    jax_sd, port_sd, stock_sd = snap["jax"], snap["port"], snap["stock"]
    assert set(jax_sd) == set(port_sd)
    for k, want in jax_sd.items():
        if k.endswith(("running_mean", "running_var")):
            # flax's biased running variance (torch's own would be 8/7 of it
            # at the bottom map); f32 floor: 1e-4 of the statistic's scale.
            ours = (port_sd[k] - want).abs().max().item()
            yardstick = (stock_sd[k] - want).abs().max().item()
            assert ours <= 2 * yardstick + 1e-4 * want.abs().max().item(), (k, ours, yardstick)
    # Master params in units of the learning rate (Adam moves each weight by
    # about lr per step whatever its gradient's size): at most 2 lr per step
    # apart, and no further from JAX than stock PyTorch's, with margin.
    mean, share, biggest = _param_spread(port_sd, jax_sd)
    s_mean, s_share, _ = _param_spread(stock_sd, jax_sd)
    assert biggest <= 2.0 * after + 0.01
    assert mean <= 2 * s_mean + 1e-3 and share <= 2 * s_share + 1e-4, (mean, share, s_mean, s_share)


def test_first_step_gradients_match_stock_pytorch(ref):
    # The port's two kernel Functions (here their plain versions) against
    # stock PyTorch ops on the same model and batch: the gradients agree to
    # f32 rounding as magnified by train-mode BN (1e-3 of each tensor's norm).
    images, pngs, sm = ref["batches"][0]
    grads = []
    for stock in (False, True):
        model = _port_model(ref["variables"])
        model.train()
        with contextlib.ExitStack() as stack:
            if stock:
                stack.enter_context(mock.patch.object(blocks, "conv3x3_bias_relu",
                                                      _stock_conv3x3_bias_relu))
                stack.enter_context(mock.patch.object(blocks, "upsample2x", _stock_upsample2x))
            out = model(torch.from_numpy(images).permute(0, 3, 1, 2))
            port_losses.binary_segmentation_loss(
                out, torch.from_numpy(pngs), "bce", pos_weight=3.0,
                sample_mask=torch.from_numpy(sm)).backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k, want in grads[1].items():
        assert (grads[0][k] - want).norm() <= 1e-3 * want.norm(), k


def test_loss_falls_on_a_fixed_batch(ref):
    model = _port_model(ref["variables"])
    opt, step = _port_step(model, "lovasz_hinge", None)
    schedules.set_learning_rate(opt, 1e-3)
    images, pngs, _ = ref["batches"][0]
    sm = np.ones(BATCH, np.float32)
    losses = [float(step(images, pngs, sm)) for _ in range(5)]
    assert losses[-1] < losses[0], losses


def test_every_parameter_gets_a_gradient(ref):
    model = _port_model(ref["variables"])
    _, step = _port_step(model, "bce", 3.0)
    step(*ref["batches"][0])
    for name, p in model.named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert torch.count_nonzero(p.grad) > 0, name


def test_eval_step_counts_match_jax(ref):
    images, pngs, _ = ref["batches"][2]
    sm = np.asarray([1.0, 0.0], np.float32)
    jeval = jax_steps.make_binary_eval_step(ref["jmodel"], "bce", 3.0)
    jstate = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]),
                               jax_schedules.make_optimizer(LR))
    jloss, jcounts = jeval(jstate, jnp.asarray(images), jnp.asarray(pngs), jnp.asarray(sm))
    model = _port_model(ref["variables"])
    loss, counts = steps.make_binary_eval_step(model, "bce", 3.0, amp=False)(images, pngs, sm)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    # diff > 0 on both sides: only a pixel whose f32 logit difference is
    # within noise of 0 could land on the other side; at these weights none is.
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.sum().item() == SIZE * SIZE  # one valid image of the two


def test_resume_equals_an_uninterrupted_run(ref, workdir):
    def run(n_steps, start=None):
        model = _port_model(ref["variables"])
        opt, step = _port_step(model, "lovasz_hinge", None)
        first = 0
        if start is not None:
            first, extra = checkpoint.restore_state(start, model, opt)
            assert extra == {"epoch": 1}
        for images, pngs, sm in ref["batches"][first:n_steps]:
            step(images, pngs, sm)
        return model, opt

    straight, _ = run(4)
    half, opt = run(2)
    path = str(workdir / "resume.pth")
    checkpoint.save_state(path, half, opt, step=2, extra={"epoch": 1})
    resumed, _ = run(4, start=path)
    for k, v in straight.state_dict().items():
        torch.testing.assert_close(resumed.state_dict()[k], v, rtol=0, atol=0, msg=k)


def test_best_pth_round_trip_into_jax_forward(ref, workdir):
    model = _port_model(ref["variables"])
    _, step = _port_step(model, "bce", 3.0)
    step(*ref["batches"][0])  # trained weights and running statistics
    path = str(workdir / "best.pth")
    checkpoint.save_weights(path, model)
    sd = {k: v.numpy() for k, v in torch.load(path, weights_only=True).items()}
    jmodel = jax_build_model("unet_resnet50", num_classes=2)
    variables = torch_interop.import_state_dict("unet_resnet50", ref["variables"], sd)
    images = ref["batches"][1][0]
    want = np.asarray(jax_steps.make_predict_fn(jmodel)(variables, jnp.asarray(images)))
    plain = _port_model(ref["variables"], diff_head=False)
    checkpoint.load_weights(path, plain)
    got = steps.make_predict_fn(plain, amp=False)(images).numpy()
    # f32 both sides, ~70 layers: 1e-4 of the logit scale (test_torch_model).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_diff_head_is_the_two_class_difference(ref):
    diff, plain = _port_model(ref["variables"]), _port_model(ref["variables"], diff_head=False)
    assert diff.state_dict().keys() == plain.state_dict().keys()
    images = ref["batches"][0][0]
    with torch.inference_mode():
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        got, two = diff.eval()(x), plain.eval()(x)
    assert got.shape == (BATCH, SIZE, SIZE)
    torch.testing.assert_close(got, two[:, 1] - two[:, 0], rtol=0, atol=1e-5)


def test_batchnorm_running_variance_is_flax_biased():
    # At a 2x2 map with batch 2 (n = 8 per channel) torch's own update would
    # be 8/7 of flax's: the port's BatchNorm must give flax's.
    rng = np.random.RandomState(3)
    x = rng.randn(2, 2, 2, 5).astype(np.float32)
    fbn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    fvars = fbn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y_j, upd = fbn.apply(fvars, jnp.asarray(x), mutable=["batch_stats"])
    bn = BatchNorm(5).train()
    y = bn(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               rtol=0, atol=1e-5)
    for ours, theirs in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(upd["batch_stats"][theirs]),
                                   rtol=1e-6, atol=1e-7)


def test_load_weights_flexible_loads_only_matching_shapes(ref):
    model = _port_model(ref["variables"])
    sd = state_dict_from_jax("unet_resnet50", ref["variables"])
    sd["final.weight"] = torch.zeros(5, 64, 1, 1)  # another head size: skipped
    sd["not.a.key"] = torch.zeros(1)
    fresh = build_model("unet_resnet50", 2, device="cpu", generator=torch.Generator().manual_seed(9))
    before = fresh.state_dict()["final.weight"].clone()
    loaded, skipped = load_weights_flexible(fresh, sd)
    assert (loaded, skipped) == (len(sd) - 2, 2)
    torch.testing.assert_close(fresh.state_dict()["final.weight"], before, rtol=0, atol=0)
    torch.testing.assert_close(fresh.state_dict()["up_conv.3.weight"],
                               model.state_dict()["up_conv.3.weight"], rtol=0, atol=0)


# --- CLIs ---------------------------------------------------------------------

CLI_ARGS = ["--data-path", "synthetic:4", "--input-size", "64", "--batch-size", "2",
            "--max-train-batches", "2", "--max-val-batches", "1", "--max-test-batches", "2",
            "--device", "cpu", "--no-amp", "--ckpt-every", "1"]


def _jax_cli():
    """The repo-root (JAX) train CLI, loaded under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "jax_train_cli", Path(__file__).resolve().parent.parent / "train.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _files(exp: str) -> set[str]:
    """exp's files, relative, with the JAX checkpoints' .msgpack named as the port's .pth."""
    return {os.path.relpath(os.path.join(d, f), exp).replace(".msgpack", ".pth")
            for d, _, fs in os.walk(exp) for f in fs}


def test_train_cli_writes_the_artifacts_and_val_reads_them(workdir, capsys):
    from PIL import Image

    exp = port_train.train(port_train.parse_args(CLI_ARGS + ["--epochs", "2", "--loss", "bce"]))
    assert os.path.relpath(exp, workdir) == os.path.join("run", "train", "exp")
    for name in ("config.json", "summary.json", "test_metrics.json",
                 "val_metrics_history.json", "val_metrics_history.csv",
                 "weights/best.pth", "weights/last.pth", "weights/resume.pth",
                 "weights/loss_curve.png", "weights/metrics_curve.png", "vis/indices.json"):
        assert os.path.exists(os.path.join(exp, name)), name
    # The JAX CLI's file set on the same data and flags (a quicker model: the
    # files do not depend on it): curves, vis/indices.json (equal) and one
    # grid per test sample whose image and ground-truth panels are equal.
    jax_cli = _jax_cli()
    jexp = jax_cli.train(jax_cli.parse_args(
        CLI_ARGS + ["--epochs", "1", "--loss", "bce", "--model", "unet_plain", "--mesh-data", "1"]))
    assert _files(exp) == _files(jexp)
    indices = json.load(open(os.path.join(exp, "vis", "indices.json")))
    assert indices == json.load(open(os.path.join(jexp, "vis", "indices.json")))
    assert sorted(indices) == [0, 1, 2, 3]
    grids = sorted(n for n in os.listdir(os.path.join(exp, "vis")) if n.endswith("_grid.png"))
    assert len(grids) == 4
    for name in grids:
        ours = np.asarray(Image.open(os.path.join(exp, "vis", name)))
        theirs = np.asarray(Image.open(os.path.join(jexp, "vis", name)))
        assert ours.shape == theirs.shape == (2 * 64, 2 * 64, 3)
        np.testing.assert_array_equal(ours[:64], theirs[:64])  # image | ground truth
    config = json.load(open(os.path.join(exp, "config.json")))
    assert config["resolved_pos_weight"] > 0 and config["device"] == "cpu"
    summary = json.load(open(os.path.join(exp, "summary.json")))
    test_metrics = json.load(open(os.path.join(exp, "test_metrics.json")))
    assert summary["test_metrics"] == test_metrics
    assert set(test_metrics) == {"Dice", "IoU", "Precision", "Recall", "Accuracy", "Loss"}
    assert len(json.load(open(os.path.join(exp, "val_metrics_history.json")))) == 2
    capsys.readouterr()
    # The val CLI: batch size 1 over the same 4 test images (the train CLI's
    # test evaluation saw them in 2 batches of 2), the two-channel head.
    metrics = port_val.val(port_val.parse_args([
        "--data-path", "synthetic:4", "--input-size", "64", "--device", "cpu", "--no-amp",
        "--loss", "bce", "--weights", os.path.join(exp, "weights", "best.pth")]))
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert printed == "\t".join(f"{test_metrics[k]:.4f}" for k in
                                ("Dice", "IoU", "Precision", "Recall", "Accuracy"))
    for k in ("Dice", "IoU", "Precision", "Recall", "Accuracy"):
        assert metrics[k] == pytest.approx(test_metrics[k], abs=1e-6), k


def test_train_cli_resume_continues_the_run(workdir):
    full = port_train.train(port_train.parse_args(CLI_ARGS + ["--epochs", "2"]))
    first = port_train.train(port_train.parse_args(CLI_ARGS + ["--epochs", "1"]))
    resumed = port_train.train(port_train.parse_args(
        CLI_ARGS + ["--epochs", "2", "--resume", os.path.join(first, "weights", "resume.pth")]))
    a = torch.load(os.path.join(full, "weights", "last.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "weights", "last.pth"), weights_only=True)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    ha = json.load(open(os.path.join(full, "val_metrics_history.json")))
    hb = json.load(open(os.path.join(resumed, "val_metrics_history.json")))
    assert ha == hb


@pytest.mark.parametrize("flag", [["--profile", "--mesh-space", "2", "--model", "unet_plain"],
                                  ["--mesh-space", "2", "--model", "unet_plain"]])
def test_train_cli_raises_on_what_is_not_ported(flag):
    # Every family takes --mesh-space; what the CLI still refuses is an input
    # whose bands would not split evenly (unet_plain: a multiple of 16 x S).
    with pytest.raises(ValueError, match="multiple of 16 x --mesh-space 2 = 32 for unet_plain"):
        port_train.train(port_train.parse_args(CLI_ARGS + flag + ["--input-size", "48"]))
