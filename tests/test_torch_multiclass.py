"""The multiclass task: the port's losses, metrics, steps and CLIs against the JAX package.

float32 on the CPU. Losses and metrics on seeded numpy inputs with ignore
pixels (the ignore class is ``num_classes``) and padded samples; train steps
1 and 3 of a narrow unet_plain (``base_channels`` 8, 44^2, batch 2) with K =
5 output classes (``--num-classes 4`` + 1), CE + Dice and Focal + Dice, held
to JAX as closely as stock PyTorch ops are; the eval steps; and train -> val
through the CLIs for unet_resnet50 and unet_plain.
"""

import json
import os
import shutil
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from test_torch_families import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    FAMILIES,
    SIZE,
    one_torch_thread,
    seeded_variables,
)
from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.ops import losses as jax_losses
from unet_embroidery_seg_tpu.ops import metrics as jax_metrics
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch import val as port_val
from unet_embroidery_seg_torch.engine import steps
from unet_embroidery_seg_torch.models import blocks
from unet_embroidery_seg_torch.models.blocks import init_weights
from unet_embroidery_seg_torch.ops import losses, metrics, schedules
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

K = 5  # output classes: --num-classes 4, plus background; targets 0..K, K ignored
N, H, W = 3, 9, 7
BATCH, STEPS, LR = 2, 3, 1e-4
MULTICLASS_KEYS = {"Pixel Accuracy", "Mean Accuracy", "Mean IoU", "Frequency Weighted IoU"}


def _targets(rng, n, h, w, ignore_share=0.1):
    t = rng.randint(0, K, (n, h, w)).astype(np.int32)
    t[rng.rand(n, h, w) < ignore_share] = K
    return t


# --- losses ------------------------------------------------------------------------------

LOSS_CASES = [(name, mask, ignore) for name in ("ce", "focal", "dice")
              for mask in (None, [1.0, 0.0, 1.0]) for ignore in (False, True)]


def _jax_loss(name, lg, targets, sm):
    sm = None if sm is None else jnp.asarray(sm)
    t = jnp.asarray(targets)
    if name == "ce":
        return jax_losses.ce_loss(lg, t, num_classes=K, sample_mask=sm)
    if name == "focal":
        return jax_losses.focal_loss(lg, t, num_classes=K, sample_mask=sm)
    return jax_losses.dice_loss(lg, jax.nn.one_hot(t, K + 1, dtype=jnp.float32), sample_mask=sm)


def _port_loss(name, lg, targets, sm):
    sm = None if sm is None else torch.from_numpy(sm)
    t = torch.from_numpy(targets)
    if name == "ce":
        return losses.ce_loss(lg, t, num_classes=K, sample_mask=sm)
    if name == "focal":
        return losses.focal_loss(lg, t, num_classes=K, sample_mask=sm)
    return losses.dice_loss(lg, F.one_hot(t.long(), K + 1).float(), sample_mask=sm)


@pytest.mark.parametrize("name,sample_mask,ignore", LOSS_CASES)
def test_multiclass_losses_and_grads_match_jax(name, sample_mask, ignore):
    rng = np.random.RandomState(len(name) + 2 * int(ignore))
    logits = (2.0 * rng.randn(N, H, W, K)).astype(np.float32)
    targets = _targets(rng, N, H, W, ignore_share=0.1 if ignore else 0.0)
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)
    want, want_grad = jax.value_and_grad(lambda lg: _jax_loss(name, lg, targets, sm))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = _port_loss(name, lt, targets, sm)
    (got_grad,) = torch.autograd.grad(got, lt)
    # f32 both sides, sums over <= 189 pixels of O(1) terms: summation order only.
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    if sm is not None:  # the padded sample gets no gradient
        assert torch.count_nonzero(got_grad[sm == 0]) == 0
    if ignore and name != "dice":  # CE and focal give ignored pixels no gradient
        assert torch.count_nonzero(got_grad[torch.from_numpy(targets) == K]) == 0


def test_multiclass_loss_is_the_steps_sum():
    rng = np.random.RandomState(9)
    logits = torch.from_numpy(rng.randn(N, H, W, K).astype(np.float32))
    targets = _targets(rng, N, H, W)
    for focal in (False, True):
        for use_dice in (False, True):
            got = losses.multiclass_loss(logits, torch.from_numpy(targets), K, focal, use_dice)
            want = _port_loss("focal" if focal else "ce", logits, targets, None)
            if use_dice:
                want = want + _port_loss("dice", logits, targets, None)
            torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- metrics -------------------------------------------------------------------------------


def test_per_class_tables_match_jax_exactly():
    rng = np.random.RandomState(3)
    pred, target = rng.randint(0, K, (N, H, W)), _targets(rng, N, H, W)
    want = jax_metrics._per_class_tables(jnp.asarray(pred), jnp.asarray(target), K)
    got = metrics._per_class_tables(torch.from_numpy(pred), torch.from_numpy(target), K)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sample_mask", [None, [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("fn", ["multiclass_batch_metrics", "multiclass_per_sample_sums"])
def test_multiclass_metrics_match_jax(fn, sample_mask):
    rng = np.random.RandomState(4)
    logits = rng.randn(N, H, W, K).astype(np.float32)
    target = _targets(rng, N, H, W)
    target[1, :, :4] = 0  # class presence differs from sample to sample
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)
    want = getattr(jax_metrics, fn)(jnp.asarray(logits), jnp.asarray(target), K,
                                    None if sm is None else jnp.asarray(sm))
    got = getattr(metrics, fn)(torch.from_numpy(logits), torch.from_numpy(target), K,
                               None if sm is None else torch.from_numpy(sm))
    if fn == "multiclass_per_sample_sums":
        (want, want_n), (got, got_n) = want, got
        assert got_n.item() == float(want_n)
    assert set(got) == set(want) == MULTICLASS_KEYS
    for k in want:  # ratios of integer counts: f32 rounding only
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, atol=1e-6, err_msg=k)


def test_per_sample_statistic_differs_from_per_batch_and_both_match_jax():
    # Two samples with different classes present: the per-batch Mean IoU
    # averages over the union of present classes, the per-sample one over
    # each sample's own (the reference val CLI's batch size 1).
    rng = np.random.RandomState(5)
    target = np.zeros((2, 8, 8), np.int32)
    target[0, :4] = 1
    target[1, :, :4] = 2
    logits = (rng.randn(2, 8, 8, K) + 3.0 * np.eye(K)[target]).astype(np.float32)
    logits[0, 0, :3] = [0, 0, 0, 9, 0]  # a few wrong predictions
    jl, jt = jnp.asarray(logits), jnp.asarray(target)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(target)
    per_batch = metrics.multiclass_batch_metrics(tl, tt, K)
    sums, n = metrics.multiclass_per_sample_sums(tl, tt, K)
    want_batch = jax_metrics.multiclass_batch_metrics(jl, jt, K)
    want_sums, want_n = jax_metrics.multiclass_per_sample_sums(jl, jt, K)
    for k in MULTICLASS_KEYS:
        np.testing.assert_allclose(per_batch[k].item(), float(want_batch[k]), rtol=1e-6, err_msg=k)
        np.testing.assert_allclose(sums[k].item(), float(want_sums[k]), rtol=1e-6, err_msg=k)
    assert n.item() == float(want_n) == 2.0
    assert abs(per_batch["Mean IoU"].item() - sums["Mean IoU"].item() / 2) > 0.01


# --- train and eval steps against JAX ------------------------------------------------------


def _batches(seed: int):
    """STEPS seeded batches: images, blocky K-class targets with ignore pixels, sample masks."""
    rng = np.random.RandomState(seed)
    out = []
    for step in range(STEPS):
        images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        coarse = rng.randint(0, K, (BATCH, 4, 4))
        pngs = np.kron(coarse, np.ones((11, 11), np.int64)).astype(np.int32)
        pngs[rng.rand(BATCH, SIZE, SIZE) < 0.02] = K
        sm = np.asarray([1.0, 0.0] if step == 1 else [1.0, 1.0], np.float32)
        out.append((images, pngs, sm))
    return out


def _port_model(variables):
    _, cls, kwargs = FAMILIES["unet_plain"]
    model = init_weights(cls(num_classes=K, **kwargs), torch.Generator().manual_seed(0))
    model = model.to(memory_format=torch.channels_last)
    model.load_state_dict(state_dict_from_jax("unet_plain", variables), strict=True)
    return model


def _stock_conv3x3_same(x, weight):
    return F.conv2d(x, weight, padding=1)


def _stock_upsample2x(x, align_corners):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


@pytest.fixture(scope="module")
def ref():
    jcls, _, kwargs = FAMILIES["unet_plain"]
    jmodel = jcls(num_classes=K, **kwargs)
    return {"jmodel": jmodel, "variables": seeded_variables(jmodel, seed=0),
            "batches": _batches(seed=1)}


@pytest.fixture(scope="module", params=["ce", "focal"])
def trajectory(request, ref):
    """Losses per step and (batch_stats + params) after steps 1 and STEPS, for jax, port, stock."""
    focal = request.param == "focal"
    tx = jax_schedules.make_train_optimizer(LR, momentum=0.9, weight_decay=1e-4,
                                            param_dtype=jnp.float32)
    state = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]), tx)
    jstep = jax_steps.make_multiclass_train_step(ref["jmodel"], tx, K, focal=focal, use_dice=True)
    port, stock = _port_model(ref["variables"]), _port_model(ref["variables"])
    runs = {}
    for name, model in (("port", port), ("stock", stock)):
        opt = schedules.make_train_optimizer(model.parameters(), LR, momentum=0.9,
                                             weight_decay=1e-4)
        runs[name] = steps.make_multiclass_train_step(model, opt, K, focal=focal, use_dice=True,
                                                      amp=False)
    out = {"port": port, "loss": {"jax": [], "port": [], "stock": []}, "snapshots": {}}
    rng = jax.random.PRNGKey(1)
    for i, (images, pngs, sm) in enumerate(ref["batches"]):
        state, loss = jstep(state, jnp.asarray(images), jnp.asarray(pngs), jnp.asarray(sm), rng)
        out["loss"]["jax"].append(float(loss))
        out["loss"]["port"].append(float(runs["port"](images, pngs, sm)))
        with mock.patch.object(blocks, "conv3x3_same", _stock_conv3x3_same), \
                mock.patch.object(blocks, "upsample2x", _stock_upsample2x):
            out["loss"]["stock"].append(float(runs["stock"](images, pngs, sm)))
        if i + 1 in (1, STEPS):
            out["snapshots"][i + 1] = {
                "jax": state_dict_from_jax("unet_plain", jax.tree.map(
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
    # The yardstick rule of test_torch_families_train.py: train-mode BN at
    # the 2x2 bottom map magnifies f32 rounding; the port is held to JAX as
    # closely as stock PyTorch ops are, with a margin of 2x, plus f32 floors.
    loss = {k: np.asarray(v[:after]) for k, v in trajectory["loss"].items()}
    np.testing.assert_allclose(loss["port"][0], loss["jax"][0], rtol=1e-5)
    assert (np.abs(loss["port"] - loss["jax"])
            <= 2 * np.abs(loss["stock"] - loss["jax"]) + 1e-5 * np.abs(loss["jax"])).all(), loss
    snap = trajectory["snapshots"][after]
    jax_sd, port_sd, stock_sd = snap["jax"], snap["port"], snap["stock"]
    assert set(jax_sd) == set(port_sd)
    for k, want in jax_sd.items():
        if k.endswith(("running_mean", "running_var")):
            ours = (port_sd[k] - want).abs().max().item()
            yardstick = (stock_sd[k] - want).abs().max().item()
            assert ours <= 2 * yardstick + 1e-4 * want.abs().max().item(), (k, ours, yardstick)
    mean, share, biggest = _param_spread(port_sd, jax_sd)
    s_mean, s_share, _ = _param_spread(stock_sd, jax_sd)
    assert biggest <= 2.0 * after + 0.01
    assert mean <= 2 * s_mean + 1e-3 and share <= 2 * s_share + 1e-4, (mean, share, s_mean, s_share)


def test_every_parameter_gets_a_gradient(trajectory):
    for name, p in trajectory["port"].named_parameters():
        assert p.grad is not None, name
        assert torch.isfinite(p.grad).all(), name
        assert torch.count_nonzero(p.grad) > 0, name


@pytest.mark.parametrize("focal", [False, True])
@pytest.mark.parametrize("per_sample", [False, True])
def test_eval_steps_match_jax(ref, focal, per_sample):
    images, pngs, _ = ref["batches"][2]
    sm = np.asarray([1.0, 0.0], np.float32)
    jstate = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]),
                               jax_schedules.make_optimizer(LR))
    model = _port_model(ref["variables"])
    if per_sample:
        jfn, fn = (jax_steps.make_multiclass_persample_eval_step,
                   steps.make_multiclass_persample_eval_step)
    else:
        jfn, fn = jax_steps.make_multiclass_eval_step, steps.make_multiclass_eval_step
    want = jfn(ref["jmodel"], K, focal=focal, use_dice=True)(
        jstate, jnp.asarray(images), jnp.asarray(pngs), jnp.asarray(sm))
    got = fn(model, K, focal=focal, use_dice=True, amp=False)(images, pngs, sm)
    # f32 logits 1e-4 of their scale apart (test_torch_families): the loss to
    # 1e-5; the metrics count argmax pixels, where no logit pair is that close.
    np.testing.assert_allclose(got[0].item(), float(want[0]), rtol=1e-5)
    assert set(got[1]) == MULTICLASS_KEYS
    for k in MULTICLASS_KEYS:
        np.testing.assert_allclose(got[1][k].item(), float(want[1][k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    if per_sample:
        assert got[2].item() == float(want[2]) == 1.0


# --- the CLIs ----------------------------------------------------------------------------------


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


CLI_ARGS = ["--data-path", "synthetic:4", "--input-size", "32", "--batch-size", "2",
            "--max-train-batches", "1", "--max-val-batches", "1", "--max-test-batches", "2",
            "--device", "cpu", "--no-amp", "--task", "multiclass", "--epochs", "2"]


@pytest.mark.parametrize("model,loss", [("unet_resnet50", "ce"), ("unet_plain", "focal")])
def test_train_val_clis(model, loss, workdir, capsys):
    exp = port_train.train(port_train.parse_args(
        CLI_ARGS + ["--model", model, "--loss", loss, "--ckpt-every", "1"]))
    for name in ("config.json", "summary.json", "test_metrics.json", "val_metrics_history.json",
                 "val_metrics_history.csv", "weights/best.pth", "weights/last.pth",
                 "weights/resume.pth"):
        assert os.path.exists(os.path.join(exp, name)), name
    config = json.load(open(os.path.join(exp, "config.json")))
    assert (config["task"], config["model"], config["loss"]) == ("multiclass", model, loss)
    assert "resolved_pos_weight" not in config  # multiclass has no pos_weight
    # keyed as scripts/make_tables.py reads a multiclass run
    test_metrics = json.load(open(os.path.join(exp, "test_metrics.json")))
    assert set(test_metrics) == MULTICLASS_KEYS | {"Loss"}
    summary = json.load(open(os.path.join(exp, "summary.json")))
    history = json.load(open(os.path.join(exp, "val_metrics_history.json")))
    assert summary["best_score"] == max(m["Mean IoU"] for m in history)
    with open(os.path.join(exp, "val_metrics_history.csv")) as f:
        assert f.readline().strip() == "epoch,Pixel Accuracy,Mean Accuracy,Mean IoU," \
                                       "Frequency Weighted IoU,Loss"
    capsys.readouterr()
    metrics = port_val.val(port_val.parse_args([
        "--data-path", "synthetic:4", "--input-size", "32", "--device", "cpu", "--no-amp",
        "--task", "multiclass", "--model", model, "--num-classes", "4",
        "--weights", os.path.join(exp, "weights", "best.pth")]))
    assert set(metrics) == MULTICLASS_KEYS | {"Loss"}
    assert capsys.readouterr().out.strip().splitlines()[-1] == str(metrics)
    for v in metrics.values():
        assert np.isfinite(v)


def test_resume_continues_a_multiclass_run(workdir):
    args = CLI_ARGS[:-2] + ["--model", "unet_plain", "--loss", "focal", "--ckpt-every", "1"]
    full = port_train.train(port_train.parse_args(args + ["--epochs", "2"]))
    first = port_train.train(port_train.parse_args(args + ["--epochs", "1"]))
    resumed = port_train.train(port_train.parse_args(
        args + ["--epochs", "2", "--resume", os.path.join(first, "weights", "resume.pth")]))
    a = torch.load(os.path.join(full, "weights", "last.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "weights", "last.pth"), weights_only=True)
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    ha = json.load(open(os.path.join(full, "val_metrics_history.json")))
    hb = json.load(open(os.path.join(resumed, "val_metrics_history.json")))
    assert ha == hb


@pytest.mark.parametrize("loss", ["bce", "lovasz_hinge"])
def test_binary_losses_are_lowered_to_ce_with_a_warning(loss, workdir, capsys):
    args = port_train.parse_args(CLI_ARGS + ["--model", "unet_plain", "--loss", loss])
    model = mock.Mock()
    with mock.patch.object(steps, "make_multiclass_train_step") as train_step, \
            mock.patch.object(steps, "make_multiclass_eval_step"):
        port_train.make_steps(args, model, None, K, None)
    assert f"[WARN] --loss {loss} is binary-only" in capsys.readouterr().out
    assert train_step.call_args.kwargs["focal"] is False
