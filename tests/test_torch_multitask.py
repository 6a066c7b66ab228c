"""multitask_unet and the multitask task: the port against the JAX package, in float32 on the CPU.

The model is full width (the ResNet-50 encoder has no width knob), so it
runs at 64^2, batch 2, and one module-scoped set of JAX variables (shapes
from ``jax.eval_shape``, values drawn by numpy from a seed) serves every
test; ``state_dict_from_jax`` carries them to the port with ``strict=True``.
Dropout cannot draw the same numbers in two frameworks, so the train steps
are compared with it made the identity on both sides: flax's
``intercept_methods`` returns ``nn.Dropout``'s input on the JAX side, and the
port's ``cls_head[4].p`` is 0. A separate test pins the port's dropout in
train and eval mode.
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
from flax import linen as flax_nn

from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.ops import losses as jax_losses
from unet_embroidery_seg_tpu.ops import metrics as jax_metrics
from unet_embroidery_seg_tpu.ops import resize as jax_resize
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_tpu.utils import torch_interop
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch import val as port_val
from unet_embroidery_seg_torch.engine import steps
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.ops import losses, metrics, schedules
from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
from unet_embroidery_seg_torch.ops.resize import adaptive_avg_pool_1x1
from unet_embroidery_seg_torch.ops.upsample import upsample2x
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE, BATCH, STEPS, LR = 64, 2, 3, 1e-4
MASKS = [[1.0, 1.0], [1.0, 0.0], [1.0, 1.0]]  # step 2 has a padded tail sample
POS_WEIGHT = 2.0  # the opt-in seg BCE weight, exercised by the trajectory


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
    """STEPS seeded batches: images, disc masks (~30% foreground), class labels, sample masks."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    out = []
    for step in range(STEPS):
        images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        cx, cy, r = rng.uniform(0.2, 0.8, (3, BATCH, 1, 1))
        pngs = (((xx - cx) ** 2 + (yy - cy) ** 2) < (0.5 * r) ** 2).astype(np.int32)
        cls = rng.randint(0, 3, BATCH).astype(np.int32)
        out.append((images, pngs, cls, np.asarray(MASKS[step], np.float32)))
    return out


@pytest.fixture(scope="module")
def ref():
    jmodel = jax_build_model("multitask_unet", num_classes=1, num_seg_classes=1, num_cls_classes=3)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
    variables = _seeded(dict(shapes), seed=0)
    return {"jmodel": jmodel, "variables": variables, "batches": _batches(seed=1)}


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


def _port_model(variables, dropout: float = 0.0):
    model = build_model("multitask_unet", 1, device="cpu")
    model.load_state_dict(state_dict_from_jax("multitask_unet", variables), strict=True)
    model.cls_head[4].p = dropout
    return model


def _jax_state(variables):
    tx = jax_schedules.make_train_optimizer(LR, momentum=0.9, weight_decay=1e-4,
                                            param_dtype=jnp.float32)
    return TrainState.create(jax.tree.map(jnp.asarray, variables), tx), tx


def _dropout_is_identity(next_fun, args, kwargs, context):
    if isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


# --- the pool, the losses and the metrics ------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adaptive_avg_pool_matches_jax_mean(dtype):
    x = np.random.RandomState(0).randn(2, 3, 5, 7).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(jax_resize.adaptive_avg_pool_1x1(xj).astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = adaptive_avg_pool_1x1(xt.permute(0, 3, 1, 2))
    assert got.dtype == xt.dtype and got.shape == (2, 7)
    # f32 sums of 15 values both sides; bf16: the same f32 mean rounded once.
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=1e-6)


MT_LOSS_CASES = [("bce", None, None), ("bce", None, [1.0, 0.0, 1.0]), ("bce", 3.5, None),
                 ("bce", 3.5, [0.0, 1.0, 1.0]), ("lovasz_hinge", None, None),
                 ("lovasz_hinge", None, [1.0, 1.0, 0.0]), ("dice", None, None)]


@pytest.mark.parametrize("seg_loss,pos_weight,sample_mask", MT_LOSS_CASES)
def test_multitask_loss_and_grads_match_jax(seg_loss, pos_weight, sample_mask):
    # "dice" is no seg loss of the multitask head: like every other name, BCE.
    rng = np.random.RandomState(len(seg_loss) + int(pos_weight or 0))
    seg = (2.0 * rng.randn(3, 9, 7, 1)).astype(np.float32)  # continuous: no Lovasz ties
    cls = rng.randn(3, 3).astype(np.float32)
    pngs = (rng.rand(3, 9, 7) < 0.3).astype(np.int32)
    labels = np.asarray([2, 0, 1], np.int32)
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)

    def jax_loss(s, c):
        return jax_losses.multitask_loss(
            s, c, jnp.asarray(pngs), jnp.asarray(labels), seg_loss_name=seg_loss,
            cls_loss_weight=0.7, sample_mask=None if sm is None else jnp.asarray(sm),
            pos_weight=pos_weight)

    want = jax_loss(jnp.asarray(seg), jnp.asarray(cls))
    want_grads = jax.grad(lambda s, c: jax_loss(s, c)[0], argnums=(0, 1))(
        jnp.asarray(seg), jnp.asarray(cls))
    st, ct = torch.from_numpy(seg).requires_grad_(), torch.from_numpy(cls).requires_grad_()
    got = losses.multitask_loss(
        st, ct, torch.from_numpy(pngs), torch.from_numpy(labels), seg_loss_name=seg_loss,
        cls_loss_weight=0.7, sample_mask=None if sm is None else torch.from_numpy(sm),
        pos_weight=pos_weight)
    grads = torch.autograd.grad(got[0], (st, ct))
    # f32 both sides, sums over <= 189 pixels of O(1) terms: summation order only.
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.item(), float(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    if sm is not None:  # the padded sample gets no gradient
        assert torch.count_nonzero(grads[0][sm == 0]) == 0
        assert torch.count_nonzero(grads[1][sm == 0]) == 0


@pytest.mark.parametrize("sample_mask", [None, [1.0, 0.0, 1.0]])
def test_multitask_seg_counts_and_metrics_match_jax(sample_mask):
    rng = np.random.RandomState(4)
    seg = rng.randn(3, 9, 7, 1).astype(np.float32)
    pngs = (rng.rand(3, 9, 7) < 0.4).astype(np.int32)
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)
    want = np.asarray(jax_metrics.multitask_seg_counts(
        jnp.asarray(seg), jnp.asarray(pngs), None if sm is None else jnp.asarray(sm)))
    got = metrics.multitask_seg_counts(torch.from_numpy(seg), torch.from_numpy(pngs),
                                       None if sm is None else torch.from_numpy(sm))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    inter, union, psum, tsum = got.tolist()
    assert inter <= min(psum, tsum) and max(psum, tsum) <= union
    assert metrics.multitask_seg_metrics_from_counts(*got.tolist()) == \
        jax_metrics.multitask_seg_metrics_from_counts(*want.tolist())


# --- the model ----------------------------------------------------------------------------


def test_eval_forward_matches_jax_f32(ref):
    x = np.random.RandomState(2).rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    want_seg, want_cls = (np.asarray(v) for v in jax_steps.make_predict_fn(ref["jmodel"])(
        ref["variables"], jnp.asarray(x)))
    got_seg, got_cls = (v.numpy() for v in steps.make_predict_fn(
        _port_model(ref["variables"], dropout=0.5), amp=False)(x))
    assert got_seg.shape == want_seg.shape == (BATCH, SIZE, SIZE, 1)
    assert got_cls.shape == want_cls.shape == (BATCH, 3)
    assert 0.1 < np.abs(want_seg).max() < 1e3 and 0.1 < np.abs(want_cls).max() < 1e3
    # f32 both sides (JAX matmul precision "highest"); ~70 layers summed in
    # another order by XLA and oneDNN: 1e-4 of the seg logits' scale, and
    # 1e-4 for the O(1) class logits (eval mode: dropout off on both sides).
    np.testing.assert_allclose(got_seg, want_seg, rtol=0, atol=1e-4 * np.abs(want_seg).max())
    np.testing.assert_allclose(got_cls, want_cls, rtol=0, atol=1e-4)


def test_state_dict_from_jax_equals_torch_interop_export(ref):
    ours = state_dict_from_jax("multitask_unet", ref["variables"])
    theirs = torch_interop.export_state_dict("multitask_unet", ref["variables"])
    assert set(ours) == set(theirs) == set(build_model("multitask_unet", 1, device="cpu")
                                           .state_dict())
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert ours["cls_head.2.weight"].shape == (512, 2048)  # Dense (in, out) -> (out, in)
    assert ours["cls_head.5.weight"].shape == (3, 512)
    assert "encoder.layer1.0.downsample.0.weight" in ours and "up_conv.3.bias" in ours


def test_forward_runs_each_kernel_site_through_its_wrapper(ref, monkeypatch):
    seen = {"up": [], "conv": []}

    def spy_up(x, align_corners):
        seen["up"].append((tuple(x.shape), align_corners))
        return upsample2x(x, align_corners)

    def spy_conv(x, w, b):
        seen["conv"].append(tuple(x.shape))
        return conv3x3_bias_relu(x, w, b)

    monkeypatch.setattr(blocks, "upsample2x", spy_up)
    monkeypatch.setattr(blocks, "conv3x3_bias_relu", spy_conv)
    x = np.random.RandomState(3).rand(1, SIZE, SIZE, 3).astype(np.float32)
    steps.make_predict_fn(_port_model(ref["variables"]), amp=False)(x)
    assert seen["up"] == [((1, 2048, 2, 2), True), ((1, 512, 4, 4), True),
                          ((1, 256, 8, 8), True), ((1, 128, 16, 16), True),
                          ((1, 64, 32, 32), True)]
    assert seen["conv"] == [(1, 512, 4, 4), (1, 256, 8, 8), (1, 128, 16, 16), (1, 64, 32, 32),
                            (1, 64, 64, 64), (1, 64, 64, 64)]


def test_build_model_is_seeded_and_the_class_head_is_flax_dense_init():
    a = build_model("multitask_unet", 1, device="cpu", generator=torch.Generator().manual_seed(5))
    b = build_model("multitask_unet", 1, device="cpu", generator=torch.Generator().manual_seed(5))
    for k, v in a.state_dict().items():
        torch.testing.assert_close(b.state_dict()[k], v, rtol=0, atol=0)
    # flax nn.Dense defaults: LeCun normal (variance 1 / fan_in, truncated at
    # 2 std), zero bias; the convs keep the reference's N(0, 0.02).
    for slot, fan_in in ((2, 2048), (5, 512)):
        w = a.cls_head[slot].weight.detach()
        assert abs(w.std().item() * fan_in ** 0.5 - 1.0) < 0.05, slot
        assert w.abs().max().item() <= 2 / 0.87962566103423978 / fan_in ** 0.5 + 1e-6
        assert torch.count_nonzero(a.cls_head[slot].bias) == 0
    assert abs(a.seg_head.weight.std().item() - 0.02) < 0.01


def test_build_model_refuses_a_diff_head_and_a_decoder_width():
    with pytest.raises(ValueError, match="diff_head"):
        build_model("multitask_unet", 1, diff_head=True, device="cpu")
    with pytest.raises(ValueError, match="decoder_width"):
        build_model("multitask_unet", 1, decoder_width=0.5, device="cpu")


def test_dropout_is_active_in_train_mode_and_off_in_eval(ref):
    # The class head's Dropout(0.5): in train mode about half of the 512
    # hidden units are zeroed and the rest scaled by 2; in eval it is off.
    model = _port_model(ref["variables"], dropout=0.5)
    feat = torch.from_numpy(np.random.RandomState(5).rand(8, 2048, 2, 2).astype(np.float32))
    hidden = model.cls_head[:4]  # up to the ReLU
    drop = model.cls_head[4]
    with torch.no_grad():
        h = hidden(feat)
        torch.manual_seed(0)
        train_out = drop.train()(h)
        eval_out = drop.eval()(h)
    torch.testing.assert_close(eval_out, h, rtol=0, atol=0)
    live = h > 0
    kept = train_out[live] != 0
    assert 0.45 < 1.0 - kept.float().mean().item() < 0.55
    torch.testing.assert_close(train_out[live][kept], 2 * h[live][kept], rtol=0, atol=0)
    assert torch.count_nonzero(train_out[~live]) == 0
    # The whole model: train-mode class logits move with the draw, eval's do not.
    x = torch.from_numpy(np.random.RandomState(6).rand(2, SIZE, SIZE, 3).astype(np.float32))
    x = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        model.eval()
        e1, e2 = model(x)[1], model(x)[1]
        model.train()
        model.encoder.eval()  # keep the BN statistics still
        t1, t2 = model(x)[1], model(x)[1]
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    assert not torch.equal(t1, t2)


# --- training and evaluation against JAX ----------------------------------------------------


def _stock_conv3x3_bias_relu(x, weight, bias):
    return torch.relu(F.conv2d(x, weight, bias, padding=1))


def _stock_upsample2x(x, align_corners):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


@pytest.fixture(scope="module")
def trajectory(ref):
    """Loss triples per step and (batch_stats + params) after steps 1 and STEPS, for three runs.

    "jax": the JAX package, dropout the identity. "port": the port at p = 0.
    "stock": the port's model with its two kernel Functions swapped for
    stock PyTorch ops, the yardstick of how far PyTorch's own arithmetic
    lands from JAX's on this model.
    """
    state, tx = _jax_state(ref["variables"])
    jstep = jax_steps.make_multitask_train_step(ref["jmodel"], tx, "bce", 1.0, POS_WEIGHT)
    port, stock = _port_model(ref["variables"]), _port_model(ref["variables"])
    runs = {}
    for name, model in (("port", port), ("stock", stock)):
        opt = schedules.make_train_optimizer(model.parameters(), LR, momentum=0.9,
                                             weight_decay=1e-4)
        runs[name] = steps.make_multitask_train_step(model, opt, "bce", 1.0, POS_WEIGHT,
                                                     amp=False)
    out = {"port": port, "loss": {"jax": [], "port": [], "stock": []},
           "correct": {"jax": [], "port": []}, "snapshots": {}}
    rng = jax.random.PRNGKey(1)
    for i, (images, pngs, cls, sm) in enumerate(ref["batches"]):
        with flax_nn.intercept_methods(_dropout_is_identity):
            state, triple, correct = jstep(state, jnp.asarray(images), jnp.asarray(pngs),
                                           jnp.asarray(cls), jnp.asarray(sm), rng)
        out["loss"]["jax"].append([float(v) for v in triple])
        out["correct"]["jax"].append(int(correct))
        triple, correct = runs["port"](images, pngs, cls, sm)
        out["loss"]["port"].append([v.item() for v in triple])
        out["correct"]["port"].append(int(correct))
        with mock.patch.object(blocks, "conv3x3_bias_relu", _stock_conv3x3_bias_relu), \
                mock.patch.object(blocks, "upsample2x", _stock_upsample2x):
            out["loss"]["stock"].append([v.item() for v in runs["stock"](images, pngs, cls, sm)[0]])
        if i + 1 in (1, STEPS):
            out["snapshots"][i + 1] = {
                "jax": state_dict_from_jax("multitask_unet", jax.tree.map(
                    np.asarray, {"params": state.opt_state.master,
                                 "batch_stats": state.batch_stats})),
                "port": {k: v.detach().clone() for k, v in port.state_dict().items()},
                "stock": {k: v.detach().clone() for k, v in stock.state_dict().items()},
            }
    out["jax_state"] = state
    return out


def _param_spread(a: dict, b: dict) -> tuple[float, float, float]:
    """(mean, share above 0.1, max) of |a - b| / lr over every parameter element."""
    d = torch.cat([(a[k] - b[k]).abs().flatten() / LR for k in b
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))])
    return d.mean().item(), (d > 0.1).float().mean().item(), d.max().item()


@pytest.mark.parametrize("after", [1, STEPS])
def test_train_steps_match_jax(trajectory, after):
    # As in test_torch_train.py: train-mode BN at the 2x2 bottom map with
    # batch 2 magnifies f32 rounding from stage to stage, and Adam moves a
    # weight whose gradient is that noise by +-lr. So the port is held to
    # JAX as closely as stock PyTorch ops are ("stock"), with a margin of 2x,
    # plus f32 floors, for each of (total, seg, cls).
    loss = {k: np.asarray(v[:after]) for k, v in trajectory["loss"].items()}
    # Step 1 sees identical weights: its seg loss agrees to f32 rounding. The
    # class head reads feat5, which train-mode BN leaves ~1e-3 apart between
    # the frameworks (test_torch_train.py), so the cls loss (1e-4 apart, in
    # stock PyTorch ops too) is held by the yardstick alone.
    np.testing.assert_allclose(loss["port"][0][1], loss["jax"][0][1], rtol=1e-5)
    assert (np.abs(loss["port"] - loss["jax"])
            <= 2 * np.abs(loss["stock"] - loss["jax"]) + 1e-5 * np.abs(loss["jax"])).all(), loss
    assert trajectory["correct"]["port"][:after] == trajectory["correct"]["jax"][:after]
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


@pytest.mark.parametrize("seg_loss,pos_weight", [("bce", None), ("bce", 2.5), ("lovasz_hinge", None)])
def test_eval_step_matches_jax(ref, seg_loss, pos_weight):
    images, pngs, cls, _ = ref["batches"][2]
    sm = np.asarray([1.0, 0.0], np.float32)
    jeval = jax_steps.make_multitask_eval_step(ref["jmodel"], seg_loss, 1.0, 3, pos_weight)
    jstate = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]),
                               jax_schedules.make_optimizer(LR))
    jtriple, jcounts, jconf = jeval(jstate, jnp.asarray(images), jnp.asarray(pngs),
                                    jnp.asarray(cls), jnp.asarray(sm))
    model = _port_model(ref["variables"], dropout=0.5)  # eval: dropout off
    triple, counts, conf = steps.make_multitask_eval_step(
        model, seg_loss, 1.0, pos_weight, amp=False)(images, pngs, cls, sm)
    np.testing.assert_allclose([v.item() for v in triple], [float(v) for v in jtriple], rtol=1e-5)
    # sigmoid > 0.5 and argmax on f32 logits agree to 1e-4 of their scale
    # above: only a value within that of the threshold could flip; none is.
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    np.testing.assert_array_equal(conf.numpy(), np.asarray(jconf))
    assert conf.sum().item() == 1 and counts[1].item() <= SIZE * SIZE  # one valid sample


# --- the CLIs ----------------------------------------------------------------------------

CLI_ARGS = ["--data-path", "synthetic:4", "--input-size", "32", "--batch-size", "2",
            "--max-train-batches", "2", "--max-val-batches", "1", "--max-test-batches", "2",
            "--device", "cpu", "--no-amp", "--task", "multitask", "--model", "multitask_unet",
            "--loss", "bce"]
MULTITASK_KEYS = {"Loss", "IoU", "Dice", "Cls Acc"}


def _delete(exp: str, *names: str) -> None:
    for name in names:
        path = os.path.join(exp, "weights", name)
        if os.path.exists(path):
            os.remove(path)


def test_train_resume_weights_and_val_clis(workdir, capsys):
    args = CLI_ARGS + ["--ckpt-every", "1", "--pos-weight", "2.5"]
    full = port_train.train(port_train.parse_args(args + ["--epochs", "2"]))
    for name in ("config.json", "summary.json", "test_metrics.json", "val_metrics_history.json",
                 "val_metrics_history.csv", "weights/best.pth", "weights/last.pth",
                 "weights/resume.pth"):
        assert os.path.exists(os.path.join(full, name)), name
    config = json.load(open(os.path.join(full, "config.json")))
    assert config["resolved_pos_weight"] == 2.5
    test_metrics = json.load(open(os.path.join(full, "test_metrics.json")))
    assert set(test_metrics) == MULTITASK_KEYS
    summary = json.load(open(os.path.join(full, "summary.json")))
    assert summary["test_metrics"] == test_metrics
    assert summary["best_score"] == max(m["IoU"] for m in json.load(
        open(os.path.join(full, "val_metrics_history.json"))))
    out = capsys.readouterr().out
    assert "(Seg: " in out and "Cls Acc: " in out and "Val - IoU: " in out

    # --resume continues the run bit for bit. Each checkpoint goes once read:
    # at full width they are 176 MB (model) and 528 MB (resume).
    _delete(full, "resume.pth")
    first = port_train.train(port_train.parse_args(args + ["--epochs", "1"]))
    resumed = port_train.train(port_train.parse_args(
        args + ["--epochs", "2", "--resume", os.path.join(first, "weights", "resume.pth")]))
    _delete(first, "best.pth", "last.pth", "resume.pth")  # the resumed run read them
    a = torch.load(os.path.join(full, "weights", "last.pth"), weights_only=True)
    b = torch.load(os.path.join(resumed, "weights", "last.pth"), weights_only=True)
    _delete(full, "last.pth")
    _delete(resumed, "best.pth", "last.pth", "resume.pth")
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)

    # --weights loads every key
    capsys.readouterr()
    loaded = port_train.train(port_train.parse_args(
        CLI_ARGS + ["--epochs", "1", "--ckpt-every", "0", "--weights",
                    os.path.join(full, "weights", "best.pth")]))
    _delete(loaded, "best.pth", "last.pth")
    assert "Skipped: 0 keys" in capsys.readouterr().out

    # val: the multitask report, the loss on the training scale with --pos-weight;
    # batch size 1 over the 4 test images, which the train CLI saw in 2 batches of 2
    metrics = port_val.val(port_val.parse_args([
        "--data-path", "synthetic:4", "--input-size", "32", "--device", "cpu", "--no-amp",
        "--task", "multitask", "--model", "multitask_unet", "--loss", "bce",
        "--pos-weight", "2.5", "--weights", os.path.join(full, "weights", "best.pth")]))
    out = capsys.readouterr().out
    assert "Multi-Task Evaluation Results" in out and "Per-Class Accuracy:" in out
    assert f"  IoU:  {metrics['IoU']:.4f}" in out
    assert f"  Overall Accuracy: {metrics['Cls Acc']:.2f}%" in out
    for k in ("IoU", "Dice", "Cls Acc"):
        assert metrics[k] == pytest.approx(test_metrics[k], abs=1e-6), k


@pytest.mark.parametrize("flag,resolved", [([], None), (["--pos-weight", "auto"], "auto")])
def test_multitask_pos_weight_is_off_by_default(workdir, flag, resolved):
    args = port_train.parse_args(CLI_ARGS + flag)
    train_dataset = [None]
    with mock.patch.object(port_train, "estimate_pos_weight", return_value=4.0) as est:
        pw = port_train.resolve_pos_weight(args, train_dataset)
    assert pw == (None if resolved is None else 4.0)
    assert est.called is (resolved == "auto")
    # Lovasz takes no pos_weight, even when asked for
    lovasz = port_train.parse_args(CLI_ARGS + flag + ["--loss", "lovasz_hinge"])
    assert port_train.resolve_pos_weight(lovasz, train_dataset) is None


@pytest.mark.parametrize("task,model", [("multitask", "unet_resnet50"),
                                        ("multitask", "unet_plain"),
                                        ("binary", "multitask_unet"),
                                        ("multiclass", "multitask_unet")])
def test_task_model_mismatch_raises(workdir, task, model):
    args = ["--data-path", "synthetic:4", "--device", "cpu", "--task", task, "--model", model]
    with pytest.raises(SystemExit, match="incompatible"):
        port_train.train(port_train.parse_args(args))
    assert not os.path.exists("run")  # refused before any artefact


@pytest.mark.parametrize("flag", [["--profile", "--mesh-space", "2"], ["--mesh-space", "2"]])
def test_unported_flags_still_raise_for_multitask(flag):
    # multitask takes --mesh-space; at 32^2 its bands would not split evenly
    with pytest.raises(ValueError, match="multiple of 32 x --mesh-space 2 = 64 for multitask_unet"):
        port_train.train(port_train.parse_args(CLI_ARGS + flag))
