"""The port's device-resident input path against the JAX package, in float32 on the CPU.

``data/cache.py`` and ``epoch_index_plan`` are held to JAX's exactly. The
train chunk (K = 3 steps of unet_resnet50 at 64^2, batch 2, augmentation
off) is held bit for bit to the port's own host-fed step loop on the same
batches, and to JAX's ``make_train_chunk_fn`` from the same weights
(``state_dict_from_jax``): step 1 to f32 rounding, later steps and the
parameters as close as stock PyTorch ops land (the yardstick of
``tests/test_torch_train.py::test_train_steps_match_jax``). The eval chunk's
counts and metrics equal the port's host-fed eval and JAX's eval chunk.
Weights are drawn by numpy from a seed (He-scaled kernels), so logits are
O(1) and no count sits on a rounding edge.
"""

import contextlib
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.data.cache import CanvasCache as JaxCanvasCache
from unet_embroidery_seg_tpu.data.sources import SyntheticSource as JaxSyntheticSource
from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import resident as jax_resident
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch.data.cache import CanvasCache
from unet_embroidery_seg_torch.data.dataset import DataLoader, SegmentationDataset
from unet_embroidery_seg_torch.data.sources import SyntheticSource
from unet_embroidery_seg_torch.data.synthetic import resident_canvases
from unet_embroidery_seg_torch.engine import resident, steps
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.ops import device_augment, schedules
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE, BATCH, K, LR = 64, 2, 3, 1e-4
MC_CLASSES = 5


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


MODELS = {  # task -> (model, size, JAX build kwargs, port build args)
    "binary": ("unet_resnet50", SIZE, {"num_classes": 2, "diff_head": True},
               {"num_classes": 2, "diff_head": True}),
    "multiclass": ("unet_plain", 32, {"num_classes": MC_CLASSES}, {"num_classes": MC_CLASSES}),
    "multitask": ("multitask_unet", SIZE, {"num_classes": 1, "num_seg_classes": 1,
                                           "num_cls_classes": 3}, {"num_classes": 1}),
}
_refs: dict = {}


def _ref(task: str) -> dict:
    """The JAX model of ``task`` and its seeded variables, built once."""
    if task not in _refs:
        name, size, jkw, _ = MODELS[task]
        jmodel = jax_build_model(name, **jkw)
        key = jax.random.PRNGKey(0)
        shapes = jax.eval_shape(lambda: jmodel.init(
            {"params": key, "dropout": key}, jnp.zeros((1, size, size, 3)), train=False))
        _refs[task] = {"jmodel": jmodel, "variables": _seeded(dict(shapes), seed=0)}
    return _refs[task]


def _port_model(task: str):
    name, _, _, pkw = MODELS[task]
    model = build_model(name, device="cpu", **pkw)
    model.load_state_dict(state_dict_from_jax(name, _ref(task)["variables"]), strict=True)
    return model


def _tensors(cache) -> tuple:
    return tuple(None if a is None else torch.from_numpy(np.array(a))
                 for a in (cache.images, cache.masks, cache.valid_wh, cache.cls_labels))


# --- cache and plan ---------------------------------------------------------


@pytest.mark.parametrize("return_cls_label", [False, True])
def test_canvas_cache_equals_jax(return_cls_label):
    want = JaxCanvasCache(JaxSyntheticSource(split="train", length=5), (48, 40),
                          return_cls_label=return_cls_label, verbose=False)
    got = CanvasCache(SyntheticSource(split="train", length=5), (48, 40),
                      return_cls_label=return_cls_label, verbose=False)
    assert len(got) == len(want) == 5
    for k in ("images", "masks", "valid_wh", "cls_labels"):
        a, b = getattr(got, k), getattr(want, k)
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("n,batch,epoch,shuffle,seed,max_batches", [
    (10, 4, 0, False, 0, None), (10, 4, 2, True, 7, None), (32, 8, 3, True, 11, None),
    (64, 8, 0, False, 0, 2), (7, 3, 5, True, 11, 0), (1, 4, 1, True, 3, None)])
def test_epoch_index_plan_equals_jax(n, batch, epoch, shuffle, seed, max_batches):
    want = jax_resident.epoch_index_plan(n, batch, epoch, shuffle, seed, max_batches)
    got = resident.epoch_index_plan(n, batch, epoch, shuffle, seed, max_batches)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_upload_and_gather_keep_the_arrays():
    cache = resident_canvases(5, 32, seed=1, cls_labels=True)
    data = resident.upload(cache, "cpu")
    assert data.n == 5 and data.nbytes == sum(
        a.nbytes for a in (cache.images, cache.masks, cache.valid_wh, cache.cls_labels))
    idx, _ = resident.upload_plan(*resident.epoch_index_plan(5, 4, 0, True, 11), "cpu")
    for got, want in zip(resident.gather_batch(data, idx[1]), _tensors(cache)):
        torch.testing.assert_close(got, want[idx[1].long()], rtol=0, atol=0)


def test_step_seeds_extend_the_host_loops_seed():
    for seed, epoch, it in ((11, 0, 0), (3, 4, 17)):
        host = int(np.random.SeedSequence((seed, epoch, it)).generate_state(1)[0])
        dropout, aug = resident.step_seeds(seed, epoch, it)
        assert dropout == host and aug != host


# --- train chunk ------------------------------------------------------------


def _plan(n: int, seed: int = 11):
    idx, mask = resident.epoch_index_plan(n, BATCH, 0, True, seed)
    return idx, mask, *resident.upload_plan(idx, mask, "cpu")


def _port_train_step(task, model):
    opt = schedules.make_train_optimizer(model.parameters(), LR, momentum=0.9, weight_decay=1e-4)
    if task == "multitask":
        return steps.make_multitask_train_step(model, opt, "bce", amp=False)
    return steps.make_binary_train_step(model, opt, "lovasz_hinge", amp=False)


@pytest.mark.parametrize("task", ["binary", "multitask"])
def test_train_chunk_equals_the_host_fed_loop_bit_for_bit(task):
    # Augmentation off: the chunk's batches are the canvases, normalised; the
    # host-fed loop gets the same batches as numpy, one step at a time,
    # seeded by the same (seed, epoch, step) rule (multitask's dropout is on).
    cache = resident_canvases(2 * K, SIZE, seed=2, cls_labels=task == "multitask")
    data = resident.upload(cache, "cpu")
    idx, mask, idx_t, mask_t = _plan(data.n)
    chunked, looped = _port_model(task), _port_model(task)
    chunk = resident.make_train_chunk_fn(_port_train_step(task, chunked), (SIZE, SIZE), True, 2,
                                         multitask=task == "multitask", augment=False, seed=11)
    got = chunk(data, idx_t, mask_t, 0, range(K))
    step = _port_train_step(task, looped)
    want = []
    for k in range(K):
        images, pngs = device_augment.preprocess_eval_batch(
            torch.from_numpy(cache.images[idx[k]]), torch.from_numpy(cache.masks[idx[k]]))
        resident.seed_default_generator(torch.device("cpu"), resident.step_seeds(11, 0, k)[0])
        if task == "multitask":
            losses, correct = step(images.numpy(), pngs.numpy(), cache.cls_labels[idx[k]],
                                   mask[k])
            want.append([*(v.item() for v in losses), float(correct)])
        else:
            want.append(step(images.numpy(), pngs.numpy(), mask[k]).item())
    if task == "multitask":
        assert len(got) == 4 and all(t.shape == (K,) for t in got)
        got = torch.stack(got).T
    np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32))
    for (k, a), b in zip(chunked.state_dict().items(), looped.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def _stock_conv3x3_bias_relu(x, weight, bias):
    return torch.relu(F.conv2d(x, weight, bias, padding=1))


def _stock_upsample2x(x, align_corners):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=align_corners)


def _param_spread(a: dict, b: dict) -> tuple[float, float, float]:
    """(mean, share above 0.1, max) of |a - b| / lr over every parameter element."""
    d = torch.cat([(a[k] - b[k]).abs().flatten() / LR for k in b
                   if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))])
    return d.mean().item(), (d > 0.1).float().mean().item(), d.max().item()


def test_train_chunk_matches_jax_chunk():
    ref = _ref("binary")
    cache = resident_canvases(2 * K, SIZE, seed=3)
    idx, mask, idx_t, mask_t = _plan(len(cache))
    tx = jax_schedules.make_train_optimizer(LR, momentum=0.9, weight_decay=1e-4,
                                            param_dtype=jnp.float32)
    state = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]), tx)
    jchunk = jax_resident.make_train_chunk_fn(
        jax_steps.make_binary_train_step(ref["jmodel"], tx, "lovasz_hinge", None),
        (SIZE, SIZE), True, 2, augment=False)
    state, jlosses = jchunk(state, jax_resident.upload(cache), idx, mask,
                            np.arange(K, dtype=np.int32), jax.random.PRNGKey(1))
    jax_sd = state_dict_from_jax("unet_resnet50", jax.tree.map(
        np.asarray, {"params": state.opt_state.master, "batch_stats": state.batch_stats}))

    runs = {}
    for name in ("port", "stock"):
        model = _port_model("binary")
        chunk = resident.make_train_chunk_fn(_port_train_step("binary", model), (SIZE, SIZE),
                                             True, 2, augment=False)
        with contextlib.ExitStack() as stack:
            if name == "stock":  # the kernels' Functions swapped for stock PyTorch ops
                stack.enter_context(mock.patch.object(blocks, "conv3x3_bias_relu",
                                                      _stock_conv3x3_bias_relu))
                stack.enter_context(mock.patch.object(blocks, "upsample2x", _stock_upsample2x))
            losses = chunk(resident.upload(cache, "cpu"), idx_t, mask_t, 0, range(K))
        runs[name] = (losses.numpy(), model.state_dict())
    want = np.asarray(jlosses)
    port, stock = runs["port"][0], runs["stock"][0]
    np.testing.assert_allclose(port[0], want[0], rtol=1e-5)  # identical weights at step 1
    assert (np.abs(port - want) <= 2 * np.abs(stock - want) + 1e-5 * np.abs(want)).all(), (
        port, stock, want)
    mean, share, biggest = _param_spread(runs["port"][1], jax_sd)
    s_mean, s_share, _ = _param_spread(runs["stock"][1], jax_sd)
    assert biggest <= 2.0 * K + 0.01
    assert mean <= 2 * s_mean + 1e-3 and share <= 2 * s_share + 1e-4, (mean, share, s_mean, s_share)


# --- eval chunk -------------------------------------------------------------


def _jax_eval_step(task, jmodel):
    if task == "binary":
        return jax_steps.make_binary_eval_step(jmodel, "lovasz_hinge")
    if task == "multitask":
        return jax_steps.make_multitask_eval_step(jmodel, "bce")
    return jax_steps.make_multiclass_eval_step(jmodel, MC_CLASSES)


def _port_eval_step(task, model):
    if task == "binary":
        return steps.make_binary_eval_step(model, "lovasz_hinge", amp=False)
    if task == "multitask":
        return steps.make_multitask_eval_step(model, "bce", amp=False)
    return steps.make_multiclass_eval_step(model, MC_CLASSES, amp=False)


@pytest.mark.parametrize("task", ["binary", "multiclass", "multitask"])
def test_eval_chunk_equals_host_fed_eval_and_jax(task):
    name, size, _, _ = MODELS[task]
    multitask = task == "multitask"
    binary = task != "multiclass"
    mask_classes = 1 if binary else 7  # multiclass: labels >= K become the ignore class
    src = SyntheticSource(split="validation", length=5, mask_classes=mask_classes)
    model = _port_model(task)
    eval_step = _port_eval_step(task, model)

    # the port: resident (5 canvases in 3 batches of 2, the last padded) ...
    cache = CanvasCache(src, (size, size), return_cls_label=multitask, verbose=False)
    data = resident.upload(cache, "cpu")
    chunk = resident.make_eval_chunk_fn(eval_step, binary, MC_CLASSES,
                                        multitask=multitask)
    idx, mask = resident.epoch_index_plan(data.n, BATCH, 0, False, 11)
    outs = chunk(data, *resident.upload_plan(idx, mask, "cpu"))
    got = port_train.run_eval_resident(chunk, data, BATCH, 11, None, task)
    # ... and host-fed: the letterboxed split through the host loader
    ds = SegmentationDataset(src, (size, size), 2 if binary else MC_CLASSES, augmentation=False,
                             task="binary" if binary else "multiclass",
                             return_cls_label=multitask)
    want = port_train.run_eval(eval_step, DataLoader(ds, BATCH, shuffle=False, prefetch=0),
                               None, task)
    assert got.keys() == want.keys()
    for k in got:
        if k == "Loss":  # host batches are x / 255, resident ones x * (1 / 255): an ulp apart
            assert got[k] == pytest.approx(want[k], rel=1e-5)
        else:
            assert got[k] == want[k], k

    # JAX's eval chunk on JAX's cache of the same source
    ref = _ref(task)
    jcache = JaxCanvasCache(JaxSyntheticSource(split="validation", length=5,
                                               mask_classes=mask_classes),
                            (size, size), return_cls_label=multitask, verbose=False)
    state = TrainState.create(jax.tree.map(jnp.asarray, ref["variables"]),
                              jax_schedules.make_optimizer(1e-4))
    jchunk = jax_resident.make_eval_chunk_fn(_jax_eval_step(task, ref["jmodel"]), (size, size),
                                             binary, MC_CLASSES, multitask=multitask)
    jouts = jchunk(state, jax_resident.upload(jcache), idx, mask)
    if task == "binary":
        np.testing.assert_array_equal(outs[1].numpy(), np.asarray(jouts[1]))
    elif task == "multitask":
        np.testing.assert_array_equal(outs[1].numpy(), np.asarray(jouts[1]))
        np.testing.assert_array_equal(outs[2].numpy(), np.asarray(jouts[2]))
    else:
        assert outs[1].keys() == jouts[1].keys()
        for k, v in outs[1].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jouts[1][k]), rtol=0, atol=1e-6,
                                       err_msg=k)
    losses = outs[0][0] if multitask else outs[0]
    jlosses = np.asarray(jouts[0][0] if multitask else jouts[0])
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-4)
