"""The mesh's ``space`` axis for every other family and task: unet_plain, attention_unet and
dualdense_unet (binary and multiclass), unet_resnet50 (multiclass), multitask_unet.

Two kinds of case, as ``tests/test_torch_space.py``:

- In this process, shards as threads (``ThreadSpace``): each family's
  model in eval mode (BN pointwise) on 2 and 4 bands of a 64-row input
  against the unsplit model, outputs and gradients; attention_unet's
  decoder stage, whose upsample's output feeds both the gate and the
  concat, with that output's summed gradient held on its own; the band
  ``GlobalAvgPool`` against JAX's ``adaptive_avg_pool_1x1``.
- One 4-rank gloo job (``torch_parallel_worker.run_space_families``): every
  case's f32 eval and one SGD step on 1x2 and 2x2 meshes, against the
  1-process port and the JAX package's steps on its own 2x2 mesh, from the
  same variables; and multitask_unet's class logits in a train step with
  its dropout on, seeded by data index as the train CLI seeds it. The three
  families at ``base_channels`` 8 (``growth_rate`` 8), the ResNet-50 ones
  full width; 64^2, batch 4.
"""

from __future__ import annotations

import copy
import os
import threading

import flax.linen as flax_nn
import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_worker as worker
from test_torch_parallel import _dropout_is_identity
from test_torch_space import _Host, _seeded, band, on_shards, split_module_case
from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.models.unet_attention import AttentionUNet as JaxAttentionUNet
from unet_embroidery_seg_tpu.models.unet_dualdense import DualDenseUNet as JaxDualDenseUNet
from unet_embroidery_seg_tpu.models.unet_plain import UNetPlain as JaxUNetPlain
from unet_embroidery_seg_tpu.ops.resize import adaptive_avg_pool_1x1 as jax_avg_pool
from unet_embroidery_seg_tpu.parallel import make_mesh as jax_make_mesh
from unet_embroidery_seg_tpu.parallel import replicate as jax_replicate
from unet_embroidery_seg_tpu.parallel import shard_batch_arrays as jax_shard_batch_arrays
from unet_embroidery_seg_torch.models import blocks
from unet_embroidery_seg_torch.parallel import mesh as mesh_lib
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE, LR, K = 64, 1e-3, worker.FAMILY_K
JOB_TIMEOUT_S = 400
TOL = 1e-5  # f32, another summation order: a share of the reference's largest value
STAT_KEYS = ("running_mean", "running_var")
JAX_NARROW = {"unet_plain": JaxUNetPlain, "attention_unet": JaxAttentionUNet,
              "dualdense_unet": JaxDualDenseUNet}
# name -> (model, task): every family and task beyond unet_resnet50's binary one
CASES = {f"{m}/{t}": (m, t) for m in worker.NARROW for t in ("binary", "multiclass")}
CASES.update({"unet_resnet50/multiclass": ("unet_resnet50", "multiclass"),
              "multitask_unet/multitask": ("multitask_unet", "multitask")})
ILL_CONDITIONED = ("unet_resnet50/multiclass", "multitask_unet/multitask")  # see the SGD test


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _num_classes(task: str) -> int:
    return {"binary": 2, "multiclass": K, "multitask": 1}[task]


def _jax_model(name: str, task: str):
    k, diff = _num_classes(task), task == "binary"
    if name in JAX_NARROW:
        return JAX_NARROW[name](num_classes=k, diff_head=diff, **worker.NARROW[name])
    if name == "multitask_unet":
        return jax_build_model(name, num_classes=1, num_seg_classes=1, num_cls_classes=3)
    return jax_build_model(name, num_classes=k, diff_head=diff)


def _jax_variables(jmodel, seed: int) -> dict:
    """Numpy-drawn variables (He-scaled kernels, non-trivial BN statistics): O(1) logits."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init({"params": key, "dropout": key},
                                                jnp.zeros((1, SIZE, SIZE, 3)), train=False))
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

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _jax_on_mesh(case: dict, mesh) -> dict:
    """The JAX package's eval and SGD step for the case, sharded on ``mesh`` (its 2x2)."""
    jmodel, variables, task = case["jmodel"], case["variables"], case["task"]
    tx = optax.sgd(LR)
    state = jax.device_put(TrainState.create(jax.tree.map(jnp.asarray, variables), tx),
                           jax_replicate(mesh))
    ev = jax_shard_batch_arrays(mesh, *case["eval_batch"])
    sgd = jax_shard_batch_arrays(mesh, *case["sgd_batch"])
    rng, pw = jax.random.PRNGKey(1), case["pos_weight"]
    out = {}
    if task == "binary":
        loss, counts = jax_steps.make_binary_eval_step(jmodel, "bce", pw)(state, *ev)
        out["eval"] = {"loss": float(loss), "counts": np.asarray(counts).tolist()}
        state, loss = jax_steps.make_binary_train_step(jmodel, tx, "bce", pw)(state, *sgd, rng)
    elif task == "multiclass":
        loss, m = jax_steps.make_multiclass_eval_step(jmodel, K)(state, *ev)
        loss_sum, sums, n_valid = jax_steps.make_multiclass_persample_eval_step(jmodel, K)(
            state, *ev)
        out["eval"] = {"loss": float(loss), "metrics": worker._floats(m),
                       "per_sample": {"loss_sum": float(loss_sum), "n_valid": float(n_valid),
                                      **worker._floats(sums)}}
        state, loss = jax_steps.make_multiclass_train_step(jmodel, tx, K)(state, *sgd, rng)
    else:
        (loss, seg_l, cls_l), seg_counts, confusion = jax_steps.make_multitask_eval_step(
            jmodel, pos_weight=pw)(state, *ev)
        out["eval"] = {"loss": float(loss), "seg_loss": float(seg_l), "cls_loss": float(cls_l),
                       "seg_counts": np.asarray(seg_counts).tolist(),
                       "confusion": np.asarray(confusion).tolist()}
        with flax_nn.intercept_methods(_dropout_is_identity):
            step = jax_steps.make_multitask_train_step(jmodel, tx, pos_weight=pw)
            state, (loss, _, _), correct = step(state, *sgd, rng)
        out["correct"] = int(correct)
    out["sgd"] = (float(loss), state_dict_from_jax(case["model"], jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats})))
    return out


def _cases() -> tuple[dict, dict]:
    """(the ranks' inputs by case name, the JAX side's by case name)."""
    port, jax_side = {}, {}
    for i, (name, (model, task)) in enumerate(CASES.items()):
        jmodel = _jax_model(model, task)
        variables = _jax_variables(jmodel, i)
        case = {"model": model, "task": task, "num_classes": _num_classes(task), "lr": LR,
                "pos_weight": {"binary": 3.0, "multitask": 2.0}.get(task),
                "eval_batch": worker.task_batch(20 + i, [1, 1, 1, 0], task),
                "sgd_batch": worker.task_batch(40 + i, [1, 0, 1, 1], task)}
        port[name] = {**case, "state": state_dict_from_jax(model, variables)}
        jax_side[name] = {**case, "jmodel": jmodel, "variables": variables}
    return port, jax_side


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The 4 ranks' results, the 1-process port's, and JAX's 2x2 mesh's, by case."""
    tmp = tmp_path_factory.mktemp("space_families")
    port_cases, jax_cases = _cases()
    torch.save(port_cases, tmp / "inputs.pt")
    failures: list[BaseException] = []

    def run():
        try:
            mesh_lib.launch_local(worker.run_space_families, 4,
                                  (str(tmp / "inputs.pt"), str(tmp)), backend="gloo",
                                  timeout_s=JOB_TIMEOUT_S)
        except BaseException as e:  # noqa: BLE001 - raised again below, in the test's thread
            failures.append(e)

    thread = threading.Thread(target=run)
    thread.start()
    try:  # this process's references, while the ranks run
        out = {"port": worker.families_one_process(port_cases), "floor": {}}
        for name in ILL_CONDITIONED:
            case = port_cases[name]
            images, *rest = case["sgd_batch"]
            out["floor"][name] = [worker.family_sgd(
                {**case, "sgd_batch": (images * np.float32(1 + e), *rest)}, None)
                for e in (2.0 ** -23, -(2.0 ** -23))]
        jmesh = jax_make_mesh(n_data=2, n_space=2)
        out["jax"] = {name: _jax_on_mesh(case, jmesh) for name, case in jax_cases.items()}
    finally:
        thread.join(JOB_TIMEOUT_S + 60)
    assert not thread.is_alive(), "the 4-rank job did not end"
    if failures:
        raise failures[0]
    out["ranks"] = [torch.load(tmp / f"families_rank{r}.pt", weights_only=False)
                    for r in range(4)]
    for f in os.listdir(tmp):
        os.remove(tmp / f)
    return out


# --- the 4-rank job ---------------------------------------------------------------------------


def _exact_keys(task: str) -> tuple[str, ...]:
    return {"binary": ("counts",), "multiclass": ("metrics",),
            "multitask": ("seg_counts", "confusion")}[task]


@pytest.mark.parametrize("mesh", worker.FAMILY_MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_eval_equals_one_process_and_jax(job, case, mesh):
    # Counts, confusion and the metrics of summed integer tables exactly;
    # the per-sample metric sums exactly too (each image's tables summed
    # over its space group, the image counted by space index 0), except
    # over the 2x2 mesh's data axis, which sums two ranks' floats in another
    # order than one process (as tests/test_torch_parallel.py holds it);
    # losses to 1e-5.
    task = CASES[case][1]
    want, jax_want = job["port"][case]["eval"], job["jax"][case]["eval"]
    for r in job["ranks"]:
        got = r[case]["eval"][mesh]
        for key in _exact_keys(task):
            assert got[key] == want[key] == jax_want[key], (key, got[key], want[key])
        for ref in (want, jax_want):
            for key in ("loss", "seg_loss", "cls_loss"):
                if key in ref:
                    assert abs(got[key] - ref[key]) <= 1e-5 * max(1.0, abs(ref[key])), key
        if task == "multiclass":
            for ref in (want["per_sample"], jax_want["per_sample"]):
                for key, v in ref.items():
                    if mesh == "1x2" and key != "loss_sum":
                        assert got["per_sample"][key] == v, (key, got["per_sample"][key], v)
                    else:
                        np.testing.assert_allclose(got["per_sample"][key], v, rtol=1e-6,
                                                   atol=1e-6, err_msg=key)


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _state_err(a: dict, b: dict, keys: list) -> float:
    """The largest difference over ``keys``, as a share of ``b``'s largest value there."""
    scale = max(float(np.abs(np.asarray(b[k])).max()) for k in keys)
    return max(_max_abs(a[k], b[k]) for k in keys) / scale


# One f32 SGD step. The three families: the loss, the parameters and the BN
# statistics within TOL of the reference's largest value, against the
# 1-process port and JAX's 2x2 mesh. The ResNet-50 encoder at 64^2 is
# ill-conditioned (train-mode BN over 2x2 maps, ~50 layers deep): moving
# the input by one f32 ulp moves the updated parameters by ~1e-3 of their
# largest value. There, as chip_smoke.py holds the card against the CPU,
# each difference is held to 4x that floor (measured in this run: the
# 1-process step with the input moved one ulp up and down) plus TOL, and
# against JAX to the 1-process port's own distance from JAX plus as much.
@pytest.mark.parametrize("mesh", worker.FAMILY_MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_sgd_step_is_within_tol_of_one_process_and_jax(job, case, mesh):
    one, (jax_loss, jax_state) = job["port"][case]["sgd"], job["jax"][case]["sgd"]
    keys = [k for k in one["state"] if not k.endswith("num_batches_tracked")]
    groups = [[k for k in keys if k.endswith(STAT_KEYS) == stats] for stats in (False, True)]
    groups = [g for g in groups if g]  # the parameters, then the BN statistics
    floor = job["floor"].get(case)
    for r in job["ranks"]:
        got = r[case]["sgd"][mesh]
        if floor is None:
            for ref_loss, ref in ((one["loss"], one["state"]), (jax_loss, jax_state)):
                assert abs(got["loss"] - ref_loss) <= TOL * abs(ref_loss), (got["loss"], ref_loss)
                for g in groups:
                    assert _state_err(got["state"], ref, g) <= TOL, g[0]
            continue
        loss_floor = max(abs(f["loss"] - one["loss"]) for f in floor)
        loss_to_jax = abs(one["loss"] - jax_loss)
        assert abs(got["loss"] - one["loss"]) <= 4 * loss_floor + TOL * abs(one["loss"])
        assert abs(got["loss"] - jax_loss) <= loss_to_jax + 4 * loss_floor + TOL * abs(jax_loss)
        for g in groups:
            state_floor = max(_state_err(f["state"], one["state"], g) for f in floor)
            to_jax = _state_err(one["state"], jax_state, g)
            assert _state_err(got["state"], one["state"], g) <= 4 * state_floor + TOL, g[0]
            assert _state_err(got["state"], jax_state, g) <= to_jax + 4 * state_floor + TOL, g[0]
    if "correct" in one:
        assert [r[case]["sgd"][mesh]["correct"] for r in job["ranks"]] == [one["correct"]] * 4
        assert one["correct"] == job["jax"][case]["correct"]


@pytest.mark.parametrize("mesh", worker.FAMILY_MESHES)
@pytest.mark.parametrize("case", list(CASES))
def test_space_ranks_end_the_step_bit_equal(job, case, mesh):
    ranks = [r[case]["sgd"][mesh] for r in job["ranks"]]
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0]["state"].items():
            torch.testing.assert_close(r["state"][k], v, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("mesh", worker.FAMILY_MESHES)
def test_multitask_class_logits_are_equal_across_an_images_space_ranks(job, mesh):
    # Dropout on: each rank seeds it from (seed, data index), so the ranks
    # of one data index draw one mask and hold the same class logits, and
    # another data index draws another.
    got = [r["dropout"][mesh] for r in job["ranks"]]
    for r in got:
        assert 0.3 < r["dropped"] < 0.7
    groups = [(0, 1), (2, 3)]
    for a, b in groups:
        torch.testing.assert_close(got[b]["logits"], got[a]["logits"], rtol=0, atol=0)
    if mesh == "2x2":
        assert not torch.equal(got[0]["logits"], got[2]["logits"])


# --- shards as threads of this process -------------------------------------------------------


def _close(got, want, scale: float, what: str) -> None:
    err = float((got.detach().double() - want.detach().double()).abs().max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("size", [2, 4])
@pytest.mark.parametrize("name", list(worker.NARROW))
def test_family_on_bands_equals_the_unsplit_family(name, size):
    # Eval mode (BN pointwise), f32: outputs and the input's gradient to
    # 1e-5 of their scale; each parameter's gradient to 1e-5 of the
    # model's largest (psi's bias gradient in attention_unet is a sum of
    # nearly cancelling terms, far below the others).
    model = _seeded(worker.narrow_model(name, 3), 3).eval()
    x = torch.randn(2, 3, SIZE, 32, generator=torch.Generator().manual_seed(1))
    (y, dx, dp), (ys, dxs, dps) = split_module_case(model, (x,), size)
    assert ys.shape == y.shape
    _close(ys, y, float(y.abs().max()), "y")
    _close(dxs[0], dx[0], float(dx[0].abs().max()), "dx")
    scale = max(float(g.abs().max()) for g in dp.values())
    for k, g in dp.items():
        _close(dps[k], g, scale, k)


def _up_with_grad(stage: blocks.UpAttn, sink: dict):
    """``stage.up``'s output gradient, the sum of the gate's and the concat's, into ``sink``."""
    def hook(module, inputs, output):
        output.register_hook(lambda g: sink.__setitem__("g", g.detach().clone()))
    stage.up.register_forward_hook(hook)


@pytest.mark.parametrize("size", [2, 4])
def test_attention_stage_sums_the_upsample_gradient_over_a_band(size):
    stage = _seeded(blocks.UpAttn(8, 6, 6), 8).eval()
    x = torch.randn(2, 8, 8, 5, generator=torch.Generator().manual_seed(9))
    skip = torch.relu(torch.randn(2, 6, 16, 10, generator=torch.Generator().manual_seed(10)))
    whole = {}
    ref = copy.deepcopy(stage)
    _up_with_grad(ref, whole)
    y = ref(x.clone().requires_grad_(True), skip.clone().requires_grad_(True))
    gy = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    (y * gy).sum().backward()

    def shard(space):
        s = copy.deepcopy(stage)
        blocks.set_space_axis(_Host(s), space)
        mine = {}
        _up_with_grad(s, mine)
        xs = x[:, :, band(8, space.index, size)].clone().requires_grad_(True)
        ss = skip[:, :, band(16, space.index, size)].clone().requires_grad_(True)
        ys = s(xs, ss)
        (ys * gy[:, :, band(16, space.index, size)]).sum().backward()
        return ys.detach(), mine["g"], xs.grad

    parts = on_shards(shard, size)
    g = whole["g"]
    torch.testing.assert_close(torch.cat([p[1] for p in parts], 2), g, rtol=0,
                               atol=TOL * float(g.abs().max()))
    want = split_module_case(stage, (x, skip), size)
    (y0, dx0, _), (ys0, dxs0, _) = want
    _close(ys0, y0, float(y0.abs().max()), "y")
    for a, b in zip(dxs0, dx0):
        _close(a, b, float(b.abs().max()), "dx")


@pytest.mark.parametrize("size", [2, 4])
def test_band_global_avg_pool_equals_jax(size):
    x = torch.randn(3, 16, 8, 5, generator=torch.Generator().manual_seed(17))
    want = np.asarray(jax_avg_pool(jnp.asarray(x.permute(0, 2, 3, 1).numpy())))
    gy = torch.randn(3, 16, generator=torch.Generator().manual_seed(18))

    def shard(space):
        pool = blocks.GlobalAvgPool()
        pool.space = space
        xs = x[:, :, band(8, space.index, size)].clone().requires_grad_(True)
        y = pool(xs)
        (y * gy * float(space.first)).sum().backward()  # the loss counted once, by index 0
        return y.detach(), xs.grad

    parts = on_shards(shard, size)
    for y, _ in parts:  # every rank holds the whole image's mean
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-7)
    dx = torch.cat([p[1] for p in parts], 2)
    torch.testing.assert_close(dx, (gy / (8 * 5))[:, :, None, None].expand_as(x), rtol=1e-6,
                               atol=0)


def test_a_band_that_the_unsplit_model_would_resize_or_pool_unevenly_raises():
    def shard(space):
        stage = blocks.UpPlain(4, 4, 4)
        blocks.set_space_axis(_Host(stage), space)
        with pytest.raises(ValueError, match="deepest stride x --mesh-space"):
            stage(torch.randn(1, 4, 3, 4), torch.randn(1, 4, 5, 8))
        pool = blocks.down(torch.nn.Identity())
        blocks.set_space_axis(_Host(pool), space)
        with pytest.raises(ValueError, match="not a multiple of the stride 2"):
            pool(torch.randn(1, 4, 3, 4))
        return True

    assert on_shards(shard, 2) == [True, True]
