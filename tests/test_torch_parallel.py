"""Data parallelism (the JAX mesh's ``data`` axis) in the port: 2 gloo ranks on the CPU.

One 2-rank job (``torch.multiprocessing``, spawn, a file store under a
fresh temporary directory) computes every case of ``torch_parallel_worker``
on its rows of a global batch of 4; this process computes the same cases
in one process on the whole batch (the port's single-device code), and the
JAX package's single-device and mesh (``make_mesh(n_data=2)``: two of the
eight virtual CPU devices) steps on the same weights. unet_resnet50 (and
multitask_unet) at 64^2, f32, SGD for one step (so parameters differ by
lr times the gradients' difference, as ``tests/test_engine.py``'s sharded
step test), Adam over a resident chunk.
"""

from __future__ import annotations

import shutil
import threading
import time

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as flax_nn

import torch_parallel_worker as worker
from unet_embroidery_seg_tpu.engine import TrainState
from unet_embroidery_seg_tpu.engine import steps as jax_steps
from unet_embroidery_seg_tpu.models import build_model as jax_build_model
from unet_embroidery_seg_tpu.parallel import make_mesh as jax_make_mesh
from unet_embroidery_seg_tpu.parallel import replicate as jax_replicate
from unet_embroidery_seg_tpu.parallel import shard_batch_arrays as jax_shard_batch_arrays
from unet_embroidery_seg_torch.parallel import mesh as mesh_lib
from unet_embroidery_seg_torch.utils.interop import state_dict_from_jax

SIZE, BATCH, K = 64, 4, 4  # K: multiclass outputs (3 classes + the ignore class index K)
LR = 1e-3  # SGD; Adam (resident chunk) at the train CLI's 1e-4
JOB_TIMEOUT_S = 300
STAT_KEYS = ("running_mean", "running_var")
SGD_CASES = ("bce_tail", "lovasz", "multiclass_ce_dice", "multitask")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _seeded_variables(jmodel, seed: int) -> dict:
    """numpy weights of ``jmodel``'s shapes from a seed: He-scaled kernels, BN statistics
    away from 0 and 1."""
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": key, "dropout": key}, jnp.zeros((1, SIZE, SIZE, 3)), train=False))
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


def _batch(seed: int, sample_mask, kind: str = "binary"):
    """A global batch: images, targets (disc masks, or blocky K-class maps with ignore pixels),
    multitask's class labels, the sample mask."""
    rng = np.random.RandomState(seed)
    images = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    if kind == "multiclass":
        coarse = rng.randint(0, K, (BATCH, 4, 4))
        pngs = np.kron(coarse, np.ones((16, 16), np.int64)).astype(np.int32)
        pngs[rng.rand(BATCH, SIZE, SIZE) < 0.02] = K
    else:
        yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
        cx, cy, r = rng.uniform(0.2, 0.8, (3, BATCH, 1, 1))
        pngs = (((xx - cx) ** 2 + (yy - cy) ** 2) < (0.5 * r) ** 2).astype(np.int32)
    sm = np.asarray(sample_mask, np.float32)
    if kind == "multitask":
        return images, pngs, rng.randint(0, 3, BATCH).astype(np.int32), sm
    return images, pngs, sm


def _dropout_is_identity(next_fun, args, kwargs, context):
    if isinstance(context.module, flax_nn.Dropout) and context.method_name == "__call__":
        return args[0]
    return next_fun(*args, **kwargs)


def _bn_inputs() -> dict:
    rng = np.random.RandomState(5)
    c = 8

    def t(a):
        return torch.from_numpy(a.astype(np.float32))

    return {"x": (2.0 * rng.randn(BATCH, c, 6, 6) + 0.5).astype(np.float32),
            "gy": rng.randn(BATCH, c, 6, 6).astype(np.float32),
            "bn_state": {"weight": t(rng.uniform(0.5, 1.5, c)), "bias": t(0.1 * rng.randn(c)),
                         "running_mean": t(0.1 * rng.randn(c)),
                         "running_var": t(rng.uniform(0.5, 1.5, c)),
                         "num_batches_tracked": torch.tensor(0)}}


def _flax_bn(case: dict) -> dict:
    """flax's BatchNorm (the JAX package's settings) on the global batch, and its gradients."""
    bn = flax_nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    s = case["bn_state"]
    params = {"scale": jnp.asarray(s["weight"].numpy()), "bias": jnp.asarray(s["bias"].numpy())}
    stats = {"mean": jnp.asarray(s["running_mean"].numpy()),
             "var": jnp.asarray(s["running_var"].numpy())}
    x = jnp.asarray(case["x"].transpose(0, 2, 3, 1))
    gy = jnp.asarray(case["gy"].transpose(0, 2, 3, 1))

    def apply(x, params):
        return bn.apply({"params": params, "batch_stats": stats}, x, mutable=["batch_stats"])

    y, new = apply(x, params)
    dx, dparams = jax.grad(lambda x, p: jnp.sum(apply(x, p)[0] * gy), argnums=(0, 1))(x, params)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "dx": nchw(dx), "dw": np.asarray(dparams["scale"]),
            "db": np.asarray(dparams["bias"]),
            "running_mean": np.asarray(new["batch_stats"]["mean"]),
            "running_var": np.asarray(new["batch_stats"]["var"])}


def _cases() -> tuple[dict, dict]:
    """(the port's cases, name -> (kind, inputs); the JAX models and variables by case)."""
    binary_model = jax_build_model("unet_resnet50", num_classes=2, diff_head=True)
    mc_model = jax_build_model("unet_resnet50", num_classes=K)
    mt_model = jax_build_model("multitask_unet", num_classes=1, num_seg_classes=1,
                               num_cls_classes=3)
    variables = {"binary": _seeded_variables(binary_model, 0),
                 "multiclass": _seeded_variables(mc_model, 1),
                 "multitask": _seeded_variables(mt_model, 2)}
    states = {"binary": state_dict_from_jax("unet_resnet50", variables["binary"]),
              "multiclass": state_dict_from_jax("unet_resnet50", variables["multiclass"]),
              "multitask": state_dict_from_jax("multitask_unet", variables["multitask"])}
    # rank 1 holds the whole padded tail in "bce_tail"
    sgd = {
        "bce_tail": dict(task="binary", model="unet_resnet50", num_classes=2, loss="bce",
                         pos_weight=3.0, batch=_batch(10, [1, 1, 0, 0])),
        "lovasz": dict(task="binary", model="unet_resnet50", num_classes=2,
                       loss="lovasz_hinge", pos_weight=None, batch=_batch(11, [1, 1, 1, 1])),
        "multiclass_ce_dice": dict(task="multiclass", model="unet_resnet50", num_classes=K,
                                   batch=_batch(12, [1, 1, 1, 0], "multiclass")),
        "multitask": dict(task="multitask", model="multitask_unet", num_classes=1, loss="bce",
                          pos_weight=2.0, batch=_batch(13, [1, 0, 1, 1], "multitask")),
    }
    jax_side = {}
    port = {"bn": ("bn", _bn_inputs())}
    for name, case in sgd.items():
        key = case["task"]
        port[name] = ("sgd", {**case, "state": states[key], "lr": LR})
        jax_side[name] = {**case, "jmodel": {"binary": binary_model, "multiclass": mc_model,
                                             "multitask": mt_model}[key],
                          "variables": variables[key]}
    port["eval"] = ("eval", {
        "binary": {"state": states["binary"], "pos_weight": 3.0,
                   "batch": _batch(20, [1, 1, 1, 0])},
        "multiclass": {"state": states["multiclass"], "num_classes": K,
                       "batch": _batch(21, [1, 0, 1, 1], "multiclass")},
        "multitask": {"state": states["multitask"], "batch": _batch(22, [1, 1, 1, 0],
                                                                   "multitask")}})
    port["resident"] = ("resident", {"state": states["binary"], "lr": 1e-4, "size": SIZE,
                                     "batch_size": BATCH})
    return port, jax_side


def _jax_sgd_step(case: dict, mesh) -> tuple[float, dict]:
    """The JAX package's train step with ``optax.sgd``: single device, or sharded on ``mesh``."""
    tx = optax.sgd(LR)
    state = TrainState.create(jax.tree.map(jnp.asarray, case["variables"]), tx)
    batch = tuple(jnp.asarray(a) for a in case["batch"])
    if mesh is not None:
        state = jax.device_put(state, jax_replicate(mesh))
        batch = jax_shard_batch_arrays(mesh, *case["batch"])
    rng = jax.random.PRNGKey(1)
    jmodel = case["jmodel"]
    if case["task"] == "binary":
        step = jax_steps.make_binary_train_step(jmodel, tx, case["loss"], case["pos_weight"])
        state, loss = step(state, *batch, rng)
    elif case["task"] == "multiclass":
        step = jax_steps.make_multiclass_train_step(jmodel, tx, K, focal=False, use_dice=True)
        state, loss = step(state, *batch, rng)
    else:
        with flax_nn.intercept_methods(_dropout_is_identity):
            step = jax_steps.make_multitask_train_step(jmodel, tx, seg_loss_name=case["loss"],
                                                       pos_weight=case["pos_weight"])
            state, (loss, _, _), _ = step(state, *batch, rng)
    name = case["model"]
    return float(loss), state_dict_from_jax(name, jax.tree.map(
        np.asarray, {"params": state.params, "batch_stats": state.batch_stats}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ranks": [rank 0's, rank 1's results], "port": 1-process results, "jax", "jax_mesh"}.

    The ranks delete the inputs once read, the results are deleted as they
    are read, and the module's directory goes whatever happens.
    """
    tmp = tmp_path_factory.mktemp("parallel")
    try:
        port_cases, jax_cases = _cases()
        torch.save(port_cases, tmp / "inputs.pt")
        failures: list[BaseException] = []

        def job():
            try:
                mesh_lib.launch_local(worker.run, 2, (str(tmp / "inputs.pt"), str(tmp)),
                                      backend="gloo", timeout_s=JOB_TIMEOUT_S)
            except BaseException as e:  # noqa: BLE001 - raised again below, in the test's thread
                failures.append(e)

        thread = threading.Thread(target=job)
        thread.start()
        try:  # this process's references, while the ranks run
            port = {name: worker.run_case(kind, case, None)
                    for name, (kind, case) in port_cases.items()}
            jmesh = jax_make_mesh(n_data=2)
            out = {"port": port, "flax_bn": _flax_bn(port_cases["bn"][1]),
                   "jax": {n: _jax_sgd_step(c, None) for n, c in jax_cases.items()},
                   "jax_mesh": {n: _jax_sgd_step(c, jmesh) for n, c in jax_cases.items()}}
        finally:
            thread.join(JOB_TIMEOUT_S + 60)
        assert not thread.is_alive(), "the 2-rank job did not end"
        if failures:
            raise failures[0]
        out["ranks"] = worker.load_results([tmp / f"rank{r}.pt" for r in (0, 1)])
        out["init"] = {name: case["state"] for name, (kind, case) in port_cases.items()
                       if kind == "sgd"}
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


HOST_CASES = ("bce_tail", "lovasz")  # bce_tail: ranks 2 and 3 hold only padded rows
HOST_RANKS = 4


@pytest.fixture(scope="module")
def two_host_ranks(runs, tmp_path_factory):
    """The results of a 4-rank gloo job joined by an explicit ``file://`` address as two
    hosts of two CPU devices each (``torch_parallel_worker.run_on_two_hosts``), by rank."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("two_hosts")
    try:
        port_cases, _ = _cases()
        torch.save({n: port_cases[n] for n in HOST_CASES}, tmp / "inputs.pt")
        ctx = mp.start_processes(
            worker.run_on_two_hosts,
            args=(f"file://{tmp / 'store'}", HOST_RANKS, str(tmp / "inputs.pt"), str(tmp)),
            nprocs=HOST_RANKS, join=False, start_method="spawn")
        deadline = time.monotonic() + JOB_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                assert time.monotonic() < deadline, "the 4-rank job did not end"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        return worker.load_results([tmp / f"host_rank{r}.pt" for r in range(HOST_RANKS)])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _cat(ranks: list, *path) -> torch.Tensor:
    def get(r):
        for p in path:
            r = r[p]
        return r
    return torch.cat([get(r) for r in ranks])


# --- the mesh helpers ----------------------------------------------------------------------


def test_init_multihost_is_a_noop_without_peers(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mesh_lib.init_multihost() == 0
    assert not torch.distributed.is_initialized()
    mesh = mesh_lib.make_mesh(devices=[torch.device("cpu")])
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)


def test_space_axis_raises_naming_the_roadmap():
    # The space axis is ported: a 1x2 mesh on one device raises as JAX's make_mesh does.
    with pytest.raises(ValueError, match=r"mesh \(1x2\) needs 2 devices, have 1"):
        mesh_lib.make_mesh(n_space=2, devices=[torch.device("cpu")])


@pytest.mark.parametrize("n_data,n_devices,match", [(4, 2, r"mesh \(4x1\) needs 4 devices, have 2"),
                                                     (2, 2, "needs 2 processes, this job has 1")])
def test_make_mesh_refuses_what_it_cannot_hold(n_data, n_devices, match):
    with pytest.raises(ValueError, match=match):
        mesh_lib.make_mesh(n_data=n_data, devices=[torch.device("cpu")] * n_devices)


@pytest.mark.parametrize("rank", [0, 1])
def test_shard_batch_arrays_rows_are_the_jax_data_shards(rank):
    images, pngs, sm = _batch(3, [1, 1, 1, 0])
    jmesh = jax_make_mesh(n_data=2)
    mesh = mesh_lib.Mesh(rank, 2, torch.device("cpu"), None)
    device = jmesh.devices[rank, 0]
    for ours, theirs in zip(mesh_lib.shard_batch_arrays(mesh, images, pngs, sm),
                            jax_shard_batch_arrays(jmesh, images, pngs, sm)):
        shard = [s for s in theirs.addressable_shards if s.device == device]
        np.testing.assert_array_equal(ours, np.asarray(shard[0].data))
    assert mesh_lib.global_batch_from_local(mesh, images, None) == (images, None)


def test_explicit_address_job_on_two_hosts_builds_its_mesh(two_host_ranks):
    # Each rank sees its host's two devices; the mesh spans both hosts'.
    # Before the repair every rank raised "mesh (4x1) needs 4 devices, have 2".
    got = [r["mesh"] for r in two_host_ranks]
    assert got == [{"rank": r, "world_size": HOST_RANKS, "local_rank": r % 2,
                    "local_world_size": 2} for r in range(HOST_RANKS)]


@pytest.mark.parametrize("case", HOST_CASES)
def test_two_host_sgd_step_equals_one_process(runs, two_host_ranks, case):
    want = runs["port"][case]
    for r in two_host_ranks:
        np.testing.assert_allclose(r[case]["loss"], want["loss"], rtol=1e-6)
        for k in _float_keys(want["state"]):
            np.testing.assert_allclose(r[case]["state"][k].numpy(), want["state"][k].numpy(),
                                       atol=1e-5, rtol=1e-4, err_msg=k)


def test_a_failing_rank_fails_the_launch():
    # Rank 1 raises while rank 0 waits in a barrier: the launch raises (the
    # first error to arrive: rank 1's, or rank 0's broken connection) and
    # stops the survivor, long before the collective's own timeout.
    import torch.multiprocessing as mp

    t0 = time.monotonic()
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException)):
        mesh_lib.launch_local(worker.fail_on_rank, 2, (1,), backend="gloo", timeout_s=120)
    assert time.monotonic() - t0 < 60


# --- BatchNorm over the group ----------------------------------------------------------------


@pytest.mark.parametrize("what", ["y", "dx", "dw", "db", "running_mean", "running_var"])
def test_synchronised_batchnorm_equals_one_process_and_flax(runs, what):
    ranks = [r["bn"] for r in runs["ranks"]]
    if what in ("y", "dx"):
        got = _cat(ranks, what)
    elif what in ("dw", "db"):  # each rank's share of the parameter gradient
        got = ranks[0][what] + ranks[1][what]
    else:  # both ranks hold the global statistics
        torch.testing.assert_close(ranks[0][what], ranks[1][what], rtol=0, atol=0)
        got = ranks[0][what]
    torch.testing.assert_close(got, runs["port"]["bn"][what], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), runs["flax_bn"][what], rtol=1e-5, atol=1e-5)


# --- one SGD step ------------------------------------------------------------------------------
#
# At 64^2 this model magnifies f32 rounding (train-mode BN over the 16
# values per channel of the 2x2 bottom map; the encoder's gradients 2-5%
# apart between any two summation orders), so the JAX package's own mesh
# step departs from its single-device step on these inputs by more than
# its mesh test's tolerance (atol 1e-5, rtol 1e-4): BN statistics by up to
# 1e-4, multitask_unet's first conv by 1.7e-3 after one step. Each
# comparison below is held to that tolerance, widened only to twice JAX's
# own largest mesh-vs-single difference (parameters and statistics apart);
# the binary and multiclass ranks meet the tolerance itself, element by
# element, against the 1-process port.


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def _float_keys(state: dict):
    return [k for k, v in state.items() if not k.endswith("num_batches_tracked")]


@pytest.mark.parametrize("case", [c for c in SGD_CASES if c != "multitask"])
def test_two_rank_sgd_step_equals_one_process(runs, case):
    got, want = runs["ranks"][0][case], runs["port"][case]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    for k in _float_keys(want["state"]):
        np.testing.assert_allclose(got["state"][k].numpy(), want["state"][k].numpy(),
                                   atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("against", ["port", "jax", "jax_mesh"])
@pytest.mark.parametrize("case", SGD_CASES)
def test_two_rank_sgd_step_is_as_close_as_jax_is_to_itself(runs, case, against):
    got = runs["ranks"][0][case]
    want_loss, want_state = ((runs["port"][case]["loss"], runs["port"][case]["state"])
                             if against == "port" else runs[against][case])
    (jl, js), (ml, ms) = runs["jax"][case], runs["jax_mesh"][case]
    rtol = 1e-6 if against == "port" else 1e-5
    assert abs(got["loss"] - want_loss) <= max(rtol * abs(want_loss), 2 * abs(ml - jl)), \
        (got["loss"], want_loss, jl, ml)
    for stats in (False, True):  # the parameters, then the BN statistics
        keys = [k for k in _float_keys(js) if k.endswith(STAT_KEYS) == stats]
        ours = max(_max_abs(got["state"][k], want_state[k]) for k in keys)
        scale = max(float(np.abs(np.asarray(want_state[k])).max()) for k in keys)
        jax_own = max(_max_abs(ms[k], js[k]) for k in keys)
        assert ours <= max(1e-5 + 1e-4 * scale, 2 * jax_own), (stats, ours, jax_own)


def _update_rel(state, ref, init) -> float:
    """||update - reference update|| / ||reference update|| over every parameter."""
    num = den = 0.0
    for k, p0 in init.items():
        if not torch.is_floating_point(p0) or k.endswith(STAT_KEYS):
            continue
        du = torch.as_tensor(np.asarray(ref[k])) - p0
        num += float(((torch.as_tensor(np.asarray(state[k])) - p0) - du).norm()) ** 2
        den += float(du.norm()) ** 2
    return (num / den) ** 0.5


@pytest.mark.parametrize("case", SGD_CASES)
def test_two_rank_sgd_update_has_the_one_process_scale(runs, case):
    # A gradient off by the world size on part of the loss (a local
    # normaliser, the all-reduce's backward, DDP's average) moves the update
    # by a large share of its size; two summation orders, by a few percent.
    init = runs["init"][case]
    ours = _update_rel(runs["ranks"][0][case]["state"], runs["port"][case]["state"], init)
    jax_own = _update_rel(runs["jax_mesh"][case][1], runs["jax"][case][1], init)
    assert ours <= 2 * jax_own + 0.02, (ours, jax_own)


@pytest.mark.parametrize("case", SGD_CASES)
def test_ranks_end_the_step_bit_equal(runs, case):
    a, b = (r[case] for r in runs["ranks"])
    assert a["loss"] == b["loss"]
    for k, v in a["state"].items():
        torch.testing.assert_close(b["state"][k], v, rtol=0, atol=0, msg=k)


# --- eval, the resident chunk, Adam ------------------------------------------------------------


@pytest.mark.parametrize("task", ["binary", "multiclass", "multiclass_per_sample",
                                  "multitask"])
def test_two_rank_eval_counts_equal_one_process(runs, task):
    # Counts, and metrics computed from summed integer tables, exactly;
    # losses and the per-sample metric sums (floats summed in another
    # order) to f32 rounding.
    want = runs["port"]["eval"][task]
    for r in runs["ranks"]:
        got = r["eval"][task]
        for k, v in want.items():
            if k.startswith("loss") or (task == "multiclass_per_sample" and k != "n_valid"):
                np.testing.assert_allclose(got[k], v, rtol=1e-6)
            else:
                assert got[k] == v, (k, got[k], v)


def test_resident_rows_are_bit_equal_to_one_process_rows(runs):
    want = runs["port"]["resident"]
    for what in ("images", "pngs", "masks"):
        got = torch.cat([r["resident"][what] for r in runs["ranks"]], dim=1)
        torch.testing.assert_close(got, want[what], rtol=0, atol=0, msg=what)


def test_resident_adam_chunk_equals_one_process(runs):
    want = runs["port"]["resident"]
    got = runs["ranks"][0]["resident"]
    # The first step sees the same weights: its loss agrees to f32 rounding.
    np.testing.assert_allclose(got["losses"][0], want["losses"][0], rtol=1e-5)
    # Adam's first update is about lr * sign(g), so each weight whose gradient
    # is rounding noise (see the SGD section) moves +-lr either way: later
    # losses agree to 1e-2 (measured 1.7e-3 at the third step), and no weight
    # is further apart than Adam's own bound, 2 lr per step. (Adam does not
    # see a gradient's scale: the SGD step pins that.)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-2)
    lr, steps = 1e-4, len(want["losses"])
    for k, v in want["state"].items():
        if torch.is_floating_point(v) and not k.endswith(STAT_KEYS):
            assert (got["state"][k] - v).abs().max() <= 2 * lr * steps + 1e-6, k


def test_resident_ranks_stay_bit_equal_and_every_version_moves(runs):
    a, b = (r["resident"] for r in runs["ranks"])
    assert a["losses"] == b["losses"]
    for k, v in a["state"].items():
        torch.testing.assert_close(b["state"][k], v, rtol=0, atol=0, msg=k)
    assert a["versions_moved"] and b["versions_moved"]
    assert runs["port"]["resident"]["versions_moved"]

