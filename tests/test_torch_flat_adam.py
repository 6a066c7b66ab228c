"""JAX's optimizer variants (``make_train_optimizer(variant=)``) against the port's and each other.

``"flat"`` (``torch_alternates.FlatAdam``) against JAX's ``FlatAdam.apply_grads``,
``"tree"`` (the port's optimizer, the foreach ``torch.optim.Adam``) against
JAX's ``TreeAdam`` and, as ``"optax"``, against JAX's ``make_optimizer`` chain, on
narrow unet_plain's parameters (base width 8) and numpy gradients from a
seed, f32 on the CPU; then ``flat`` against ``tree`` wherever the port
trains: the learning rate set per epoch, the packed-weight cache, a
checkpoint round trip and its size, the train CLI's ``--resume``, the
binary, multiclass and multitask steps, and a 2-rank gloo job over the
data axis and over the space axis.

Tolerances. Against JAX: 1e-6 absolute after ten steps of lr 1e-3 (JAX's
own test: f32 rounding of the update, ~1e-7 of each step). ``flat``
against ``tree``: the same ops, elementwise, on another memory layout. On
one thread the parameters came out equal bit for bit (measured); on eight,
ten steps once put one parameter 2.7 ulps of its value apart (3.2e-7 at
1.06: the CPU kernels' vector loops and their scalar tails round a lerp
differently, and the arena's thread chunks end elsewhere than a tensor's);
on the H100 one step put an element 2.5 ulps of its update apart (the
foreach kernels contract the update's seven ops otherwise). So each
element is held to ``ULPS_PER_STEP`` f32 ulps per step of the largest of
its value before, its values after and the update (``ulps_apart``), over
steps that see the same gradients: after a train step's first update the
next gradients differ by that rounding, which Adam's sign-like update can
turn into +-lr; later steps are held by their loss (1e-6 relative).
"""

import functools
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import torch_alternates as alt
import torch_parallel_worker as worker
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_tpu.ops.flat_adam import FlatAdam as JaxFlatAdam
from unet_embroidery_seg_tpu.ops.flat_adam import TreeAdam as JaxTreeAdam
from unet_embroidery_seg_torch import train as port_train
from unet_embroidery_seg_torch.engine import checkpoint, steps
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.ops import conv3x3 as C
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

LR, WD = 1e-3, 1e-4
ULPS_PER_STEP = 4  # chip_smoke.py's FLAT_STEP_ULPS
JOB_TIMEOUT_S = 300


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs (the suite's workers share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seed: int = 0, num_classes: int = 2, diff_head: bool = False) -> torch.nn.Module:
    model = worker.narrow_model("unet_plain", num_classes, diff_head)
    return blocks.init_weights(model, torch.Generator().manual_seed(seed))


def _grads(params: list, seed: int) -> list[np.ndarray]:
    rng = np.random.RandomState(seed)
    return [(rng.randn(*p.shape) * 1e-2).astype(np.float32) for p in params]


def _set_grads(params: list, grads: list[np.ndarray]) -> None:
    """Put ``grads`` where the optimizer reads them, as a backward would (in place if bound)."""
    for p, g in zip(params, grads):
        if p.grad is None:
            p.grad = torch.from_numpy(g.copy())
        else:
            p.grad.copy_(torch.from_numpy(g))


def _port_steps(variant: str, n: int, lr=LR, wd=WD, lrs=None) -> list[np.ndarray]:
    """``n`` steps of the port's ``variant`` on narrow unet_plain with seeded gradients."""
    params = list(_model().parameters())
    opt = alt.make_optimizer(variant, params, lr, 0.9, wd)
    for i in range(n):
        if lrs is not None:
            schedules.set_learning_rate(opt, lrs[i])
        opt.zero_grad()
        _set_grads(params, _grads(params, 100 + i))
        opt.step()
    return [p.detach().numpy().copy() for p in params]


def _jax_steps(variant: str, n: int, lr=LR, wd=WD, lrs=None) -> list[np.ndarray]:
    """The same on JAX's counterpart (FlatAdam, TreeAdam, the optax chain)."""
    params = [jnp.asarray(p.detach().numpy()) for p in _model().parameters()]
    if variant == "optax":
        tx = jax_schedules.make_optimizer(lr, momentum=0.9, weight_decay=wd)
        state = tx.init(params)
        for i in range(n):
            if lrs is not None:
                state = jax_schedules.set_learning_rate(state, lrs[i])
            g = [jnp.asarray(a) for a in _grads(params, 100 + i)]
            updates, state = tx.update(g, state, params)
            params = optax.apply_updates(params, updates)
        return [np.asarray(p) for p in params]
    cls = {"flat": JaxFlatAdam, "tree": JaxTreeAdam}[variant]
    tx = cls(lr, b1=0.9, weight_decay=wd, param_dtype=jnp.float32)
    state = tx.init(params)
    for i in range(n):
        if lrs is not None:
            state = jax_schedules.set_learning_rate(state, lrs[i])
        params, state = tx.apply_grads([jnp.asarray(a) for a in _grads(params, 100 + i)], state)
    return [np.asarray(p) for p in params]


def _max_diff(a: list, b: list) -> float:
    return max(float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).max())
               for x, y in zip(a, b))


def ulps_apart(a: list, b: list, init: list) -> float:
    """The largest difference of two lists of f32 arrays updated from ``init``, in ulps of the
    largest of the value before, the values after and the update there (the update carries
    its ops' roundings, whatever the result)."""
    worst = 0.0
    for x, y, z in zip(a, b, init):
        x, y, z = (np.asarray(t, np.float32) for t in (x, y, z))
        ulp = np.spacing(np.max([np.abs(x), np.abs(y), np.abs(z), np.abs(y - z)], axis=0))
        worst = max(worst, float((np.abs(x.astype(np.float64) - y) / ulp).max()))
    return worst


def _init() -> list[np.ndarray]:
    return [p.detach().numpy().copy() for p in _model().parameters()]


# --- against JAX -------------------------------------------------------------------------------


@pytest.mark.parametrize("variant", alt.VARIANTS)
@pytest.mark.parametrize("case", ["ten_steps", "no_weight_decay", "set_learning_rate"])
def test_variant_equals_jax(variant, case):
    kw = {"ten_steps": {"n": 10}, "no_weight_decay": {"n": 1, "wd": 0.0},
          "set_learning_rate": {"n": 3, "lrs": [1e-3, 5e-4, 2e-4]}}[case]
    got, want = _port_steps(variant, **kw), _jax_steps(variant, **kw)
    assert _max_diff(got, want) < 1e-6


def test_flat_equals_tree_over_ten_steps():
    assert ulps_apart(_port_steps("flat", 10), _port_steps("tree", 10), _init()) <= 10 * ULPS_PER_STEP


def test_an_unknown_variant_raises():
    with pytest.raises(ValueError, match="variant"):
        alt.make_optimizer("lamb", [torch.nn.Parameter(torch.ones(2))], LR)


# --- FlatAdam's arenas: views, versions, the packed-weight cache, rebinding --------------------


def test_parameters_and_gradients_are_views_of_the_arenas():
    model = _model().to(memory_format=torch.channels_last)
    formats = [p.is_contiguous(memory_format=torch.channels_last) for p in model.parameters()]
    values = [p.detach().clone() for p in model.parameters()]
    opt = alt.FlatAdam(model.parameters(), lr=LR)
    opt.zero_grad()
    base = opt.master.untyped_storage().data_ptr()
    gbase = opt.grad.untyped_storage().data_ptr()
    for p, fmt, v in zip(model.parameters(), formats, values):
        assert p.untyped_storage().data_ptr() == base
        assert p.grad.untyped_storage().data_ptr() == gbase
        assert p.is_contiguous(memory_format=torch.channels_last) == fmt  # strides kept
        torch.testing.assert_close(p.detach(), v, rtol=0, atol=0)
    assert opt.master.numel() == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("variant", alt.VARIANTS)
def test_a_step_bumps_every_version_and_the_cache_repacks(variant):
    # The conv kernel's grad-off packed-weight cache keys on (data pointer,
    # version): after a step a grad-off call must see the new weights.
    conv = blocks.SquareConv3x3(16)
    opt = alt.make_optimizer(variant, conv.parameters(), LR)
    with torch.no_grad():
        before = C._packed_params(conv.weight, conv.bias, torch.float32)
        assert C._packed_params(conv.weight, conv.bias, torch.float32)[0] is before[0]
    versions = [p._version for p in conv.parameters()]
    opt.zero_grad()
    _set_grads(list(conv.parameters()), _grads(list(conv.parameters()), 1))
    opt.step()
    assert all(p._version > v for p, v in zip(conv.parameters(), versions))
    with torch.no_grad():
        after = C._packed_params(conv.weight, conv.bias, torch.float32)
    fresh = C._pack(conv.weight.detach().clone(), conv.bias.detach().clone(), torch.float32)
    torch.testing.assert_close(after[0], fresh[0], rtol=0, atol=0)
    assert not torch.equal(after[0], before[0])


def test_a_moved_parameter_is_bound_again_with_its_moments():
    """``p.data = ...`` (what ``model.to`` does) breaks the aliasing: the next step re-binds,
    keeping values and moments, and goes on as an unbroken run."""
    runs = {}
    for rebind in (False, True):
        params = list(_model().parameters())
        opt = alt.FlatAdam(params, lr=LR, weight_decay=WD)
        for i in range(3):
            if rebind and i == 1:
                for p in params:
                    p.data = p.data.clone().contiguous()
            opt.zero_grad()
            _set_grads(params, _grads(params, 100 + i))
            opt.step()
        assert all(p.untyped_storage().data_ptr() == opt.master.untyped_storage().data_ptr()
                   for p in params)
        runs[rebind] = [p.detach().numpy().copy() for p in params]
    assert _max_diff(runs[True], runs[False]) == 0


def test_a_gradient_put_in_place_of_its_view_is_read():
    """A gradient assigned by hand (``p.grad = t``, not the arena's view) is what the step uses."""
    runs = {}
    for variant in ("tree", "flat"):
        params = list(_model().parameters())
        opt = alt.make_optimizer(variant, params, LR)
        for p, g in zip(params, _grads(params, 7)):
            p.grad = torch.from_numpy(g)
        opt.step()
        runs[variant] = [p.detach().numpy().copy() for p in params]
    assert ulps_apart(runs["flat"], runs["tree"], _init()) <= ULPS_PER_STEP


# --- checkpoints -------------------------------------------------------------------------------


def _trained(variant: str, n: int):
    model = _model()
    opt = alt.make_optimizer(variant, model.parameters(), LR)
    params = list(model.parameters())
    for i in range(n):
        opt.zero_grad()
        _set_grads(params, _grads(params, 100 + i))
        opt.step()
    return model, opt


def test_checkpoint_round_trip_and_file_sizes(tmp_path):
    """save_state / restore_state round-trip FlatAdam exactly; its files are the tree's size."""
    sizes = {}
    try:
        for variant in ("tree", "flat"):
            model, opt = _trained(variant, 1)
            checkpoint.save_weights(str(tmp_path / f"{variant}.pth"), model)
            checkpoint.save_state(str(tmp_path / f"{variant}_resume.pth"), model, opt, 1,
                                  {"epoch": 1})
            sizes[variant] = (os.path.getsize(tmp_path / f"{variant}.pth"),
                              os.path.getsize(tmp_path / f"{variant}_resume.pth"))
        model, opt = _trained("flat", 1)
        fresh = _model(seed=9)
        fresh_opt = alt.make_optimizer("flat", fresh.parameters(), LR)
        step, extra = checkpoint.restore_state(str(tmp_path / "flat_resume.pth"), fresh,
                                               fresh_opt)
        weights = torch.load(tmp_path / "flat.pth", weights_only=True)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    assert (step, extra, fresh_opt.count) == (1, {"epoch": 1}, 1)
    for a, b in ((fresh_opt.mu, opt.mu), (fresh_opt.nu, opt.nu), (fresh_opt.master, opt.master)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(weights[k], v, rtol=0, atol=0)
        assert weights[k].untyped_storage().nbytes() == v.numel() * v.element_size(), k
    # model-only: the same tensors, so the same bytes; resume: no arena saved per key
    assert sizes["flat"][0] == sizes["tree"][0]
    assert 0.99 * sizes["tree"][1] <= sizes["flat"][1] <= sizes["tree"][1], sizes
    for p, q in zip(model.parameters(), fresh.parameters()):  # both go on alike
        p.grad.copy_(torch.ones_like(p))
        q.grad.copy_(torch.ones_like(q))
    opt.step()
    fresh_opt.step()
    torch.testing.assert_close(fresh_opt.master, opt.master, rtol=0, atol=0)


def test_a_view_of_a_larger_storage_is_saved_alone(tmp_path):
    """``torch.save`` of a view writes its whole storage; the checkpoint writer copies it out."""
    arena = torch.arange(1 << 16, dtype=torch.float32)
    path = tmp_path / "view.pth"
    try:
        checkpoint.save_weights(str(path), {"w": arena[8:12]})
        size = os.path.getsize(path)
        weights = torch.load(path, weights_only=True)
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    torch.testing.assert_close(weights["w"], arena[8:12], rtol=0, atol=0)
    assert weights["w"].untyped_storage().nbytes() == 16
    assert size < arena.numel() * arena.element_size() // 8, size


def test_train_cli_resume_is_exact_with_flat(tmp_path, monkeypatch):
    """``--resume`` with FlatAdam (the CLI's optimizer swapped, as the JAX CLI has no flag)."""
    monkeypatch.setattr(schedules, "make_train_optimizer",
                        functools.partial(alt.make_optimizer, "flat"))
    monkeypatch.chdir(tmp_path)
    args = ["--data-path", "synthetic:4", "--input-size", "32", "--batch-size", "2",
            "--max-train-batches", "2", "--max-val-batches", "1", "--max-test-batches", "1",
            "--device", "cpu", "--no-amp", "--ckpt-every", "1", "--no-export-vis",
            "--task", "binary", "--model", "unet_plain", "--loss", "bce"]
    try:
        full = port_train.train(port_train.parse_args(args + ["--epochs", "2"]))
        first = port_train.train(port_train.parse_args(args + ["--epochs", "1"]))
        resumed = port_train.train(port_train.parse_args(
            args + ["--epochs", "2", "--resume", os.path.join(first, "weights", "resume.pth")]))
        a, b = (torch.load(os.path.join(e, "weights", "last.pth"), weights_only=True)
                for e in (full, resumed))
        histories = [open(os.path.join(e, "val_metrics_history.json")).read()
                     for e in (full, resumed)]
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
    assert a.keys() == b.keys()
    for k in a:
        torch.testing.assert_close(b[k], a[k], rtol=0, atol=0, msg=k)
    assert histories[0] == histories[1]


# --- every task's train step -------------------------------------------------------------------


def _task_step(task: str, variant: str | None) -> tuple[list[float], dict]:
    """Two f32 train steps of ``task`` with ``variant``: (losses, the state dict after the
    first); ``variant`` None: ([], the initial state dict)."""
    torch.manual_seed(0)
    if task == "multitask":
        model = build_model("multitask_unet", 1, device="cpu",
                            generator=torch.Generator().manual_seed(0))
        model.cls_head[4].p = 0.0
    else:
        model = _model(num_classes=2 if task == "binary" else 4, diff_head=task == "binary")
    if variant is None:  # the initial state
        return [], {k: v.numpy().copy() for k, v in model.state_dict().items()}
    opt = alt.make_optimizer(variant, model.parameters(), LR)
    batch = worker.task_batch(3, [1, 1, 0, 1], task)
    batch = (batch[0][:, :32, :32], batch[1][:, :32, :32], *batch[2:])
    if task == "binary":
        step = steps.make_binary_train_step(model, opt, "bce", 2.0, amp=False)
    elif task == "multiclass":
        step = steps.make_multiclass_train_step(model, opt, 4, amp=False)
    else:
        train = steps.make_multitask_train_step(model, opt, pos_weight=2.0, amp=False)
        step = lambda *b: train(*b)[0][0]  # noqa: E731
    losses = [float(step(*batch))]
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    losses.append(float(step(*batch)))
    return losses, state


@pytest.mark.parametrize("task", ["binary", "multiclass", "multitask"])
def test_every_task_trains_alike_with_flat_and_tree(task):
    (fl, fs), (tl, ts) = _task_step(task, "flat"), _task_step(task, "tree")
    assert fl[0] == tl[0]  # the same forward on the same weights
    np.testing.assert_allclose(fl, tl, rtol=1e-6)
    keys = [k for k in ts if np.issubdtype(ts[k].dtype, np.floating)]
    init = _task_step(task, None)[1]
    assert ulps_apart([fs[k] for k in keys], [ts[k] for k in keys], [init[k] for k in keys]) <= ULPS_PER_STEP


# --- a 2-rank gloo job: the data axis and the space axis ---------------------------------------


@pytest.fixture(scope="module")
def flat_job(tmp_path_factory):
    """Each rank's results and the one process's, by mesh and variant; files deleted as read."""
    tmp = tmp_path_factory.mktemp("flat_adam")
    try:
        model = _model(diff_head=True)
        case = {"state": {k: v.clone() for k, v in model.state_dict().items()},
                "pos_weight": 2.0, "batch": worker.space_batch(5, [1, 1, 1, 0])}
        torch.save(case, tmp / "inputs.pt")
        failures: list[BaseException] = []

        def run():
            try:
                mesh_lib.launch_local(worker.run_flat_adam, 2, (str(tmp / "inputs.pt"), str(tmp)),
                                      backend="gloo", timeout_s=JOB_TIMEOUT_S)
            except BaseException as e:  # noqa: BLE001 - raised again below, in the test's thread
                failures.append(e)

        thread = threading.Thread(target=run)
        thread.start()
        try:
            one = {v: worker.flat_adam_case(case, v, None) for v in worker.FLAT_VARIANTS}
        finally:
            thread.join(JOB_TIMEOUT_S + 60)
        assert not thread.is_alive(), "the 2-rank job did not end"
        if failures:
            raise failures[0]
        ranks = worker.load_results([tmp / f"flat_rank{r}.pt" for r in (0, 1)])
        return {"one": one, "ranks": ranks, "init": case["state"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@pytest.mark.parametrize("mesh", worker.FLAT_MESHES)
def test_two_rank_flat_step_equals_one_process_and_tree(flat_job, mesh):
    # Against one process, Adam's rule of tests/test_torch_parallel.py: the
    # first loss to f32 rounding, no weight further than 2 lr per step (its
    # sign-like first update moves weights whose gradient is rounding noise
    # by +-lr either way). Against tree on the same ranks: the first update
    # within ULPS_PER_STEP, the losses to 1e-6.
    one = flat_job["one"]["flat"]
    ranks = [r[mesh] for r in flat_job["ranks"]]
    for r in ranks:
        got = r["flat"]
        assert got["versions_moved"]
        np.testing.assert_allclose(got["losses"][0], one["losses"][0], rtol=1e-5)
        for k, v in one["state"].items():
            if torch.is_floating_point(v) and not k.endswith(("running_mean", "running_var")):
                bound = 2 * worker.FLAT_LR * worker.FLAT_STEPS + 1e-6
                assert (got["state"][k] - v).abs().max() <= bound, k
        assert got["losses"][0] == r["tree"]["losses"][0]
        np.testing.assert_allclose(got["losses"], r["tree"]["losses"], rtol=1e-6)
        keys = [k for k, v in got["first"].items() if torch.is_floating_point(v)]
        assert ulps_apart([got["first"][k].numpy() for k in keys],
                          [r["tree"]["first"][k].numpy() for k in keys],
                          [flat_job["init"][k].numpy() for k in keys]) <= ULPS_PER_STEP
    for k, v in ranks[0]["flat"]["state"].items():  # the ranks end bit-equal
        torch.testing.assert_close(ranks[1]["flat"]["state"][k], v, rtol=0, atol=0, msg=k)
