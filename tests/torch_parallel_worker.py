"""The cases of ``tests/test_torch_parallel.py``, run on one rank of a gloo job or in one process.

Each case function takes the case's inputs (numpy arrays and state dicts,
the global batch) and a ``Mesh``: on a rank it computes on that rank's
rows through the port's data-parallel code; with ``mesh=None`` it is the
1-process port on the whole batch, the reference the test holds the ranks
against. ``run`` is the worker: it computes every case on its rank and
saves the results for the test to read. Imports torch and the port only
(no JAX): the spawned ranks start from a fresh import.

``run_space`` is the worker of ``tests/test_torch_space.py``'s 4-rank job:
the mesh's space axis on 1x4, 1x2 and 2x2 meshes (``space_cases``), and
``space_one_process`` the same cases in one process. ``run_space_families``
is ``tests/test_torch_space_families.py``'s: every other family and task
over 1x2 and 2x2 meshes (``family_cases``), ``families_one_process`` the
same in one process.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from unet_embroidery_seg_torch.data.synthetic import resident_canvases
from unet_embroidery_seg_torch.engine import resident, steps
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.ops import schedules
from unet_embroidery_seg_torch.parallel import halo
from unet_embroidery_seg_torch.parallel import mesh as mesh_lib

RESIDENT_CANVASES = 12  # three global batches of 4


def _rows(mesh, *arrays):
    return arrays if mesh is None else mesh_lib.shard_batch_arrays(mesh, *arrays)


def _group(mesh):
    return None if mesh is None else mesh.group


def _snapshot(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def port_model(name: str, num_classes: int, state: dict, diff_head: bool = False):
    """The port's model with ``state`` (strict); multitask_unet's dropout made the identity."""
    model = build_model(name, num_classes, diff_head=diff_head, device="cpu")
    model.load_state_dict(state, strict=True)
    if name == "multitask_unet":
        model.cls_head[4].p = 0.0
    return model


def bn_case(case: dict, mesh) -> dict:
    """A train-mode BatchNorm: output, the gradients of sum(y * gy), running statistics.

    On a rank ``dx`` is its rows of the global gradient; ``dw`` and ``db``
    are its share (the ranks' shares sum to the global gradient).
    """
    bn = blocks.BatchNorm(case["x"].shape[1])
    bn.load_state_dict(case["bn_state"])
    blocks.set_batchnorm_group(bn.train(), _group(mesh))
    x, gy = (torch.from_numpy(a) for a in _rows(mesh, case["x"], case["gy"]))
    x.requires_grad_(True)
    y = bn(x)
    (y * gy).sum().backward()
    return {"y": y.detach(), "dx": x.grad, "dw": bn.weight.grad, "db": bn.bias.grad,
            "running_mean": bn.running_mean.clone(), "running_var": bn.running_var.clone()}


def sgd_step_case(case: dict, mesh) -> dict:
    """One SGD train step of the case's task: the loss and the state dict after it."""
    task = case["task"]
    model = port_model(case["model"], case["num_classes"], case["state"],
                       diff_head=task == "binary")
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    group = _group(mesh)
    batch = _rows(mesh, *case["batch"])
    if task == "binary":
        step = steps.make_binary_train_step(model, opt, case["loss"], case["pos_weight"],
                                            amp=False, group=group)
        loss = step(*batch)
    elif task == "multiclass":
        step = steps.make_multiclass_train_step(model, opt, case["num_classes"],
                                                use_dice=True, amp=False, group=group)
        loss = step(*batch)
    else:
        step = steps.make_multitask_train_step(model, opt, seg_loss_name=case["loss"],
                                               pos_weight=case["pos_weight"], amp=False,
                                               group=group)
        (loss, _, _), _ = step(*batch)
    return {"loss": float(loss), "state": _snapshot(model)}


def eval_case(case: dict, mesh) -> dict:
    """The binary, multiclass and multitask eval steps' losses and counts on the case's batches."""
    group = _group(mesh)
    out = {}
    b = case["binary"]
    model = port_model("unet_resnet50", 2, b["state"], diff_head=True)
    loss, counts = steps.make_binary_eval_step(model, "bce", b["pos_weight"], amp=False,
                                               group=group)(*_rows(mesh, *b["batch"]))
    out["binary"] = {"loss": float(loss), "counts": counts.tolist()}
    m = case["multiclass"]
    model = port_model("unet_resnet50", m["num_classes"], m["state"])
    loss, metrics = steps.make_multiclass_eval_step(model, m["num_classes"], amp=False,
                                                    group=group)(*_rows(mesh, *m["batch"]))
    out["multiclass"] = {"loss": float(loss), **{k: float(v) for k, v in metrics.items()}}
    loss_sum, sums, n_valid = steps.make_multiclass_persample_eval_step(
        model, m["num_classes"], amp=False, group=group)(*_rows(mesh, *m["batch"]))
    out["multiclass_per_sample"] = {"loss_sum": float(loss_sum), "n_valid": float(n_valid),
                                    **{k: float(v) for k, v in sums.items()}}
    t = case["multitask"]
    model = port_model("multitask_unet", 1, t["state"])
    (loss, _, _), seg_counts, confusion = steps.make_multitask_eval_step(
        model, amp=False, group=group)(*_rows(mesh, *t["batch"]))
    out["multitask"] = {"loss": float(loss), "seg_counts": seg_counts.tolist(),
                        "confusion": confusion.tolist()}
    return out


def resident_case(case: dict, mesh) -> dict:
    """A resident chunk of Adam steps (binary Lovasz, augmentation on) on seeded canvases.

    Returns the losses, the augmented rows each step trained on, the state
    dict after the chunk, and whether every parameter's version moved.
    """
    model = port_model("unet_resnet50", 2, case["state"], diff_head=True)
    opt = schedules.make_train_optimizer(model.parameters(), case["lr"])
    step = steps.make_binary_train_step(model, opt, "lovasz_hinge", amp=False,
                                        group=_group(mesh))
    seen = []

    def recording_step(images, pngs, sample_mask):
        seen.append((images.clone(), pngs.clone(), sample_mask.clone()))
        return step(images, pngs, sample_mask)

    size = case["size"]
    data = resident.upload(resident_canvases(RESIDENT_CANVASES, size, seed=3), "cpu")
    chunk = resident.make_train_chunk_fn(recording_step, (size, size), True, 2, seed=11,
                                         mesh=mesh)
    idx, mask = resident.epoch_index_plan(data.n, case["batch_size"], 0, True, 11)
    versions = [p._version for p in model.parameters()]
    losses = chunk(data, *resident.upload_plan(idx, mask, "cpu"), 0, range(len(idx)))
    return {"losses": losses.tolist(), "images": torch.stack([s[0] for s in seen]),
            "pngs": torch.stack([s[1] for s in seen]), "masks": torch.stack([s[2] for s in seen]),
            "state": _snapshot(model),
            "versions_moved": all(p._version > v for p, v in zip(model.parameters(), versions))}


CASES = {"bn": bn_case, "sgd": sgd_step_case, "eval": eval_case, "resident": resident_case}


def run_case(kind: str, case: dict, mesh) -> dict:
    torch.manual_seed(0)
    return CASES[kind](case, mesh)


def fail_on_rank(rank: int, failing: int) -> None:
    """Worker that raises on rank ``failing`` while the others wait for it in a collective."""
    if rank == failing:
        raise RuntimeError(f"rank {rank} fails")
    torch.distributed.barrier()


def run(rank: int, inputs_path: str, out_dir: str) -> None:
    """Worker of a gloo job: every case of ``inputs_path`` on this rank, saved to ``out_dir``."""
    torch.set_num_threads(1)
    mesh = mesh_lib.make_mesh(devices=[torch.device("cpu")] * 2)
    inputs = torch.load(inputs_path, weights_only=False)
    results = {name: run_case(kind, case, mesh) for name, (kind, case) in inputs.items()}
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))


def run_on_two_hosts(rank: int, init_method: str, world: int, inputs_path: str,
                     out_dir: str) -> None:
    """Worker of a gloo job joined by explicit address, as two hosts of two CPU devices each.

    Ranks 0-1 see the hostname ``host0``, ranks 2-3 ``host1``; each builds
    the mesh on its host's two devices and computes the sgd cases of
    ``inputs_path`` on its rows.
    """
    import socket

    torch.set_num_threads(1)
    socket.gethostname = lambda: f"host{rank // 2}"  # this worker process only
    mesh_lib.init_multihost(init_method, world, rank, backend="gloo")
    mesh = mesh_lib.make_mesh(devices=[torch.device("cpu")] * 2)
    inputs = torch.load(inputs_path, weights_only=False)
    results = {name: run_case(kind, case, mesh) for name, (kind, case) in inputs.items()}
    results["mesh"] = {"rank": mesh.rank, "world_size": mesh.world_size,
                       "local_rank": int(os.environ["LOCAL_RANK"]),
                       "local_world_size": int(os.environ["LOCAL_WORLD_SIZE"])}
    torch.save(results, os.path.join(out_dir, f"host_rank{rank}.pt"))
    torch.distributed.destroy_process_group()


# --- the space axis (tests/test_torch_space.py) ----------------------------------------------

SPACE_SIZE, SPACE_BATCH, SPACE_LR = 64, 4, 1e-3
SPACE_LOSSES = ("bce", "lovasz_hinge")
EXCHANGE_HALO = (2, 1)  # (top, bottom) rows of the exchange case, zero rows at the image's edges


def space_batch(seed: int, sample_mask):
    """A global batch at 64^2: seeded images, one disc per mask, the sample mask."""
    rng = np.random.RandomState(seed)
    n, size = len(sample_mask), SPACE_SIZE
    images = rng.rand(n, size, size, 3).astype(np.float32)
    yy, xx = np.mgrid[:size, :size] / size
    cx, cy, r = rng.uniform(0.2, 0.8, (3, n, 1, 1))
    pngs = (((xx - cx) ** 2 + (yy - cy) ** 2) < (0.5 * r) ** 2).astype(np.int32)
    return images, pngs, np.asarray(sample_mask, np.float32)


def space_cases(state: dict) -> dict:
    """Inputs of the space job: unet_resnet50's state, an eval batch, one SGD batch per loss."""
    g = torch.Generator().manual_seed(21)
    return {"state": state, "eval": {"pos_weight": 3.0, "batch": space_batch(20, [1, 1, 1, 0])},
            "sgd": {"bce": space_batch(10, [1, 1, 1, 0]), "lovasz_hinge": space_batch(11, [1] * 4)},
            "exchange": {"x": torch.randn(2, 3, 12, 5, generator=g),
                         "g": torch.randn(2, 3, 12 + sum(EXCHANGE_HALO), 5, generator=g)}}


def _space_eval(cases: dict, mesh) -> dict:
    e = cases["eval"]
    model = port_model("unet_resnet50", 2, cases["state"], diff_head=True)
    step = steps.make_binary_eval_step(model, "bce", e["pos_weight"], amp=False,
                                       group=_group(mesh), space=halo.space_axis(mesh))
    loss, counts = step(*_rows(mesh, *e["batch"]))
    return {"loss": float(loss), "counts": counts.tolist()}


def _space_sgd(cases: dict, loss: str, mesh) -> dict:
    torch.manual_seed(0)
    model = port_model("unet_resnet50", 2, cases["state"], diff_head=True)
    opt = torch.optim.SGD(model.parameters(), lr=SPACE_LR)
    step = steps.make_binary_train_step(model, opt, loss, None, amp=False, group=_group(mesh),
                                        space=halo.space_axis(mesh))
    value = step(*_rows(mesh, *cases["sgd"][loss]))
    return {"loss": float(value), "state": _snapshot(model)}


def _space_exchange(case: dict, mesh) -> dict:
    """This rank's band with its halo, and its rows' gradient, beside what slicing gives."""
    top, bottom = EXCHANGE_HALO
    x, g = case["x"], case["g"]
    h = x.shape[2] // mesh.n_space
    xs = x[:, :, mesh.band(x.shape[2])].clone().requires_grad_(True)
    out = halo.space_axis(mesh).exchange(xs, top, bottom, zero_edges=True)
    lo = mesh.s * h  # rows of the zero-padded image: every band's window has top + h + bottom
    (out * g[:, :, lo:lo + out.shape[2]]).sum().backward()
    want_dx = torch.zeros_like(g)
    for j in range(mesh.n_space):  # every band's copy of each row adds its gradient
        want_dx[:, :, j * h:j * h + h + top + bottom] += g[:, :, j * h:j * h + h + top + bottom]
    padded = torch.nn.functional.pad(x, (0, 0, top, bottom))
    return {"out": out.detach(), "want": padded[:, :, lo:lo + h + top + bottom],
            "dx": xs.grad, "want_dx": want_dx[:, :, top + lo:top + lo + h]}


def space_one_process(cases: dict) -> dict:
    """The space job's eval and SGD cases in one process on whole images."""
    return {"eval": _space_eval(cases, None),
            "sgd": {loss: _space_sgd(cases, loss, None) for loss in SPACE_LOSSES}}


def _space_meshes(rank: int) -> dict:
    """This rank's 2x2 mesh, its space group as a 1x2 mesh, and the 1x4 mesh, of a 4-rank job.

    Each 1x2 mesh is one space group of the 2x2 mesh taken as a whole job
    (both compute the same step).
    """
    cpu = torch.device("cpu")
    mesh22 = mesh_lib.make_mesh(2, 2, [cpu] * 4)
    pair = mesh22.space_group
    world = torch.distributed.group.WORLD
    return {"2x2": mesh22, "1x2": mesh_lib.Mesh(rank % 2, 2, cpu, pair, n_space=2,
                                                space_group=pair),
            "1x4": mesh_lib.Mesh(rank, 4, cpu, world, n_space=4, space_group=world)}


def run_space(rank: int, inputs_path: str, out_dir: str) -> None:
    """Worker of the 4-rank space job: the steps on 2x2 and 1x2 meshes, the exchange on 1x4."""
    torch.set_num_threads(1)
    meshes = _space_meshes(rank)
    cases = torch.load(inputs_path, weights_only=False)
    results = {"exchange": _space_exchange(cases["exchange"], meshes["1x4"]),
               "eval": _space_eval(cases, meshes["2x2"]),
               "sgd": {name: {loss: _space_sgd(cases, loss, meshes[name])
                              for loss in SPACE_LOSSES} for name in ("1x2", "2x2")}}
    torch.save(results, os.path.join(out_dir, f"space_rank{rank}.pt"))


# --- the space axis for every family and task (tests/test_torch_space_families.py) -----------

FAMILY_K = 4  # multiclass outputs (3 classes + the ignore class index K)
FAMILY_MESHES = ("1x2", "2x2")
FAMILY_DROPOUT_SEED = 7
NARROW = {"unet_plain": {"base_channels": 8}, "attention_unet": {"base_channels": 8},
          "dualdense_unet": {"base_channels": 8, "growth_rate": 8}}


def task_batch(seed: int, sample_mask, task: str):
    """A global batch at 64^2 for ``task``: ``space_batch``'s images and disc masks, or
    blocky K-class maps with ignore pixels (multiclass); multitask adds class labels."""
    images, pngs, sm = space_batch(seed, sample_mask)
    rng = np.random.RandomState(seed + 1000)
    if task == "multiclass":
        coarse = rng.randint(0, FAMILY_K, (len(sm), 4, 4))
        pngs = np.kron(coarse, np.ones((16, 16), np.int64)).astype(np.int32)
        pngs[rng.rand(*pngs.shape) < 0.02] = FAMILY_K
    if task == "multitask":
        return images, pngs, rng.randint(0, 3, len(sm)).astype(np.int32), sm
    return images, pngs, sm


def narrow_model(name: str, num_classes: int, diff_head: bool = False) -> torch.nn.Module:
    """One of the three families at ``NARROW`` widths (weights as constructed)."""
    from unet_embroidery_seg_torch.models.unet_attention import AttentionUNet
    from unet_embroidery_seg_torch.models.unet_dualdense import DualDenseUNet
    from unet_embroidery_seg_torch.models.unet_plain import UNetPlain

    cls = {"unet_plain": UNetPlain, "attention_unet": AttentionUNet,
           "dualdense_unet": DualDenseUNet}[name]
    model = cls(num_classes=num_classes, diff_head=diff_head, **NARROW[name])
    return model.to(memory_format=torch.channels_last)


def family_model(name: str, num_classes: int, state: dict, diff_head: bool = False,
                 dropout: bool = False):
    """The port's model with ``state``: the three families at ``NARROW`` widths, the ResNet-50
    ones full width (multitask_unet's dropout the identity unless ``dropout``)."""
    if name not in NARROW:
        model = port_model(name, num_classes, state, diff_head)
        if dropout:
            model.cls_head[4].p = 0.5
        return model
    model = narrow_model(name, num_classes, diff_head)
    model.load_state_dict(state, strict=True)
    return model


def _floats(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()}


def family_eval(case: dict, mesh) -> dict:
    """The case's f32 eval step(s) on its eval batch: losses, counts, tables, per-sample sums."""
    group, space = _group(mesh), halo.space_axis(mesh)
    task, k = case["task"], case["num_classes"]
    model = family_model(case["model"], k, case["state"], diff_head=task == "binary")
    batch = _rows(mesh, *case["eval_batch"])
    if task == "binary":
        loss, counts = steps.make_binary_eval_step(model, "bce", case["pos_weight"], amp=False,
                                                   group=group, space=space)(*batch)
        return {"loss": float(loss), "counts": counts.tolist()}
    if task == "multiclass":
        loss, m = steps.make_multiclass_eval_step(model, k, amp=False, group=group,
                                                  space=space)(*batch)
        loss_sum, sums, n_valid = steps.make_multiclass_persample_eval_step(
            model, k, amp=False, group=group, space=space)(*batch)
        return {"loss": float(loss), "metrics": _floats(m),
                "per_sample": {"loss_sum": float(loss_sum), "n_valid": float(n_valid),
                               **_floats(sums)}}
    (loss, seg_l, cls_l), seg_counts, confusion = steps.make_multitask_eval_step(
        model, pos_weight=case["pos_weight"], amp=False, group=group, space=space)(*batch)
    return {"loss": float(loss), "seg_loss": float(seg_l), "cls_loss": float(cls_l),
            "seg_counts": seg_counts.tolist(), "confusion": confusion.tolist()}


def family_sgd(case: dict, mesh) -> dict:
    """One f32 SGD train step of the case's task: the loss and the state dict after it."""
    torch.manual_seed(0)
    group, space = _group(mesh), halo.space_axis(mesh)
    task, k = case["task"], case["num_classes"]
    model = family_model(case["model"], k, case["state"], diff_head=task == "binary")
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    batch = _rows(mesh, *case["sgd_batch"])
    out = {}
    if task == "binary":
        loss = steps.make_binary_train_step(model, opt, "bce", case["pos_weight"], amp=False,
                                            group=group, space=space)(*batch)
    elif task == "multiclass":
        loss = steps.make_multiclass_train_step(model, opt, k, amp=False, group=group,
                                                space=space)(*batch)
    else:
        (loss, _, _), correct = steps.make_multitask_train_step(
            model, opt, pos_weight=case["pos_weight"], amp=False, group=group,
            space=space)(*batch)
        out["correct"] = int(correct)
    return {"loss": float(loss), "state": _snapshot(model), **out}


def multitask_dropout(case: dict, mesh) -> dict:
    """A multitask train step with its dropout on, seeded as the train CLI seeds it.

    Returns the class head's logits and the share of the dropout's nonzero
    inputs it zeroed, both read by forward hooks during the step.
    """
    group, space = _group(mesh), halo.space_axis(mesh)
    model = family_model("multitask_unet", 1, case["state"], dropout=True)
    opt = torch.optim.SGD(model.parameters(), lr=case["lr"])
    step = steps.make_multitask_train_step(model, opt, pos_weight=case["pos_weight"], amp=False,
                                           group=group, space=space)
    seen = {}

    def dropped(module, inputs, output):
        kept = inputs[0] != 0
        seen["dropped"] = float(((output == 0) & kept).sum() / kept.sum())

    model.cls_head[4].register_forward_hook(dropped)
    model.cls_head.register_forward_hook(
        lambda module, inputs, output: seen.setdefault("logits", output.detach().clone()))
    resident.seed_default_generator(torch.device("cpu"),
                                    resident.rank_seed(FAMILY_DROPOUT_SEED, mesh))
    step(*_rows(mesh, *case["sgd_batch"]))
    return seen


def families_one_process(cases: dict) -> dict:
    """Every family case's eval and SGD step in one process on whole images."""
    return {name: {"eval": family_eval(case, None), "sgd": family_sgd(case, None)}
            for name, case in cases.items()}


def run_space_families(rank: int, inputs_path: str, out_dir: str) -> None:
    """Worker of the families' 4-rank space job: every case on the 1x2 and 2x2 meshes."""
    torch.set_num_threads(1)
    meshes = _space_meshes(rank)
    cases = torch.load(inputs_path, weights_only=False)
    results = {name: {kind: {m: fn(case, meshes[m]) for m in FAMILY_MESHES}
                      for kind, fn in (("eval", family_eval), ("sgd", family_sgd))}
               for name, case in cases.items()}
    results["dropout"] = {m: multitask_dropout(cases["multitask_unet/multitask"], meshes[m])
                          for m in FAMILY_MESHES}
    torch.save(results, os.path.join(out_dir, f"families_rank{rank}.pt"))
