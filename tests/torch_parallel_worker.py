"""The cases of ``tests/test_torch_parallel.py``, run on one rank of a gloo job or in one process.

Each case function takes the case's inputs (numpy arrays and state dicts,
the global batch) and a ``Mesh``: on a rank it computes on that rank's
rows through the port's data-parallel code; with ``mesh=None`` it is the
1-process port on the whole batch, the reference the test holds the ranks
against. ``run`` is the worker: it computes every case on its rank and
saves the results for the test to read. Imports torch and the port only
(no JAX): the spawned ranks start from a fresh import.
"""

from __future__ import annotations

import os

import torch

from unet_embroidery_seg_torch.data.synthetic import resident_canvases
from unet_embroidery_seg_torch.engine import resident, steps
from unet_embroidery_seg_torch.models import blocks, build_model
from unet_embroidery_seg_torch.ops import schedules
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
