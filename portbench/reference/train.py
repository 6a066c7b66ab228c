"""The reference's training steps: its own losses, Adam and readings.

``Readings`` is what a training cell compares: the loss of each of the
first steps, each leaf's norm of the first gradient as Adam takes it
(``g + weight_decay * p``, coupled L2, as the program's optimizer has it),
and each leaf's norm of the parameters' change after the steps. The
program's readings are taken from its own run (``entries/train_chunk.py``);
these come from the reference, in any of ``models.PRECISIONS``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from portbench.reference import augment as aug
from portbench.reference.models import Precision


@dataclass
class Readings:
    losses: list[float]
    grad_norms: dict[str, float]  # first gradient as the optimizer takes it, per leaf
    change_norms: dict[str, float]  # ||p_after - p_before|| per leaf
    raw_grad_norms: dict[str, float] | None = None  # first gradient without the decay term
    grad_vectors: dict | None = None  # the first gradient as taken, per leaf (on the card)
    change_vectors: dict | None = None  # p_after - p_before, per leaf

def lovasz_hinge(diff: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean over images of the Lovasz hinge (Berman et al. 2018) of (N, H, W) logits."""
    losses = []
    for logit, label in zip(diff.float(), labels.float()):
        logit, label = logit.reshape(-1), label.reshape(-1)
        errors = 1.0 - logit * (2.0 * label - 1.0)
        errors_sorted, perm = torch.sort(errors, descending=True)
        gt = label[perm]
        gts = gt.sum()
        jaccard = 1.0 - (gts - gt.cumsum(0)) / (gts + (1.0 - gt).cumsum(0))
        grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
        losses.append(torch.dot(F.relu(errors_sorted), grad))
    return torch.stack(losses).mean()


def bce(diff: torch.Tensor, labels: torch.Tensor, pos_weight: float | None) -> torch.Tensor:
    pw = None if pos_weight is None else torch.tensor(pos_weight, device=diff.device)
    return F.binary_cross_entropy_with_logits(diff.float(), labels.float(), pos_weight=pw)


class Adam:
    """Adam with coupled L2 weight decay, bias correction from step 1, in float32."""

    def __init__(self, params: dict[str, torch.Tensor], lr: float, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4):
        self.params, self.lr, self.betas, self.eps, self.wd = params, lr, betas, eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self) -> dict[str, torch.Tensor]:
        """One update; returns each leaf's gradient as taken (with the decay term)."""
        self.t += 1
        b1, b2 = self.betas
        taken = {}
        for k, p in self.params.items():
            g = p.grad + self.wd * p
            taken[k] = g
            self.m[k].mul_(b1).add_(g, alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
            mhat = self.m[k] / (1 - b1 ** self.t)
            vhat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(self.lr * mhat / (vhat.sqrt() + self.eps))
            p.grad = None
        return taken


def batch(step_seed: int, epoch: int, it: int, canvases, out_hw, augment: bool):
    """The reference's own batch of step ``it``: the canvases given, augmented from the step's
    seed (or only normalised), as (images NCHW f32, targets (N, H, W) int32)."""
    imgs, masks, wh = canvases
    if augment:
        _, aug_seed = aug.step_seeds(step_seed, epoch, it)
        gen = torch.Generator(device=imgs.device).manual_seed(aug_seed)
        images, targets = aug.augment(imgs, masks, wh, aug.sample_params(gen, imgs.shape[0]),
                                      out_hw)
    else:
        images, targets = imgs.to(torch.float32) * aug.INV_255, (masks > 0).to(torch.int32)
    return images.permute(0, 3, 1, 2).contiguous(), targets


def run_steps(model, batches, loss: str, pos_weight, lr: float, weight_decay: float,
              precision: str) -> Readings:
    """Train ``model`` (train mode, BN batch statistics) one step per batch; its readings."""
    device = next(model.parameters()).device
    params = dict(model.named_parameters())
    before = {k: p.detach().clone() for k, p in params.items()}
    opt = Adam(params, lr, weight_decay=weight_decay)
    model.train()
    losses, grad_norms, raw = [], {}, {}
    for k, (x, t) in enumerate(batches):
        with Precision(precision, device):
            diff = model(x)
        value = lovasz_hinge(diff, t) if loss == "lovasz_hinge" else bce(diff, t, pos_weight)
        value.backward()
        losses.append(float(value.detach()))
        if k == 0:
            raw = {n: float(p.grad.norm()) for n, p in params.items()}
        taken = opt.step()
        if k == 0:
            grad_norms = {n: float(g.norm()) for n, g in taken.items()}
            grad_vectors = taken
    change_vectors = {k: p.detach() - before[k] for k, p in params.items()}
    change = {k: float(v.norm()) for k, v in change_vectors.items()}
    return Readings(losses, grad_norms, change, raw, grad_vectors, change_vectors)

