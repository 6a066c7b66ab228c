"""Binary segmentation losses (port of the binary part of ``ops/losses.py``).

Layouts as in the JAX package: 2-class logits are NHWC (N, H, W, 2), a diff
head's logit difference (N, H, W), targets (N, H, W) integers. Every
reduction is in float32 whatever the logits' dtype (bf16 under autocast).

The Lovasz hinge sorts each image's hinge errors in descending order with
``torch.sort(stable=True)``; its gradient is a custom
``torch.autograd.Function`` that mirrors the JAX custom VJP
(``_lovasz_errors_loss``): the per-image coefficient vector in sorted order,
scattered back through the forward's permutation. The loss value does not
depend on how ties are ordered; the gradient per pixel can (the JAX
package's ``lax.sort`` makes no promise about ties), so the tests compare
the two on inputs without ties.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def binary_logits_from_two_class(outputs: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 2) two-class logits -> (N, H, W) logit 1 - logit 0.

    softmax(outputs)[..., 1] == sigmoid(outputs[..., 1] - outputs[..., 0]).
    A 3-dim input is already the difference (a ``diff_head`` model) and
    passes through unchanged.
    """
    if outputs.dim() == 3:
        return outputs
    if outputs.dim() != 4 or outputs.shape[-1] != 2:
        raise ValueError(f"Expected outputs shape (N,H,W,2), got {tuple(outputs.shape)}")
    return outputs[..., 1] - outputs[..., 0]


def bce_with_logits(
    logits: torch.Tensor,
    targets: torch.Tensor,
    pos_weight: float | torch.Tensor | None = None,
    mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Stable BCE with logits, mean over all (or, with ``mask``, over valid) elements.

    loss = -[pos_weight * z * log(sigmoid(x)) + (1 - z) * log(1 - sigmoid(x))].
    ``mask`` broadcasts to the logits' shape before the mean, so an (N, 1, 1)
    per-sample mask counts every pixel of a valid sample.
    """
    x = logits.float()
    z = targets.float()
    log_p = -F.softplus(-x)
    log_not_p = -F.softplus(x)
    pos = z * log_p if pos_weight is None else float(pos_weight) * z * log_p
    per_elem = -(pos + (1.0 - z) * log_not_p)
    if mask is not None:
        m = mask.float().expand_as(per_elem)
        return (per_elem * m).sum() / m.sum().clamp_min(1.0)
    return per_elem.mean()


class _LovaszErrorsLoss(torch.autograd.Function):
    """(N,) per-image Lovasz losses from hinge errors (N, P) and labels (N, P)."""

    @staticmethod
    def forward(ctx, errors: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        errors_sorted, perm = torch.sort(errors, dim=1, descending=True, stable=True)
        gt_sorted = labels.gather(1, perm)
        gts = gt_sorted.sum(1, keepdim=True)
        intersection = gts - gt_sorted.cumsum(1)
        union = gts + (1.0 - gt_sorted).cumsum(1)
        jaccard = 1.0 - intersection / union
        grad = torch.cat([jaccard[:, :1], jaccard[:, 1:] - jaccard[:, :-1]], dim=1)
        per_image = (torch.relu(errors_sorted) * grad).sum(1)
        # d per_image / d errors_sorted = 1{errors_sorted > 0} * grad
        ctx.save_for_backward(torch.where(errors_sorted > 0, grad, 0.0), perm)
        return per_image

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar: torch.Tensor):
        coeff_sorted, perm = ctx.saved_tensors
        coeff = torch.empty_like(coeff_sorted).scatter_(1, perm, coeff_sorted)
        return gbar[:, None] * coeff, None


def lovasz_hinge_per_image(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(N,) per-image Lovasz-hinge losses of (N, ...) logits and {0, 1} labels."""
    n = logits.shape[0]
    flat_logits = logits.reshape(n, -1).float()
    flat_labels = labels.reshape(n, -1).float()
    errors = 1.0 - flat_logits * (2.0 * flat_labels - 1.0)
    return _LovaszErrorsLoss.apply(errors, flat_labels)


def lovasz_hinge(
    logits: torch.Tensor, labels: torch.Tensor, sample_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """Lovasz-hinge loss: the mean of the per-image losses (over valid images with ``sample_mask``)."""
    if logits.dim() == 2:
        logits, labels = logits[None], labels[None]
    per_image = lovasz_hinge_per_image(logits, labels)
    if sample_mask is not None:
        m = sample_mask.float()
        return (per_image * m).sum() / m.sum().clamp_min(1.0)
    return per_image.mean()


def binary_segmentation_loss(
    outputs: torch.Tensor,
    targets: torch.Tensor,
    loss_name: str,
    pos_weight: float | torch.Tensor | None = None,
    ignore_index: int | None = None,
    sample_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """BCE or Lovasz hinge on 2-class logits (N, H, W, 2) or a logit difference (N, H, W).

    ``ignore_index`` masks pixels for BCE. For Lovasz it neutralises them
    approximately, exactly as the JAX package does (``ops/losses.py:199-216``):
    the label is forced to the logit's sign and the logit to +-1e3, so the
    hinge error is -999 and sorts last with zero weight.
    """
    logits = binary_logits_from_two_class(outputs).float()
    labels = (targets == 1).float()
    if loss_name == "bce":
        mask = None
        if ignore_index is not None:
            mask = (targets != ignore_index).float()
        if sample_mask is not None:
            sm = sample_mask.float()[:, None, None]
            mask = sm if mask is None else mask * sm
        return bce_with_logits(logits, labels, pos_weight=pos_weight, mask=mask)
    if loss_name == "lovasz_hinge":
        if ignore_index is not None:
            valid = targets != ignore_index
            pos = logits >= 0
            labels = torch.where(valid, labels, pos.float())
            logits = torch.where(valid, logits, torch.where(pos, 1e3, -1e3))
        return lovasz_hinge(logits, labels, sample_mask=sample_mask)
    raise ValueError(f"Unsupported loss_name: {loss_name}")
