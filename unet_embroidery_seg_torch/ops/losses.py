"""Segmentation losses (port of ``ops/losses.py``): binary, multiclass and multitask.

Layouts as in the JAX package: 2-class logits are NHWC (N, H, W, 2), a diff
head's logit difference (N, H, W), K-class logits (N, H, W, K), targets
(N, H, W) integers, where the multiclass ignore class is ``num_classes``.
Every reduction is in float32 whatever the logits' dtype (bf16 under
autocast).

The Lovasz hinge sorts each image's hinge errors in descending order with
``torch.sort(stable=True)``; its gradient is a custom
``torch.autograd.Function`` that mirrors the JAX custom VJP
(``_lovasz_errors_loss``): the per-image coefficient vector in sorted order,
scattered back through the forward's permutation. The loss value does not
depend on how ties are ordered; the gradient per pixel can (the JAX
package's ``lax.sort`` makes no promise about ties), so the tests compare
the two on inputs without ties.

Data parallelism: each loss takes an optional process ``group``, and None
keeps the single-device code. With a group, each normaliser is the global
batch's, as the JAX losses take theirs on the sharded global arrays: the
local numerator and denominator (Dice: tp, the probabilities' and the
targets' sums) go through one autograd-aware all-reduce
(``parallel/mesh.global_sum``) before the division, so every rank gets
the global loss, and its backward carries the gradient scale DDP's
averaging expects (nothing is multiplied by the world size).

The mesh's space axis (``space``: ``parallel/halo.SpaceAxis``; each rank
holds a band of every image's rows, ``group`` is then the whole job): the
pixel sums of BCE need nothing more. The Lovasz hinge sorts whole images:
each rank gathers its images' hinge errors and labels over the space group
(``SpaceAxis.gather_rows``), whose flattened order is then the unsplit
image's, so the sort and its tie order are unchanged; every rank of the
group computes the per-image losses, only space index 0 counts them (the
others add zeros, and their gradients, zeros, still run the gather's
backward), and the gather's backward gives each rank its slice of the
coefficient: neither the loss nor its gradient is counted once per band.
CE, focal and Dice sum their numerators and normalisers over ``group``,
which holds every band: they need nothing more. multitask's class CE is
per image, and every rank of an image's group holds its class logits
(``blocks.GlobalAvgPool``): space index 0 counts it, the others count zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from unet_embroidery_seg_torch.parallel.mesh import Group, global_sum


def _global_ratio(num: torch.Tensor, den: torch.Tensor | int, group: Group,
                  floor: float) -> torch.Tensor:
    """sum(num) / max(sum(den), floor), each summed over ``group``'s ranks.

    An integer ``den`` (an element count) is filled on ``num``'s device: a
    tensor made from a host value would be a copy that waits for the card.
    """
    den = num.new_full((), den) if isinstance(den, int) else den.to(num.dtype)
    num, den = global_sum(torch.stack([num, den]), group).unbind()
    return num / den.clamp_min(floor)


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
    group: Group = None,
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
        if group is not None:
            return _global_ratio((per_elem * m).sum(), m.sum(), group, 1.0)
        return (per_elem * m).sum() / m.sum().clamp_min(1.0)
    if group is not None:
        return _global_ratio(per_elem.sum(), per_elem.numel(), group, 1.0)
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


def lovasz_hinge_per_image(logits: torch.Tensor, labels: torch.Tensor,
                           space=None) -> torch.Tensor:
    """(N,) per-image Lovasz-hinge losses of (N, ...) logits and {0, 1} labels.

    ``space``: the logits and labels are a band of each image's rows, and
    the losses are the whole images', gathered over the space group.
    """
    n = logits.shape[0]
    flat_logits = logits.reshape(n, -1).float()
    flat_labels = labels.reshape(n, -1).float()
    errors = 1.0 - flat_logits * (2.0 * flat_labels - 1.0)
    if space is not None:
        errors, flat_labels = space.gather_rows(errors), space.gather_rows(flat_labels)
    return _LovaszErrorsLoss.apply(errors, flat_labels)


def lovasz_hinge(
    logits: torch.Tensor, labels: torch.Tensor, sample_mask: torch.Tensor | None = None,
    group: Group = None, space=None,
) -> torch.Tensor:
    """Lovasz-hinge loss: the mean of the per-image losses (over valid images with ``sample_mask``).

    ``space``: each rank holds a band of every image (module docstring);
    space index 0 counts the images, the others count zero of them.
    """
    if logits.dim() == 2:
        logits, labels = logits[None], labels[None]
    per_image = lovasz_hinge_per_image(logits, labels, space)
    m = None if sample_mask is None else sample_mask.float()
    if space is not None:
        m = (per_image.new_ones(per_image.shape) if m is None else m) * float(space.first)
    if m is not None:
        if group is not None:
            return _global_ratio((per_image * m).sum(), m.sum(), group, 1.0)
        return (per_image * m).sum() / m.sum().clamp_min(1.0)
    if group is not None:
        return _global_ratio(per_image.sum(), per_image.numel(), group, 1.0)
    return per_image.mean()


def binary_segmentation_loss(
    outputs: torch.Tensor,
    targets: torch.Tensor,
    loss_name: str,
    pos_weight: float | torch.Tensor | None = None,
    ignore_index: int | None = None,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
    space=None,
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
        return bce_with_logits(logits, labels, pos_weight=pos_weight, mask=mask, group=group)
    if loss_name == "lovasz_hinge":
        if ignore_index is not None:
            valid = targets != ignore_index
            pos = logits >= 0
            labels = torch.where(valid, labels, pos.float())
            logits = torch.where(valid, logits, torch.where(pos, 1e3, -1e3))
        return lovasz_hinge(logits, labels, sample_mask=sample_mask, group=group, space=space)
    raise ValueError(f"Unsupported loss_name: {loss_name}")


def _pixel_nll(logits: torch.Tensor, target: torch.Tensor, num_classes: int,
               sample_mask: torch.Tensor | None):
    """(per-pixel NLL, 0 where the pixel is invalid; the valid mask), both flat over N*H*W."""
    n, c = logits.shape[0], logits.shape[-1]
    flat_target = target.reshape(-1).long()
    valid = flat_target != num_classes
    if sample_mask is not None:
        per_pix = flat_target.numel() // n
        valid = valid & sample_mask.bool().repeat_interleave(per_pix)
    safe_target = torch.where(valid, flat_target, 0)
    log_probs = torch.log_softmax(logits.reshape(-1, c).float(), dim=-1)
    nll = -log_probs.gather(1, safe_target[:, None])[:, 0]
    return nll * valid.float(), valid


def ce_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    num_classes: int = 21,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> torch.Tensor:
    """Pixel cross-entropy with ``ignore_index == num_classes`` (JAX ``ce_loss``, unweighted).

    The mean over valid pixels; ``sample_mask`` (N,) drops the padded
    samples' pixels.
    """
    nll, valid = _pixel_nll(logits, target, num_classes, sample_mask)
    if group is not None:
        return _global_ratio(nll.sum(), valid.float().sum(), group, 1e-12)
    return nll.sum() / valid.float().sum().clamp_min(1e-12)


# The reference's defaults, which every caller uses.
FOCAL_ALPHA, FOCAL_GAMMA = 0.5, 2.0
DICE_SMOOTH = 1e-5


def focal_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    num_classes: int = 21,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> torch.Tensor:
    """Focal loss on per-pixel CE (JAX ``focal_loss``, unweighted, alpha 0.5, gamma 2).

    Per-pixel CE with reduction 'none' (ignored pixels give 0), then the
    mean over ALL pixels, as the reference; with ``sample_mask`` the
    denominator is the valid samples' pixel count (a padded sample's pixels
    are invalid, so their CE is 0, pt 1 and their loss exactly 0).
    """
    nll, _ = _pixel_nll(logits, target, num_classes, sample_mask)
    pt = torch.exp(-nll)
    loss = ((1.0 - pt) ** FOCAL_GAMMA) * (nll * FOCAL_ALPHA)
    if sample_mask is not None:
        per_pix = target[0].numel()
        if group is not None:
            return _global_ratio(loss.sum(), sample_mask.float().sum() * per_pix, group, 1.0)
        return loss.sum() / (sample_mask.float().sum() * per_pix).clamp_min(1.0)
    if group is not None:
        return _global_ratio(loss.sum(), loss.numel(), group, 1.0)
    return loss.mean()


def dice_loss(
    logits: torch.Tensor,
    target_onehot: torch.Tensor,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> torch.Tensor:
    """Soft Dice loss over softmax probabilities (JAX ``dice_loss`` at its beta 1, smooth 1e-5).

    ``target_onehot`` is (N, H, W, K + 1): its last channel is the ignore
    class, dropped from tp and fn as the reference's ``temp_target[..., :-1]``.
    """
    n, c = logits.shape[0], logits.shape[-1]
    probs = torch.softmax(logits.reshape(n, -1, c).float(), dim=-1)
    tgt = target_onehot.reshape(n, -1, target_onehot.shape[-1]).float()
    if sample_mask is not None:
        sm = sample_mask.float()[:, None, None]
        probs, tgt = probs * sm, tgt * sm
    tgt_fg = tgt[..., :-1]
    tp = (tgt_fg * probs).sum(dim=(0, 1))
    p_sum, t_sum = probs.sum(dim=(0, 1)), tgt_fg.sum(dim=(0, 1))
    if group is not None:  # Dice is not linear in the sums: the global ones first
        tp, p_sum, t_sum = global_sum(torch.stack([tp, p_sum, t_sum]), group).unbind()
    fp = p_sum - tp
    fn = t_sum - tp
    score = (2.0 * tp + DICE_SMOOTH) / (2.0 * tp + fn + fp + DICE_SMOOTH)
    return 1.0 - score.mean()


def multiclass_loss(
    logits: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    focal: bool = False,
    use_dice: bool = True,
    sample_mask: torch.Tensor | None = None,
    group: Group = None,
) -> torch.Tensor:
    """CE or focal, plus Dice against the (K + 1)-channel one-hot (the multiclass steps' loss)."""
    fn = focal_loss if focal else ce_loss
    loss = fn(logits, target, num_classes=num_classes, sample_mask=sample_mask, group=group)
    if use_dice:
        onehot = F.one_hot(target.long(), num_classes + 1).float()
        loss = loss + dice_loss(logits, onehot, sample_mask=sample_mask, group=group)
    return loss


def multitask_loss(
    seg_logits: torch.Tensor,
    cls_logits: torch.Tensor,
    seg_targets: torch.Tensor,
    cls_targets: torch.Tensor,
    seg_loss_name: str = "bce",
    cls_loss_weight: float = 1.0,
    sample_mask: torch.Tensor | None = None,
    pos_weight: float | torch.Tensor | None = None,
    group: Group = None,
    space=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, seg, cls) multitask loss (JAX ``multitask_loss``).

    ``seg_logits`` (N, H, W, 1) from the 1-channel head, ``cls_logits`` (N,
    K). Seg: Lovasz hinge for ``lovasz_hinge``, every other name BCE (as the
    reference), with the opt-in ``pos_weight`` (off by default: the
    reference never weights it) and the padded samples' pixels masked.
    Cls: per-sample CE, averaged over the valid samples. total = seg +
    ``cls_loss_weight`` * cls. ``space``: the seg maps are bands, and each
    image's class CE is counted by space index 0 only (module docstring).
    """
    seg_flat = seg_logits[..., 0]
    if seg_loss_name == "lovasz_hinge":
        seg_l = lovasz_hinge(seg_flat, seg_targets.float(), sample_mask=sample_mask, group=group,
                             space=space)
    else:
        pix_mask = None
        if sample_mask is not None:
            pix_mask = sample_mask.float()[:, None, None].expand_as(seg_flat)
        seg_l = bce_with_logits(seg_flat, seg_targets.float(), pos_weight=pos_weight,
                                mask=pix_mask, group=group)
    log_probs = torch.log_softmax(cls_logits.float(), dim=-1)
    per_sample_nll = -log_probs.gather(1, cls_targets.long()[:, None])[:, 0]
    m = None if sample_mask is None else sample_mask.float()
    if space is not None:
        m = (per_sample_nll.new_ones(per_sample_nll.shape) if m is None else m) * float(space.first)
    if m is not None:
        if group is not None:
            cls_l = _global_ratio((per_sample_nll * m).sum(), m.sum(), group, 1.0)
        else:
            cls_l = (per_sample_nll * m).sum() / m.sum().clamp_min(1.0)
    elif group is not None:
        cls_l = _global_ratio(per_sample_nll.sum(), per_sample_nll.numel(), group, 1.0)
    else:
        cls_l = per_sample_nll.mean()
    return seg_l + cls_loss_weight * cls_l, seg_l, cls_l
