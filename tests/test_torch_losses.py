"""The port's binary losses, metrics, schedules and Adam against the JAX package, on the CPU.

The same numpy inputs go to both sides, in float32. Gradients are held
against ``jax.grad``. The Lovasz hinge is compared per pixel on inputs
without tied hinge errors: the loss does not depend on how ties sort, the
per-pixel gradient can, and the JAX package's ``lax.sort`` promises no order
for them. On inputs built to tie, the loss and each tied group's summed
gradient are compared: a group at sorted positions [a, b] sums to
J(b) - J(a - 1), whatever its order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.ops import losses as jax_losses
from unet_embroidery_seg_tpu.ops import metrics as jax_metrics
from unet_embroidery_seg_tpu.ops import schedules as jax_schedules
from unet_embroidery_seg_tpu.ops.flat_adam import TreeAdam
from unet_embroidery_seg_torch.ops import losses, metrics, schedules

N, H, W = 3, 9, 7


def _case(seed, two_class=False):
    rng = np.random.RandomState(seed)
    shape = (N, H, W, 2) if two_class else (N, H, W)
    logits = (2.0 * rng.randn(*shape)).astype(np.float32)  # continuous: no ties
    targets = (rng.rand(N, H, W) < 0.3).astype(np.int32)
    return logits, targets


LOSS_CASES = [
    ("bce", None, None, False),
    ("bce", 4.5, None, False),
    ("bce", 4.5, [1.0, 1.0, 0.0], False),   # a padded tail sample
    ("bce", None, None, True),               # 2-class logits
    ("lovasz_hinge", None, None, False),
    ("lovasz_hinge", None, [1.0, 0.0, 1.0], False),
    ("lovasz_hinge", None, None, True),
]


@pytest.mark.parametrize("loss_name,pos_weight,sample_mask,two_class", LOSS_CASES)
def test_binary_segmentation_loss_and_grad_match_jax(loss_name, pos_weight, sample_mask, two_class):
    logits, targets = _case(seed=len(loss_name) + int(two_class), two_class=two_class)
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)

    def jax_loss(lg):
        return jax_losses.binary_segmentation_loss(
            lg, jnp.asarray(targets), loss_name=loss_name, pos_weight=pos_weight,
            sample_mask=None if sm is None else jnp.asarray(sm))

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = losses.binary_segmentation_loss(
        lt, torch.from_numpy(targets), loss_name=loss_name, pos_weight=pos_weight,
        sample_mask=None if sm is None else torch.from_numpy(sm))
    (got_grad,) = torch.autograd.grad(got, lt)
    # f32 both sides; sums over <= 189 pixels of O(1) terms (the Lovasz
    # cumsums included): f32 summation order only.
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)
    if sm is not None:  # the padded sample gets no gradient
        assert torch.count_nonzero(got_grad[sm == 0]) == 0


def test_lovasz_per_image_and_mean_match_jax():
    logits, targets = _case(seed=11)
    want = np.asarray(jax_losses.lovasz_hinge_per_image(jnp.asarray(logits), jnp.asarray(targets)))
    got = losses.lovasz_hinge_per_image(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    mean = losses.lovasz_hinge(torch.from_numpy(logits), torch.from_numpy(targets))
    np.testing.assert_allclose(mean.item(), want.mean(), rtol=1e-6, atol=1e-6)
    # a 2-D (H, W) input is one image
    one = losses.lovasz_hinge(torch.from_numpy(logits[0]), torch.from_numpy(targets[0]))
    np.testing.assert_allclose(one.item(), want[0], rtol=1e-6, atol=1e-6)


def _tied_case(seed):
    """(N, 32, 32) logits on a few levels, most of each image one flat mask-0 region.

    Like a resident batch: gray fill outside the pasted rectangle, where the
    model's logit is constant and the mask 0. Label-1 pixels take logits in
    {-1, 0.5, 2} and label-0 pixels in {-0.75, 0.25, 1.5}: every tie of
    hinge errors (1 - logit * sign) lies within one label.
    """
    rng = np.random.RandomState(seed)
    targets = np.zeros((2, 32, 32), np.int32)
    targets[:, 8:20, 6:22] = rng.rand(2, 12, 16) < 0.5
    logits = np.where(targets == 1, rng.choice([-1.0, 0.5, 2.0], targets.shape),
                      rng.choice([-0.75, 0.25, 1.5], targets.shape)).astype(np.float32)
    logits[:, 20:, :] = 0.25  # the flat fill: one large tied group per image
    return logits, targets


def _assert_group_sums_equal(keys, got, want):
    """Per image, the gradient summed over each group of equal ``keys`` (float64) agrees to 1e-6."""
    for k, g, w in zip(keys, got, want):
        for value in np.unique(k):
            sel = k == value
            assert abs(g[sel].astype(np.float64).sum() - w[sel].astype(np.float64).sum()) <= 1e-6


@pytest.mark.parametrize("sample_mask", [None, [1.0, 0.0]])
def test_lovasz_tied_errors_match_jax_by_group(sample_mask):
    logits, targets = _tied_case(seed=4)
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)

    def jax_loss(lg):
        return jax_losses.lovasz_hinge(lg, jnp.asarray(targets),
                                       None if sm is None else jnp.asarray(sm))

    want, want_grad = jax.value_and_grad(jax_loss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = losses.lovasz_hinge(lt, torch.from_numpy(targets),
                              None if sm is None else torch.from_numpy(sm))
    (got_grad,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    errors = 1.0 - logits * (2.0 * targets - 1.0)
    _, counts = np.unique(errors[0], return_counts=True)
    assert counts.max() > 300  # the flat region is one group
    _assert_group_sums_equal(errors.reshape(2, -1), got_grad.numpy().reshape(2, -1),
                             np.asarray(want_grad).reshape(2, -1))


def test_lovasz_errors_with_mixed_label_ties_match_jax_by_group():
    # Ties across labels too: the per-pixel coefficient depends on the order
    # within a group, the group's sum does not.
    rng = np.random.RandomState(5)
    errors = rng.choice([-0.5, 0.25, 1.0, 1.75], (3, 400)).astype(np.float32)
    labels = (rng.rand(3, 400) < 0.4).astype(np.float32)
    want, vjp = jax.vjp(lambda e: jax_losses._lovasz_errors_loss(e, jnp.asarray(labels)),
                        jnp.asarray(errors))
    (want_grad,) = vjp(jnp.ones(3, jnp.float32))
    et = torch.from_numpy(errors).requires_grad_()
    got = losses._LovaszErrorsLoss.apply(et, torch.from_numpy(labels))
    (got_grad,) = torch.autograd.grad(got.sum(), et)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    _assert_group_sums_equal(errors, got_grad.numpy(), np.asarray(want_grad))


@pytest.mark.parametrize("loss_name", ["bce", "lovasz_hinge"])
def test_ignore_index_matches_jax_approximation(loss_name):
    # Lovasz keeps the JAX package's approximate neutralisation (label to
    # the logit's sign, logit to +-1e3), not an exact mask.
    logits, targets = _case(seed=21)
    targets = targets.copy()
    targets[:, :2] = 255
    want, want_grad = jax.value_and_grad(lambda lg: jax_losses.binary_segmentation_loss(
        lg, jnp.asarray(targets), loss_name=loss_name, ignore_index=255))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    got = losses.binary_segmentation_loss(lt, torch.from_numpy(targets), loss_name=loss_name,
                                          ignore_index=255)
    (got_grad,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_grad.numpy(), np.asarray(want_grad), rtol=0, atol=1e-6)


def test_binary_logits_from_two_class_rejects_other_shapes():
    with pytest.raises(ValueError):
        losses.binary_logits_from_two_class(torch.zeros(2, 4, 4, 3))


@pytest.mark.parametrize("ignore_index,sample_mask", [(None, None), (None, [1, 1, 0]),
                                                      (255, [0, 1, 1])])
def test_confusion_counts_and_metrics_match_jax(ignore_index, sample_mask):
    rng = np.random.RandomState(5)
    pred = (rng.rand(N, H, W) < 0.4).astype(np.int32)
    target = (rng.rand(N, H, W) < 0.3).astype(np.int32)
    if ignore_index is not None:
        target[:, 0] = ignore_index
    sm = None if sample_mask is None else np.asarray(sample_mask, np.float32)
    want = np.asarray(jax_metrics.binary_confusion_counts(
        jnp.asarray(pred), jnp.asarray(target), ignore_index=ignore_index,
        sample_mask=None if sm is None else jnp.asarray(sm)))
    got = metrics.binary_confusion_counts(
        torch.from_numpy(pred), torch.from_numpy(target), ignore_index=ignore_index,
        sample_mask=None if sm is None else torch.from_numpy(sm))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64
    assert metrics.binary_metrics_from_counts(*got.tolist()) == \
        jax_metrics.binary_metrics_from_counts(*want.tolist())


@pytest.mark.parametrize("decay,epochs", [("cos", 1), ("cos", 5), ("cos", 50), ("cos", 300),
                                          ("step", 10), ("step", 50), ("step", 300)])
def test_schedule_epoch_by_epoch_matches_jax(decay, epochs):  # step needs >= 10 epochs
    for batch_size in (2, 8, 32):
        ours = schedules.resolve_init_lrs(batch_size, init_lr=3e-4)
        assert ours == jax_schedules.resolve_init_lrs(batch_size, init_lr=3e-4)
        f = schedules.get_lr_scheduler(decay, *ours, epochs)
        g = jax_schedules.get_lr_scheduler(decay, *ours, epochs)
        assert [f(e) for e in range(epochs)] == [g(e) for e in range(epochs)]


def test_adam_matches_jax_tree_adam_over_five_steps():
    # TreeAdam (param_dtype f32) against the port's torch.optim.Adam: coupled
    # L2 weight decay, bias correction from step 1, and a learning-rate
    # change between steps (the per-epoch schedule).
    rng = np.random.RandomState(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 3, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()} for _ in range(5)]
    lrs = [1e-3, 1e-3, 5e-4, 5e-4, 2e-4]
    tx = TreeAdam(lrs[0], b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4, param_dtype=jnp.float32)
    state = tx.init(jax.tree.map(jnp.asarray, params))
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = schedules.make_train_optimizer(tparams.values(), lrs[0], momentum=0.9,
                                         weight_decay=1e-4)
    for lr, g in zip(lrs, grads):
        state = jax_schedules.set_learning_rate(state, lr)
        _, state = tx.apply_grads(jax.tree.map(jnp.asarray, g), state)
        schedules.set_learning_rate(opt, lr)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k, p in tparams.items():
        moved = np.abs(p.detach().numpy() - params[k]).min()
        assert moved > 1e-4  # every weight took five steps of ~lr
        # f32 both sides, the same formula in another order of operations:
        # the O(1) weights agree to a few f32 ulps (1e-6), 1/200 of one step.
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(state.master[k]), rtol=0,
                                   atol=1e-6)


def test_adam_step_bumps_every_parameter_version():
    # The conv kernel's packed-weight cache (grad-off calls, e.g. eval after
    # training) keys on the parameter's version counter: the optimizer's
    # update must bump it. The port's Adam is foreach (fused=True does not
    # bump it: its update bypasses the counter).
    params = [torch.nn.Parameter(torch.randn(4, 4, 3, 3)), torch.nn.Parameter(torch.randn(4))]
    opt = schedules.make_train_optimizer(params, 1e-3)
    assert opt.defaults["foreach"] and not opt.defaults["fused"]
    for p in params:
        p.grad = torch.randn_like(p)
    before = [p._version for p in params]
    opt.step()
    assert all(p._version > v for p, v in zip(params, before))
