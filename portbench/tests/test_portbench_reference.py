"""The plain reference against the program's CPU path (its operators' plain versions), small."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import check, gen, harness
from portbench.reference import augment as ref_aug
from portbench.reference import models as ref_models
from portbench.reference import train as ref_train

CONFIGS = ("unet_resnet50", "unet_plain")


def _config(name: str) -> dict:
    return harness.load_json(harness.PKG / "configs" / f"{name}.json")


def _pair(name: str, diff: bool, seed: int = 5):
    from unet_embroidery_seg_torch.models import build_model

    config = _config(name)
    ref = ref_models.build(config, diff)
    weights = gen.weights(gen.init_spec(ref), seed, "cpu")
    ref.load_state_dict(weights)
    port = build_model(name, 2, diff_head=diff, device="cpu")
    port.load_state_dict(weights)
    return ref, port


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_keys_and_shapes_match(name):
    ref, port = _pair(name, diff=True)
    assert {k: v.shape for k, v in ref.state_dict().items()} == \
        {k: v.shape for k, v in port.state_dict().items()}
    assert [n for n, _ in ref.named_parameters()] == [n for n, _ in port.named_parameters()]


@pytest.mark.parametrize("name", CONFIGS)
def test_eval_forward_matches_the_programs_cpu_path(name):
    ref, port = _pair(name, diff=False)
    x = gen.predict_batch(3, 0, 2, 64, "cpu").permute(0, 3, 1, 2)
    with torch.no_grad():
        want = ref.eval()(x)
        got = port.eval()(x.contiguous(memory_format=torch.channels_last))
    # float32 on both sides; sums in another order
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.parametrize("name,loss", [("unet_resnet50", "lovasz_hinge"), ("unet_plain", "bce")])
def test_train_step_matches_the_programs_cpu_path(name, loss):
    from unet_embroidery_seg_torch.engine import steps
    from unet_embroidery_seg_torch.ops import schedules

    ref, port = _pair(name, diff=True)
    images, masks, wh = gen.split(9, 4, 64, "cpu")
    x, t = ref_train.batch(9, 0, 0, (images, masks, wh), (64, 64), True)
    pos_weight = gen.pos_weight(masks) if loss == "bce" else None
    want = ref_train.run_steps(ref, [(x, t)], loss, pos_weight, 1e-4, 1e-4, "f32")
    opt = schedules.make_train_optimizer(port.parameters(), 1e-4, weight_decay=1e-4)
    step = steps.make_binary_train_step(port, opt, loss, pos_weight, amp=False)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    got_loss = float(step(x.permute(0, 2, 3, 1), t, torch.ones(4)))
    got = ref_train.Readings(
        [got_loss],
        {n: float(opt.state[p]["exp_avg"].norm()) / 0.1 for n, p in port.named_parameters()},
        {n: float((p.detach() - before[n]).norm()) for n, p in port.named_parameters()})
    gaps = check.train_gaps(got, want)
    # float32 on both sides: the loss to rounding; the first gradient's leaves to the
    # network's own conditioning at this size (a deep BN net amplifies rounding)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap_median_leaf"] < 1e-3 and gaps["grad_gap"] < 0.05


def test_reference_augmentation_is_the_programs_bit_for_bit():
    from unet_embroidery_seg_torch.ops import device_augment

    images, masks, wh = gen.split(11, 6, 96, "cpu")
    _, aug_seed = ref_aug.step_seeds(11, 2, 5)
    params = device_augment.sample_params(torch.Generator().manual_seed(aug_seed), 6)
    got = device_augment.augment_batch(images, masks, wh, params=params, out_hw=(64, 64))
    want = ref_aug.augment(images, masks, wh,
                           ref_aug.sample_params(torch.Generator().manual_seed(aug_seed), 6),
                           (64, 64))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    from unet_embroidery_seg_torch.engine import resident
    assert resident.step_seeds(11, 2, 5) == ref_aug.step_seeds(11, 2, 5)


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([448.0, 1.0, 1.0625, 1.125, -3.0])  # largest magnitude 448: scale 1
    q = ref_models.fp8_round(t).float()
    assert q[0] == 448.0 and q[1] == 1.0 and q[3] == 1.125 and q[4] == -3.0
    assert q[2] in (1.0, 1.125)  # e4m3 holds three mantissa bits


def test_inputs_depend_only_on_the_seed():
    a = gen.split_rows(2**33 + 1, [3, 0], 64, "cpu")
    b = gen.split(2**33 + 1, 4, 64, "cpu")
    assert torch.equal(a[0], b[0][[3, 0]]) and torch.equal(a[1], b[1][[3, 0]])
    assert torch.equal(a[2], b[2][[3, 0]])
    idx, mask = gen.plan(13, 4, 1, 2**40)
    assert idx.shape == (4, 4) and mask.sum() == 13 and sorted(set(idx.ravel())) == list(range(13))
    assert not np.array_equal(idx, gen.plan(13, 4, 2, 2**40)[0])
