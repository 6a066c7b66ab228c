"""The port's on-device augmentation against ``unet_embroidery_seg_tpu/ops/device_augment.py``.

float32 on the CPU, letterboxed canvases of the synthetic source at 48^2
(JAX's ``CanvasCache``), batches of 4. ``augment_batch`` is fed the
parameters that JAX's ``_sample_params`` draws from its key, since torch's
generators and JAX's never draw the same numbers. The JAX functions run
jitted, as the package runs them (XLA turns a division by a constant into a
product with its reciprocal, which the port writes out). JAX resamples by
matmul with dense weight matrices, the port by a two-tap gather: the sums
differ by at most an FMA's rounding, so images are held within atol 1e-5
and masks equal, but for pixels whose source coordinate lies within 1e-4
of a ``.5`` rounding boundary (fewer than 1e-4 of all pixels).
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.data.cache import CanvasCache as JaxCanvasCache
from unet_embroidery_seg_tpu.data.sources import SyntheticSource
from unet_embroidery_seg_tpu.ops import device_augment as jda
from unet_embroidery_seg_torch.ops import device_augment as da

CANVAS, OUT, N = 48, 40, 4
TOL_IMAGE, TOL_BOUNDARY, MAX_BOUNDARY_SHARE = 1e-5, 1e-4, 1e-4


@pytest.fixture(scope="module")
def canvases():
    """Canvases with masks labelled 1..7 (``mask_classes=7``): labels >= K for multiclass."""
    src = SyntheticSource(split="train", length=N, mask_classes=7)
    return JaxCanvasCache(src, (CANVAS, CANVAS), verbose=False)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("binary,num_classes", [(True, None), (False, 4), (False, None)])
def test_preprocess_eval_batch_is_exact(canvases, binary, num_classes):
    want_img, want_mask = jda.preprocess_eval_batch(
        jnp.asarray(canvases.images), jnp.asarray(canvases.masks), binary=binary,
        num_classes=num_classes)
    img, mask = da.preprocess_eval_batch(_t(canvases.images), _t(canvases.masks), binary,
                                         num_classes)
    assert img.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))


def _hsv_probe_colours() -> np.ndarray:
    """Seeded RGB in [0, 1], plus ties between channel maxima and hues around the 0/180 wrap."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 256, (512, 3)) / 255.0  # uint8 levels: exact ties are common
    ties = np.array([[a, a, b] for a, b in rng.random((64, 2))]
                    + [[a, b, a] for a, b in rng.random((64, 2))]
                    + [[b, a, a] for a, b in rng.random((64, 2))]
                    + [[a, a, a] for a in rng.random(16)] + [[0, 0, 0], [1, 1, 1]])
    # red maximum with blue just above or below green: hue just below 180 or above 0
    eps = np.array([1e-3, 1e-5, 1e-7, 0.0])[rng.integers(0, 4, 128)]
    r, g = rng.uniform(0.5, 1.0, 128), rng.uniform(0.0, 0.5, 128)
    wrap = np.stack([r, g, g + np.where(rng.random(128) < 0.5, eps, -eps)], -1)
    return np.concatenate([rng.random((512, 3)), q, ties, np.clip(wrap, 0, 1)]).astype(np.float32)


def test_rgb_to_hsv_matches_jax():
    rgb = _hsv_probe_colours()
    want = [np.asarray(v) for v in jax.jit(jda.rgb_to_hsv_cv)(jnp.asarray(rgb))]
    got = [v.numpy() for v in da.rgb_to_hsv_cv(_t(rgb))]
    for g, w, name in zip(got, want, "hsv"):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=name)
    assert (want[0] > 179).any() and (want[0] < 1).any()  # the wrap is probed on both sides


def test_hsv_to_rgb_matches_jax():
    rng = np.random.default_rng(1)
    h = np.concatenate([rng.uniform(0, 180, 4096), np.arange(0, 180, 30.0),
                        np.arange(0, 180, 30.0) - 1e-4]).astype(np.float32) % 180
    s = rng.uniform(0, 255, h.shape).astype(np.float32)
    v = rng.uniform(0, 255, h.shape).astype(np.float32)
    want = np.asarray(jax.jit(jda.hsv_to_rgb_cv)(jnp.asarray(h), jnp.asarray(s), jnp.asarray(v)))
    got = da.hsv_to_rgb_cv(_t(h), _t(s), _t(v)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_hsv_jitter_matches_jax():
    rng = np.random.default_rng(2)
    img = _hsv_probe_colours()[: 4 * 16 * 16].reshape(4, 16, 16, 3)
    gains = (rng.uniform(-1, 1, (4, 3)) * [0.1, 0.7, 0.3] + 1).astype(np.float32)
    want = np.asarray(jax.jit(jda.hsv_jitter_device)(jnp.asarray(img), jnp.asarray(gains)))
    got = da.hsv_jitter_device(_t(img), _t(gains)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _boundary_pixels(canvases, params) -> np.ndarray:
    """(N, OUT, OUT): pixels whose nearest-sampling coordinate is within TOL_BOUNDARY of a .5."""
    yc, _, xc, _ = da.paste_coords(_t(canvases.valid_wh), params, (CANVAS, CANVAS), (OUT, OUT))

    def near(c):
        c = c.double() + 0.5
        return (c - c.round()).abs() < TOL_BOUNDARY

    return (near(yc)[:, :, None] | near(xc)[:, None, :]).numpy()


@pytest.mark.parametrize("flip", [True, False, None], ids=["flip", "no-flip", "drawn"])
@pytest.mark.parametrize("binary,num_classes", [(True, None), (False, 4)],
                         ids=["binary", "multiclass"])
def test_augment_batch_matches_jax_on_its_parameters(canvases, binary, num_classes, flip):
    key = jax.random.PRNGKey(7)
    drawn = jda._sample_params(key, N, 0.3, 0.1, 0.7, 0.3)
    if flip is not None:  # every sample flipped, or none
        drawn = (*drawn[:3], jnp.full((N,), flip), *drawn[4:])
    with mock.patch.object(jda, "_sample_params", lambda *a, **k: drawn):
        # a jit of its own (a new function: no trace cached from other parameters)
        want_img, want_mask = jax.jit(lambda *a: jda.augment_batch.__wrapped__(
            *a, out_hw=(OUT, OUT), binary=binary, num_classes=num_classes))(
            jnp.asarray(canvases.images), jnp.asarray(canvases.masks),
            jnp.asarray(canvases.valid_wh), key)
    params = tuple(_t(p) for p in drawn)
    img, mask = da.augment_batch(_t(canvases.images), _t(canvases.masks),
                                 _t(canvases.valid_wh), params=params, out_hw=(OUT, OUT),
                                 binary=binary, num_classes=num_classes)
    assert img.shape == (N, OUT, OUT, 3) and mask.shape == (N, OUT, OUT)
    assert img.dtype == torch.float32 and mask.dtype == torch.int32
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), rtol=0, atol=TOL_IMAGE)
    differ = mask.numpy() != np.asarray(want_mask)
    assert not (differ & ~_boundary_pixels(canvases, params)).any()
    assert differ.sum() <= MAX_BOUNDARY_SHARE * differ.size
    if not binary:  # labels >= K are the ignore class K
        assert mask.max().item() == num_classes and (canvases.masks > num_classes).any()


def test_augment_batch_takes_a_generator_or_parameters_not_both(canvases):
    args = (_t(canvases.images), _t(canvases.masks), _t(canvases.valid_wh))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="exactly one"):
        da.augment_batch(*args, gen, da.sample_params(gen, N), out_hw=(OUT, OUT))
    with pytest.raises(ValueError, match="exactly one"):
        da.augment_batch(*args, out_hw=(OUT, OUT))


def test_augment_batch_from_a_generator_is_its_sampled_parameters(canvases):
    args = (_t(canvases.images), _t(canvases.masks), _t(canvases.valid_wh))
    a = da.augment_batch(*args, torch.Generator().manual_seed(3), out_hw=(OUT, OUT))
    b = da.augment_batch(*args, params=da.sample_params(torch.Generator().manual_seed(3), N),
                         out_hw=(OUT, OUT))
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert 0.0 <= a[0].min() and a[0].max() <= 1.0 and set(a[1].unique().tolist()) <= {0, 1}


def test_sampler_is_seeded_and_keeps_its_ranges():
    # as tests/test_device_augment.py holds the JAX sampler
    n = 4000
    a = da.sample_params(torch.Generator().manual_seed(11), n)
    b = da.sample_params(torch.Generator().manual_seed(11), n)
    c = da.sample_params(torch.Generator().manual_seed(12), n)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not torch.equal(a[0], c[0])
    ar_a, ar_b, scale, flip, px, py, hsv_r = a
    for v, lo, hi in ((ar_a, 0.7, 1.3), (ar_b, 0.7, 1.3), (scale, 0.25, 2.0), (px, 0.0, 1.0),
                      (py, 0.0, 1.0)):
        assert v.dtype == torch.float32 and lo <= v.min() and v.max() <= hi
    assert flip.dtype == torch.bool and abs(flip.float().mean().item() - 0.5) < 0.03
    assert hsv_r.shape == (n, 3)
    for j, amp in enumerate((0.1, 0.7, 0.3)):
        assert 1 - amp <= hsv_r[:, j].min() and hsv_r[:, j].max() <= 1 + amp
