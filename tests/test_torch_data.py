"""The port's copies of the host input pipeline against the JAX package's.

Framework-free modules copied into the port (it imports nothing of the JAX
package): the synthetic source, the train augmentation, the eval letterbox,
the dataset's label encoding, and the loader's seed-and-epoch order and
``n_valid`` tail padding. Both sides must produce the same arrays.
"""

import numpy as np
import pytest

from unet_embroidery_seg_tpu.data import augment as jax_augment
from unet_embroidery_seg_tpu.data import dataset as jax_dataset
from unet_embroidery_seg_tpu.data import sources as jax_sources
from unet_embroidery_seg_torch.data import augment, dataset, sources


@pytest.mark.parametrize("split", ["train", "validation", "test"])
def test_synthetic_source_draws_the_same_samples(split):
    ours, theirs = sources.SyntheticSource(split=split), jax_sources.SyntheticSource(split=split)
    assert len(ours) == len(theirs)
    for i in (0, 3):
        a, b = ours[i], theirs[i]
        assert a["label"] == b["label"] and a["filename"] == b["filename"]
        np.testing.assert_array_equal(np.array(a["image"]), np.array(b["image"]))
        np.testing.assert_array_equal(np.array(a["mask"]), np.array(b["mask"]))


@pytest.mark.parametrize("augmentation", [True, False])
def test_dataset_items_equal_jax(augmentation):
    src = sources.SyntheticSource(split="train", length=5)
    ours = dataset.SegmentationDataset(src, (48, 64), 2, augmentation=augmentation,
                                       task="binary", seed=3)
    theirs = jax_dataset.SegmentationDataset(jax_sources.SyntheticSource(split="train", length=5),
                                             (48, 64), 2, augmentation=augmentation,
                                             task="binary", seed=3)
    for i in range(len(ours)):
        for epoch in (0, 2):
            a, b = ours.get(i, epoch), theirs.get(i, epoch)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])


def test_hsv_jitter_numpy_fallback_equals_jax(monkeypatch):
    # The card's machine has no cv2: the port's jitter takes its numpy path.
    import builtins

    real_import = builtins.__import__

    def no_cv2(name, *args, **kwargs):
        if name == "cv2":
            raise ImportError("no cv2")
        return real_import(name, *args, **kwargs)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (9, 11, 3), dtype=np.uint8)
    r = np.array([1.05, 0.8, 1.2])
    monkeypatch.setattr(jax_augment, "cv2", None)
    want = jax_augment.hsv_jitter(img, r)
    monkeypatch.setattr(builtins, "__import__", no_cv2)
    np.testing.assert_array_equal(augment.hsv_jitter(img, r), want)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_order_and_tail_padding_equal_jax(shuffle):
    src = sources.SyntheticSource(split="validation", length=5)
    ours = dataset.DataLoader(dataset.SegmentationDataset(src, (32, 32), 2, augmentation=False,
                                                          task="binary"),
                              batch_size=2, shuffle=shuffle, seed=7)
    theirs = jax_dataset.DataLoader(
        jax_dataset.SegmentationDataset(jax_sources.SyntheticSource(split="validation", length=5),
                                        (32, 32), 2, augmentation=False, task="binary"),
        batch_size=2, shuffle=shuffle, seed=7)
    got, want = list(ours.epoch(1)), list(theirs.epoch(1))
    assert [n for _, n in got] == [n for _, n in want] == [2, 2, 1]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.pngs, b.pngs)
    assert got[-1][0].images.shape[0] == 2  # the tail batch is padded to the batch size
