"""The predict call's page-locked staging (``engine/host_copy.py``) on the CPU: how a batch is
cut into chunks of whole images. The copies themselves run on a card only
(``tests/test_torch_cuda.py``)."""

import pytest

from unet_embroidery_seg_torch.engine import host_copy

IMAGE_UP = 480 * 480 * 3 * 4  # one predict canvas, NHWC float32
IMAGE_DOWN = 480 * 480 * 2 * 4  # its two-class probabilities


@pytest.mark.parametrize("n", [1, 7, 32, 33])
@pytest.mark.parametrize("item,chunk", [(IMAGE_UP, host_copy.CHUNK_BYTES),
                                        (IMAGE_DOWN, host_copy.CHUNK_BYTES),
                                        (IMAGE_UP, IMAGE_UP // 3),  # a chunk under one image
                                        (IMAGE_DOWN, 4 * IMAGE_DOWN),  # whole images exactly
                                        (12, 1 << 30)])  # the whole batch in one chunk
def test_chunks_cover_the_batch_in_order_with_whole_images(n, item, chunk):
    got = host_copy.chunks(n, item, chunk)
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))  # contiguous, non-overlapping
    assert all(i1 > i0 for i0, i1 in got)
    per = max(1, chunk // item)  # as many whole images as fit, and at least one
    assert [i1 - i0 for i0, i1 in got] == [min(per, n - i0) for i0, _ in got]
    assert all((i1 - i0) * item <= max(chunk, item) for i0, i1 in got)


def test_chunks_of_an_empty_batch_are_none():
    assert host_copy.chunks(0, IMAGE_UP) == []
