"""The packed decoder tail (``tests/torch_alternates.py``) against JAX's and the port's unpacked ops.

The cases of ``tests/test_packed_tail.py``, on numpy inputs from a seed,
f32 on the CPU: each function against ``unet_embroidery_seg_tpu.ops.
packed_tail`` (NHWC there; the port's NCHW tensors compared through their
NHWC view), and the whole tail against the port's own unpacked ops (their
plain versions on the CPU: ``upsample2x``, ``conv3x3_bias_relu``, the 1x1
head), with gradients. Tolerances: the data movers exactly; a product of
sums in another order to 1e-5 of the output's scale (f32, sums of 9 x C
terms at most), the whole tail and the gradients to 1e-4, as JAX's own
test holds them.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

import torch_alternates as pt
from unet_embroidery_seg_tpu.ops import packed_tail as jax_pt
from unet_embroidery_seg_torch.ops.conv3x3 import conv3x3_bias_relu
from unet_embroidery_seg_torch.ops.upsample import upsample2x


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _close(got: np.ndarray, want: np.ndarray, rel: float) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1.0, np.abs(want).max()))


@pytest.fixture()
def rng():
    return np.random.RandomState(7)


# --- the layout: exact -------------------------------------------------------------------------


def test_space_depth_roundtrip_and_jax_layout(rng):
    x = rng.rand(2, 8, 6, 3).astype(np.float32)
    packed = pt.space_to_depth2(_nchw(x))
    np.testing.assert_array_equal(_nhwc(packed), np.asarray(jax_pt.space_to_depth2(x)))
    assert packed.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(_nhwc(pt.depth_to_space2(packed)), x)
    np.testing.assert_array_equal(_nhwc(pt.depth_to_space2(packed)),
                                  np.asarray(jax_pt.depth_to_space2(jax_pt.space_to_depth2(x))))


def test_phase_order_pqc(rng):
    """Packed channel (p * 2 + q) * C + c holds pixel (2i + p, 2j + q, c)."""
    x = rng.rand(1, 4, 4, 2).astype(np.float32)
    packed = _nhwc(pt.space_to_depth2(_nchw(x)))
    for p in (0, 1):
        for q in (0, 1):
            for c in (0, 1):
                np.testing.assert_array_equal(packed[0, :, :, (p * 2 + q) * 2 + c],
                                              x[0, p::2, q::2, c])


def test_labels_match_the_logits_phases_and_jax(rng):
    y = rng.randint(0, 2, (2, 8, 8)).astype(np.int32)
    got = pt.space_to_depth2_labels(torch.from_numpy(y))
    assert got.shape == (2, 4, 4, 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jax_pt.space_to_depth2_labels(y)))
    logits_like = pt.space_to_depth2(torch.from_numpy(y)[:, None].float())
    np.testing.assert_array_equal(got.float().numpy(), logits_like.numpy())


# --- each op against JAX's and the port's unpacked op -----------------------------------------


@pytest.mark.parametrize("align_corners", [True, False])
def test_packed_upsample(rng, align_corners):
    x = rng.rand(2, 16, 12, 8).astype(np.float32)
    got = pt.packed_upsample2x(_nchw(x), align_corners=align_corners)
    _close(_nhwc(got), np.asarray(jax_pt.packed_upsample2x(jnp.asarray(x), align_corners)), 1e-6)
    unpacked = upsample2x(_nchw(x), align_corners)
    _close(_nhwc(pt.depth_to_space2(got)), _nhwc(unpacked), 1e-6)


def test_phase_kernel_is_jax_phase_kernel(rng):
    w = rng.randn(3, 3, 4, 5).astype(np.float32)
    for p in (0, 1):
        for q in (0, 1):
            want = np.asarray(jax_pt._phase_kernel(jnp.asarray(w), p, q))  # [2, 2, 4C, O]
            got = pt._phase_kernel(_oihw(w), p, q)  # [O, 4C, 2, 2]
            np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)


def test_packed_conv3x3(rng):
    x = rng.randn(2, 32, 32, 8).astype(np.float32)
    w = (rng.randn(3, 3, 8, 5) * 0.2).astype(np.float32)
    b = (rng.randn(5) * 0.1).astype(np.float32)
    got = pt.packed_conv3x3(pt.space_to_depth2(_nchw(x)), _oihw(w), torch.from_numpy(b))
    want = jax_pt.packed_conv3x3(jax_pt.space_to_depth2(jnp.asarray(x)), jnp.asarray(w),
                                 jnp.asarray(b))
    _close(_nhwc(got), np.asarray(want), 1e-5)
    unpacked = F.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b), padding=1)
    _close(_nhwc(pt.depth_to_space2(got)), _nhwc(unpacked), 1e-5)


def test_packed_conv1x1(rng):
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    w = (rng.randn(1, 1, 8, 3) * 0.2).astype(np.float32)
    b = (rng.randn(3) * 0.1).astype(np.float32)
    got = pt.packed_conv1x1(pt.space_to_depth2(_nchw(x)), _oihw(w), torch.from_numpy(b))
    want = jax_pt.packed_conv1x1(jax_pt.space_to_depth2(jnp.asarray(x)), jnp.asarray(w),
                                 jnp.asarray(b))
    _close(_nhwc(got), np.asarray(want), 1e-5)
    unpacked = F.conv2d(_nchw(x), _oihw(w), torch.from_numpy(b))
    _close(_nhwc(pt.depth_to_space2(got)), _nhwc(unpacked), 1e-5)


# --- the whole tail and its gradients ----------------------------------------------------------


def _tail_params(rng, c: int = 8, k: int = 2) -> dict:
    return {"w1": (rng.randn(3, 3, c, c) * 0.2).astype(np.float32),
            "b1": (rng.randn(c) * 0.1).astype(np.float32),
            "w2": (rng.randn(3, 3, c, c) * 0.2).astype(np.float32),
            "b2": (rng.randn(c) * 0.1).astype(np.float32),
            "wh": (rng.randn(1, 1, c, k) * 0.2).astype(np.float32),
            "bh": (rng.randn(k) * 0.1).astype(np.float32)}


def _torch_params(params: dict) -> dict:
    return {n: (_oihw(a) if a.ndim == 4 else torch.from_numpy(a)).requires_grad_(True)
            for n, a in params.items()}


def packed_tail(x: torch.Tensor, t: dict) -> torch.Tensor:
    """upsample -> conv + ReLU -> conv + ReLU -> head, packed; the logits unpacked."""
    u = pt.packed_upsample2x(x, align_corners=True)
    y = F.relu(pt.packed_conv3x3(u, t["w1"], t["b1"]))
    y = F.relu(pt.packed_conv3x3(y, t["w2"], t["b2"]))
    return pt.depth_to_space2(pt.packed_conv1x1(y, t["wh"], t["bh"]))


def unpacked_tail(x: torch.Tensor, t: dict) -> torch.Tensor:
    """The same stage through the port's ops (the kernels' wrappers)."""
    u = upsample2x(x, True)
    y = conv3x3_bias_relu(u, t["w1"], t["b1"])
    y = conv3x3_bias_relu(y, t["w2"], t["b2"])
    return F.conv2d(y, t["wh"], t["bh"])


def test_full_tail_equals_jax_and_the_unpacked_tail(rng):
    x = rng.randn(2, 16, 16, 8).astype(np.float32)
    params = _tail_params(rng)
    got = packed_tail(_nchw(x), _torch_params(params))
    j = {n: jnp.asarray(a) for n, a in params.items()}
    up = jax_pt.packed_upsample2x(jnp.asarray(x), align_corners=True)
    yp = jax.nn.relu(jax_pt.packed_conv3x3(up, j["w1"], j["b1"]))
    yp = jax.nn.relu(jax_pt.packed_conv3x3(yp, j["w2"], j["b2"]))
    want = jax_pt.depth_to_space2(jax_pt.packed_conv1x1(yp, j["wh"], j["bh"]))
    _close(_nhwc(got), np.asarray(want), 1e-4)
    _close(_nhwc(got), _nhwc(unpacked_tail(_nchw(x), _torch_params(params))), 1e-4)


def test_gradients_equal_the_unpacked_tail_and_jax(rng):
    """The same loss -> the same gradients of every parameter and of the input."""
    x = rng.randn(1, 8, 8, 4).astype(np.float32)
    params = _tail_params(rng, c=4, k=3)
    tgt = rng.randn(1, 16, 16, 3).astype(np.float32)
    tgt4 = rng.randn(1, 16, 16, 4).astype(np.float32)
    grads = {}
    for name, fn in (("packed", packed_tail), ("unpacked", unpacked_tail)):
        t, xt = _torch_params(params), _nchw(x).requires_grad_(True)
        ((fn(xt, t) - _nchw(tgt)) ** 2).sum().backward()
        grads[name] = {n: v.grad for n, v in t.items()} | {"x": xt.grad}
    for n, g in grads["unpacked"].items():
        _close(grads["packed"][n].numpy(), g.numpy(), 1e-4)

    def jax_loss(w):  # JAX's own gradient check: the first conv's weight, no bias
        y = jax_pt.packed_conv3x3(jax_pt.packed_upsample2x(jnp.asarray(x), True), w, None)
        return jnp.sum((jax_pt.depth_to_space2(y) - jnp.asarray(tgt4)) ** 2)

    w = torch.from_numpy(_oihw(params["w1"]).numpy()).requires_grad_(True)
    y = pt.packed_conv3x3(pt.packed_upsample2x(_nchw(x), True), w, None)
    ((pt.depth_to_space2(y) - _nchw(tgt4)) ** 2).sum().backward()
    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(params["w1"])))
    _close(w.grad.permute(2, 3, 1, 0).numpy(), want, 1e-4)
