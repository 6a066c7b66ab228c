"""The port's kernel Functions' gradients against ``jax.vjp``, in float32 on the CPU.

The same numpy inputs and output cotangents go to both sides. On the CPU
the Functions run the kernels' plain versions forward and backward
(``conv3x3_bias_relu_plain`` / ``conv3x3_dgrad_plain`` and
``upsample2x_plain`` / ``upsample2x_backward_plain``); the CUDA kernels are
held against those on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). JAX runs at matmul precision "highest"
(``tests/conftest.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unet_embroidery_seg_tpu.ops import resize as jax_resize
from unet_embroidery_seg_torch.ops.conv3x3 import (
    conv3x3_bias_relu,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
)
from unet_embroidery_seg_torch.ops.upsample import (
    inverse_taps,
    upsample2x,
    upsample2x_backward,
    upsample2x_backward_plain,
)

# (N, H, W, C): odd and even H and W, C in {8, 64}.
SHAPES = [(2, 7, 9, 8), (1, 8, 6, 8), (2, 5, 4, 64), (1, 6, 11, 64)]


def _nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> NCHW tensor in channels_last memory (the same bytes)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _conv_case(shape, seed):
    n, h, w, c = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    g = rng.randn(n, h, w, c).astype(np.float32)
    return x, w_hwio, b, g


def _jax_conv_vjp(x, w_hwio, b, g):
    def f(x, w, b):
        y = jax.lax.conv_general_dilated(x, w, (1, 1), "SAME",
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jax.nn.relu(y + b)

    y, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w_hwio), jnp.asarray(b))
    return [np.asarray(v) for v in (y, *vjp(jnp.asarray(g)))]


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_function_backward_matches_jax_vjp(shape):
    x, w_hwio, b, g = _conv_case(shape, seed=sum(shape))
    y_j, dx_j, dw_j, db_j = _jax_conv_vjp(x, w_hwio, b, g)
    xt = _nchw(x).requires_grad_()
    wt = _oihw(w_hwio).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_()
    y = conv3x3_bias_relu(xt, wt, bt)
    dx, dw, db = torch.autograd.grad(y, (xt, wt, bt), _nchw(g))
    # f32 both sides; fan-in 9*C <= 576 products of O(1) terms (dx, y), sums
    # over N*H*W <= 132 pixels (dW, db): f32 summation order only.
    np.testing.assert_allclose(_nhwc(y), y_j, rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(dx), dx_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(), dw_j, rtol=0, atol=1e-4)
    np.testing.assert_allclose(db.numpy(), db_j, rtol=0, atol=1e-4)
    assert dw.dtype == db.dtype == torch.float32


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_dgrad_plain_matches_jax_vjp_of_the_conv(shape):
    # dgrad alone: the VJP of the bare conv (no bias, no ReLU) in x.
    x, w_hwio, _, g = _conv_case(shape, seed=sum(shape) + 1)

    def conv(x):
        return jax.lax.conv_general_dilated(x, jnp.asarray(w_hwio), (1, 1), "SAME",
                                            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    _, vjp = jax.vjp(conv, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    before = conv3x3_dgrad.launches
    for fn in (conv3x3_dgrad_plain, conv3x3_dgrad):  # the wrapper takes the plain version here
        got = fn(_nchw(g), _oihw(w_hwio))
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(_nhwc(got), want, rtol=0, atol=1e-4)  # f32, 9*C terms
    assert conv3x3_dgrad.launches == before  # no kernel on the CPU


def test_conv3x3_function_grad_is_zero_where_relu_is_off():
    x, w_hwio, b, g = _conv_case((1, 5, 5, 8), seed=3)
    xt = _nchw(x).requires_grad_()
    bt = torch.from_numpy(b - 100.0).requires_grad_()  # every output below zero
    y = conv3x3_bias_relu(xt, _oihw(w_hwio), bt)
    assert torch.count_nonzero(y) == 0
    dx, db = torch.autograd.grad(y, (xt, bt), _nchw(g))
    assert torch.count_nonzero(dx) == 0 and torch.count_nonzero(db) == 0


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_upsample_function_backward_matches_jax_vjp(shape, align_corners):
    n, h, w, c = shape
    rng = np.random.RandomState(sum(shape) + int(align_corners))
    x = rng.randn(n, h, w, c).astype(np.float32)
    g = rng.randn(n, 2 * h, 2 * w, c).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: jax_resize.upsample2x(a, align_corners=align_corners),
                       jnp.asarray(x))
    dx_j = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _nchw(x).requires_grad_()
    y = upsample2x(xt, align_corners)
    (dx,) = torch.autograd.grad(y, xt, _nchw(g))
    # f32 both sides; each input sums <= 16 weighted taps of O(1) values.
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(dx), dx_j, rtol=0, atol=1e-5)
    plain = upsample2x_backward_plain(_nchw(g), align_corners)
    np.testing.assert_allclose(_nhwc(plain), dx_j, rtol=0, atol=1e-5)
    before = upsample2x_backward.launches
    torch.testing.assert_close(upsample2x_backward(_nchw(g), align_corners), plain,
                               rtol=0, atol=0)
    assert upsample2x_backward.launches == before  # no kernel on the CPU


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [1, 2, 3, 15, 16, 30, 64, 255, 256])
def test_inverse_taps_are_the_transposed_interpolation_matrix(size, align_corners):
    # The backward kernel sums through these tables: rebuilt into a matrix
    # they must be the forward's (2*size, size) matrix exactly.
    idx, wgt = inverse_taps(size, align_corners)
    assert idx.shape[1] <= 4 and idx.dtype == np.int32 and wgt.dtype == np.float32
    m = np.zeros((2 * size, size), np.float32)
    for i in range(size):
        for k in range(idx.shape[1]):
            m[idx[i, k], i] += wgt[i, k]
    np.testing.assert_array_equal(m, jax_resize._interp_matrix(size, 2 * size, align_corners))
