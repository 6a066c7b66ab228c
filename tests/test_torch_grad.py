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
from unet_embroidery_seg_torch.ops import upsample as upsample_mod
from unet_embroidery_seg_torch.ops.resize import band_input_rows
from unet_embroidery_seg_torch.ops.conv3x3 import (
    conv3x3_bias_relu,
    conv3x3_dgrad,
    conv3x3_dgrad_plain,
)
from unet_embroidery_seg_torch.ops.upsample import (
    BWD_BANDS,
    BWD_STRIPS,
    backward_reach,
    backward_taps,
    inverse_taps,
    tile_input_span,
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


# --- the backward kernel's tables and schedule (csrc/upsample2x_bwd.cu) --------


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("band", BWD_BANDS + BWD_STRIPS)
def test_backward_band_reads_at_most_2t_plus_2_outputs(band, align_corners):
    # A block streams the output rows (columns) its band (strip) of inputs
    # reads through a ring sized for 2 T + 2 of them; every 2x resize fits.
    for size in range(1, 1101):
        first, last = backward_reach(size, align_corners)
        assert tile_input_span(first, last, band) <= 2 * band + 2, size


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("size", [1, 2, 3, 15, 16, 17, 30, 33, 64, 255, 256])
def test_backward_taps_transpose_to_inverse_taps(size, align_corners):
    # Row pass (per output) and column pass (per input) multiply by the same
    # matrix entries, entry by entry, as the transposed contraction.
    i0, i1, w0, w1 = backward_taps(size, align_corners)
    per_output = {}
    for o in range(2 * size):
        per_output[(o, int(i0[o]))] = w0[o]
        if i1[o] != i0[o]:
            per_output[(o, int(i1[o]))] = w1[o]
        else:
            assert w1[o] == 0
    idx, wgt = inverse_taps(size, align_corners)
    per_input = {(int(idx[i, k]), i): wgt[i, k]
                 for i in range(size) for k in range(idx.shape[1]) if wgt[i, k] != 0}
    assert {k: v for k, v in per_output.items() if v != 0} == per_input
    first, last = backward_reach(size, align_corners)
    for i in range(size):  # every output that reads i, and no other
        reads = [o for o in range(2 * size) if i in (i0[o], i1[o])]
        assert (first[i], last[i]) == (reads[0], reads[-1])
        assert reads == list(range(first[i], last[i] + 1))


def _streamed_backward(g: np.ndarray, align_corners: bool, band: int, strip: int,
                       rows_band=None) -> np.ndarray:
    """numpy model of the backward kernel's schedule on NHWC ``g``, in float32.

    Reads the device tables as the kernel does (same layout and offsets),
    with the kernel's band and strip edges: per block, the output rows
    [first, last] of its band streamed top to bottom, each cut to the
    strip's output columns; a column pass over each input column's 4
    inverse taps; a row pass into the two rolling input-row accumulators,
    storing a row when i0 moves past it. Every dx element is written once.
    ``rows_band`` (H, r0, r1): the kernel's band mode (the mesh's space
    axis), g the band's output rows and dx its input rows, halo included.
    """
    n, oh, ow, c = g.shape
    h = oh // 2 if rows_band is None else band_input_rows(rows_band)[1]
    w = ow // 2
    cpu = torch.device("cpu")
    ridx, rw = (t.numpy() for t in upsample_mod._backward_tables(h, align_corners, cpu,
                                                                 rows_band))
    cidx, cw = (t.numpy() for t in upsample_mod._backward_tables(w, align_corners, cpu))
    dx = np.full((n, h, w, c), np.nan, np.float32)
    written = np.zeros((h, w), np.int32)
    taps = np.arange(4)
    for iy0 in range(0, h, band):
        nr = min(band, h - iy0)
        oy0 = ridx[oh + iy0]
        nrows = ridx[oh + h + iy0 + nr - 1] - oy0 + 1
        assert nrows <= 2 * band + 2
        for ix0 in range(0, w, strip):
            nc = min(strip, w - ix0)
            ox0 = cidx[ow + ix0]
            ncols = cidx[ow + w + ix0 + nc - 1] - ox0 + 1
            assert ncols <= 2 * strip + 2
            ix = ix0 + np.arange(nc)
            wx = cw[2 * ow + ix[:, None] * 4 + taps]                      # (nc, 4)
            off = np.where(wx != 0, cidx[ow + 2 * w + ix[:, None] * 4 + taps] - ox0, 0)
            assert off.min() >= 0 and off.max() < ncols

            def store(r, acc):
                if iy0 <= r < iy0 + nr:
                    dx[:, r, ix0 : ix0 + nc] = acc
                    written[r, ix0 : ix0 + nc] += 1

            rlo = ridx[oy0]
            lo = np.zeros((n, nc, c), np.float32)
            hi = np.zeros((n, nc, c), np.float32)
            for k in range(nrows):
                staged = g[:, oy0 + k, ox0 : ox0 + ncols]                 # (n, ncols, c)
                racc = np.zeros((n, nc, c), np.float32)
                for j in range(4):
                    racc += wx[None, :, j, None] * staged[:, off[:, j]]
                i0 = ridx[oy0 + k]
                if i0 != rlo:
                    assert i0 == rlo + 1
                    store(rlo, lo)
                    lo, hi, rlo = hi, np.zeros_like(hi), i0
                lo += rw[oy0 + k] * racc
                hi += rw[oh + oy0 + k] * racc
            store(rlo, lo)
            store(rlo + 1, hi)
    assert (written == 1).all()
    return dx


@pytest.mark.parametrize("band,strip", [(b, s) for b in BWD_BANDS for s in BWD_STRIPS])
@pytest.mark.parametrize("align_corners", [False, True])
def test_streamed_backward_schedule_matches_plain(band, strip, align_corners):
    # Odd sizes, sizes that leave a partial last band and strip, H = 1 and
    # W = 1: the kernel's index and weight logic against the transposed
    # contraction, without a card.
    rng = np.random.RandomState(band * 100 + strip + int(align_corners))
    for n, h, w, c in [(2, 7, 37, 3), (1, 19, 5, 2), (1, 1, 9, 2), (1, 6, 1, 3), (1, 34, 40, 1)]:
        g = rng.randn(n, 2 * h, 2 * w, c).astype(np.float32)
        got = _streamed_backward(g, align_corners, band, strip)
        want = _nhwc(upsample2x_backward_plain(_nchw(g), align_corners))
        # f32 both sides, <= 16 taps of O(1) values summed in another order.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("band,strip", [(2, 16), (4, 32), (16, 16)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_streamed_backward_schedule_matches_plain_over_a_band(band, strip, align_corners):
    # The band mode's tables (a band's output rows, its input rows with one
    # halo row each side inside the image) through the same schedule, at
    # the image's top, inside it and at its bottom.
    rng = np.random.RandomState(band + strip + int(align_corners))
    for h, r0, r1 in [(12, 0, 4), (12, 4, 8), (12, 8, 12), (37, 5, 29), (40, 0, 40)]:
        g = rng.randn(2, 2 * (r1 - r0), 2 * 9, 3).astype(np.float32)
        got = _streamed_backward(g, align_corners, band, strip, (h, r0, r1))
        want = _nhwc(upsample2x_backward_plain(_nchw(g), align_corners, (h, r0, r1)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("align_corners", [False, True])
def test_forward_band_tables_fit_every_tile(align_corners):
    # Every band of every size up to 300 rows: the indices lie in the band's
    # input rows and each tile's taps fit its staging area (checked inside).
    cpu = torch.device("cpu")
    for h in range(2, 301, 7):
        for r0, r1 in [(0, h // 2), (h // 2, h), (h // 3, 2 * h // 3)]:
            first, rows = band_input_rows((h, r0, r1))
            idx, _ = upsample_mod._device_tables(rows, align_corners, cpu, (h, r0, r1))
            assert idx.numel() == 4 * (r1 - r0)
            assert int(idx.min()) >= 0 and int(idx.max()) < rows
