"""conv3x3's dgrad on the forward's packing, on the CPU.

With grad on, the forward packs the weight once (``pack_conv3x3_grad``) and
its backward's dgrad reads that packing: the bf16 tensor-core kernel flips
and transposes it inside the kernel (tap 8 - t, each [co][64 ci] tile read
as an MN-major B through wgmma's transposed-B mode), the ``fma`` kernel by
index, and the ``tf32x3`` packing carries dgrad's planes beside the
forward's. The kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here numpy models of their reads are held, bit for bit,
against the layout the old composition packed for dgrad,
``pack_conv3x3_weight(_dgrad_weight(w))``, and the autograd Functions' dx
on the new operator signature against ``jax.vjp`` of the JAX package's conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_embroidery_seg_tpu.models import blocks as jax_blocks
from unet_embroidery_seg_torch.ops import conv3x3 as C

# csrc/conv3x3_same.cu: bytes of a shared-memory row, of one dgrad weight box
# (64 K' rows; the MN-major descriptor's LBO), of an 8-row swizzle atom (its
# SBO), and of a k16 step (16 K' rows).
ROW, DG_BOX, SBO, K_STEP = 128, 64 * 128, 1024, 16 * 128
SIZES = [16, 48, 64, 80, 128, 192, 1024]


def _weight(c: int, seed: int) -> torch.Tensor:
    rng = np.random.RandomState(seed)
    return torch.from_numpy((rng.randn(c, c, 3, 3) / np.sqrt(9 * c)).astype(np.float32))


def _bits(t: torch.Tensor) -> np.ndarray:
    """The raw bits of a bf16 or f32 tensor, for exact comparison (zeros' signs included)."""
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _mn_major_source(bn: int, nchunks: int):
    """Where the dgrad kernel's B'[k][n] of one (tap', K' chunk, N' tile) comes from.

    The producer loads, per weight stage, ``bn // 64`` TMA boxes of 64 rows
    (co = kc * 64 + r) x 64 input channels, box j from input-channel chunk
    ``nt * bn // 64 + j`` of the forward's tap 8 - tap', each with the
    128-byte swizzle, box j at byte j * DG_BOX. The consumer reads k16 step
    ks through the MN-major descriptor: K' row k at ks * K_STEP + (k // 8) *
    SBO + (k % 8) * ROW, N' column n at (n // 64) * LBO, the 16-byte unit
    swizzled by the row. Returns (box j, row r, element e) for every (k, n),
    k over 64 K' rows, n over ``bn`` N' columns, by inverting the TMA swizzle.
    """
    k, n = np.meshgrid(np.arange(64), np.arange(bn), indexing="ij")
    ks, k16 = k // 16, k % 16
    row_in_atom = k16 % 8
    unit = ((n % 64) * 2 // 16) ^ row_in_atom
    addr = (ks * K_STEP + (k16 // 8) * SBO + row_in_atom * ROW + (n // 64) * DG_BOX
            + unit * 16 + (n % 64) * 2 % 16)
    j, r = addr // DG_BOX, addr % DG_BOX // ROW
    e = ((((addr % ROW) // 16) ^ (r % 8)) * 16 + addr % 16) // 2  # TMA's swizzle, undone
    return j, r, e


@pytest.mark.parametrize("c", SIZES)
def test_bf16_dgrad_reads_equal_the_flipped_transposed_packing(c):
    dtype = torch.bfloat16
    w = _weight(c, seed=c)
    fwd = _bits(C.pack_conv3x3_grad(w, dtype))  # [tap][ci chunk][co_pad][64]
    old = _bits(C.pack_conv3x3_weight(C._dgrad_weight(w), dtype))  # dgrad's K-major tiles
    assert fwd.shape == old.shape
    nchunks, co_pad = fwd.shape[1], fwd.shape[2]
    bn = 64 if c <= 64 else 128
    assert co_pad % bn == 0 and co_pad >= 64 * nchunks  # every K' chunk's 64 rows exist
    j, r, e = _mn_major_source(bn, nchunks)
    for tap in range(9):
        for kc in range(nchunks):  # the halo stage's chunk of g: 64 of the forward's co
            for nt in range(co_pad // bn):
                chunk = nt * (bn // 64) + j
                live = chunk < nchunks  # a chunk past the last: TMA's zero fill
                got = np.where(live, fwd[8 - tap, np.minimum(chunk, nchunks - 1), kc * 64 + r, e], 0)
                # the old kernel's K-major B: row n of the N' tile, K' column k
                want = old[tap, kc, nt * bn:(nt + 1) * bn, :].T
                np.testing.assert_array_equal(got, want)


def _split_bits(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The pack kernel's tf32 split on the bits: (+0x1000) & ~0x1FFF, of v and of v - big."""
    big = ((v.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small = ((v - big).view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return big, small.view(np.float32)


@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
@pytest.mark.parametrize("c", SIZES)
def test_tf32x3_pack_kernel_model_equals_both_packings(c, layout):
    dtype = torch.float32
    w = _weight(c, seed=c + 1)
    if layout == "channels_last":  # the models hold their weights so
        w = w.contiguous(memory_format=torch.channels_last)
    want = C.pack_conv3x3_grad(w, dtype)  # the plain version: the two packings stacked
    torch.testing.assert_close(want, torch.stack([C.pack_conv3x3_weight(w, dtype),
                                                  C.pack_conv3x3_weight(C._dgrad_weight(w),
                                                                        dtype)]),
                               rtol=0, atol=0)
    _, _, _, chunks, co_pad, _ = want.shape
    # conv3x3_pack_tf32x3_kernel: one thread per element e of a plane, reading
    # w through its strides (elements), writing four planes.
    so, si, sy, sx = w.stride()
    flat = torch.as_strided(w, (w.numel(),), (1,), 0).numpy()  # the storage, as the kernel sees it
    plane = 9 * chunks * co_pad * 32
    bits = _bits(want).reshape(2, 2, plane)
    per_tap = chunks * co_pad * 32
    for tap in range(9):  # a tap's threads at a time: C = 1024 has 9.4M per plane
        e = np.arange(tap * per_tap, (tap + 1) * per_tap)
        k, row = e % 32, (e // 32) % co_pad
        rest = e // (32 * co_pad)
        chunk = rest % chunks
        assert (rest // chunks == tap).all()
        kk = chunk * 32 + k
        live = (row < c) & (kk < c)
        fy, fx = tap // 3, tap % 3
        rowc, kkc = np.minimum(row, c - 1), np.minimum(kk, c - 1)
        fwd = np.where(live, flat[rowc * so + kkc * si + fy * sy + fx * sx], np.float32(0))
        dg = np.where(live, flat[kkc * so + rowc * si + (2 - fy) * sy + (2 - fx) * sx],
                      np.float32(0))
        for layout, v in enumerate((fwd, dg)):
            for plane_i, part in enumerate(_split_bits(v.astype(np.float32))):
                np.testing.assert_array_equal(part.view(np.int32), bits[layout, plane_i, e])


# C % 4 != 0 in f32, C % 16 != 0 in bf16: the CUDA-core kernel's calls
FMA_CASES = [(3, torch.float32), (130, torch.float32), (3, torch.bfloat16), (24, torch.bfloat16),
             (130, torch.bfloat16)]


@pytest.mark.parametrize("c,dtype", FMA_CASES,
                         ids=[f"c{c}-{'f32' if t == torch.float32 else 'bf16'}"
                              for c, t in FMA_CASES])
def test_fma_dgrad_reads_equal_the_flipped_transposed_packing(c, dtype):
    assert C.conv3x3_path(c, dtype) == "fma"
    w = _weight(c, seed=c + 2)
    fwd = _bits(C.pack_conv3x3_grad(w, dtype)).reshape(9 * c * c)  # [ky][kx][co][ci]
    old = _bits(C.pack_conv3x3_weight(C._dgrad_weight(w), dtype, "fma"))
    tap, go, gc = np.meshgrid(np.arange(9), np.arange(c), np.arange(c), indexing="ij")
    # conv3x3_fma_kernel<T, false, true>: wt[((8 - tap) * c + gc) * c + go]
    np.testing.assert_array_equal(fwd[((8 - tap) * c + gc) * c + go], old.reshape(9, c, c))


PADS = [(1, 1), (0, 1), (1, 0), (2, 1), (1, 2)]


def _jax_dx(x, w_hwio, b, g, pad, fused):
    """y and dx of the JAX conv with H pads ``pad`` (W SAME), + bias and ReLU when ``fused``.

    The JAX package's conv3x3 block is a flax ``nn.Conv`` with padding
    ((1, 1), (1, 1)), which lowers to this ``conv_general_dilated``; the
    mesh's bands pad H by ``pad`` instead.
    """
    def f(x):
        y = jax.lax.conv_general_dilated(x, jnp.asarray(w_hwio), (1, 1), (tuple(pad), (1, 1)),
                                         dimension_numbers=("NHWC", "HWIO", "NHWC"))
        return jax.nn.relu(y + jnp.asarray(b)) if fused else y

    y, vjp = jax.vjp(f, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def test_jax_conv_at_same_pads_is_the_packages_block():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 6, 5, 8).astype(np.float32)
    w_hwio = (rng.randn(3, 3, 8, 8) / 8).astype(np.float32)
    b = (0.1 * rng.randn(8)).astype(np.float32)
    block = jax_blocks.conv3x3(8, use_bias=True)
    want = block.apply({"params": {"kernel": jnp.asarray(w_hwio), "bias": jnp.asarray(b)}},
                       jnp.asarray(x))
    y, _ = _jax_dx(x, w_hwio, b, np.zeros_like(x), (1, 1), False)
    np.testing.assert_allclose(y + b, np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("pad", PADS, ids=[f"pad{t}{b}" for t, b in PADS])
@pytest.mark.parametrize("fused", [True, False], ids=["bias_relu", "same"])
def test_function_dx_on_the_forward_packing_matches_jax_vjp(fused, pad, monkeypatch):
    n, h, w, c = 2, 7, 9, 8
    rng = np.random.RandomState(17 + pad[0] * 3 + pad[1])
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    g = rng.randn(n, h + pad[0] + pad[1] - 2, w, c).astype(np.float32)
    y_j, dx_j = _jax_dx(x, w_hwio, b, g, pad, fused)

    packs, phase = [], ["forward"]
    pack, pack_weight = C.pack_conv3x3_grad, C.pack_conv3x3_weight
    monkeypatch.setattr(C, "pack_conv3x3_grad",
                        lambda *a: packs.append(("grad", phase[0])) or pack(*a))
    monkeypatch.setattr(C, "pack_conv3x3_weight",
                        lambda *a: packs.append(("weight", phase[0])) or pack_weight(*a))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    if fused:
        y = C.conv3x3_bias_relu(xt, wt, torch.from_numpy(b), pad)
    else:
        y = C.conv3x3_same(xt, wt, pad)
    phase[0] = "backward"
    (dx,) = torch.autograd.grad(y, (xt,), torch.from_numpy(g).permute(0, 3, 1, 2))
    # The forward packs once; the backward packs nothing.
    assert [p for p in packs if p[0] == "grad"] == [("grad", "forward")]
    assert not [p for p in packs if p[1] == "backward"]
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), y_j, rtol=0, atol=1e-5)
    # f32 both sides, 9*C = 72 products of O(1) terms: as tests/test_torch_grad.py holds dx
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(), dx_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_operators_refuse_a_packing_of_another_type(dtype):
    c = 16
    w = _weight(c, seed=5)
    g = torch.randn(1, c, 4, 4).to(dtype)
    other = C.pack_conv3x3_grad(w, torch.float32 if dtype == torch.bfloat16 else torch.bfloat16)
    for call in (lambda: torch.ops.unet_seg.conv3x3_dgrad(g, w, other),
                 lambda: torch.ops.unet_seg.conv3x3_same(g, w, False, packed=other),
                 lambda: C.conv3x3_dgrad(g, w, packed=other)):
        with pytest.raises(ValueError, match="pack_conv3x3_grad"):
            call()
