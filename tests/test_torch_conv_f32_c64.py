"""conv3x3's f32 path at C <= 64 (``tf32x3_c64``), on the CPU.

The kernel (``csrc/conv3x3_same.cu``, layout PIPES) runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``). Here: the path's name; a
model of its schedule (the tile ``pick_tile`` chooses, the items each of a
CTA's two pipelines takes, the halo rows each tap reads, and where the
epilogue's rounds of 32 channels put each value in the halo stage it stages
in), held to cover every output pixel and channel exactly once; and its
arithmetic, the three tf32 products in the kernel's order (chunk, tap, k8
step; small x big, big x small, big x big), reading the packed planes,
against the JAX package's conv at ``Precision.HIGHEST`` and its ``jax.vjp``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from unet_embroidery_seg_torch.ops import conv3x3 as C

# csrc/conv3x3_same.cu: pixels per tile, rows of a halo stage, bytes of a row
# (32 f32 channels), output channels per tile, the H100's SMs (the grid's
# cap), the pipelines (groups) per CTA, channels per epilogue round.
TILE_M, HALO_ROWS, ROW, BN, SMS, GROUPS, OUT_CH = 128, 192, 128, 64, 132, 2, 32


@pytest.mark.parametrize("c,path", [(4, "tf32x3_c64"), (16, "tf32x3_c64"), (48, "tf32x3_c64"),
                                    (64, "tf32x3_c64"), (68, "tf32x3"), (128, "tf32x3"),
                                    (1024, "tf32x3")])
def test_conv3x3_path_names_the_c64_variant(c, path):
    assert C.conv3x3_path(c, torch.float32) == path
    assert C._TC_SYMBOLS[path] == "conv3x3_tf32x3_launch"
    # Both read the one tf32x3 packing: 64 output channels per tile up to C = 64.
    assert C._tc_layout(c, torch.float32)[1] % (64 if c <= 64 else 128) == 0


def _pick_tile(h: int, w: int) -> tuple[int, int]:
    """pick_tile: (TH, TW) of 128 pixels with the fewest M rows, ties to the smaller halo."""
    best = None
    for tw in (8, 16, 30):
        th = TILE_M // tw
        halo = (th + 2) * (tw + 2)
        if halo > HALO_ROWS:
            continue
        key = (-(-h // th) * -(-w // tw) * TILE_M, halo)
        if best is None or key < best[0]:
            best = (key, (th, tw))
    return best[1]


# (batch, C, input rows, width, pads): 64@512 and 64@256, one rank's band of
# each on a 1x2 mesh (its forward at pads (1, 0), its dgrad at (1, 2)), and a
# ragged shape.
SCHEDULE_CASES = [(8, 64, 512, 512, (1, 1)), (8, 64, 256, 256, (1, 1)),
                  (8, 64, 257, 512, (1, 0)), (8, 64, 256, 512, (1, 2)),
                  (8, 64, 129, 256, (1, 0)), (8, 64, 128, 256, (1, 2)),
                  (2, 64, 33, 47, (1, 1))]


@pytest.mark.parametrize("n,c,h,w,pad", SCHEDULE_CASES)
def test_pipelines_cover_every_output_pixel_once(n, c, h, w, pad):
    oh = C.out_rows(h, pad)
    th, tw = _pick_tile(oh, w)
    tiles_x, tiles_y = -(-w // tw), -(-oh // th)
    co_tiles, nchunks = -(-c // BN), -(-c // 32)
    items = n * tiles_y * tiles_x * co_tiles
    grid = min(-(-items // GROUPS), SMS)
    covered = np.zeros((n, oh, w, co_tiles), np.int16)
    halo_w = tw + 2
    taps = np.array([(t // 3) * halo_w + t % 3 for t in range(9)])
    m = np.arange(TILE_M)
    live = m < th * tw
    # A lane's halo row at tap (0, 0) (ldmatrix), shifted per tap: inside the
    # stage's (TH + 2) x (TW + 2) rows, and the input pixel the conv reads.
    rows = (m // tw) * halo_w + m % tw
    assert (rows[live][:, None] + taps).max() < (th + 2) * (tw + 2) <= HALO_ROWS
    hy, hx = (rows[:, None] + taps) // halo_w, (rows[:, None] + taps) % halo_w
    ky, kx = np.arange(9) // 3, np.arange(9) % 3
    np.testing.assert_array_equal((hy - m[:, None] // tw)[live], np.tile(ky, (live.sum(), 1)))
    np.testing.assert_array_equal((hx - m[:, None] % tw)[live], np.tile(kx, (live.sum(), 1)))
    go_step = nchunks * 9 // 2  # group 1 starts once group 0 passes this (chunk, tap) step
    assert 0 <= go_step < nchunks * 9
    for cta in range(grid):
        assert cta * GROUPS < items  # group 0 has an item, so it releases group 1
        for g in range(GROUPS):
            for item in range(cta * GROUPS + g, items, grid * GROUPS):
                co_t, pix = item % co_tiles, item // co_tiles
                tx, pix = pix % tiles_x, pix // tiles_x
                ty, img = pix % tiles_y, pix // tiles_y
                # the TMA store clips the box at the map's edges
                covered[img, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw, co_t] += 1
    assert (covered == 1).all()


def test_epilogue_rounds_put_each_value_where_the_store_reads_it():
    # One warpgroup holds a 128-pixel tile as two m64 slabs; thread (warp,
    # lane) holds rows s * 64 + warp * 16 + lane / 4 + 8 * hf and channel pairs
    # 8 * j + 2 * (lane % 4) (+1), acc[s][4j + 2hf (+1)]. Each round of 32
    # channels (j = 4 * rd + jj) goes to the halo stage as 128-byte rows with
    # the 128-byte swizzle; the TMA store of the (32, TW, TH, 1) box reads
    # row m, channel k at m * 128 + ((k * 4 // 16) ^ (m % 8)) * 16 + k * 4 % 16.
    assert TILE_M * ROW <= HALO_ROWS * ROW  # a round fits the halo stage
    for rd in range(BN // OUT_CH):
        stage = {}
        for s in range(2):
            for warp in range(4):
                for lane in range(32):
                    for hf in range(2):
                        m = s * 64 + warp * 16 + lane // 4 + 8 * hf
                        for jj in range(OUT_CH // 8):
                            j = rd * (OUT_CH // 8) + jj
                            addr = (m * ROW + (((2 * (jj % 4) + (lane % 4) // 2) ^ m) & 7) * 16
                                    + 8 * (lane % 2))
                            for v in range(2):  # st.shared.v2.f32: two channels
                                assert addr + 4 * v not in stage
                                stage[addr + 4 * v] = (m, 8 * j + 2 * (lane % 4) + v)
        for m in range(TILE_M):
            for k in range(OUT_CH):
                addr = m * ROW + (((k * 4 // 16) ^ (m % 8)) * 16) + k * 4 % 16
                assert stage[addr] == (m, rd * OUT_CH + k)
        assert len(stage) == TILE_M * OUT_CH


def _three_products(x: torch.Tensor, planes: torch.Tensor, pad, bias=None,
                    one_pass: bool = False) -> torch.Tensor:
    """The kernel's arithmetic on NCHW ``x``: per chunk, tap and k8 step, three tf32 products.

    ``planes``: [w_big, w_small][tap][chunk of 32][co_pad][32], as the kernel
    reads them. A is split per value (``tf32_split``: the kernel's bits
    rounding); acc += a_small w_big, += a_big w_small, += a_big w_big, in f32,
    in that order (each an 8-term product, whose inner order the tensor core
    fixes). ``bias``: MODE_BIAS_RELU's epilogue. ``one_pass``: big x big alone.
    """
    n, c, h, w = x.shape
    _, _, chunks, co_pad, _ = planes.shape
    oh = C.out_rows(h, pad)
    xp = F.pad(x, (1, 1, pad[0], pad[1]))
    xp = F.pad(xp, (0, 0, 0, 0, 0, chunks * 32 - c)).permute(0, 2, 3, 1)  # NHWC, C padded
    a_big, a_small = C.tf32_split(xp.contiguous())
    acc = torch.zeros(n, oh, w, co_pad)
    for ch in range(chunks):
        for tap in range(9):
            ky, kx = divmod(tap, 3)
            big = a_big[:, ky:ky + oh, kx:kx + w, ch * 32:(ch + 1) * 32]
            small = a_small[:, ky:ky + oh, kx:kx + w, ch * 32:(ch + 1) * 32]
            w_big, w_small = planes[0, tap, ch], planes[1, tap, ch]  # [co_pad][32]
            for ks in range(4):
                k = slice(8 * ks, 8 * ks + 8)
                if not one_pass:
                    acc = acc + small[..., k] @ w_big[:, k].T
                    acc = acc + big[..., k] @ w_small[:, k].T
                acc = acc + big[..., k] @ w_big[:, k].T
    out = acc[..., :c]
    if bias is not None:
        out = torch.relu(out + bias)
    return out.numpy()  # NHWC


def _jax_conv(x_nhwc, w_hwio, pad):
    return jax.lax.conv_general_dilated(x_nhwc, jnp.asarray(w_hwio), (1, 1), (tuple(pad), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        precision=jax.lax.Precision.HIGHEST)


@pytest.mark.parametrize("pad", [(1, 1), (1, 0)])
@pytest.mark.parametrize("c", [64, 48])
def test_three_products_match_jax_conv_and_its_vjp(c, pad):
    rng = np.random.RandomState(c + 7 * pad[1])
    n, h, w = 2, 11, 13
    x = rng.randn(n, h, w, c).astype(np.float32)
    w_hwio = (rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    oh = C.out_rows(h, pad)
    g = rng.randn(n, oh, w, c).astype(np.float32)
    weight = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    assert C.conv3x3_path(c, torch.float32) == "tf32x3_c64"
    packed = C.pack_conv3x3_grad(weight, torch.float32)  # [forward, dgrad][big, small]...

    y, vjp = jax.vjp(lambda v: _jax_conv(v, w_hwio, pad), jnp.asarray(x))
    want_y = np.maximum(np.asarray(y) + b, 0.0)
    want_dx = np.asarray(vjp(jnp.asarray(g))[0])
    got_y = _three_products(torch.from_numpy(x).permute(0, 3, 1, 2), packed[0], pad,
                            torch.from_numpy(b))
    got_dx = _three_products(torch.from_numpy(g).permute(0, 3, 1, 2), packed[1], C.dgrad_pad(pad))
    assert got_y.shape == want_y.shape and got_dx.shape == want_dx.shape
    # f32-accurate: ~2^-21 of each of 9*C products, summed in another order.
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-4)
    # One tf32 pass (big x big alone) misses by more: the test sees the split.
    one = _three_products(torch.from_numpy(g).permute(0, 3, 1, 2), packed[1], C.dgrad_pad(pad),
                          one_pass=True)
    assert np.abs(one - want_dx).max() > 1e-4 > np.abs(got_dx - want_dx).max()
