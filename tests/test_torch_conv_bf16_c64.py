"""conv3x3's bf16 path at C <= 64 (``c64_persistent``), on the CPU.

The kernel (``csrc/conv3x3_same.cu``, ``conv3x3_c64_kernel``) runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). Its operands are
swapped against the streamed kernel's: M = the 64 output channels (A, the
resident weights), N = 256 pixels of the halo stage at the tap's shift (B),
both read from shared memory by descriptors; N runs across tile rows at the
halo's pitch TW + 2, and the two columns of each row past TW are computed
and dropped. Here: the path's name; a numpy walk of the schedule (tiles,
items per CTA and per consumer warpgroup, the halo ring, the pitch, the
dropped columns) covering every output pixel once; the operands each wgmma
reads, forward and dgrad, rebuilt from ``pack_conv3x3_weight``'s packing
and the halo stage's swizzled bytes by the descriptors' address rule, their
products summed and held against ``jax.lax.conv_general_dilated`` (HIGHEST)
and its ``jax.vjp``; and the epilogue's ``stmatrix .trans`` through each
warp's 512 bytes of shared memory, which gives every lane the 16 bytes (8
channels of one pixel) it stores.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unet_embroidery_seg_torch.ops import conv3x3 as C

BF16 = torch.bfloat16
SMS = 132                 # the H100's SMs: the grid's cap
ROW = 128                 # bytes of a halo row or a weight row (64 bf16 channels)
CSRC = Path(C.__file__).resolve().parent.parent / "csrc" / "conv3x3_same.cu"

# (batch, C, input rows, width, pads) the kernel is launched with (a dgrad's
# g rows and its own pads): unet_resnet50's fused 64@480^2 and 64@240^2 at
# predict, their dgrad at 512^2 and 256^2, the families' 64@480^2 and their
# band on a 1x2 mesh (forward (1, 0), dgrad (1, 2), the other rank (0, 1),
# (2, 1)); then odd widths, batch 1, one-row maps, every pad.
SHAPES = [
    (8, 64, 480, 480, (1, 1)), (8, 64, 240, 240, (1, 1)), (8, 64, 512, 512, (1, 1)),
    (8, 64, 256, 256, (1, 1)), (8, 64, 257, 512, (1, 0)), (8, 64, 256, 512, (1, 2)),
    (8, 64, 257, 512, (0, 1)), (8, 64, 256, 512, (2, 1)), (8, 64, 129, 256, (1, 0)),
    (2, 64, 17, 33, (1, 1)), (1, 48, 9, 20, (1, 1)), (1, 16, 3, 3, (1, 1)),
    (3, 64, 480, 17, (1, 1)), (1, 64, 37, 45, (0, 2)), (2, 32, 33, 47, (1, 2)),
    (1, 64, 1, 8, (1, 1)), (2, 16, 41, 24, (1, 0)), (1, 64, 19, 13, (2, 1)),
]


@pytest.mark.parametrize("c,path", [(16, "c64_persistent"), (32, "c64_persistent"),
                                    (48, "c64_persistent"), (64, "c64_persistent"),
                                    (80, "wgmma"), (40, "fma")])
def test_c64_path_keeps_its_name(c, path):
    assert C.conv3x3_path(c, BF16) == path
    if path == "c64_persistent":
        assert C._TC_SYMBOLS[path] == "conv3x3_wgmma_launch"
        assert C._tc_layout(c, BF16) == (1, 64)  # one 64-channel chunk, 64 output rows a tap


@pytest.mark.parametrize("flags", ["true, false", "false, true", "false, false"])
def test_profiles_count_the_kernel_as_the_ports_conv(flags):
    # The profile scripts group card time by kernel name; the C <= 64 kernel's
    # name holds "conv", which would otherwise fall in cuDNN's group.
    from unet_embroidery_seg_torch.utils import timing

    name = f"void (anonymous namespace)::tc::conv3x3_c64_kernel<{flags}>(CUtensorMap_st, ...)"
    assert timing._group_of(name) == "port conv3x3 (forward and dgrad)"


def test_the_kernel_and_its_mirror_share_the_tile_table():
    text = CSRC.read_text()
    m = re.search(r"constexpr int C64_TILES\[3\]\[2\] = \{(.*?)\};", text)
    assert m is not None
    tiles = tuple(tuple(int(v) for v in t.split(",")) for t in re.findall(r"\{(\d+, \d+)\}", m.group(1)))
    assert tiles == C.C64_TILES
    for name, value in (("C64_N", C.C64_N), ("C64_STAGES", C.C64_STAGES),
                        ("C64_HALO_ROWS", C.C64_HALO_ROWS)):
        assert re.search(rf"constexpr int {name} = {value};", text), name


@pytest.mark.parametrize("h,w,want", [(480, 480, (8, 30)), (240, 240, (8, 30)), (512, 512, (6, 40)),
                                      (256, 256, (8, 30)), (256, 512, (6, 40)), (3, 3, (8, 30)),
                                      (20, 13, (16, 14))])
def test_pick_tile_c64_takes_the_fewest_tiles(h, w, want):
    assert C.pick_tile_c64(h, w) == want
    th, tw = want
    assert min(-(-w // t) * -(-h // r) for t, r in C.C64_TILES) == -(-w // tw) * -(-h // th)


@pytest.mark.parametrize("n,c,h,w,pad", SHAPES)
def test_schedule_covers_every_output_pixel_once(n, c, h, w, pad):
    sched = C.c64_schedule(n, h, w, pad)
    oh = C.out_rows(h, pad)
    th, tw = sched["tile"]
    pitch = sched["halo_pitch"]
    assert pitch == tw + 2 and th * pitch <= C.C64_N
    tiles_y, tiles_x = sched["tiles"]
    assert (tiles_y - 1) * th < oh <= tiles_y * th and (tiles_x - 1) * tw < w <= tiles_x * tw
    grid = sched["grid"]
    assert grid == min(SMS, -(-sched["items"] // 2))
    covered = np.zeros((n, oh, w), np.int16)
    for cta in range(grid):
        stages = []  # (group, stage) of each of the CTA's items, in the producer's order
        for k in range(sched["items"]):
            item = cta + k * grid
            if item >= sched["items"]:
                break
            stages.append((k % 2, k % C.C64_STAGES))
            tx, rest = item % tiles_x, item // tiles_x
            ty, img = rest % tiles_y, rest // tiles_y
            # the TMA store's box (64, TW, TH, 1) clips at the map's edges
            covered[img, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw] += 1
        assert len(stages) <= sched["items_per_cta"]
        # The groups alternate over the ring. Group g's loads of stage s land
        # on the barrier hfull[s][g], whose i-th phase is its i-th item on that
        # stage: item k waits for phase k // 6 (parity (k // 6) & 1), and the
        # phase before it is the group's own item k - 6, long consumed, so a
        # parity wait cannot pass on a stale phase.
        uses = {}
        for k, (g, s) in enumerate(stages):
            assert g == k % 2 and s == k % C.C64_STAGES
            i = uses.get((s, g), 0)
            assert i == k // (2 * C.C64_STAGES)
            uses[(s, g)] = i + 1
    assert (covered == 1).all()
    assert sched["dropped_share"] == 1 - th * tw / C.C64_N


@pytest.mark.parametrize("tw,th", C.C64_TILES)
def test_live_pixels_read_only_the_halo_box(tw, th):
    # Pixel n of a tile is halo row n at tap (0, 0) and output (n // P, n % P);
    # at tap (ky, kx) it reads row n + ky P + kx. A live pixel (x < TW, y < TH)
    # reads inside the (TH + 2) P rows the TMA box wrote, exactly the input
    # pixel the conv needs; every pixel, dropped ones too, reads inside the stage.
    pitch = tw + 2
    n = np.arange(C.C64_N)
    y, x = n // pitch, n % pitch
    live = (x < tw) & (y < th)
    assert live.sum() == th * tw
    for tap in range(9):
        ky, kx = divmod(tap, 3)
        rows = n + ky * pitch + kx
        assert rows.max() < C.C64_HALO_ROWS
        assert rows[live].max() < (th + 2) * pitch
        np.testing.assert_array_equal(rows[live] // pitch, y[live] + ky)
        np.testing.assert_array_equal(rows[live] % pitch, x[live] + kx)


def _swizzle(rows: np.ndarray) -> np.ndarray:
    """Rows of 64 bf16 values as TMA's 128-byte swizzle lays them out from a 1024-byte aligned
    address: 16-byte unit u of row r at unit u ^ (r % 8)."""
    out = np.empty_like(rows)
    for r in range(rows.shape[0]):
        for u in range(8):
            out[r, 8 * (u ^ (r % 8)):8 * (u ^ (r % 8)) + 8] = rows[r, 8 * u:8 * u + 8]
    return out


def _read_k_major(phys: np.ndarray, start_row: int, k_byte: int, rows: int) -> np.ndarray:
    """A K-major 128-byte-swizzled operand by its descriptor: ``rows`` rows from
    ``start_row``, 16 K values from byte ``k_byte`` of each row. The swizzle follows
    the address bits: unit (k_byte / 16 + c) of row r is at unit ^ (r % 8)."""
    out = np.empty((rows, 16), phys.dtype)
    for i in range(rows):
        r = start_row + i
        for c in range(2):
            u = (k_byte // 16 + c) ^ (r % 8)
            out[i, 8 * c:8 * c + 8] = phys[r, 8 * u:8 * u + 8]
    return out


def _read_mn_major(phys: np.ndarray, k_row: int) -> np.ndarray:
    """An MN-major 128-byte-swizzled A of M = 64 by its descriptor (dgrad): K rows
    k_row .. k_row + 15 of 64 M values each, read as [m][k]."""
    out = np.empty((64, 16), phys.dtype)
    for kk in range(16):
        r = k_row + kk
        for u in range(8):
            out[8 * u:8 * u + 8, kk] = phys[r, 8 * (u ^ (r % 8)):8 * (u ^ (r % 8)) + 8]
    return out


def _halo_stage(x: np.ndarray, img: int, y0: int, x0: int, th: int, tw: int,
                pad_top: int) -> np.ndarray:
    """The halo stage TMA writes for a tile (NHWC x, C <= 64), swizzled, with NaN past the box."""
    pitch, (_, h, w, c) = tw + 2, x.shape
    rows = np.full((C.C64_HALO_ROWS, 64), np.nan, np.float32)
    for hy in range(th + 2):
        for hx in range(pitch):
            gy, gx = y0 - pad_top + hy, x0 - 1 + hx
            rows[hy * pitch + hx] = 0.0  # TMA's zero fill: outside the map and past C
            if 0 <= gy < h and 0 <= gx < w:
                rows[hy * pitch + hx, :c] = x[img, gy, gx]
    return _swizzle(rows)


def _kernel_conv(x: np.ndarray, packed: np.ndarray, pad, dgrad: bool) -> np.ndarray:
    """The kernel's arithmetic on NHWC ``x``: per tile, 9 taps x 4 k16 steps of A (64 x 16)
    @ B (16 x 256), read from the swizzled stages; the live pixels go out."""
    n, h, w, c = x.shape
    oh = C.out_rows(h, pad)
    th, tw = C.pick_tile_c64(oh, w)
    pitch = tw + 2
    wphys = [_swizzle(packed[t, 0]) for t in range(9)]  # each tap's [64 co][64 ci], 1024-aligned
    out = np.zeros((n, oh, w, 64), np.float32)
    for img in range(n):
        for ty in range(-(-oh // th)):
            for tx in range(-(-w // tw)):
                stage = _halo_stage(x, img, ty * th, tx * tw, th, tw, pad[0])
                d = np.zeros((64, C.C64_N), np.float32)
                for tap in range(9):
                    shift = (tap // 3) * pitch + tap % 3
                    for ks in range(4):
                        if dgrad:  # the forward's tap 8 - tap, its rows (co) as K
                            a = _read_mn_major(wphys[8 - tap], 16 * ks)
                        else:
                            a = _read_k_major(wphys[tap], 0, 32 * ks, 64)
                        b = _read_k_major(stage, shift, 32 * ks, C.C64_N).T  # [k][n]
                        d += a @ b
                pix = np.arange(C.C64_N)
                y, xx = pix // pitch, pix % pitch
                live = (xx < tw) & (y < th) & (ty * th + y < oh) & (tx * tw + xx < w)
                assert np.isfinite(d[:, live]).all()  # live pixels read no row past the box
                out[img, ty * th + y[live], tx * tw + xx[live]] = d[:, live].T
    return out[..., :c]


def _jax_conv(x_nhwc, w_hwio, pad):
    return jax.lax.conv_general_dilated(x_nhwc, jnp.asarray(w_hwio), (1, 1), (tuple(pad), (1, 1)),
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        precision=jax.lax.Precision.HIGHEST)


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(BF16).float().numpy()


@pytest.mark.parametrize("pad", [(1, 1), (1, 0)])
@pytest.mark.parametrize("c", [16, 48, 64])
def test_swapped_products_match_jax_conv_and_its_vjp(c, pad):
    rng = np.random.RandomState(c + 5 * pad[1])
    n, h, w = 1, 9, 20  # two tiles in H (TH = 8), the second ragged; W < TW
    x = _bf16(rng.randn(n, h, w, c).astype(np.float32))
    w_hwio = _bf16((rng.randn(3, 3, c, c) / np.sqrt(9 * c)).astype(np.float32))
    oh = C.out_rows(h, pad)
    g = _bf16(rng.randn(n, oh, w, c).astype(np.float32))
    weight = torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))
    packed = C.pack_conv3x3_weight(weight, BF16).float().numpy()  # [tap][1][64][64]
    assert packed.shape == (9, 1, 64, 64)

    y, vjp = jax.vjp(lambda v: _jax_conv(v, w_hwio, pad), jnp.asarray(x))
    want_y, want_dx = np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])
    got_y = _kernel_conv(x, packed, pad, dgrad=False)
    got_dx = _kernel_conv(g, packed, C.dgrad_pad(pad), dgrad=True)
    assert got_y.shape == want_y.shape and got_dx.shape == want_dx.shape
    # bf16 inputs, exact products, f32 sums of 9 * C terms in another order.
    scale = max(np.abs(want_y).max(), np.abs(want_dx).max())
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got_dx, want_dx, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("bias_relu", [False, True])
def test_epilogue_transposes_each_value_to_its_pixel_and_channels(bias_relu):
    # Thread (warp, lane) holds D rows (channels) 16 warp + lane / 4 (+ 8) and
    # columns (pixels) 8j + 2 (lane % 4) (+ 1): acc[4j + 2h + v]. At each even
    # j, stmatrix .x4 .trans stores matrices q = 0..3 (channels + 8 (q % 2),
    # pixels 8 (j + q / 2) ..), register q packing v[2q], v[2q + 1], into the
    # warp's 512 bytes: lane L gives the address of row L % 8 of matrix L / 8,
    # pixel p = 8 (L / 16) + L % 8 of the pair, half u = (L / 8) % 2, at
    # p * 32 + (u ^ (p / 4 % 2)) * 16. Then lane L reads half L % 2 of pixel
    # L / 2 and stores it as channels 16 warp + 8 (L % 2) .. + 7 of pixel
    # 16 (j / 2) + L / 2.
    d = np.arange(64 * C.C64_N, dtype=np.float32).reshape(64, C.C64_N) - 5000.0
    bias = np.linspace(-3, 3, 64).astype(np.float32)
    stored = np.full((64, C.C64_N), np.nan, np.float32)

    def addr(p, u):
        return p * 32 + ((u ^ ((p >> 2) & 1)) << 4)

    for warp in range(4):
        for j in range(0, 32, 2):
            regs = {}  # lane -> its 8 values v[0..7] after the bias and ReLU
            for lane in range(32):
                ch0 = 16 * warp + lane // 4
                v = []
                for i in range(8):
                    jj, h, vv = j + i // 4, (i // 2) % 2, i % 2
                    val = d[ch0 + 8 * h, 8 * jj + 2 * (lane % 4) + vv]
                    v.append(max(val + bias[ch0 + 8 * h], 0.0) if bias_relu else val)
                regs[lane] = v
            buf = {}
            for q in range(4):
                rows = [addr(8 * (q // 2) + c, q % 2) for c in range(8)]  # lanes 8q .. 8q + 7
                assert len({a % 128 // 16 for a in rows}) == 8  # one bank group each: no conflict
                for c in range(8):  # stored row c of matrix q: the fragment's column c
                    for i in range(8):  # element i: fragment row i, held by lane 4i + c / 2
                        a = rows[c] + 2 * i
                        assert a not in buf
                        buf[a] = regs[4 * i + c // 2][2 * q + c % 2]
            assert sorted(buf) == list(range(0, 512, 2))
            for lane in range(32):
                p, u = lane // 2, lane % 2
                n = 8 * j + p
                for i in range(8):
                    stored[16 * warp + 8 * u + i, n] = buf[addr(p, u) + 2 * i]
    want = np.maximum(d + bias[:, None], 0.0) if bias_relu else d
    np.testing.assert_array_equal(stored, want)
