"""conv3x3's bf16 streamed path at C > 64 (``wgmma``), on the CPU.

The kernel (``csrc/conv3x3_same.cu``, ``conv3x3_wgmma_kernel<bf16, 128,
STREAMED, ...>``) runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). It runs in thread-block clusters of two CTAs: both take
the same 128-channel tile and neighbouring 128-pixel tiles, and each loads
half of every weight stage into both (TMA multicast); a CTA's two consumer
warpgroups each take half of the tile's rows and store them on their own.
Here: the path's name,
and a numpy model of that schedule, as the kernel walks it, held to cover
every output pixel and channel exactly once at every shape the main path
gives the kernel and at odd ones; the two CTAs of a cluster in step (one
channel tile, one chunk count, so one weight stage sequence); an odd tail's
partner storing nothing; each CTA's half of a weight stage, forward and
dgrad, covering the stage's rows once, read from the packed weights; and
``streamed_schedule``'s counts (the items, the L2 weight bytes
``chip_smoke.py`` reports) equal to the model's; and each warpgroup's half
of a tile at every tile width, read from the right halo rows and staged
where its store reads it.
"""

import numpy as np
import pytest
import torch

from unet_embroidery_seg_torch.ops import conv3x3 as C

BF16 = torch.bfloat16
# The H100's 132 SMs hold at most 66 clusters of two; the launch asks the
# card (cudaOccupancyMaxActiveClusters), so the model runs at fewer too.
CLUSTERS = (66, 61)
CHUNK, ROW = 64, 128  # input channels per halo stage and weight row; bytes of a row
SHARE = C.STREAMED_STAGE_BYTES // C.STREAMED_CLUSTER  # bytes a CTA loads of each stage

# (batch, C, input rows, width, pads) the kernel is launched with (the
# forward's pads; dgrad's g rows and dgrad_pad for a dgrad): the families'
# bias-free forward at 480^2 and dgrad at 512^2, unet_resnet50's fused
# forward and dgrad, one rank's band of each on a 1x2 mesh (forward at (1, 0)
# / (0, 1), dgrad at (1, 2) / (2, 1)); then odd ones (ragged tiles, batch 1,
# C = 80 and 192, one-row maps).
SHAPES = [
    (8, 128, 240, 240, (1, 1)), (8, 256, 120, 120, (1, 1)), (8, 512, 60, 60, (1, 1)),
    (8, 1024, 30, 30, (1, 1)), (8, 128, 256, 256, (1, 1)), (8, 256, 128, 128, (1, 1)),
    (8, 512, 64, 64, (1, 1)), (8, 1024, 32, 32, (1, 1)), (8, 512, 30, 30, (1, 1)),
    (8, 256, 60, 60, (1, 1)), (8, 128, 120, 120, (1, 1)), (8, 128, 129, 256, (1, 0)),
    (8, 256, 65, 128, (1, 0)), (8, 512, 33, 64, (0, 1)), (8, 1024, 17, 32, (1, 0)),
    (8, 512, 16, 32, (1, 2)), (8, 256, 32, 64, (1, 2)), (8, 128, 64, 128, (2, 1)),
    (8, 1024, 16, 32, (1, 2)), (1, 80, 19, 21, (1, 1)), (2, 80, 33, 47, (1, 1)),
    (1, 192, 20, 37, (0, 2)), (3, 384, 15, 23, (1, 2)), (1, 1024, 9, 13, (1, 1)),
    (1, 128, 1, 8, (1, 1)), (1, 128, 19, 45, (1, 0)),
]


@pytest.mark.parametrize("c,path", [(16, "c64_persistent"), (64, "c64_persistent"),
                                    (80, "wgmma"), (128, "wgmma"), (1024, "wgmma"),
                                    (72, "fma")])
def test_conv3x3_path_keeps_its_names(c, path):
    assert C.conv3x3_path(c, BF16) == path
    if path != "fma":
        assert C._TC_SYMBOLS[path] == "conv3x3_wgmma_launch"


def _walk(sched: dict, clusters: int):
    """The kernel's items: (cluster, rank, item, channel tile, pixel tile, live) in its order.

    A cluster of rank-r CTAs walks items cluster, cluster + clusters, ...; an
    item's channel tile is item % co_tiles, its pixel tile 2 * (item //
    co_tiles) + r, past the last one the last one again, not stored.
    """
    items, co_tiles, pix_tiles = sched["items"], sched["co_tiles"], sched["pix_tiles"]
    grid = min(items, clusters)
    for cl in range(grid):
        for item in range(cl, items, grid):
            for rank in range(sched["cluster"]):
                pix = item // co_tiles * sched["cluster"] + rank
                yield cl, rank, item, item % co_tiles, min(pix, pix_tiles - 1), pix < pix_tiles


@pytest.mark.parametrize("clusters", CLUSTERS)
@pytest.mark.parametrize("n,c,h,w,pad", SHAPES)
def test_clusters_cover_every_output_once(n, c, h, w, pad, clusters):
    sched = C.streamed_schedule(n, h, w, c, pad)
    oh = C.out_rows(h, pad)
    th, tw = sched["tile"]
    assert th == C.TILE_M // tw and (th + 2) * (tw + 2) <= C.HALO_ROWS  # 4 x 30: 8 dead rows
    tiles_y, tiles_x = sched["tiles"]
    assert (tiles_y - 1) * th < oh <= tiles_y * th and (tiles_x - 1) * tw < w <= tiles_x * tw
    covered = np.zeros((n, oh, w, sched["co_tiles"]), np.int16)
    steps = {}  # (cluster, rank) -> the (channel tile, chunks) of each item it runs
    stored = np.zeros(sched["pix_tiles"], np.int16)
    loads = 0
    for cl, rank, item, co_t, pix, live in _walk(sched, clusters):
        steps.setdefault((cl, rank), []).append((co_t, sched["chunks"]))
        loads += 9 * sched["chunks"] * SHARE
        if not live:  # the partner of an odd tail: it loads its share, stores nothing
            assert pix == sched["pix_tiles"] - 1 and sched["pix_tiles"] % 2 == 1
            continue
        stored[pix] += 1
        tx, ty, img = pix % tiles_x, pix // tiles_x % tiles_y, pix // (tiles_x * tiles_y)
        # the TMA store clips the box at the map's edges
        covered[img, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw, co_t] += 1
    assert (covered == 1).all()
    assert (stored == sched["co_tiles"]).all()
    # Both CTAs of a cluster run the same channel tile and chunk count at
    # every item, so the same weight stages in the same order.
    for cl in range(min(sched["items"], clusters)):
        assert steps[(cl, 0)] == steps[(cl, 1)]
    assert loads == sched["l2_weight_bytes"]
    dead = sum(1 for *_, live in _walk(sched, clusters) if not live)
    assert dead == (sched["pix_tiles"] % 2) * sched["co_tiles"]


def test_odd_pixel_tile_counts_are_among_the_shapes():
    odd = [s for s in SHAPES if C.streamed_schedule(s[0], s[2], s[3], s[1], s[4])["pix_tiles"] % 2]
    assert len(odd) >= 3


def test_l2_weight_bytes_are_half_of_one_cta_per_item():
    # 256@120^2, batch 8: 960 pixel tiles x 2 channel tiles, each 4 chunks x
    # 9 stages of 16 KB; a cluster reads each stage once for two tiles.
    sched = C.streamed_schedule(8, 120, 120, 256)
    assert sched["pix_tiles"] * sched["co_tiles"] == 1920
    assert sched["l2_weight_bytes"] == 1920 * 36 * 16384 // 2


def _packed(c: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """(OIHW weight in bf16 values as f32, its [tap][chunk][co_pad][64] packing) as numpy."""
    w = torch.from_numpy(np.random.default_rng(seed).standard_normal((c, c, 3, 3), np.float32))
    packed = C.pack_conv3x3_weight(w, BF16).float().numpy()
    return w.to(BF16).float().numpy(), packed


@pytest.mark.parametrize("c", [80, 256])
def test_forward_shares_make_each_weight_stage(c):
    # Forward: the stage of (tap, chunk, channel tile) is 128 rows [co][64 ci]
    # of 128 bytes; the 2-D map's box is 64 rows, and rank r loads rows
    # co_t * 128 + r * 64 .. + 63 to byte r * SHARE of the stage.
    w, packed = _packed(c, seed=c)
    rows = packed.reshape(-1, CHUNK)  # the tensor map's rows
    chunks, co_pad = packed.shape[1], packed.shape[2]
    half = C.STREAMED_BN // C.STREAMED_CLUSTER
    assert half * ROW == SHARE
    for tap in (0, 4, 8):
        for ch in range(chunks):
            for co_t in range(co_pad // C.STREAMED_BN):
                stage = np.zeros((C.STREAMED_BN, CHUNK), np.float32)
                hits = np.zeros(C.STREAMED_BN, np.int16)
                for rank in range(C.STREAMED_CLUSTER):
                    r0 = (tap * chunks + ch) * co_pad + co_t * C.STREAMED_BN + rank * half
                    dst = rank * SHARE // ROW
                    stage[dst:dst + half] = rows[r0:r0 + half]
                    hits[dst:dst + half] += 1
                assert (hits == 1).all()
                # B (K-major): row co, column ci of this chunk, w[co, ci, ky, kx]
                co = np.arange(co_t * C.STREAMED_BN, (co_t + 1) * C.STREAMED_BN)
                ci = np.arange(ch * CHUNK, (ch + 1) * CHUNK)
                want = np.zeros((C.STREAMED_BN, CHUNK), np.float32)
                live_co, live_ci = co < c, ci < c
                want[np.ix_(live_co, live_ci)] = w[np.ix_(co[live_co], ci[live_ci])][..., tap // 3,
                                                                                      tap % 3]
                np.testing.assert_array_equal(stage, want)


@pytest.mark.parametrize("c", [80, 256])
def test_dgrad_shares_make_each_weight_stage(c):
    # dgrad: the stage of (tap, K' chunk, N' tile) is two boxes of 64 co x 64
    # ci of the forward's tap 8 - tap, N' block co_t * 2 + j at byte j * SHARE
    # (the descriptor's LBO); rank r loads block j = r. Read as MN-major B,
    # row k' (the forward's output channel) column n' (its input channel)
    # is dgrad's weight w'[n', k', ky, kx] = w[k', n', 2 - ky, 2 - kx].
    w, packed = _packed(c, seed=c + 1)
    chunks, co_pad = packed.shape[1], packed.shape[2]
    assert SHARE == CHUNK * ROW
    for tap in (0, 5, 8):
        for ch in range(chunks):  # K' chunk: forward output channels ch * 64 ..
            for co_t in range(co_pad // C.STREAMED_BN):
                stage = np.zeros((C.STREAMED_BN // CHUNK, CHUNK, CHUNK), np.float32)
                hits = np.zeros(C.STREAMED_BN // CHUNK, np.int16)
                for rank in range(C.STREAMED_CLUSTER):
                    block = co_t * C.STREAMED_CLUSTER + rank  # the forward's input-channel chunk
                    box = np.zeros((CHUNK, CHUNK), np.float32)  # TMA's zero fill past the map
                    if block < chunks:
                        rows = packed[8 - tap, block, ch * CHUNK:(ch + 1) * CHUNK]
                        box[:rows.shape[0]] = rows
                    stage[rank * SHARE // (CHUNK * ROW)] = box
                    hits[rank * SHARE // (CHUNK * ROW)] += 1
                assert (hits == 1).all()
                b = np.concatenate(list(stage), axis=1)  # [k'][n'] of the N' = 128 tile
                kp = np.arange(ch * CHUNK, (ch + 1) * CHUNK)
                n_p = np.arange(co_t * C.STREAMED_BN, (co_t + 1) * C.STREAMED_BN)
                want = np.zeros_like(b)
                lk, ln = kp < c, n_p < c
                want[np.ix_(lk, ln)] = w[np.ix_(kp[lk], n_p[ln])][..., 2 - tap // 3, 2 - tap % 3]
                np.testing.assert_array_equal(b, want)


@pytest.mark.parametrize("tw", C.TILE_WIDTHS)
def test_each_warpgroup_reads_and_stores_its_half_of_the_tile(tw):
    # The two consumer warpgroups run apart, so each stores its own rows: the
    # 64 M rows of warpgroup g are the tile's rows g * TH/2 .. + TH/2 - 1 (TW
    # = 30: 60 live M rows and 4 dead ones that read pixel 0 and store
    # nothing). M row r reads, at each tap, the halo row of its pixel shifted
    # by the tap, and is staged as row r of the warpgroup's buffer, where the
    # TMA store of its (64, TW, TH/2, 1) box at tile row g * TH/2 reads that
    # pixel.
    th = C.TILE_M // tw
    halo_w, half_px = tw + 2, th // 2 * tw
    seen = np.zeros((th, tw), np.int16)
    for g in range(2):
        for r in range(64):
            if r >= half_px:
                continue
            pix = g * half_px + r
            y, x = pix // tw, pix % tw
            assert (g * (th // 2) + r // tw, r % tw) == (y, x)  # the store box's row order
            seen[y, x] += 1
            a_row = y * halo_w + x  # the kernel's a_row: halo row of the pixel at tap (0, 0)
            for tap in range(9):
                ky, kx = divmod(tap, 3)
                assert a_row + ky * halo_w + kx == (y + ky) * halo_w + x + kx
                assert (y + ky) * halo_w + x + kx < (th + 2) * (tw + 2) <= C.HALO_ROWS
    assert (seen == 1).all()
