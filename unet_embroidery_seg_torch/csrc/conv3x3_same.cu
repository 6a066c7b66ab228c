// SAME, stride-1 3x3 convolution with C_in = C_out, fused bias and ReLU.
//
// Halo-padded mode (the mesh's space axis, parallel/halo.py): each launch
// takes pad_top and pad_bottom, 0 to 2 each, the zero rows above and below
// the input in H (SAME is 1 and 1). Output rows are h + pad_top +
// pad_bottom - 2, and output row y reads input rows y - pad_top .. y -
// pad_top + 2. A band of an image with its neighbours' rows already
// exchanged runs with 0 inside the image and 1 at its global edge; dgrad of
// such a band runs with 2 - pad on each side (its output has the halo rows'
// gradients, which the exchange's backward returns). The Pallas kernel took
// its H halo the same way, as two one-row views. W stays SAME. The pads
// only move the halo box's first row and the tile count, so they are
// launch arguments, and the epilogue stays a template parameter.
//
// Replaces: docs/negative-results/pallas_conv.py, conv3x3_same
// (pl.pallas_call over _kernel): NHWC x HWIO -> NHWC with f32 accumulation,
// one im2col GEMM per kernel row on the TPU. As there, the same kernel
// computes dgrad (dx of the conv): the conv of the output's gradient with
// the weights flipped in space and transposed in channels, the epilogue's
// bias and ReLU off (ops/conv3x3.py:conv3x3_dgrad). The Pallas kernel was
// handed weights flipped and transposed beforehand; here dgrad reads the
// forward's packing as it stands (MODE_DGRAD), so with grad on a weight is
// packed once per step, in the forward, and nothing is packed in the
// backward: tap t reads the forward's tap 8 - t, and the bf16 path's wgmma
// reads each [co][64 ci] tile as an MN-major B (transposed-B mode). The
// f32 path's wgmma has no transposed B: its grad-mode packing
// (conv3x3_pack_tf32x3) writes dgrad's K-major planes beside the forward's.
//
// Bound on the H100: 2*9*C*C FLOP per output pixel against 4*C bytes of
// bf16 input and output. At the six unet_resnet50 decoder sites (480^2,
// batch 8, bf16) that is 408 GFLOP, ~412 us at the 989 TFLOP/s bf16
// tensor-core rate. The C >= 128 sites are bound by operations; at C = 64
// the bytes take about as long (the 480^2 sites: 141 us of bytes, 137 us of
// operations).
//
// Three paths:
//
//  - bf16 with C % 16 == 0 (every decoder site): conv3x3_wgmma_kernel, an
//    implicit GEMM on the tensor cores. M = output pixels, N = output
//    channels, K = 9 taps x C_in, f32 accumulators in registers. Persistent:
//    one CTA per SM walks (pixel tile, channel tile) items.
//      * Warp roles: two consumer warpgroups (setmaxnreg 232) and a producer
//        warpgroup (setmaxnreg 40) one thread of which issues every TMA
//        copy (cp.async.bulk.tensor) into mbarrier rings. A halo stage is a
//        4-D box (64 channels, TW+2, TH+2, 1 image) of the NHWC input at
//        (c0, x0-1, y0-pad_top, n): TMA's zero fill outside the tensor is
//        the SAME padding (and pads C up to 64), so no edge is masked on
//        load.
//        64 bf16 channels are 128 bytes, the 128-byte swizzle width.
//      * MMA: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate). B (the
//        weights, [co][64 ci] rows, 128B-swizzled by TMA) comes from shared
//        memory through a descriptor. A is the pixel window shifted by the
//        tap, taken from registers: ldmatrix with one row address per lane
//        into the halo tile at the tap's shift, un-swizzled by hand, double-
//        buffered (tap t+1's ldmatrix runs while tap t's wgmma does).
//      * C <= 64 (up_concat1.conv2, up_conv.1/.3, the families' inc.conv2
//        and up4.conv.conv2; bound by bytes and operations about equally):
//        "c64_persistent", a kernel of its own (conv3x3_c64_kernel) with the
//        operands swapped: M = the 64 output channels, A = the weights (all
//        9 x 64 x 64, 72 KB, loaded once per CTA), N = 256 pixels, B = the
//        halo stage read by descriptor from the tap's shifted row. The
//        128-byte swizzle follows the address bits, so a descriptor whose
//        start moves by whole 128-byte rows reads the window shifted by any
//        number of pixels (scripts/torch_conv_bf16_probe.py shift). No
//        ldmatrix, and each m64n256k16 reads 10 KB of shared memory per 128
//        tensor-core cycles (80 bytes a cycle of the SM's 128; the old m64n64
//        form with A by ldmatrix needed all 128). N runs across tile rows at
//        the halo's pitch TW + 2, and 2 columns a row are computed and
//        dropped. A probe of the old form (split --layout resident) put 9-17%
//        of its time in ldmatrix and 18-25% in the epilogue, which one
//        group's MMAs could not cover; here one group's back-to-back N = 256
//        wgmmas keep the tensor cores busy while the other stores. With the
//        MMAs taken away the loads and stores alone take 77-91% of the call
//        (split --layout c64, no_mma): what bounds it now is device memory.
//      * C > 64 (up_concat{4,3,2}.conv2; bound by operations): "wgmma".
//        Tiles of 128 pixels x 128 output channels, one slab of m64 per
//        consumer warpgroup; per 64-channel chunk one halo stage (reused by
//        all 9 taps) and 9 weight tiles of 16 KB streamed through a 6-stage
//        ring. Thread-block clusters of two CTAs (launched with
//        cudaLaunchKernelEx, as many as cudaOccupancyMaxActiveClusters
//        says fit: 66 on the H100): both take the same channel tile and
//        neighbouring pixel tiles, and each loads half of every weight
//        stage (64 of its rows; dgrad: one of its two 64 x 64 boxes) into
//        both with a multicast TMA copy, so the weights read from L2 per
//        FLOP are halved (128 FLOP per byte before, whatever C). A stage is
//        freed once both CTAs' consumers are done with it (one arrival per
//        warp on each CTA's barrier); an odd count of pixel tiles leaves a
//        partner that computes the last tile again and stores nothing.
//        Timing variants of the single-CTA kernel
//        (scripts/torch_conv_bf16_probe.py split, H100 SXM, 700 W) put the
//        L2 weight reloads at 0-2% of the call, but the epilogue at 6-23%
//        at C <= 256 (2-4 chunks an item) and its store at 4-12%, with
//        both warpgroups idle on the tensor cores meanwhile. So each
//        consumer warpgroup takes its own half of the tile's rows and
//        stages and stores it alone (a named barrier per warpgroup,
//        (64, TW, TH/2, 1) boxes): neither waits for the other at an
//        item's end, and a storing thread waits for its store to read the
//        buffer at the buffer's next use, not right after it. Starting
//        the second warpgroup a few taps late as well (variant lag4) ran
//        slower. The weight ring is 8 deep, the halo ring 2. Same products
//        in the same order: the output is bit-equal.
//      * Tile shape per call: TW in {8, 16, 30}, TH = 128 / TW, choosing
//        the fewest M rows in all (ties: the smaller halo, then the
//        narrower tile). 480^2, 240^2 and 120^2 take 16 x 8 (120^2 has 7%
//        dead rows), 30^2 takes 16 x 8 (12% dead), 60^2 takes 4 x 30 (120 of
//        128 rows live, no ragged tile). Dead rows read a valid address and
//        are not stored.
//      * Epilogue: + bias (f32) and ReLU (forward; dgrad skips both), round to nearest even bf16 into
//        shared memory (128-byte rows, swizzled), then TMA stores of
//        (64, TW, TH, 1) boxes, which clip the ragged edges and C not a
//        multiple of 64. The C <= 64 path stages in the halo stage it has
//        just consumed, the C > 64 path in a 32 KB buffer of its own, 16 KB
//        per warpgroup, each storing (64, TW, TH/2, 1) boxes.
//  - f32 with C % 4 == 0 (every f32 model site): the same kernel's float
//    template instances on the TF32 tensor cores, f32-accurate by the
//    three-pass split: a = a_big + a_small and w = w_big + w_small, each
//    part rounded to tf32 (cvt.rna: nearest, ties away), acc += a_small*w_big
//    + a_big*w_small + a_big*w_big in f32 (a_small*w_small, ~2^-22 of a
//    product, is dropped). Bound: 2*9*C*C FLOP per pixel at 495/3 = 165
//    TFLOP/s, 0.824 ms at C = 1024, 30^2, batch 8 (the CUDA cores' f32 peak,
//    67 TFLOP/s, would be 2.03 ms); 0.937 ms at C = 64, 512^2, batch 8.
//      * A 32-channel f32 chunk is 128 bytes: the bf16 path's halo box,
//        swizzle and ldmatrix addresses carry over unchanged, CHUNK = 32.
//        An ldmatrix 8x8 b16 matrix is 8 rows x 4 f32, so the x4 load that
//        gives bf16's k16 fragment gives exactly the tf32 m64k8 fragment
//        (a0..a3 = rows g / g+8, columns t / t+4). The split is done in
//        registers right after the load and serves N = 64 or 128 columns
//        of three wgmma.m64nNk8.f32.tf32.tf32 each.
//      * B: the packed weights hold two planes, w_big and w_small, already
//        rounded on the host (the same rounding as cvt.rna); K-major, the
//        only layout wgmma takes for tf32; a weight stage is one tap-chunk
//        of both planes (two TMA loads on one barrier). Both variants below
//        read the one packing. No resident-weight variant: two f32 planes
//        at C = 64 are 288 KB.
//      * C > 64: "tf32x3", the streamed layout (one pipeline of both
//        warpgroups, one slab each), tiles of 128 output channels. Shared
//        memory (the bf16 layout would take 265 KB here): 2 halo stages of
//        24 KB, 128 KB of weight stages (4 x 32 KB: 12 wgmma per stage),
//        and the 64 KB f32 epilogue staged as rounds of 64 channels through
//        one 32 KB buffer; 214 KB in all. Epilogue: + bias (f32) and ReLU,
//        f32 rows of 32 channels with the 128-byte swizzle, TMA stores of
//        (32, TW, TH, 1) boxes.
//      * C <= 64 (up_conv.1/.3 and the families' inc, up4.conv at 512^2,
//        up_concat1.conv2 at 256^2, their halo bands; forward and dgrad):
//        "tf32x3_c64", layout PIPES. With the streamed layout at N = 64
//        these ran at ~59% of the bound. Timing variants of that kernel at
//        64@512 (scripts/torch_conv_f32_probe.py split, H100 SXM, 700 W)
//        put the loss in the A split first: with no split at all the call
//        took ~15% less, with the store skipped ~5% less, the epilogue
//        skipped ~5%, the L2 weight reloads taken away ~2%. sm_90 has no
//        one-instruction cvt.rna.tf32.f32 (ptxas emits a compare-and-
//        select sequence: 288 FSETP in a chunk's 9 taps), and at N = 64 each split
//        serves only 24 MMA columns. So:
//          - the split is done on the bits (tf32_rna_bits: an integer add
//            and a mask, the same values; ~11% of the call);
//          - two pipelines per CTA, as c64_persistent: each consumer
//            warpgroup takes its own 128-pixel tiles as two m64 slabs,
//            with its own 2-stage halo ring, its own ring of 4 weight
//            stages of 16 KB (each tap's 24 wgmma) and its own producer
//            thread, so one pipeline's epilogue, split and chunk-end drain
//            run under the other's MMAs. The second pipeline starts half
//            an item late (the "go" barrier), so the two epilogues do not
//            fall together. The output is staged in the halo stage just
//            consumed, in rounds of 32 channels (16 KB). 225 KB in all;
//          - a commit group per k8 step (6 wgmma), one left in flight: the
//            A fragments of a whole tap for two slabs, big and small,
//            beside 64 accumulators, spilled past the 168 registers ptxas
//            gives a thread of 384.
//        Same products in the same order as the streamed layout: the
//        output is bit-equal to it. 64@512: ~70% of the bound (the
//        streamed layout ~59%).
//  - everything else (C % 4 != 0 in f32, C % 16 != 0 in bf16):
//    conv3x3_fma_kernel on the CUDA cores. An
//    8 x 16 pixel tile x 64 output channels per block; each stage holds 8
//    input channels of the (8+2) x (16+2) halo tile as f32; each thread
//    accumulates 4 neighbouring pixels x 8 output channels and reuses the 6
//    inputs of a kernel row for 3 taps (96 FMA per 30 shared-memory reads).
//    Any N, H, W, C >= 1.
//
// Weights arrive packed by the wrapper (ops/conv3x3.py:pack_conv3x3_weight;
// grad off once per parameter version, grad on once per forward), bias as
// f32:
//  - bf16 tensor-core path: [tap = ky*3+kx][C_in chunk of 64][co_pad][64],
//    zero in the padding (co_pad = C rounded up to N); dgrad reads the same;
//  - tf32x3: f32 [plane: w_big, w_small][tap][C_in chunk of 32][co_pad][32];
//    with grad on [layout: forward, dgrad] of those (conv3x3_pack_tf32x3);
//  - CUDA-core path: [ky][kx][co][ci] in the activation type; dgrad reads
//    the same.
//
// C interface (ctypes): pointers and the stream are void*; each entry point
// returns cudaGetLastError() after its launch, or a CUDA error code for
// what it refuses.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- tensor-core paths: bf16 with C % 16 == 0, f32 (3xTF32) with C % 4 == 0 ---

namespace tc {

constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and one producer warpgroup
constexpr int ROW_BYTES = 128;             // one pixel or weight row of a chunk
constexpr int TILE_M = 128;                // pixels per tile
constexpr int HALO_ROWS = 192;             // most (TH+2)*(TW+2) of a tile shape (4 x 30)

// T is the activation type: __nv_bfloat16, or float for 3xTF32.
//
// A "group" is one pipeline: its consumer warpgroups share a tile, a halo
// ring and a producer thread. LAYOUT says how the two consumer warpgroups
// and the weights are laid out:
//  - STREAMED (bf16 C > 64, f32 C > 64): one group of two warpgroups (one
//    slab each) sharing every tile and every streamed weight stage; bf16 in
//    clusters of CLUSTER = 2 CTAs that share each weight stage (multicast),
//    each warpgroup staging and storing its own half of the tile's rows.
//  - RESIDENT (bf16, C <= 64): two groups of one warpgroup each (two slabs
//    of m64), so one group's epilogue overlaps the other's MMAs; both read
//    the one resident weight set. Not launched: bf16 at C <= 64 runs
//    conv3x3_c64_kernel. Its branches stay, compile-time dead in the other
//    layouts, so that those compile to the same code as before it went.
//  - PIPES (f32, C <= 64): two groups of one warpgroup each, as RESIDENT,
//    but each streams its own weight ring (two f32 planes are too large to
//    stay). The epilogue stages in the halo stage just consumed.
//
// f32 (3xTF32): a chunk is 32 channels, so a row is still 128 bytes; a
// weight stage holds two planes (w_big, w_small), 32 KB at BN = 128. The
// bf16 layout would need 265 KB, so: 2 halo stages (a chunk is 9 taps x 12
// wgmma, ~14k cycles, against one 24 KB halo load), 128 KB of weight stages
// (4 at BN = 128: each tap's 12 wgmma cover ~1.5k cycles, so 3 loads stay
// in flight ahead), and the 64 KB f32 epilogue staged in rounds of 64
// channels through one 32 KB buffer. PIPES: per group 2 halo stages and a
// ring of 4 weight stages of 16 KB (each tap's 24 wgmma cover ~0.8-1.5k
// cycles), the output staged in rounds of 32 channels (16 KB) in the halo
// stage; 225 KB in all.
constexpr int STREAMED = 0, RESIDENT = 1, PIPES = 2;

template <typename T, int BN, int LAYOUT>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int CHUNK = ROW_BYTES / static_cast<int>(sizeof(T));  // channels per stage
  static constexpr int PLANES = F32 ? 2 : 1;               // weight planes: w_big, w_small
  static constexpr bool RESIDENT_W = LAYOUT == RESIDENT;   // weights loaded once per CTA
  static constexpr int GROUPS = LAYOUT == STREAMED ? 1 : 2;
  static constexpr int RINGS = LAYOUT == PIPES ? 2 : 1;    // weight rings: one per group
  static constexpr int WGS = 2 / GROUPS;                   // warpgroups per group
  // CTAs per thread-block cluster (bf16 STREAMED): the cluster's CTAs take
  // the same channel tile and neighbouring pixel tiles, and each loads
  // 1/CLUSTER of every weight stage into all of them (TMA multicast).
  static constexpr int CLUSTER = !F32 && LAYOUT == STREAMED ? 2 : 1;
  static constexpr int SLABS = TILE_M / 64 / WGS;          // m64 slabs per warpgroup
  static constexpr int HALO_BYTES = HALO_ROWS * ROW_BYTES;  // a multiple of 1024
  // CLUSTER > 1: each warpgroup stores its own half of the tile's rows, so
  // neither waits for the other at an item's end; a deeper weight ring and a
  // halo ring one stage shallower (8 and 2 ran faster than 6 and 3 at 6 of
  // the probe's 8 shapes: scripts/torch_conv_bf16_probe.py split, ring_6_3).
  static constexpr int H_STAGES = F32 || CLUSTER > 1 ? 2 : 3;  // per group
  static constexpr int PLANE_BYTES = BN * ROW_BYTES;       // one tap, one chunk, one plane
  static constexpr int W_TILE = PLANES * PLANE_BYTES;
  static constexpr int W_STAGES =
      RESIDENT_W ? 9 : F32 ? 131072 / W_TILE / RINGS : CLUSTER > 1 ? 8 : 6;  // per ring
  // The epilogue stages its output in the halo stage it has just consumed.
  static constexpr bool STAGE_IN_HALO = LAYOUT != STREAMED;
  static constexpr int OUT_CH = !F32 ? BN : STAGE_IN_HALO ? CHUNK : 64;  // channels per round
  static constexpr int OUT_BYTES =
      STAGE_IN_HALO ? 0 : TILE_M * OUT_CH * static_cast<int>(sizeof(T));
  // wgmma commit groups per tap (A registers double-buffered by group). f32
  // with two slabs commits each k8 step (6 wgmma) on its own: a tap's A
  // fragments, big and small, for both slabs, would not fit the 168
  // registers ptxas gives a thread of 384 beside the 64 accumulators.
  static constexpr int PARTS = F32 && SLABS == 2 ? 4 : 1;
  static constexpr int BARS =
      2 * GROUPS * H_STAGES + 2 * RINGS * W_STAGES + (LAYOUT == PIPES ? 1 : 0);
  static constexpr int SMEM = 1024 + GROUPS * H_STAGES * HALO_BYTES + RINGS * W_STAGES * W_TILE +
                              OUT_BYTES + 8 * BARS;
  static_assert(HALO_BYTES % 1024 == 0 && PLANE_BYTES % 1024 == 0,
                "stages keep the swizzle's 1024-byte alignment");
  static_assert(TILE_M * OUT_CH * static_cast<int>(sizeof(T)) <= HALO_BYTES || !STAGE_IN_HALO,
                "a round of the output fits the halo stage");
  static_assert(SMEM <= 232448, "over the 227 KB a block can have");
  static_assert(!(F32 && RESIDENT_W),
                "no resident f32 variant: two f32 planes at C = 64 are 288 KB");
  static_assert(LAYOUT != PIPES || F32, "PIPES is the f32 layout");
};

struct Params {
  const float* bias;  // read only by the BIAS_RELU kernels
  __nv_bfloat16* out;
  int h, w, c, th, tw, tiles_x, tiles_y, co_tiles, nchunks, co_pad, items, pad_top;
  uint32_t halo_tx;  // bytes of one halo box
  int pix_tiles;     // CLUSTER > 1: pixel tiles of the call (items counts cluster items)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrives on the mbarrier at this CTA's offset `bar` in CTA `rank` of the
// cluster. The default (release at CTA scope) form: the stage it releases was
// read by wgmmas that have completed, so nothing needs ordering at cluster
// scope, and the .release.cluster form made the kernel take ~1.9x as long
// (scripts/torch_conv_bf16_probe.py split, variant release_cluster).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// Releases a weight stage: CLUSTER 1, each consumer thread arrives; else one
// arrival per warp on each CTA's barrier (lane r on CTA r's), since every
// CTA of the cluster writes its share of the stage into this one.
template <int CLUSTER>
__device__ __forceinline__ void release_stage(uint32_t bar, int lane) {
  if constexpr (CLUSTER == 1) {
    mbar_arrive(bar);
  } else {
    if (lane < CLUSTER) mbar_arrive_cluster(bar, lane);
  }
}

// Every thread of every CTA of the cluster: barrier inits before any remote
// arrival or multicast copy, and no CTA exits while another may still write
// to its shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Returns once the phase of parity `parity` has completed. A wait of ~10 s
// (a copy that never lands, a ring out of step) traps, so a fault ends the
// kernel with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > 20000000000LL) __trap();
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The same loads into every CTA of `mask` in the cluster, at the same
// shared-memory offsets, each completing on that CTA's barrier at `bar`.
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d_mc(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int c0, int c1, int c2, int c3, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5, %6, %7}], [%2], %3;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commits the stores issued so far; waits until they have read their
// shared-memory source (the writes to global memory go on in the
// background); both at once. A wait may be deferred to the buffer's next use.
__device__ __forceinline__ void bulk_store_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_store_wait_read_only() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_store_wait_read() {
  bulk_store_commit();
  bulk_store_wait_read_only();
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v2_f32(uint32_t addr, float v0, float v1) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v0), "f"(v1) : "memory");
}

// f32 -> tf32, round to nearest with ties away from zero: the low 13 bits
// come back zero, so wgmma's truncation of them changes nothing.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

// The same rounding on the bits, as ops/conv3x3.py:_round_tf32 packs the
// weights: add half of the dropped 13 bits' range, clear them (the carry
// rounds the magnitude up, whatever the sign). Two integer operations where
// sm_90's cvt.rna.tf32.f32 is a compare-and-select sequence of ~5.
__device__ __forceinline__ uint32_t tf32_rna_bits(uint32_t v) { return (v + 0x1000u) & ~0x1FFFu; }

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// K-major B tile with the 128-byte swizzle: rows of 128 bytes, 8-row groups
// 1024 bytes apart (SBO); the leading offset is unused for this layout.
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// MN-major B tile with the 128-byte swizzle (dgrad: the forward's rows of
// 64 input channels, one row per output channel, read as K' rows of 64 N'
// values each): 8-row K' groups 1024 bytes apart (SBO), 64-wide N' blocks
// `block` bytes apart (LBO). A k16 step is 16 rows, 2048 bytes on.
__device__ __forceinline__ uint64_t smem_desc_sw128_mn(uint32_t addr, uint32_t block) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(block >> 4) << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// Keeps the compiler from moving reads of an accumulator across a wgmma wait.
template <int K>
__device__ __forceinline__ void fence_operands(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1), "n"(TRANS_B));
}

// TRANS_B = 0: B K-major (the forward); 1: B MN-major (dgrad, reading the
// forward's tiles transposed).
template <int BN, int TRANS_B>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BN == 64) wgmma_m64n64k16<TRANS_B>(d, a, desc);
  else wgmma_m64n128k16<TRANS_B>(d, a, desc);
}

// tf32 (k8): A from registers in the m64k8 fragment (per warp of 16 rows:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) for g = lane/4,
// t = lane%4), B K-major through the descriptor. tf32 takes no transpose
// operands: both are K-major.
__device__ __forceinline__ void wgmma_m64n64k8_tf32(float (&d)[32], const uint32_t (&a)[4],
                                                    uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], const uint32_t (&a)[4],
                                                     uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                                uint64_t desc) {
  if constexpr (BN == 64) wgmma_m64n64k8_tf32(d, a, desc);
  else wgmma_m64n128k8_tf32(d, a, desc);
}

// DGRAD (bf16 only, epilogue off): dx from the output's gradient, reading the
// forward's packed weights as they stand. Tap t reads the forward's tap
// 8 - t (the flip); K' = the forward's output channels, N' = its input
// channels, so each [co][64 ci] weight tile is B' MN-major (the transpose),
// which wgmma's transposed-B mode reads in place. Streamed, a weight stage
// is two TMA boxes of 64 co x 64 ci: the rows of this halo stage's K'
// chunk from the two input-channel chunks of the N' = 128 tile.
template <typename T, int BN, int LAYOUT, bool BIAS_RELU, bool DGRAD>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap ymap, const Params p) {
  using C = Cfg<T, BN, LAYOUT>;
  static_assert(!DGRAD || (!C::F32 && !BIAS_RELU), "dgrad: bf16, epilogue off");
  constexpr bool RESIDENT_W = C::RESIDENT_W;
  constexpr int SLABS = C::SLABS, PARTS = C::PARTS, KS = 4 / PARTS;  // KS: k steps per part
  constexpr int DG_BOX = C::CHUNK * ROW_BYTES;  // dgrad: 64 K' rows of one N' block
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align every stage to it.
  const uint32_t halo0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t wgt0 = halo0 + C::GROUPS * C::H_STAGES * C::HALO_BYTES;
  const uint32_t out0 = wgt0 + C::RINGS * C::W_STAGES * C::W_TILE;
  const uint32_t bars = out0 + C::OUT_BYTES;
  // Barriers: hfull[group][stage], hempty[group][stage], wfull[ring][stage],
  // wempty[ring][stage], and (PIPES) go: group 1 starts half an item late.
  const uint32_t hfull0 = bars, hempty0 = hfull0 + 8 * C::GROUPS * C::H_STAGES;
  const uint32_t wfull0 = hempty0 + 8 * C::GROUPS * C::H_STAGES;
  const uint32_t wempty0 = wfull0 + 8 * C::RINGS * C::W_STAGES;
  const uint32_t go = wempty0 + 8 * C::RINGS * C::W_STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::GROUPS * C::H_STAGES; ++s) {
      mbar_init(hfull0 + 8 * s, 1);
      mbar_init(hempty0 + 8 * s, 128 * C::WGS);
    }
    for (int s = 0; s < C::RINGS * C::W_STAGES; ++s) {
      mbar_init(wfull0 + 8 * s, 1);
      mbar_init(wempty0 + 8 * s,
                C::CLUSTER > 1 ? C::CLUSTER * (CONSUMERS / 32) : CONSUMERS / C::RINGS);
    }
    if (LAYOUT == PIPES) mbar_init(go, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if constexpr (C::CLUSTER > 1) cluster_sync();
  else __syncthreads();

  const int halo_w = p.tw + 2;
  // Item stride: one slot per group; CLUSTER > 1, one per cluster (an item
  // is then CLUSTER neighbouring pixel tiles of one channel tile, and the
  // CTA of rank r takes the r-th: rank = blockIdx.x % CLUSTER).
  const int slots = C::CLUSTER > 1 ? gridDim.x / C::CLUSTER : gridDim.x * C::GROUPS;
  const int rank = C::CLUSTER > 1 ? blockIdx.x % C::CLUSTER : 0;

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: lane 0 of warp g keeps group g's rings full ----
    setmaxnreg_dec<40>();
    const int g = (tid - CONSUMERS) / 32;
    if (g < C::GROUPS && tid % 32 == 0) {
      const uint32_t hfull = hfull0 + 8 * g * C::H_STAGES;
      const uint32_t hempty = hempty0 + 8 * g * C::H_STAGES;
      const uint32_t halo_g = halo0 + g * C::H_STAGES * C::HALO_BYTES;
      const int ring = C::RINGS == 2 ? g : 0;
      const uint32_t wfull = wfull0 + 8 * ring * C::W_STAGES;
      const uint32_t wempty = wempty0 + 8 * ring * C::W_STAGES;
      const uint32_t wgt = wgt0 + ring * C::W_STAGES * C::W_TILE;
      if (RESIDENT_W && g == 0) {
        mbar_expect_tx(wfull, 9 * C::W_TILE);
        for (int tap = 0; tap < 9; ++tap)
          tma_load_2d(wgt + tap * C::W_TILE, &wmap, wfull, 0, tap * p.co_pad);
      }
      int hi = 0, wi = 0;
      const int first = C::CLUSTER > 1 ? blockIdx.x / C::CLUSTER : blockIdx.x * C::GROUPS + g;
      for (int item = first; item < p.items; item += slots) {
        const int co_t = item % p.co_tiles;
        int pix = item / p.co_tiles;
        // An odd tail's partner loads the last tile's halo (it stores nothing).
        if constexpr (C::CLUSTER > 1) pix = min(pix * C::CLUSTER + rank, p.pix_tiles - 1);
        const int tx = pix % p.tiles_x;
        pix /= p.tiles_x;
        const int ty = pix % p.tiles_y, n = pix / p.tiles_y;
        for (int ch = 0; ch < p.nchunks; ++ch, ++hi) {
          const int hs = hi % C::H_STAGES;
          mbar_wait(hempty + 8 * hs, ((hi / C::H_STAGES) & 1) ^ 1);
          mbar_expect_tx(hfull + 8 * hs, p.halo_tx);
          tma_load_4d(halo_g + hs * C::HALO_BYTES, &xmap, hfull + 8 * hs, ch * C::CHUNK,
                      tx * p.tw - 1, ty * p.th - p.pad_top, n);
          if (!RESIDENT_W) {
            for (int tap = 0; tap < 9; ++tap, ++wi) {
              const int ws = wi % C::W_STAGES;
              mbar_wait(wempty + 8 * ws, ((wi / C::W_STAGES) & 1) ^ 1);
              mbar_expect_tx(wfull + 8 * ws, C::W_TILE);
              if constexpr (C::CLUSTER > 1) {
                // This CTA's 1/CLUSTER of the stage (rows rank * 64 .. + 63 of
                // the forward's [co][64 ci] tile; dgrad's box of N' block
                // rank), multicast into every CTA of the cluster. wfull
                // expects the whole stage: the other CTAs' shares land on it.
                constexpr uint16_t ALL = (1u << C::CLUSTER) - 1;
                constexpr int SHARE = C::W_TILE / C::CLUSTER;
                if constexpr (DGRAD)
                  tma_load_4d_mc(wgt + ws * C::W_TILE + rank * SHARE, &wmap, wfull + 8 * ws, 0,
                                 ch * C::CHUNK, co_t * (BN / C::CHUNK) + rank, 8 - tap, ALL);
                else
                  tma_load_2d_mc(wgt + ws * C::W_TILE + rank * SHARE, &wmap, wfull + 8 * ws, 0,
                                 (tap * p.nchunks + ch) * p.co_pad + co_t * BN +
                                     rank * (BN / C::CLUSTER),
                                 ALL);
              } else if constexpr (DGRAD) {
                // Box (64 ci, 64 co, 1, 1) of [tap][ci chunk][co_pad][64] at the
                // forward's tap 8 - tap; a chunk past the last is TMA's zero fill.
#pragma unroll
                for (int j = 0; j < BN / C::CHUNK; ++j)
                  tma_load_4d(wgt + ws * C::W_TILE + j * DG_BOX, &wmap, wfull + 8 * ws, 0,
                              ch * C::CHUNK, co_t * (BN / C::CHUNK) + j, 8 - tap);
              } else {
                // f32: plane 1 (w_small) lies 9 * nchunks * co_pad rows after plane 0.
#pragma unroll
                for (int pl = 0; pl < C::PLANES; ++pl)
                  tma_load_2d(wgt + ws * C::W_TILE + pl * C::PLANE_BYTES, &wmap, wfull + 8 * ws,
                              0, pl * 9 * p.nchunks * p.co_pad + (tap * p.nchunks + ch) * p.co_pad +
                                     co_t * BN);
              }
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg of group g, SLABS m64 slabs each -----------
    setmaxnreg_inc<232>();
    // PIPES: the warpgroup index made warp-uniform to the compiler (a shuffle
    // from lane 0), so the ring addresses and wgmma descriptors derived from
    // it stay in uniform registers.
    const int wg = LAYOUT == PIPES ? __shfl_sync(0xffffffffu, tid / 128, 0) : tid / 128;
    const int warp = (tid / 32) % 4, lane = tid % 32;
    const int g = wg / C::WGS, wg_in = wg % C::WGS;
    const uint32_t hfull = hfull0 + 8 * g * C::H_STAGES;
    const uint32_t hempty = hempty0 + 8 * g * C::H_STAGES;
    const uint32_t halo_g = halo0 + g * C::H_STAGES * C::HALO_BYTES;
    const int ring = C::RINGS == 2 ? g : 0;
    const uint32_t wfull = wfull0 + 8 * ring * C::W_STAGES;
    const uint32_t wempty = wempty0 + 8 * ring * C::W_STAGES;
    const uint32_t wgt = wgt0 + ring * C::W_STAGES * C::W_TILE;
    const int tile_px = p.th * p.tw;
    // ldmatrix: lane -> A row (pixel) and 8-channel half of the k16 step.
    const int lrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int khalf = lane >> 4;
    int a_row[SLABS];  // halo row of this lane's pixel at tap (0, 0)
#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      int m = (wg_in * SLABS + s) * 64 + lrow;
      if (m >= tile_px) m = 0;  // dead row: read a valid pixel, store nothing
      // CLUSTER > 1: warpgroup wg_in's slab is tile rows wg_in * TH/2 .. +
      // TH/2 - 1 (TW = 30: 60 of its 64 M rows live).
      if constexpr (C::CLUSTER > 1)
        m = lrow < p.th / 2 * p.tw ? wg_in * (p.th / 2 * p.tw) + lrow : 0;
      a_row[s] = (m / p.tw) * halo_w + m % p.tw;
    }

    if (RESIDENT_W) mbar_wait(wfull, 0);
    // PIPES: group 1 waits until group 0 is half through its first item, so
    // the two groups' epilogues (and their drains at each chunk's end) fall
    // while the other group's MMAs run, not at the same time.
    const int go_step = p.nchunks * 9 / 2;
    if (LAYOUT == PIPES && g == 1) mbar_wait(go, 0);
    int hi = 0, wi = 0, last_hs = 0;
    const int first = C::CLUSTER > 1 ? blockIdx.x / C::CLUSTER : blockIdx.x * C::GROUPS + g;
    for (int item = first; item < p.items; item += slots) {
      const int co_t = item % p.co_tiles;
      int pix = item / p.co_tiles;
      bool live = true;  // false: an odd tail's partner, which computes the last tile again
      if constexpr (C::CLUSTER > 1) {
        pix = pix * C::CLUSTER + rank;
        live = pix < p.pix_tiles;
        if (!live) pix = p.pix_tiles - 1;
      }
      const int tx = pix % p.tiles_x;
      pix /= p.tiles_x;
      const int ty = pix % p.tiles_y, n = pix / p.tiles_y;

      float acc[SLABS][BN / 2];
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[s][i] = 0.0f;

      for (int ch = 0; ch < p.nchunks; ++ch, ++hi) {
        const int hs = hi % C::H_STAGES;
        mbar_wait(hfull + 8 * hs, (hi / C::H_STAGES) & 1);
        const uint32_t halo = halo_g + hs * C::HALO_BYTES;
        // [buffer][slab][k step of the part][register]: bf16 A, or f32 A's tf32 big part
        uint32_t a[2][SLABS][KS][4];
        uint32_t a_small[2][C::F32 ? SLABS : 1][KS][4];  // f32: A - big, rounded to tf32
        int prev_ws = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint32_t wtile;
          int ws = 0;
          if (RESIDENT_W) {
            wtile = wgt + (DGRAD ? 8 - tap : tap) * C::W_TILE;
          } else {
            ws = wi % C::W_STAGES;
            mbar_wait(wfull + 8 * ws, (wi / C::W_STAGES) & 1);
            ++wi;
            wtile = wgt + ws * C::W_TILE;
          }
          const int shift = (tap / 3) * halo_w + tap % 3;
#pragma unroll
          for (int part = 0; part < PARTS; ++part) {
            const int buf = (tap * PARTS + part) & 1;  // the part before last has completed
#pragma unroll
            for (int s = 0; s < SLABS; ++s) {
              const uint32_t r = a_row[s] + shift;
              const uint32_t row_addr = halo + r * ROW_BYTES;
#pragma unroll
              for (int kk = 0; kk < KS; ++kk) {
                const int ks = part * KS + kk;
                const uint32_t addr = row_addr + ((((ks * 2 + khalf) ^ r) & 7) << 4);
                if constexpr (C::F32) {
                  // An 8x8 b16 matrix is 8 rows x 4 f32: the four matrices are
                  // the tf32 m64k8 fragment's a0..a3, as the four k8 halves of
                  // bf16's k16. Split here, once per 3 x BN/8 MMA columns.
                  uint32_t raw[4];
                  ldsm_x4(addr, raw);
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    if constexpr (LAYOUT == PIPES) {
                      const uint32_t big = tf32_rna_bits(raw[i]);
                      a[buf][s][kk][i] = big;
                      a_small[buf][s][kk][i] = tf32_rna_bits(
                          __float_as_uint(__uint_as_float(raw[i]) - __uint_as_float(big)));
                    } else {
                      const uint32_t big = tf32_rna(__uint_as_float(raw[i]));
                      a[buf][s][kk][i] = big;
                      a_small[buf][s][kk][i] =
                          tf32_rna(__uint_as_float(raw[i]) - __uint_as_float(big));
                    }
                  }
                } else {
                  ldsm_x4(addr, a[buf][s][kk]);
                }
              }
            }
            wgmma_fence();
            const uint64_t desc = DGRAD ? smem_desc_sw128_mn(wtile, DG_BOX) : smem_desc_sw128(wtile);
#pragma unroll
            for (int kk = 0; kk < KS; ++kk)
#pragma unroll
              for (int s = 0; s < SLABS; ++s) {
                const int ks = part * KS + kk;
                if constexpr (C::F32) {  // small x big + big x small + big x big, +32 bytes per k8
                  const uint64_t desc_small = smem_desc_sw128(wtile + C::PLANE_BYTES);
                  wgmma_tile_tf32<BN>(acc[s], a_small[buf][s][kk], desc + 2 * ks);
                  wgmma_tile_tf32<BN>(acc[s], a[buf][s][kk], desc_small + 2 * ks);
                  wgmma_tile_tf32<BN>(acc[s], a[buf][s][kk], desc + 2 * ks);
                } else if constexpr (DGRAD) {
                  wgmma_tile<BN, 1>(acc[s], a[buf][s][kk], desc + 128 * ks);  // +16 rows per k16
                } else {
                  wgmma_tile<BN, 0>(acc[s], a[buf][s][kk], desc + 2 * ks);  // +32 bytes per k16
                }
              }
            wgmma_commit();
            wgmma_wait<1>();  // the part before is done: its A registers (and weight stage) are free
            if (!RESIDENT_W && part == 0 && tap > 0)
              release_stage<C::CLUSTER>(wempty + 8 * prev_ws, lane);
          }
          prev_ws = ws;
          if (LAYOUT == PIPES && g == 0 && tid == 0 && item == blockIdx.x * C::GROUPS &&
              ch * 9 + tap == go_step)
            mbar_arrive(go);
        }
        wgmma_wait<0>();
        if (!RESIDENT_W) release_stage<C::CLUSTER>(wempty + 8 * prev_ws, lane);
        // The last chunk's halo stage is released after the epilogue's store
        // where the epilogue stages in it.
        if (!C::STAGE_IN_HALO || (LAYOUT == PIPES && ch + 1 < p.nchunks))
          mbar_arrive(hempty + 8 * hs);
        last_hs = hs;
      }
#pragma unroll
      for (int s = 0; s < SLABS; ++s) fence_operands(acc[s]);

      // ---- epilogue: (+ bias, ReLU if BIAS_RELU), bf16, TMA store ------------
      // The tile goes to shared memory as rows of 128 bytes (one pixel, 64
      // channels) with the 128-byte swizzle, conflict-free (the 8 rows of one
      // store get 8 distinct 16-byte chunks), then one TMA store per 64
      // channels writes the (64, TW, TH, 1) box; TMA clips the ragged edges
      // and the channels past C. RESIDENT and PIPES stage in the halo stage
      // they just consumed (released after the store), STREAMED in its own
      // buffer.
      const uint32_t stage = C::STAGE_IN_HALO ? halo_g + last_hs * C::HALO_BYTES : out0;
      const int x0 = tx * p.tw, y0 = ty * p.th, co0 = co_t * BN + 2 * (lane % 4);
      if constexpr (C::F32) {
        // f32: rows of 32 channels (128 bytes), OUT_CH / 32 boxes per round
        // of OUT_CH output channels through the one buffer (STREAMED: 64
        // channels through 32 KB; PIPES: 32 through 16 KB of the halo stage).
        // A thread's two channels are 8 bytes of the 16-byte unit
        // 2 * (jj % 4) + t / 2, swizzled by the row as the bf16 path's units are.
#pragma unroll
        for (int rd = 0; rd < BN / C::OUT_CH; ++rd) {
          named_bar_sync(1 + g, 128 * C::WGS);  // the previous store has read the buffer
#pragma unroll
          for (int s = 0; s < SLABS; ++s)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int m = (wg_in * SLABS + s) * 64 + warp * 16 + lane / 4 + 8 * hf;
              if (m >= tile_px) continue;
#pragma unroll
              for (int jj = 0; jj < C::OUT_CH / 8; ++jj) {
                const int j = rd * (C::OUT_CH / 8) + jj;
                const int co = co0 + 8 * j;
                float v0 = acc[s][4 * j + 2 * hf], v1 = acc[s][4 * j + 2 * hf + 1];
                if constexpr (BIAS_RELU) {
                  v0 = fmaxf(v0 + (co < p.c ? p.bias[co] : 0.0f), 0.0f);
                  v1 = fmaxf(v1 + (co < p.c ? p.bias[co + 1] : 0.0f), 0.0f);
                }
                st_shared_v2_f32(stage + (jj / 4) * TILE_M * ROW_BYTES + m * ROW_BYTES +
                                     ((((2 * (jj % 4) + (lane % 4) / 2) ^ m) & 7) << 4) +
                                     8 * (lane % 2),
                                 v0, v1);
              }
            }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to TMA
          named_bar_sync(1 + g, 128 * C::WGS);
          if (wg_in == 0 && warp == 0 && lane == 0) {
#pragma unroll
            for (int b = 0; b < C::OUT_CH / C::CHUNK; ++b) {
              const int cb = co_t * BN + rd * C::OUT_CH + b * C::CHUNK;
              if (cb < p.c) tma_store_4d(&ymap, stage + b * TILE_M * ROW_BYTES, cb, x0, y0, n);
            }
            bulk_store_wait_read();
          }
        }
        if (C::STAGE_IN_HALO) mbar_arrive(hempty + 8 * last_hs);
        continue;
      }
      if constexpr (C::CLUSTER > 1) {
        if (!live) continue;
        // Each warpgroup stages its half of the tile's rows in its own half
        // of the buffer ([half of 64 channels][64 rows]) and stores it as
        // (64, TW, TH/2, 1) boxes (TMA drops rows past the map), with no
        // barrier shared with the other warpgroup. Its storing thread waits
        // for its previous store to have read the buffer here, not after
        // the store: the next item's MMAs run meanwhile.
        const int half_px = p.th / 2 * p.tw;
        const uint32_t stage_wg = out0 + wg_in * (C::OUT_BYTES / 2);
        const bool storer = warp == 0 && lane == 0;
        if (storer) bulk_store_wait_read_only();
        named_bar_sync(1 + wg_in, 128);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = warp * 16 + lane / 4 + 8 * hf;
          if (m >= half_px) continue;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = co0 + 8 * j;
            float v0 = acc[0][4 * j + 2 * hf], v1 = acc[0][4 * j + 2 * hf + 1];
            if constexpr (BIAS_RELU) {
              v0 = fmaxf(v0 + (co < p.c ? p.bias[co] : 0.0f), 0.0f);
              v1 = fmaxf(v1 + (co < p.c ? p.bias[co + 1] : 0.0f), 0.0f);
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            st_shared_b32(stage_wg + (j / 8) * 64 * ROW_BYTES + m * ROW_BYTES +
                              ((((j % 8) ^ m) & 7) << 4) + 4 * (lane % 4),
                          *reinterpret_cast<const uint32_t*>(&v));
          }
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to TMA
        named_bar_sync(1 + wg_in, 128);
        if (storer) {
#pragma unroll
          for (int half = 0; half < BN / 64; ++half)
            if (co_t * BN + half * 64 < p.c)
              tma_store_4d(&ymap, stage_wg + half * 64 * ROW_BYTES, co_t * BN + half * 64, x0,
                           y0 + wg_in * (p.th / 2), n);
          bulk_store_commit();
        }
        continue;
      }
      named_bar_sync(1 + g, 128 * C::WGS);  // the previous store has read the buffer
#pragma unroll
      for (int s = 0; s < SLABS; ++s)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int m = (wg_in * SLABS + s) * 64 + warp * 16 + lane / 4 + 8 * hf;
          if (m >= tile_px) continue;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const int co = co0 + 8 * j;
            float v0 = acc[s][4 * j + 2 * hf], v1 = acc[s][4 * j + 2 * hf + 1];
            if constexpr (BIAS_RELU) {
              v0 = fmaxf(v0 + (co < p.c ? p.bias[co] : 0.0f), 0.0f);
              v1 = fmaxf(v1 + (co < p.c ? p.bias[co + 1] : 0.0f), 0.0f);
            }
            const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
            st_shared_b32(stage + (j / 8) * TILE_M * ROW_BYTES + m * ROW_BYTES +
                              ((((j % 8) ^ m) & 7) << 4) + 4 * (lane % 4),
                          *reinterpret_cast<const uint32_t*>(&v));
          }
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // visible to TMA
      named_bar_sync(1 + g, 128 * C::WGS);
      if (wg_in == 0 && warp == 0 && lane == 0) {
#pragma unroll
        for (int half = 0; half < BN / 64; ++half)
          if (co_t * BN + half * 64 < p.c)
            tma_store_4d(&ymap, stage + half * TILE_M * ROW_BYTES, co_t * BN + half * 64, x0, y0, n);
        bulk_store_wait_read();
      }
      if (C::STAGE_IN_HALO) mbar_arrive(hempty + 8 * last_hs);
    }
  }
  if constexpr (C::CLUSTER > 1) {
    // Each warpgroup's last store has read its buffer.
    if (tid < CONSUMERS && tid % 128 == 0) bulk_store_wait_read_only();
    cluster_sync();
  }
}

// ---- bf16 at C <= 64 ("c64_persistent"): the operands swapped ------------------
//
// M = the 64 output channels (A = the resident weights, by descriptor), N =
// 256 pixels of the halo stage at the tap's shift (B, by descriptor): no
// register holds an operand, so no ldmatrix, and each wgmma.m64n256k16 (128
// tensor-core cycles) reads 2 KB of A and 8 KB of B from shared memory.
// Pixel n of a tile is halo row n + shift and output (n / P, n % P) at the
// halo's pitch P = TW + 2; the 2 columns of each row past TW (and any pixel
// past TH rows) are computed and dropped. An item is one tile: 36 wgmmas
// into 128 accumulators a thread, one commit group, one wait. Each of the
// two consumer warpgroups takes every other item of its CTA from one
// 3-stage halo ring that the producer fills in item order, and releases its
// stage as soon as its MMAs have read it; then its epilogue transposes the
// accumulators (channels x pixels) into NHWC rows through 512 bytes of
// shared memory per warp (stmatrix .trans) and stores them, 16 bytes (8
// channels of a pixel) a lane, while the other warpgroup's MMAs run.
constexpr int C64_N = 256;          // pixels per tile (wgmma N), TH * P of them live
constexpr int C64_STAGES = 3;       // halo stages, shared by the two groups
constexpr int C64_HALO_ROWS = 352;  // the rows any tile's last tap reads (see c64_tiles_fit)
constexpr int C64_HALO_BYTES = C64_HALO_ROWS * ROW_BYTES;
constexpr int C64_W_BYTES = 9 * 64 * ROW_BYTES;  // 9 taps of [64 co][64 ci]
constexpr int C64_XBUF_BYTES = CONSUMERS / 32 * 512;  // the epilogue's transposes
constexpr int C64_SMEM =
    1024 + C64_STAGES * C64_HALO_BYTES + C64_W_BYTES + C64_XBUF_BYTES + 8 * 3 * C64_STAGES + 8;
static_assert(C64_HALO_BYTES % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
static_assert(C64_SMEM <= 232448, "over the 227 KB a block can have");

// The tile shapes (TW, TH) a launch picks from (ops/conv3x3.py:C64_TILES): TH
// rows at pitch P = TW + 2 fill at most the 256 pixels of N, and the rows the
// last tap reads, 2P + 2 + 255, fit a stage (the box holds (TH + 2) P of them;
// past it only dropped columns read).
constexpr int C64_TILES[3][2] = {{30, 8}, {40, 6}, {14, 16}};

constexpr bool c64_tiles_fit() {
  for (const auto& t : C64_TILES) {
    const int pitch = t[0] + 2;
    if (t[1] * pitch > C64_N || 2 * pitch + 2 + C64_N > C64_HALO_ROWS || pitch < 16)
      return false;
  }
  return true;
}
static_assert(c64_tiles_fit(), "a tile fills at most N, its last tap's rows fit a stage, and a "
                               "row of it holds a pair of 8-pixel blocks");

// m64n256k16 with A and B from shared memory by descriptor; TRANS_A = 1: A
// MN-major (dgrad: the forward's [co][64 ci] tiles read as [ci][co]).
template <int TRANS_A>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], uint64_t adesc,
                                                    uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(adesc), "l"(bdesc), "r"(1), "n"(TRANS_A));
}

__device__ __forceinline__ void stsm_x4_trans(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                              uint32_t r3) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(r0), "r"(r1), "r"(r2), "r"(r3)
               : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct C64Params {
  const float* bias;
  __nv_bfloat16* out;
  int c, w, oh, th, tw, tiles_x, tiles_y, items, pad_top;
  uint32_t halo_tx;
};

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

template <bool BIAS_RELU, bool DGRAD>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_c64_kernel(const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap, const C64Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t halo0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t wgt = halo0 + C64_STAGES * C64_HALO_BYTES;
  const uint32_t xbuf0 = wgt + C64_W_BYTES;  // 512 bytes per consumer warp
  // hfull[stage][group]: a group waits only on its own items' loads, so a
  // wait can never pass on an older phase (a stage alternates between the
  // groups, and one parity bit tells apart only a barrier's last two phases).
  const uint32_t hfull0 = xbuf0 + C64_XBUF_BYTES, hempty0 = hfull0 + 8 * 2 * C64_STAGES;
  const uint32_t wfull = hempty0 + 8 * C64_STAGES;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C64_STAGES; ++s) {
      mbar_init(hfull0 + 8 * (2 * s), 1);
      mbar_init(hfull0 + 8 * (2 * s + 1), 1);
      mbar_init(hempty0 + 8 * s, 128);
    }
    mbar_init(wfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int pitch = p.tw + 2;
  const int grid = gridDim.x;

  if (tid >= CONSUMERS) {
    // ---- producer: one thread loads the weights once, then every halo in item order ----
    setmaxnreg_dec<40>();
    if (tid == CONSUMERS) {
      mbar_expect_tx(wfull, C64_W_BYTES);
      for (int tap = 0; tap < 9; ++tap)
        tma_load_2d(wgt + tap * 64 * ROW_BYTES, &wmap, wfull, 0, tap * 64);
      for (int k = 0;; ++k) {
        const int item = blockIdx.x + k * grid;
        if (item >= p.items) break;
        const int s = k % C64_STAGES;
        mbar_wait(hempty0 + 8 * s, ((k / C64_STAGES) & 1) ^ 1);
        const uint32_t full = hfull0 + 8 * (2 * s + k % 2);
        mbar_expect_tx(full, p.halo_tx);
        const int tx = item % p.tiles_x, rest = item / p.tiles_x;
        const int ty = rest % p.tiles_y, n = rest / p.tiles_y;
        tma_load_4d(halo0 + s * C64_HALO_BYTES, &xmap, full, 0, tx * p.tw - 1,
                    ty * p.th - p.pad_top, n);
      }
    }
    return;
  }

  // ---- consumers: warpgroup g takes the CTA's items g, g + 2, ... ----------------
  setmaxnreg_inc<232>();
  const int g = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid / 32) % 4, lane = tid % 32;
  // This thread's accumulators: output channels ch0 and ch0 + 8, pixels 8j + 2 (lane % 4) + {0, 1}.
  const int ch0 = 16 * warp + lane / 4;
  float b0 = 0.0f, b1 = 0.0f;
  if constexpr (BIAS_RELU) {
    b0 = ch0 < p.c ? p.bias[ch0] : 0.0f;
    b1 = ch0 + 8 < p.c ? p.bias[ch0 + 8] : 0.0f;
  }
  // The epilogue, per pair of 8-pixel blocks (j, j + 1): stmatrix .trans puts
  // the warp's 16 channels x 16 pixels into its own 512 bytes of shared memory
  // as 32-byte pixel rows (lane l addresses row l % 8 of matrix l / 8: pixel
  // 8 (l / 16) + l % 8, channels 8 ((l / 8) % 2) .. + 7 of the warp's 16; the
  // two 16-byte halves of pixels 4-7 and 12-15 swapped, so no two rows of a
  // matrix share banks), then lane l reads half l % 2 of pixel l / 2 and
  // stores its 16 bytes to global memory.
  const uint32_t xbuf = xbuf0 + (tid / 32) * 512;
  const int st_p = 8 * (lane / 16) + lane % 8, st_u = (lane / 8) % 2;
  const uint32_t st_addr = xbuf + st_p * 32 + ((st_u ^ ((st_p >> 2) & 1)) << 4);
  const int ld_p = lane / 2, ld_u = lane % 2;
  const uint32_t ld_addr = xbuf + ld_p * 32 + ((ld_u ^ ((ld_p >> 2) & 1)) << 4);
  const int co = 16 * warp + 8 * ld_u;  // the channels this lane stores
  mbar_wait(wfull, 0);
  for (int k = g;; k += 2) {
    const int item = blockIdx.x + k * grid;
    if (item >= p.items) break;
    const int s = k % C64_STAGES;
    const uint32_t stage = halo0 + s * C64_HALO_BYTES;
    mbar_wait(hfull0 + 8 * (2 * s + g), (k / (2 * C64_STAGES)) & 1);  // its k-th use: k / 6
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const uint32_t wtile = wgt + (DGRAD ? 8 - tap : tap) * 64 * ROW_BYTES;
      const uint64_t adesc =
          DGRAD ? smem_desc_sw128_mn(wtile, 64 * ROW_BYTES) : smem_desc_sw128(wtile);
      // B: the halo stage's rows from the tap's shift on (K-major, 128-byte swizzle)
      const uint64_t bdesc = smem_desc_sw128(stage + ((tap / 3) * pitch + tap % 3) * ROW_BYTES);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)  // A: +32 bytes per k16 (dgrad: +16 rows); B: +32 bytes
        wgmma_m64n256k16_ss<DGRAD ? 1 : 0>(acc, adesc + (DGRAD ? 128 : 2) * ks, bdesc + 2 * ks);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    mbar_arrive(hempty0 + 8 * s);  // the MMAs have read the stage: the producer may refill it

    // ---- epilogue: (+ bias, ReLU), bf16, transposed per warp, 16-byte stores ----
    const int tx = item % p.tiles_x, rest = item / p.tiles_x;
    const int ty = rest % p.tiles_y, n = rest / p.tiles_y;
    const int x0 = tx * p.tw, y0 = ty * p.th;
    __nv_bfloat16* const out =
        p.out + ((static_cast<long long>(n) * p.oh + y0) * p.w + x0) * p.c + co;
    const bool live_c = co < p.c;  // C is a multiple of 16: a warp's channels all live or none
    int y = 0, x = ld_p;  // this lane's pixel of the pair (pitch >= 16: x < pitch)
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = acc[4 * j + i];
      if constexpr (BIAS_RELU) {
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = fmaxf(v[i] + ((i / 2) % 2 ? b1 : b0), 0.0f);
      }
      stsm_x4_trans(st_addr, pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                    pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
      __syncwarp();
      const uint4 val = ld_shared_v4(ld_addr);
      if (live_c && x < p.tw && y < p.th && x0 + x < p.w && y0 + y < p.oh)
        *reinterpret_cast<uint4*>(out + (static_cast<long long>(y) * p.w + x) * p.c) = val;
      __syncwarp();  // read before the next pair's stmatrix writes
      x += 16;  // the next pair (pitch >= 16: one row on at most)
      if (x >= pitch) {
        x -= pitch;
        ++y;
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call; take it from the driver the
// process already has loaded, so the library needs no -lcuda at link time.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiledFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

struct Tile {
  int th, tw;
};

// The tile of `m` pixels with the fewest M rows over the whole map, ties to
// the smaller halo box.
Tile pick_tile(int m, int max_halo_rows, int h, int w) {
  const int tws[3] = {8, 16, 30};
  Tile best = {0, 0};
  long long best_rows = 0;
  int best_halo = 0;
  for (int tw : tws) {
    const int th = m / tw, halo = (th + 2) * (tw + 2);
    if (halo > max_halo_rows) continue;
    const long long rows = static_cast<long long>((h + th - 1) / th) * ((w + tw - 1) / tw) * m;
    if (best.th == 0 || rows < best_rows || (rows == best_rows && halo < best_halo)) {
      best = {th, tw};
      best_rows = rows;
      best_halo = halo;
    }
  }
  return best;
}

// x has h rows; out has h + pad_top + pad_bottom - 2.
template <typename T, int BN, int LAYOUT, bool BIAS_RELU, bool DGRAD>
int launch(const void* x, const void* wpk, const void* bias, void* out, int n, int h, int w,
           int c, int pad_top, int pad_bottom, cudaStream_t stream) {
  using C = Cfg<T, BN, LAYOUT>;
  constexpr int CHUNK = C::CHUNK;
  constexpr cuuint64_t ES = sizeof(T);
  constexpr CUtensorMapDataType DTYPE =
      C::F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  auto kernel = conv3x3_wgmma_kernel<T, BN, LAYOUT, BIAS_RELU, DGRAD>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);

  // CLUSTER > 1: a launch of clusters of C::CLUSTER CTAs.
  cudaLaunchAttribute cluster_dim;
  cluster_dim.id = cudaLaunchAttributeClusterDimension;
  cluster_dim.val.clusterDim.x = C::CLUSTER;
  cluster_dim.val.clusterDim.y = 1;
  cluster_dim.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster_dim;
  cfg.numAttrs = 1;

  static int sms = 0;
  static int clusters = 0;  // CLUSTER > 1: the clusters the card holds at once
  static bool smem_set = false;
  if (!smem_set) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (C::CLUSTER > 1 && e == cudaSuccess) {
      cfg.gridDim = dim3(C::CLUSTER * sms);
      e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (e == cudaSuccess && clusters < 1) e = cudaErrorInvalidConfiguration;
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }

  const int oh = h + pad_top + pad_bottom - 2;
  const Tile t = pick_tile(TILE_M, HALO_ROWS, oh, w);
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h;
  p.w = w;
  p.c = c;
  p.th = t.th;
  p.tw = t.tw;
  p.tiles_x = (w + t.tw - 1) / t.tw;
  p.tiles_y = (oh + t.th - 1) / t.th;
  p.co_tiles = (c + BN - 1) / BN;
  p.nchunks = (c + CHUNK - 1) / CHUNK;
  p.co_pad = p.co_tiles * BN;
  p.pix_tiles = n * p.tiles_y * p.tiles_x;
  // CLUSTER > 1: items of CLUSTER neighbouring pixel tiles (the last may
  // have fewer live ones) per channel tile.
  p.items = (p.pix_tiles + C::CLUSTER - 1) / C::CLUSTER * p.co_tiles;
  p.pad_top = pad_top;
  p.halo_tx = static_cast<uint32_t>((t.th + 2) * (t.tw + 2) * ROW_BYTES);
  if (C::RESIDENT_W && p.nchunks != 1) return static_cast<int>(cudaErrorInvalidValue);

  alignas(64) CUtensorMap xmap, wmap, ymap;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(c) * ES,
                                 static_cast<cuuint64_t>(w) * c * ES,
                                 static_cast<cuuint64_t>(h) * w * c * ES};
  const cuuint32_t xbox[4] = {CHUNK, static_cast<cuuint32_t>(t.tw + 2),
                              static_cast<cuuint32_t>(t.th + 2), 1};
  if (encode(&xmap, DTYPE, 4, const_cast<void*>(x), xdim, xstride, xbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t ydim[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(oh), static_cast<cuuint64_t>(n)};
  const cuuint64_t ystride[3] = {static_cast<cuuint64_t>(c) * ES,
                                 static_cast<cuuint64_t>(w) * c * ES,
                                 static_cast<cuuint64_t>(oh) * w * c * ES};
  // CLUSTER > 1: each warpgroup stores its half of the tile's rows.
  const cuuint32_t ybox[4] = {CHUNK, static_cast<cuuint32_t>(t.tw),
                              static_cast<cuuint32_t>(C::CLUSTER > 1 ? t.th / 2 : t.th), 1};
  if (encode(&ymap, DTYPE, 4, out, ydim, ystride, ybox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (DGRAD && !C::RESIDENT_W) {
    // The forward's [tap][chunk][co_pad][64] as a 4-D tensor, boxes of 64 co
    // rows of one input-channel chunk; a chunk past the last reads zeros.
    const cuuint64_t wdim[4] = {CHUNK, static_cast<cuuint64_t>(p.co_pad),
                                static_cast<cuuint64_t>(p.nchunks), 9};
    const cuuint64_t wstride[3] = {ROW_BYTES, static_cast<cuuint64_t>(p.co_pad) * ROW_BYTES,
                                   static_cast<cuuint64_t>(p.nchunks) * p.co_pad * ROW_BYTES};
    const cuuint32_t wbox[4] = {CHUNK, CHUNK, 1, 1};
    if (encode(&wmap, DTYPE, 4, const_cast<void*>(wpk), wdim, wstride, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  } else {
    // f32: [plane][tap][chunk][co_pad][32] as rows of one 128-byte chunk.
    const cuuint64_t wdim[2] = {CHUNK,
                                static_cast<cuuint64_t>(C::PLANES) * 9 * p.nchunks * p.co_pad};
    const cuuint64_t wstride[1] = {ROW_BYTES};
    const cuuint32_t wbox[2] = {CHUNK, BN / C::CLUSTER};  // CLUSTER > 1: a CTA's share
    if (encode(&wmap, DTYPE, 2, const_cast<void*>(wpk), wdim, wstride, wbox, ones,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }

  if constexpr (C::CLUSTER > 1) {
    // Persistent: as many clusters as the card holds at once, at most one per item.
    cfg.gridDim = dim3(C::CLUSTER * (p.items < clusters ? p.items : clusters));
    void* args[] = {&xmap, &wmap, &ymap, &p};
    const cudaError_t e = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel), args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
  }
  const int ctas = (p.items + C::GROUPS - 1) / C::GROUPS;
  const int grid = ctas < sms ? ctas : sms;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(xmap, wmap, ymap, p);
  return static_cast<int>(cudaGetLastError());
}

// The c64 kernel's tile for an oh x w output: the C64_TILES shape with the
// fewest tiles (each a full wgmma N), ties to the first.
Tile pick_tile_c64(int oh, int w) {
  Tile best = {0, 0};
  long long best_tiles = 0;
  for (const auto& t : C64_TILES) {
    const long long tiles =
        static_cast<long long>((w + t[0] - 1) / t[0]) * ((oh + t[1] - 1) / t[1]);
    if (best.th == 0 || tiles < best_tiles) {
      best = {t[1], t[0]};
      best_tiles = tiles;
    }
  }
  return best;
}

// bf16 at C <= 64: x has h rows, out h + pad_top + pad_bottom - 2; wpk the
// forward's packing [tap][1][64][64] (dgrad reads it flipped and transposed).
template <bool BIAS_RELU, bool DGRAD>
int launch_c64(const void* x, const void* wpk, const void* bias, void* out, int n, int h, int w,
               int c, int pad_top, int pad_bottom, cudaStream_t stream) {
  auto kernel = conv3x3_c64_kernel<BIAS_RELU, DGRAD>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  if (c > 64 || reinterpret_cast<uintptr_t>(out) % 16 != 0)  // 16-byte stores of 8 channels
    return static_cast<int>(cudaErrorInvalidValue);
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C64_SMEM);
    if (e != cudaSuccess) {
      sms = 0;
      return static_cast<int>(e);
    }
  }
  const int oh = h + pad_top + pad_bottom - 2;
  const Tile t = pick_tile_c64(oh, w);
  C64Params p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.c = c;
  p.w = w;
  p.oh = oh;
  p.th = t.th;
  p.tw = t.tw;
  p.tiles_x = (w + t.tw - 1) / t.tw;
  p.tiles_y = (oh + t.th - 1) / t.th;
  const long long items = static_cast<long long>(n) * p.tiles_y * p.tiles_x;
  if (items > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  p.items = static_cast<int>(items);
  p.pad_top = pad_top;
  p.halo_tx = static_cast<uint32_t>((t.th + 2) * (t.tw + 2) * ROW_BYTES);

  alignas(64) CUtensorMap xmap, wmap;
  constexpr cuuint64_t ES = 2;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  // The halo: boxes of (64 channels, TW + 2, TH + 2, 1) at (0, x0 - 1, y0 - pad_top, n);
  // TMA's zero fill is the padding, in W and H and past C.
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(c) * ES,
                                 static_cast<cuuint64_t>(w) * c * ES,
                                 static_cast<cuuint64_t>(h) * w * c * ES};
  const cuuint32_t xbox[4] = {64, static_cast<cuuint32_t>(t.tw + 2),
                              static_cast<cuuint32_t>(t.th + 2), 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  // The weights: [tap][64 co][64 ci] as rows of 128 bytes, one box of 64 rows per tap.
  const cuuint64_t wdim[2] = {64, 9 * 64};
  const cuuint64_t wstride[1] = {ROW_BYTES};
  const cuuint32_t wbox[2] = {64, 64};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wpk), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  // Persistent: at most one CTA per SM, and two items (one per group) per CTA at least.
  const int ctas = (p.items + 1) / 2;
  const int grid = ctas < sms ? ctas : sms;
  kernel<<<grid, THREADS, C64_SMEM, stream>>>(xmap, wmap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- CUDA-core path: f32 with C % 4 != 0, bf16 with C % 16 != 0 ----------------

constexpr int TH = 8;          // tile rows
constexpr int TW = 16;         // tile columns
constexpr int HALO_W = TW + 2;
constexpr int CO_T = 64;       // output channels per block
constexpr int THREADS = 256;
constexpr int CI_T = 8;        // input channels per stage
constexpr int PX = 4;          // neighbouring pixels per thread (along W)
constexpr int CO_PER = 8;      // output channels per thread, strided by 8
static_assert((TH * TW / PX) * (CO_T / CO_PER) == THREADS, "one thread per micro-tile");

// DGRAD: wt is the forward's packing, read flipped and transposed by index.
template <typename T, bool BIAS_RELU, bool DGRAD>
__global__ void __launch_bounds__(THREADS) conv3x3_fma_kernel(
    const T* __restrict__ x, const T* __restrict__ wt, const float* __restrict__ bias,
    T* __restrict__ out, int h, int w, int c, int tiles_x, int oh, int pad_top) {
  __shared__ float in_s[CI_T][TH + 2][HALO_W];
  __shared__ float w_s[9][CI_T][CO_T];

  const int t = threadIdx.x;
  const int cg = t % CO_PER;               // this thread's channels: co0 + cg + 8*j
  const int pg = t / CO_PER;               // pixel group 0..31
  const int row = pg / (TW / PX);          // 0..TH-1
  const int col = (pg % (TW / PX)) * PX;   // 0, 4, 8, 12

  const int tile_y = (blockIdx.x / tiles_x) * TH;
  const int tile_x = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * CO_T;
  const long long img = (long long)blockIdx.z * h, img_out = (long long)blockIdx.z * oh;

  float acc[PX][CO_PER];
#pragma unroll
  for (int p = 0; p < PX; ++p)
#pragma unroll
    for (int j = 0; j < CO_PER; ++j) acc[p][j] = 0.0f;

  for (int ci0 = 0; ci0 < c; ci0 += CI_T) {
    __syncthreads();  // the previous stage is consumed
    for (int e = t; e < (TH + 2) * HALO_W * CI_T; e += THREADS) {
      const int ci = e % CI_T;
      const int pix = e / CI_T;
      const int ly = pix / HALO_W, lx = pix % HALO_W;
      const int gy = tile_y + ly - pad_top, gx = tile_x + lx - 1, gc = ci0 + ci;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && gc < c)
        v = to_f32(x[((img + gy) * w + gx) * c + gc]);
      in_s[ci][ly][lx] = v;
    }
    for (int e = t; e < 9 * CI_T * CO_T; e += THREADS) {
      const int ci = e % CI_T;
      const int co = (e / CI_T) % CO_T;
      const int tap = e / (CI_T * CO_T);
      const int gc = ci0 + ci, go = co0 + co;
      float v = 0.0f;
      if (gc < c && go < c)
        v = to_f32(DGRAD ? wt[((long long)(8 - tap) * c + gc) * c + go]
                         : wt[((long long)tap * c + go) * c + gc]);
      w_s[tap][ci][co] = v;
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CI_T; ++ci) {
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float xin[PX + 2];
#pragma unroll
        for (int i = 0; i < PX + 2; ++i) xin[i] = in_s[ci][row + ky][col + i];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float wv[CO_PER];
#pragma unroll
          for (int j = 0; j < CO_PER; ++j) wv[j] = w_s[ky * 3 + kx][ci][cg + CO_PER * j];
#pragma unroll
          for (int p = 0; p < PX; ++p)
#pragma unroll
            for (int j = 0; j < CO_PER; ++j) acc[p][j] = fmaf(xin[p + kx], wv[j], acc[p][j]);
        }
      }
    }
  }

  const int gy = tile_y + row;
  if (gy >= oh) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = tile_x + col + p;
    if (gx >= w) continue;
    T* dst = out + ((img_out + gy) * w + gx) * c;
#pragma unroll
    for (int j = 0; j < CO_PER; ++j) {
      const int co = co0 + cg + CO_PER * j;
      if (co < c) dst[co] = from_f32<T>(BIAS_RELU ? fmaxf(acc[p][j] + bias[co], 0.0f) : acc[p][j]);
    }
  }
}

// f32 tensor-core path with grad on: the forward's two tf32 planes and
// dgrad's (the weights flipped in space and transposed in channels) in one
// pass, out = [layout: forward, dgrad][plane: w_big, w_small][tap][chunk of
// 32][co_pad][32]. wgmma takes no transposed tf32 B, so dgrad cannot read
// the forward's planes as the bf16 path does. The split is done on the bits,
// as ops/conv3x3.py:tf32_split does (+0x1000, clear the low 13), so both
// layouts equal pack_conv3x3_weight's bit for bit. w is OIHW f32 with
// strides (so, si, sy, sx) in elements. Bound by bytes: 9*C*C f32 read,
// four times that (and the padding) written.
__global__ void conv3x3_pack_tf32x3_kernel(const float* __restrict__ w, float* __restrict__ out,
                                           int c, int chunks, int co_pad, long long so,
                                           long long si, long long sy, long long sx,
                                           long long plane) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= plane) return;
  const int k = static_cast<int>(e % 32);
  const int row = static_cast<int>((e / 32) % co_pad);
  const long long rest = e / (32LL * co_pad);
  const int chunk = static_cast<int>(rest % chunks), tap = static_cast<int>(rest / chunks);
  const int kk = chunk * 32 + k;  // the K index: input channel of this layout's conv
  const bool live = row < c && kk < c;
  const int fy = tap / 3, fx = tap % 3;
  const float fwd = live ? w[row * so + kk * si + fy * sy + fx * sx] : 0.0f;
  const float dg = live ? w[kk * so + row * si + (2 - fy) * sy + (2 - fx) * sx] : 0.0f;
  const float vals[2] = {fwd, dg};
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const float big = __uint_as_float((__float_as_uint(vals[l]) + 0x1000u) & ~0x1FFFu);
    const float small = __uint_as_float((__float_as_uint(vals[l] - big) + 0x1000u) & ~0x1FFFu);
    out[(2 * l) * plane + e] = big;
    out[(2 * l + 1) * plane + e] = small;
  }
}

// Epilogue and weight-read mode of a launch: MODE_CONV stores the bare conv
// and never reads bias; MODE_BIAS_RELU stores relu(conv + bias) (the fused
// forward); MODE_DGRAD stores the bare conv of the output's gradient with
// the forward's packed weights read flipped and transposed in the kernel
// (bf16 tensor-core and CUDA-core paths; the f32 tensor-core path's dgrad
// reads the planes conv3x3_pack_tf32x3 wrote, in MODE_CONV). Each mode is its
// own template instance, so the forward's code is the same as without the
// modes. pad_top, pad_bottom (0 to 2 each; SAME is 1, 1): the zero rows
// above and below x in H; out has h + pad_top + pad_bottom - 2 rows.
constexpr int MODE_CONV = 0, MODE_BIAS_RELU = 1, MODE_DGRAD = 2;

bool bad_pads(int h, int pad_top, int pad_bottom) {
  return pad_top < 0 || pad_top > 2 || pad_bottom < 0 || pad_bottom > 2 ||
         h + pad_top + pad_bottom - 2 < 1;
}

template <typename T, int BN, int LAYOUT>
int tc_modes(int mode, const void* x, const void* wpk, const void* bias, void* out, int n, int h,
             int w, int c, int pt, int pb, cudaStream_t s) {
  if (mode == MODE_BIAS_RELU)
    return tc::launch<T, BN, LAYOUT, true, false>(x, wpk, bias, out, n, h, w, c, pt, pb, s);
  if constexpr (sizeof(T) == 2) {
    if (mode == MODE_DGRAD)
      return tc::launch<T, BN, LAYOUT, false, true>(x, wpk, bias, out, n, h, w, c, pt, pb, s);
  }
  if (mode != MODE_CONV) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch<T, BN, LAYOUT, false, false>(x, wpk, bias, out, n, h, w, c, pt, pb, s);
}

int c64_modes(int mode, const void* x, const void* wpk, const void* bias, void* out, int n, int h,
              int w, int c, int pt, int pb, cudaStream_t s) {
  if (mode == MODE_BIAS_RELU)
    return tc::launch_c64<true, false>(x, wpk, bias, out, n, h, w, c, pt, pb, s);
  if (mode == MODE_DGRAD)
    return tc::launch_c64<false, true>(x, wpk, bias, out, n, h, w, c, pt, pb, s);
  if (mode != MODE_CONV) return static_cast<int>(cudaErrorInvalidValue);
  return tc::launch_c64<false, false>(x, wpk, bias, out, n, h, w, c, pt, pb, s);
}

template <typename T, bool BIAS_RELU, bool DGRAD>
int fma_launch(const void* x, const void* wt, const float* bias, void* out, dim3 grid, int h,
               int w, int c, int tiles_x, int oh, int pad_top, cudaStream_t s) {
  conv3x3_fma_kernel<T, BIAS_RELU, DGRAD><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wt), bias, static_cast<T*>(out), h, w, c,
      tiles_x, oh, pad_top);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int fma_modes(int mode, const void* x, const void* wt, const float* bias, void* out, dim3 grid,
              int h, int w, int c, int tiles_x, int oh, int pad_top, cudaStream_t s) {
  if (mode == MODE_BIAS_RELU)
    return fma_launch<T, true, false>(x, wt, bias, out, grid, h, w, c, tiles_x, oh, pad_top, s);
  if (mode == MODE_DGRAD)
    return fma_launch<T, false, true>(x, wt, bias, out, grid, h, w, c, tiles_x, oh, pad_top, s);
  if (mode != MODE_CONV) return static_cast<int>(cudaErrorInvalidValue);
  return fma_launch<T, false, false>(x, wt, bias, out, grid, h, w, c, tiles_x, oh, pad_top, s);
}

}  // namespace

// Tensor-core path. x, wpk (packed) and out bf16; bias f32. Needs C % 16 == 0
// and 16-byte aligned x and wpk (TMA); C <= 64 takes the persistent
// resident-weight kernel, C > 64 the streamed-weight one. mode: MODE_*.
extern "C" int conv3x3_wgmma_launch(const void* x, const void* wpk, const void* bias, void* out,
                                    int n, int h, int w, int c, int mode, int pad_top,
                                    int pad_bottom, void* stream) {
  if (c % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wpk) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0 ||
      bad_pads(h, pad_top, pad_bottom))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (c <= 64) return c64_modes(mode, x, wpk, bias, out, n, h, w, c, pad_top, pad_bottom, s);
  return tc_modes<bf16, 128, tc::STREAMED>(mode, x, wpk, bias, out, n, h, w, c, pad_top,
                                           pad_bottom, s);
}

// Tensor-core path in f32 (3xTF32). x, out and bias f32; wpk the two tf32
// planes [plane][tap][chunk of 32][co_pad][32]. Needs C % 4 == 0 (TMA's
// 16-byte strides) and 16-byte aligned x, wpk and out; C <= 64 takes the
// two-pipeline kernel (PIPES, 64 output channels), C > 64 the streamed one
// (128), weights streamed in both. mode: MODE_CONV or MODE_BIAS_RELU (dgrad
// is MODE_CONV on dgrad's planes).
extern "C" int conv3x3_tf32x3_launch(const void* x, const void* wpk, const void* bias, void* out,
                                     int n, int h, int w, int c, int mode, int pad_top,
                                     int pad_bottom, void* stream) {
  if (c % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wpk) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      bad_pads(h, pad_top, pad_bottom))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 64)
    return tc_modes<float, 64, tc::PIPES>(mode, x, wpk, bias, out, n, h, w, c, pad_top,
                                          pad_bottom, s);
  return tc_modes<float, 128, tc::STREAMED>(mode, x, wpk, bias, out, n, h, w, c, pad_top,
                                            pad_bottom, s);
}

// CUDA-core path. dtype: 0 = float32, 1 = bfloat16 (x, wt and out); bias is
// float32; wt is [ky][kx][co][ci] (MODE_DGRAD: the forward's). mode: MODE_*.
extern "C" int conv3x3_fma_launch(const void* x, const void* wt, const void* bias, void* out,
                                  int n, int h, int w, int c, int dtype, int mode,
                                  int pad_top, int pad_bottom, void* stream) {
  if (bad_pads(h, pad_top, pad_bottom)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int oh = h + pad_top + pad_bottom - 2;
  const int tiles_x = (w + TW - 1) / TW;
  const dim3 grid(tiles_x * ((oh + TH - 1) / TH), (c + CO_T - 1) / CO_T, n);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) return fma_modes<float>(mode, x, wt, b, out, grid, h, w, c, tiles_x, oh, pad_top, s);
  if (dtype == 1)
    return fma_modes<__nv_bfloat16>(mode, x, wt, b, out, grid, h, w, c, tiles_x, oh, pad_top, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The f32 tensor-core path's packing with grad on (conv3x3_pack_tf32x3_kernel):
// w OIHW f32 with strides so, si, sy, sx (elements); out f32 of
// 4 * 9 * chunks * co_pad * 32 elements, 16-byte aligned.
extern "C" int conv3x3_pack_tf32x3_launch(const void* w, void* out, int c, int chunks, int co_pad,
                                          long long so, long long si, long long sy, long long sx,
                                          void* stream) {
  if (c < 1 || chunks * 32 < c || co_pad < c || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long plane = 9LL * chunks * co_pad * 32;
  const int threads = 256;
  const long long blocks = (plane + threads - 1) / threads;
  conv3x3_pack_tf32x3_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(out), c, chunks, co_pad, so, si, sy, sx,
      plane);
  return static_cast<int>(cudaGetLastError());
}
