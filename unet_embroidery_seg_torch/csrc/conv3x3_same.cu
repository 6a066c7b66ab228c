// SAME, stride-1 3x3 convolution with C_in = C_out, fused bias and ReLU.
//
// Replaces: docs/negative-results/pallas_conv.py, conv3x3_same
// (pl.pallas_call over _kernel): NHWC x HWIO -> NHWC with f32 accumulation,
// one im2col GEMM per kernel row on the TPU. As there, the same kernel
// computes dgrad (dx of the conv) when given the weights flipped in space
// and transposed in channels, with the epilogue's bias and ReLU off
// (bias_relu = 0; ops/conv3x3.py:conv3x3_dgrad).
//
// Bound on the H100: 2*9*C*C FLOP per output pixel against 4*C bytes of
// bf16 input and output. At the six unet_resnet50 decoder sites (480^2,
// batch 8, bf16) that is 408 GFLOP, ~412 us at the 989 TFLOP/s bf16
// tensor-core rate. The C >= 128 sites are bound by operations; at C = 64
// the bytes take about as long (the 480^2 sites: 141 us of bytes, 137 us of
// operations).
//
// Two paths:
//
//  - bf16 with C % 16 == 0 (every decoder site): conv3x3_wgmma_kernel, an
//    implicit GEMM on the tensor cores. M = output pixels, N = output
//    channels, K = 9 taps x C_in, f32 accumulators in registers. Persistent:
//    one CTA per SM walks (pixel tile, channel tile) items.
//      * Warp roles: two consumer warpgroups (setmaxnreg 232) and a producer
//        warpgroup (setmaxnreg 40) one thread of which issues every TMA
//        copy (cp.async.bulk.tensor) into mbarrier rings. A halo stage is a
//        4-D box (64 channels, TW+2, TH+2, 1 image) of the NHWC input at
//        (c0, x0-1, y0-1, n): TMA's zero fill outside the tensor is the
//        SAME padding (and pads C up to 64), so no edge is masked on load.
//        64 bf16 channels are 128 bytes, the 128-byte swizzle width.
//      * MMA: wgmma.mma_async m64nNk16 (bf16 in, f32 accumulate). B (the
//        weights, [co][64 ci] rows, 128B-swizzled by TMA) comes from shared
//        memory through a descriptor. A is the pixel window shifted by the
//        tap, which no shared-memory descriptor can address (a one-pixel
//        shift crosses 8-row core matrices), so A comes from registers:
//        ldmatrix with one row address per lane into the halo tile at the
//        tap's shift, un-swizzled by hand. A is double-buffered in
//        registers: tap t+1's ldmatrix runs while tap t's wgmma does.
//      * C <= 64 (up_concat1.conv2, up_conv.1/.3; bound by bytes):
//        "c64_persistent". All 9 x 64 x 64 weights (72 KB) are loaded once
//        per CTA and stay. Each consumer warpgroup is its own pipeline (own
//        128-pixel tiles, own 3-stage halo ring, own producer thread), so
//        one warpgroup's epilogue runs under the other's MMAs; N = 64. The
//        smaller tile over-reads the halo 1.41x (a shared 256-pixel 16 x 16
//        tile would be 1.27x), which L2 absorbs; at this C the limit on the
//        SM is shared-memory bandwidth (ldmatrix of A plus wgmma's reads of
//        B about equal the tensor-core time), not device memory.
//      * C > 64 (up_concat{4,3,2}.conv2; bound by operations): "wgmma".
//        Tiles of 128 pixels x 128 output channels, one slab of m64 per
//        consumer warpgroup; per 64-channel chunk one halo stage (reused by
//        all 9 taps) and 9 weight tiles of 16 KB streamed through a 6-stage
//        ring.
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
//        just consumed, the C > 64 path in a 32 KB buffer of its own.
//  - everything else (f32, odd C): conv3x3_fma_kernel on the CUDA cores. An
//    8 x 16 pixel tile x 64 output channels per block; each stage holds 8
//    input channels of the (8+2) x (16+2) halo tile as f32; each thread
//    accumulates 4 neighbouring pixels x 8 output channels and reuses the 6
//    inputs of a kernel row for 3 taps (96 FMA per 30 shared-memory reads).
//    Any N, H, W, C >= 1.
//
// Weights arrive packed once per parameter version by the wrapper
// (ops/conv3x3.py:pack_conv3x3_weight), bias as f32:
//  - tensor-core path: bf16 [tap = ky*3+kx][C_in chunk of 64][co_pad][64],
//    zero in the padding (co_pad = C rounded up to N);
//  - CUDA-core path: [ky][kx][co][ci] in the activation type.
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

// ---- tensor-core path: bf16, C % 16 == 0 -------------------------------------

namespace tc {

constexpr int CONSUMERS = 256;             // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;   // and one producer warpgroup
constexpr int CHUNK = 64;                  // input channels per halo stage
constexpr int ROW_BYTES = CHUNK * 2;       // one pixel or weight row: 128 bytes
constexpr int TILE_M = 128;                // pixels per tile
constexpr int HALO_ROWS = 192;             // most (TH+2)*(TW+2) of a tile shape (4 x 30)

// A "group" is one pipeline: its consumer warpgroups share a tile, a halo
// ring and a producer thread. RESIDENT (C <= 64): two groups of one
// warpgroup each (two slabs of m64), so one group's epilogue overlaps the
// other's MMAs; both read the one resident weight set. Streamed (C > 64):
// one group of two warpgroups (one slab each) sharing every weight tile.
template <int BN, bool RESIDENT>
struct Cfg {
  static constexpr int GROUPS = RESIDENT ? 2 : 1;
  static constexpr int WGS = 2 / GROUPS;                   // warpgroups per group
  static constexpr int SLABS = TILE_M / 64 / WGS;          // m64 slabs per warpgroup
  static constexpr int HALO_BYTES = HALO_ROWS * ROW_BYTES;  // a multiple of 1024
  static constexpr int H_STAGES = 3;                       // per group
  static constexpr int W_TILE = BN * ROW_BYTES;            // one tap, one chunk
  static constexpr int W_STAGES = RESIDENT ? 9 : 6;
  static constexpr int OUT_BYTES = RESIDENT ? 0 : TILE_M * BN * 2;  // epilogue staging
  static constexpr int BARS = 2 * GROUPS * H_STAGES + 2 * W_STAGES;
  static constexpr int SMEM =
      1024 + GROUPS * H_STAGES * HALO_BYTES + W_STAGES * W_TILE + OUT_BYTES + 8 * BARS;
  static_assert(HALO_BYTES % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(SMEM <= 232448, "over the 227 KB a block can have");
};

struct Params {
  const float* bias;  // read only by the BIAS_RELU kernels
  __nv_bfloat16* out;
  int h, w, c, th, tw, tiles_x, tiles_y, co_tiles, nchunks, co_pad, items;
  uint32_t halo_tx;  // bytes of one halo box
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

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Commits the stores issued so far and waits until they have read their
// shared-memory source (the writes to global memory go on in the background).
__device__ __forceinline__ void bulk_store_wait_read() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

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

__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BN == 64) wgmma_m64n64k16(d, a, desc);
  else wgmma_m64n128k16(d, a, desc);
}

template <int BN, bool RESIDENT, bool BIAS_RELU>
__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         const __grid_constant__ CUtensorMap ymap, const Params p) {
  using C = Cfg<BN, RESIDENT>;
  constexpr int SLABS = C::SLABS;
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align every stage to it.
  const uint32_t halo0 = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t wgt0 = halo0 + C::GROUPS * C::H_STAGES * C::HALO_BYTES;
  const uint32_t out0 = wgt0 + C::W_STAGES * C::W_TILE;
  const uint32_t bars = out0 + C::OUT_BYTES;
  // Barriers: hfull[group][stage], hempty[group][stage], wfull[stage], wempty[stage].
  const uint32_t hfull0 = bars, hempty0 = hfull0 + 8 * C::GROUPS * C::H_STAGES;
  const uint32_t wfull = hempty0 + 8 * C::GROUPS * C::H_STAGES;
  const uint32_t wempty = wfull + 8 * C::W_STAGES;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < C::GROUPS * C::H_STAGES; ++s) {
      mbar_init(hfull0 + 8 * s, 1);
      mbar_init(hempty0 + 8 * s, 128 * C::WGS);
    }
    for (int s = 0; s < C::W_STAGES; ++s) {
      mbar_init(wfull + 8 * s, 1);
      mbar_init(wempty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int halo_w = p.tw + 2;
  const int slots = gridDim.x * C::GROUPS;  // item stride: one slot per group

  if (tid >= CONSUMERS) {
    // ---- producer warpgroup: lane 0 of warp g keeps group g's rings full ----
    setmaxnreg_dec<40>();
    const int g = (tid - CONSUMERS) / 32;
    if (g < C::GROUPS && tid % 32 == 0) {
      const uint32_t hfull = hfull0 + 8 * g * C::H_STAGES;
      const uint32_t hempty = hempty0 + 8 * g * C::H_STAGES;
      const uint32_t halo_g = halo0 + g * C::H_STAGES * C::HALO_BYTES;
      if (RESIDENT && g == 0) {
        mbar_expect_tx(wfull, 9 * C::W_TILE);
        for (int tap = 0; tap < 9; ++tap)
          tma_load_2d(wgt0 + tap * C::W_TILE, &wmap, wfull, 0, tap * p.co_pad);
      }
      int hi = 0, wi = 0;
      for (int item = blockIdx.x * C::GROUPS + g; item < p.items; item += slots) {
        const int co_t = item % p.co_tiles;
        int pix = item / p.co_tiles;
        const int tx = pix % p.tiles_x;
        pix /= p.tiles_x;
        const int ty = pix % p.tiles_y, n = pix / p.tiles_y;
        for (int ch = 0; ch < p.nchunks; ++ch, ++hi) {
          const int hs = hi % C::H_STAGES;
          mbar_wait(hempty + 8 * hs, ((hi / C::H_STAGES) & 1) ^ 1);
          mbar_expect_tx(hfull + 8 * hs, p.halo_tx);
          tma_load_4d(halo_g + hs * C::HALO_BYTES, &xmap, hfull + 8 * hs, ch * CHUNK,
                      tx * p.tw - 1, ty * p.th - 1, n);
          if (!RESIDENT) {
            for (int tap = 0; tap < 9; ++tap, ++wi) {
              const int ws = wi % C::W_STAGES;
              mbar_wait(wempty + 8 * ws, ((wi / C::W_STAGES) & 1) ^ 1);
              mbar_expect_tx(wfull + 8 * ws, C::W_TILE);
              tma_load_2d(wgt0 + ws * C::W_TILE, &wmap, wfull + 8 * ws, 0,
                          (tap * p.nchunks + ch) * p.co_pad + co_t * BN);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg of group g, SLABS m64 slabs each -----------
    setmaxnreg_inc<232>();
    const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
    const int g = wg / C::WGS, wg_in = wg % C::WGS;
    const uint32_t hfull = hfull0 + 8 * g * C::H_STAGES;
    const uint32_t hempty = hempty0 + 8 * g * C::H_STAGES;
    const uint32_t halo_g = halo0 + g * C::H_STAGES * C::HALO_BYTES;
    const int tile_px = p.th * p.tw;
    // ldmatrix: lane -> A row (pixel) and 8-channel half of the k16 step.
    const int lrow = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int khalf = lane >> 4;
    int a_row[SLABS];  // halo row of this lane's pixel at tap (0, 0)
#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      int m = (wg_in * SLABS + s) * 64 + lrow;
      if (m >= tile_px) m = 0;  // dead row: read a valid pixel, store nothing
      a_row[s] = (m / p.tw) * halo_w + m % p.tw;
    }

    if (RESIDENT) mbar_wait(wfull, 0);
    int hi = 0, wi = 0, last_hs = 0;
    for (int item = blockIdx.x * C::GROUPS + g; item < p.items; item += slots) {
      const int co_t = item % p.co_tiles;
      int pix = item / p.co_tiles;
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
        uint32_t a[2][SLABS][4][4];  // [buffer][slab][k16 step][register]
        int prev_ws = 0;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          uint32_t wtile;
          int ws = 0;
          if (RESIDENT) {
            wtile = wgt0 + tap * C::W_TILE;
          } else {
            ws = wi % C::W_STAGES;
            mbar_wait(wfull + 8 * ws, (wi / C::W_STAGES) & 1);
            ++wi;
            wtile = wgt0 + ws * C::W_TILE;
          }
          const int shift = (tap / 3) * halo_w + tap % 3;
#pragma unroll
          for (int s = 0; s < SLABS; ++s) {
            const uint32_t r = a_row[s] + shift;
            const uint32_t row_addr = halo + r * ROW_BYTES;
#pragma unroll
            for (int ks = 0; ks < 4; ++ks)
              ldsm_x4(row_addr + ((((ks * 2 + khalf) ^ r) & 7) << 4), a[tap & 1][s][ks]);
          }
          wgmma_fence();
          const uint64_t desc = smem_desc_sw128(wtile);
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
#pragma unroll
            for (int s = 0; s < SLABS; ++s)
              wgmma_tile<BN>(acc[s], a[tap & 1][s][ks], desc + 2 * ks);  // +32 bytes per k16
          wgmma_commit();
          wgmma_wait<1>();  // tap - 1 is done: its A registers and weight stage are free
          if (!RESIDENT && tap > 0) mbar_arrive(wempty + 8 * prev_ws);
          prev_ws = ws;
        }
        wgmma_wait<0>();
        if (!RESIDENT) mbar_arrive(wempty + 8 * prev_ws);
        if (!RESIDENT) mbar_arrive(hempty + 8 * hs);  // else released after the store
        last_hs = hs;
      }
#pragma unroll
      for (int s = 0; s < SLABS; ++s) fence_operands(acc[s]);

      // ---- epilogue: (+ bias, ReLU if BIAS_RELU), bf16, TMA store ------------
      // The tile goes to shared memory as rows of 128 bytes (one pixel, 64
      // channels) with the 128-byte swizzle, conflict-free (the 8 rows of one
      // store get 8 distinct 16-byte chunks), then one TMA store per 64
      // channels writes the (64, TW, TH, 1) box; TMA clips the ragged edges
      // and the channels past C. RESIDENT stages in the halo stage it just
      // consumed (released after the store), streamed in its own buffer.
      const uint32_t stage = RESIDENT ? halo_g + last_hs * C::HALO_BYTES : out0;
      const int x0 = tx * p.tw, y0 = ty * p.th, co0 = co_t * BN + 2 * (lane % 4);
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
      if (RESIDENT) mbar_arrive(hempty + 8 * last_hs);
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

template <int BN, bool RESIDENT, bool BIAS_RELU>
int launch(const void* x, const void* wpk, const void* bias, void* out, int n, int h, int w,
           int c, cudaStream_t stream) {
  using C = Cfg<BN, RESIDENT>;
  auto kernel = conv3x3_wgmma_kernel<BN, RESIDENT, BIAS_RELU>;
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);

  static int sms = 0;
  static bool smem_set = false;
  if (!smem_set) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }

  const Tile t = pick_tile(TILE_M, HALO_ROWS, h, w);
  Params p;
  p.bias = static_cast<const float*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.h = h;
  p.w = w;
  p.c = c;
  p.th = t.th;
  p.tw = t.tw;
  p.tiles_x = (w + t.tw - 1) / t.tw;
  p.tiles_y = (h + t.th - 1) / t.th;
  p.co_tiles = (c + BN - 1) / BN;
  p.nchunks = (c + CHUNK - 1) / CHUNK;
  p.co_pad = p.co_tiles * BN;
  p.items = n * p.tiles_y * p.tiles_x * p.co_tiles;
  p.halo_tx = static_cast<uint32_t>((t.th + 2) * (t.tw + 2) * ROW_BYTES);
  if (RESIDENT && p.nchunks != 1) return static_cast<int>(cudaErrorInvalidValue);

  alignas(64) CUtensorMap xmap, wmap, ymap;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  const cuuint64_t xdim[4] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t xstride[3] = {static_cast<cuuint64_t>(c) * 2,
                                 static_cast<cuuint64_t>(w) * c * 2,
                                 static_cast<cuuint64_t>(h) * w * c * 2};
  const cuuint32_t xbox[4] = {CHUNK, static_cast<cuuint32_t>(t.tw + 2),
                              static_cast<cuuint32_t>(t.th + 2), 1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), xdim, xstride, xbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint32_t ybox[4] = {CHUNK, static_cast<cuuint32_t>(t.tw), static_cast<cuuint32_t>(t.th), 1};
  if (encode(&ymap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, out, xdim, xstride, ybox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdim[2] = {CHUNK, static_cast<cuuint64_t>(9) * p.nchunks * p.co_pad};
  const cuuint64_t wstride[1] = {ROW_BYTES};
  const cuuint32_t wbox[2] = {CHUNK, BN};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(wpk), wdim, wstride,
             wbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const int ctas = (p.items + C::GROUPS - 1) / C::GROUPS;
  const int grid = ctas < sms ? ctas : sms;
  kernel<<<grid, THREADS, C::SMEM, stream>>>(xmap, wmap, ymap, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- CUDA-core path: f32, or bf16 with C % 16 != 0 ----------------------------

constexpr int TH = 8;          // tile rows
constexpr int TW = 16;         // tile columns
constexpr int HALO_W = TW + 2;
constexpr int CO_T = 64;       // output channels per block
constexpr int THREADS = 256;
constexpr int CI_T = 8;        // input channels per stage
constexpr int PX = 4;          // neighbouring pixels per thread (along W)
constexpr int CO_PER = 8;      // output channels per thread, strided by 8
static_assert((TH * TW / PX) * (CO_T / CO_PER) == THREADS, "one thread per micro-tile");

template <typename T, bool BIAS_RELU>
__global__ void __launch_bounds__(THREADS) conv3x3_fma_kernel(
    const T* __restrict__ x, const T* __restrict__ wt, const float* __restrict__ bias,
    T* __restrict__ out, int h, int w, int c, int tiles_x) {
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
  const long long img = (long long)blockIdx.z * h;

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
      const int gy = tile_y + ly - 1, gx = tile_x + lx - 1, gc = ci0 + ci;
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
      if (gc < c && go < c) v = to_f32(wt[((long long)tap * c + go) * c + gc]);
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
  if (gy >= h) return;
#pragma unroll
  for (int p = 0; p < PX; ++p) {
    const int gx = tile_x + col + p;
    if (gx >= w) continue;
    T* dst = out + ((img + gy) * w + gx) * c;
#pragma unroll
    for (int j = 0; j < CO_PER; ++j) {
      const int co = co0 + cg + CO_PER * j;
      if (co < c) dst[co] = from_f32<T>(BIAS_RELU ? fmaxf(acc[p][j] + bias[co], 0.0f) : acc[p][j]);
    }
  }
}

}  // namespace

// Epilogue mode, both paths: bias_relu = 1 stores relu(conv + bias) (the
// forward), 0 stores the bare conv and never reads bias (dgrad). Each mode
// is its own template instance, so the forward's code is the same as
// without the mode.
//
// Tensor-core path. x, wpk (packed) and out bf16; bias f32. Needs C % 16 == 0
// and 16-byte aligned x and wpk (TMA); C <= 64 takes the persistent
// resident-weight kernel, C > 64 the streamed-weight one.
extern "C" int conv3x3_wgmma_launch(const void* x, const void* wpk, const void* bias, void* out,
                                    int n, int h, int w, int c, int bias_relu, void* stream) {
  if (c % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wpk) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= tc::CHUNK) {
    if (bias_relu) return tc::launch<64, true, true>(x, wpk, bias, out, n, h, w, c, s);
    return tc::launch<64, true, false>(x, wpk, bias, out, n, h, w, c, s);
  }
  if (bias_relu) return tc::launch<128, false, true>(x, wpk, bias, out, n, h, w, c, s);
  return tc::launch<128, false, false>(x, wpk, bias, out, n, h, w, c, s);
}

// CUDA-core path. dtype: 0 = float32, 1 = bfloat16 (x, wt and out); bias is
// float32; wt is [ky][kx][co][ci].
extern "C" int conv3x3_fma_launch(const void* x, const void* wt, const void* bias, void* out,
                                  int n, int h, int w, int c, int dtype, int bias_relu,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (w + TW - 1) / TW;
  const dim3 grid(tiles_x * ((h + TH - 1) / TH), (c + CO_T - 1) / CO_T, n);
  const float* b = static_cast<const float*>(bias);
  using bf16 = __nv_bfloat16;
  if (dtype == 0 && bias_relu) {
    conv3x3_fma_kernel<float, true><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), b,
        static_cast<float*>(out), h, w, c, tiles_x);
  } else if (dtype == 0) {
    conv3x3_fma_kernel<float, false><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), b,
        static_cast<float*>(out), h, w, c, tiles_x);
  } else if (dtype == 1 && bias_relu) {
    conv3x3_fma_kernel<bf16, true><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wt), b,
        static_cast<bf16*>(out), h, w, c, tiles_x);
  } else if (dtype == 1) {
    conv3x3_fma_kernel<bf16, false><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wt), b,
        static_cast<bf16*>(out), h, w, c, tiles_x);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
