// SAME, stride-1 3x3 convolution with C_in = C_out, fused bias and ReLU.
//
// Replaces: docs/negative-results/pallas_conv.py, conv3x3_same
// (pl.pallas_call over _kernel): NHWC x HWIO -> NHWC with f32 accumulation,
// one im2col GEMM per kernel row on the TPU.
//
// Bound on the H100: 2*9*C*C FLOP per output pixel against 4*C bytes of
// bf16 input and output. At the six unet_resnet50 decoder sites (480^2,
// batch 8, bf16) that is 408 GFLOP, ~412 us at the 989 TFLOP/s bf16
// tensor-core rate. The C >= 128 sites are bound by operations; at C = 64
// the bytes take about as long (the 480^2 sites: 141 us of bytes, 137 us of
// operations).
//
// Design: an implicit GEMM over (pixel, 9*C) with no im2col in memory. A
// block owns an 8 x 16 pixel tile of one image and 64 output channels and
// walks the input channels in stages: each stage puts the (8+2) x (16+2)
// halo tile of its channels, zero-filled outside the image, and their
// 3x3 x 64 weights in shared memory, then accumulates all nine taps in f32.
// The epilogue adds the bias, applies ReLU and rounds to the output type.
// Two paths share that structure:
//
//  - bf16 with C % 16 == 0 (every decoder site): tensor cores through
//    mma.sync m16n8k16 (bf16 in, f32 accumulate). A stage holds 16 input
//    channels; each of the 8 warps owns 2 tile rows x 32 output channels,
//    i.e. 2 x 4 MMA tiles. An A fragment row is one pixel of the halo tile
//    shifted by the tap, a B fragment column one output channel; both are
//    read straight from shared memory, whose pixel and channel rows are
//    padded to 48 bytes so the fragment loads hit 32 distinct banks.
//  - everything else (f32, odd C): CUDA cores. A stage holds 8 input
//    channels as f32; each thread accumulates 4 neighbouring pixels x 8
//    output channels and reuses the 6 inputs of a kernel row for 3 taps
//    (96 FMA per 30 shared-memory reads).
//
// Neither path pipelines its global loads (one stage in flight) or uses
// ldmatrix, wgmma or TMA: those are the next steps toward the bound. Any N,
// H, W and C >= 1 work; the edges are masked.
//
// Weights arrive repacked by the wrapper as [ky][kx][co][ci] in the
// activation type, so a stage's channels of one output channel are
// contiguous; the bias is f32.
//
// C interface (ctypes): pointers and the stream are void*, returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 8;          // tile rows
constexpr int TW = 16;         // tile columns
constexpr int HALO_W = TW + 2;
constexpr int HALO_PIX = (TH + 2) * HALO_W;
constexpr int CO_T = 64;       // output channels per block
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// ---- tensor-core path: bf16, C % 16 == 0 -------------------------------------

constexpr int MMA_CI = 16;     // input channels per stage (the MMA's k)
constexpr int ROW_PAD = 24;    // bf16 per pixel / per output channel in shared memory

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(THREADS) conv3x3_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int h, int w, int c,
    int tiles_x) {
  __shared__ __align__(16) __nv_bfloat16 in_s[HALO_PIX * ROW_PAD];
  __shared__ __align__(16) __nv_bfloat16 w_s[9 * CO_T * ROW_PAD];

  const int t = threadIdx.x;
  const int lane = t % 32, warp = t / 32;
  const int g = lane / 4, q = lane % 4;   // MMA fragment group and thread-in-group
  const int warp_row = (warp % 4) * 2;    // this warp's 2 tile rows
  const int warp_co = (warp / 4) * 32;    // and 32 output channels

  const int tile_y = (blockIdx.x / tiles_x) * TH;
  const int tile_x = (blockIdx.x % tiles_x) * TW;
  const int co0 = blockIdx.y * CO_T;
  const long long img = (long long)blockIdx.z * h;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;

  for (int ci0 = 0; ci0 < c; ci0 += MMA_CI) {
    __syncthreads();  // the previous stage is consumed
    for (int e = t; e < HALO_PIX * 2; e += THREADS) {  // 2 x 16 bytes per pixel
      const int pix = e / 2, half = e % 2;
      const int gy = tile_y + pix / HALO_W - 1, gx = tile_x + pix % HALO_W - 1;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (gy >= 0 && gy < h && gx >= 0 && gx < w)
        v = *reinterpret_cast<const uint4*>(x + ((img + gy) * w + gx) * c + ci0 + half * 8);
      *reinterpret_cast<uint4*>(in_s + pix * ROW_PAD + half * 8) = v;
    }
    for (int e = t; e < 9 * CO_T * 2; e += THREADS) {
      const int row = e / 2, half = e % 2;  // row = tap * CO_T + co
      const int go = co0 + row % CO_T;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (go < c)
        v = *reinterpret_cast<const uint4*>(
            wt + ((long long)(row / CO_T) * c + go) * c + ci0 + half * 8);
      *reinterpret_cast<uint4*>(w_s + row * ROW_PAD + half * 8) = v;
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A row r = tile pixel (warp_row + mt, r), read at the tap's shift.
        const __nv_bfloat16* base = in_s + ((warp_row + mt + ky) * HALO_W + kx) * ROW_PAD + q * 2;
        a[mt][0] = lds32(base + g * ROW_PAD);
        a[mt][1] = lds32(base + (g + 8) * ROW_PAD);
        a[mt][2] = lds32(base + g * ROW_PAD + 8);
        a[mt][3] = lds32(base + (g + 8) * ROW_PAD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* wb = w_s + (tap * CO_T + warp_co + nt * 8 + g) * ROW_PAD + q * 2;
        const uint32_t b0 = lds32(wb), b1 = lds32(wb + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int gy = tile_y + warp_row + mt;
    if (gy >= h) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {  // fragment rows g and g + 8
      const int gx = tile_x + g + 8 * half;
      if (gx >= w) continue;
      __nv_bfloat16* dst = out + ((img + gy) * w + gx) * c;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + warp_co + nt * 8 + q * 2;
        if (co >= c) continue;
        const float v0 = fmaxf(acc[mt][nt][2 * half] + bias[co], 0.0f);
        const float v1 = fmaxf(acc[mt][nt][2 * half + 1] + bias[co + 1], 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(dst + co) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// ---- CUDA-core path: f32, or bf16 with C % 16 != 0 ----------------------------

constexpr int CI_T = 8;        // input channels per stage
constexpr int PX = 4;          // neighbouring pixels per thread (along W)
constexpr int CO_PER = 8;      // output channels per thread, strided by 8
static_assert((TH * TW / PX) * (CO_T / CO_PER) == THREADS, "one thread per micro-tile");

template <typename T>
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
    for (int e = t; e < HALO_PIX * CI_T; e += THREADS) {
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
      if (co < c) dst[co] = from_f32<T>(fmaxf(acc[p][j] + bias[co], 0.0f));
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, wt and out); bias is float32.
extern "C" int conv3x3_bias_relu_launch(const void* x, const void* wt, const void* bias,
                                        void* out, int n, int h, int w, int c, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles_x = (w + TW - 1) / TW;
  const dim3 grid(tiles_x * ((h + TH - 1) / TH), (c + CO_T - 1) / CO_T, n);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0) {
    conv3x3_fma_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(wt), b,
        static_cast<float*>(out), h, w, c, tiles_x);
  } else if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const bool aligned = (uintptr_t)x % 16 == 0 && (uintptr_t)wt % 16 == 0 &&
                         (uintptr_t)out % 4 == 0;
    if (c % MMA_CI == 0 && aligned) {
      conv3x3_mma_kernel<<<grid, THREADS, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wt), b,
          static_cast<bf16*>(out), h, w, c, tiles_x);
    } else {
      conv3x3_fma_kernel<bf16><<<grid, THREADS, 0, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wt), b,
          static_cast<bf16*>(out), h, w, c, tiles_x);
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
