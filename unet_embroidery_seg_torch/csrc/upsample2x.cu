// Exact 2x bilinear upsample of an NHWC (channels_last NCHW) tensor.
//
// Replaces: docs/negative-results/pallas_upsample.py, upsample2x_pallas
// (_forward -> pl.pallas_call, _kernel): per-parity shifted adds on an
// edge-padded input, f32 maths, both torch conventions.
//
// Bound on the H100: bytes. Each output element reads 4 input taps and
// does 3 lerps, so the work is ~0 FLOP/byte; the least time is
// (input bytes + output bytes) / 3.35 TB/s. At the unet_resnet50 sites
// (480^2, batch 8, bf16) that is ~176 us per forward, most of it the
// 64-channel 240^2 -> 480^2 site.
//
// Design: a block owns one image, a tile of TH x TW output pixels and a
// chunk of CV channel vectors (VEC channels each: 16 bytes when C and the
// pointers allow). TH x TW x CV = 2048 vectors, 8 per thread: CV = 8 (128
// bytes of every pixel) over 8 x 32 pixels when C is narrow, CV = 16 (256
// bytes) over 8 x 16 pixels when there are at least 16 vectors (C >= 128
// in bf16).
//  1. It copies the input pixels the tile needs, at most (TH/2+2) x
//     (TW/2+2) of them (found from the row and column tables), and the
//     tile's table entries into shared memory once. L2 then sees each input
//     byte about once per block, where reading the 4 taps of every output
//     from L2 read it ~4x per output.
//  2. Every thread computes output vectors of the tile from shared memory,
//     two horizontal neighbours at a time (they share a lerped input
//     column), and stores them 16 bytes a thread; CV neighbouring threads
//     write the contiguous bytes of one pixel's chunk.
// A 3-D grid (column tile x channel chunk, row tile, image) and 32-bit
// index maths; no 64-bit division anywhere. In bf16 the unpacking and
// lerps, not device memory, held the kernel back (the f32 kernel, with
// twice the bytes per element, reached a larger share of the bound), hence
// the shared column lerps and paired bf16 rounding. Taller or flatter
// tiles, 512-byte chunks, streaming stores and a persistent
// double-buffered (cp.async) variant were no faster on the H100.
//
// Band mode (the mesh's space axis, ops/upsample.py): the output height oh
// is a launch argument, not 2h. A rank holding input rows [r0, r1) of an
// image, plus one exchanged row on each side inside the image, makes output
// rows [2 r0, 2 r1): the row tables are the whole image's rows for those
// outputs, shifted to the band's first input row, so the band's outputs are
// the unsplit kernel's bit for bit. The whole image is oh = 2h.
//
// The index and weight tables per output row and column come from the host
// (ops/resize.py:_linear_coords, float64 maths), so the weights equal the
// JAX ones bit for bit and any H, W >= 1 and any C work; the TPU kernel's
// C % 128 and row-tiling limits do not apply. Maths in f32, bf16 or f32 in
// and out, round to nearest even on the store.
//
// C interface (ctypes): pointers and the stream are void*, returns
// cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TH = 8;                           // output rows per tile
constexpr int THREADS = 256;
constexpr int TILE_VECS = THREADS * 8;         // output vectors per block, 8 per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// f32 values to a vector of T, rounding to nearest even (bf16 in pairs).
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> pack(const float (&f)[VEC]) {
  Vec<T, VEC> o;
  if constexpr (std::is_same<T, __nv_bfloat16>::value && VEC % 2 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(&o.v[i]) = __floats2bfloat162_rn(f[i], f[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(f[i]);
  }
  return o;
}

// rows_idx = [idx0 (OH), idx1 (OH)], rows_w = w1 (OH); the same for columns.
// Both index tables are non-decreasing, so the tile's input rows are
// [idx0[first row], idx1[last row]], at most IN_H of them for a 2x resize
// (checked on the host, ops/upsample.py); the same for columns.
template <typename T, int VEC, int CV>
__global__ void __launch_bounds__(THREADS) upsample2x_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const int* __restrict__ rows_idx, const float* __restrict__ rows_w,
    const int* __restrict__ cols_idx, const float* __restrict__ cols_w,
    int h, int w, int c, int col_tiles, int oh) {
  using V = Vec<T, VEC>;
  constexpr int TW = TILE_VECS / (TH * CV);     // output columns per tile
  constexpr int IN_H = TH / 2 + 2, IN_W = TW / 2 + 2;
  __shared__ V tile[IN_H * IN_W * CV];
  __shared__ int r_off[TH][2], c_off[TW][2];  // tap row / column in the tile
  __shared__ float r_w[TH], c_w[TW];

  const int ow = 2 * w, cv = c / VEC;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH;
  const int ox0 = (blockIdx.x % col_tiles) * TW;
  const int v0 = (blockIdx.x / col_tiles) * CV;
  const int nv = min(CV, cv - v0);
  const int nr = min(TH, oh - oy0), nc = min(TW, ow - ox0);
  const int ry0 = rows_idx[oy0], rh = rows_idx[oh + oy0 + nr - 1] - ry0 + 1;
  const int rx0 = cols_idx[ox0], rw = cols_idx[ow + ox0 + nc - 1] - rx0 + 1;

  const int t = threadIdx.x;
  if (t < nr) {
    r_off[t][0] = rows_idx[oy0 + t] - ry0;
    r_off[t][1] = rows_idx[oh + oy0 + t] - ry0;
    r_w[t] = rows_w[oy0 + t];
  } else if (t >= 64 && t < 64 + nc) {
    const int q = t - 64;
    c_off[q][0] = cols_idx[ox0 + q] - rx0;
    c_off[q][1] = cols_idx[ow + ox0 + q] - rx0;
    c_w[q] = cols_w[ox0 + q];
  }

  // 1. Stage the input pixels: rh x rw pixels x nv vectors.
  const V* src = reinterpret_cast<const V*>(x) + v0;
  const int in_vec = rh * rw * CV;
#pragma unroll
  for (int k = 0; k < (IN_H * IN_W * CV + THREADS - 1) / THREADS; ++k) {
    const int e = t + k * THREADS;
    if (e < in_vec) {
      const int v = e % CV, p = e / CV;
      const int r = p / rw, q = p - r * rw;
      if (v < nv) {
        const size_t pix = (static_cast<size_t>(b) * h + ry0 + r) * w + rx0 + q;
        tile[p * CV + v] = src[pix * cv + v];
      }
    }
  }
  __syncthreads();

  // 2. The tile's outputs from shared memory, two horizontal neighbours
  // (q, q+1) per thread: 2W is even, so tiles hold whole pairs. For a 2x
  // resize the pair reads three input columns A = c_off[q][0], B =
  // c_off[q][1], C = c_off[q+1][1], and q+1's left column is A or B (its
  // source coordinate is less than one column further on). Each column is
  // lerped along H once; q+1 then weighs (A, B, C) by (1-wx, wx, 0) or
  // (0, 1-wx, wx), which equals lerping its own two columns exactly.
  constexpr int PAIRS = TW / 2;
  V* dst = reinterpret_cast<V*>(out) + v0;
#pragma unroll
  for (int k = 0; k < TH * PAIRS * CV / THREADS; ++k) {
    const int e = t + k * THREADS;
    const int v = e % CV, pp = e / CV;
    const int r = pp / PAIRS, q = (pp % PAIRS) * 2;
    if (r >= nr || q >= nc || v >= nv) continue;
    const int ca = c_off[q][0], cb = c_off[q][1], cc = c_off[q + 1][1];
    const bool from_b = c_off[q + 1][0] != ca;
    const V* row0 = tile + r_off[r][0] * rw * CV + v;
    const V* row1 = tile + r_off[r][1] * rw * CV + v;
    const V a0 = row0[ca * CV], a1 = row1[ca * CV];
    const V b0 = row0[cb * CV], b1 = row1[cb * CV];
    const V c0 = row0[cc * CV], c1 = row1[cc * CV];
    const float wy = r_w[r], wx = c_w[q], wx1 = c_w[q + 1];
    const float ga = from_b ? 0.0f : 1.0f - wx1, gb = from_b ? 1.0f - wx1 : wx1;
    const float gc = from_b ? wx1 : 0.0f;
    float o0[VEC], o1[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      // Along H first, then along W: the order of the TPU kernel.
      const float ha = to_f32(a0.v[i]) * (1.0f - wy) + to_f32(a1.v[i]) * wy;
      const float hb = to_f32(b0.v[i]) * (1.0f - wy) + to_f32(b1.v[i]) * wy;
      const float hc = to_f32(c0.v[i]) * (1.0f - wy) + to_f32(c1.v[i]) * wy;
      o0[i] = ha * (1.0f - wx) + hb * wx;
      o1[i] = ha * ga + hb * gb + hc * gc;
    }
    const size_t opix = (static_cast<size_t>(b) * oh + oy0 + r) * ow + ox0 + q;
    dst[opix * cv + v] = pack<T, VEC>(o0);
    dst[(opix + 1) * cv + v] = pack<T, VEC>(o1);
  }
}

template <typename T, int VEC, int CV>
int launch(const void* x, void* out, const void* ri, const void* rw, const void* ci,
           const void* cw, int n, int h, int w, int c, int oh, cudaStream_t stream) {
  constexpr int TW = TILE_VECS / (TH * CV);
  const int col_tiles = (2 * w + TW - 1) / TW;
  const int chunks = (c / VEC + CV - 1) / CV;
  const long long gx = static_cast<long long>(col_tiles) * chunks;
  const int gy = (oh + TH - 1) / TH;
  if (gx > 0x7fffffff || gy > 65535 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(gx), gy, n);
  upsample2x_kernel<T, VEC, CV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(ri),
      static_cast<const float*>(rw), static_cast<const int*>(ci),
      static_cast<const float*>(cw), h, w, c, col_tiles, oh);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, void* out, const void* ri, const void* rw, const void* ci,
             const void* cw, int n, int h, int w, int c, int oh, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && c % kVec == 0) {
    if (c / kVec >= 16) return launch<T, kVec, 16>(x, out, ri, rw, ci, cw, n, h, w, c, oh, stream);
    return launch<T, kVec, 8>(x, out, ri, rw, ci, cw, n, h, w, c, oh, stream);
  }
  return launch<T, 1, 8>(x, out, ri, rw, ci, cw, n, h, w, c, oh, stream);
}

}  // namespace

// x: (n, h, w, c); out: (n, oh, 2w, c), oh output rows (2h for a whole
// image); the row tables have oh entries each. dtype: 0 = float32, 1 = bfloat16.
extern "C" int upsample2x_launch(const void* x, void* out, const void* rows_idx,
                                 const void* rows_w, const void* cols_idx,
                                 const void* cols_w, int n, int h, int w, int c, int oh,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (oh < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(x, out, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, oh, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, out, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, oh, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
