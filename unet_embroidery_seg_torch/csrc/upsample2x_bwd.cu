// Backward of the exact 2x bilinear upsample: dx from the output's gradient.
//
// Replaces: docs/negative-results/pallas_upsample.py, the custom VJP of
// upsample2x_pallas (_bwd): the transposed interpolation-matrix
// contraction dx = Mh^T g Mw, with Mh (2H x H) and Mw (2W x W) the
// forward's row and column interpolation matrices.
//
// Bound on the H100: bytes. It reads the gradient g (4x the size of dx)
// once and writes dx once, ~2 FLOP per byte; at the unet_resnet50 sites
// (512^2, batch 8, bf16) the least time is (|g| + |dx|) / 3.35 TB/s.
//
// Design: gather, not scatter. One thread owns one input pixel and VEC
// channels (16 bytes when C, the strides and the pointers allow) and sums
// its own output taps: for each output row that reads its input row (at
// most a handful, from the host's inverse tables) the weighted sum over the
// output columns that read its input column. No atomics, so the result is
// deterministic (F.interpolate's CUDA backward adds with atomics). Each
// output tap is read by the ~4 input pixels that feed it, from L2; a
// staged version, like the forward's, is later work.
//
// g may be a channel slice of a wider channels_last tensor (the gradient of
// torch.cat([skip, up(x)], 1) in the decoder): the kernel takes g's pixel
// stride and image stride in elements and reads the slice in place.
//
// The inverse tables (ops/upsample.py:_inverse_tables) list, for each input
// row (column), the output rows (columns) whose interpolation reads it and
// the weight, which is the entry of the forward's interpolation matrix
// (ops/resize.py:_interp_matrix, float64 maths in float32), padded with
// weight-0 entries to K per input. Any H, W >= 1 and any C; f32 maths, bf16
// or f32 in and out, round to nearest even on the store.
//
// C interface (ctypes): pointers and the stream are void*, returns
// cudaGetLastError() after the launch, or a CUDA error code for what it
// refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

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

// rows_idx / rows_w: [h][kr] output rows and weights per input row; cols: [w][kc].
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS) upsample2x_bwd_kernel(
    const T* __restrict__ g, T* __restrict__ dx,
    const int* __restrict__ rows_idx, const float* __restrict__ rows_w,
    const int* __restrict__ cols_idx, const float* __restrict__ cols_w,
    int h, int w, int c, int kr, int kc, long long g_img, int g_pix, int total) {
  using V = Vec<T, VEC>;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= total) return;
  const int cv = c / VEC;
  const int v = e % cv;
  int p = e / cv;
  const int ix = p % w;
  p /= w;
  const int iy = p % h, b = p / h;
  const int ow = 2 * w;
  const T* gb = g + static_cast<long long>(b) * g_img + v * VEC;

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.0f;
  for (int a = 0; a < kr; ++a) {
    const float wy = __ldg(rows_w + iy * kr + a);
    if (wy == 0.0f) continue;  // padding of the table
    const int oy = __ldg(rows_idx + iy * kr + a);
    float racc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) racc[i] = 0.0f;
    for (int q = 0; q < kc; ++q) {
      const float wx = __ldg(cols_w + ix * kc + q);
      if (wx == 0.0f) continue;
      const int ox = __ldg(cols_idx + ix * kc + q);
      const V gv = *reinterpret_cast<const V*>(
          gb + (static_cast<long long>(oy) * ow + ox) * g_pix);
#pragma unroll
      for (int i = 0; i < VEC; ++i) racc[i] = fmaf(wx, to_f32(gv.v[i]), racc[i]);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = fmaf(wy, racc[i], acc[i]);
  }
  V o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<T>(acc[i]);
  reinterpret_cast<V*>(dx)[e] = o;
}

template <typename T, int VEC>
int launch(const void* g, void* dx, const void* ri, const void* rw, const void* ci,
           const void* cw, int n, int h, int w, int c, int kr, int kc, long long g_img,
           int g_pix, cudaStream_t stream) {
  const long long total = static_cast<long long>(n) * h * w * (c / VEC);
  if (total > 0x7fffffffLL - THREADS) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((total + THREADS - 1) / THREADS);
  upsample2x_bwd_kernel<T, VEC><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<const int*>(ri),
      static_cast<const float*>(rw), static_cast<const int*>(ci), static_cast<const float*>(cw),
      h, w, c, kr, kc, g_img, g_pix, static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* g, void* dx, const void* ri, const void* rw, const void* ci,
             const void* cw, int n, int h, int w, int c, int kr, int kc, long long g_img,
             int g_pix, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)g % 16 == 0) && ((uintptr_t)dx % 16 == 0);
  if (aligned && c % kVec == 0 && g_pix % kVec == 0 && g_img % kVec == 0)
    return launch<T, kVec>(g, dx, ri, rw, ci, cw, n, h, w, c, kr, kc, g_img, g_pix, stream);
  return launch<T, 1>(g, dx, ri, rw, ci, cw, n, h, w, c, kr, kc, g_img, g_pix, stream);
}

}  // namespace

// g: (n, 2h, 2w, c) with pixel stride g_pix and image stride g_img (elements),
// channels contiguous; dx: (n, h, w, c) contiguous. dtype: 0 = float32,
// 1 = bfloat16 (g and dx).
extern "C" int upsample2x_bwd_launch(const void* g, void* dx, const void* rows_idx,
                                     const void* rows_w, const void* cols_idx,
                                     const void* cols_w, int n, int h, int w, int c, int kr,
                                     int kc, long long g_img, int g_pix, int dtype,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_pix < c) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(g, dx, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, kr, kc, g_img,
                           g_pix, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(g, dx, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, kr, kc,
                                   g_img, g_pix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
