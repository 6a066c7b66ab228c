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
// Design: one thread per output pixel and vector of VEC channels (16 bytes
// when C allows), so neighbouring threads touch neighbouring addresses in
// both the reads and the writes. The 4 taps of an output pixel lie in two
// input rows; between neighbouring output pixels they repeat, so the reads
// mostly hit L2 and device memory sees each input byte about once. The
// index and weight tables per output row and column come from the host
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

namespace {

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

// rows_idx = [idx0 (OH), idx1 (OH)], rows_w = w1 (OH); the same for columns.
template <typename T, int VEC>
__global__ void __launch_bounds__(256) upsample2x_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const int* __restrict__ rows_idx, const float* __restrict__ rows_w,
    const int* __restrict__ cols_idx, const float* __restrict__ cols_w,
    int n, int h, int w, int c) {
  const int oh = 2 * h, ow = 2 * w, cv = c / VEC;
  const long long total = (long long)n * oh * ow * cv;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    const int v = (int)(i % cv);
    long long p = i / cv;
    const int ox = (int)(p % ow);
    p /= ow;
    const int oy = (int)(p % oh);
    const int b = (int)(p / oh);

    const int y0 = rows_idx[oy], y1 = rows_idx[oh + oy];
    const int x0 = cols_idx[ox], x1 = cols_idx[ow + ox];
    const float wy = rows_w[oy], wx = cols_w[ox];

    const long long img = (long long)b * h;
    const long long c0 = (long long)v * VEC;
    const Vec<T, VEC> a00 = *reinterpret_cast<const Vec<T, VEC>*>(x + ((img + y0) * w + x0) * c + c0);
    const Vec<T, VEC> a01 = *reinterpret_cast<const Vec<T, VEC>*>(x + ((img + y0) * w + x1) * c + c0);
    const Vec<T, VEC> a10 = *reinterpret_cast<const Vec<T, VEC>*>(x + ((img + y1) * w + x0) * c + c0);
    const Vec<T, VEC> a11 = *reinterpret_cast<const Vec<T, VEC>*>(x + ((img + y1) * w + x1) * c + c0);

    Vec<T, VEC> r;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      // Along H first, then along W: the order of the TPU kernel.
      const float left = to_f32(a00.v[k]) * (1.0f - wy) + to_f32(a10.v[k]) * wy;
      const float right = to_f32(a01.v[k]) * (1.0f - wy) + to_f32(a11.v[k]) * wy;
      r.v[k] = from_f32<T>(left * (1.0f - wx) + right * wx);
    }
    *reinterpret_cast<Vec<T, VEC>*>(out + (((long long)b * oh + oy) * ow + ox) * c + c0) = r;
  }
}

template <typename T, int VEC>
void launch(const void* x, void* out, const void* ri, const void* rw, const void* ci,
            const void* cw, int n, int h, int w, int c, cudaStream_t stream) {
  const long long total = (long long)n * 2 * h * 2 * w * (c / VEC);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  const long long cap = 132LL * 16;  // grid-stride beyond 16 blocks per SM
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  upsample2x_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), static_cast<const int*>(ri),
      static_cast<const float*>(rw), static_cast<const int*>(ci),
      static_cast<const float*>(cw), n, h, w, c);
}

template <typename T>
void dispatch(const void* x, void* out, const void* ri, const void* rw, const void* ci,
              const void* cw, int n, int h, int w, int c, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  if (aligned && c % kVec == 0) {
    launch<T, kVec>(x, out, ri, rw, ci, cw, n, h, w, c, stream);
  } else {
    launch<T, 1>(x, out, ri, rw, ci, cw, n, h, w, c, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.
extern "C" int upsample2x_launch(const void* x, void* out, const void* rows_idx,
                                 const void* rows_w, const void* cols_idx,
                                 const void* cols_w, int n, int h, int w, int c,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dispatch<float>(x, out, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, s);
  } else if (dtype == 1) {
    dispatch<__nv_bfloat16>(x, out, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
