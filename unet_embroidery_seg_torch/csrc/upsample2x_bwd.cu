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
// Design: a block owns one image, a band of `band` input rows, a strip of
// TW input columns and a chunk of CV channel vectors (VEC channels each:
// 16 bytes when C, the strides and the pointers allow), TW x CV = 256
// threads, one (input column, vector) each: CV = 8 (128 bytes of every
// pixel) over 32 columns when C is narrow, CV = 16 (256 bytes) over 16.
//  1. It streams the output rows that the band reads (at most 2 band + 2,
//     from the host's per-input first / last tables), top to bottom, each
//     cut to the strip's output columns (at most 2 TW + 2), through a ring
//     of STAGES rows in shared memory: cp.async copies, STAGES - 1 rows in
//     flight while one is reduced. So g comes from device memory once
//     (the 1-row halo of a band is read again by its neighbour, mostly
//     from L2) and never gathered from L2 tap by tap.
//  2. Column pass, per staged row: each thread sums the <= 4 output
//     columns that read its input column, weighted by the column matrix's
//     entries (the inverse taps, held in registers for the whole band).
//  3. Row pass: the column-reduced value goes, times the row matrix's two
//     entries for this output row, into the accumulators of the two input
//     rows i0, i0 + 1 it reads. i0 never falls and steps by at most one
//     from one output row to the next (checked on the host), so two
//     accumulators per thread roll down the band; when i0 moves on, the
//     row above is finished and stored at once, 16 bytes a thread,
//     neighbouring threads on neighbouring bytes of dx.
// No atomics: every dx element is summed by one thread in a fixed order, so
// the result is deterministic (F.interpolate's CUDA backward adds with
// atomics). The band height is chosen per call (launch below) against the
// card's resident blocks; x in the grid is the band, so blocks that share
// a halo row run close together.
//
// g may be a channel slice of a wider channels_last tensor (the gradient of
// torch.cat([skip, up(x)], 1) in the decoder): the kernel takes g's pixel
// stride and image stride in elements and reads the slice in place.
//
// Band mode (the mesh's space axis, ops/upsample.py): the gradient's height
// oh is a launch argument, not 2h. For a rank's band of outputs [2 r0,
// 2 r1) and its input rows with one exchanged row on each side inside the
// image, the row tables are the whole image's, taken for those outputs and
// inputs and shifted to the band's first input row: dx then holds the
// band's share of each input row's gradient, the halo rows' too, which the
// exchange's backward adds into the neighbours' rows.
//
// Tables per dimension of size S (ops/upsample.py:backward_taps), int32
// idx = [i0 (2S), first (S), last (S), inverse index (S x 4)] and float32
// wgt = [w0 (2S), w1 (2S), inverse weight (S x 4)]: per output the input
// i0 it reads first and the interpolation matrix's entries at i0 and i0 + 1
// (ops/resize.py:_interp_matrix: w1 = 0 where the output reads one input);
// per input the first and last output that reads it and its <= 4 nonzero
// entries, padded with weight 0. So the kernel multiplies by exactly the
// matrices' entries. Any H, W >= 1 and any C; f32 maths, bf16 or f32 in and
// out, round to nearest even on the store.
//
// C interface (ctypes): pointers and the stream are void*, returns
// cudaGetLastError() after the launch, or a CUDA error code for what it
// refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 4;          // ring depth in output rows
constexpr int MAX_BAND = 16;       // input rows per band, at most
constexpr int MAX_ROWS = 2 * MAX_BAND + 2;  // output rows a band reads, at most
constexpr int TAPS = 4;            // inverse taps per input column
constexpr int MANY_WAVES_BAND = 4;  // input rows per band where one wave cannot hold the grid

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

// One vector from device to shared memory: cp.async for 16 bytes (bypassing
// L1) and 4 (one f32), a plain load and store for 2 (one bf16: cp.async
// takes no 2-byte copy).
template <typename V>
__device__ __forceinline__ void copy_vec(V* dst, const V* src) {
  if constexpr (sizeof(V) == 16) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  } else if constexpr (sizeof(V) == 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int VEC, int CV>
__global__ void __launch_bounds__(THREADS) upsample2x_bwd_kernel(
    const T* __restrict__ g, T* __restrict__ dx,
    const int* __restrict__ rows_idx, const float* __restrict__ rows_w,
    const int* __restrict__ cols_idx, const float* __restrict__ cols_w,
    int h, int w, int c, int oh, int band, int strips, long long g_img, int g_pix) {
  using V = Vec<T, VEC>;
  constexpr int TW = THREADS / CV;  // input columns per strip
  constexpr int SPAN = 2 * TW + 2;  // output columns a strip reads, at most
  __shared__ V ring[STAGES][SPAN * CV];
  __shared__ int s_i0[MAX_ROWS];
  __shared__ float s_w0[MAX_ROWS], s_w1[MAX_ROWS];

  const int ow = 2 * w, cv = c / VEC;
  const int b = blockIdx.z;
  const int iy0 = blockIdx.x * band;
  const int ix0 = (blockIdx.y % strips) * TW;
  const int v0 = (blockIdx.y / strips) * CV;
  const int nr = min(band, h - iy0), nc = min(TW, w - ix0), nv = min(CV, cv - v0);
  // The output rows and columns the block reads: [first of its first
  // input, last of its last input].
  const int oy0 = rows_idx[oh + iy0];
  const int nrows = rows_idx[oh + h + iy0 + nr - 1] - oy0 + 1;
  const int ox0 = cols_idx[ow + ix0];
  const int ncols = cols_idx[ow + w + ix0 + nc - 1] - ox0 + 1;

  const int t = threadIdx.x;
  if (t < nrows) {
    s_i0[t] = rows_idx[oy0 + t];
    s_w0[t] = rows_w[oy0 + t];
    s_w1[t] = rows_w[oh + oy0 + t];
  }

  // This thread's input column q of the strip and vector v of the chunk;
  // threads past the ragged edge compute on a neighbour's taps and store
  // nothing.
  const int v = t % CV, q = t / CV;
  const bool active = q < nc && v < nv;
  int off[TAPS];
  float wx[TAPS];
  {
    const int ix = ix0 + min(q, nc - 1);
#pragma unroll
    for (int k = 0; k < TAPS; ++k) {
      wx[k] = cols_w[2 * ow + ix * TAPS + k];
      off[k] = (wx[k] != 0.0f ? cols_idx[ow + 2 * w + ix * TAPS + k] - ox0 : 0) * CV + v;
    }
  }

  // Row k of the stream (output row oy0 + k) into ring slot k % STAGES.
  const T* gb = g + static_cast<long long>(b) * g_img + static_cast<long long>(v0) * VEC +
                static_cast<long long>(ox0) * g_pix;
  auto issue = [&](int k) {
    if (k < nrows) {
      const T* src = gb + static_cast<long long>(oy0 + k) * ow * g_pix;
      V* slot = ring[k % STAGES];
      for (int e = t; e < ncols * CV; e += THREADS) {
        const int vv = e % CV, p = e / CV;
        if (vv < nv)
          copy_vec(slot + e, reinterpret_cast<const V*>(src + static_cast<long long>(p) * g_pix +
                                                       vv * VEC));
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count uniform
  };

  T* dst = dx + (static_cast<long long>(b) * h * w + ix0 + q) * c + (v0 + v) * VEC;
  auto store = [&](int r, const float (&a)[VEC]) {
    if (active && r >= iy0 && r < iy0 + nr)
      *reinterpret_cast<V*>(dst + static_cast<long long>(r) * w * c) = pack<T, VEC>(a);
  };

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) issue(k);
  __syncthreads();  // the row taps
  int rlo = s_i0[0];  // the two live input rows: rlo (lo) and rlo + 1 (hi)
  float lo[VEC], hi[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) lo[i] = hi[i] = 0.0f;

  for (int k = 0; k < nrows; ++k) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of row k have landed
    __syncthreads();              // everyone's; and slot (k - 1) % STAGES is free
    issue(k + STAGES - 1);

    // Column pass: this input column's taps in output row oy0 + k.
    const V* row = ring[k % STAGES];
    float racc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) racc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const V gv = row[off[j]];
#pragma unroll
      for (int i = 0; i < VEC; ++i) racc[i] = fmaf(wx[j], to_f32(gv.v[i]), racc[i]);
    }

    // Row pass: into input rows i0 and i0 + 1, rolling when i0 moves on.
    const int i0 = s_i0[k];
    if (i0 != rlo) {  // i0 == rlo + 1: row rlo is complete
      store(rlo, lo);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        lo[i] = hi[i];
        hi[i] = 0.0f;
      }
      rlo = i0;
    }
    const float w0 = s_w0[k], w1 = s_w1[k];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      lo[i] = fmaf(w0, racc[i], lo[i]);
      hi[i] = fmaf(w1, racc[i], hi[i]);
    }
  }
  cp_async_wait<0>();
  store(rlo, lo);
  store(rlo + 1, hi);
}

// Blocks of the kernel that the card holds at once (SMs x blocks per SM).
template <typename T, int VEC, int CV>
long long resident_blocks() {
  static long long slots = 0;  // the same on every call for one kind of card
  if (slots == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, upsample2x_bwd_kernel<T, VEC, CV>,
                                                  THREADS, 0);
    slots = static_cast<long long>(sms) * per_sm;
  }
  return slots;
}

template <typename T, int VEC, int CV>
int launch(const void* g, void* dx, const void* ri, const void* rw, const void* ci,
           const void* cw, int n, int h, int w, int c, int oh, long long g_img, int g_pix,
           cudaStream_t stream) {
  constexpr int TW = THREADS / CV;
  const int strips = (w + TW - 1) / TW;
  const int chunks = (c / VEC + CV - 1) / CV;
  // Band height: the tallest band whose grid is one wave that fills at
  // least half of the resident slots (every block starts at once, and each
  // SM keeps two or three rings in flight). Where no band does, short bands
  // in many waves, so that the last, partial wave is short; their extra
  // halo rows come mostly from L2. A grid of 1.3 or 2.6 waves was slower
  // than either on the H100.
  const long long per_band = static_cast<long long>(n) * strips * chunks;
  const long long slots = resident_blocks<T, VEC, CV>();
  int band = MANY_WAVES_BAND;
  for (int b = MAX_BAND; b >= 2; b /= 2) {
    const long long blocks = per_band * ((h + b - 1) / b);
    if (blocks <= slots && 2 * blocks >= slots) {
      band = b;
      break;
    }
  }
  const long long gy = static_cast<long long>(strips) * chunks;
  if (gy > 65535 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((h + band - 1) / band, static_cast<unsigned>(gy), n);
  upsample2x_bwd_kernel<T, VEC, CV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(g), static_cast<T*>(dx), static_cast<const int*>(ri),
      static_cast<const float*>(rw), static_cast<const int*>(ci), static_cast<const float*>(cw),
      h, w, c, oh, band, strips, g_img, g_pix);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* g, void* dx, const void* ri, const void* rw, const void* ci,
             const void* cw, int n, int h, int w, int c, int oh, long long g_img, int g_pix,
             cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = ((uintptr_t)g % 16 == 0) && ((uintptr_t)dx % 16 == 0);
  if (aligned && c % kVec == 0 && g_pix % kVec == 0 && g_img % kVec == 0) {
    if (c / kVec >= 16)
      return launch<T, kVec, 16>(g, dx, ri, rw, ci, cw, n, h, w, c, oh, g_img, g_pix, stream);
    return launch<T, kVec, 8>(g, dx, ri, rw, ci, cw, n, h, w, c, oh, g_img, g_pix, stream);
  }
  return launch<T, 1, 8>(g, dx, ri, rw, ci, cw, n, h, w, c, oh, g_img, g_pix, stream);
}

}  // namespace

// g: (n, oh, 2w, c) with pixel stride g_pix and image stride g_img
// (elements), channels contiguous, oh = 2h for a whole image; dx: (n, h, w,
// c) contiguous. dtype: 0 = float32, 1 = bfloat16 (g and dx).
extern "C" int upsample2x_bwd_launch(const void* g, void* dx, const void* rows_idx,
                                     const void* rows_w, const void* cols_idx,
                                     const void* cols_w, int n, int h, int w, int c, int oh,
                                     long long g_img, int g_pix, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_pix < c || oh < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return dispatch<float>(g, dx, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, oh, g_img,
                           g_pix, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(g, dx, rows_idx, rows_w, cols_idx, cols_w, n, h, w, c, oh,
                                   g_img, g_pix, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
