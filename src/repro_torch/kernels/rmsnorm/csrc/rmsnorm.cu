// Fused RMSNorm for Hopper (sm_90a), float32 arithmetic:
//
//   out[r, :] = (x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * scale
//   x (rows, d) float32 or bfloat16, scale (d,) float32 or bfloat16
//   -> out (rows, d) in x's type
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py::_kernel
// (launched by rms_norm_padded). It computes what that kernel computes: the
// mean over the true d, the association (x * rsqrt(var + eps)) * scale in
// f32, the result rounded once to x's type. It is not a block-by-block copy:
// the TPU kernel pads d to 128 lanes and rows to its block; here the ragged
// row is handled in place and eps is an argument (the Pallas op fixes it at
// 1e-6).
//
// Design. One warp per row, grid-stride over rows, 8 warps a block. A row is
// read twice: once for the sum of squares (f32 FMA, then a shuffle
// reduction), once to scale and write; the second read finds the row in L1
// (a 3072-wide bf16 row is 6 KB). Loads and stores of x and out are 16 bytes
// (8 bf16 or 4 f32) wherever the row allows: each row starts with a scalar
// head up to the next 16-byte boundary, then 16-byte vectors, then a scalar
// tail, so any d runs with no padding. The scale is read per element (d
// values, shared by every row, stay in L1). Template arguments cover
// x in {f32, bf16} x scale in {f32, bf16}: the model zoo norms a bf16
// residual stream with f32 scales, with no cast per call.
//
// What bounds it on an H100. Each element is read once and written once:
// rows * d * 2 * sizeof(x) bytes (plus d scales). At the zoo's decode shape
// (4 rows x 3072 bf16, 49 KB) that is 15 ns at 3.35 TB/s: the launch itself
// is the time. At 2048 x 4096 f32 (64 MiB) the bound is 20 us; arithmetic is
// 3 FLOP an element, far below the f32 peak, so memory bounds it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block: 8 rows in flight
constexpr int WARPS = NT / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, typename S>
__global__ void __launch_bounds__(NT)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                   long long rows, int d, float eps, int vec) {
  constexpr int V = 16 / sizeof(T);  // elements in a 16-byte vector
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32; r < rows; r += stride) {
    const T* xr = x + r * d;
    T* orow = out + r * d;
    // x and out start 16-byte aligned (vec), so a row starts (r * d) % V
    // elements past a boundary: head scalars, nv vectors, tail scalars
    int head = d, nv = 0;
    if (vec) {
      head = min(d, (int)((V - (r * d) % V) % V));
      nv = (d - head) / V;
    }
    const int tail = head + nv * V;
    const uint4* xv = reinterpret_cast<const uint4*>(xr + head);

    float ss = 0.f;
    for (int c = lane; c < head; c += 32) {
      const float v = to_f32(xr[c]);
      ss = fmaf(v, v, ss);
    }
    for (int i = lane; i < nv; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float v = to_f32(e[k]);
        ss = fmaf(v, v, ss);
      }
    }
    for (int c = tail + lane; c < d; c += 32) {
      const float v = to_f32(xr[c]);
      ss = fmaf(v, v, ss);
    }
    const float inv = rsqrtf(warp_sum(ss) / (float)d + eps);

    for (int c = lane; c < head; c += 32)
      orow[c] = from_f32<T>((to_f32(xr[c]) * inv) * to_f32(scale[c]));
    uint4* ov = reinterpret_cast<uint4*>(orow + head);
    for (int i = lane; i < nv; i += 32) {
      const uint4 u = xv[i];
      const T* e = reinterpret_cast<const T*>(&u);
      uint4 w;
      T* o = reinterpret_cast<T*>(&w);
      const int c0 = head + i * V;
#pragma unroll
      for (int k = 0; k < V; ++k) o[k] = from_f32<T>((to_f32(e[k]) * inv) * to_f32(scale[c0 + k]));
      ov[i] = w;
    }
    for (int c = tail + lane; c < d; c += 32)
      orow[c] = from_f32<T>((to_f32(xr[c]) * inv) * to_f32(scale[c]));
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, long long rows, int d, float eps,
           void* stream) {
  if (rows < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 16 == 0);
  const long long need = (rows + WARPS - 1) / WARPS;
  const int blocks = (int)(need < 8LL * sms ? need : 8LL * sms);
  rmsnorm_kernel<T, S><<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<T*>(out), rows, d, eps,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points, loaded with ctypes: rmsnorm_<x type>_<scale type>.
// x and out are (rows, d) contiguous device arrays, scale is (d,)
// contiguous. Returns the launch's cudaError_t; launches on `stream` and
// does not synchronize.
extern "C" int rmsnorm_f32_f32(const void* x, const void* scale, void* out, long long rows, int d,
                               float eps, void* stream) {
  return launch<float, float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_f32_bf16(const void* x, const void* scale, void* out, long long rows,
                                int d, float eps, void* stream) {
  return launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16_f32(const void* x, const void* scale, void* out, long long rows,
                                int d, float eps, void* stream) {
  return launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, stream);
}

extern "C" int rmsnorm_bf16_bf16(const void* x, const void* scale, void* out, long long rows,
                                 int d, float eps, void* stream) {
  return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d, eps, stream);
}
