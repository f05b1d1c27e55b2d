// Fused RMSNorm for Hopper (sm_90a), float32 arithmetic:
//
//   out[r, :] = (x[r, :] * rsqrt(sum(x[r, :]^2) / d + eps)) * scale
//   x (rows, d) float32 or bfloat16, scale (d,) float32 or bfloat16
//   -> out (rows, d) in x's type
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py::_kernel
// (launched by rms_norm_padded). It computes what that kernel computes: the
// mean over the true d, the association (x * rsqrt(var + eps)) * scale in
// f32, the result rounded once to x's type. It is not a block-by-block copy:
// the TPU kernel pads d to 128 lanes and rows to its block; here the ragged
// row is handled in place and eps is an argument (the Pallas op fixes it at
// 1e-6). Template arguments cover x in {f32, bf16} x scale in {f32, bf16}:
// the model zoo norms a bf16 residual stream with f32 scales, with no cast.
//
// What bounds it on an H100. Each element is read once and written once:
// rows * d * 2 * sizeof(x) bytes plus d scales; 3 FLOP an element is far
// below the f32 peak, so memory bounds it. At the zoo's decode step (4 rows
// x 3072 bf16, 49 KB) that is 15 ns at 3.35 TB/s, so the time is the
// launch's fixed cost and the latency of one dependent chain: read the row,
// reduce, write. At 2048 x 4096 f32 (64 MiB) the bound is 20 us. On the
// host, each call costs an enqueue that the caller pays 65 times a decode
// step; the wrapper keeps it short (kernels/rmsnorm/ops.py).
//
// Design, against what the first version (one warp per row, 8 warps a
// block) lost:
// - The row stays in registers: each thread loads its 16-byte vectors of x
//   once, sums their squares, and after the reduction scales and writes the
//   same registers. The first version read each row twice (the second time
//   from L1) and walked 12 vectors a lane in each pass.
// - A grid that fills the card at 4 rows: with few rows each row gets a
//   block of ceil(d / V) threads (V elements in 16 bytes), one vector a
//   thread: 4 blocks of 384 threads on 4 SMs at the decode step, where the
//   first version ran 4 warps in one block on one SM. With many rows a row
//   gets two vectors a thread, and narrow rows share a block. The shape
//   comes from the caller (kernels/rmsnorm/ops.py::launch_shape), built
//   once per input shape and passed by pointer; this entry checks that the
//   row fits the registers it is given. The first version asked the device
//   for its SM count on every call; this one only reads which device is
//   current.
// - The reduction is a warp shuffle, one shared-memory stage of at most 32
//   partial sums and one __syncthreads; the partials are double-buffered so
//   a block that strides over several rows needs no second barrier.
// - The scale is read as 16-byte vectors (8 bytes for 4 bf16 values) and
//   converted to f32 once per vector, before the reduction so its latency
//   hides behind x's; the first version read it one scalar an element.
// - Ragged rows in place: slot k of a row covers elements
//   [k * V - a, k * V - a + V), where a is the row's offset past a 16-byte
//   boundary. A slot wholly inside the row is one 16-byte access; the
//   row's first and last slots, when cut, go element by element. Rows that
//   start off the grid (odd d, offset views) need no padding, and when out
//   and x sit differently against the grid the stores go element by
//   element.
// - A row wider than four vectors a thread of a 1024-thread block (d past
//   16384 f32 or 32768 bf16) is walked in a loop inside the block and read
//   twice, once to sum and once to write.
//
// The backward (rmsnorm_bwd_*) replaces no TPU kernel: the Pallas op has no
// backward, and the reference trains through its jnp norm. The port routes
// every zoo norm through the forward kernel, so a train step on the card
// needs the norm's gradient on the card:
//
//   r = rsqrt(mean(x[r, :]^2) + eps)
//   dx[r, :] = r * (scale * dy[r, :]) - x[r, :] * r^3 * mean(x[r, :] * scale * dy[r, :])
//   dscale   = sum over rows of dy * x * r
//
// in f32, dx rounded once to x's type and dscale to scale's. It reads x and
// dy and writes dx (plus d scales in, d out), 3 FLOP-ish per element a
// pass: memory bounds it, 6.3 MB (1.9 us at 3.35 TB/s) at mamba2-370m's
// 1024 x 1024 bf16 rows. Design, simple first:
// - r is recomputed from x (the forward saves nothing, so its serving path
//   and times are unchanged). A block walks rows with a stride of the
//   grid; per row, one pass sums x^2 and x * scale * dy (two block
//   reductions in one barrier), a second pass writes dx (the row's second
//   read comes from L1 / L2).
// - dscale is summed deterministically, without atomics: each block adds
//   its rows' dy * x * r into a d-float accumulator in shared memory (a
//   column belongs to one thread, so no two threads touch one entry),
//   writes it as its row of an f32 (blocks, d) scratch the wrapper
//   allocates, and a second kernel sums the scratch's column in block
//   order. Two runs of a step give the same bits.
// ptxas -v output for every instantiation sits beside the library in
// build/kernels/rmsnorm-*.log.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One launch's shape, built once per input shape by the wrapper
// (kernels/rmsnorm/ops.py::Plan) and passed by pointer, so a ctypes call
// converts five pointers and no per-call scalars (each converted argument
// costs the host about as much as the launch's own checks).
struct RmsnormPlan {
  long long rows;
  int d;
  float eps;
  int threads;         // a multiple of 32, at most 1024
  int rows_per_block;  // divides threads into whole warps per row
  int blocks;
  int vpt;     // 16-byte vectors a thread holds (1, 2 or 4), or 0 to loop
  int device;  // the inputs' device, made current for the launch if it is not
};

// The backward's launch, built once per input shape by the wrapper
// (kernels/rmsnorm/ops.py::BackwardPlan).
struct RmsnormBwdPlan {
  long long rows;
  int d;
  float eps;
  int threads;  // a multiple of 32, at most 1024
  int blocks;   // the row pass's grid: rows of the (blocks, d) f32 scratch
  int device;
};

namespace {

constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;

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

// The slot of a row whose first element is c0 (< 0 when the slot starts
// before the row): one 16-byte load when it lies wholly in [0, d), else
// element by element with zeros outside the row.
template <typename T>
__device__ __forceinline__ uint4 load_slot(const T* __restrict__ row, int c0, int d) {
  constexpr int V = 16 / sizeof(T);
  if (c0 >= 0 && c0 + V <= d) return *reinterpret_cast<const uint4*>(row + c0);
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i >= 0 && c0 + i < d) e[i] = row[c0 + i];
  return u;
}

template <typename T>
__device__ __forceinline__ void store_slot(T* __restrict__ row, int c0, int d, bool vec,
                                           const uint4& w) {
  constexpr int V = 16 / sizeof(T);
  if (vec && c0 >= 0 && c0 + V <= d) {
    *reinterpret_cast<uint4*>(row + c0) = w;
    return;
  }
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i >= 0 && c0 + i < d) row[c0 + i] = e[i];
}

// Element i of 32-bit words holding f32 or packed bf16 values, in f32. The
// bits are shifted out of the words rather than read through a pointer, so
// the words stay in registers.
template <typename S, int N>
__device__ __forceinline__ float word_elem(const unsigned (&w)[N], int i) {
  if constexpr (sizeof(S) == 4) {
    return __uint_as_float(w[i]);
  } else {
    return __uint_as_float((i & 1) ? (w[i >> 1] & 0xffff0000u) : (w[i >> 1] << 16));
  }
}

// The scales of elements [c0, c0 + V) in f32: V * sizeof(S) bytes (8, 16 or
// 32) as 8- or 16-byte loads when `vec` (the row's slots line up with the
// scale's own alignment) and the slot lies in the row, else one at a time.
template <typename S, int V>
__device__ __forceinline__ void load_scale(float (&sf)[V], const S* __restrict__ scale, int c0,
                                           int d, bool vec) {
  constexpr int WORDS = V * (int)sizeof(S) / 4;
  if (vec && c0 >= 0 && c0 + V <= d) {
    unsigned w[WORDS];
    if constexpr (WORDS == 2) {
      const uint2 u = *reinterpret_cast<const uint2*>(scale + c0);
      w[0] = u.x;
      w[1] = u.y;
    } else {
#pragma unroll
      for (int q = 0; q < WORDS / 4; ++q) {
        const uint4 u = *reinterpret_cast<const uint4*>(scale + c0 + q * (16 / (int)sizeof(S)));
        w[4 * q] = u.x;
        w[4 * q + 1] = u.y;
        w[4 * q + 2] = u.z;
        w[4 * q + 3] = u.w;
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) sf[i] = word_elem<S>(w, i);
    return;
  }
#pragma unroll
  for (int i = 0; i < V; ++i) sf[i] = (c0 + i >= 0 && c0 + i < d) ? to_f32(scale[c0 + i]) : 0.f;
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& u, float ss) {
  constexpr int V = 16 / sizeof(T);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float v = to_f32(e[i]);
    ss = fmaf(v, v, ss);
  }
  return ss;
}

template <typename T, int V>
__device__ __forceinline__ uint4 normed(const uint4& u, float inv, const float (&sf)[V]) {
  const T* e = reinterpret_cast<const T*>(&u);
  uint4 w;
  T* o = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = from_f32<T>((to_f32(e[i]) * inv) * sf[i]);
  return w;
}

// VPT: 16-byte slots a thread holds in registers (1, 2 or 4); 0 walks the
// row in a loop and reads it twice. Each group of blockDim.x / rows_per_block
// threads (whole warps) norms one row; the block strides over rows.
template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale, T* __restrict__ out,
                   long long rows, int d, float eps, int rows_per_block) {
  constexpr int V = 16 / sizeof(T);
  constexpr int SCALE_ALIGN = V * sizeof(S) < 16 ? V * sizeof(S) : 16;
  // hold the scales in registers from before the reduction; at four slots
  // they would cost more registers than a 1024-thread block has
  constexpr bool PREFETCH = VPT == 1 || VPT == 2;
  __shared__ float partial[2][MAX_WARPS];

  const int tpr = blockDim.x / rows_per_block;  // threads per row
  const int group = threadIdx.x / tpr, t = threadIdx.x - group * tpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first_warp = group * (tpr >> 5), row_warps = tpr >> 5;
  const long long step = (long long)gridDim.x * rows_per_block;
  int buf = 0;
  for (long long base = (long long)blockIdx.x * rows_per_block; base < rows; base += step) {
    const long long r = base + group;
    const bool live = r < rows;
    const T* xr = x + (live ? r : 0) * d;
    T* orow = out + (live ? r : 0) * d;
    const int a = (int)((reinterpret_cast<uintptr_t>(xr) % 16) / sizeof(T));
    const int slots = (a + d + V - 1) / V;
    const bool vec_out =
        reinterpret_cast<uintptr_t>(orow) % 16 == reinterpret_cast<uintptr_t>(xr) % 16;
    const bool vec_s =
        (reinterpret_cast<uintptr_t>(scale) - (uintptr_t)a * sizeof(S)) % SCALE_ALIGN == 0;

    float ss = 0.f;
    uint4 xv[VPT > 0 ? VPT : 1];
    float sv[PREFETCH ? VPT : 1][V];
    if constexpr (VPT > 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int k = t + j * tpr;
        xv[j] = make_uint4(0u, 0u, 0u, 0u);
        if (live && k < slots) {
          xv[j] = load_slot(xr, k * V - a, d);
          if constexpr (PREFETCH) load_scale(sv[j], scale, k * V - a, d, vec_s);
        }
      }
#pragma unroll
      for (int j = 0; j < VPT; ++j) ss = sum_squares<T>(xv[j], ss);
    } else {
      if (live)
        for (int k = t; k < slots; k += tpr) ss = sum_squares<T>(load_slot(xr, k * V - a, d), ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) partial[buf][warp] = ss;
    __syncthreads();
    float total = lane < row_warps ? partial[buf][first_warp + lane] : 0.f;
    total = warp_sum(total);
    buf ^= 1;  // the next row's partials go to the other buffer: no second barrier
    if (!live) continue;
    const float inv = rsqrtf(total / (float)d + eps);

    if constexpr (VPT > 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int k = t + j * tpr;
        if (k >= slots) continue;
        if constexpr (PREFETCH) {
          store_slot(orow, k * V - a, d, vec_out, normed<T>(xv[j], inv, sv[j]));
        } else {
          float sf[V];
          load_scale(sf, scale, k * V - a, d, vec_s);
          store_slot(orow, k * V - a, d, vec_out, normed<T>(xv[j], inv, sf));
        }
      }
    } else {
      for (int k = t; k < slots; k += tpr) {
        float sf[V];
        load_scale(sf, scale, k * V - a, d, vec_s);
        store_slot(orow, k * V - a, d, vec_out, normed<T>(load_slot(xr, k * V - a, d), inv, sf));
      }
    }
  }
}

template <typename T, typename S>
int launch(const void* x, const void* scale, void* out, const RmsnormPlan* plan, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = plan->rows;
  const int d = plan->d, threads = plan->threads, rows_per_block = plan->rows_per_block;
  const int blocks = plan->blocks, vpt = plan->vpt;
  const float eps = plan->eps;
  if (rows < 0 || d < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      rows_per_block < 1 || threads % rows_per_block != 0 ||
      (threads / rows_per_block) % 32 != 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  // the registers promised must hold the row: a row spans ceil((a + d) / V)
  // slots, a < V its offset past a 16-byte boundary (0 for every row when x
  // is aligned and V divides d)
  const long long tpr = threads / rows_per_block;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 && d % V == 0;
  const long long span = ((long long)d + (aligned ? 0 : V - 1) + V - 1) / V;
  if ((vpt != 0 && vpt != 1 && vpt != 2 && vpt != 4) || (vpt != 0 && tpr * vpt < span))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != plan->device) e = cudaSetDevice(plan->device);
  if (e != cudaSuccess) return (int)e;
  const auto st = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const S* s = static_cast<const S*>(scale);
  T* o = static_cast<T*>(out);
  if (vpt == 0)
    rmsnorm_kernel<T, S, 0><<<blocks, threads, 0, st>>>(xt, s, o, rows, d, eps, rows_per_block);
  else if (vpt == 1)
    rmsnorm_kernel<T, S, 1><<<blocks, threads, 0, st>>>(xt, s, o, rows, d, eps, rows_per_block);
  else if (vpt == 2)
    rmsnorm_kernel<T, S, 2><<<blocks, threads, 0, st>>>(xt, s, o, rows, d, eps, rows_per_block);
  else
    rmsnorm_kernel<T, S, 4><<<blocks, threads, 0, st>>>(xt, s, o, rows, d, eps, rows_per_block);
  e = cudaGetLastError();
  if (current != plan->device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}

// The backward's row pass: each block walks rows blockIdx.x, blockIdx.x +
// gridDim.x, ...; thread t owns columns t, t + blockDim.x, ... of every row
// and of the block's dscale accumulator (dynamic shared memory, d floats).
template <typename T, typename S>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, long long rows, int d, float eps) {
  extern __shared__ float acc[];
  __shared__ float red[2][2][MAX_WARPS];  // BWD_STATIC_SMEM bytes
  const int tpb = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = tpb >> 5;
  for (int c = threadIdx.x; c < d; c += tpb) acc[c] = 0.f;
  int buf = 0;
  for (long long r = blockIdx.x; r < rows; r += gridDim.x) {
    const T* xr = x + r * d;
    const T* gr = dy + r * d;
    float ss = 0.f, dot = 0.f;
    for (int c = threadIdx.x; c < d; c += tpb) {
      const float xv = to_f32(xr[c]);
      ss = fmaf(xv, xv, ss);
      dot = fmaf(xv, to_f32(scale[c]) * to_f32(gr[c]), dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (lane == 0) {
      red[buf][0][warp] = ss;
      red[buf][1][warp] = dot;
    }
    __syncthreads();
    ss = lane < warps ? red[buf][0][lane] : 0.f;
    dot = lane < warps ? red[buf][1][lane] : 0.f;
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    buf ^= 1;  // the next row's sums go to the other buffer: no second barrier
    const float inv = rsqrtf(ss / (float)d + eps);
    const float k = inv * inv * inv * (dot / (float)d);
    T* dxr = dx + r * d;
    for (int c = threadIdx.x; c < d; c += tpb) {
      const float xv = to_f32(xr[c]), g = to_f32(gr[c]);
      dxr[c] = from_f32<T>(inv * (to_f32(scale[c]) * g) - xv * k);
      acc[c] = fmaf(g * xv, inv, acc[c]);
    }
  }
  float* prow = partial + (long long)blockIdx.x * d;
  for (int c = threadIdx.x; c < d; c += tpb) prow[c] = acc[c];
}

// dscale[c] = sum over b of partial[b, c], in block order.
template <typename S>
__global__ void rmsnorm_bwd_scale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                                         int blocks, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += partial[(long long)b * d + c];
  dscale[c] = from_f32<S>(s);
}

constexpr int BWD_SCALE_THREADS = 256;
constexpr int MAX_SMEM = 227 * 1024;
// the row pass's static shared memory (red), beside the dynamic accumulator
constexpr int BWD_STATIC_SMEM = 2 * 2 * MAX_WARPS * (int)sizeof(float);

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, const RmsnormBwdPlan* plan, void* stream) {
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = plan->rows;
  const int d = plan->d, threads = plan->threads, blocks = plan->blocks;
  const size_t smem = (size_t)d * sizeof(float);
  if (rows < 1 || d < 1 || threads < 32 || threads > MAX_THREADS || threads % 32 != 0 ||
      blocks < 1 || (long long)blocks > rows || smem > (size_t)(MAX_SMEM - BWD_STATIC_SMEM))
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != plan->device) e = cudaSetDevice(plan->device);
  if (e != cudaSuccess) return (int)e;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(rmsnorm_bwd_rows_kernel<T, S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) {
    const auto st = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);
    rmsnorm_bwd_rows_kernel<T, S><<<blocks, threads, smem, st>>>(
        static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
        static_cast<T*>(dx), part, rows, d, plan->eps);
    e = cudaGetLastError();
    if (e == cudaSuccess) {
      rmsnorm_bwd_scale_kernel<S><<<(d + BWD_SCALE_THREADS - 1) / BWD_SCALE_THREADS,
                                    BWD_SCALE_THREADS, 0, st>>>(part, static_cast<S*>(dscale),
                                                                blocks, d);
      e = cudaGetLastError();
    }
  }
  if (current != plan->device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}

}  // namespace

// Plain C entry points, loaded with ctypes: rmsnorm_<x type>_<scale type>.
// x and out are (plan->rows, plan->d) contiguous device arrays, scale is
// (d,) contiguous. The plan's shape is checked (whole warps a row, at most
// 1024 threads, vpt against the row's span) on every call. Returns the
// launch's cudaError_t; launches on `stream` and does not synchronize.
#define RMSNORM_ENTRY(NAME, T, S)                                                             \
  extern "C" int NAME(const void* x, const void* scale, void* out, const RmsnormPlan* plan, \
                      void* stream) {                                                         \
    return launch<T, S>(x, scale, out, plan, stream);                                         \
  }

RMSNORM_ENTRY(rmsnorm_f32_f32, float, float)
RMSNORM_ENTRY(rmsnorm_f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRY(rmsnorm_bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRY(rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

// The backward: rmsnorm_bwd_<x type>_<scale type>. x, dy and dx are
// (plan->rows, plan->d) contiguous device arrays of x's type, scale and
// dscale (d,) of scale's type, partial a (plan->blocks, d) float32 scratch.
// Launches the row pass and the column sum on `stream`; returns the first
// launch error (cudaError_t), and does not synchronize.
#define RMSNORM_BWD_ENTRY(NAME, T, S)                                                        \
  extern "C" int NAME(const void* x, const void* scale, const void* dy, void* dx,            \
                      void* dscale, void* partial, const RmsnormBwdPlan* plan, void* stream) { \
    return launch_bwd<T, S>(x, scale, dy, dx, dscale, partial, plan, stream);                \
  }

RMSNORM_BWD_ENTRY(rmsnorm_bwd_f32_f32, float, float)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_f32_bf16, float, __nv_bfloat16)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_bf16_f32, __nv_bfloat16, float)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
