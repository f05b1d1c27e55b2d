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
// dy and writes dx (plus d scales in, d out), about 12 f32 operations an
// element: memory bounds it, 6.3 MB (1.9 us at 3.35 TB/s) at mamba2-370m's
// 1024 x 1024 bf16 rows, 25 MB (7.5 us) at its 1024 x 2048 f32 gated
// norms. r is recomputed from x (the forward saves nothing, so its serving
// path and times are unchanged). Design, against what the first version
// (one block a row at a time, scalar loads, each row read twice, a d-float
// shared-memory dscale accumulator a block, 264 partial rows summed by
// ceil(d / 256) blocks) lost:
// - The row stays in registers. A row group of whole warps loads its row's
//   x and dy once as 16-byte vectors (slot k holds elements [k V, k V + V),
//   V in 16 bytes; thread t of a group of tpr threads holds slots t,
//   t + tpr, ...), sums x^2 and x * scale * dy, reduces both at once
//   (shuffles, and for a group of several warps one shared-memory stage
//   behind the group's own named barrier, so groups never wait for each
//   other) and writes dx from the same registers. The next row's vectors
//   are loaded before the current row's reduction.
// - Several row groups a block and at most one block an SM: a block takes
//   a contiguous run of rows and its groups interleave over it, so one wave
//   covers the rows (1024 rows on 132 SMs: 128 blocks of 8 rows).
// - A thread's columns are the same for every row its group walks: its
//   scales are loaded once and its dscale terms dy * x * r summed in
//   registers. At the end the block's groups combine their sums in a fixed
//   tree through shared memory (at most 512 V floats), and group 0 writes
//   the block's one partial row of an f32 (blocks, pitch) scratch.
// - The column sum runs ceil(d / 32) blocks of 32 columns; warp w of a
//   block adds the partial rows w, w + W, ... in order (8 loads in flight
//   at a time), then warp 0 adds the W sums in warp order. No atomics: two
//   runs give the same bits. W is a warp a partial row, up to 32. It is
//   launched as a programmatic dependent of the row pass (Hopper's
//   griddepcontrol), so that its launch overlaps the row pass's tail.
// - Any alignment in place: a slot's columns are fixed, so a row whose
//   start is 8-, 4- or 2-byte aligned is read and written in 8-byte, 4-byte
//   or one-element accesses, and the ragged last slot element by element.
// - Rows of more than 1024 slots (past 4096 f32 or 8192 bf16 elements)
//   take a loop route: the block is one group, reads each row twice, and
//   adds its dscale terms into its partial row in the scratch (a column
//   belongs to one thread), so no width is refused.
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
// (kernels/rmsnorm/ops.py::BackwardPlan, from backward_plan).
struct RmsnormBwdPlan {
  long long rows;
  long long rows_per_block;  // each block's contiguous run of rows
  int d;
  float eps;
  int vpt;            // 16-byte slots a thread holds (1, 2 or 4), or 0 to loop
  int group_threads;  // threads a row group: whole warps
  int groups;         // row groups a block (1 on the loop route)
  int blocks;         // the row pass's grid: rows of the f32 dscale scratch
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

// The most threads a backward row-pass block may have at VPT slots a
// thread (0: the loop route): its registers, with the next row's vectors
// prefetched, stay within what the SM gives that many threads.
__host__ __device__ constexpr int bwd_max_threads(int vpt) {
  return vpt <= 1 ? MAX_THREADS : MAX_THREADS / vpt;
}
// named barriers 1..15 a block: one for each group of several warps
constexpr int BWD_MAX_BARRIER_GROUPS = 15;

__device__ __forceinline__ void group_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The largest power of two (at most 16) that divides p's address.
__device__ __forceinline__ int align_of(const void* p) {
  const unsigned a = (unsigned)(reinterpret_cast<uintptr_t>(p) & 15u);
  return a == 0u ? 16 : (int)(a & (0u - a));
}

// Elements [c0, c0 + V) of a row whose start is `align`-byte aligned: one
// 16-byte load, two 8-byte or four 4-byte loads when the slot lies wholly
// in [0, d), else element by element with zeros past d.
template <typename T>
__device__ __forceinline__ uint4 load_cols(const T* __restrict__ row, int c0, int d, int align) {
  constexpr int V = 16 / sizeof(T);
  if (c0 + V <= d) {
    const T* p = row + c0;
    if (align == 16) return *reinterpret_cast<const uint4*>(p);
    if (align == 8) {
      const uint2 lo = reinterpret_cast<const uint2*>(p)[0];
      const uint2 hi = reinterpret_cast<const uint2*>(p)[1];
      return make_uint4(lo.x, lo.y, hi.x, hi.y);
    }
    if (align == 4) {
      const unsigned* w = reinterpret_cast<const unsigned*>(p);
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  uint4 u = make_uint4(0u, 0u, 0u, 0u);
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i < d) e[i] = row[c0 + i];
  return u;
}

template <typename T>
__device__ __forceinline__ void store_cols(T* __restrict__ row, int c0, int d, int align,
                                           const uint4& w) {
  constexpr int V = 16 / sizeof(T);
  if (c0 + V <= d) {
    T* p = row + c0;
    if (align == 16) {
      *reinterpret_cast<uint4*>(p) = w;
      return;
    }
    if (align == 8) {
      reinterpret_cast<uint2*>(p)[0] = make_uint2(w.x, w.y);
      reinterpret_cast<uint2*>(p)[1] = make_uint2(w.z, w.w);
      return;
    }
    if (align == 4) {
      unsigned* q = reinterpret_cast<unsigned*>(p);
      q[0] = w.x;
      q[1] = w.y;
      q[2] = w.z;
      q[3] = w.w;
      return;
    }
  }
  const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i)
    if (c0 + i < d) row[c0 + i] = e[i];
}

// One slot's share of the row sums: x^2 and x * (scale * dy).
template <typename T, int V>
__device__ __forceinline__ void slot_sums(const uint4& xu, const uint4& gu, const float (&s)[V],
                                          float& ss, float& dot) {
  const T* xe = reinterpret_cast<const T*>(&xu);
  const T* ge = reinterpret_cast<const T*>(&gu);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float xv = to_f32(xe[i]);
    ss = fmaf(xv, xv, ss);
    dot = fmaf(xv, s[i] * to_f32(ge[i]), dot);
  }
}

// One slot's dx, and its dscale terms dy * x * r added into acc.
template <typename T, int V>
__device__ __forceinline__ uint4 slot_dx(const uint4& xu, const uint4& gu, const float (&s)[V],
                                         float inv, float k, float (&acc)[V]) {
  const T* xe = reinterpret_cast<const T*>(&xu);
  const T* ge = reinterpret_cast<const T*>(&gu);
  uint4 w;
  T* o = reinterpret_cast<T*>(&w);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const float xv = to_f32(xe[i]), g = to_f32(ge[i]);
    o[i] = from_f32<T>(inv * (s[i] * g) - xv * k);
    acc[i] = fmaf(g * xv, inv, acc[i]);
  }
  return w;
}

// The backward's row pass. Block b takes rows [b R, b R + R) (R =
// rows_per_block); its blockDim.x / tpr groups of tpr threads interleave
// over them (group g: rows b R + g, b R + g + groups, ...). VPT > 0: the
// register route above; VPT = 0: one group a block, each row read twice,
// the dscale terms added into the block's partial row in place. The
// scratch's rows are `pitch` = slots * V floats apart.
template <typename T, typename S, int VPT>
__global__ void __launch_bounds__(bwd_max_threads(VPT))
    rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                            const T* __restrict__ dy, T* __restrict__ dx,
                            float* __restrict__ partial, long long rows, long long rows_per_block,
                            int d, float eps, int tpr) {
  constexpr int V = 16 / sizeof(T);
  constexpr int R = VPT > 0 ? VPT : 1;
  constexpr int SCALE_ALIGN = V * sizeof(S) < 16 ? V * sizeof(S) : 16;
  __shared__ float red[2][2][MAX_WARPS];
  // the groups' dscale sums on their way through the tree: at most half
  // the block's threads park R * V floats each
  __shared__ float4 comb[VPT > 0 ? bwd_max_threads(VPT) / 2 * R * V / 4 : 1];
  // the column sum, a programmatic dependent, may start now; it waits for
  // this grid to finish before it reads the scratch
  asm volatile("griddepcontrol.launch_dependents;");

  const int groups = blockDim.x / tpr;
  const int g = threadIdx.x / tpr, t = threadIdx.x - g * tpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int first_warp = g * (tpr >> 5), group_warps = tpr >> 5;
  const int slots = (d + V - 1) / V;
  const long long start = (long long)blockIdx.x * rows_per_block;
  const long long end = min(rows, start + rows_per_block);
  // the scales of a slot as 8- or 16-byte loads where their alignment allows
  const bool vec_s = reinterpret_cast<uintptr_t>(scale) % SCALE_ALIGN == 0;
  float* prow = partial + (long long)blockIdx.x * slots * V;
  int buf = 0;
  // (ss, dot) summed over the group: every thread gets the same bits
  auto group_sums = [&](float& ss, float& dot) {
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    if (group_warps > 1) {
      if (lane == 0) {
        red[buf][0][warp] = ss;
        red[buf][1][warp] = dot;
      }
      group_barrier(1 + g, tpr);
      ss = lane < group_warps ? red[buf][0][first_warp + lane] : 0.f;
      dot = lane < group_warps ? red[buf][1][first_warp + lane] : 0.f;
      ss = warp_sum(ss);
      dot = warp_sum(dot);
      buf ^= 1;  // the next row's sums go to the other buffer: no second barrier
    }
  };

  if constexpr (VPT > 0) {
    float s[VPT][V], acc[VPT][V];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      load_scale<S>(s[j], scale, (t + j * tpr) * V, d, vec_s);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[j][i] = 0.f;
    }
    uint4 xv[VPT], gv[VPT];
    auto load_row = [&](long long r, uint4(&xo)[VPT], uint4(&go)[VPT]) {
      const T* xr = x + r * d;
      const T* gr = dy + r * d;
      const int ax = align_of(xr), ag = align_of(gr);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int k = t + j * tpr;
        xo[j] = go[j] = make_uint4(0u, 0u, 0u, 0u);
        if (k < slots) {
          xo[j] = load_cols(xr, k * V, d, ax);
          go[j] = load_cols(gr, k * V, d, ag);
        }
      }
    };
    long long r = start + g;
    if (r < end) load_row(r, xv, gv);
    for (; r < end; r += groups) {
      uint4 nx[VPT], ng[VPT];
      const bool more = r + groups < end;
      if (more) load_row(r + groups, nx, ng);  // in flight during this row's sums
      float ss = 0.f, dot = 0.f;
#pragma unroll
      for (int j = 0; j < VPT; ++j) slot_sums<T>(xv[j], gv[j], s[j], ss, dot);
      group_sums(ss, dot);
      const float inv = rsqrtf(ss / (float)d + eps);
      const float k3 = inv * inv * inv * (dot / (float)d);
      T* dxr = dx + r * d;
      const int ad = align_of(dxr);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int k = t + j * tpr;
        if (k < slots)
          store_cols(dxr, k * V, d, ad, slot_dx<T>(xv[j], gv[j], s[j], inv, k3, acc[j]));
      }
      if (more) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          xv[j] = nx[j];
          gv[j] = ng[j];
        }
      }
    }
    // the block's groups' sums in a fixed tree: of the n groups that still
    // hold sums, the upper n - h (h = ceil(n / 2)) park theirs and group
    // q < n - h adds group q + h's
    for (int n = groups; n > 1;) {
      const int h = (n + 1) / 2;
      __syncthreads();  // the previous level's reads are done
      if (g >= h && g < n) {
#pragma unroll
        for (int j = 0; j < VPT; ++j)
#pragma unroll
          for (int q = 0; q < V / 4; ++q)
            comb[(((g - h) * VPT + j) * (V / 4) + q) * tpr + t] =
                make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
      __syncthreads();
      if (g < n - h) {
#pragma unroll
        for (int j = 0; j < VPT; ++j)
#pragma unroll
          for (int q = 0; q < V / 4; ++q) {
            const float4 o = comb[((g * VPT + j) * (V / 4) + q) * tpr + t];
            acc[j][4 * q] += o.x;
            acc[j][4 * q + 1] += o.y;
            acc[j][4 * q + 2] += o.z;
            acc[j][4 * q + 3] += o.w;
          }
      }
      n = h;
    }
    if (g == 0) {
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        const int k = t + j * tpr;
        if (k >= slots) continue;
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          reinterpret_cast<float4*>(prow + k * V)[q] =
              make_float4(acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2], acc[j][4 * q + 3]);
      }
    }
  } else {
    // the loop route: the block is one group of tpr threads
    for (int k = t; k < slots; k += tpr)
#pragma unroll
      for (int q = 0; q < V / 4; ++q)
        reinterpret_cast<float4*>(prow + k * V)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (long long r = start; r < end; ++r) {
      const T* xr = x + r * d;
      const T* gr = dy + r * d;
      T* dxr = dx + r * d;
      const int ax = align_of(xr), ag = align_of(gr), ad = align_of(dxr);
      float ss = 0.f, dot = 0.f;
      for (int k = t; k < slots; k += tpr) {
        float s[V];
        load_scale<S>(s, scale, k * V, d, vec_s);
        slot_sums<T>(load_cols(xr, k * V, d, ax), load_cols(gr, k * V, d, ag), s, ss, dot);
      }
      group_sums(ss, dot);
      const float inv = rsqrtf(ss / (float)d + eps);
      const float k3 = inv * inv * inv * (dot / (float)d);
      for (int k = t; k < slots; k += tpr) {
        float s[V], acc[V];
        load_scale<S>(s, scale, k * V, d, vec_s);
        float4* pv = reinterpret_cast<float4*>(prow + k * V);
#pragma unroll
        for (int q = 0; q < V / 4; ++q) {
          const float4 o = pv[q];
          acc[4 * q] = o.x;
          acc[4 * q + 1] = o.y;
          acc[4 * q + 2] = o.z;
          acc[4 * q + 3] = o.w;
        }
        const uint4 xu = load_cols(xr, k * V, d, ax), gu = load_cols(gr, k * V, d, ag);
        store_cols(dxr, k * V, d, ad, slot_dx<T>(xu, gu, s, inv, k3, acc));
#pragma unroll
        for (int q = 0; q < V / 4; ++q)
          pv[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      }
    }
  }
}

// dscale[c] = the sum of partial[b, c] over the row pass's blocks b: 32
// columns a block; warp w adds rows w, w + W, ... in order, BWD_SUM_BATCH
// independent loads in flight at a time, then warp 0 adds the W sums in
// warp order (read from shared memory all at once).
constexpr int BWD_SUM_BATCH = 8;

template <typename S>
__global__ void __launch_bounds__(MAX_THREADS)
    rmsnorm_bwd_scale_kernel(const float* __restrict__ partial, S* __restrict__ dscale,
                             int blocks, int d, int pitch) {
  __shared__ float sums[MAX_WARPS][32];
  // a programmatic dependent: wait for the row pass to finish and its
  // writes to be visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.f;
  for (int b0 = w; b0 < blocks; b0 += BWD_SUM_BATCH * warps) {
    float v[BWD_SUM_BATCH];
#pragma unroll
    for (int i = 0; i < BWD_SUM_BATCH; ++i) {
      const int b = b0 + i * warps;
      v[i] = c < d && b < blocks ? partial[(long long)b * pitch + c] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < BWD_SUM_BATCH; ++i)
      if (b0 + i * warps < blocks) s += v[i];
  }
  sums[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < d) {
    float v[MAX_WARPS];
#pragma unroll
    for (int q = 0; q < MAX_WARPS; ++q) v[q] = sums[q][lane];
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_WARPS; ++q)
      if (q < warps) total += v[q];
    dscale[c] = from_f32<S>(total);
  }
}

template <typename T, typename S, int VPT>
cudaError_t launch_bwd_rows(const void* x, const void* scale, const void* dy, void* dx,
                            float* partial, const RmsnormBwdPlan* p, cudaStream_t st) {
  rmsnorm_bwd_rows_kernel<T, S, VPT><<<p->blocks, p->group_threads * p->groups, 0, st>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale), static_cast<const T*>(dy),
      static_cast<T*>(dx), partial, p->rows, p->rows_per_block, p->d, p->eps, p->group_threads);
  return cudaGetLastError();
}

template <typename T, typename S>
int launch_bwd(const void* x, const void* scale, const void* dy, void* dx, void* dscale,
               void* partial, const RmsnormBwdPlan* plan, void* stream) {
  constexpr int V = 16 / sizeof(T);
  if (plan == nullptr) return (int)cudaErrorInvalidValue;
  const long long rows = plan->rows, per_block = plan->rows_per_block;
  const int d = plan->d, vpt = plan->vpt, tpr = plan->group_threads, groups = plan->groups;
  const int blocks = plan->blocks, warps = blocks < MAX_WARPS ? blocks : MAX_WARPS;
  const long long slots = ((long long)d + V - 1) / V;
  // whole warps a group; the block within the route's threads; a register
  // route's group holds the row's slots; every block has a row and every
  // row a block
  if (rows < 1 || d < 1 || (vpt != 0 && vpt != 1 && vpt != 2 && vpt != 4) || tpr < 32 ||
      tpr % 32 != 0 || groups < 1 || (long long)tpr * groups > bwd_max_threads(vpt) ||
      (vpt == 0 && groups != 1) || (tpr > 32 && groups > BWD_MAX_BARRIER_GROUPS) ||
      (vpt != 0 && (long long)tpr * vpt < slots) || blocks < 1 || per_block < 1 ||
      (long long)blocks * per_block < rows || (long long)(blocks - 1) * per_block >= rows ||
      slots * V > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != plan->device) e = cudaSetDevice(plan->device);
  if (e != cudaSuccess) return (int)e;
  const auto st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (vpt == 0)
    e = launch_bwd_rows<T, S, 0>(x, scale, dy, dx, part, plan, st);
  else if (vpt == 1)
    e = launch_bwd_rows<T, S, 1>(x, scale, dy, dx, part, plan, st);
  else if (vpt == 2)
    e = launch_bwd_rows<T, S, 2>(x, scale, dy, dx, part, plan, st);
  else
    e = launch_bwd_rows<T, S, 4>(x, scale, dy, dx, part, plan, st);
  if (e == cudaSuccess) {
    const int pitch = (int)(slots * V);
    S* ds = static_cast<S*>(dscale);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((d + 31) / 32));
    cfg.blockDim = dim3((unsigned)(32 * warps));
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, rmsnorm_bwd_scale_kernel<S>, (const float*)part, ds, blocks, d,
                           pitch);
    if (e == cudaSuccess) e = cudaGetLastError();
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
// (plan->rows, plan->d) contiguous device arrays of x's type (any
// alignment), scale and dscale (d,) of scale's type, partial an f32
// (plan->blocks, ceil(d / V) * V) scratch (V elements of x in 16 bytes),
// 16-byte aligned. The plan is checked on every call. Launches the row
// pass and the column sum on `stream`; returns the first launch error
// (cudaError_t), and does not synchronize.
#define RMSNORM_BWD_ENTRY(NAME, T, S)                                                        \
  extern "C" int NAME(const void* x, const void* scale, const void* dy, void* dx,            \
                      void* dscale, void* partial, const RmsnormBwdPlan* plan, void* stream) { \
    return launch_bwd<T, S>(x, scale, dy, dx, dscale, partial, plan, stream);                \
  }

RMSNORM_BWD_ENTRY(rmsnorm_bwd_f32_f32, float, float)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_f32_bf16, float, __nv_bfloat16)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_bf16_f32, __nv_bfloat16, float)
RMSNORM_BWD_ENTRY(rmsnorm_bwd_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
