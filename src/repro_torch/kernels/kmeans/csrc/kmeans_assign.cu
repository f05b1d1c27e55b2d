// k-means cluster assignment for Hopper (sm_90a), float32 arithmetic:
//
//   out[b, i]  = argmin_c ( ||x[b,i]||^2 - 2 x[b,i]·mu[b,c] + ||mu[b,c]||^2 )
//   mind[b, i] = that minimum (optional: the inertia's terms)
//   x (B, N, d), mu (B, C, d), float32 or bfloat16 -> out (B, N) int32
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/kmeans/kernel.py::_kmeans_assign_kernel (launched by
// kmeans_assign_batched_padded). It computes the same expansion in the same
// association, (x2 - 2·dot) + c2, and jnp.argmin's tie rule: the lowest
// centre index wins. It is not a block-by-block copy: the TPU kernel holds
// all C·d centres in VMEM and pads d and C to 128 lanes with 3e18 sentinel
// rows; here the centres stream through shared memory in tiles, and the
// ragged N, C and d edges are loop bounds.
//
// Design. A 2-D grid of (N / BN row tiles) x B blocks; the batch strides of
// x and mu are arguments, so a batch broadcast with a stride-0 view needs no
// copy. A block of 256 threads owns BN = 64 rows. It first computes the
// rows' squared norms (one warp per row). Then, for each tile of TC = 64
// centres, it computes the centres' squared norms once, and walks d in
// chunks of TD = 32 columns: the x chunk and the centre chunk are staged
// (transposed) in shared memory, and each thread accumulates a 4 rows x 4
// centres micro-tile of dot products with f32 FMA (no tensor cores, no
// TF32). At the end of a tile each thread folds its 16 distances into a
// running (min, argmin) per row, visiting centres in increasing index
// order with a strict '<', so the running argmin carries across tiles in
// index order. Last, the 16 threads that share a row merge their (min,
// argmin) pairs by shuffles, taking the lower index on equal distances.
// Shared memory is 17 KB whatever C and d are, so any C and d run.
//
// What bounds it on an H100. Work is 2·B·N·C·d FLOP against
// 4·B·(N·d + C·d + N) compulsory bytes (f32 in, int32 out). At the
// one-shot path's shape (B = 8 restarts x parties, N = 2048, d = 128,
// C = 10) that is 42 MFLOP (0.6 us at 67 TFLOP/s) against 8.4 MB (2.5 us at
// 3.35 TB/s): memory-bound, and at these sizes a launch is dominated by its
// fixed cost. The 64-wide centre tile wastes most of its FMAs when C = 10;
// at C ~ 1000 (the large-C check) the kernel is compute-bound and runs
// plain FMA, where tensor cores with f32 accuracy would be the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BN = 64;          // rows per block
constexpr int TC = 64;          // centres per shared-memory tile
constexpr int TD = 32;          // columns per staged chunk
constexpr int NT = 256;         // threads per block: 16 x 16
constexpr int RPT = 4;          // rows per thread
constexpr int CPT = 4;          // centres per thread
constexpr int PITCH_X = BN + 1; // transposed tiles, padded against bank conflicts
constexpr int PITCH_C = TC + 1;
static_assert(BN == 16 * RPT && TC == 16 * CPT && NT == 256, "thread roles");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Squared norm of one length-d row, by one warp.
template <typename T>
__device__ __forceinline__ float warp_sq_norm(const T* row, int d, int lane) {
  float s = 0.f;
  for (int k = lane; k < d; k += 32) {
    float v = to_f32(row[k]);
    s = fmaf(v, v, s);
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

template <typename T>
__global__ void __launch_bounds__(NT)
kmeans_assign_kernel(const T* __restrict__ x, const T* __restrict__ mu, int* __restrict__ out,
                     float* __restrict__ mind, int n, int c, int d, long long x_sb,
                     long long x_rs, long long mu_sb, long long mu_rs) {
  __shared__ float xs[TD * PITCH_X];  // x chunk, [column][row]
  __shared__ float cs[TD * PITCH_C];  // centre chunk, [column][centre]
  __shared__ float x2s[BN];
  __shared__ float c2s[TC];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // centre lane: centres tx, tx + 16, tx + 32, tx + 48
  const int ty = tid >> 4;  // row lane: rows 4·ty .. 4·ty + 3
  const int warp = tid >> 5, lane = tid & 31;
  const T* xb = x + b * x_sb;
  const T* mb = mu + b * mu_sb;

  for (int r = warp; r < BN; r += NT / 32) {
    const int gr = row0 + r;
    float s = gr < n ? warp_sq_norm(xb + gr * x_rs, d, lane) : 0.f;
    if (lane == 0) x2s[r] = s;
  }

  float best[RPT];
  int arg[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    best[i] = INFINITY;
    arg[i] = 0;
  }

  for (int c0 = 0; c0 < c; c0 += TC) {
    __syncthreads();  // c2s of the previous tile is no longer read
    for (int j = warp; j < TC; j += NT / 32) {
      const int gc = c0 + j;
      float s = gc < c ? warp_sq_norm(mb + gc * mu_rs, d, lane) : 0.f;
      if (lane == 0) c2s[j] = s;
    }
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += TD) {
      __syncthreads();  // the previous chunk has been read
      // Stage the chunks: consecutive threads read consecutive columns.
      for (int e = tid; e < BN * TD; e += NT) {
        const int r = e / TD, k = e % TD;
        const int gr = row0 + r, gk = k0 + k;
        xs[k * PITCH_X + r] = (gr < n && gk < d) ? to_f32(xb[gr * x_rs + gk]) : 0.f;
      }
      for (int e = tid; e < TC * TD; e += NT) {
        const int j = e / TD, k = e % TD;
        const int gc = c0 + j, gk = k0 + k;
        cs[k * PITCH_C + j] = (gc < c && gk < d) ? to_f32(mb[gc * mu_rs + gk]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(TD, d - k0);
      for (int k = 0; k < kmax; ++k) {
        float a[RPT], m[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = xs[k * PITCH_X + RPT * ty + i];
#pragma unroll
        for (int j = 0; j < CPT; ++j) m[j] = cs[k * PITCH_C + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], m[j], acc[i][j]);
      }
    }
    // Fold the tile into the running (min, argmin): this thread's centres
    // in increasing index order, strict '<' keeps the lowest index.
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int gc = c0 + tx + 16 * j;
      if (gc < c) {
        const float c2 = c2s[tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float dist = (x2s[RPT * ty + i] - 2.f * acc[i][j]) + c2;
          if (dist < best[i]) {
            best[i] = dist;
            arg[i] = gc;
          }
        }
      }
    }
  }

  // Merge the 16 centre lanes of each row (lanes of one half-warp).
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float v = best[i];
    int a = arg[i];
    for (int o = 8; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o, 16);
      const int oa = __shfl_xor_sync(0xffffffffu, a, o, 16);
      if (ov < v || (ov == v && oa < a)) {
        v = ov;
        a = oa;
      }
    }
    const int gr = row0 + RPT * ty + i;
    if (tx == 0 && gr < n) {
      out[(long long)b * n + gr] = a;
      if (mind != nullptr) mind[(long long)b * n + gr] = v;
    }
  }
}

template <typename T>
int launch(const void* x, const void* mu, int* out, float* mind, int batch, int n, int c, int d,
           long long x_sb, long long x_rs, long long mu_sb, long long mu_rs, void* stream) {
  if (batch < 1 || batch > 65535 || n < 0 || c < 1 || d < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const dim3 grid((n + BN - 1) / BN, batch);
  kmeans_assign_kernel<T><<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(mu), out, mind, n, c, d, x_sb, x_rs, mu_sb,
      mu_rs);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements; each row's d values are contiguous. out and mind
// are contiguous (B, N); mind may be null. Returns a cudaError_t.
extern "C" int kmeans_assign_f32(const void* x, const void* mu, int* out, float* mind, int batch,
                                 int n, int c, int d, long long x_sb, long long x_rs,
                                 long long mu_sb, long long mu_rs, void* stream) {
  return launch<float>(x, mu, out, mind, batch, n, c, d, x_sb, x_rs, mu_sb, mu_rs, stream);
}

extern "C" int kmeans_assign_bf16(const void* x, const void* mu, int* out, float* mind, int batch,
                                  int n, int c, int d, long long x_sb, long long x_rs,
                                  long long mu_sb, long long mu_rs, void* stream) {
  return launch<__nv_bfloat16>(x, mu, out, mind, batch, n, c, d, x_sb, x_rs, mu_sb, mu_rs,
                               stream);
}
