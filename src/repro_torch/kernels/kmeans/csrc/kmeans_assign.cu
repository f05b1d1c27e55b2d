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
// rows; here the ragged N, C and d edges are masked in the kernel.
//
// Two routes, chosen per shape by ops.py::launch_plan (cached per shape and
// SM count, passed in here; the entry makes no device query). The plan's
// route crossover and block sizes were set by measurement (PERF.md §6).
//
// The rows route (up to 48 centres in f32, 16 in bf16: every shape of the
// training path).
// What bounds it is bytes: 4·B·(N·d + C·d + N) at 3.35 TB/s, 2.5 us at the
// path's (8, 2048, 128, 10), against 0.6 us of f32 FMA. At a few us a
// launch is latency, so the design is one round trip for x:
//  * a block stages its batch entry's centres in shared memory once
//    (16-byte loads, zero-padded) and their squared norms once, from shared
//    memory; then it walks its rows with no further block barrier;
//  * a group of L lanes owns a row, 16 elements a lane (d = 128 f32: 8
//    lanes of four 16-byte vectors), and R = 2 rows at once, so that one
//    read of a centre from shared memory serves both; R = 1 where that
//    leaves too few blocks to fill the card;
//  * each lane issues all of its rows' loads before it uses any: x is read
//    once, and the loads fly while the centres are staged. A block holds
//    one pass of rows, (256 / L) · R, and the grid has a block for each;
//  * ‖x‖² and the dots come from the same registers. The centres go K =
//    min(L, 8) at a time (the last C mod K one at a time): a transposing
//    butterfly of K - 1 shuffles leaves each lane one full dot, which it
//    folds into its own (min, argmin) in increasing index order with a
//    strict '<'; the K lanes merge once a row.
//
// The tile route (larger C). What bounds it is operations: on the tensor
// cores at f32 accuracy a product costs three TF32 products, so the least
// time is 3 · 2·B·N·C·d FLOP at 495 TFLOP/s (51 us at (1, 4096, 1024,
// 1000), against 125 us of f32 FMA). The design:
//  * 3xTF32 mma.sync.m16n8k8: each f32 operand is split into hi + lo, both
//    rounded as cvt.rna.tf32.f32 rounds, and a product is lo·hi + hi·lo +
//    hi·hi (helpers copied from sdpa_estimator.cu). bf16 operands are exact
//    in TF32 (their lo is 0), so they take the hi·hi pass alone;
//  * a block of 2 x 2 warps owns BM = 128 rows x a range of centres,
//    walked in BN = 64-centre tiles; each tile sweeps d in KC = 32-column
//    chunks through a 3-deep cp.async ring (element loads where the rows
//    are not 16-byte aligned); a warp holds a 64 x 32 block of dots, so
//    each split operand feeds four mma's;
//  * short tensor-core sums: each chunk's products go to an accumulator of
//    their own, added to the running dot with an IEEE f32 add, so the error
//    does not grow with d (an mma's accumulation does not round as an IEEE
//    add does);
//  * ‖x‖² and ‖μ‖² are summed in f32 from the fragments as they pass; after
//    a tile's sweep the epilogue folds (x2 - 2·dot) + c2 into a running
//    (min, argmin) per row in registers; no distance reaches memory;
//  * a grid that fills the card: where the row tiles alone leave SMs idle
//    the centres are cut into ranges, one block each; each range parks its
//    (min, argmin) and kmeans_merge takes the lowest distance over the
//    ranges in index order with a strict '<' (so the lowest index on ties,
//    whatever order the blocks ran in; -0.0 == +0.0 as floats compare).

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- rows route
constexpr int RT = 256;               // threads a block
constexpr int RR = 2;                 // rows a lane group holds at once, at most (the plan: 1 or 2)
constexpr int EPL = 16;               // elements of a row a lane holds, at most
constexpr int ROWS_MAX_D = 32 * EPL;  // widest d: 32 lanes a row
constexpr int ROWS_SMEM_MAX = 98304;  // most shared memory for the centres and norms
constexpr int ROWS_MIN_BLOCKS = 2;    // blocks an SM holds by registers (__launch_bounds__)
constexpr int CK = 8;                 // centres a lane group reduces at once, at most
constexpr int SU = 4;                 // centre vectors a thread stages at once
// ---- tile route
constexpr int WM = 2;             // warps along the rows
constexpr int WN = 2;             // warps along the centres
constexpr int MI = 4;             // 16-row mma tiles a warp
constexpr int NJ = 4;             // 8-centre mma tiles a warp
constexpr int BM = WM * MI * 16;  // rows a block: 128
constexpr int BN = WN * NJ * 8;   // centres a tile: 64
constexpr int KC = 32;            // columns a chunk
constexpr int STAGES = 3;         // depth of the cp.async ring
constexpr int TT = 32 * WM * WN;  // threads a block: 128
constexpr int MIN_BLOCKS = 2;     // blocks an SM holds by registers (__launch_bounds__)

typedef uint16_t bf16_bits;  // a bfloat16 element, read as its bits

__host__ __device__ inline int vec_elems(int elem) { return 16 / elem; }

// Lanes a row on the rows route: the fewest (a power of two) that hold a
// row in at most EPL elements each.
__host__ __device__ inline int row_lanes(int d, int elem) {
  const int ve = vec_elems(elem), nv = (d + ve - 1) / ve, per_lane = EPL / ve;
  int lanes = 1;
  while (lanes < 32 && lanes * per_lane < nv) lanes *= 2;
  return lanes;
}

// Floats a staged centre row takes: the lanes' full width, zero-padded.
__host__ __device__ inline int rows_pitch(int d, int elem) {
  const int ve = vec_elems(elem), nv = (d + ve - 1) / ve, lanes = row_lanes(d, elem);
  return lanes * ((nv + lanes - 1) / lanes) * ve;
}

// The centres in f32, each row zero-padded to the lanes' width, and their norms.
__host__ __device__ inline long long rows_smem_bytes(int c, int d, int elem) {
  return 4LL * c * (rows_pitch(d, elem) + 1);
}

// Dynamic shared memory of the tile route: STAGES ring slots of the x and
// centre chunks, rows padded by one vector against bank conflicts, and the
// final merge's (min, argmin) of BM rows from each warp column wn > 0.
__host__ __device__ inline int tile_smem_bytes(int elem) {
  return STAGES * (BM + BN) * (KC + vec_elems(elem)) * elem + 8 * BM * (WN - 1);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16_bits v) { return __uint_as_float((uint32_t)v << 16); }

// The 16 bytes at p as a vector of 16 / sizeof(T) elements, of which the
// first `valid` are read and the rest are 0: one 16-byte load where `vec`
// (p is 16-byte aligned) and the vector is whole, else element loads.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* p, int valid, bool vec) {
  constexpr int VE = 16 / sizeof(T);
  if (vec && valid >= VE) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < valid) w[e] = __ldg(reinterpret_cast<const unsigned int*>(p) + e);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (e < valid)
        w[e >> 1] |= (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p) + e)
                     << (16 * (e & 1));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The vector's elements as floats: 4 (f32) or 8 (bf16, exact).
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(T) == 4) {
      f[i] = __uint_as_float(w[i]);
    } else {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// Sum over the L lanes of an aligned lane group (every lane gets it). L is
// a compile-time constant: a shuffle under a runtime condition compiles with
// a divergent-lane fallback.
template <int L>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;
}

// v[0..K) are a lane's partial dots of K centres; the group's L lanes hold
// the rest of each. Afterwards lane l's v[0] is the full dot of centre
// l % K: first the lanes above K add theirs, then a butterfly halves the
// centres at each step (the lane whose bit o is set keeps the upper half and
// sends the lower): K - 1 shuffles where L = K, against K · log2(L) for K
// separate sums.
template <int L, int K>
__device__ __forceinline__ void reduce_scatter(float (&v)[K], int lane) {
#pragma unroll
  for (int o = L / 2; o >= K; o >>= 1)
#pragma unroll
    for (int i = 0; i < K; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], o);
#pragma unroll
  for (int o = K / 2; o > 0; o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < o; ++i) {
      const float keep = up ? v[i + o] : v[i], send = up ? v[i] : v[i + o];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
  }
}

// The lexicographic lower of (v, a) and (ov, oa): lower distance, then index.
__device__ __forceinline__ void take_lower(float& v, int& a, float ov, int oa) {
  if (ov < v || (ov == v && oa < a)) {
    v = ov;
    a = oa;
  }
}

// Fold centres j0 .. j0 + K - 1 into each lane's running (min, argmin) of
// its R rows: the lane sums its part of the K dots from its registers and
// the staged centres, reduce_scatter leaves it centre j0 + sub % K, and it
// keeps that one if strictly nearer (a lane's centres come in increasing
// order: its lowest index on ties). K = 1 is a whole group sum.
template <int L, int K, int R, int VE, int VPL>
__device__ __forceinline__ void fold_centres(const float (&xf)[R][EPL], const float (&x2)[R],
                                             const float* cs, const float* c2s, int pitch,
                                             int vpl, int j0, int sub, int lane, float (&best)[R],
                                             int (&arg)[R]) {
  float dot[R][K];
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int i = 0; i < K; ++i) dot[h][i] = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float* const cr = cs + (j0 + i) * pitch + sub * VE;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      if (v < vpl) {
#pragma unroll
        for (int q = 0; q < VE / 4; ++q) {
          const float4 m = *reinterpret_cast<const float4*>(cr + v * L * VE + 4 * q);
#pragma unroll
          for (int h = 0; h < R; ++h) {
            const float* const xv = &xf[h][v * VE + 4 * q];
            dot[h][i] = fmaf(xv[0], m.x, dot[h][i]);
            dot[h][i] = fmaf(xv[1], m.y, dot[h][i]);
            dot[h][i] = fmaf(xv[2], m.z, dot[h][i]);
            dot[h][i] = fmaf(xv[3], m.w, dot[h][i]);
          }
        }
      }
    }
  }
  const int j = j0 + (sub & (K - 1));
  const float c2 = c2s[j];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    reduce_scatter<L, K>(dot[h], lane);
    const float dist = (x2[h] - 2.f * dot[h][0]) + c2;
    if (dist < best[h]) {
      best[h] = dist;
      arg[h] = j;
    }
  }
}

// The rows route. Block (blockIdx.x, b = blockIdx.y) owns (RT / L) · R rows
// of batch entry b, L = row_lanes(d). Lane `sub` of a
// group holds, of each of its R rows, the 16-byte vectors sub, sub + L, ...
// (so that the group's lanes read neighbouring vectors). The centres go K
// at a time while K remain, then one at a time; the K lanes that hold
// different centres merge once a row.
template <typename T, int L, int R>
__global__ void __launch_bounds__(RT, ROWS_MIN_BLOCKS)
kmeans_rows_kernel(const T* __restrict__ x, const T* __restrict__ mu, int* __restrict__ out,
                   float* __restrict__ mind, int n, int c, int d, long long x_sb, long long x_rs,
                   long long mu_sb, long long mu_rs, int vec) {
  constexpr int VE = 16 / sizeof(T);  // elements a vector
  constexpr int VPL = EPL / VE;       // vectors a lane holds of a row, at most
  constexpr int K = L < CK ? L : CK;  // centres reduced at once
  extern __shared__ float4 rows_smem[];
  float* const cs = reinterpret_cast<float*>(rows_smem);
  const int nv = (d + VE - 1) / VE;
  const int vpl = (nv + L - 1) / L;  // <= VPL (row_lanes)
  const int pitch = L * vpl * VE;
  float* const c2s = cs + (long long)c * pitch;
  const long long b = blockIdx.y;
  const T* const xb = x + b * x_sb;
  const T* const mb = mu + b * mu_sb;
  const int tid = threadIdx.x, lane = tid & 31, sub = tid & (L - 1);
  const int grp = tid / L, groups = RT / L, rows_pass = groups * R;
  const long long r0 = (long long)blockIdx.x * rows_pass;

  uint4 raw[R][VPL];  // in flight while the centres are staged
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const long long row = r0 + h * groups + grp;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int k = (v * L + sub) * VE;
      const bool in = row < n && v < vpl;
      raw[h][v] = load16(xb + (in ? row * x_rs + k : 0), in ? d - k : 0, vec);
    }
  }

  // Stage the centres SU vectors a thread at a time, all loads issued before
  // any store: one round trip for up to RT · SU vectors.
  const int row_vecs = pitch / VE, all_vecs = c * row_vecs;
  for (int e0 = 0; e0 < all_vecs; e0 += RT * SU) {
    uint4 buf[SU];
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * RT + tid, j = e / row_vecs, k = (e - j * row_vecs) * VE;
      const bool in = e < all_vecs && k < d;
      buf[u] = load16(mb + (in ? j * mu_rs + k : 0), in ? d - k : 0, vec);
    }
#pragma unroll
    for (int u = 0; u < SU; ++u) {
      const int e = e0 + u * RT + tid;
      if (e < all_vecs) {
        float f[VE];
        unpack<T>(buf[u], f);
        float4* const dst = reinterpret_cast<float4*>(cs + e * VE);
#pragma unroll
        for (int q = 0; q < VE / 4; ++q)
          dst[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
      }
    }
  }
  __syncthreads();
  for (int j = tid >> 5; j < c; j += RT / 32) {
    float s = 0.f;
    for (int k = lane; k < pitch; k += 32) s = fmaf(cs[j * pitch + k], cs[j * pitch + k], s);
    s = group_sum<32>(s);
    if (lane == 0) c2s[j] = s;
  }
  __syncthreads();  // the last barrier: the rows below need none

  float xf[R][EPL];
#pragma unroll
  for (int h = 0; h < R; ++h)
#pragma unroll
    for (int v = 0; v < VPL; ++v) unpack<T>(raw[h][v], &xf[h][v * VE]);
  float x2[R], best[R];
  int arg[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    float s = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) s = fmaf(xf[h][e], xf[h][e], s);
    x2[h] = group_sum<L>(s);
    best[h] = INFINITY;
    arg[h] = 0;
  }
  int j0 = 0;
  for (; j0 + K <= c; j0 += K)
    fold_centres<L, K, R, VE, VPL>(xf, x2, cs, c2s, pitch, vpl, j0, sub, lane, best, arg);
  for (; j0 < c; ++j0)
    fold_centres<L, 1, R, VE, VPL>(xf, x2, cs, c2s, pitch, vpl, j0, sub, lane, best, arg);
#pragma unroll
  for (int h = 0; h < R; ++h) {
#pragma unroll
    for (int o = 1; o < K; o <<= 1)
      take_lower(best[h], arg[h], __shfl_xor_sync(0xffffffffu, best[h], o),
                 __shfl_xor_sync(0xffffffffu, arg[h], o));
    const long long row = r0 + h * groups + grp;
    if (sub == 0 && row < n) {
      out[b * n + row] = arg[h];
      if (mind != nullptr) mind[b * n + row] = best[h];
    }
  }
}

// ---- tile route helpers (copies of sdpa_estimator.cu's; see there)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cvt.rna.tf32.f32 of a finite x: to nearest, ties away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes into shared memory: cp.async where `vec` (zero-filling past
// `valid` elements), else element loads and a 16-byte store.
template <typename T>
__device__ __forceinline__ void copy16(T* dst, const T* src, int valid, bool vec) {
  constexpr int VE = 16 / sizeof(T);
  if (vec) {
    const int bytes = valid <= 0 ? 0 : (valid >= VE ? 16 : valid * (int)sizeof(T));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "r"(bytes)
                 : "memory");
  } else {
    *reinterpret_cast<uint4*>(dst) = load16(src, valid, false);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The tile route. Block (row tile, centre range) = blockIdx.x (range-minor),
// batch entry blockIdx.y. Warp (wm, wn) holds rows wm·MI·16 .. of the tile
// and centres wn·NJ·8 .. of each centre tile: MI x NJ mma tiles of 16 x 8.
// Thread (g = lane / 4, t = lane % 4) holds, of each, rows g and g + 8 and
// centres 2t and 2t + 1 (the m16n8 accumulator layout). Dynamic shared
// memory: STAGES ring slots of [BM][PITCH] x and [BN][PITCH] centre
// chunks, then the final merge's (min, argmin) of the warps wn > 0.
template <typename T>
__global__ void __launch_bounds__(TT, MIN_BLOCKS)
kmeans_tile_kernel(const T* __restrict__ x, const T* __restrict__ mu, int* __restrict__ out,
                   float* __restrict__ mind, float2* __restrict__ part, int n, int c, int d,
                   long long x_sb, long long x_rs, long long mu_sb, long long mu_rs, int splits,
                   int per_tiles, int vec) {
  constexpr int VE = 16 / sizeof(T);
  constexpr int PITCH = KC + VE;  // elements a staged row: 16 bytes of padding
  constexpr int VR = KC / VE;     // vectors a row of a chunk
  constexpr int STAGE = (BM + BN) * PITCH;
  constexpr bool F32 = sizeof(T) == 4;
  extern __shared__ float4 tile_smem[];
  T* const stages = reinterpret_cast<T*>(tile_smem);
  float2* const red = reinterpret_cast<float2*>(stages + STAGES * STAGE);  // [WN - 1][BM]

  const int split = blockIdx.x % splits;
  const int row0 = (blockIdx.x / splits) * BM;
  const long long b = blockIdx.y;
  const T* const xb = x + b * x_sb;
  const T* const mb = mu + b * mu_sb;
  const int cbeg = split * per_tiles * BN, cend = min(c, cbeg + per_tiles * BN);
  const int nchunks = (d + KC - 1) / KC;
  const int steps = ((cend - cbeg + BN - 1) / BN) * nchunks;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp % WM, wn = warp / WM, g = lane >> 2, t = lane & 3;

  // step s: centre tile s / nchunks, column chunk s % nchunks, into ring slot st
  auto issue = [&](int s, int st) {
    const int ct = s / nchunks, k0 = (s - ct * nchunks) * KC, c0 = cbeg + ct * BN;
    T* const xs = stages + st * STAGE;
    T* const cs = xs + BM * PITCH;
    for (int e = tid; e < BM * VR; e += TT) {
      const int r = e / VR, k = k0 + (e - r * VR) * VE;
      const bool in = row0 + r < n && k < d;
      copy16(xs + r * PITCH + (k - k0), xb + (in ? (row0 + r) * x_rs + k : 0), in ? d - k : 0,
             vec);
    }
    for (int e = tid; e < BN * VR; e += TT) {
      const int r = e / VR, k = k0 + (e - r * VR) * VE;
      const bool in = c0 + r < cend && k < d;
      copy16(cs + r * PITCH + (k - k0), mb + (in ? (c0 + r) * mu_rs + k : 0), in ? d - k : 0,
             vec);
    }
  };

  float dot[MI][NJ][4], x2p[MI][2], x2v[MI][2], c2p[NJ], best[MI][2];
  int arg[MI][2];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x2p[i][h] = 0.f;
      x2v[i][h] = 0.f;
      best[i][h] = INFINITY;
      arg[i][h] = 0;
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) dot[i][j][0] = dot[i][j][1] = dot[i][j][2] = dot[i][j][3] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j) c2p[j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s, s);
    cp_async_commit();  // an empty group past the end keeps the count
  }
  for (int s = 0; s < steps; ++s) {
    const int st = s % STAGES, ct = s / nchunks, kc = s - ct * nchunks, k0 = kc * KC;
    cp_async_wait<STAGES - 2>();  // step s has landed
    __syncthreads();              // ... for every thread, and every warp is done with step s - 1
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1, (s + STAGES - 1) % STAGES);
    cp_async_commit();

    float acc[MI][NJ][4];  // this chunk's products alone: a short tensor-core sum
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;
    const T* const xa = stages + st * STAGE + (wm * MI * 16 + g) * PITCH + t;
    const T* const ca = stages + st * STAGE + (BM + wn * NJ * 8 + g) * PITCH + t;
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      if (k0 + kk * 8 < d) {
        float a[MI][4], bv[NJ][2];
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const T* const p = xa + i * 16 * PITCH + kk * 8;
          a[i][0] = to_f32(p[0]);
          a[i][1] = to_f32(p[8 * PITCH]);
          a[i][2] = to_f32(p[4]);
          a[i][3] = to_f32(p[8 * PITCH + 4]);
          if (ct == 0) {  // ‖x‖² from the first centre tile's sweep
            x2p[i][0] = fmaf(a[i][2], a[i][2], fmaf(a[i][0], a[i][0], x2p[i][0]));
            x2p[i][1] = fmaf(a[i][3], a[i][3], fmaf(a[i][1], a[i][1], x2p[i][1]));
          }
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const T* const p = ca + j * 8 * PITCH + kk * 8;
          bv[j][0] = to_f32(p[0]);
          bv[j][1] = to_f32(p[4]);
          c2p[j] = fmaf(bv[j][1], bv[j][1], fmaf(bv[j][0], bv[j][0], c2p[j]));
        }
        if constexpr (F32) {
          uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(a[i][q], ah[i][q], al[i][q]);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int q = 0; q < 2; ++q) split_tf32(bv[j][q], bh[j][q], bl[j][q]);
          // lo·hi, hi·lo, then hi·hi: consecutive mma's are independent
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
        } else {  // bf16 is exact in TF32: one pass
          uint32_t ab[MI][4];
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) ab[i][q] = __float_as_uint(a[i][q]);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              mma_tf32(acc[i][j], ab[i], __float_as_uint(bv[j][0]), __float_as_uint(bv[j][1]));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dot[i][j][e] += acc[i][j][e];  // IEEE f32

    if (kc == nchunks - 1) {  // the tile's sweep is complete: fold its centres
      if (ct == 0) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) x2v[i][h] = quad_sum(x2p[i][h]);
      }
      // c2 of centre j·8 + q sits in lanes 4q .. 4q + 3; this thread's
      // accumulators hold centres j·8 + 2t and j·8 + 2t + 1
      float c2v[NJ][2];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float s2 = quad_sum(c2p[j]);
        c2v[j][0] = __shfl_sync(0xffffffffu, s2, 8 * t);
        c2v[j][1] = __shfl_sync(0xffffffffu, s2, 8 * t + 4);
        c2p[j] = 0.f;
      }
      const int cw = cbeg + ct * BN + wn * NJ * 8 + 2 * t;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int ci = cw + j * 8 + e;  // increasing over (j, e): strict '<' keeps the lowest
              if (ci < cend) {
                const float dist = (x2v[i][h] - 2.f * dot[i][j][2 * h + e]) + c2v[j][e];
                if (dist < best[i][h]) {
                  best[i][h] = dist;
                  arg[i][h] = ci;
                }
              }
            }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          dot[i][j][0] = dot[i][j][1] = dot[i][j][2] = dot[i][j][3] = 0.f;
    }
  }

  // Merge a row's holders: the 4 threads of a quad, then the WN warps
  // (red lies past the ring: no barrier needed before it is written).
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1)
        take_lower(best[i][h], arg[i][h], __shfl_xor_sync(0xffffffffu, best[i][h], o),
                   __shfl_xor_sync(0xffffffffu, arg[i][h], o));
      const int r = wm * MI * 16 + i * 16 + h * 8 + g;
      if (wn > 0 && t == 0)
        red[(wn - 1) * BM + r] = make_float2(best[i][h], __int_as_float(arg[i][h]));
    }
  __syncthreads();
  if (wn == 0 && t == 0) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * MI * 16 + i * 16 + h * 8 + g, row = row0 + r;
        float v = best[i][h];
        int a = arg[i][h];
#pragma unroll
        for (int w = 1; w < WN; ++w) {
          const float2 o = red[(w - 1) * BM + r];
          take_lower(v, a, o.x, __float_as_int(o.y));
        }
        if (row < n) {
          if (splits == 1) {
            out[b * n + row] = a;
            if (mind != nullptr) mind[b * n + row] = v;
          } else {
            part[((long long)split * gridDim.y + b) * n + row] = make_float2(v, __int_as_float(a));
          }
        }
      }
  }
}

// Merge the centre ranges of the tile route: per row, the lowest parked
// distance in increasing range order with a strict '<' (the lower index on
// equal distances; -0.0 and +0.0 compare equal). part is [splits][B·N].
__global__ void __launch_bounds__(256) kmeans_merge(const float2* __restrict__ part,
                                                    int* __restrict__ out,
                                                    float* __restrict__ mind, long long rows,
                                                    int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  float2 p = part[i];
  float best = p.x;
  int arg = __float_as_int(p.y);
  for (int r = 1; r < splits; ++r) {
    p = part[r * rows + i];
    if (p.x < best) {
      best = p.x;
      arg = __float_as_int(p.y);
    }
  }
  out[i] = arg;
  if (mind != nullptr) mind[i] = best;
}

// Rows, strides and the base: 16-byte vectors can be read in place.
bool aligned16(const void* p, int batch, int rows, long long sb, long long rs, int ve) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (batch == 1 || sb % ve == 0) &&
         (rows == 1 || rs % ve == 0);
}

template <typename T, int L, int R>
int launch_rows(long long per_entry, int batch, long long smem, cudaStream_t st, const T* x,
                const T* mu, int* out, float* mind, int n, int c, int d, long long x_sb,
                long long x_rs, long long mu_sb, long long mu_rs, int vec) {
  // opt in once per instantiation to the most any shape takes: no device query per call
  static const cudaError_t opted = cudaFuncSetAttribute(
      kmeans_rows_kernel<T, L, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, ROWS_SMEM_MAX);
  if (opted != cudaSuccess) return (int)opted;
  kmeans_rows_kernel<T, L, R><<<dim3((unsigned)per_entry, batch), RT, (size_t)smem, st>>>(
      x, mu, out, mind, n, c, d, x_sb, x_rs, mu_sb, mu_rs, vec);
  return (int)cudaGetLastError();
}

template <typename T, int L>
int dispatch_rows(int rows, long long per_entry, int batch, long long smem, cudaStream_t st,
                const T* x, const T* mu, int* out, float* mind, int n, int c, int d, long long x_sb,
                long long x_rs, long long mu_sb, long long mu_rs, int vec) {
  return rows == 1 ? launch_rows<T, L, 1>(per_entry, batch, smem, st, x, mu, out, mind, n, c, d,
                                          x_sb, x_rs, mu_sb, mu_rs, vec)
                   : launch_rows<T, L, 2>(per_entry, batch, smem, st, x, mu, out, mind, n, c, d,
                                          x_sb, x_rs, mu_sb, mu_rs, vec);
}

template <typename T>
int launch(const void* x, const void* mu, int* out, float* mind, float* part, int batch, int n,
           int c, int d, long long x_sb, long long x_rs, long long mu_sb, long long mu_rs,
           int route, int rows, int splits, int per_tiles, void* stream) {
  constexpr int elem = sizeof(T);
  if (batch < 1 || batch > 65535 || n < 0 || c < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  const int ve = vec_elems(elem);
  const int vec =
      aligned16(x, batch, n, x_sb, x_rs, ve) && aligned16(mu, batch, c, mu_sb, mu_rs, ve);
  const T* xt = static_cast<const T*>(x);
  const T* mt = static_cast<const T*>(mu);
  if (route == 0) {
    const long long smem = rows_smem_bytes(c, d, elem);
    if (d > ROWS_MAX_D || smem > ROWS_SMEM_MAX || rows < 1 || rows > RR)
      return (int)cudaErrorInvalidValue;
    if (n == 0) return (int)cudaSuccess;
    const int lanes = row_lanes(d, elem);
    const long long per_block = (long long)(RT / lanes) * rows;
    const long long per_entry = (n + per_block - 1) / per_block;
    if (per_entry > INT_MAX) return (int)cudaErrorInvalidValue;
#define KMEANS_ROWS(L)                                                                        \
  dispatch_rows<T, L>(rows, per_entry, batch, smem, st, xt, mt, out, mind, n, c, d, x_sb, x_rs, \
                      mu_sb, mu_rs, vec)
    switch (lanes) {
      case 1: return KMEANS_ROWS(1);
      case 2: return KMEANS_ROWS(2);
      case 4: return KMEANS_ROWS(4);
      case 8: return KMEANS_ROWS(8);
      case 16: return KMEANS_ROWS(16);
      default: return KMEANS_ROWS(32);
    }
#undef KMEANS_ROWS
  }
  if (route != 1 || splits < 1 || per_tiles < 1 ||
      (long long)(splits - 1) * per_tiles * BN >= c || (long long)splits * per_tiles * BN < c ||
      (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (long long)((n + BM - 1) / BM) * splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  static const cudaError_t tile_opted = cudaFuncSetAttribute(
      kmeans_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, tile_smem_bytes(elem));
  if (tile_opted != cudaSuccess) return (int)tile_opted;
  kmeans_tile_kernel<T><<<dim3((unsigned)blocks, batch), TT, tile_smem_bytes(elem), st>>>(
      xt, mt, out, mind, reinterpret_cast<float2*>(part), n, c, d, x_sb, x_rs, mu_sb, mu_rs,
      splits, per_tiles, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long all_rows = (long long)batch * n;
  kmeans_merge<<<(unsigned)((all_rows + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float2*>(part), out, mind, all_rows, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel's geometry, which ops.py's launch plan also counts with and
// checks against this once when it loads the library: out = {RT, RR, EPL,
// ROWS_MAX_D, ROWS_SMEM_MAX, ROWS_MIN_BLOCKS, CK, BM, BN, KC, TT, STAGES,
// MIN_BLOCKS, lanes a row at (d, elem), the rows route's shared bytes at
// (c, d, elem), the tile route's at elem}.
extern "C" void kmeans_geometry(int c, int d, int elem, long long* out) {
  const long long g[16] = {RT, RR, EPL, ROWS_MAX_D, ROWS_SMEM_MAX, ROWS_MIN_BLOCKS, CK, BM, BN, KC,
                           TT, STAGES, MIN_BLOCKS, row_lanes(d, elem), rows_smem_bytes(c, d, elem),
                           tile_smem_bytes(elem)};
  for (int i = 0; i < 16; ++i) out[i] = g[i];
}

// Plain C entry points, loaded with ctypes. x (B, N, d) and mu (B, C, d)
// with batch and row strides in elements (a batch stride of 0 broadcasts);
// each row's d values are contiguous. out and mind are contiguous (B, N);
// mind may be null. route 0 (rows): `rows` (1 or 2) rows a lane group
// holds at once. route 1 (tiles): `splits` centre ranges of `per_tiles` tiles of 64 centres
// (every range holds a centre); with more than one, part (splits·B·N float
// pairs) is the merge's scratch. Launches on `stream`, does not synchronize
// or query the device, and returns the first failing call's cudaError_t.
extern "C" int kmeans_assign_f32(const void* x, const void* mu, int* out, float* mind, float* part,
                                 int batch, int n, int c, int d, long long x_sb, long long x_rs,
                                 long long mu_sb, long long mu_rs, int route, int rows,
                                 int splits, int per_tiles, void* stream) {
  return launch<float>(x, mu, out, mind, part, batch, n, c, d, x_sb, x_rs, mu_sb, mu_rs, route,
                       rows, splits, per_tiles, stream);
}

extern "C" int kmeans_assign_bf16(const void* x, const void* mu, int* out, float* mind, float* part,
                                  int batch, int n, int c, int d, long long x_sb, long long x_rs,
                                  long long mu_sb, long long mu_rs, int route, int rows,
                                  int splits, int per_tiles, void* stream) {
  return launch<bf16_bits>(x, mu, out, mind, part, batch, n, c, d, x_sb, x_rs, mu_sb, mu_rs,
                           route, rows, splits, per_tiles, stream);
}
