// Eq. 10 SDPA estimator for Hopper (sm_90a), float32 throughout:
//
//   out[b] = softmax(q[b] · k[b]ᵀ · scale) · v[b]
//   q (B, N_u, d), k (B, N_o, d), v (B, N_o, d_b) -> out (B, N_u, d_b)
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/sdpa_estimator/kernel.py::_sdpa_kernel (launched by
// sdpa_estimate_batched_padded). It computes what that kernel computes: one
// head, no causal mask, a flash-style online softmax over N_o, with the
// scale 1/sqrt(d) of the true d applied to q as it is staged. It is not a
// block-by-block copy: there is no 128-lane padding and no -1e30 padded
// column; the ragged N_o edge is the loop bound.
//
// Design. A 2-D grid of (N_u / BU row tiles) x B blocks. The TPU kernel's
// sequential N_o grid axis is the loop inside each block. A block holds G
// groups of NT threads (G = 2 when the grid alone would leave SMs idle,
// else 1); group g walks the K/V tiles g, g + G, g + 2G, ...
// of BO rows each, with its own shared-memory tile buffer, running max m and
// normalizer l (shared memory) and output accumulator (registers) for the
// block's BU query rows; the groups meet once at the end to merge their
// (m, l, acc) into the output. Per tile, a group
//   1. stages K (cp.async); each thread computes 8 rows x 1 key of the
//      score tile from the transposed, pre-scaled q tile;
//   2. stages V over K while each warp runs the online softmax over
//      BU / 8 rows of the score tile in place;
//   3. rescales and accumulates P·V, each thread 8 rows x one column of
//      each 128-wide slice of d_b.
// Groups synchronize on their own named barriers, so one group's loads
// overlap another's arithmetic. Arithmetic is plain f32 FMA (no tensor
// cores, no TF32): the port is held to the f32 reference.
//
// What bounds it on an H100. Work is 2·B·N_u·N_o·(d + d_b) FLOP; at the
// serving shape B=1, N_u=1024, N_o=2048, d=d_b=128 that is 1.07 GFLOP, or
// 16 us at the 67 TFLOP/s f32 (non-tensor) peak, against 3.1 MB of
// compulsory traffic (0.9 us at 3.35 TB/s): compute-bound. This kernel
// does not reach that bound. With BU = 16, a B=1 launch of 1024 rows has
// 64 blocks for 132 SMs, and a block's time is the length of its groups'
// chains of dependent shared-memory loads and FMAs (8 FMAs per 3 loads in
// both inner loops), not the FMA pipe's rate. Tried on the card: with one
// group, a launch's time barely moves with BU (8, 16 or 32 rows a block),
// while a second group walking half the tiles shortens a B=1 launch. PERF.md
// has this kernel's times. Tensor cores are what would close the gap; this
// kernel keeps true f32.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BU = 16;           // query rows per block
constexpr int BO = 128;          // key/value rows per shared-memory tile
constexpr int NT = 256;          // threads per group
constexpr int NW = NT / 32;      // warps per group
constexpr int MAX_D = 256;       // widest d and d_b
constexpr int P_PITCH = BU + 4;  // score-tile row pitch: float4-aligned and
                                 // free of bank conflicts for the stores
// Thread roles: each thread owns 8 query rows and one key of a tile
// (scores) or one column of each 128-wide output slice (P·V).
static_assert(BO == 128 && NT % BO == 0 && BU == 8 * (NT / BO), "thread roles");
static_assert(BU % NW == 0, "softmax rows per warp");

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Barrier for the NT threads of group g only (id 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(g + 1), "r"(NT) : "memory");
}

// Asynchronous global -> shared copies (sm_80+): all of a tile's loads are
// in flight at once instead of one load latency per element, and V's
// overlap the softmax that does not need them.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stage rows [j0, j0 + nk) of a (N_o, width) matrix with row stride rs into
// a shared tile of pitch `pitch`, one warp per row.
__device__ __forceinline__ void stage_tile(float* tile, const float* src, long long rs, int j0,
                                           int nk, int width, int pitch, int warp, int lane) {
  for (int j = warp; j < nk; j += NW)
    for (int c = lane; c < width; c += 32)
      cp_async_f32(tile + j * pitch + c, src + (j0 + j) * rs + c);
}

// Odd pitch: lanes reading one column of consecutive K rows hit distinct banks.
__host__ __device__ inline int kv_pitch(int d, int db) { return (d > db ? d : db) | 1; }

// One group's shared memory, in order: K/V tile [BO][pitch], score tile
// [BO][P_PITCH], then m, l and alpha [BU] each.
__host__ __device__ inline int group_floats(int d, int db) {
  return BO * kv_pitch(d, db) + BO * P_PITCH + 3 * BU;
}

__host__ __device__ inline size_t smem_bytes(int d, int db, int groups) {
  return sizeof(float) * ((size_t)d * BU + (size_t)groups * group_floats(d, db));
}

// NC = number of 128-wide output column slices per thread (1: d_b <= 128).
template <int NC, int G>
__global__ void __launch_bounds__(NT * G) sdpa_estimator_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int nu, int no, int d, int db, long long q_sb, long long q_rs,
    long long k_sb, long long k_rs, long long v_sb, long long v_rs, float scale) {
  extern __shared__ float4 smem_f4[];
  float* const qt = reinterpret_cast<float*>(smem_f4);  // [d][BU] scaled q, transposed
  const int pitch = kv_pitch(d, db);
  const int region = group_floats(d, db);
  const int g = threadIdx.x / NT;                    // this thread's group
  float* const kv = qt + d * BU + g * region;        // [BO][pitch] K, then V
  float* const ps = kv + BO * pitch;                 // [BO][P_PITCH] scores, then P
  float* const m_s = ps + BO * P_PITCH;              // [BU] running max
  float* const l_s = m_s + BU;                       // [BU] running normalizer
  float* const a_s = l_s + BU;                       // [BU] exp(m_old - m_new)

  const int tid = threadIdx.x % NT, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * BU;
  const long long b = blockIdx.y;
  q += b * q_sb;
  k += b * k_sb;
  v += b * v_sb;
  out += b * nu * db;

  for (int r = threadIdx.x >> 5; r < BU; r += NW * G) {
    const int row = row0 + r;
    for (int c = lane; c < d; c += 32)
      qt[c * BU + r] = row < nu ? q[row * q_rs + c] * scale : 0.f;
  }
  if (tid < BU) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  const int rows8 = (tid / BO) * 8;  // this thread's 8 rows (scores and P·V)
  const int key = tid % BO;          // this thread's key in the score tile
  const int col = tid % BO;          // this thread's column in each 128-wide slice
  float acc[NC][8];
  bool has_col[NC];
#pragma unroll
  for (int t = 0; t < NC; ++t) {
    has_col[t] = col + 128 * t < db;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[t][i] = 0.f;
  }
  __syncthreads();  // q tile staged, m and l initialized

  for (int j0 = g * BO; j0 < no; j0 += G * BO) {
    const int nk = min(BO, no - j0);
    stage_tile(kv, k, k_rs, j0, nk, d, pitch, warp, lane);
    cp_async_wait_all();
    group_sync(g);  // the K tile is in

    if (key < nk) {  // 1. scores for rows rows8..rows8+7 against one key
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) s[i] = 0.f;
      const float* kr = kv + key * pitch;
#pragma unroll 8
      for (int c = 0; c < d; ++c) {
        const float kc = kr[c];
        const float4 qa = *reinterpret_cast<const float4*>(qt + c * BU + rows8);
        const float4 qb = *reinterpret_cast<const float4*>(qt + c * BU + rows8 + 4);
        s[0] = fmaf(qa.x, kc, s[0]);
        s[1] = fmaf(qa.y, kc, s[1]);
        s[2] = fmaf(qa.z, kc, s[2]);
        s[3] = fmaf(qa.w, kc, s[3]);
        s[4] = fmaf(qb.x, kc, s[4]);
        s[5] = fmaf(qb.y, kc, s[5]);
        s[6] = fmaf(qb.z, kc, s[6]);
        s[7] = fmaf(qb.w, kc, s[7]);
      }
      float4* dst = reinterpret_cast<float4*>(ps + key * P_PITCH + rows8);
      dst[0] = make_float4(s[0], s[1], s[2], s[3]);
      dst[1] = make_float4(s[4], s[5], s[6], s[7]);
    }
    group_sync(g);  // the score tile is complete and K is no longer read

    // 2a. start staging V over K
    stage_tile(kv, v, v_rs, j0, nk, db, pitch, warp, lane);
    // 2b. online softmax, BU / NW rows per warp
    for (int r = warp * (BU / NW); r < (warp + 1) * (BU / NW); ++r) {
      float mx = -INFINITY;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, ps[j * P_PITCH + r]);
      mx = warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(ps[j * P_PITCH + r] - m_new);
        ps[j * P_PITCH + r] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the group's first tile
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        a_s[r] = alpha;
      }
    }
    cp_async_wait_all();
    group_sync(g);  // V is in; P and alpha are complete

    // 3. acc = acc * alpha + P·V for rows rows8..rows8+7
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = a_s[rows8 + i];
#pragma unroll
      for (int t = 0; t < NC; ++t) acc[t][i] *= alpha;
    }
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + j * P_PITCH + rows8);
      const float4 pb = *reinterpret_cast<const float4*>(ps + j * P_PITCH + rows8 + 4);
#pragma unroll
      for (int t = 0; t < NC; ++t) {
        if (has_col[t]) {
          const float vv = kv[j * pitch + col + 128 * t];
          acc[t][0] = fmaf(pa.x, vv, acc[t][0]);
          acc[t][1] = fmaf(pa.y, vv, acc[t][1]);
          acc[t][2] = fmaf(pa.z, vv, acc[t][2]);
          acc[t][3] = fmaf(pa.w, vv, acc[t][3]);
          acc[t][4] = fmaf(pb.x, vv, acc[t][4]);
          acc[t][5] = fmaf(pb.y, vv, acc[t][5]);
          acc[t][6] = fmaf(pb.z, vv, acc[t][6]);
          acc[t][7] = fmaf(pb.w, vv, acc[t][7]);
        }
      }
    }
    group_sync(g);  // P·V is done with the tile buffer
  }

  // Merge the groups: group h > 0 parks its accumulator in its idle tile
  // buffer as [BU][d_b]; group 0 rescales every part to the common max. A
  // group that had no tile (N_o <= h·BO) has m = -inf and weighs 0.
  if (G > 1) {
    __syncthreads();
    if (g > 0) {
#pragma unroll
      for (int t = 0; t < NC; ++t)
        if (has_col[t])
#pragma unroll
          for (int i = 0; i < 8; ++i) kv[(rows8 + i) * db + col + 128 * t] = acc[t][i];
    }
    __syncthreads();
    if (g > 0) return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = rows8 + i;
    float m = m_s[r];
    for (int h = 1; h < G; ++h) m = fmaxf(m, m_s[h * region + r]);
    const float w0 = expf(m_s[r] - m);
    float l = l_s[r] * w0;
    float part[NC];
#pragma unroll
    for (int t = 0; t < NC; ++t) part[t] = acc[t][i] * w0;
    for (int h = 1; h < G; ++h) {
      const float w = expf(m_s[h * region + r] - m);
      l += l_s[h * region + r] * w;
#pragma unroll
      for (int t = 0; t < NC; ++t)
        if (has_col[t]) part[t] += kv[h * region + r * db + col + 128 * t] * w;
    }
    const int row = row0 + r;
    if (row >= nu) continue;
#pragma unroll
    for (int t = 0; t < NC; ++t)
      if (has_col[t]) out[(long long)row * db + col + 128 * t] = part[t] / l;
  }
}

template <int NC, int G>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int batch,
                   int nu, int no, int d, int db, long long q_sb, long long q_rs,
                   long long k_sb, long long k_rs, long long v_sb, long long v_rs,
                   float scale, size_t smem, int optin, cudaStream_t stream) {
  // Opt in once (per process, on the first device launched on) to all the
  // dynamic shared memory a block may use (227 KB on an H100).
  static const cudaError_t opted = cudaFuncSetAttribute(
      sdpa_estimator_kernel<NC, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (opted != cudaSuccess) return opted;
  const dim3 grid((nu + BU - 1) / BU, batch);
  sdpa_estimator_kernel<NC, G><<<grid, NT * G, smem, stream>>>(
      q, k, v, out, nu, no, d, db, q_sb, q_rs, k_sb, k_rs, v_sb, v_rs, scale);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers to
// f32 data whose last dimension is contiguous; *_sb / *_rs are the batch
// and row strides in elements (a batch stride of 0 broadcasts one matrix
// over the batch). out is (B, N_u, d_b) contiguous. Returns the launch's
// cudaError_t; launches on `stream` and does not synchronize.
extern "C" int sdpa_estimator_f32(const float* q, const float* k, const float* v, float* out,
                                  int batch, int nu, int no, int d, int db, long long q_sb,
                                  long long q_rs, long long k_sb, long long k_rs,
                                  long long v_sb, long long v_rs, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || nu < 0 || no < 1 || d < 1 || d > MAX_D || db < 1 ||
      db > MAX_D)
    return (int)cudaErrorInvalidValue;
  if (nu == 0) return (int)cudaSuccess;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  // Two groups only when the grid leaves SMs idle (B=1 serving launches:
  // 64 blocks) and both tile buffers fit (max(d, d_b) up to about 192 on an
  // H100). A grid that fills the card runs faster with one group: half the
  // shared memory, so two blocks share an SM.
  const long long blocks = (long long)((nu + BU - 1) / BU) * batch;
  const int groups = blocks < sms && smem_bytes(d, db, 2) <= (size_t)optin ? 2 : 1;
  const size_t smem = smem_bytes(d, db, groups);
  auto st = static_cast<cudaStream_t>(stream);
  if (db <= 128 && groups == 2)
    e = launch<1, 2>(q, k, v, out, batch, nu, no, d, db, q_sb, q_rs, k_sb, k_rs, v_sb, v_rs,
                     scale, smem, optin, st);
  else if (db <= 128)
    e = launch<1, 1>(q, k, v, out, batch, nu, no, d, db, q_sb, q_rs, k_sb, k_rs, v_sb, v_rs,
                     scale, smem, optin, st);
  else if (groups == 2)
    e = launch<2, 2>(q, k, v, out, batch, nu, no, d, db, q_sb, q_rs, k_sb, k_rs, v_sb, v_rs,
                     scale, smem, optin, st);
  else
    e = launch<2, 1>(q, k, v, out, batch, nu, no, d, db, q_sb, q_rs, k_sb, k_rs, v_sb, v_rs,
                     scale, smem, optin, st);
  return (int)e;
}
