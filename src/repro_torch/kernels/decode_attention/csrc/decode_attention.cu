// GQA flash-decode attention for Hopper (sm_90a), float32 arithmetic:
//
//   out[b, h] = softmax(q[b, h] · K[b, h / G]ᵀ / sqrt(dh), over valid keys) · V[b, h / G]
//   q (B, H, dh) f32; K, V (B, Hkv, S, dh) f32 or bf16, any batch / head /
//   seq strides; len (B,) int32 or all S; kpos (B, S) and qpos (B,) int32
//   or none -> out (B, H, dh) f32; G = H / Hkv
//   key l of sequence b is valid when l < len[b] and, with positions,
//   kpos[b, l] > 0 and kpos[b, l] - 1 <= qpos[b]
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::_decode_kernel (launched by
// decode_attention_padded). It computes what that kernel computes: one query
// token per sequence, the G query heads of a group against their kv head, q
// pre-scaled by 1/sqrt(dh) in f32, an online softmax (running max m,
// normalizer l, accumulator acc, all f32) over tiles of the cache. It is not
// a block-by-block copy: the TPU kernel pads G to 8 sublanes, dh to 128
// lanes and S to its block and masks columns >= one static s_valid to -1e30
// for the whole batch; here the cache is read in place through its strides
// (the model zoo's (B, S, Hkv, dh) layout needs no transpose), and each
// sequence's own length bounds its loop. Keys at or past len[b] are never
// read: in the reference they score -1e30 and weigh exp(-1e30 - m) = 0
// exactly, so leaving them out changes no sum. len[b] must be >= 1.
//
// The position mask is the model zoo's decode mask
// (src/repro/models/layers.py::attention_apply): each slot is held to its
// own stored position (+1, 0 for an empty slot), so the valid slots need
// not be a prefix. A key that fails it is read like any other and scores
// -1e30, as in the reference. A tile, or a split's whole range, with no
// valid key leaves m = -1e30 and weighs its keys exp(0) = 1; the first
// valid key sets m to a real score, and alpha = exp(-1e30 - m) = 0 then
// clears them from l and acc (and the merge weighs such a range
// exp(-1e30 - m) = 0). Every row needs one valid key: the zoo's current
// token's slot always is.
//
// Design. A 3-D grid of (splits, Hkv, B) blocks of 128 threads. The TPU
// kernel's sequential cache axis is the loop inside a block; when B * Hkv
// blocks would leave most of the 132 SMs idle (long caches at small batch),
// the cache is cut into `splits` contiguous ranges, one block each, and a
// second small kernel merges the ranges' (m, l, acc). Per tile of 64 keys a
// block
//   1. stages K and V with 16-byte cp.async copies (V's overlap step 2);
//   2. scores: two threads per key, each summing half of the dh products
//      for all G heads of the group from the staged q (the G heads share
//      each staged K row), joined by one shuffle;
//   3. online softmax, one warp per head;
//   4. rescales and accumulates P·V, each thread owning one or two of the dh
//      columns for all G heads, four keys at a time.
// Shared memory is about 37 KB at dh = 128 in bf16 (K and V tiles with a
// 32-byte row pad against bank conflicts, q, scores), so several blocks
// share an SM. Arithmetic is plain f32 FMA, no tensor cores: a decode step's
// work is a few FLOP per cache byte.
//
// What bounds it on an H100. Each cache element is read once: the bytes are
// 2 * B * Hkv * len * dh * sizeof(cache), the work 4 * B * H * len * dh FLOP
// (G = 3 in bf16: 3 FLOP a byte, against 20 for the f32 peak / memory rate),
// so memory bounds it. At the zoo's decode step (B = 4, Hkv = 8, S = 48,
// dh = 128, bf16) that is 0.4 MB, 0.1 us: a launch's fixed cost is the time.
// At 32768 keys and B = 8 it is 1 GiB, 0.32 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int NW = NT / 32;      // warps per block
constexpr int BS = 64;           // keys per tile: two threads per key in step 2
constexpr int MAX_DH = 256;      // widest head: at most two columns a thread
constexpr int MAX_G = 16;        // most query heads per kv head
constexpr int P_PITCH = BS + 4;  // score row pitch in floats (float4-aligned)
constexpr int ROW_PAD = 32;      // bytes after each staged K/V row
constexpr float NEG = -1e30f;    // the reference's masked score
static_assert(NT == 2 * BS, "two threads per key in the score phase");
static_assert(MAX_DH <= 2 * NT, "two columns per thread in the P·V phase");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline int row_pitch(int dh, int elem) { return dh * elem + ROW_PAD; }

__host__ __device__ inline size_t smem_bytes(int dh, int elem, int gt) {
  return 2 * (size_t)BS * row_pitch(dh, elem) + sizeof(float) * ((size_t)gt * (dh + P_PITCH + 3));
}

// Copy keys [k0, k0 + nk) of one (b, kv head) slice, rows `rs` elements
// apart, into a tile of `pitch`-byte rows: 16-byte chunks, consecutive
// threads on consecutive chunks of a row.
template <typename T>
__device__ __forceinline__ void stage_tile(char* tile, const T* src, long long rs, int k0, int nk,
                                           int nch, int pitch) {
  constexpr int E = 16 / sizeof(T);
  for (int i = threadIdx.x; i < nk * nch; i += NT) {
    const int row = i / nch, ch = i - row * nch;
    cp_async16(tile + row * pitch + ch * 16, src + (k0 + row) * rs + ch * E);
  }
}

// GT: a power of two >= G, the size of the per-thread head arrays.
template <typename T, int GT>
__global__ void __launch_bounds__(NT) decode_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, const int* __restrict__ kpos, const int* __restrict__ qpos,
    float* __restrict__ out, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int h, int hkv, int s, int dh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int tiles_per_split,
    float scale) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte chunk
  extern __shared__ float4 smem_f4[];
  const int pitch = row_pitch(dh, sizeof(T));
  char* const ks = reinterpret_cast<char*>(smem_f4);  // [BS][pitch] K tile
  char* const vs = ks + BS * pitch;                   // [BS][pitch] V tile
  float* const qs = reinterpret_cast<float*>(vs + BS * pitch);  // [GT][dh] scaled q
  float* const ps = qs + GT * dh;                     // [GT][P_PITCH] scores, then P
  float* const m_s = ps + GT * P_PITCH;               // [GT] running max
  float* const l_s = m_s + GT;                        // [GT] running normalizer
  float* const a_s = l_s + GT;                        // [GT] exp(m_old - m_new)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int g_n = h / hkv;
  const long long head0 = b * h + (long long)kvh * g_n;  // first query head of the group
  const int len = lengths ? min(lengths[b], s) : s;
  const int q_at = kpos ? qpos[b] : 0;  // the query's position
  const int k_begin = split * tiles_per_split * BS;
  const int k_end = min(len, k_begin + tiles_per_split * BS);
  const T* const kb = k + b * k_sb + kvh * k_sh;
  const T* const vb = v + b * v_sb + kvh * v_sh;
  const int nch = dh / E;  // 16-byte chunks per row

  for (int i = tid; i < g_n * dh; i += NT) qs[i] = q[head0 * dh + i] * scale;
  if (tid < GT) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }
  const int key = tid >> 1, half = tid & 1;  // step 2's roles
  const bool has_col[2] = {tid < dh, tid + NT < dh};  // step 4's columns tid, tid + NT
  float acc[GT][2];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g][0] = acc[g][1] = 0.f;
  __syncthreads();  // q staged, m and l initialized

  for (int k0 = k_begin; k0 < k_end; k0 += BS) {
    const int nk = min(BS, k_end - k0);
    // 1. K, then V, in flight together
    stage_tile(ks, kb, k_ss, k0, nk, nch, pitch);
    cp_async_commit();
    stage_tile(vs, vb, v_ss, k0, nk, nch, pitch);
    cp_async_commit();
    // this thread's key's stored position, read while the tiles are in flight
    const int kp = (kpos && key < nk) ? kpos[b * s + k0 + key] : 1;
    const bool valid = kp > 0 && kp - 1 <= q_at;
    cp_async_wait<1>();
    __syncthreads();  // the K tile is in

    // 2. scores of this key against the group's G heads, half of dh each
    float sc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] = 0.f;
    if (key < nk) {
      const char* kr = ks + key * pitch;
      for (int ch = half; ch < nch; ch += 2) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr + ch * 16);
        const T* e = reinterpret_cast<const T*>(&u);
        float kf[E];
#pragma unroll
        for (int i = 0; i < E; ++i) kf[i] = to_f32(e[i]);
#pragma unroll
        for (int g = 0; g < GT; ++g) {
          if (g < g_n) {
            const float* qg = qs + g * dh + ch * E;
#pragma unroll
            for (int i = 0; i < E; i += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qg + i);
              sc[g] = fmaf(qq.x, kf[i], sc[g]);
              sc[g] = fmaf(qq.y, kf[i + 1], sc[g]);
              sc[g] = fmaf(qq.z, kf[i + 2], sc[g]);
              sc[g] = fmaf(qq.w, kf[i + 3], sc[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], 1);
    if (key < nk && half == 0) {
#pragma unroll
      for (int g = 0; g < GT; ++g)
        if (g < g_n) ps[g * P_PITCH + key] = valid ? sc[g] : NEG;
    }
    __syncthreads();  // the score tile is complete

    // 3. online softmax, one warp per head
    for (int g = warp; g < g_n; g += NW) {
      float* pr = ps + g * P_PITCH;
      float mx = NEG;
      for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = lane; j < nk; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the block's first tile
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // V is in; P and alpha are complete

    // 4. acc = acc * alpha + P·V for this thread's columns
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < g_n) {
        const float alpha = a_s[g];
        acc[g][0] *= alpha;
        acc[g][1] *= alpha;
      }
    }
    const T* vcol = reinterpret_cast<const T*>(vs) + tid;
    const int vp = pitch / (int)sizeof(T);  // row pitch in elements
    const int nk4 = nk & ~3;
    for (int j = 0; j < nk4; j += 4) {
      float vv[2][4];
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          vv[c][i] = has_col[c] ? to_f32(vcol[(j + i) * vp + c * NT]) : 0.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < g_n) {
          const float4 p = *reinterpret_cast<const float4*>(ps + g * P_PITCH + j);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            acc[g][c] = fmaf(p.x, vv[c][0], acc[g][c]);
            acc[g][c] = fmaf(p.y, vv[c][1], acc[g][c]);
            acc[g][c] = fmaf(p.z, vv[c][2], acc[g][c]);
            acc[g][c] = fmaf(p.w, vv[c][3], acc[g][c]);
          }
        }
      }
    }
    for (int j = nk4; j < nk; ++j) {
      float vv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) vv[c] = has_col[c] ? to_f32(vcol[j * vp + c * NT]) : 0.f;
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        if (g < g_n) {
          const float p = ps[g * P_PITCH + j];
          acc[g][0] = fmaf(p, vv[0], acc[g][0]);
          acc[g][1] = fmaf(p, vv[1], acc[g][1]);
        }
      }
    }
    __syncthreads();  // the tiles and P are free for the next tile
  }

  // One range: normalize and write. Several: park (acc, m, l) for the merge;
  // a range with no key left (k_begin >= len) parks m = -1e30, l = 0, acc = 0.
  const int splits = gridDim.x;
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g >= g_n) continue;
    const long long row = head0 + g;
    if (part_acc == nullptr) {
      const float inv_l = 1.f / l_s[g];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (has_col[c]) out[row * dh + tid + c * NT] = acc[g][c] * inv_l;
    } else {
      const long long prow = row * splits + split;
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (has_col[c]) part_acc[prow * dh + tid + c * NT] = acc[g][c];
      if (tid == 0) {
        part_ml[2 * prow] = m_s[g];
        part_ml[2 * prow + 1] = l_s[g];
      }
    }
  }
}

// Merge the ranges of one (b, head): rescale each to the common max. A range
// whose keys were all masked parks m = -1e30 and weighs exp(-1e30 - m) = 0
// against any range with a valid key.
__global__ void __launch_bounds__(NT) decode_attention_combine(const float* __restrict__ part_acc,
                                                               const float* __restrict__ part_ml,
                                                               float* __restrict__ out, int h,
                                                               int dh, int splits) {
  const long long row = (long long)blockIdx.y * h + blockIdx.x;
  const float* ml = part_ml + 2 * row * splits;
  float m = NEG;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < splits; ++i) l += ml[2 * i + 1] * expf(ml[2 * i] - m);
  for (int c = threadIdx.x; c < dh; c += NT) {
    float a = 0.f;
    for (int i = 0; i < splits; ++i)
      a = fmaf(part_acc[(row * splits + i) * dh + c], expf(ml[2 * i] - m), a);
    out[row * dh + c] = a / l;
  }
}

struct Args {
  const float* q;
  const void* k;
  const void* v;
  const int* lengths;
  const int* kpos;
  const int* qpos;
  float* out;
  float* part_acc;
  float* part_ml;
  int b, h, hkv, s, dh;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int splits;
  float scale;
};

template <typename T, int GT>
cudaError_t launch(const Args& a, int optin, cudaStream_t stream) {
  // Opt in once (per process, on the first device launched on) to all the
  // dynamic shared memory a block may use (227 KB on an H100).
  static const cudaError_t opted = cudaFuncSetAttribute(
      decode_attention_kernel<T, GT>, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (opted != cudaSuccess) return opted;
  const size_t smem = smem_bytes(a.dh, sizeof(T), GT);
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  const int tiles = (a.s + BS - 1) / BS;
  const int per_split = (tiles + a.splits - 1) / a.splits;
  const dim3 grid(a.splits, a.hkv, a.b);
  decode_attention_kernel<T, GT><<<grid, NT, smem, stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths, a.kpos, a.qpos,
      a.out, a.splits > 1 ? a.part_acc : nullptr, a.part_ml, a.h, a.hkv, a.s, a.dh, a.k_sb,
      a.k_sh, a.k_ss, a.v_sb, a.v_sh, a.v_ss, per_split, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.splits == 1) return e;
  decode_attention_combine<<<dim3(a.h, a.b), NT, 0, stream>>>(a.part_acc, a.part_ml, a.out, a.h,
                                                               a.dh, a.splits);
  return cudaGetLastError();
}

template <typename T>
int run(const Args& a, void* stream) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned = (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0 &&
                       a.k_sb % E == 0 && a.k_sh % E == 0 && a.k_ss % E == 0 &&
                       a.v_sb % E == 0 && a.v_sh % E == 0 && a.v_ss % E == 0;
  if (a.b < 1 || a.b > 65535 || a.hkv < 1 || a.hkv > 65535 || a.h % a.hkv != 0 ||
      a.h / a.hkv > MAX_G || a.s < 1 || a.dh < 1 || a.dh > MAX_DH || a.dh % E != 0 ||
      !aligned || a.splits < 1 || (a.splits > 1 && (!a.part_acc || !a.part_ml)) ||
      (a.kpos == nullptr) != (a.qpos == nullptr))
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  auto st = static_cast<cudaStream_t>(stream);
  const int g = a.h / a.hkv;
  if (g <= 1) return (int)launch<T, 1>(a, optin, st);
  if (g <= 2) return (int)launch<T, 2>(a, optin, st);
  if (g <= 4) return (int)launch<T, 4>(a, optin, st);
  if (g <= 8) return (int)launch<T, 8>(a, optin, st);
  return (int)launch<T, 16>(a, optin, st);
}

}  // namespace

// Plain C entry points, loaded with ctypes: decode_attention_<cache type>.
// q is (B, H, dh) f32 contiguous, out (B, H, dh) f32 contiguous; the caches
// are (B, Hkv, S, dh) with dh contiguous and batch / head / seq strides in
// elements (multiples of 16 bytes, 16-byte aligned bases). lengths is (B,)
// int32 or null (all S valid); kpos (B, S) and qpos (B,) int32 contiguous,
// both or neither (no position mask). With splits > 1, part_acc (B·H·splits·dh)
// and part_ml (B·H·splits·2) f32 are the merge's scratch. Returns the
// launches' cudaError_t; launches on `stream` and does not synchronize.
#define DECODE_ATTENTION_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const float* q, const void* k, const void* v, const int* lengths,       \
                      const int* kpos, const int* qpos, float* out, float* part_acc,          \
                      float* part_ml, int b, int h, int hkv,                                  \
                      int s, int dh, long long k_sb, long long k_sh, long long k_ss,          \
                      long long v_sb, long long v_sh, long long v_ss, int splits, float scale, \
                      void* stream) {                                                         \
    const Args a{q,    k,    v,    lengths, kpos, qpos, out,  part_acc, part_ml, b,      h,     \
                 hkv,  s,    dh,   k_sb,    k_sh, k_ss, v_sb, v_sh,     v_ss,    splits, scale}; \
    return run<T>(a, stream);                                                                 \
  }

DECODE_ATTENTION_ENTRY(decode_attention_f32, float)
DECODE_ATTENTION_ENTRY(decode_attention_bf16, __nv_bfloat16)
