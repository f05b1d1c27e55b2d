// GQA flash-decode attention for Hopper (sm_90a), float32 arithmetic:
//
//   out[b, h] = softmax(q[b, h] · K[b, h / G]ᵀ / sqrt(dh), over valid keys) · V[b, h / G]
//   q (B, H, dh) f32; K, V (B, Hkv, S, dh) f32 or bf16, any batch / head /
//   seq strides; len (B,) int32 or all S; kpos (B, S) and qpos (B,) int32
//   or none -> out (B, H, dh) f32; G = H / Hkv
//   key l of sequence b is valid when l < len[b] and, with positions,
//   kpos[b, l] > 0 and kpos[b, l] - 1 <= qpos[b], and, with a sliding
//   window w >= 1, qpos[b] - (kpos[b, l] - 1) < w
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py::_decode_kernel (launched by
// decode_attention_padded). It computes what that kernel computes: one query
// token per sequence, the G query heads of a group against their kv head, q
// pre-scaled by 1/sqrt(dh) in f32 (times log2(e): see item 4 below), an
// online softmax (running max m, normalizer l, accumulator acc, all f32)
// over tiles of the cache. It is not
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
// -1e30, as in the reference. A tile, a warp's keys or a key range with no
// valid key leaves m = -1e30 and weighs its keys exp(0) = 1; the first
// valid key sets m to a real score, and alpha = exp(-1e30 - m) = 0 then
// clears them from l and acc, and every merge weighs such a part
// exp(-1e30 - m) = 0. Every row needs one valid key: the zoo's current
// token's slot always is.
//
// What bounds it on an H100. Each cache element is read once: the bytes are
// 2 * B * Hkv * len * dh * sizeof(cache); the work is 4 * G * dh FLOP a key
// of a kv head, so a cache byte carries G FLOP in bf16 (G / 2 in f32): at
// G = 3, 3 FLOP a byte against the 20 a byte that 67 TFLOP/s of f32 FMA
// over 3.35 TB/s allow. Memory bounds it: at B = 8, Hkv = 8, 32768 keys,
// dh = 128 in bf16 the cache is 1 GiB, 0.3206 ms. G = 16 in bf16 (16 FLOP a
// byte) sits near the line. At the zoo's decode step (B = 4, Hkv = 8,
// S = 48) the cache is 0.4 MB, 0.1 us: a launch's fixed cost and one
// round trip to memory are the time. So the design keeps the memory busy
// and the path to the first tile short, and keeps the arithmetic off the
// critical path; it stays f32 FMA on the CUDA cores (no tensor cores: they
// would not move a memory bound, and a bf16 q would miss the f32 reference
// at 2e-5).
//
// Design. A grid of (Hkv x head blocks, ranges, B) blocks of 1-4 warps.
// The plan (ops.py::launch_plan, cached per shape and SM count) cuts each
// sequence's cache into ranges of range_keys keys: one range on a short
// cache, and on a long one the cut whose launch takes the fewest waves of
// blocks times tiles a warp (resident blocks counted by shared memory,
// threads and this build's registers). A range that starts at or past
// len[b] exits at once and the merge skips it; with per-sequence lengths
// the plan asks for several waves, so that the block scheduler balances
// ragged lengths by itself. The kv heads of one range
// are neighbouring blocks: they read neighbouring 16-byte runs of the same
// cache rows.
//   1. Keys split across warps. A range's tiles of KT = 16 keys go to its
//      warps in turn (tile i to warp i mod warps). Each warp runs its own
//      online softmax over its own tiles, with (m, l, acc) of the block's
//      heads in registers; its scores stay in registers, reduced by warp
//      shuffles. Steady state has no block barrier: a warp waits only for
//      its own copies (cp.async.wait_group + __syncwarp). The block merges
//      its warps' (m, l, acc) once, at the end, through shared memory and
//      one __syncthreads, then writes the output or parks the range's
//      (acc, m, l) for a second, small merge kernel.
//   2. A copy ring, STAGES = 3 tiles deep per warp: 16-byte cp.async
//      copies of K and V rows (and 4-byte copies of the tile's kpos), one
//      commit group per tile, so tiles j+1 and j+2 are in flight while
//      tile j computes. At dh = 128 in bf16 a stage is 8.5 KB; four
//      warps and two blocks an SM keep about 135 KB requested ahead of use,
//      against the ~20 KB that 3.35 TB/s times ~0.8 us of latency over 132
//      SMs needs. The first tiles are issued before q is read; q is loaded,
//      scaled and stored while they are in flight, so a one-tile launch
//      pays one round trip to memory.
//   3. 16-byte shared-memory loads throughout. Scores: two lanes a key,
//      each taking every other 16-byte chunk of the row against q (f32,
//      shared, read as float4), joined by one shuffle. P·V: lanes split into
//      key groups of CL lanes, each lane owning one 16-byte chunk of V (two
//      for f32 rows over 128 wide): 8 contiguous columns of acc for each
//      head; P comes from the score lanes by shuffle; bf16 pairs convert
//      with __bfloat1622float2. Staged rows are an odd number of 16 bytes
//      apart, so a quarter-warp's rows fall in distinct banks.
//   4. No per-head branch and no divergent shuffle in the tile loop. A block
//      holds G = 1, 2, 3 (phi4-mini), 4 or 8 heads as a template constant;
//      other groups are padded with zero q rows, and a group of 9-16 takes
//      two blocks of 8 (each reads the kv head's cache; 16 heads' acc would
//      not fit in registers). The warp index is read through a shuffle, so
//      the compiler knows it and the tile loops are warp-uniform: the
//      shuffles in them compile to plain SHFL, not to code for divergent
//      lanes. Scores are in log2 units (q carries log2(e) / sqrt(dh),
//      rounded once to f32), so every exponential is one exp2f.
//   5. Shared memory: q (G * dh floats) and, per warp, STAGES stages of
//      K and V tiles and kpos. 104 KB at dh = 128 in bf16 with 4 warps and
//      3 stages (two blocks an SM); dh = 256 in f32 fits with 2 warps.
//      __launch_bounds__(128, 1) leaves ptxas room: no instantiation spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 16;              // keys a warp's tile: two score lanes a key
constexpr int MAX_WARPS = 4;        // warps a block
constexpr int STAGES = 3;           // copy ring depth a warp
constexpr int MAX_DH = 256;         // widest head
constexpr int MAX_G = 16;           // most query heads per kv head
constexpr int BLOCK_G = 8;          // most query heads a block holds: G = 16 takes two blocks
constexpr int MERGE_THREADS = 64;   // the range merge: one float4 of a row each (dh <= 256)
constexpr size_t MAX_SMEM = 232448; // dynamic shared memory a block may opt in to (H100)
constexpr float NEG = -1e30f;       // the reference's masked score
constexpr unsigned FULL = 0xffffffffu;
static_assert(KT == 16, "the score phase puts a key on lanes l and l + 16");

// bytes of one staged K or V row: an odd number of 16-byte chunks, so the
// 8 rows a quarter-warp reads at one chunk lie in 8 distinct bank groups
__host__ __device__ inline int row_pitch(int dh, int elem) { return ((dh * elem / 16) | 1) * 16; }

// one ring stage of a warp: a K tile, a V tile, the tile's kpos
__host__ __device__ inline size_t stage_bytes(int dh, int elem) {
  return 2 * (size_t)KT * row_pitch(dh, elem) + KT * sizeof(int);
}

// the query heads a block holds for a group of g: g itself up to 4 (phi4-mini
// has 3), else 8; a group of more than 8 heads takes head_blocks(g) blocks
__host__ __device__ inline int padded_group(int g) { return g <= 4 ? g : BLOCK_G; }
__host__ __device__ inline int head_blocks(int g) { return (g + BLOCK_G - 1) / BLOCK_G; }

// dynamic shared memory of a block for a group of g heads: q (padded_group(g)
// * dh floats), then each warp's ring
__host__ __device__ inline size_t smem_bytes(int dh, int elem, int g, int warps) {
  return (size_t)padded_group(g) * dh * sizeof(float) +
         (size_t)warps * STAGES * stage_bytes(dh, elem);
}

// 16 bytes of a staged row as f32
template <typename T>
struct Chunk;

template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static __forceinline__ void load(const char* p, float* f) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    f[0] = u.x;
    f[1] = u.y;
    f[2] = u.z;
    f[3] = u.w;
  }
};

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static __forceinline__ void load(const char* p, float* f) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// G: the query heads a block holds (1, 2, 3, 4 or 8); a block with g_n < G
// heads is padded with zero q rows, so the hot loops carry no per-head
// guard, and only the g_n real heads are written.
template <typename T, int G>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1) decode_attention_kernel(
    const float* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, const int* __restrict__ kpos, const int* __restrict__ qpos,
    float* __restrict__ out, float* __restrict__ part_acc, float* __restrict__ part_ml, int h,
    int hkv, int s, int dh, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, int range_keys, int window, float scale) {
  using C = Chunk<T>;
  constexpr int E = C::E;  // elements a 16-byte chunk
  extern __shared__ float4 smem_f4[];
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  // the warp index, read through a shuffle so that the compiler knows it is
  // warp-uniform: the tile loops around the shuffles are then convergent
  const int warp = __shfl_sync(FULL, (int)threadIdx.x >> 5, 0);
  // blocks of one range side by side: kv head, then its head block
  const int hb_n = head_blocks(h / hkv), kvh = blockIdx.x / hb_n, hb = blockIdx.x % hb_n;
  const int range = blockIdx.y;
  const long long b = blockIdx.z;
  const int len = lengths ? min(lengths[b], s) : s;
  const int r_begin = range * range_keys;
  if (r_begin >= len) return;  // no key here: the merge skips this range
  const int r_end = min(len, r_begin + range_keys);
  const int g_n = min(G, h / hkv - hb * G);  // this block's real heads
  const long long head0 = b * h + (long long)kvh * (h / hkv) + hb * G;  // its first head
  const int q_at = kpos ? qpos[b] : 0;                   // the query's position
  const int nch = dh * (int)sizeof(T) / 16;              // 16-byte chunks a row
  const bool wide = nch > 32;                            // f32 rows over 128 wide: 2 chunks a lane
  const int pitch = row_pitch(dh, sizeof(T));
  const int stage = (int)stage_bytes(dh, sizeof(T));
  float* const qs = reinterpret_cast<float*>(smem_f4);  // [G][dh], scaled, padded with zeros
  char* const rings = reinterpret_cast<char*>(smem_f4) + (size_t)G * dh * sizeof(float);
  char* const ring = rings + (size_t)warp * STAGES * stage;
  const T* const kb = k + b * k_sb + kvh * k_sh;
  const T* const vb = v + b * v_sb + kvh * v_sh;
  const int* const kpb = kpos ? kpos + b * s : nullptr;
  const int n_tiles = (r_end - r_begin + KT - 1) / KT;
  const int my_tiles = warp < n_tiles ? (n_tiles - warp + nw - 1) / nw : 0;
  // Row roles, for the copies and for P·V: key group kg of kg_n takes rows
  // kg, kg + kg_n, ...; in a row, lane c of cl takes chunk c (and c + 32).
  const int cl = nch >= 32 ? 32 : 1 << (32 - __clz(nch - 1));
  const int kg_n = 32 / cl, kg = lane / cl, c = lane % cl;
  const bool has_c = c < nch;

  auto issue = [&](int t) {  // this warp's t-th tile into ring slot t % STAGES
    const int k0 = r_begin + (warp + t * nw) * KT;
    const int nk = min(KT, r_end - k0);
    char* dst = ring + (t % STAGES) * stage + kg * pitch + c * 16;
    const T* ksrc = kb + (k0 + kg) * k_ss + c * E;
    const T* vsrc = vb + (k0 + kg) * v_ss + c * E;
    if (has_c) {
      for (int row = kg; row < nk; row += kg_n) {
        cp_async16(dst, ksrc);
        cp_async16(dst + KT * pitch, vsrc);
        if (wide && c + 32 < nch) {
          cp_async16(dst + 512, ksrc + 32 * E);
          cp_async16(dst + KT * pitch + 512, vsrc + 32 * E);
        }
        dst += kg_n * pitch;
        ksrc += kg_n * k_ss;
        vsrc += kg_n * v_ss;
      }
    }
    if (kpb && lane < nk)
      cp_async4(ring + (t % STAGES) * stage + 2 * KT * pitch + lane * 4, kpb + k0 + lane);
  };

  // The ring's first tiles go out before q is read; one group each, empty
  // or not, so that the count of groups stays uniform.
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < my_tiles) issue(t);
    cp_async_commit();
  }
  const float4* const q4 = reinterpret_cast<const float4*>(q + head0 * dh);
  float4* const qs4 = reinterpret_cast<float4*>(qs);
  for (int i = threadIdx.x; i < G * dh / 4; i += blockDim.x) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < g_n * dh / 4) {
      x = q4[i];
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    qs4[i] = x;
  }
  __syncthreads();  // q is staged: the only block barrier before the merge

  float m[G], l[G], acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }
  // score roles: key `key` of the tile, chunks half, half + 2, ...
  const int key = lane & (KT - 1), half = lane >> 4;

  for (int t = 0; t < my_tiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t are in
    __syncwarp();  // tile t is in for the whole warp; slot (t - 1) % STAGES is free
    if (t + STAGES - 1 < my_tiles) issue(t + STAGES - 1);
    cp_async_commit();
    const int k0 = r_begin + (warp + t * nw) * KT;
    const int nk = min(KT, r_end - k0);
    const char* const slot = ring + (t % STAGES) * stage;

    // scores (log2 units: q carries log2(e)) of this lane's key against the
    // G heads, half of the chunks
    float sc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g] = 0.f;
    const bool live = key < nk;
    if (live) {
      const char* const kr = slot + key * pitch;
#pragma unroll 2
      for (int ch = half; ch < nch; ch += 2) {
        float kf[E];
        C::load(kr + ch * 16, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4* const qg = reinterpret_cast<const float4*>(qs + g * dh + ch * E);
#pragma unroll
          for (int i = 0; i < E / 4; ++i) {
            const float4 qq = qg[i];
            sc[g] = fmaf(qq.x, kf[4 * i], sc[g]);
            sc[g] = fmaf(qq.y, kf[4 * i + 1], sc[g]);
            sc[g] = fmaf(qq.z, kf[4 * i + 2], sc[g]);
            sc[g] = fmaf(qq.w, kf[4 * i + 3], sc[g]);
          }
        }
      }
    }
    bool valid = live;
    if (kpb && live) {
      const int kp = reinterpret_cast<const int*>(slot + 2 * KT * pitch)[key];
      valid = kp > 0 && kp - 1 <= q_at && (window == 0 || q_at - (kp - 1) < window);
    }
    // online softmax, per head: the tile's max over its 16 keys (lanes l
    // and l + 16 hold the same score), rescale, P kept in sc
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float dot = sc[g] + __shfl_xor_sync(FULL, sc[g], 16);
      const float x = valid ? dot : NEG;
      float mx = x;
#pragma unroll
      for (int o = 1; o < KT; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[g], mx);
      const float alpha = exp2f(m[g] - m_new);  // 0 once a real score replaces -1e30
      sc[g] = live ? exp2f(x - m_new) : 0.f;
      l[g] = fmaf(l[g], alpha, sc[g]);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
    }
    // acc += P·V: key group kg takes keys kg, kg + kg_n, ...
#pragma unroll 2
    for (int j0 = 0; j0 < nk; j0 += kg_n) {
      const int j = j0 + kg;
      float vf[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) vf[e] = 0.f;
      if (j < nk && has_c) {
        const char* const vr = slot + (KT + j) * pitch + c * 16;
        C::load(vr, vf);
        if (E == 4 && wide && c + 32 < nch) C::load(vr + 512, vf + 4);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = __shfl_sync(FULL, sc[g], j & (KT - 1));
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        if (E == 8 || wide) {
#pragma unroll
          for (int e = 4; e < 8; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();  // only empty groups can be left

  // Join the key groups' acc and the 16 score lanes' l.
#pragma unroll
  for (int g = 0; g < G; ++g) {
    for (int o = cl; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(FULL, acc[g][e], o);
    }
#pragma unroll
    for (int o = 1; o < KT; o <<= 1) l[g] += __shfl_xor_sync(FULL, l[g], o);
  }
  __syncwarp();  // every lane is done with the ring: it now holds the warp's part

  // The warp's (acc, m, l) into its own ring: acc [g_n][dh], then m [G], l [G].
  float* const wacc = reinterpret_cast<float*>(ring);
  float* const wml = wacc + g_n * dh;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g < g_n && kg == 0 && has_c) {
      float4* const row = reinterpret_cast<float4*>(wacc + g * dh);
      row[c * (E / 4)] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      if (E == 8) row[c * 2 + 1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
      if (E == 4 && wide && c + 32 < nch)
        row[c + 32] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
    if (g < g_n && lane == 0) {
      wml[g] = m[g];
      wml[G + g] = l[g];
    }
  }
  __syncthreads();  // every warp's part is in

  // Merge the warps: rescale each to the common max. Then write the output
  // (one range) or park the range's (acc, m, l) for the range merge.
  const int n4 = dh / 4, splits = gridDim.y;
  const size_t warp_stride = (size_t)STAGES * stage;
  for (int i = threadIdx.x; i < g_n * n4; i += blockDim.x) {
    const int g = i / n4, c4 = i - g * n4;
    float mt = NEG;
    for (int w = 0; w < nw; ++w) {
      const float* const ml = reinterpret_cast<const float*>(rings + w * warp_stride) + g_n * dh;
      mt = fmaxf(mt, ml[g]);
    }
    float lt = 0.f;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      const float* const wa = reinterpret_cast<const float*>(rings + w * warp_stride);
      const float* const ml = wa + g_n * dh;
      const float wt = exp2f(ml[g] - mt);
      lt = fmaf(ml[G + g], wt, lt);
      const float4 x = reinterpret_cast<const float4*>(wa + g * dh)[c4];
      a.x = fmaf(x.x, wt, a.x);
      a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z);
      a.w = fmaf(x.w, wt, a.w);
    }
    const long long row = head0 + g;
    if (part_acc == nullptr) {
      reinterpret_cast<float4*>(out)[row * n4 + c4] =
          make_float4(a.x / lt, a.y / lt, a.z / lt, a.w / lt);
    } else {
      const long long prow = row * splits + range;
      reinterpret_cast<float4*>(part_acc)[prow * n4 + c4] = a;
      if (c4 == 0) {
        part_ml[2 * prow] = mt;
        part_ml[2 * prow + 1] = lt;
      }
    }
  }
}

// Merge the ranges of one (b, head): rescale each to the common max. Ranges
// at or past len[b] never ran and are skipped; a range whose keys were all
// masked parked m = -1e30 and weighs exp(-1e30 - m) = 0 against any range
// with a valid key.
__global__ void __launch_bounds__(MERGE_THREADS) decode_attention_merge(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ lengths, float* __restrict__ out, int h, int s, int dh, int splits,
    int range_keys) {
  const long long b = blockIdx.y, row = b * h + blockIdx.x;
  const int len = lengths ? min(lengths[b], s) : s;
  const int active = min(splits, (len + range_keys - 1) / range_keys);
  const float* const ml = part_ml + 2 * row * splits;
  float m = NEG;
  for (int r = 0; r < active; ++r) m = fmaxf(m, ml[2 * r]);
  float l = 0.f;
  for (int r = 0; r < active; ++r) l = fmaf(ml[2 * r + 1], exp2f(ml[2 * r] - m), l);
  const int n4 = dh / 4;
  const float4* const pa = reinterpret_cast<const float4*>(part_acc) + row * splits * n4;
  for (int c4 = threadIdx.x; c4 < n4; c4 += MERGE_THREADS) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < active; ++r) {
      const float wt = exp2f(ml[2 * r] - m);
      const float4 x = pa[r * n4 + c4];
      a.x = fmaf(x.x, wt, a.x);
      a.y = fmaf(x.y, wt, a.y);
      a.z = fmaf(x.z, wt, a.z);
      a.w = fmaf(x.w, wt, a.w);
    }
    reinterpret_cast<float4*>(out)[row * n4 + c4] = make_float4(a.x / l, a.y / l, a.z / l, a.w / l);
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
  int splits, range_keys, warps;
  int window;  // 0: no sliding window
  float scale;
};

template <typename T, int G>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  // Opt in once per instantiation (on the first device launched on) to the
  // most dynamic shared memory a block may use: no device query per call.
  static const cudaError_t opted = cudaFuncSetAttribute(
      decode_attention_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (opted != cudaSuccess) return opted;
  const size_t smem = smem_bytes(a.dh, sizeof(T), a.h / a.hkv, a.warps);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(a.hkv * head_blocks(a.h / a.hkv), a.splits, a.b);
  const bool merge = a.splits > 1;
  decode_attention_kernel<T, G><<<grid, 32 * a.warps, smem, stream>>>(
      a.q, static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths, a.kpos, a.qpos,
      a.out, merge ? a.part_acc : nullptr, a.part_ml, a.h, a.hkv, a.s, a.dh, a.k_sb, a.k_sh,
      a.k_ss, a.v_sb, a.v_sh, a.v_ss, a.range_keys, a.window, a.scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || !merge) return e;
  decode_attention_merge<<<dim3(a.h, a.b), MERGE_THREADS, 0, stream>>>(
      a.part_acc, a.part_ml, a.lengths, a.out, a.h, a.s, a.dh, a.splits, a.range_keys);
  return cudaGetLastError();
}

template <typename T>
int run(const Args& a, void* stream) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned = (uintptr_t)a.k % 16 == 0 && (uintptr_t)a.v % 16 == 0 &&
                       a.k_sb % E == 0 && a.k_sh % E == 0 && a.k_ss % E == 0 &&
                       a.v_sb % E == 0 && a.v_sh % E == 0 && a.v_ss % E == 0;
  const bool plan_ok = a.splits >= 1 && a.range_keys >= KT && a.range_keys % KT == 0 &&
                       (long long)(a.splits - 1) * a.range_keys < a.s &&
                       (long long)a.splits * a.range_keys >= a.s && a.warps >= 1 &&
                       a.warps <= MAX_WARPS;
  if (a.b < 1 || a.b > 65535 || a.hkv < 1 || a.hkv > 65535 || a.h % a.hkv != 0 ||
      a.h / a.hkv > MAX_G || a.s < 1 || a.dh < 1 || a.dh > MAX_DH || a.dh % E != 0 ||
      a.splits > 65535 || !aligned || !plan_ok || (a.splits > 1 && (!a.part_acc || !a.part_ml)) ||
      (a.kpos == nullptr) != (a.qpos == nullptr) || a.window < 0 || (a.window > 0 && !a.kpos))
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  switch (padded_group(a.h / a.hkv)) {
    case 1: return (int)launch<T, 1>(a, st);
    case 2: return (int)launch<T, 2>(a, st);
    case 3: return (int)launch<T, 3>(a, st);
    case 4: return (int)launch<T, 4>(a, st);
    default: return (int)launch<T, BLOCK_G>(a, st);
  }
}

template <typename T, int G>
int registers_of() {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, decode_attention_kernel<T, G>);
  return e == cudaSuccess ? attr.numRegs : -(int)e;
}

template <typename T>
int registers(int g) {
  switch (padded_group(g)) {
    case 1: return registers_of<T, 1>();
    case 2: return registers_of<T, 2>();
    case 3: return registers_of<T, 3>();
    case 4: return registers_of<T, 4>();
    default: return registers_of<T, BLOCK_G>();
  }
}

}  // namespace

// The kernel's geometry, which ops.py's launch plan also counts with and
// checks against this once when it loads the library: out = {KT, MAX_WARPS,
// STAGES, MAX_G, MAX_DH, dynamic shared memory of a block at (dh, elem
// bytes, G, warps)}.
extern "C" void decode_attention_geometry(int dh, int elem, int g, int warps, long long* out) {
  const long long geo[6] = {KT, MAX_WARPS, STAGES, MAX_G, MAX_DH,
                            (long long)smem_bytes(dh, elem, g, warps)};
  for (int i = 0; i < 6; ++i) out[i] = geo[i];
}

// The registers a thread of the instantiation for a cache of `elem` bytes
// and a group of g heads uses (with shared memory and threads, they bound
// the blocks an SM holds), or -cudaError_t. ops.py reads them once, when it
// loads the library.
extern "C" int decode_attention_registers(int elem, int g) {
  return elem == 2 ? registers<__nv_bfloat16>(g) : registers<float>(g);
}

// Plain C entry points, loaded with ctypes: decode_attention_<cache type>.
// q is (B, H, dh) f32 contiguous, out (B, H, dh) f32 contiguous; the caches
// are (B, Hkv, S, dh) with dh contiguous and batch / head / seq strides in
// elements (multiples of 16 bytes, 16-byte aligned bases). lengths is (B,)
// int32 or null (all S valid); kpos (B, S) and qpos (B,) int32 contiguous,
// both or neither (no position mask); `window` >= 1 adds the sliding
// window's term to the position mask (kpos required), 0 means none. The
// plan: `splits` key ranges of `range_keys` keys (a multiple of 16; every
// range holds a key of S), one block of `warps` warps each. q is multiplied
// by `scale` = log2(e) / sqrt(dh). With splits > 1, part_acc (B·H·splits·dh)
// and part_ml (B·H·splits·2) f32 are the merge's scratch. Returns the
// launches' cudaError_t; launches on `stream`, does not synchronize and
// makes no device query.
#define DECODE_ATTENTION_ENTRY(NAME, T)                                                          \
  extern "C" int NAME(const float* q, const void* k, const void* v, const int* lengths,         \
                      const int* kpos, const int* qpos, float* out, float* part_acc,            \
                      float* part_ml, int b, int h, int hkv, int s, int dh, long long k_sb,     \
                      long long k_sh, long long k_ss, long long v_sb, long long v_sh,           \
                      long long v_ss, int splits, int range_keys, int warps, int window,        \
                      float scale, void* stream) {                                              \
    const Args a{q,    k,    v,    lengths, kpos,   qpos,       out,   part_acc, part_ml,      \
                 b,    h,    hkv,  s,       dh,     k_sb,       k_sh,  k_ss,     v_sb,         \
                 v_sh, v_ss, splits, range_keys, warps, window, scale};                          \
    return run<T>(a, stream);                                                                   \
  }

DECODE_ATTENTION_ENTRY(decode_attention_f32, float)
DECODE_ATTENTION_ENTRY(decode_attention_bf16, __nv_bfloat16)
