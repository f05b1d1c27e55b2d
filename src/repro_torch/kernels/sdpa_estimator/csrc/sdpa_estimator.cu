// Eq. 10 SDPA estimator for Hopper (sm_90a), float32 in and out:
//
//   out[b] = softmax(q[b] · k[b]ᵀ · scale) · v[b]
//   q (B, N_u, d), k (B, N_o, d), v (B, N_o, d_b) -> out (B, N_u, d_b)
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/sdpa_estimator/kernel.py::_sdpa_kernel (launched by
// sdpa_estimate_batched_padded). It computes what that kernel computes: one
// head, no causal mask, a flash-style online softmax over N_o, with the
// scale 1/sqrt(d) of the true d applied to q in f32 before any product. It
// is not a block-by-block copy: there is no 128-lane padding and no -1e30
// padded column; the ragged edges are masked in the kernel.
//
// What bounds it on an H100. Work is 2·B·N_u·N_o·(d + d_b) FLOP. The
// products run on the tensor cores in TF32 at f32 accuracy, which takes
// three TF32 products for each one (below), so the card's least time is
// 3 · 2·B·N_u·N_o·(d + d_b) FLOP at 495 TFLOP/s (dense TF32): 6.5 us at
// the serving shape B=1, N_u=1024, N_o=2048, d=d_b=128, against 0.94 us for
// its 3.1 MB of compulsory traffic at 3.35 TB/s. Operations bound it.
//
// What the design does about that.
//  * 3xTF32 on the tensor cores. Each f32 operand x is split into
//    hi = rna(x) and lo = rna(x - hi), rounded to TF32 as cvt.rna.tf32.f32
//    rounds (nearest, ties away from zero); a product is hi·hi + hi·lo + lo·hi,
//    three mma.sync.m16n8k8 TF32 products accumulated in f32 (the lo·lo
//    term is below f32 rounding). One TF32 pass would miss the f32 tolerances by
//    two orders of magnitude. Both S = (q·scale)·kᵀ and P·v are split; the
//    scale is applied to q in f32 before the split.
//  * Short tensor-core sums. An mma's f32 accumulation does not round as an
//    IEEE add does, and its error grows with the number of products added
//    into one accumulator. So a score tile's cross terms have accumulators of
//    their own, and each key tile's P·v products are summed apart (16 x BN
//    keys, 12 mma's a column tile) and added to the running acc with one f32
//    fma, acc = alpha·acc + P·v: the error no longer grows with the range.
//  * Scores stay in registers. A block holds BM = 64 query rows, 16 a warp.
//    A warp's 16 x BN score tile lives in its mma accumulators; the online
//    softmax (row max, exp, row sum, the alpha rescale) runs there, reduced
//    over the 4 threads of a quad that share a row.
//  * P is reused as the A operand with no shuffle. The m16n8 accumulator
//    gives thread (g = lane/4, t = lane%4) key columns 2t and 2t+1; the
//    m16n8k8 A fragment wants k = t and t+4. The sum over keys does not
//    depend on their order, so key 2t is taken as k = t and key 2t+1 as
//    k = t+4, and v's B fragment is loaded to match: b0 = v[key 2t],
//    b1 = v[key 2t+1].
//  * K/V tiles of BN = 32 keys arrive by TMA (cp.async.bulk.tensor), one
//    thread issuing a stage's 32-column boxes, double-buffered on two
//    mbarriers: tile j+1 is in flight while tile j's products run, and no
//    thread spends instructions on addresses. TMA zero-fills rows past N_u
//    or N_o and columns past d or d_b, so the ragged edges need no code
//    beyond masking keys past the range to -inf. The 128-byte swizzle
//    leaves every fragment load free of bank conflicts. Inputs whose rows
//    TMA cannot address (not 16-byte aligned) are padded by the wrapper.
//  * A grid that fills the card. N_o is cut into `splits` contiguous
//    ranges of `per_tiles` tiles, one block each (ops.py::launch_plan picks
//    them from the shape, the SM count and the blocks an SM holds); each
//    range parks its unnormalized (acc, m, l) and sdpa_estimator_merge
//    rescales the ranges to their common max. One range writes the output
//    directly.
//  * d_b is taken in column chunks of up to COLS = 128, one block each,
//    so a warp's acc and its tile sum are at most 16 x 128 each (64
//    registers a thread apiece): d_b = 256 recomputes the scores once more
//    rather than spilling. __launch_bounds__ holds registers to what
//    MIN_BLOCKS blocks an SM leave; ops.py's plan counts that many.

#include <cuda.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;             // query rows per block
constexpr int BN = 32;             // keys per K/V tile
constexpr int NT = 128;            // threads per block: 4 warps x 16 rows
constexpr int NS = BN / 8;         // n-tiles of the score tile (k-steps of P·V)
constexpr int COLS = 128;          // widest d_b chunk a block accumulates
constexpr int MAX_D = 256;         // widest d and d_b
constexpr int BOX = 32;            // floats in a TMA box row: 128 bytes, the swizzle span
constexpr int MIN_BLOCKS = 2;      // blocks an SM holds by registers (__launch_bounds__)
static_assert(BM == 16 * (NT / 32), "one warp per 16 query rows");

__host__ __device__ inline int pad8(int w) { return (w + 7) & ~7; }
__host__ __device__ inline int boxes(int w) { return (w + BOX - 1) / BOX; }

// Shared memory from a 1024-byte aligned base (the 128-byte swizzle's
// period), in floats: the q tile, boxes(d) boxes of [BM][32]; two K stages
// of boxes(d) boxes of [BN][32]; two V stages of boxes(chunk) boxes of
// [BN][32]; then the two stages' mbarriers. 1024 bytes of slack align it.
__host__ __device__ inline size_t smem_bytes(int d, int db) {
  const int cw = db < COLS ? db : COLS;
  const size_t floats = (size_t)BOX * (boxes(d) * (BM + 2 * BN) + 2 * BN * boxes(cw));
  return 1024 + sizeof(float) * floats + 2 * sizeof(uint64_t);
}
const size_t MAX_SMEM = smem_bytes(MAX_D, MAX_D);  // 164880 bytes: under 227 KB

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// Thread 0's arrival on a stage's barrier, announcing the bytes TMA brings.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a (B, rows, width) tensor into shared memory, completing on `bar`.
// Rows and columns past the tensor's edges arrive as zeros.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map, int col, int row,
                                         int b, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(b), "r"(smem_u32(bar))
      : "memory");
}

// cvt.rna.tf32.f32 of a finite x: round to TF32 (10 mantissa bits) to
// nearest, ties away from zero, by adding half of the 13 dropped bits to the
// magnitude and clearing them: two integer instructions, which run faster
// in this kernel than the conversion instruction (PERF.md).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each rounded to TF32: lo = rna(x - hi) holds the next 11
// significant bits, so hi·hi + hi·lo + lo·hi misses x·y by about 2^-22 of it.
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

// c += a·b at f32 accuracy for G column tiles: B fragments (b[j][0], b[j][1])
// are split, then the three products go in three passes over the G tiles
// (lo·hi, hi·lo, hi·hi), so that consecutive mma's are independent and each
// waits on its own accumulator's previous product G mma's back. The small
// cross terms may go to separate accumulators (`small`); P·v, whose tile
// sums are short, passes `big` twice.
template <int G>
__device__ __forceinline__ void mma_3xtf32(float (*big)[4], float (*small)[4],
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           const float (&b)[G][2]) {
  uint32_t bh[G][2], bl[G][2];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    split_tf32(b[j][0], bh[j][0], bl[j][0]);
    split_tf32(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(small[j], al, bh[j][0], bh[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(small[j], ah, bl[j][0], bl[j][1]);
#pragma unroll
  for (int j = 0; j < G; ++j) mma_tf32(big[j], ah, bh[j][0], bh[j][1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The exponent's base for a row whose running max is m: a row that has seen
// only masked keys (m = -inf) uses 0, so exp(-inf - 0) = 0, never NaN.
__device__ __forceinline__ float safe_max(float m) { return m == -INFINITY ? 0.f : m; }

// NB = 8-wide column tiles of the d_b chunk a warp accumulates (NB·8 >= the
// chunk width). Block (split, chunk, row tile) of batch entry blockIdx.y.
// bcast bits: 1 q, 2 k, 4 v have one matrix for every batch entry.
template <int NB>
__global__ void __launch_bounds__(NT, MIN_BLOCKS) sdpa_estimator_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int nu, int no, int d, int db,
    int splits, int per_tiles, int chunks, float scale, int bcast) {
  extern __shared__ float4 smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  float* const qs = reinterpret_cast<float*>(reinterpret_cast<char*>(smem_raw) + pad);
  int x = blockIdx.x;
  const int split = x % splits;
  x /= splits;
  const int chunk = x % chunks, row0 = (x / chunks) * BM;
  const long long b = blockIdx.y, batch = gridDim.y;
  const int dk = pad8(d), nbq = boxes(d);
  const int col0 = chunk * COLS, cw = min(COLS, db - col0), cwp = pad8(cw), nbv = boxes(cw);
  const int nbv_max = boxes(min(COLS, db));
  float* const ks = qs + nbq * BM * BOX;           // stage s: ks + s * nbq * BN * BOX
  float* const vs = ks + 2 * nbq * BN * BOX;       // stage s: vs + s * nbv_max * BN * BOX
  uint64_t* const bar = reinterpret_cast<uint64_t*>(vs + 2 * nbv_max * BN * BOX);
  const int kbeg = split * per_tiles * BN;
  const int kend = min(no, kbeg + per_tiles * BN);
  const int ntiles = (kend - kbeg + BN - 1) / BN;
  const int bq = bcast & 1 ? 0 : (int)b, bk = bcast & 2 ? 0 : (int)b, bv = bcast & 4 ? 0 : (int)b;
  const uint32_t kv_bytes = (nbq + nbv) * BN * BOX * sizeof(float);

  // One thread drives the copies: a stage's K and V boxes land on its
  // barrier; the q tile rides on stage 0's first phase.
  auto load_kv = [&](int key0, int st) {
    for (int j = 0; j < nbq; ++j)
      tma_load(ks + (st * nbq + j) * BN * BOX, &tk, BOX * j, key0, bk, &bar[st]);
    for (int j = 0; j < nbv; ++j)
      tma_load(vs + (st * nbv_max + j) * BN * BOX, &tv, col0 + BOX * j, key0, bv, &bar[st]);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], nbq * BM * BOX * sizeof(float) + kv_bytes);
    for (int j = 0; j < nbq; ++j) tma_load(qs + j * BM * BOX, &tq, BOX * j, row0, bq, &bar[0]);
    load_kv(kbeg, 0);
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rq = warp * 16 + g;  // this thread's q rows: rq and rq + 8 (both = g mod 8)
  // TMA writes each box row of 128 bytes with its 16-byte chunks permuted by
  // XOR with the row mod 8 (the 128-byte swizzle): element (r, c) of a box
  // sits at r·32 + ((c/4 XOR r%8)·4 + c%4). These offsets within a row are
  // fixed for the thread: q and K fragments read columns 8j + t and
  // 8j + t + 4 of rows = g (mod 8); V fragments read column 8j + g of rows
  // 2t and 2t + 1 (mod 8). Either way the 32 lanes hit 32 distinct banks.
  int xq[4][2], xv[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      xq[j][e] = (((2 * j + e) ^ g) << 2) + t;
      xv[j][e] = (((2 * j + (g >> 2)) ^ (2 * t + e)) << 2) + (g & 3);
    }
  float o[NB][4];
#pragma unroll
  for (int n = 0; n < NB; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max of rows g and g + 8
  float l0 = 0.f, l1 = 0.f;              // this thread's share of their sums

  for (int it = 0; it < ntiles; ++it) {
    const int key0 = kbeg + it * BN, st = it & 1;
    if (threadIdx.x == 0 && it + 1 < ntiles) {
      // tile it + 1 into the other stage, which every warp finished reading
      // before the barrier that ended tile it - 1
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(&bar[st ^ 1], kv_bytes);
      load_kv(key0 + BN, st ^ 1);
    }
    mbar_wait(&bar[st], (it >> 1) & 1);
    const float* const kt = ks + st * nbq * BN * BOX;
    const float* const vt = vs + st * nbv_max * BN * BOX;

    // S = (q·scale)·kᵀ: 16 rows x BN keys in accumulators
    float s[NS][4], sl[NS][4];  // hi·hi, and the cross terms
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = sl[n][e] = 0.f;
    for (int kb = 0; kb < dk; kb += BOX) {  // one 32-column box of q and K at a time
      const float* const qb = qs + kb * BM + rq * BOX;  // rows rq and rq + 8 (+8 rows)
      const float* const kr = kt + kb * BN + g * BOX;   // rows n·8 + g (+8n rows)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (kb + 8 * j < dk) {
          uint32_t ah[4], al[4];
          split_tf32(qb[xq[j][0]] * scale, ah[0], al[0]);
          split_tf32(qb[8 * BOX + xq[j][0]] * scale, ah[1], al[1]);
          split_tf32(qb[xq[j][1]] * scale, ah[2], al[2]);
          split_tf32(qb[8 * BOX + xq[j][1]] * scale, ah[3], al[3]);
          float kf[NS][2];
#pragma unroll
          for (int n = 0; n < NS; ++n) {
            kf[n][0] = kr[n * 8 * BOX + xq[j][0]];
            kf[n][1] = kr[n * 8 * BOX + xq[j][1]];
          }
          mma_3xtf32<NS>(s, sl, ah, al, kf);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];
    if (key0 + BN > kend) {  // the range's ragged last tile: keys past it score -inf
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + n * 8 + 2 * t + (e & 1) >= kend) s[n][e] = -INFINITY;
    }

    // online softmax in registers; thread holds rows g (e = 0, 1), g + 8 (e = 2, 3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float b0 = safe_max(mn0), b1 = safe_max(mn1);
    const float alpha0 = expf(m0 - b0), alpha1 = expf(m1 - b1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      s[n][0] = expf(s[n][0] - b0);
      s[n][1] = expf(s[n][1] - b0);
      s[n][2] = expf(s[n][2] - b1);
      s[n][3] = expf(s[n][3] - b1);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;

    // pv = P·v of this tile. Key order within each 8-key step is permuted so
    // that the score accumulators are the A fragment as they stand:
    // accumulator column 2t (c0 row g, c2 row g + 8) is k = t, column 2t + 1
    // (c1, c3) is k = t + 4, so a = {c0, c2, c1, c3}, and b0 = v[key 2t],
    // b1 = v[key 2t + 1].
    float pv[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      uint32_t ah[4], al[4];
      split_tf32(s[kk][0], ah[0], al[0]);
      split_tf32(s[kk][2], ah[1], al[1]);
      split_tf32(s[kk][1], ah[2], al[2]);
      split_tf32(s[kk][3], ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < NB; n += 4) {  // 4 column tiles a pass (NB is a multiple of 4)
        if (n * 8 < cwp) {
          float vb[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // column (n + j)·8 + g: box (n + j) / 4
            const float* const vr = vt + ((n + j) >> 2) * BN * BOX + (kk * 8 + 2 * t) * BOX;
            vb[j][0] = vr[xv[(n + j) & 3][0]];
            vb[j][1] = vr[BOX + xv[(n + j) & 3][1]];
          }
          mma_3xtf32<4>(pv + n, pv + n, ah, al, vb);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {  // acc = alpha·acc + P·v, in IEEE f32
      o[n][0] = fmaf(o[n][0], alpha0, pv[n][0]);
      o[n][1] = fmaf(o[n][1], alpha0, pv[n][1]);
      o[n][2] = fmaf(o[n][2], alpha1, pv[n][2]);
      o[n][3] = fmaf(o[n][3], alpha1, pv[n][3]);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int ra = row0 + warp * 16 + g, rb = ra + 8;
  const bool parked = splits > 1;
  const float inv0 = parked ? 1.f : 1.f / l0, inv1 = parked ? 1.f : 1.f / l1;
  // parked rows have a pitch of d_b rounded up to 4, for the merge's 16-byte loads
  const int pitch = parked ? (db + 3) & ~3 : db;
  float* const dst = parked ? part_acc + (split * batch + b) * nu * pitch : out + b * nu * db;
  const bool pairs = pitch % 2 == 0;  // c is even: (c, c + 1) is one 8-byte store
#pragma unroll
  for (int n = 0; n < NB; ++n) {
    const int c = col0 + n * 8 + 2 * t;
    if (c >= db) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = h ? rb : ra;
      const float inv = h ? inv1 : inv0;
      if (r >= nu) continue;
      float* const p = dst + (long long)r * pitch + c;
      if (pairs && c + 1 < db)
        *reinterpret_cast<float2*>(p) = make_float2(o[n][2 * h] * inv, o[n][2 * h + 1] * inv);
      else {
        p[0] = o[n][2 * h] * inv;
        if (c + 1 < db) p[1] = o[n][2 * h + 1] * inv;
      }
    }
  }
  if (parked && chunk == 0 && t == 0) {
    float* const ml = part_ml + 2 * ((split * batch + b) * nu);
    if (ra < nu) {
      ml[2 * ra] = m0;
      ml[2 * ra + 1] = l0;
    }
    if (rb < nu) {
      ml[2 * rb] = m1;
      ml[2 * rb + 1] = l1;
    }
  }
}

// Merge the key ranges: one thread for 4 columns of an output row rescales
// each range's (acc, l) to the row's common max M and sums them. A range
// with no valid key has m = -inf and weighs 0. part_acc rows have a pitch
// of pitch4 float4s; part_ml holds (m, l) per range and row.
__global__ void __launch_bounds__(256) sdpa_estimator_merge(const float4* __restrict__ part_acc,
                                                            const float2* __restrict__ part_ml,
                                                            float* __restrict__ out,
                                                            long long rows, int db, int pitch4,
                                                            int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows * pitch4) return;
  const long long row = i / pitch4;
  const int c4 = (int)(i - row * pitch4);
  float m = -INFINITY;
  for (int r = 0; r < splits; ++r) m = fmaxf(m, part_ml[r * rows + row].x);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 16
  for (int r = 0; r < splits; ++r) {
    const float4 p = part_acc[(r * rows + row) * pitch4 + c4];
    const float2 ml = part_ml[r * rows + row];
    const float w = expf(ml.x - m);
    l = fmaf(ml.y, w, l);
    a = make_float4(fmaf(p.x, w, a.x), fmaf(p.y, w, a.y), fmaf(p.z, w, a.z), fmaf(p.w, w, a.w));
  }
  const float inv = 1.f / l;
  const float v[4] = {a.x * inv, a.y * inv, a.z * inv, a.w * inv};
  float* const o = out + row * db + 4 * c4;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * c4 + e < db) o[e] = v[e];
}

template <int NB>
cudaError_t launch(dim3 grid, size_t smem, cudaStream_t st, const CUtensorMap& tq,
                   const CUtensorMap& tk, const CUtensorMap& tv, float* out, float* part_acc,
                   float* part_ml, int nu, int no, int d, int db, int splits, int per_tiles,
                   int chunks, float scale, int bcast) {
  // Opt in once per instantiation (on the first device launched on) to the
  // most dynamic shared memory any shape needs: no device query per call.
  static const cudaError_t opted = cudaFuncSetAttribute(
      sdpa_estimator_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (opted != cudaSuccess) return opted;
  sdpa_estimator_kernel<NB><<<grid, NT, smem, st>>>(tq, tk, tv, out, part_acc, part_ml, nu, no,
                                                    d, db, splits, per_tiles, chunks, scale,
                                                    bcast);
  return cudaGetLastError();
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime: the
// library links no libcuda.
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                : nullptr;
  }();
  return fn;
}

// A TMA map of a (batch, rows, width) f32 tensor with batch and row strides
// sb and rs (elements), read in boxes of 32 columns x box_rows rows with
// the 128-byte swizzle; out-of-range elements read as zeros. A broadcast
// batch (sb = 0) is one matrix: the kernel reads it at batch coordinate 0.
bool make_map(CUtensorMap* map, const float* p, int width, int rows, int batch, long long sb,
              long long rs, int box_rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr || reinterpret_cast<uintptr_t>(p) % 16 || rs <= 0 || rs % 4 || sb < 0 ||
      sb % 4)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)rows, (cuuint64_t)(sb ? batch : 1)};
  const cuuint64_t strides[2] = {(cuuint64_t)rs * 4, (cuuint64_t)(sb ? sb : rs * rows) * 4};
  const cuuint32_t box[3] = {BOX, (cuuint32_t)box_rows, 1}, unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(p), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

}  // namespace

// The kernel's geometry, which ops.py's launch plan also counts with and
// checks against this once when it loads the library: out = {BM, BN, COLS,
// BOX, MAX_D, MIN_BLOCKS, dynamic shared memory of a block at (d, db)}.
extern "C" void sdpa_estimator_geometry(int d, int db, long long* out) {
  const long long g[7] = {BM, BN, COLS, BOX, MAX_D, MIN_BLOCKS, (long long)smem_bytes(d, db)};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
}

// Plain C entry point, loaded with ctypes. Pointers are device pointers to
// f32 data whose last dimension is contiguous, 16-byte aligned, with batch
// and row strides (*_sb, *_rs, in elements) that are multiples of 4; a
// batch stride of 0 broadcasts one matrix over the batch. out is
// (B, N_u, d_b) contiguous. The key axis is cut into `splits` ranges of
// `per_tiles` tiles of 32 keys (every range holds a key:
// (splits - 1)·per_tiles·32 < N_o <= splits·per_tiles·32). With more than
// one range, part_acc (splits·B·N_u·pad4(d_b) floats, 16-byte aligned) and
// part_ml (splits·B·N_u·2) are the merge's scratch. Returns the first failing
// call's cudaError_t; launches on `stream` and does not synchronize or query
// the device.
extern "C" int sdpa_estimator_f32(const float* q, const float* k, const float* v, float* out,
                                  float* part_acc, float* part_ml, int batch, int nu, int no,
                                  int d, int db, long long q_sb, long long q_rs, long long k_sb,
                                  long long k_rs, long long v_sb, long long v_rs, int splits,
                                  int per_tiles, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || nu < 0 || no < 1 || d < 1 || d > MAX_D || db < 1 ||
      db > MAX_D || splits < 1 || per_tiles < 1 ||
      (long long)(splits - 1) * per_tiles * BN >= no ||
      (long long)splits * per_tiles * BN < no || (splits > 1 && (!part_acc || !part_ml)))
    return (int)cudaErrorInvalidValue;
  if (nu == 0) return (int)cudaSuccess;
  const int chunks = (db + COLS - 1) / COLS;
  const long long blocks = (long long)((nu + BM - 1) / BM) * chunks * splits;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, d, nu, batch, q_sb, q_rs, BM) ||
      !make_map(&tk, k, d, no, batch, k_sb, k_rs, BN) ||
      !make_map(&tv, v, db, no, batch, v_sb, v_rs, BN))
    return (int)cudaErrorInvalidValue;
  const int bcast = (q_sb == 0 ? 1 : 0) | (k_sb == 0 ? 2 : 0) | (v_sb == 0 ? 4 : 0);
  const dim3 grid((unsigned)blocks, batch);
  const size_t smem = smem_bytes(d, db);
  auto st = static_cast<cudaStream_t>(stream);
  const int widest = db < COLS ? db : COLS;
  cudaError_t e;
  if (widest <= 32)
    e = launch<4>(grid, smem, st, tq, tk, tv, out, part_acc, part_ml, nu, no, d, db, splits,
                  per_tiles, chunks, scale, bcast);
  else if (widest <= 64)
    e = launch<8>(grid, smem, st, tq, tk, tv, out, part_acc, part_ml, nu, no, d, db, splits,
                  per_tiles, chunks, scale, bcast);
  else
    e = launch<16>(grid, smem, st, tq, tk, tv, out, part_acc, part_ml, nu, no, d, db, splits,
                   per_tiles, chunks, scale, bcast);
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long long rows = (long long)batch * nu;
  const int pitch4 = (db + 3) / 4;
  sdpa_estimator_merge<<<(unsigned)((rows * pitch4 + 255) / 256), 256, 0, st>>>(
      reinterpret_cast<const float4*>(part_acc), reinterpret_cast<const float2*>(part_ml), out,
      rows, db, pitch4, splits);
  return (int)cudaGetLastError();
}
