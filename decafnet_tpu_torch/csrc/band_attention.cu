// Banded (local-window) multi-head attention for Hopper (sm_90a), in two
// kernels: f32 in and out (band_attention_kernel: a block per tile of
// columns), and bf16 in and out (band_attention_bf16_kernel: at the long
// levels a persistent, warp-specialised pipeline fed by TMA, at the short
// ones warps loading straight into registers; see its note below). Both
// compute the scores, the softmax and the weighted sum in f32.
//
//   out[b, h, t] = sum_{|j - t| <= halo, 0 <= j < T, mask[b, j]} p_j * v[b, h, j]
//   p = softmax_j(q[b, h, t] . k[b, h, j])      (scores over the valid band keys)
//   rows with an invalid query, or with no valid key, are 0.
//
// Replaces the TPU kernel decafnet_tpu/ops/local_attention.py:_band_attention_pallas_impl
// (pallas_call at :348). That kernel built (c, 3c) score tiles for the TPU's
// matrix unit from prev/cur/next chunk BlockSpecs; with 5 keys per query almost
// all of that tile is masked away. Here a query's 2*halo+1 dot products, its
// masked max-subtracted softmax and its weighted sum of v rows stay in registers.
//
// What bounds it on an H100: memory. Per query it does ~4*(2*halo+1)*D FLOPs
// against 16*D bytes of q, k, v and output (8*D in bf16), a few FLOP per byte.
// The f32 design (E = float):
//   - a block owns one (b, h) and a tile of `tile` time columns ((b, h) and the
//     tile are flattened into blockIdx.x, so B*H is not capped at 65535);
//   - the tile's k and v, with `halo` columns on each side, are staged once in
//     shared memory as [D][row] of E (interior at column PAD, 16 bytes in):
//     with the model's head views (stride_t == 1) every d-row is
//     time-contiguous and the interior is copied with 16-byte cp.async (4
//     columns); the halo, rows whose base is not 16-byte aligned, and any
//     other layout take one element per 4-byte cp.async. Each k or v element
//     is read from memory once instead of once per query of its band;
//   - the tile's mask bytes are staged once; a tile with no valid query (the
//     masked tail of a row) writes its zeros and loads nothing else;
//   - D is a template parameter, so q sits in registers and the d loops unroll;
//   - a query's D is split over `split` lanes (1, 2 or 4; lane part l takes
//     d = l, l + split, ...) whose partial scores are summed with
//     __shfl_xor_sync, so the short levels (T = 36..288 at the served widths)
//     run on 2-4x the threads; the staged rows are padded so that the lanes
//     of a warp read 32 distinct banks for any split;
//   - the output is written (B, H, D, T), time-minor and coalesced, which is
//     the (B, C, T) layout the output projection reads.
// The f32 launch plan (tile, split) is chosen by the wrapper
// (ops/local_attention.py:band_attention_plan) from (B, H, T); the bf16 one
// (split, grid) by band_attention_bf16_plan.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "cp_async.cuh"
#include "hopper.cuh"

namespace {

using namespace decafnet;

constexpr int MAX_THREADS = 512;

// elements of E per 16-byte copy; also the interior column offset of a staged
// row (16 bytes), which leaves room for a halo of up to 4 columns
template <typename E>
constexpr int VEC = 16 / (int)sizeof(E);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

// one element into shared memory, zero when !in (src is then not read)
__device__ __forceinline__ void stage1(float* dst, const float* src, bool in) {
  cp_async4(dst, src, in);
}

template <typename E, int D, int HALO, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
band_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const uint8_t* __restrict__ mask,
                      E* __restrict__ out, int H, int T, int tile, int row, int n_tiles,
                      long long sb, long long sh, long long st, long long sd, bool vec) {
  constexpr int W = 2 * HALO + 1;
  constexpr int QW = 32 / SPLIT;  // queries per warp
  constexpr int DL = D / SPLIT;   // head dims per lane
  constexpr int PAD = VEC<E>;     // interior column offset of a staged row
  extern __shared__ __align__(16) float smem[];
  E* ks = reinterpret_cast<E*>(smem);  // [D][row], tile column c at PAD + c
  E* vs = ks + D * row;
  uint8_t* ms = reinterpret_cast<uint8_t*>(vs + D * row);  // [tile + 2 HALO]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int tq = (tid >> 5) * QW + lane % QW;  // this thread's query column in the tile
  const int part = lane / QW;                  // its share of the query's D
  const int bh = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - bh * n_tiles) * tile;
  const int b = bh / H, h = bh - b * H;
  const int t = t0 + tq;
  const uint8_t* mb = mask + (size_t)b * T;
  E* ob = out + (size_t)bh * D * T + t;

  for (int i = tid; i < tile + 2 * HALO; i += nthreads) {
    const int j = t0 - HALO + i;
    ms[i] = (j >= 0 && j < T) ? mb[j] : 0;
  }
  __syncthreads();
  const bool valid = t < T && ms[HALO + tq] != 0;
  if (!__syncthreads_or(valid)) {  // no valid query in the tile: zeros, no loads
    if (t < T) {
#pragma unroll
      for (int i = 0; i < DL; ++i) put(ob + (size_t)(i * SPLIT + part) * T, 0.f);
    }
    return;
  }

  const long long base = b * sb + h * sh;
  const E* kb = k + base;
  const E* vb = v + base;
  if (vec) {
    // time-contiguous, 16-byte aligned rows: VEC columns per copy
    constexpr int V = VEC<E>;
    const int cpr = tile / V;  // copies per row; nthreads / cpr == V * SPLIT
    const int ch = tid % cpr;
    const int c0 = t0 + V * ch;
    for (int d = tid / cpr; d < D; d += V * SPLIT) {
      E* kd = ks + d * row + PAD + V * ch;
      E* vd = vs + d * row + PAD + V * ch;
      const long long off = d * sd + c0;
      if (c0 + V <= T) {
        cp_async16(kd, kb + off);
        cp_async16(vd, vb + off);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) {
          const bool in = c0 + e < T;
          stage1(kd + e, in ? kb + off + e : kb, in);
          stage1(vd + e, in ? vb + off + e : vb, in);
        }
      }
    }
  } else {
    // any strides: one element per copy (nthreads == tile * SPLIT)
    const int c = tid % tile;
    const bool in = t0 + c < T;
    const long long tc = (long long)(in ? t0 + c : 0) * st;
    for (int d = tid / tile; d < D; d += SPLIT) {
      stage1(ks + d * row + PAD + c, kb + tc + d * sd, in);
      stage1(vs + d * row + PAD + c, vb + tc + d * sd, in);
    }
  }
  for (int i = tid; i < 2 * HALO * D; i += nthreads) {
    const int d = i / (2 * HALO), e = i % (2 * HALO);
    const int c = e < HALO ? e - HALO : tile + e - HALO;
    const int j = t0 + c;
    const bool in = j >= 0 && j < T;
    const long long off = in ? (long long)j * st + d * sd : 0;
    stage1(ks + d * row + PAD + c, kb + off, in);
    stage1(vs + d * row + PAD + c, vb + off, in);
  }

  // q into registers while the copies fly (idle lanes past T read column T-1)
  float qr[DL];
  const E* qt = q + base + (long long)(t < T ? t : T - 1) * st;
#pragma unroll
  for (int i = 0; i < DL; ++i) qr[i] = to_f32(qt[(long long)(i * SPLIT + part) * sd]);

  cp_async_wait_all();
  __syncthreads();

  bool ok[W];
  float s[W];
#pragma unroll
  for (int r = 0; r < W; ++r) {
    ok[r] = ms[tq + r] != 0;
    s[r] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const E* kr = ks + (i * SPLIT + part) * row + PAD + tq - HALO;
#pragma unroll
    for (int r = 0; r < W; ++r) s[r] = fmaf(qr[i], to_f32(kr[r]), s[r]);
  }
#pragma unroll
  for (int o = QW; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < W; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
  }

  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < W; ++r)
    if (ok[r]) m = fmaxf(m, s[r]);
  float p[W];
  float den = 0.f;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    p[r] = ok[r] ? expf(s[r] - m) : 0.f;
    den += p[r];
  }
  den = fmaxf(den, FLT_MIN);  // as the plain version clamps
#pragma unroll
  for (int r = 0; r < W; ++r) p[r] = p[r] / den;

  if (t >= T) return;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = i * SPLIT + part;
    const E* vr = vs + d * row + PAD + tq - HALO;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < W; ++r)
      if (ok[r]) acc = fmaf(p[r], to_f32(vr[r]), acc);
    put(ob + (size_t)d * T, valid ? acc : 0.f);
  }
}

template <typename E>
struct Launch {
  const E *q, *k, *v;
  const uint8_t* mask;
  E* out;
  int B, H, T;
  long long sb, sh, st, sd;
  int tile;
  cudaStream_t stream;
};

template <typename E, int D, int HALO, int SPLIT>
int launch(const Launch<E>& a) {
  constexpr int V = VEC<E>;
  const int tile = a.tile;
  if (tile <= 0 || tile % V != 0 || tile % (32 / SPLIT) != 0 || tile * SPLIT > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (a.T + tile - 1) / tile;
  const long long blocks = (long long)a.B * a.H * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int row = row_stride(tile, V, SPLIT, (int)sizeof(E));
  const size_t smem = sizeof(E) * 2 * D * row + ((tile + 2 * HALO + 15) / 16) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_attention_kernel<E, D, HALO, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t kv = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
  const bool vec =
      a.st == 1 && a.sd % V == 0 && a.sh % V == 0 && a.sb % V == 0 && (kv & 15) == 0;
  band_attention_kernel<E, D, HALO, SPLIT><<<(unsigned)blocks, tile * SPLIT, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.out, a.H, a.T, tile, row, (int)n_tiles, a.sb, a.sh, a.st, a.sd,
      vec);
  return (int)cudaGetLastError();
}

template <typename E, int D, int HALO>
int launch_split(const Launch<E>& a, int split) {
  switch (split) {
    case 1: return launch<E, D, HALO, 1>(a);
    case 2: return launch<E, D, HALO, 2>(a);
    case 4: return launch<E, D, HALO, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename E>
int entry(const E* q, const E* k, const E* v, const uint8_t* mask, E* out, int B, int H,
          int T, int D, long long sb, long long sh, long long st, long long sd, int halo,
          int tile, int split, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != 32) return (int)cudaErrorInvalidValue;
  const Launch<E> a{q, k, v, mask, out, B, H, T, sb, sh, st, sd, tile, stream};
  switch (halo) {
    case 1: return launch_split<E, 32, 1>(a, split);
    case 2: return launch_split<E, 32, 2>(a, split);
    case 3: return launch_split<E, 32, 3>(a, split);
    case 4: return launch_split<E, 32, 4>(a, split);
    default: return (int)cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------------ bf16
//
// The bf16 kernel (band_attention_bf16_kernel), designed for bf16 on the
// H100: q, k, v and the result in bf16; the scores, the softmax and the
// weighted sum in f32, the result rounded once.
//
// What bounds it: memory, 8 * D bytes per valid query (q, k, v read once,
// the result written once) against ~4 * w * D FLOPs, at the long levels;
// a chain of round trips at the short ones (T <= 144 when served), whose
// bounds are 0.6-2.3 us. What held the f32 design back in bf16 (PERF.md
// section 6, the phase study): every access moved 2 bytes (a lane read its
// query's 10 x 32 k and v elements from shared memory one at a time, q and
// the result went as 32 single 2-byte loads and stores, the halo columns by
// plain loads), and each block ran mask staging, copies, compute and stores
// in turn with nothing in flight beside them.
//
// A lane owns two adjacent queries (columns t, t + 1 with t even) and D /
// split of their head dims (d = part, part + split, ...; the partial scores
// summed with __shfl_xor_sync). Per d it reads q as one 32-bit word (both
// queries) and k and v as E + 1 words (E = the halo rounded up to even:
// columns t - E .. t + 1 + E), widened to f32 by a shift or a mask. The
// products are exact in f32 and summed in d order by fma; the masked
// max-subtracted softmax (the FLT_MIN clamp of the plain version; a query
// with no valid key gets zeros) and the weighted sum over the band run in
// f32 (a masked key has p = 0). The two results leave as one bf16x2 word of
// the (B, H, D, T) output (2-byte stores where T is odd). The wrapper's plan
// (ops/local_attention.py:band_attention_bf16_plan) picks one of two
// paths:
//
// split 1 (the long levels): a persistent, warp-specialised pipeline fed by
// TMA.
//   - persistent blocks of 384 threads (one per SM) walk the work items in
//     order: item i = (b * H + h, tile of 128 columns), block x taking x,
//     x + grid, ... Each block has 4 producer warps and 8 consumer warps in
//     4 groups of 2 (64 columns a warp); the block's n-th item is loaded by
//     producer warp n % 4 into stage n % 8 of a ring and computed by group
//     n % 4, so each group has its own producer and two stages, one
//     computed while the other loads (one producer thread issuing every box
//     measured slower: each issue waited on the previous ones);
//   - a stage holds the item's k and v as [D][144] bf16 tiles of the
//     columns t0 - 8 .. t0 + 135, q as a [D][128] tile of its own columns,
//     and the mask bytes of the k, v columns (0 outside [0, T)). The k and
//     v tiles start 16 bytes before the tile's first column because a TMA
//     box must start on 16 bytes of the row (on the H100 a start off 16
//     bytes faults), and reach 8 columns past its last, so a halo of up to
//     4 columns each side is in the stage;
//   - a producer warp holds the mask bytes of its next 2 items in
//     registers, their loads in flight while it issues the current one; per
//     item it waits for its stage to be free, stores the mask bytes and a
//     flag "a query is valid", and where one is, lane 0 issues the three
//     TMA boxes (4-D maps over (T, D, H, B) per tensor, encoded on the host,
//     zero-filled past either end of a row) against the stage's full
//     mbarrier. A tile with no valid query (the masked tail of a row) loads
//     nothing; its consumers write zeros;
//   - time-contiguous views whose rows are on 8 bytes but not on 16 (T a
//     multiple of 4 but not of 8, as a time-sharded rank's block widened
//     by its halo has; a base 8 bytes off 16; rows padded to 8 bytes) are
//     staged in the same layout by the producer warp's lanes, 8-byte
//     cp.async of 4 columns (zero-filled past T), completion signalled on
//     the full mbarrier by cp.async.mbarrier.arrive, so the copies of
//     consecutive stages overlap. Other views (rows or bases on 2 or 4
//     bytes: odd T, T = 2 mod 4, a base 2 bytes off, the (B, H, T, D)
//     layout) take split 4, which the wrapper's plan picks for them: the
//     pipeline's single-element copies measured 1.3-2.7x slower there
//     than the direct path (PERF.md).
//
// split 4 (the short levels, where a launch is a few round trips long):
// each warp of a block computes items of 16 columns of one (b, h), its
// lanes 4 parts x 8 query pairs, loading their mask bytes and q, k, v words
// straight from global memory into registers (the level's tensors were
// just written by the projections: L2) before any arithmetic, so an item
// costs one round trip: no staging, no barrier. The pipeline measured
// slower there at every variant tried (items of 32 or 128 columns, one or
// two blocks per SM, TMA or copies; PERF.md): its stages add a round trip
// and hand-offs to a launch of a few microseconds.

constexpr int BF_D = 32;                               // head width
constexpr int BF_PRODUCERS = 4;                        // warps (split 1)
constexpr int BF_CONSUMERS = 8;                        // warps (split 1)
constexpr int BF_THREADS = 32 * (BF_PRODUCERS + BF_CONSUMERS);
constexpr int BF_WARPS = BF_THREADS / 32;
constexpr int BF_GROUP = 2;                            // consumer warps per item
constexpr int BF_GROUPS = BF_CONSUMERS / BF_GROUP;
constexpr int BF_STAGES = 2 * BF_GROUPS;
static_assert(BF_PRODUCERS == BF_GROUPS, "a producer warp per consumer group");
constexpr int BF_TILE = 128;                           // query columns per item (split 1)
constexpr int BF_COLS = BF_TILE / BF_GROUP;            // per consumer warp
constexpr int BF_LEFT = 8;                             // staged k, v columns left of t0
constexpr int BF_W = BF_TILE + 16;                     // staged k, v columns per row
constexpr int BF_QBYTES = BF_D * BF_TILE * 2;          // a staged q tile
constexpr int BF_KVBYTES = BF_D * BF_W * 2;            // a staged k or v tile
// a stage: q, k, v, then the mask bytes of the k, v columns
constexpr int BF_K = BF_QBYTES, BF_V = BF_K + BF_KVBYTES, BF_MASK = BF_V + BF_KVBYTES;
constexpr int BF_LOAD = BF_MASK;                       // bytes of a stage's boxes
constexpr int BF_STAGE = (BF_MASK + BF_W + 127) / 128 * 128;
constexpr int BF_BARS = BF_STAGES * BF_STAGE;          // full, then empty mbarriers
constexpr int BF_FLAGS = BF_BARS + 2 * BF_STAGES * 8;
constexpr int BF_SMEM = BF_FLAGS + BF_STAGES * 4 + 128;  // + aligning the base
constexpr int BF_MW = (BF_W + 31) / 32;                // mask bytes per producer lane
constexpr int BF_MASK_AHEAD = 2;                       // items ahead a producer holds
constexpr int BF_WARP_COLS = 16;                       // query columns per warp item (split 4)

// how the views are read: at split 1 by TMA or by the producer warps with
// 8-byte cp.async; at split 4 as 32-bit words or single elements
enum BfMode { BF_TMA = 0, BF_COPY8 = 1, BF_WORDS = 2, BF_ELEMENTS = 3 };

// one TMA descriptor per tensor: (T, D, H, B) bf16, boxes of 128 (q) or
// 144 (k, v) columns x D rows
struct BandMaps {
  CUtensorMap q, k, v;
};

struct BfArgs {
  const uint16_t *q, *k, *v;
  const uint8_t* mask;
  uint16_t* out;
  int H, T, n_tiles, n_items;
  long long sb, sh, st, sd;
  int mode;
};

__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// 8-byte copy of which the first src_bytes come from src and the rest are
// zero (src is not read when src_bytes is 0)
__device__ __forceinline__ void cp_async8_fill(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// one arrival on bar once this thread's earlier cp.async copies have landed
// (the barrier's count includes it)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// two results of a row at columns t, t + 1 (t even) as bf16
__device__ __forceinline__ void store_pair(uint16_t* o, float a0, float a1, int t, int T,
                                           bool even) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const uint32_t w = *reinterpret_cast<const uint32_t*>(&h);
  if (even) {
    if (t < T) *reinterpret_cast<uint32_t*>(o) = w;
  } else {
    if (t < T) o[0] = (uint16_t)w;
    if (t + 1 < T) o[1] = (uint16_t)(w >> 16);
  }
}

// the masked max-subtracted softmax of one query over its band (bit r of
// ok: key r of the band valid); no valid key gives zeros
template <int WIN>
__device__ __forceinline__ void band_softmax(const float (&s)[WIN], uint32_t ok,
                                             float (&p)[WIN]) {
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < WIN; ++r)
    if ((ok >> r) & 1) m = fmaxf(m, s[r]);
  float den = 0.f;
#pragma unroll
  for (int r = 0; r < WIN; ++r) {
    p[r] = (ok >> r) & 1 ? exp2f((s[r] - m) * 1.44269504088896341f) : 0.f;  // e^x as 2^(x log2 e)
    den += p[r];
  }
  const float inv = 1.f / fmaxf(den, FLT_MIN);  // as the plain version clamps
#pragma unroll
  for (int r = 0; r < WIN; ++r) p[r] *= inv;
}

// A lane's two queries (columns t, t + 1) over its head dims d = part,
// part + SPLIT, ...: qword(i) is the q word of its i-th dim (both queries),
// kword(i, w) and vword(i, w) the k and v words w = 0 .. E + 1 of that dim
// (columns t - E + 2w and one more); bit r of ok: column t - HALO + r
// valid. out(i, a0, a1) takes the i-th dim's two results (0 for an
// invalid query).
template <int HALO, int SPLIT, class Q, class K, class V, class O>
__device__ __forceinline__ void pair_attention(Q qword, K kword, V vword, uint32_t ok, O out) {
  constexpr int WIN = 2 * HALO + 1;
  constexpr int E = (HALO + 1) / 2 * 2;  // the halo rounded up to even
  constexpr int NW = E + 1;              // k or v words per dim
  constexpr int DL = BF_D / SPLIT;       // head dims per lane
  float s0[WIN], s1[WIN];                // scores of the queries at t and t + 1
#pragma unroll
  for (int r = 0; r < WIN; ++r) s0[r] = s1[r] = 0.f;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const uint32_t qw = qword(i);
    const float q0 = bf_lo(qw), q1 = bf_hi(qw);
    float kf[2 * NW];  // columns t - E .. t + 1 + E
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t x = kword(i, w);
      kf[2 * w] = bf_lo(x);
      kf[2 * w + 1] = bf_hi(x);
    }
#pragma unroll
    for (int r = 0; r < WIN; ++r) {
      s0[r] = fmaf(q0, kf[E - HALO + r], s0[r]);
      s1[r] = fmaf(q1, kf[E - HALO + 1 + r], s1[r]);
    }
  }
#pragma unroll
  for (int o = 32 / SPLIT; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < WIN; ++r) {
      s0[r] += __shfl_xor_sync(0xffffffffu, s0[r], o);
      s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], o);
    }
  }
  float p0[WIN], p1[WIN];
  band_softmax<WIN>(s0, ok, p0);
  band_softmax<WIN>(s1, ok >> 1, p1);
  const bool valid0 = (ok >> HALO) & 1, valid1 = (ok >> (HALO + 1)) & 1;
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    float vf[2 * NW];
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const uint32_t x = vword(i, w);
      vf[2 * w] = bf_lo(x);
      vf[2 * w + 1] = bf_hi(x);
    }
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int r = 0; r < WIN; ++r) {
      a0 = fmaf(p0[r], vf[E - HALO + r], a0);
      a1 = fmaf(p1[r], vf[E - HALO + 1 + r], a1);
    }
    out(i, valid0 ? a0 : 0.f, valid1 ? a1 : 0.f);
  }
}

// ----------------------------------------------------------- bf16, split 1

// one producer warp's copy of one tensor's tile into a stage where TMA
// cannot read the views (BF_COPY8): a [D][COLS] tile of the columns
// t0 - LEFT .., of which the staged columns [FIRST, LAST) (multiples of 4:
// those the consumers read) are filled by 8-byte copies, zero past T
template <int COLS, int LEFT, int FIRST, int LAST>
__device__ __forceinline__ void copy_tile(const BfArgs& a, const uint16_t* src, uint8_t* dst,
                                          int t0, int lane) {
  constexpr int CH = (LAST - FIRST) / 4;  // 4-column chunks per row
  for (int e = lane; e < BF_D * CH; e += 32) {
    const int d = e / CH, c = FIRST + 4 * (e - d * CH), j = t0 - LEFT + c;
    const int n = j < 0 ? 0 : min(4, a.T - j);  // the chunk's columns inside [0, T)
    cp_async8_fill(dst + (d * COLS + c) * 2, n > 0 ? src + d * a.sd + j : src,
                   n > 0 ? 2 * n : 0);
  }
}

__device__ __forceinline__ void copy_stage(const BfArgs& a, uint8_t* stage, long long base,
                                           int t0, int lane) {
  // q: the tile's columns; k, v: those within a halo of 4 of them
  copy_tile<BF_TILE, 0, 0, BF_TILE>(a, a.q + base, stage, t0, lane);
  copy_tile<BF_W, BF_LEFT, BF_LEFT - 4, BF_LEFT + BF_TILE + 4>(a, a.k + base, stage + BF_K,
                                                                t0, lane);
  copy_tile<BF_W, BF_LEFT, BF_LEFT - 4, BF_LEFT + BF_TILE + 4>(a, a.v + base, stage + BF_V,
                                                                t0, lane);
}

// lane 0 of a producer warp: the stage's three boxes, and its arrival on
// the stage's full barrier with their bytes
__device__ __forceinline__ void issue_boxes(const BandMaps& maps, uint8_t* stage, int t0, int h,
                                            int b, uint64_t* full) {
  mbar_arrive_expect_tx(full, BF_LOAD);
  tma_load_4d(stage, &maps.q, t0, 0, h, b, full);
  tma_load_4d(stage + BF_K, &maps.k, t0 - BF_LEFT, 0, h, b, full);
  tma_load_4d(stage + BF_V, &maps.v, t0 - BF_LEFT, 0, h, b, full);
}

// producer warp w feeds consumer group w: the block's items n = w, w + 4,
// ..., in stages w and w + 4
__device__ __forceinline__ void produce(const BandMaps& maps, const BfArgs& a, uint8_t* smem,
                                        uint64_t* full, uint64_t* empty, int* flags) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the mask bytes of the block's n-th item at staged columns lane + 32 i
  // (0 outside [0, T))
  auto fetch = [&](int n, uint32_t (&mb)[BF_MW]) {
    const int item = blockIdx.x + n * gridDim.x;
    if (item >= a.n_items) return;
    const int bh = item / a.n_tiles, t0 = (item - bh * a.n_tiles) * BF_TILE;
    const uint8_t* row = a.mask + (size_t)(bh / a.H) * a.T;
#pragma unroll
    for (int i = 0; i < BF_MW; ++i) {
      const int c = lane + 32 * i, j = t0 - BF_LEFT + c;
      mb[i] = c < BF_W && j >= 0 && j < a.T ? row[j] : 0;
    }
  };
  if (a.mode == BF_TMA && lane == 0) {  // the descriptors on their way to the TMA unit
    prefetch_tensormap(&maps.q);
    prefetch_tensormap(&maps.k);
    prefetch_tensormap(&maps.v);
  }
  uint32_t ahead[BF_MASK_AHEAD][BF_MW];
#pragma unroll
  for (int i = 0; i < BF_MASK_AHEAD; ++i) fetch(warp + i * BF_GROUPS, ahead[i]);
  for (int k0 = 0;; k0 += BF_MASK_AHEAD) {
#pragma unroll
    for (int i = 0; i < BF_MASK_AHEAD; ++i) {
      const int n = warp + (k0 + i) * BF_GROUPS;  // this warp's (k0 + i)-th item
      const int item = blockIdx.x + n * gridDim.x;
      if (item >= a.n_items) return;
      uint32_t cur[BF_MW];
#pragma unroll
      for (int w = 0; w < BF_MW; ++w) cur[w] = ahead[i][w];
      fetch(n + BF_MASK_AHEAD * BF_GROUPS, ahead[i]);
      const int s = n % BF_STAGES;
      const int bh = item / a.n_tiles, t0 = (item - bh * a.n_tiles) * BF_TILE;
      uint8_t* stage = smem + s * BF_STAGE;
      mbar_wait(&empty[s], ((n / BF_STAGES) & 1) ^ 1);
      const int b = bh / a.H, h = bh - b * a.H;
      uint8_t* ms = stage + BF_MASK;
      bool valid = false;
#pragma unroll
      for (int w = 0; w < BF_MW; ++w) {
        const int c = lane + 32 * w;
        if (c < BF_W) ms[c] = (uint8_t)cur[w];
        valid |= c >= BF_LEFT && c < BF_LEFT + BF_TILE && cur[w] != 0;
      }
      const bool any = __any_sync(0xffffffffu, valid);
      if (lane == 0) flags[s] = any;
      __syncwarp();  // the warp's stores above, before any of its lanes arrives
      if (a.mode == BF_TMA) {
        if (lane == 0 && any)
          issue_boxes(maps, stage, t0, h, b, &full[s]);
        else
          mbar_arrive(&full[s]);
        continue;
      }
      if (any) copy_stage(a, stage, b * a.sb + h * a.sh, t0, lane);
      cp_async_arrive(&full[s]);
      mbar_arrive(&full[s]);
    }
  }
}

template <int HALO>
__device__ __forceinline__ void consume(const BfArgs& a, const uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, const int* flags) {
  constexpr int E = (HALO + 1) / 2 * 2;
  const int lane = threadIdx.x & 31, cw = (threadIdx.x >> 5) - BF_PRODUCERS;
  const int col = (cw % BF_GROUP) * BF_COLS + 2 * lane;  // first query column in the tile
  const bool even = (a.T & 1) == 0;
  for (int n = cw / BF_GROUP;; n += BF_GROUPS) {
    const int item = blockIdx.x + n * gridDim.x;
    if (item >= a.n_items) return;
    const int s = n % BF_STAGES;
    const int bh = item / a.n_tiles, t = (item - bh * a.n_tiles) * BF_TILE + col;
    uint16_t* ob = a.out + (size_t)bh * BF_D * a.T + t;
    mbar_wait(&full[s], (n / BF_STAGES) & 1);
    const uint8_t* stage = smem + s * BF_STAGE;
    if (!flags[s]) {  // no valid query in the tile: zeros, nothing loaded
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
#pragma unroll
      for (int d = 0; d < BF_D; ++d) store_pair(ob + (size_t)d * a.T, 0.f, 0.f, t, a.T, even);
      continue;
    }
    const uint32_t* qs = reinterpret_cast<const uint32_t*>(stage) + col / 2;
    const uint32_t* ks = reinterpret_cast<const uint32_t*>(stage + BF_K) + (BF_LEFT + col - E) / 2;
    const uint32_t* vs = reinterpret_cast<const uint32_t*>(stage + BF_V) + (BF_LEFT + col - E) / 2;
    const uint8_t* ms = stage + BF_MASK + BF_LEFT + col - HALO;
    uint32_t ok = 0;
#pragma unroll
    for (int r = 0; r < 2 * HALO + 2; ++r) ok |= (uint32_t)(ms[r] != 0) << r;
    pair_attention<HALO, 1>([&](int d) { return qs[d * (BF_TILE / 2)]; },
                            [&](int d, int w) { return ks[d * (BF_W / 2) + w]; },
                            [&](int d, int w) { return vs[d * (BF_W / 2) + w]; }, ok,
                            [&](int d, float a0, float a1) {
                              store_pair(ob + (size_t)d * a.T, a0, a1, t, a.T, even);
                            });
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
}

// ----------------------------------------------------------- bf16, split 4

// the word of columns j, j + 1 of a row of q, k or v (zero outside [0, T))
__device__ __forceinline__ uint32_t row_word(const BfArgs& a, const uint16_t* row, int j) {
  if (a.mode == BF_WORDS)  // time-contiguous, T even, on 4 bytes: j, j + 1 both in or out
    return j >= 0 && j < a.T ? *reinterpret_cast<const uint32_t*>(row + j) : 0u;
  const uint32_t lo = j >= 0 && j < a.T ? row[(long long)j * a.st] : 0;
  const uint32_t hi = j + 1 >= 0 && j + 1 < a.T ? row[(long long)(j + 1) * a.st] : 0;
  return lo | (hi << 16);
}

template <int HALO>
__device__ __forceinline__ void direct(const BfArgs& a) {
  constexpr int E = (HALO + 1) / 2 * 2, NW = E + 1, DL = BF_D / 4;
  const int lane = threadIdx.x & 31, part = lane / 8;
  const bool even = (a.T & 1) == 0;
  for (int item = blockIdx.x * BF_WARPS + (threadIdx.x >> 5); item < a.n_items;
       item += gridDim.x * BF_WARPS) {
    const int bh = item / a.n_tiles;
    const int t = (item - bh * a.n_tiles) * BF_WARP_COLS + 2 * (lane % 8);
    const int b = bh / a.H, h = bh - b * a.H;
    const uint8_t* mrow = a.mask + (size_t)b * a.T;
    uint32_t ok = 0;
#pragma unroll
    for (int r = 0; r < 2 * HALO + 2; ++r) {
      const int j = t - HALO + r;
      ok |= (uint32_t)(j >= 0 && j < a.T && mrow[j] != 0) << r;
    }
    uint16_t* ob = a.out + (size_t)bh * BF_D * a.T + t;
    const long long base = b * a.sb + h * a.sh;
    uint32_t qr[DL], kr[DL][NW], vr[DL][NW];
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      const long long row = base + (i * 4 + part) * a.sd;
      qr[i] = row_word(a, a.q + row, t);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        kr[i][w] = row_word(a, a.k + row, t - E + 2 * w);
        vr[i][w] = row_word(a, a.v + row, t - E + 2 * w);
      }
    }
    pair_attention<HALO, 4>([&](int i) { return qr[i]; }, [&](int i, int w) { return kr[i][w]; },
                            [&](int i, int w) { return vr[i][w]; }, ok,
                            [&](int i, float a0, float a1) {
                              store_pair(ob + (size_t)(i * 4 + part) * a.T, a0, a1, t, a.T,
                                         even);
                            });
  }
}

template <int HALO, int SPLIT>
__global__ void __launch_bounds__(BF_THREADS, 1)
band_attention_bf16_kernel(const __grid_constant__ BandMaps maps, const BfArgs a) {
  if constexpr (SPLIT == 4) {
    direct<HALO>(a);
  } else {
    extern __shared__ __align__(128) uint8_t smem_raw[];
    // the stages on 128 bytes (TMA's destinations), by pointer arithmetic on
    // the shared array, so the compiler knows every access below is to
    // shared memory (ld.shared; and no aliasing with the global stores)
    uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem + BF_BARS);
    uint64_t* empty = full + BF_STAGES;
    int* flags = reinterpret_cast<int*>(smem + BF_FLAGS);
    if (threadIdx.x < BF_STAGES) {
      const int s = threadIdx.x;
      // the stage's producer warp: each lane (lane 0 with the TMA bytes),
      // and with copies each lane again by cp.async.mbarrier.arrive when
      // its copies land
      mbar_init(&full[s], a.mode == BF_COPY8 ? 64 : 32);
      mbar_init(&empty[s], BF_GROUP);  // the item's consumer warps
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32 * BF_PRODUCERS)
      produce(maps, a, smem, full, empty, flags);
    else
      consume<HALO>(a, smem, full, empty, flags);
  }
}

// a TMA descriptor of one of q, k, v: (T, D, H, B) with the views' strides,
// boxes of box_t columns x D rows
int encode_view(CUtensorMap* map, const void* base, int B, int H, int T, long long sb,
                long long sh, long long sd, int box_t) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[4] = {(cuuint64_t)T, (cuuint64_t)BF_D, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sd * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_t, (cuuint32_t)BF_D, 1, 1}, elem[4] = {1, 1, 1, 1};
  if (encode == nullptr ||
      encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return (int)cudaErrorNotSupported;
  return (int)cudaSuccess;
}

struct BfLaunch {
  const uint16_t *q, *k, *v;
  const uint8_t* mask;
  uint16_t* out;
  int B, H, T;
  long long sb, sh, st, sd;
  int grid;
  cudaStream_t stream;
};

template <int HALO, int SPLIT>
int launch_bf16(const BfLaunch& l) {
  const int cols = SPLIT == 4 ? BF_WARP_COLS : BF_TILE;  // per work item
  const long long n_tiles = (l.T + cols - 1) / cols;
  const long long n_items = (long long)l.B * l.H * n_tiles;
  if (n_items > INT_MAX || l.grid <= 0) return (int)cudaErrorInvalidValue;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(l.q) | reinterpret_cast<uintptr_t>(l.k) |
                         reinterpret_cast<uintptr_t>(l.v);
  BfArgs a{l.q, l.k, l.v, l.mask, l.out, l.H, l.T, (int)n_tiles, (int)n_items,
           l.sb, l.sh, l.st, l.sd, BF_TMA};
  BandMaps maps;
  memset(&maps, 0, sizeof(maps));
  int smem = 0, blocks = (int)n_items;  // blocks one item each is enough
  if (SPLIT == 4) {
    a.mode = l.st == 1 && l.T % 2 == 0 && l.sd % 2 == 0 && l.sh % 2 == 0 && l.sb % 2 == 0 &&
                     (ptrs & 3) == 0
                 ? BF_WORDS
                 : BF_ELEMENTS;
    blocks = (int)((n_items + BF_WARPS - 1) / BF_WARPS);
  } else {
    // TMA: time-contiguous rows on 16 bytes, nested strides (a box reaching
    // past either end of a row is zero-filled, also where T is shorter);
    // else 8-byte copies: time-contiguous rows on 8 bytes; else refused
    const bool tma = l.st == 1 && l.sd % 8 == 0 && l.sh % 8 == 0 && l.sb % 8 == 0 &&
                     (ptrs & 15) == 0 && l.sd >= l.T && l.sh >= BF_D * l.sd &&
                     l.sb >= (long long)l.H * l.sh;
    if (tma) {
      int err = encode_view(&maps.q, l.q, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_TILE);
      if (err == (int)cudaSuccess) err = encode_view(&maps.k, l.k, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_W);
      if (err == (int)cudaSuccess) err = encode_view(&maps.v, l.v, l.B, l.H, l.T, l.sb, l.sh, l.sd, BF_W);
      if (err != (int)cudaSuccess) return err;
    } else if (l.st == 1 && l.sd % 4 == 0 && l.sh % 4 == 0 && l.sb % 4 == 0 && (ptrs & 7) == 0) {
      a.mode = BF_COPY8;
    } else {
      return (int)cudaErrorInvalidValue;
    }
    smem = BF_SMEM;
    const cudaError_t err = cudaFuncSetAttribute(band_attention_bf16_kernel<HALO, SPLIT>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int grid = l.grid < blocks ? l.grid : blocks;
  band_attention_bf16_kernel<HALO, SPLIT><<<grid, BF_THREADS, smem, l.stream>>>(maps, a);
  return (int)cudaGetLastError();
}

template <int SPLIT>
int launch_bf16_halo(const BfLaunch& l, int halo) {
  switch (halo) {
    case 1: return launch_bf16<1, SPLIT>(l);
    case 2: return launch_bf16<2, SPLIT>(l);
    case 3: return launch_bf16<3, SPLIT>(l);
    case 4: return launch_bf16<4, SPLIT>(l);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point of the f32 kernel. q, k, v: (B, H, T, D) views sharing the
// element strides (sb, sh, st, sd); mask (B, T) bytes; out (B, H, D, T)
// contiguous f32. The window is 2*halo+1 with halo in 1..4; D must be 32
// (the one head width instantiated). Launch plan: `tile` time columns per
// block (a multiple of 32 / split and of 4; tile * split <= 512), D split
// over `split` lanes (1, 2 or 4). Returns the cudaError_t of the launch.
extern "C" int decafnet_band_attention_f32(const float* q, const float* k, const float* v,
                                           const uint8_t* mask, float* out, int B, int H,
                                           int T, int D, long long sb, long long sh,
                                           long long st, long long sd, int halo, int tile,
                                           int split, cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, tile, split, stream);
}

// C entry point of the bf16 kernel, as the f32 one with bf16 q, k, v and out.
// Launch plan: `split` lanes per pair of queries (1: the TMA pipeline over
// items of 128 columns, `grid` persistent blocks, for time-contiguous views
// whose rows and bases are on 8 bytes; 4: warps over items of 16 columns,
// `grid` blocks of 12 warps, at most one warp per item, any views).
// Returns the cudaError_t of the launch, cudaErrorNotSupported when a TMA
// descriptor cannot be made.
extern "C" int decafnet_band_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, const uint8_t* mask,
                                            __nv_bfloat16* out, int B, int H, int T, int D,
                                            long long sb, long long sh, long long st,
                                            long long sd, int halo, int split, int grid,
                                            cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != BF_D) return (int)cudaErrorInvalidValue;
  const BfLaunch l{reinterpret_cast<const uint16_t*>(q), reinterpret_cast<const uint16_t*>(k),
                   reinterpret_cast<const uint16_t*>(v), mask,
                   reinterpret_cast<uint16_t*>(out), B, H, T, sb, sh, st, sd, grid, stream};
  switch (split) {
    case 1: return launch_bf16_halo<1>(l, halo);
    case 4: return launch_bf16_halo<4>(l, halo);
    default: return (int)cudaErrorInvalidValue;
  }
}
