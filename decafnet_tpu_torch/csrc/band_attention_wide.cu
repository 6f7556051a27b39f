// Banded (local-window) multi-head attention for Hopper (sm_90a) at the head
// widths and windows off the tuned kernels of band_attention.cu (built for
// D = 32 and windows 3..9): D a multiple of 8 from 8 to 256, any window from
// 1 to 33 (halo 0..16), in f32 and bf16. The wrapper
// (ops/local_attention.py: band_attention_route, "wide") sends those shapes
// here; the general kernel of band_attention_general.cu keeps the rest.
//
//   out[b, h, t] = sum_{|j - t| <= halo, 0 <= j < T, mask[b, j]} p_j * v[b, h, j]
//   p = softmax_j(q[b, h, t] . k[b, h, j])      (scores over the valid band keys)
//   rows with an invalid query, or with no valid key, are 0.
//
// Replaces, for those shapes, the TPU kernel
// decafnet_tpu/ops/local_attention.py:_band_attention_pallas_impl (pallas_call
// at :348), which takes any D and any window up to twice its chunk.
//
// What bounds it on an H100: memory, 16 * D bytes per valid query in f32 (q,
// k, v read once, the result written once; 8 * D in bf16) against ~4 * w * D
// FLOPs, 1.25-2.75 FLOP per byte at windows 5-11, far under the card's ridge:
// no tensor cores. What held the general kernel back (a thread per query,
// scores recomputed per block of 64 dims, single-element loads through L1) is
// answered so:
//   - a block owns one (b, h) and a tile of `tile` time columns ((b, h) and
//     the tile flattened into blockIdx.x, so B*H is not capped at 65535). The
//     tile's q, and its k and v with HA columns each side (the halo rounded
//     up to a 16-byte copy), are staged in shared memory, so each key row
//     crosses device memory once and serves every query whose band holds it;
//     the tile's mask bytes are staged once, and a tile with no valid query
//     writes its zeros and loads nothing else;
//   - D is streamed in steps of 8 * parts dims through a double buffer of
//     cp.async copies (where the view's rows are time-contiguous, of 16
//     bytes, or 8 or 4 where rows and bases are only on those: the bf16
//     head views at T = 36; else element by element, 4-byte cp.async in
//     f32, plain loads in bf16; the route never depends on the layout), so
//     shared memory does not bound D: phase 1 streams q and k and adds the partial
//     scores, phase 2 streams v and stores each finished step of the output
//     straight away;
//   - a lane owns two adjacent queries (t, t + 1, t even) and reads q, k and v
//     as pairs (float2, or one bf16x2 word), so a key row of 2 * HP + 2
//     columns (HP the halo rounded up to even) feeds 2 * w products;
//   - the w scores of each query are computed once and kept in registers
//     (at most 2 x 33 per lane); no score is recomputed. The kernel is
//     built for the halo classes 0..5, 8 and 16 (HALO), so the build stays
//     short: a halo between two classes runs on the larger one, its
//     offsets past the halo masked like invalid keys;
//   - D is split over `parts` = warps x lanes parts of 8 dims per step: the
//     `lanes` parts of a warp hold the same queries and add their partial
//     scores by an xor-shuffle tree, the warps through shared memory in warp
//     order, once per query after the last step of phase 1. Then each part
//     takes the masked max-subtracted softmax of its queries and, in phase
//     2, the weighted sum of its dims of v. At lanes 1 a warp's store covers
//     64 adjacent columns of a d-row (256 bytes in f32, 128 in bf16); the
//     wrapper's plan takes lanes 2 or 4 (tiles of 32 or 16 columns) only
//     where a launch would have fewer than 1024 threads per SM;
//   - scores, softmax and sums in f32 (bf16 inputs widened exactly); the
//     result rounded once to bf16 in the bf16 kernel, written (B, H, D, T),
//     time-minor, as the tuned kernels write it.
// The launch plan (warps, lanes) is the wrapper's
// (ops/local_attention.py: band_attention_wide_plan); the entry points refuse
// a plan outside the kernel's envelope or its shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace decafnet;

constexpr int MAX_HALO = 16;
// the halos the kernel is instantiated for; halo h runs on the least >= h
constexpr int HALO_CLASSES[] = {0, 1, 2, 3, 4, 5, 8, 16};

__host__ __device__ constexpr int halo_class(int halo) {
  return halo <= 5 ? halo : halo <= 8 ? 8 : 16;
}
constexpr int MAX_D = 256;
constexpr int MAX_WARPS = 8;
constexpr int DIMS = 8;             // head dims of a part per step
constexpr int PAIR_COLS = 64;       // query columns of a warp at lanes 1
constexpr long long SMEM_LIMIT = 232448;

// elements per 16-byte copy
template <typename E>
constexpr int VEC = 16 / (int)sizeof(E);

__host__ __device__ constexpr long long round16(long long n) { return (n + 15) / 16 * 16; }

// staged k, v columns each side of the tile: the halo rounded up to a copy
__host__ __device__ constexpr int halo_pad(int halo, int vec) {
  return (halo + vec - 1) / vec * vec;
}

// Shared memory of a block at `halo`'s class: two stages (q [dims][tile],
// then k or v [dims][tile + 2 HA]), the partial scores of the warps
// ([warps][w][tile] f32; none at one warp) and the mask bytes of the staged
// columns.
__host__ __device__ constexpr long long wide_smem(int esz, int warps, int lanes, int halo) {
  halo = halo_class(halo);
  const int tile = PAIR_COLS / lanes;
  const int row = tile + 2 * halo_pad(halo, 16 / esz);
  const long long dims = (long long)DIMS * warps * lanes;
  const long long stage = round16(dims * (tile + row) * esz);
  const long long scratch = warps > 1 ? (long long)warps * (2 * halo + 1) * tile * 4 : 0;
  return 2 * stage + scratch + round16(row);
}

// E = float or __nv_bfloat16: two adjacent elements, widened
__device__ __forceinline__ void load_pair(const float* p, float& a, float& b) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  a = x.x;
  b = x.y;
}
__device__ __forceinline__ void load_pair(const __nv_bfloat16* p, float& a, float& b) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  a = __uint_as_float(w << 16);
  b = __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float from_f32(float x, float*) { return x; }
__device__ __forceinline__ __nv_bfloat16 from_f32(float x, __nv_bfloat16*) {
  return __float2bfloat16_rn(x);
}

// the results of queries t and t + 1 (t even) of one d-row: one pair store
// where T is even (the pair is then on its own size), else one or two
// single ones
__device__ __forceinline__ void store_pair(float* o, float a, float b, int t, int T) {
  if (t + 1 < T && (T & 1) == 0) {
    *reinterpret_cast<float2*>(o) = make_float2(a, b);
  } else {
    if (t < T) o[0] = a;
    if (t + 1 < T) o[1] = b;
  }
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float a, float b, int t, int T) {
  if (t + 1 < T && (T & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a, b);
  } else {
    if (t < T) o[0] = __float2bfloat16_rn(a);
    if (t + 1 < T) o[1] = __float2bfloat16_rn(b);
  }
}

// N bytes (4, 8 or 16) global -> shared; when !valid nothing is read and
// the bytes are zeroed
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool valid) {
  if constexpr (N == 16) {
    cp_async16(dst, src, valid);
  } else {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(N),
                 "r"(valid ? N : 0)
                 : "memory");
  }
}

// one element into shared memory, zero when !in (src is then not read)
__device__ __forceinline__ void stage1(float* dst, const float* src, bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void stage1(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? __ldg(src) : __ushort_as_bfloat16(0);
}

// rows d0 .. d0 + n - 1 of one (b, h) slice `src`, time-contiguous, columns
// c0 .. c0 + len - 1 (zeros outside [0, T)), into dst as [n][len] by copies
// of CW bytes: rows and src on CW bytes, c0 and len multiples of a copy's
// columns, so a copy never straddles 0
template <int CW, typename E>
__device__ __forceinline__ void stage_copies(E* dst, int len, const E* src, int d0, int n,
                                             int c0, int T, long long sd, int tid,
                                             int nthreads) {
  constexpr int V = CW / (int)sizeof(E);
  const int per_row = len / V;
  for (int i = tid; i < n * per_row; i += nthreads) {
    const int r = i / per_row, c = (i - r * per_row) * V;
    const int j = c0 + c;
    E* to = dst + r * len + c;
    if (j >= 0 && j + V <= T) {
      cp_async_n<CW>(to, src + (long long)(d0 + r) * sd + j, true);
    } else if (j < 0 || j >= T) {
      cp_async_n<CW>(to, src, false);
    } else {
      const E* from = src + (long long)(d0 + r) * sd + j;
#pragma unroll
      for (int e = 0; e < V; ++e) stage1(to + e, j + e < T ? from + e : src, j + e < T);
    }
  }
}

// rows d0 .. d0 + n - 1 of one (b, h) slice `src`, columns c0 .. c0 + len - 1
// (zeros outside [0, T)), into dst as [n][len]: by copies of `copy` bytes
// (16, 8 or 4; see stage_copies), or element by element (copy 0)
template <typename E>
__device__ __forceinline__ void stage_rows(E* dst, int len, const E* src, int d0, int n,
                                           int c0, int T, long long sd, long long st,
                                           int copy, int tid, int nthreads) {
  if (copy == 16) {
    stage_copies<16>(dst, len, src, d0, n, c0, T, sd, tid, nthreads);
  } else if (copy == 8) {
    stage_copies<8>(dst, len, src, d0, n, c0, T, sd, tid, nthreads);
  } else if (copy == 4) {
    stage_copies<4>(dst, len, src, d0, n, c0, T, sd, tid, nthreads);
  } else if (sd == 1) {
    // (B, H, T, D) rows: d fastest, so a warp reads adjacent dims
    for (int i = tid; i < n * len; i += nthreads) {
      const int c = i / n, r = i - c * n;
      const int j = c0 + c;
      const bool in = j >= 0 && j < T;
      stage1(dst + r * len + c, in ? src + (long long)j * st + d0 + r : src, in);
    }
  } else {
    for (int i = tid; i < n * len; i += nthreads) {
      const int r = i / len, c = i - r * len;
      const int j = c0 + c;
      const bool in = j >= 0 && j < T;
      stage1(dst + r * len + c, in ? src + (long long)j * st + (long long)(d0 + r) * sd : src,
             in);
    }
  }
}

// masked max-subtracted softmax of one query's scores in place (the FLT_MIN
// clamp of the plain version; no valid key: all 0)
template <int W>
__device__ __forceinline__ void softmax(float (&s)[W], uint64_t ok) {
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < W; ++r)
    if ((ok >> r) & 1) m = fmaxf(m, s[r]);
  float den = 0.f;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    s[r] = ((ok >> r) & 1) ? expf(s[r] - m) : 0.f;
    den += s[r];
  }
  den = fmaxf(den, FLT_MIN);
#pragma unroll
  for (int r = 0; r < W; ++r) s[r] = s[r] / den;
}

template <typename E, int HALO>
__global__ void __launch_bounds__(32 * MAX_WARPS)
band_attention_wide_kernel(const E* __restrict__ q, const E* __restrict__ k,
                           const E* __restrict__ v, const uint8_t* __restrict__ mask,
                           E* __restrict__ out, int H, int T, int D, int halo, int lanes,
                           int n_tiles,
                           long long sb, long long sh, long long st, long long sd, int copy) {
  constexpr int W = 2 * HALO + 1;
  constexpr int HP = HALO + (HALO & 1);   // halo rounded up to even: whole pairs
  constexpr int HA = halo_pad(HALO, VEC<E>);
  constexpr int KP = 2 * HP + 2;          // key columns a lane reads per dim
  // a step's dims unrolled at the classes up to 5 (the paths' halos); one
  // at a time at the classes 8 and 16, which no path runs, to keep this
  // source's build short
  constexpr int UNROLL = HALO <= 5 ? DIMS : 1;
  const int nthreads = blockDim.x, warps = nthreads >> 5;
  const int tile = PAIR_COLS / lanes;
  const int row = tile + 2 * HA;
  const int dims = DIMS * warps * lanes;  // head dims of a step
  const int steps = D / dims;
  const int stage_elems = (int)(round16((long long)dims * (tile + row) * sizeof(E)) / sizeof(E));

  extern __shared__ __align__(16) uint8_t smem[];
  E* const stages = reinterpret_cast<E*>(smem);
  float* const scratch = reinterpret_cast<float*>(stages + 2 * stage_elems);
  uint8_t* const ms = reinterpret_cast<uint8_t*>(scratch + (warps > 1 ? warps * W * tile : 0));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pairs = 32 / lanes;            // query pairs of a warp
  const int tq = 2 * (lane % pairs);       // the lane's first query column in the tile
  const int lp = lane / pairs;             // its part among the warp's lanes
  const int part = warp * lanes + lp;      // its part among the block's
  const int bh = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - bh * n_tiles) * tile;
  const int b = bh / H, h = bh - b * H;
  const int ta = t0 + tq;
  const uint8_t* mb = mask + (size_t)b * T;
  E* const ob = out + (size_t)bh * D * T;

  for (int i = tid; i < row; i += nthreads) {
    const int j = t0 - HA + i;
    ms[i] = (j >= 0 && j < T) ? mb[j] : 0;
  }
  __syncthreads();
  const bool valid0 = ta < T && ms[HA + tq] != 0;
  const bool valid1 = ta + 1 < T && ms[HA + tq + 1] != 0;
  if (!__syncthreads_or(valid0 || valid1)) {  // no valid query in the tile: zeros, no loads
    const E zero = from_f32(0.f, (E*)nullptr);
    for (int i = tid; i < D * tile; i += nthreads) {
      const int d = i / tile, c = i - d * tile;
      if (t0 + c < T) ob[(size_t)d * T + t0 + c] = zero;
    }
    return;
  }
  // the valid keys of each query, bit r at offset r - HALO (none past halo)
  uint64_t ok0 = 0, ok1 = 0;
#pragma unroll
  for (int r = 0; r < W; ++r) {
    const bool band = r - HALO >= -halo && r - HALO <= halo;
    ok0 |= (uint64_t)(band && ms[HA + tq + r - HALO] != 0) << r;
    ok1 |= (uint64_t)(band && ms[HA + tq + 1 + r - HALO] != 0) << r;
  }

  const long long base = b * sb + h * sh;
  // step s < steps: q and k of dims s * dims ..; then v of dims (s - steps) * dims ..
  auto issue = [&](int s) {
    E* buf = stages + (s & 1) * stage_elems;
    if (s < steps) {
      stage_rows(buf, tile, q + base, s * dims, dims, t0, T, sd, st, copy, tid, nthreads);
      stage_rows(buf + dims * tile, row, k + base, s * dims, dims, t0 - HA, T, sd, st, copy,
                 tid, nthreads);
    } else {
      stage_rows(buf + dims * tile, row, v + base, (s - steps) * dims, dims, t0 - HA, T, sd,
                 st, copy, tid, nthreads);
    }
    cp_async_commit();
  };

  float s0[W], s1[W];  // scores of queries ta and ta + 1, then their probabilities
#pragma unroll
  for (int r = 0; r < W; ++r) s0[r] = s1[r] = 0.f;

  issue(0);
  for (int s = 0; s < 2 * steps; ++s) {
    if (s + 1 < 2 * steps)
      issue(s + 1);
    else
      cp_async_commit();  // an empty group: the wait below still leaves one
    cp_async_wait<1>();
    __syncthreads();
    const E* buf = stages + (s & 1) * stage_elems;
    const E* kv = buf + dims * tile;
    if (s < steps) {
#pragma unroll(UNROLL)
      for (int j = 0; j < DIMS; ++j) {
        const int r = part * DIMS + j;
        float qa, qb;
        load_pair(buf + r * tile + tq, qa, qb);
        const E* kr = kv + r * row + HA - HP + tq;  // columns tq - HP .. tq + HP + 1
        float kf[KP];
#pragma unroll
        for (int m = 0; m <= HP; ++m) load_pair(kr + 2 * m, kf[2 * m], kf[2 * m + 1]);
#pragma unroll
        for (int i = 0; i < W; ++i) {
          s0[i] = fmaf(qa, kf[HP - HALO + i], s0[i]);
          s1[i] = fmaf(qb, kf[HP - HALO + i + 1], s1[i]);
        }
      }
      if (s == steps - 1) {
        // the parts' partial scores: the warp's lanes by an xor tree, then
        // the warps in order
        for (int o = pairs; o < 32; o <<= 1) {
#pragma unroll
          for (int i = 0; i < W; ++i) {
            s0[i] += __shfl_xor_sync(0xffffffffu, s0[i], o);
            s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], o);
          }
        }
        if (warps > 1) {
          if (lp == 0) {
#pragma unroll
            for (int i = 0; i < W; ++i)
              *reinterpret_cast<float2*>(scratch + (warp * W + i) * tile + tq) =
                  make_float2(s0[i], s1[i]);
          }
          __syncthreads();
#pragma unroll
          for (int i = 0; i < W; ++i) {
            const float2 x = *reinterpret_cast<const float2*>(scratch + i * tile + tq);
            s0[i] = x.x;
            s1[i] = x.y;
          }
          for (int w = 1; w < warps; ++w) {
#pragma unroll
            for (int i = 0; i < W; ++i) {
              const float2 x =
                  *reinterpret_cast<const float2*>(scratch + (w * W + i) * tile + tq);
              s0[i] += x.x;
              s1[i] += x.y;
            }
          }
        }
        softmax(s0, ok0);
        softmax(s1, ok1);
      }
    } else {
#pragma unroll(UNROLL)
      for (int j = 0; j < DIMS; ++j) {
        const int r = part * DIMS + j;
        const E* vr = kv + r * row + HA - HP + tq;
        float vf[KP];
#pragma unroll
        for (int m = 0; m <= HP; ++m) load_pair(vr + 2 * m, vf[2 * m], vf[2 * m + 1]);
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int i = 0; i < W; ++i) {
          if ((ok0 >> i) & 1) a0 = fmaf(s0[i], vf[HP - HALO + i], a0);
          if ((ok1 >> i) & 1) a1 = fmaf(s1[i], vf[HP - HALO + i + 1], a1);
        }
        const int d = (s - steps) * dims + r;
        store_pair(ob + (size_t)d * T + ta, valid0 ? a0 : 0.f, valid1 ? a1 : 0.f, ta, T);
      }
    }
    __syncthreads();  // the stage is read; the next issue may overwrite it
  }
}

template <typename E>
struct Launch {
  const E *q, *k, *v;
  const uint8_t* mask;
  E* out;
  int B, H, T, D;
  long long sb, sh, st, sd;
  int halo, warps, lanes;
  cudaStream_t stream;
};

// the widest copy (16, 8 or 4 bytes) whose size the views' time-contiguous
// rows and bases are on, or 0 (element by element)
template <typename E>
int copy_bytes(const Launch<E>& a) {
  if (a.st != 1) return 0;
  const uintptr_t p = reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.k) |
                      reinterpret_cast<uintptr_t>(a.v);
  for (int cw = 16; cw >= 4; cw /= 2) {
    const int n = cw / (int)sizeof(E);
    if (a.sd % n == 0 && a.sh % n == 0 && a.sb % n == 0 && p % cw == 0) return cw;
  }
  return 0;
}

template <typename E, int HALO>
int launch(const Launch<E>& a) {
  const int tile = PAIR_COLS / a.lanes;
  const long long n_tiles = (a.T + tile - 1) / tile;
  const long long blocks = (long long)a.B * a.H * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long smem = wide_smem((int)sizeof(E), a.warps, a.lanes, HALO);
  static_assert(halo_class(HALO) == HALO, "HALO is a class");
  if (smem > 48 * 1024) {
    // the most any plan of this kernel takes, so launches from other threads
    // with other plans never lower it under one another
    const cudaError_t err =
        cudaFuncSetAttribute(band_attention_wide_kernel<E, HALO>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
  }
  band_attention_wide_kernel<E, HALO><<<(unsigned)blocks, 32 * a.warps, (size_t)smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.out, a.H, a.T, a.D, a.halo, a.lanes, (int)n_tiles, a.sb, a.sh,
      a.st, a.sd, copy_bytes(a));
  return (int)cudaGetLastError();
}

// the launch at the class of a.halo: HALO_CLASSES[I] or a later one
template <typename E, int I = 0>
int launch_class(const Launch<E>& a) {
  if constexpr (I == sizeof(HALO_CLASSES) / sizeof(int)) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (halo_class(a.halo) == HALO_CLASSES[I]) return launch<E, HALO_CLASSES[I]>(a);
    return launch_class<E, I + 1>(a);
  }
}

template <typename E>
int entry(const E* q, const E* k, const E* v, const uint8_t* mask, E* out, int B, int H,
          int T, int D, long long sb, long long sh, long long st, long long sd, int halo,
          int warps, int lanes, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D < DIMS || D > MAX_D || D % DIMS != 0 || halo < 0 ||
      halo > MAX_HALO)
    return (int)cudaErrorInvalidValue;
  if (warps < 1 || warps > MAX_WARPS || (lanes != 1 && lanes != 2 && lanes != 4) ||
      D % (DIMS * warps * lanes) != 0)
    return (int)cudaErrorInvalidValue;
  if (wide_smem((int)sizeof(E), warps, lanes, halo) > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const Launch<E> a{q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, warps, lanes, stream};
  return launch_class(a);
}

}  // namespace

// C entry points, f32 and bf16. q, k, v: (B, H, T, D) views sharing the
// element strides (sb, sh, st, sd); mask (B, T) bytes; out (B, H, D, T)
// contiguous, of q's type. D a multiple of 8 in 8..256, halo 0..16, the plan
// (warps 1..8, lanes 1, 2 or 4, D a multiple of 8 * warps * lanes, shared
// memory within a block's). Each returns the cudaError_t of the launch.
extern "C" int decafnet_band_attention_wide_f32(const float* q, const float* k, const float* v,
                                                const uint8_t* mask, float* out, int B, int H,
                                                int T, int D, long long sb, long long sh,
                                                long long st, long long sd, int halo,
                                                int warps, int lanes, cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, warps, lanes, stream);
}

extern "C" int decafnet_band_attention_wide_bf16(const __nv_bfloat16* q,
                                                 const __nv_bfloat16* k,
                                                 const __nv_bfloat16* v, const uint8_t* mask,
                                                 __nv_bfloat16* out, int B, int H, int T, int D,
                                                 long long sb, long long sh, long long st,
                                                 long long sd, int halo, int warps, int lanes,
                                                 cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, warps, lanes, stream);
}
