// Banded (local-window) multi-head attention for Hopper (sm_90a), in two
// variants: f32 in and out, and bf16 in and out (bf16 tiles in shared memory;
// q in f32 registers; scores, the softmax and the weighted sum in f32; the
// result rounded once to bf16).
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
// The design (both variants; E is the element type):
//   - a block owns one (b, h) and a tile of `tile` time columns ((b, h) and the
//     tile are flattened into blockIdx.x, so B*H is not capped at 65535);
//   - the tile's k and v, with `halo` columns on each side, are staged once in
//     shared memory as [D][row] of E (interior at column PAD, 16 bytes in):
//     with the model's head views (stride_t == 1) every d-row is
//     time-contiguous and the interior is copied with 16-byte cp.async (4 f32
//     or 8 bf16 columns); the halo, rows whose base is not 16-byte aligned, and
//     any other layout take one element per copy (a 4-byte cp.async in f32, a
//     plain load and store in bf16: cp.async copies 4, 8 or 16 bytes). Each k
//     or v element is read from memory once instead of once per query of its
//     band;
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
// The launch plan (tile, split) is chosen by the wrapper
// (ops/local_attention.py:band_attention_plan) from (B, H, T).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace decafnet;

constexpr int MAX_THREADS = 512;

// elements of E per 16-byte copy; also the interior column offset of a staged
// row (16 bytes), which leaves room for a halo of up to 4 columns
template <typename E>
constexpr int VEC = 16 / (int)sizeof(E);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// one element into shared memory, zero when !in (src is then not read)
__device__ __forceinline__ void stage1(float* dst, const float* src, bool in) {
  cp_async4(dst, src, in);
}
__device__ __forceinline__ void stage1(__nv_bfloat16* dst, const __nv_bfloat16* src, bool in) {
  *dst = in ? *src : __float2bfloat16(0.f);
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

}  // namespace

// C entry points, f32 and bf16. q, k, v: (B, H, T, D) views sharing the
// element strides (sb, sh, st, sd); mask (B, T) bytes; out (B, H, D, T)
// contiguous, of the inputs' type. The window is 2*halo+1 with halo in 1..4; D
// must be 32 (the one head width instantiated). Launch plan: `tile` time
// columns per block (a multiple of 32 / split and of the columns per 16-byte
// copy, 4 in f32 and 8 in bf16; tile * split <= 512), D split over `split`
// lanes (1, 2 or 4). Each returns the cudaError_t of the launch.
extern "C" int decafnet_band_attention_f32(const float* q, const float* k, const float* v,
                                           const uint8_t* mask, float* out, int B, int H,
                                           int T, int D, long long sb, long long sh,
                                           long long st, long long sd, int halo, int tile,
                                           int split, cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, tile, split, stream);
}

extern "C" int decafnet_band_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                            const __nv_bfloat16* v, const uint8_t* mask,
                                            __nv_bfloat16* out, int B, int H, int T, int D,
                                            long long sb, long long sh, long long st,
                                            long long sd, int halo, int tile, int split,
                                            cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, tile, split, stream);
}
