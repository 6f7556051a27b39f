// Banded (local-window) multi-head attention, f32, for Hopper (sm_90a).
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
// against 16*D bytes of q, k, v and output, a few FLOP per byte. The design:
//   - a block owns one (b, h) and a tile of `tile` time columns ((b, h) and the
//     tile are flattened into blockIdx.x, so B*H is not capped at 65535);
//   - the tile's k and v, with `halo` columns on each side, are staged once in
//     shared memory as [D][row] (interior at column PAD, 16-byte aligned): with
//     the model's head views (stride_t == 1) every d-row is time-contiguous and
//     the interior is copied with 16-byte cp.async; the halo, rows whose base
//     is not 16-byte aligned, and any other layout use 4-byte copies. Each k or
//     v element is read from memory once instead of once per query of its band;
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

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace decafnet;

constexpr int PAD = 4;          // interior column offset of a staged row
constexpr int MAX_THREADS = 512;

template <int D, int HALO, int SPLIT>
__global__ void __launch_bounds__(MAX_THREADS)
band_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ mask,
                      float* __restrict__ out, int H, int T, int tile, int row, int n_tiles,
                      long long sb, long long sh, long long st, long long sd, bool vec) {
  constexpr int W = 2 * HALO + 1;
  constexpr int QW = 32 / SPLIT;  // queries per warp
  constexpr int DL = D / SPLIT;   // head dims per lane
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;               // [D][row], tile column c at PAD + c
  float* vs = smem + D * row;
  uint8_t* ms = reinterpret_cast<uint8_t*>(smem + 2 * D * row);  // [tile + 2 HALO]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int tq = (tid >> 5) * QW + lane % QW;  // this thread's query column in the tile
  const int part = lane / QW;                  // its share of the query's D
  const int bh = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - bh * n_tiles) * tile;
  const int b = bh / H, h = bh - b * H;
  const int t = t0 + tq;
  const uint8_t* mb = mask + (size_t)b * T;
  float* ob = out + (size_t)bh * D * T + t;

  for (int i = tid; i < tile + 2 * HALO; i += nthreads) {
    const int j = t0 - HALO + i;
    ms[i] = (j >= 0 && j < T) ? mb[j] : 0;
  }
  __syncthreads();
  const bool valid = t < T && ms[HALO + tq] != 0;
  if (!__syncthreads_or(valid)) {  // no valid query in the tile: zeros, no loads
    if (t < T) {
#pragma unroll
      for (int i = 0; i < DL; ++i) ob[(size_t)(i * SPLIT + part) * T] = 0.f;
    }
    return;
  }

  const long long base = b * sb + h * sh;
  const float* kb = k + base;
  const float* vb = v + base;
  if (vec) {
    // time-contiguous, 16-byte aligned rows: 4 columns per copy
    const int cpr = tile / 4;  // copies per row; nthreads / cpr == 4 * SPLIT
    const int ch = tid % cpr;
    const int c0 = t0 + 4 * ch;
    for (int d = tid / cpr; d < D; d += 4 * SPLIT) {
      float* kd = ks + d * row + PAD + 4 * ch;
      float* vd = vs + d * row + PAD + 4 * ch;
      const long long off = d * sd + c0;
      if (c0 + 4 <= T) {
        cp_async16(kd, kb + off);
        cp_async16(vd, vb + off);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = c0 + e < T;
          cp_async4(kd + e, in ? kb + off + e : kb, in);
          cp_async4(vd + e, in ? vb + off + e : vb, in);
        }
      }
    }
  } else {
    // any strides: one element per copy (nthreads == tile * SPLIT)
    const int c = tid % tile;
    const bool in = t0 + c < T;
    const long long tc = (long long)(in ? t0 + c : 0) * st;
    for (int d = tid / tile; d < D; d += SPLIT) {
      cp_async4(ks + d * row + PAD + c, kb + tc + d * sd, in);
      cp_async4(vs + d * row + PAD + c, vb + tc + d * sd, in);
    }
  }
  for (int i = tid; i < 2 * HALO * D; i += nthreads) {
    const int d = i / (2 * HALO), e = i % (2 * HALO);
    const int c = e < HALO ? e - HALO : tile + e - HALO;
    const int j = t0 + c;
    const bool in = j >= 0 && j < T;
    const long long off = in ? (long long)j * st + d * sd : 0;
    cp_async4(ks + d * row + PAD + c, kb + off, in);
    cp_async4(vs + d * row + PAD + c, vb + off, in);
  }

  // q into registers while the copies fly (idle lanes past T read column T-1)
  float qr[DL];
  const float* qt = q + base + (long long)(t < T ? t : T - 1) * st;
#pragma unroll
  for (int i = 0; i < DL; ++i) qr[i] = qt[(long long)(i * SPLIT + part) * sd];

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
    const float* kr = ks + (i * SPLIT + part) * row + PAD + tq - HALO;
#pragma unroll
    for (int r = 0; r < W; ++r) s[r] = fmaf(qr[i], kr[r], s[r]);
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
    const float* vr = vs + d * row + PAD + tq - HALO;
    float acc = 0.f;
#pragma unroll
    for (int r = 0; r < W; ++r)
      if (ok[r]) acc = fmaf(p[r], vr[r], acc);
    ob[(size_t)d * T] = valid ? acc : 0.f;
  }
}

struct Launch {
  const float *q, *k, *v;
  const uint8_t* mask;
  float* out;
  int B, H, T;
  long long sb, sh, st, sd;
  int tile;
  cudaStream_t stream;
};

template <int D, int HALO, int SPLIT>
int launch(const Launch& a) {
  const int tile = a.tile;
  if (tile <= 0 || tile % 4 != 0 || tile % (32 / SPLIT) != 0 || tile * SPLIT > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (a.T + tile - 1) / tile;
  const long long blocks = (long long)a.B * a.H * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const int row = row_stride(tile, PAD, SPLIT);
  const size_t smem = sizeof(float) * 2 * D * row + ((tile + 2 * HALO + 15) / 16) * 16;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        band_attention_kernel<D, HALO, SPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const uintptr_t kv = reinterpret_cast<uintptr_t>(a.k) | reinterpret_cast<uintptr_t>(a.v);
  const bool vec =
      a.st == 1 && a.sd % 4 == 0 && a.sh % 4 == 0 && a.sb % 4 == 0 && (kv & 15) == 0;
  band_attention_kernel<D, HALO, SPLIT><<<(unsigned)blocks, tile * SPLIT, smem, a.stream>>>(
      a.q, a.k, a.v, a.mask, a.out, a.H, a.T, tile, row, (int)n_tiles, a.sb, a.sh, a.st, a.sd,
      vec);
  return (int)cudaGetLastError();
}

template <int D, int HALO>
int launch_split(const Launch& a, int split) {
  switch (split) {
    case 1: return launch<D, HALO, 1>(a);
    case 2: return launch<D, HALO, 2>(a);
    case 4: return launch<D, HALO, 4>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point. q, k, v: (B, H, T, D) f32 views sharing the element strides
// (sb, sh, st, sd); mask (B, T) bytes; out (B, H, D, T) f32 contiguous. The
// window is 2*halo+1 with halo in 1..4; D must be 32 (the one head width
// instantiated). Launch plan: `tile` time columns per block (a multiple of 4
// and of 32 / split, tile * split <= 512), D split over `split` lanes (1, 2
// or 4). Returns the cudaError_t of the launch.
extern "C" int decafnet_band_attention_f32(const float* q, const float* k, const float* v,
                                           const uint8_t* mask, float* out, int B, int H,
                                           int T, int D, long long sb, long long sh,
                                           long long st, long long sd, int halo, int tile,
                                           int split, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D != 32) return (int)cudaErrorInvalidValue;
  const Launch a{q, k, v, mask, out, B, H, T, sb, sh, st, sd, tile, stream};
  switch (halo) {
    case 1: return launch_split<32, 1>(a, split);
    case 2: return launch_split<32, 2>(a, split);
    case 3: return launch_split<32, 3>(a, split);
    case 4: return launch_split<32, 4>(a, split);
    default: return (int)cudaErrorInvalidValue;
  }
}
