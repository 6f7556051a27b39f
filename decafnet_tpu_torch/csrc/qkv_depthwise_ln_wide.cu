// Depthwise q/k/v trio for Hopper (sm_90a) at C above the tuned kernels'
// 256 channels, up to 4096: the tuned kernel's staged tile (qkv_depthwise_ln.cu),
// its channels split over a thread-block cluster. In f32 or bf16:
//
//   y_s[b, c, t] = sum_tap w_s[c, tap] * xm[b, c, t + tap - 1],   s in {q, k, v}
//   out_s = LN_c(y_s) * ln_w_s + ln_b_s
//
// The bf16 kernel computes the function of the bf16 composition, as the tuned
// bf16 kernel does: the taps rounded to bf16, each 3-tap sum in f32 rounded to
// bf16, the LN in f32 on the f32 LN parameters, the result rounded once.
//
// Replaces, for C > 256, the TPU kernel
// decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl (pallas_call at
// :370), which reads x once for all three branches; so does this kernel.
//
// What bounds it on an H100: memory, 16 bytes per element in f32 (x read
// once, q, k and v written once; 8 in bf16) against ~40 FLOPs. The general
// kernel (qkv_depthwise_ln_general.cu) read x three times from global memory,
// one thread per column walking all C channels. Here:
//   - a cluster of `cluster` blocks owns one batch row and a tile of `tile`
//     time columns; block r of the cluster owns channels r * cpb .. r * cpb +
//     cpb - 1 (cpb = ceil(C / cluster)) and stages them, `chunk` channels at a
//     time, as x[b, c, t0 - 1 .. t0 + tile] in shared memory by cp.async: 16-,
//     8- or 4-byte copies, the widest the rows' alignment allows (bf16 rows
//     on 2 bytes only by single loads), the two halo columns by 4-byte copies
//     (in bf16 the 4-byte word that holds the halo element, where T is even);
//   - the tile's mask is staged as floats: a tile with no valid column (halo
//     included) writes ln_b and loads no x; a partly masked tile multiplies
//     its masked columns into the staged x once per chunk;
//   - the chunk's taps (rounded to bf16 once, in bf16) and LN vectors are
//     staged beside it;
//   - as in the tuned kernel, each column (bf16: each pair of adjacent
//     columns, stored as a bf16x2) is owned by CS = 4 lanes of one warp, each
//     of which takes every fourth channel; the lanes meet in __shfl_xor_sync,
//     and y is recomputed from shared memory for each pass;
//   - statistics, per branch and column: each lane runs Welford's update
//     over its channels of a chunk, one pass where the tuned kernel takes
//     two (the sum for the mean, then the centred squares: 3 % slower at
//     the median plan on an H100); the lanes, the chunks, and then the
//     blocks of the cluster merge (count, mean, M2) by Chan's formula, the
//     blocks in rank order
//     through distributed shared memory (mapa + ld.shared::cluster), so
//     every block of a cluster holds the same statistics;
//   - the output pass recomputes y from the staged chunk; with more than one
//     chunk, the last one staged is written first and the others are staged
//     again (from L2: the tile's x was read from device memory moments
//     before).
// The wrapper's plan (ops/fused_conv.py: qkv_wide_plan) picks the cluster, tile
// and chunk: at most 128 channels a block at once, on the tuned kernel's
// 64-column tiles (f32 4 blocks of 48 KB a multiprocessor, bf16 more).
// scripts/torch_trio_wide_variants.py times every plan, the two-pass
// statistics and other register budgets, and the alternatives: one block
// with narrower tiles, one block re-reading its chunks from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "hopper.cuh"

namespace {

using namespace decafnet;

constexpr int SMEM_LIMIT = 232448;  // shared memory of one block (H100)
constexpr int MAX_C = 4096;         // the widest C the kernels take
constexpr int MAX_CLUSTER = 8;      // the portable cluster size
constexpr int MAX_THREADS = 256;
constexpr int CS = 4;               // lanes per column (bf16: column pair)
constexpr int QW = 32 / CS;         // columns (pairs) per warp

// (mean, M2) of n values merged with (mb, qb) of nb others (Chan et al.)
__device__ __forceinline__ void merge(float n, float nb, float& mean, float& m2, float mb,
                                      float qb) {
  const float nn = n + nb, d = mb - mean;
  mean = fmaf(d, nb / nn, mean);
  m2 += fmaf(d * d, n * nb / nn, qb);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// the two bf16 of a 32-bit word as floats (exact: a bf16 is the high half of
// its f32)
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

struct Params {
  const float* w[3];   // (C, 3) taps of q, k, v
  const float* lw[3];  // (C,) LN scales
  const float* lb[3];  // (C,) LN shifts
};

struct Shape {
  int C, T, tile, row, cpb, chunk, n_tiles, copy;
  float eps;
};

// blocks of MAX_THREADS a multiprocessor holds by registers: f32 4 (64
// registers a thread), bf16 3 (80); the fastest of 2, 3 and 4 in each dtype
// at C 512 and 1024 on an H100 (scripts/torch_trio_wide_variants.py)
template <typename E>
constexpr int min_blocks() {
  return sizeof(E) == 2 ? 3 : 4;
}

template <typename E>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks<E>())
qkv_depthwise_ln_wide_kernel(const E* __restrict__ x, const uint8_t* __restrict__ mask,
                             const Params p, E* __restrict__ oq, E* __restrict__ ok,
                             E* __restrict__ ov, const Shape sh) {
  constexpr bool BF16 = sizeof(E) == 2;
  constexpr int V = BF16 ? 2 : 1;           // columns per lane
  constexpr int PADE = 16 / (int)sizeof(E);  // interior offset of a staged row (16 bytes)
  const int C = sh.C, T = sh.T, tile = sh.tile, row = sh.row, chunk = sh.chunk;

  extern __shared__ __align__(16) uint8_t smem[];
  E* xs = reinterpret_cast<E*>(smem);                             // [chunk][row]
  float4* ws = reinterpret_cast<float4*>(xs + (size_t)chunk * row);  // [3][chunk] taps
  float2* ls = reinterpret_cast<float2*>(ws + 3 * chunk);         // [3][chunk] (ln_w, ln_b)
  float* mf = reinterpret_cast<float*>(ls + 3 * chunk);           // [tile + 2]
  float2* xch = reinterpret_cast<float2*>(mf + tile + 2);         // [3][tile] (mean, M2)

  const int tid = threadIdx.x, nthreads = blockDim.x, lane = tid & 31;
  const int tq = V * ((tid >> 5) * QW + lane % QW);  // this lane's first column in the tile
  const int part = lane / QW;                         // its share of the channels
  const uint32_t cl = cluster_size(), rank = cluster_rank();
  const int item = cluster_id();
  const int b = item / sh.n_tiles;
  const int t0 = (item - b * sh.n_tiles) * tile;
  const int t = t0 + tq;
  const int c_beg = (int)rank * sh.cpb;
  const int c_end = min(C, c_beg + sh.cpb);
  const uint8_t* mb = mask + (size_t)b * T;
  E* const o3[3] = {oq, ok, ov};

  // columns t, t + 1 of a bf16 lane as one 4-byte store where both are in
  // and aligned
  const bool pair = (T & 1) == 0 && t + 1 < T;
  auto put = [&](E* o, const float (&y)[V]) {
    if constexpr (BF16) {
      if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y[0], y[V - 1]);
      } else {
        if (t < T) o[0] = __float2bfloat16(y[0]);
        if (t + 1 < T) o[1] = __float2bfloat16(y[V - 1]);
      }
    } else {
      if (t < T) o[0] = y[0];
    }
  };

  bool any = false, all = true;
  for (int i = tid; i < tile + 2; i += nthreads) {
    const int j = t0 - 1 + i;
    const bool m = j >= 0 && j < T && mb[j] != 0;
    mf[i] = m ? 1.f : 0.f;
    any = any || m;
    all = all && m;
  }
  any = __syncthreads_or(any);
  all = __syncthreads_and(all);
  if (!any) {  // LN of an all-zero column is ln_b; every block of the cluster is here
#pragma unroll
    for (int s = 0; s < 3; ++s)
      for (int c = c_beg + part; c < c_end; c += CS) {
        const float l = p.lb[s][c];
        float y[V];
#pragma unroll
        for (int v = 0; v < V; ++v) y[v] = l;
        put(o3[s] + ((size_t)b * C + c) * T + t, y);
      }
    return;
  }

  // x[b, c0 .. c0 + nc - 1, t0 - 1 .. t0 + tile], the taps and LN vectors of
  // those channels, and the mask multiplied in
  auto stage = [&](int c0, int nc) {
    const E* xb = x + ((size_t)b * C + c0) * T;
    const int copy = sh.copy;
    if (copy >= 4) {
      const int per = copy / (int)sizeof(E);  // columns per copy
      const int cpr = tile / per;             // copies per row
      for (int i = tid; i < nc * cpr; i += nthreads) {
        const int c = i / cpr, j = (i - c * cpr) * per;
        const bool in = t0 + j < T;  // T is a multiple of per
        E* dst = xs + c * row + PADE + j;
        const E* src = in ? xb + (size_t)c * T + t0 + j : x;
        if (copy == 16)
          cp_async16(dst, src, in);
        else if (copy == 8)
          cp_async8(dst, src, in);
        else
          cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), in);
      }
    } else {  // bf16 rows on 2 bytes
      for (int i = tid; i < nc * tile; i += nthreads) {
        const int c = i / tile, j = i - c * tile;
        xs[c * row + PADE + j] = t0 + j < T ? xb[(size_t)c * T + t0 + j] : E(0.f);
      }
    }
    for (int i = tid; i < 2 * nc; i += nthreads) {
      const int c = i >> 1;
      const bool right = i & 1;
      const int j = right ? t0 + tile : t0 - 1;
      const bool in = j >= 0 && j < T;
      if (!BF16) {
        cp_async4(reinterpret_cast<float*>(xs + c * row + PADE + (right ? tile : -1)),
                  reinterpret_cast<const float*>(in ? xb + (size_t)c * T + j : x), in);
      } else if (copy >= 4) {
        // the 4-byte word holding the halo element: (t0 - 2, t0 - 1) or
        // (t0 + tile, t0 + tile + 1), both in when its element is (T even)
        const int dj = right ? tile : -2;
        cp_async4(reinterpret_cast<float*>(xs + c * row + PADE + dj),
                  reinterpret_cast<const float*>(in ? xb + (size_t)c * T + t0 + dj : x), in);
      } else {
        xs[c * row + PADE + (right ? tile : -1)] = in ? xb[(size_t)c * T + j] : E(0.f);
      }
    }
    for (int i = tid; i < nc; i += nthreads) {
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float* w = p.w[s] + 3 * (c0 + i);
        ws[s * chunk + i] = BF16 ? make_float4(round_bf16(w[0]), round_bf16(w[1]),
                                               round_bf16(w[2]), 0.f)
                                 : make_float4(w[0], w[1], w[2], 0.f);
        ls[s * chunk + i] = make_float2(p.lw[s][c0 + i], p.lb[s][c0 + i]);
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (!all) {  // x * mask, in place, on the masked columns only
      for (int i = tid; i < nc * (tile + 2); i += nthreads) {
        const int c = i / (tile + 2), j = i - c * (tile + 2);
        if (mf[j] == 0.f) {
          E* v = xs + c * row + PADE - 1 + j;
          if constexpr (BF16)
            *v = __float2bfloat16(__bfloat162float(*v) * 0.f);
          else
            *v *= 0.f;
        }
      }
      __syncthreads();
    }
  };

  // y of the three branches at this lane's columns, channel c of the chunk
  auto conv = [&](int c, float (&y)[3][V]) {
    if constexpr (BF16) {
      // words of columns (tq - 2, tq - 1), (tq, tq + 1), (tq + 2, tq + 3)
      const uint32_t* r = reinterpret_cast<const uint32_t*>(xs + c * row + PADE + tq);
      const uint32_t u = r[-1], v = r[0], z = r[1];
      const float a = hi_f32(u), m0 = lo_f32(v), m1 = hi_f32(v), r0 = lo_f32(z);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float4 w = ws[s * chunk + c];
        // both columns rounded to bf16 by one conversion
        const __nv_bfloat162 h = __floats2bfloat162_rn(fmaf(w.z, m1, fmaf(w.y, m0, w.x * a)),
                                                       fmaf(w.z, r0, fmaf(w.y, m1, w.x * m0)));
        const uint32_t u2 = *reinterpret_cast<const uint32_t*>(&h);
        y[s][0] = lo_f32(u2);
        y[s][V - 1] = hi_f32(u2);
      }
    } else {
      const float* xr = reinterpret_cast<const float*>(xs) + c * row + PADE - 1 + tq;
      const float a = xr[0], m = xr[1], r = xr[2];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float4 w = ws[s * chunk + c];
        y[s][0] = fmaf(w.z, r, fmaf(w.y, m, w.x * a));
      }
    }
  };

  // statistics of the block's channels: per chunk its mean and M2, merged
  float n = 0.f, mean[3][V] = {}, m2[3][V] = {};
  int c_last = c_beg;
  for (int c0 = c_beg; c0 < c_end; c0 += chunk) {
    const int nc = min(chunk, c_end - c0);
    if (c0 != c_beg) __syncthreads();  // every lane is done with the last chunk
    stage(c0, nc);
    c_last = c0;
    float mk[3][V], qk[3][V];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) mk[s][v] = qk[s][v] = 0.f;
    // one pass: each lane's running (mean, M2) over its channels, then
    // the 4 lanes of a column merged, the lower part first in both lanes
    // of a pair (so both hold the same values)
    int k = 0;
#pragma unroll 4
    for (int c = part; c < nc; c += CS) {
      float y[3][V];
      conv(c, y);
      const float inv = __frcp_rn((float)++k);
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = y[s][v] - mk[s][v];
          mk[s][v] = fmaf(d, inv, mk[s][v]);
          qk[s][v] = fmaf(d, y[s][v] - mk[s][v], qk[s][v]);
        }
    }
    float nl = (float)k;
#pragma unroll
    for (int o = QW; o < 32; o <<= 1) {
      const bool upper = lane & o;
      const float nb = __shfl_xor_sync(0xffffffffu, nl, o);
      const float na = upper ? nb : nl, nu = upper ? nl : nb;
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float mb = __shfl_xor_sync(0xffffffffu, mk[s][v], o);
          const float qb = __shfl_xor_sync(0xffffffffu, qk[s][v], o);
          float ma = upper ? mb : mk[s][v], qa = upper ? qb : qk[s][v];
          const float mu = upper ? mk[s][v] : mb, qu = upper ? qk[s][v] : qb;
          if (na == 0.f) {
            ma = mu;
            qa = qu;
          } else if (nu > 0.f) {
            merge(na, nu, ma, qa, mu, qu);
          }
          mk[s][v] = ma;
          qk[s][v] = qa;
        }
      nl += nb;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (c0 == c_beg) {
          mean[s][v] = mk[s][v];
          m2[s][v] = qk[s][v];
        } else {
          merge(n, (float)nc, mean[s][v], m2[s][v], mk[s][v], qk[s][v]);
        }
      }
    n += (float)nc;
  }

  // the cluster's statistics: every block merges all blocks' in rank order
  if (cl > 1) {
    if (part == 0) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) xch[s * tile + tq + v] = make_float2(mean[s][v], m2[s][v]);
    }
    cluster_arrive();
    cluster_wait();
    float tm[3][V], tq2[3][V], tn = 0.f;
    for (uint32_t r = 0; r < cl; ++r) {
      const float nr = (float)min(sh.cpb, C - (int)r * sh.cpb);
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float2 e = ld_peer(&xch[s * tile + tq + v], r);
          if (r == 0) {
            tm[s][v] = e.x;
            tq2[s][v] = e.y;
          } else {
            merge(tn, nr, tm[s][v], tq2[s][v], e.x, e.y);
          }
        }
      tn += nr;
    }
    // this block is done reading its peers; it waits for them before it
    // exits (they read its exchange)
    cluster_arrive();
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        mean[s][v] = tm[s][v];
        m2[s][v] = tq2[s][v];
      }
  }
  float rstd[3][V];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int v = 0; v < V; ++v) rstd[s][v] = rsqrtf(m2[s][v] / (float)C + sh.eps);

  // the outputs: the chunk still staged first, then the others staged again
  for (int c0 = c_last; c0 >= c_beg; c0 -= chunk) {
    const int nc = min(chunk, c_end - c0);
    if (c0 != c_last) {
      __syncthreads();
      stage(c0, nc);
    }
    const size_t o0 = ((size_t)b * C + c0) * T + t;
#pragma unroll 4
    for (int c = part; c < nc; c += CS) {
      float y[3][V];
      conv(c, y);
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float2 l = ls[s * chunk + c];
        float o[V];
#pragma unroll
        for (int v = 0; v < V; ++v) o[v] = fmaf((y[s][v] - mean[s][v]) * rstd[s][v], l.x, l.y);
        put(o3[s] + o0 + (size_t)c * T, o);
      }
    }
  }
  if (cl > 1) cluster_wait();
}

// Row stride of a staged chunk, in elements: cp_async.cuh's row_stride for
// CS lanes a column (distinct banks for the lanes of a column).
template <typename E>
int wide_row(int tile) {
  return row_stride(tile, 16 / (int)sizeof(E), CS, (int)sizeof(E));
}

// Shared memory bytes of a block: the staged chunk, its taps and LN vectors,
// the mask columns and the cluster's exchange. Mirrored by
// ops/fused_conv.py: qkv_wide_smem.
template <typename E>
size_t wide_smem(int tile, int chunk) {
  return sizeof(E) * (size_t)chunk * wide_row<E>(tile) + (size_t)(3 * 16 + 3 * 8) * chunk +
         4 * (size_t)(tile + 2) + 3 * 8 * (size_t)tile;
}

template <typename E>
int entry(const E* x, const uint8_t* mask, const Params& p, E* oq, E* ok, E* ov, int B, int C,
          int T, float eps, int cluster, int tile, int chunk, cudaStream_t stream) {
  constexpr int V = sizeof(E) == 2 ? 2 : 1;
  if (B <= 0 || C <= 0 || C > MAX_C || T <= 0) return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > MAX_CLUSTER || tile <= 0 || tile % (V * QW) != 0 ||
      CS * tile / V > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const int cpb = (C + cluster - 1) / cluster;
  // every block of a cluster owns some channels; a chunk is at most a block's
  if ((cluster - 1) * cpb >= C || chunk < 1 || chunk > cpb) return (int)cudaErrorInvalidValue;
  const size_t smem = wide_smem<E>(tile, chunk);
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (T + tile - 1) / tile;
  if ((long long)B * n_tiles * cluster > INT_MAX) return (int)cudaErrorInvalidValue;
  // the widest copy the rows' alignment allows
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  const long long row_bytes = (long long)T * sizeof(E);
  int copy = (int)sizeof(E);
  const int widths[3] = {16, 8, 4};
  for (int w : widths)
    if (row_bytes % w == 0 && base % w == 0) {
      copy = w;
      break;
    }
  const Shape sh{C, T, tile, wide_row<E>(tile), cpb, chunk, (int)n_tiles, copy, eps};
  auto kernel = qkv_depthwise_ln_wide_kernel<E>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * n_tiles * cluster));
  cfg.blockDim = dim3(CS * tile / V);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, x, mask, p, oq, ok, ov, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, f32 and bf16, with the arguments of the other trio kernels
// (qkv_depthwise_ln.cu) and a launch plan: x (B, C, T) and the outputs
// (B, C, T) of one type; mask (B, T) bytes; w_s (C, 3) taps and the LN params
// (C,) in f32 (the bf16 kernel rounds the taps to bf16); all contiguous on the
// device; C up to 4096. Plan: `cluster` blocks (1 to 8) split the channels,
// ceil(C / cluster) each, every block some; `tile` time columns per block, a
// multiple of the columns of a warp (f32 8, bf16 16) with 4 lanes a column
// (pair) and at most 512 threads; `chunk` channels staged at once, at most a
// block's; the block's shared memory within 227 KB. Each returns the
// cudaError_t of the launch (cudaErrorInvalidValue for arguments outside the
// kernel's envelope).
extern "C" int decafnet_qkv_depthwise_ln_wide_f32(
    const float* x, const uint8_t* mask, const float* wq, const float* wk, const float* wv,
    const float* lwq, const float* lbq, const float* lwk, const float* lbk, const float* lwv,
    const float* lbv, float* oq, float* ok, float* ov, int B, int C, int T, float eps,
    int cluster, int tile, int chunk, cudaStream_t stream) {
  const Params p{{wq, wk, wv}, {lwq, lwk, lwv}, {lbq, lbk, lbv}};
  return entry(x, mask, p, oq, ok, ov, B, C, T, eps, cluster, tile, chunk, stream);
}

extern "C" int decafnet_qkv_depthwise_ln_wide_bf16(
    const __nv_bfloat16* x, const uint8_t* mask, const float* wq, const float* wk,
    const float* wv, const float* lwq, const float* lbq, const float* lwk, const float* lbk,
    const float* lwv, const float* lbv, __nv_bfloat16* oq, __nv_bfloat16* ok,
    __nv_bfloat16* ov, int B, int C, int T, float eps, int cluster, int tile, int chunk,
    cudaStream_t stream) {
  const Params p{{wq, wk, wv}, {lwq, lwk, lwv}, {lbq, lbk, lbv}};
  return entry(x, mask, p, oq, ok, ov, B, C, T, eps, cluster, tile, chunk, stream);
}
