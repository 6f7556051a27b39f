// Banded (local-window) multi-head attention for Hopper (sm_90a) at any head
// width D and any odd window: the general kernel beside the tuned ones of
// band_attention.cu, which are built for D = 32 and windows 3..9 (the served
// model's shapes). The wrapper (ops/local_attention.py: band_attention_route)
// sends every other shape here, in f32 or bf16:
//
//   out[b, h, t] = sum_{|j - t| <= halo, 0 <= j < T, mask[b, j]} p_j * v[b, h, j]
//   p = softmax_j(q[b, h, t] . k[b, h, j])      (scores over the valid band keys)
//   rows with an invalid query, or with no valid key, are 0.
//
// Replaces, for those shapes, the TPU kernel
// decafnet_tpu/ops/local_attention.py:_band_attention_pallas_impl (pallas_call
// at :348), which takes any D and any window up to twice its chunk.
//
// What bounds it on an H100: memory, 16 * D bytes per valid query in f32 (q, k,
// v read once, the result written once; 8 * D in bf16) against ~4 * w * D
// FLOPs. The design is the simple one, right first:
//   - one thread per query (b, h, t); a block of 128 threads owns 128
//     adjacent columns of one (b, h) (flattened into blockIdx.x, so B*H is not
//     capped at 65535). With the model's head views (time-contiguous rows) the
//     lanes of a warp read 32 adjacent columns of each d-row, so every load is
//     coalesced, and a key's row, read by the 2 * halo + 1 queries whose band
//     holds it, comes from L1 after the first;
//   - pass 1 takes the band's largest score; pass 2 takes, per block of DB
//     head dims, the sum of exp(s - max) and the weighted sum of v in
//     registers, and writes that block divided by the sum. The scores are
//     recomputed in each pass (1 + ceil(D / DB) dot products per key), so
//     neither D nor the window is bounded by registers or shared memory;
//   - scores, softmax and sums in f32 (bf16 q, k and v are widened exactly);
//     the result is rounded once to bf16 in the bf16 kernel;
//   - the output is written (B, H, D, T), time-minor and coalesced, as the
//     tuned kernels write it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// q_t . k_j over the D head dims, summed in d order
template <typename E>
__device__ __forceinline__ float score(const E* qt, const E* kj, int D, long long sd) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(ld(qt + d * sd), ld(kj + d * sd), s);
  return s;
}

template <typename E, int DB>
__global__ void __launch_bounds__(THREADS)
band_attention_general_kernel(const E* __restrict__ q, const E* __restrict__ k,
                              const E* __restrict__ v, const uint8_t* __restrict__ mask,
                              E* __restrict__ out, int H, int T, int D, int halo, int n_tiles,
                              long long sb, long long sh, long long st, long long sd) {
  const int bh = blockIdx.x / n_tiles;
  const int t = (blockIdx.x - bh * n_tiles) * THREADS + threadIdx.x;
  if (t >= T) return;
  const int b = bh / H, h = bh - b * H;
  const uint8_t* mb = mask + (size_t)b * T;
  E* ob = out + (size_t)bh * D * T + t;
  const long long base = b * sb + h * sh;
  const E* qt = q + base + t * st;
  const E* kb = k + base;
  const E* vb = v + base;
  const int j0 = t - halo > 0 ? t - halo : 0;
  const int j1 = t + halo < T - 1 ? t + halo : T - 1;

  float m = -INFINITY;
  if (mb[t] != 0)
    for (int j = j0; j <= j1; ++j)
      if (mb[j] != 0) m = fmaxf(m, score(qt, kb + j * st, D, sd));
  if (m == -INFINITY) {  // an invalid query, or no valid key: zeros
    for (int d = 0; d < D; ++d) put(ob + (size_t)d * T, 0.f);
    return;
  }

  for (int d0 = 0; d0 < D; d0 += DB) {
    float acc[DB];
#pragma unroll
    for (int i = 0; i < DB; ++i) acc[i] = 0.f;
    float den = 0.f;
    for (int j = j0; j <= j1; ++j) {
      if (mb[j] == 0) continue;
      const float p = expf(score(qt, kb + j * st, D, sd) - m);
      den += p;
      const E* vj = vb + j * st + d0 * sd;
#pragma unroll
      for (int i = 0; i < DB; ++i)
        if (d0 + i < D) acc[i] = fmaf(p, ld(vj + i * sd), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < DB; ++i)
      if (d0 + i < D) put(ob + (size_t)(d0 + i) * T, acc[i] / den);
  }
}

template <typename E, int DB>
int launch(const E* q, const E* k, const E* v, const uint8_t* mask, E* out, int B, int H,
           int T, int D, long long sb, long long sh, long long st, long long sd, int halo,
           cudaStream_t stream) {
  const long long n_tiles = (T + THREADS - 1) / THREADS;
  const long long blocks = (long long)B * H * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  band_attention_general_kernel<E, DB><<<(unsigned)blocks, THREADS, 0, stream>>>(
      q, k, v, mask, out, H, T, D, halo, (int)n_tiles, sb, sh, st, sd);
  return (int)cudaGetLastError();
}

// the head dims one pass 2 sums in registers: D itself up to 16 or 32, else 64
template <typename E>
int entry(const E* q, const E* k, const E* v, const uint8_t* mask, E* out, int B, int H,
          int T, int D, long long sb, long long sh, long long st, long long sd, int halo,
          cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || halo < 0) return (int)cudaErrorInvalidValue;
  if (D <= 16) return launch<E, 16>(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, stream);
  if (D <= 32) return launch<E, 32>(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, stream);
  return launch<E, 64>(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, stream);
}

}  // namespace

// C entry points, f32 and bf16. q, k, v: (B, H, T, D) views sharing the
// element strides (sb, sh, st, sd); mask (B, T) bytes; out (B, H, D, T)
// contiguous, of q's type. Any D >= 1 and window 2 * halo + 1 with halo >= 0.
// Each returns the cudaError_t of the launch.
extern "C" int decafnet_band_attention_general_f32(const float* q, const float* k,
                                                   const float* v, const uint8_t* mask,
                                                   float* out, int B, int H, int T, int D,
                                                   long long sb, long long sh, long long st,
                                                   long long sd, int halo, cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, stream);
}

extern "C" int decafnet_band_attention_general_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const uint8_t* mask, __nv_bfloat16* out, int B, int H, int T, int D, long long sb,
    long long sh, long long st, long long sd, int halo, cudaStream_t stream) {
  return entry(q, k, v, mask, out, B, H, T, D, sb, sh, st, sd, halo, stream);
}
