// Depthwise q/k/v trio for Hopper (sm_90a): three depthwise conv3 maps of
// x * mask (groups = C, zero padding 1, no bias), each followed by its own channel
// LayerNorm (biased variance, f32 statistics).
//
//   y_s[b, c, t] = sum_tap w_s[c, tap] * xm[b, c, t + tap - 1],   s in {q, k, v}
//   out_s = LN_c(y_s) * ln_w_s + ln_b_s
//
// Two variants: f32 in and out, and bf16 in and out. The bf16 one computes the
// function of the JAX bf16 composition (qkv_depthwise_ln_xla): the taps are
// rounded to bf16, each 3-tap sum is taken in f32 and rounded to bf16 (the bf16
// conv output), the LN runs in f32 on the f32 LN parameters, and the result is
// rounded once to bf16. x is staged as f32 in both, so the arithmetic below is
// one code path.
//
// Replaces the TPU kernel decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl
// (pallas_call at :370), which read x once for all three branches; so does this.
//
// What bounds it on an H100: memory. Per element it does ~9 FMAs and a few LN
// operations against 4 bytes read and 12 written (2 and 6 in bf16), far below
// the card's ~20 FLOP/byte f32 balance point. The design:
//   - a block owns one batch row and a tile of `tile` time columns, all C
//     channels; x[b, :, t0 - 1 .. t0 + tile] is staged once in shared memory,
//     the interior with 16-byte cp.async when x and its rows are 16-byte
//     aligned (4-byte copies otherwise, and for the two halo columns); bf16
//     x is read 8 columns per 16-byte load where aligned (else one element
//     per load) and converted to f32 as it is stored;
//   - the tile's mask is staged once as floats: a tile with no valid column
//     (halo included) writes ln_b, which is what the LN of an all-zero column
//     gives, and loads no x; a tile with some masked columns multiplies them
//     into the staged x once; a fully valid tile skips that pass;
//   - the 9 taps and the 6 LN vectors are staged in shared memory once per
//     block, the taps of a channel as float4s;
//   - each column is owned by CS = 4 lanes of one warp (lane part l takes
//     channels l, l + 4, ...), so the channel statistics
//     need no shared memory and no barrier: the parts' partial sums meet in
//     __shfl_xor_sync. y is recomputed from the staged x for each of three
//     passes (sum for the mean, centred squares for the variance, output),
//     9 FMAs per element on CUDA cores that are otherwise idle, so the LN is
//     two-pass as in the plain version;
//   - the staged rows are padded so that the parts of a warp read distinct
//     banks; several blocks fit on an SM, so one block's copies overlap
//     another's arithmetic and stores.
// The tile width is chosen by the wrapper (ops/fused_conv.py:qkv_depthwise_ln_plan).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace decafnet;

constexpr int PAD = 4;  // interior column offset of a staged row
constexpr int MAX_THREADS = 512;
constexpr int CS = 4;   // lanes per time column (ops/fused_conv.py:QKV_LANES)
constexpr int QW = 32 / CS;  // columns per warp

__device__ __forceinline__ float sum_over_parts(float v) {
#pragma unroll
  for (int o = 32 / CS; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// v as the element type E holds it: v itself in f32, rounded to bf16 in bf16
template <typename E>
__device__ __forceinline__ float in_e(float v) {
  return sizeof(E) == 4 ? v : __bfloat162float(__float2bfloat16(v));
}

template <typename E>
__global__ void __launch_bounds__(MAX_THREADS)
qkv_depthwise_ln_kernel(const E* __restrict__ x, const uint8_t* __restrict__ mask,
                        const float* __restrict__ wq, const float* __restrict__ wk,
                        const float* __restrict__ wv, const float* __restrict__ lwq,
                        const float* __restrict__ lbq, const float* __restrict__ lwk,
                        const float* __restrict__ lbk, const float* __restrict__ lwv,
                        const float* __restrict__ lbv, E* __restrict__ oq,
                        E* __restrict__ ok, E* __restrict__ ov, int C, int T,
                        int tile, int row, int n_tiles, float eps, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                            // [C][row]
  float4* ws = reinterpret_cast<float4*>(smem + C * row);      // [3][C] taps
  float2* ls = reinterpret_cast<float2*>(ws + 3 * C);          // [3][C] (ln_w, ln_b)
  float* mf = reinterpret_cast<float*>(ls + 3 * C);            // [tile + 2]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int tq = (tid >> 5) * QW + lane % QW;  // this thread's column in the tile
  const int part = lane / QW;                  // its share of the channels
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * tile;
  const int t = t0 + tq;
  const E* xb = x + (size_t)b * C * T;
  const uint8_t* mb = mask + (size_t)b * T;
  const float* const lb3[3] = {lbq, lbk, lbv};
  E* const o3[3] = {oq, ok, ov};

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
  if (!any) {  // LN of an all-zero column is ln_b
    if (t < T) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
        for (int c = part; c < C; c += CS) put(o3[s] + ((size_t)b * C + c) * T + t, lb3[s][c]);
    }
    return;
  }

  if constexpr (sizeof(E) == 2) {
    if (vec) {
      // 16-byte aligned rows (T % 8 == 0): 8 columns per load, to f32 in shared
      const int cpr = tile / 8;  // loads per row; nthreads / cpr == 8 * CS
      const int ch = tid % cpr;
      const int c0 = t0 + 8 * ch;
      for (int c = tid / cpr; c < C; c += 8 * CS) {
        float4* dst = reinterpret_cast<float4*>(xs + c * row + PAD + 8 * ch);
        if (c0 < T) {
          const uint4 u = *reinterpret_cast<const uint4*>(xb + (size_t)c * T + c0);
          const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
          const float2 a = __bfloat1622float2(h[0]), b2 = __bfloat1622float2(h[1]);
          const float2 c2 = __bfloat1622float2(h[2]), d2 = __bfloat1622float2(h[3]);
          dst[0] = make_float4(a.x, a.y, b2.x, b2.y);
          dst[1] = make_float4(c2.x, c2.y, d2.x, d2.y);
        } else {
          dst[0] = dst[1] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    } else {
      const int col = tid % tile;  // nthreads == tile * CS
      const bool in = t0 + col < T;
      for (int c = tid / tile; c < C; c += CS)
        xs[c * row + PAD + col] = in ? to_f32(xb[(size_t)c * T + t0 + col]) : 0.f;
    }
    for (int i = tid; i < 2 * C; i += nthreads) {
      const int c = i >> 1;
      const int col = (i & 1) ? tile : -1;
      const int j = t0 + col;
      xs[c * row + PAD + col] = (j >= 0 && j < T) ? to_f32(xb[(size_t)c * T + j]) : 0.f;
    }
  } else if (vec) {
    // 16-byte aligned rows (T % 4 == 0): 4 columns per copy
    const int cpr = tile / 4;  // copies per row; nthreads / cpr == 4 * CS
    const int ch = tid % cpr;
    const int c0 = t0 + 4 * ch;
    for (int c = tid / cpr; c < C; c += 4 * CS) {
      float* dst = xs + c * row + PAD + 4 * ch;
      if (c0 < T) {
        cp_async16(dst, xb + (size_t)c * T + c0);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    const int col = tid % tile;  // nthreads == tile * CS
    const bool in = t0 + col < T;
    for (int c = tid / tile; c < C; c += CS)
      cp_async4(xs + c * row + PAD + col, xb + (size_t)c * T + (in ? t0 + col : 0), in);
  }
  if constexpr (sizeof(E) == 4) {
    for (int i = tid; i < 2 * C; i += nthreads) {
      const int c = i >> 1;
      const int col = (i & 1) ? tile : -1;
      const int j = t0 + col;
      const bool in = j >= 0 && j < T;
      cp_async4(xs + c * row + PAD + col, xb + (size_t)c * T + (in ? j : 0), in);
    }
  }
  const float* const w3[3] = {wq, wk, wv};
  const float* const lw3[3] = {lwq, lwk, lwv};
  for (int i = tid; i < C; i += nthreads) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* w = w3[s] + 3 * i;
      ws[s * C + i] = make_float4(in_e<E>(w[0]), in_e<E>(w[1]), in_e<E>(w[2]), 0.f);
      ls[s * C + i] = make_float2(lw3[s][i], lb3[s][i]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (!all) {  // x * mask, once, in place: each part its own channels
    const float ml = mf[tq], mm = mf[tq + 1], mr = mf[tq + 2];
    for (int c = part; c < C; c += CS) {
      float* xr = xs + c * row + PAD + tq;
      xr[0] *= mm;
      if (tq == 0) xr[-1] *= ml;
      if (tq == tile - 1) xr[1] *= mr;
    }
    __syncthreads();
  }

  const float* xt = xs + PAD - 1 + tq;
  auto conv = [&](int c, float (&y)[3]) {
    const float* xr = xt + c * row;
    const float a = xr[0], m = xr[1], r = xr[2];
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float4 w = ws[s * C + c];
      y[s] = in_e<E>(fmaf(w.z, r, fmaf(w.y, m, w.x * a)));
    }
  };

  float mean[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int c = part; c < C; c += CS) {
    float y[3];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) mean[s] += y[s];
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) mean[s] = sum_over_parts(mean[s]) / (float)C;

  float rstd[3] = {0.f, 0.f, 0.f};
#pragma unroll 4
  for (int c = part; c < C; c += CS) {
    float y[3];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float d = y[s] - mean[s];
      rstd[s] = fmaf(d, d, rstd[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) rstd[s] = rsqrtf(sum_over_parts(rstd[s]) / (float)C + eps);

  if (t >= T) return;
  const size_t o0 = (size_t)b * C * T + t;
#pragma unroll 4
  for (int c = part; c < C; c += CS) {
    float y[3];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float2 l = ls[s * C + c];
      put(o3[s] + o0 + (size_t)c * T, fmaf((y[s] - mean[s]) * rstd[s], l.x, l.y));
    }
  }
}

template <typename E>
int entry(const E* x, const uint8_t* mask, const float* wq, const float* wk, const float* wv,
          const float* lwq, const float* lbq, const float* lwk, const float* lbk,
          const float* lwv, const float* lbv, E* oq, E* ok, E* ov, int B, int C, int T,
          float eps, int tile, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || T <= 0 || C > 256) return (int)cudaErrorInvalidValue;
  if (tile <= 0 || tile % 4 != 0 || tile % QW != 0 || tile * CS > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (T + tile - 1) / tile;
  if ((long long)B * n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int row = row_stride(tile, PAD, CS);
  const size_t smem = sizeof(float) * ((size_t)C * row + 12 * C + 6 * C + tile + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qkv_depthwise_ln_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // rows of 16-byte multiples: T % 4 == 0 in f32, T % 8 == 0 in bf16
  const bool vec = T % (16 / (int)sizeof(E)) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  qkv_depthwise_ln_kernel<E><<<(unsigned)(B * n_tiles), tile * CS, smem, stream>>>(
      x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, C, T, tile, row,
      (int)n_tiles, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, f32 and bf16. x (B, C, T) and the outputs (B, C, T) of one
// type; mask (B, T) bytes; w_s (C, 3) depthwise taps and the ln params (C,) in
// f32 (the bf16 variant rounds the taps to bf16); all contiguous on the
// device. Launch plan: `tile` time columns per block, a multiple of 8 (the
// columns per warp, 32 / CS) with tile * CS <= 512. Each returns the
// cudaError_t of the launch.
extern "C" int decafnet_qkv_depthwise_ln_f32(
    const float* x, const uint8_t* mask, const float* wq, const float* wk, const float* wv,
    const float* lwq, const float* lbq, const float* lwk, const float* lbk, const float* lwv,
    const float* lbv, float* oq, float* ok, float* ov, int B, int C, int T, float eps,
    int tile, cudaStream_t stream) {
  return entry(x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, B, C, T, eps,
               tile, stream);
}

extern "C" int decafnet_qkv_depthwise_ln_bf16(
    const __nv_bfloat16* x, const uint8_t* mask, const float* wq, const float* wk,
    const float* wv, const float* lwq, const float* lbq, const float* lwk, const float* lbk,
    const float* lwv, const float* lbv, __nv_bfloat16* oq, __nv_bfloat16* ok,
    __nv_bfloat16* ov, int B, int C, int T, float eps, int tile, cudaStream_t stream) {
  return entry(x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, B, C, T, eps,
               tile, stream);
}
