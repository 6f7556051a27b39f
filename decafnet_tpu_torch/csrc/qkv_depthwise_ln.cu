// Depthwise q/k/v trio for Hopper (sm_90a): three depthwise conv3 maps of
// x * mask (groups = C, zero padding 1, no bias), each followed by its own channel
// LayerNorm (biased variance, f32 statistics).
//
//   y_s[b, c, t] = sum_tap w_s[c, tap] * xm[b, c, t + tap - 1],   s in {q, k, v}
//   out_s = LN_c(y_s) * ln_w_s + ln_b_s
//
// Two kernels: f32 in and out, and bf16 in and out. The bf16 one computes the
// function of the JAX bf16 composition (qkv_depthwise_ln_xla): the taps are
// rounded to bf16, each 3-tap sum is taken in f32 and rounded to bf16 (the bf16
// conv output), the LN runs in f32 on the f32 LN parameters, and the result is
// rounded once to bf16.
//
// Replaces the TPU kernel decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl
// (pallas_call at :370), which read x once for all three branches; so does this.
//
// What bounds it on an H100: memory. Per element it does ~9 FMAs and a few LN
// operations against 4 bytes read and 12 written (2 and 6 in bf16), far below
// the card's ~20 FLOP/byte f32 balance point. The f32 design:
//   - a block owns one batch row and a tile of `tile` time columns, all C
//     channels; x[b, :, t0 - 1 .. t0 + tile] is staged once in shared memory,
//     the interior with 16-byte cp.async when x and its rows are 16-byte
//     aligned (4-byte copies otherwise, and for the two halo columns);
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
// The bf16 kernel keeps that design with two changes. The first bf16 variant
// shared the f32 kernel and was slower than it on half the bytes: it read bf16
// x with synchronous loads and widened it to f32 in shared memory (no overlap,
// twice the bytes), and each lane stored one 2-byte element per channel and
// output, so eight lanes covered half a 32-byte sector. Here x is staged as
// bf16 with 16-byte cp.async (8 columns per copy; synchronous 2-byte loads
// where T % 8 != 0 or x is not 16-byte aligned) and widened to f32 as it is
// read: one 4-byte shared load gives two columns. Each lane owns two adjacent
// columns (still 4 lanes per column pair, 8 pairs per warp), so each store of
// q, k and v is a bf16x2 and the 8 lanes of a part write 32 contiguous bytes,
// a whole sector. The taps (rounded to bf16) and the LN parameters stay
// staged in shared memory per block: read through L1 from prepared tables in
// the inner loops instead, the kernel was slower on an H100 (PERF.md).
// The tile widths are chosen by the wrapper (ops/fused_conv.py:qkv_depthwise_ln_plan).

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

__global__ void __launch_bounds__(MAX_THREADS)
qkv_depthwise_ln_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                        const float* __restrict__ wq, const float* __restrict__ wk,
                        const float* __restrict__ wv, const float* __restrict__ lwq,
                        const float* __restrict__ lbq, const float* __restrict__ lwk,
                        const float* __restrict__ lbk, const float* __restrict__ lwv,
                        const float* __restrict__ lbv, float* __restrict__ oq,
                        float* __restrict__ ok, float* __restrict__ ov, int C, int T,
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
  const float* xb = x + (size_t)b * C * T;
  const uint8_t* mb = mask + (size_t)b * T;
  const float* const lb3[3] = {lbq, lbk, lbv};
  float* const o3[3] = {oq, ok, ov};

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
        for (int c = part; c < C; c += CS) o3[s][((size_t)b * C + c) * T + t] = lb3[s][c];
    }
    return;
  }

  if (vec) {
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
  for (int i = tid; i < 2 * C; i += nthreads) {
    const int c = i >> 1;
    const int col = (i & 1) ? tile : -1;
    const int j = t0 + col;
    const bool in = j >= 0 && j < T;
    cp_async4(xs + c * row + PAD + col, xb + (size_t)c * T + (in ? j : 0), in);
  }
  const float* const w3[3] = {wq, wk, wv};
  const float* const lw3[3] = {lwq, lwk, lwv};
  for (int i = tid; i < C; i += nthreads) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* w = w3[s] + 3 * i;
      ws[s * C + i] = make_float4(w[0], w[1], w[2], 0.f);
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
      y[s] = fmaf(w.z, r, fmaf(w.y, m, w.x * a));
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
      o3[s][o0 + (size_t)c * T] = fmaf((y[s] - mean[s]) * rstd[s], l.x, l.y);
    }
  }
}


// ------------------------------------------------------------------ bf16

constexpr int BPAD = 8;        // interior column offset of a staged bf16 row (16 bytes)
constexpr int BPW = 32 / CS;   // column pairs per warp

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// the two bf16 of a 32-bit word as floats (exact: a bf16 is the high half of
// its f32)
__device__ __forceinline__ float lo_f32(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f32(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void __launch_bounds__(MAX_THREADS)
qkv_depthwise_ln_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
                             const float* __restrict__ wq, const float* __restrict__ wk,
                             const float* __restrict__ wv, const float* __restrict__ lwq,
                             const float* __restrict__ lbq, const float* __restrict__ lwk,
                             const float* __restrict__ lbk, const float* __restrict__ lwv,
                             const float* __restrict__ lbv, __nv_bfloat16* __restrict__ oq,
                             __nv_bfloat16* __restrict__ ok, __nv_bfloat16* __restrict__ ov,
                             int C, int T, int tile, int row, int n_tiles, float eps, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);      // [C][row]
  float4* ws = reinterpret_cast<float4*>(xs + (size_t)C * row);     // [3][C] taps
  float2* ls = reinterpret_cast<float2*>(ws + 3 * C);               // [3][C] (ln_w, ln_b)
  float* mf = reinterpret_cast<float*>(ls + 3 * C);                 // [tile + 2]

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const int tc = 2 * ((tid >> 5) * BPW + lane % BPW);  // this thread's columns tc, tc + 1
  const int part = lane / BPW;                          // its share of the channels
  const int b = blockIdx.x / n_tiles;
  const int t0 = (blockIdx.x - b * n_tiles) * tile;
  const int t = t0 + tc;
  const __nv_bfloat16* xb = x + (size_t)b * C * T;
  const uint8_t* mb = mask + (size_t)b * T;
  const float* const lb3[3] = {lbq, lbk, lbv};
  __nv_bfloat16* const o3[3] = {oq, ok, ov};
  // columns t, t + 1 as one 4-byte store where both are in and aligned
  const bool pair = (T & 1) == 0 && t + 1 < T;
  auto put2 = [&](__nv_bfloat16* o, float y0, float y1) {
    if (pair) {
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
    } else {
      if (t < T) o[0] = __float2bfloat16(y0);
      if (t + 1 < T) o[1] = __float2bfloat16(y1);
    }
  };

  // the tile's mask columns: one per thread at most (2 * tile threads), so
  // one barrier counts the valid ones
  bool mine = false;
  for (int i = tid; i < tile + 2; i += nthreads) {
    const int j = t0 - 1 + i;
    const bool m = j >= 0 && j < T && mb[j] != 0;
    mf[i] = m ? 1.f : 0.f;
    mine = m;
  }
  const int n_in = __syncthreads_count(mine);
  const bool any = n_in > 0, all = n_in == tile + 2;
  if (!any) {  // LN of an all-zero column is ln_b
    if (t < T) {
#pragma unroll
      for (int s = 0; s < 3; ++s)
        for (int c = part; c < C; c += CS) {
          const float l = lb3[s][c];
          put2(o3[s] + ((size_t)b * C + c) * T + t, l, l);
        }
    }
    return;
  }

  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {
    // 16-byte aligned rows (T % 8 == 0): 8 columns per copy
    const int cpr = tile / 8;
    for (int i = tid; i < C * cpr; i += nthreads) {
      const int c = i / cpr, j = 8 * (i - c * cpr);
      const bool in = t0 + j < T;
      cp_async16(xs + c * row + BPAD + j, in ? xb + (size_t)c * T + t0 + j : x, in);
    }
  } else {
    for (int i = tid; i < C * tile; i += nthreads) {
      const int c = i / tile, j = i - c * tile;
      xs[c * row + BPAD + j] = t0 + j < T ? xb[(size_t)c * T + t0 + j] : zero;
    }
  }
  for (int i = tid; i < 2 * C; i += nthreads) {
    const int c = i >> 1;
    const int col = (i & 1) ? tile : -1;
    const int j = t0 + col;
    xs[c * row + BPAD + col] = (j >= 0 && j < T) ? xb[(size_t)c * T + j] : zero;
  }
  const float* const w3[3] = {wq, wk, wv};
  const float* const lw3[3] = {lwq, lwk, lwv};
  for (int i = tid; i < C; i += nthreads) {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* w = w3[s] + 3 * i;
      ws[s * C + i] = make_float4(round_bf16(w[0]), round_bf16(w[1]), round_bf16(w[2]), 0.f);
      ls[s * C + i] = make_float2(lw3[s][i], lb3[s][i]);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (!all) {  // x * mask, once, in place, on the masked columns only
    for (int i = tid; i < C * (tile + 2); i += nthreads) {
      const int c = i / (tile + 2), j = i - c * (tile + 2);
      __nv_bfloat16* v = xs + c * row + BPAD - 1 + j;
      if (mf[j] == 0.f) *v = __float2bfloat16(__bfloat162float(*v) * 0.f);
    }
    __syncthreads();
  }

  // words of columns (tc - 2, tc - 1), (tc, tc + 1), (tc + 2, tc + 3)
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(xs + BPAD + tc);
  const int roww = row / 2;
  auto conv = [&](int c, float (&y)[3][2]) {
    const uint32_t* r = xw + c * roww;
    const uint32_t u = r[-1], v = r[0], z = r[1];
    const float a = hi_f32(u), m0 = lo_f32(v), m1 = hi_f32(v), r0 = lo_f32(z);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float4 w = ws[s * C + c];
      // both columns rounded to bf16 by one conversion
      const __nv_bfloat162 h = __floats2bfloat162_rn(fmaf(w.z, m1, fmaf(w.y, m0, w.x * a)),
                                                     fmaf(w.z, r0, fmaf(w.y, m1, w.x * m0)));
      const uint32_t u2 = *reinterpret_cast<const uint32_t*>(&h);
      y[s][0] = lo_f32(u2);
      y[s][1] = hi_f32(u2);
    }
  };

  float mean[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int c = part; c < C; c += CS) {
    float y[3][2];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      mean[s][0] += y[s][0];
      mean[s][1] += y[s][1];
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int p = 0; p < 2; ++p) mean[s][p] = sum_over_parts(mean[s][p]) / (float)C;

  float rstd[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
#pragma unroll 4
  for (int c = part; c < C; c += CS) {
    float y[3][2];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const float d = y[s][p] - mean[s][p];
        rstd[s][p] = fmaf(d, d, rstd[s][p]);
      }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int p = 0; p < 2; ++p)
      rstd[s][p] = rsqrtf(sum_over_parts(rstd[s][p]) / (float)C + eps);

  if (t >= T) return;
  const size_t o0 = (size_t)b * C * T + t;
#pragma unroll 4
  for (int c = part; c < C; c += CS) {
    float y[3][2];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float2 l = ls[s * C + c];
      put2(o3[s] + o0 + (size_t)c * T, fmaf((y[s][0] - mean[s][0]) * rstd[s][0], l.x, l.y),
           fmaf((y[s][1] - mean[s][1]) * rstd[s][1], l.x, l.y));
    }
  }
}

}  // namespace

// C entry points, f32 and bf16. x (B, C, T) and the outputs (B, C, T) of one
// type; mask (B, T) bytes; w_s (C, 3) depthwise taps and the ln params (C,) in
// f32 (the bf16 variant rounds the taps to bf16); all contiguous on the
// device. Launch plan: `tile` time columns per block; in f32 a multiple of 8
// (the columns per warp, 32 / CS) with tile * CS <= 512, in bf16 a multiple of
// 16 (the columns per warp, 2 * 32 / CS) with 2 * tile <= 512. Each returns the
// cudaError_t of the launch.
extern "C" int decafnet_qkv_depthwise_ln_f32(
    const float* x, const uint8_t* mask, const float* wq, const float* wk, const float* wv,
    const float* lwq, const float* lbq, const float* lwk, const float* lbk, const float* lwv,
    const float* lbv, float* oq, float* ok, float* ov, int B, int C, int T, float eps,
    int tile, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || T <= 0 || C > 256) return (int)cudaErrorInvalidValue;
  if (tile <= 0 || tile % 4 != 0 || tile % QW != 0 || tile * CS > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (T + tile - 1) / tile;
  if ((long long)B * n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int row = row_stride(tile, PAD, CS);
  const size_t smem = sizeof(float) * ((size_t)C * row + 12 * C + 6 * C + tile + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qkv_depthwise_ln_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // rows of 16-byte multiples
  const bool vec = T % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  qkv_depthwise_ln_kernel<<<(unsigned)(B * n_tiles), tile * CS, smem, stream>>>(
      x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, C, T, tile, row,
      (int)n_tiles, eps, vec);
  return (int)cudaGetLastError();
}

extern "C" int decafnet_qkv_depthwise_ln_bf16(
    const __nv_bfloat16* x, const uint8_t* mask, const float* wq, const float* wk,
    const float* wv, const float* lwq, const float* lbq, const float* lwk, const float* lbk,
    const float* lwv, const float* lbv, __nv_bfloat16* oq, __nv_bfloat16* ok,
    __nv_bfloat16* ov, int B, int C, int T, float eps, int tile, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || T <= 0 || C > 256) return (int)cudaErrorInvalidValue;
  if (tile <= 0 || tile % (2 * BPW) != 0 || 2 * tile > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  const long long n_tiles = (T + tile - 1) / tile;
  if ((long long)B * n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const int row = row_stride(tile, BPAD, CS, 2);
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)C * row +
                      sizeof(float) * (12 * C + 6 * C + tile + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        qkv_depthwise_ln_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // rows of 16-byte multiples
  const bool vec = T % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  qkv_depthwise_ln_bf16_kernel<<<(unsigned)(B * n_tiles), 2 * tile, smem, stream>>>(
      x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, C, T, tile, row,
      (int)n_tiles, eps, vec);
  return (int)cudaGetLastError();
}
