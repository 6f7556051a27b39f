// Depthwise q/k/v trio for Hopper (sm_90a) at any channel count: the general
// kernel beside the tuned ones of qkv_depthwise_ln.cu, which stage all C
// channels of a tile in shared memory and are built for C <= 256. The wrapper
// (ops/fused_conv.py: qkv_route) sends wider inputs here, in f32 or bf16:
//
//   y_s[b, c, t] = sum_tap w_s[c, tap] * xm[b, c, t + tap - 1],   s in {q, k, v}
//   out_s = LN_c(y_s) * ln_w_s + ln_b_s
//
// In bf16 it computes the function of the bf16 composition, as the tuned bf16
// kernel does: the taps rounded to bf16, each 3-tap sum in f32 rounded to bf16,
// the LN in f32 on the f32 LN parameters, the result rounded once.
//
// Replaces, for C > 256, the TPU kernel
// decafnet_tpu/ops/fused_conv.py:_qkv_depthwise_ln_pallas_impl (pallas_call at
// :370), which read x once for all three branches; so does each pass here.
//
// What bounds it on an H100: memory, 16 bytes per element in f32 (x read, q, k
// and v written; 8 in bf16) against ~40 FLOPs. The design is the simple one:
// a thread per time column, a block of 128 adjacent columns of one row, and
// the channel LN in three passes over the channels, each recomputing the three
// convs from x (the sums for the means, the centred squares, the outputs), so
// no channel count is bounded by registers or shared memory. A warp's 32
// columns of one channel are one coalesced load or store; the column's two
// neighbours come from L1, and the taps and LN parameters of a channel are the
// same for the whole warp (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(__ldg(p)); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Params {
  const float* w[3];   // (C, 3) taps of q, k, v
  const float* lw[3];  // (C,) LN scales
  const float* lb[3];  // (C,) LN shifts
};

template <typename E>
__global__ void __launch_bounds__(THREADS)
qkv_depthwise_ln_general_kernel(const E* __restrict__ x, const uint8_t* __restrict__ mask,
                                const Params p, E* __restrict__ oq, E* __restrict__ ok,
                                E* __restrict__ ov, int C, int T, int n_tiles, float eps) {
  constexpr bool BF16 = sizeof(E) == 2;
  const int b = blockIdx.x / n_tiles;
  const int t = (blockIdx.x - b * n_tiles) * THREADS + threadIdx.x;
  if (t >= T) return;
  const uint8_t* mb = mask + (size_t)b * T;
  // which of the columns t - 1, t, t + 1 the conv reads (x * mask, zero outside)
  const bool in[3] = {t > 0 && mb[t - 1] != 0, mb[t] != 0, t + 1 < T && mb[t + 1] != 0};
  const E* xb = x + (size_t)b * C * T + t;

  // y[s] of channel c
  auto conv = [&](int c, float (&y)[3]) {
    const E* xc = xb + (size_t)c * T;
    const float x0 = in[0] ? ld(xc - 1) : 0.f;
    const float x1 = in[1] ? ld(xc) : 0.f;
    const float x2 = in[2] ? ld(xc + 1) : 0.f;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float* w = p.w[s] + 3 * c;
      float w0 = w[0], w1 = w[1], w2 = w[2];
      if (BF16) {
        w0 = round_bf16(w0);
        w1 = round_bf16(w1);
        w2 = round_bf16(w2);
      }
      const float v = fmaf(w2, x2, fmaf(w1, x1, w0 * x0));
      y[s] = BF16 ? round_bf16(v) : v;
    }
  };

  float mean[3] = {0.f, 0.f, 0.f}, rstd[3] = {0.f, 0.f, 0.f};
  for (int c = 0; c < C; ++c) {
    float y[3];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) mean[s] += y[s];
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) mean[s] /= (float)C;
  for (int c = 0; c < C; ++c) {
    float y[3];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const float d = y[s] - mean[s];
      rstd[s] = fmaf(d, d, rstd[s]);
    }
  }
#pragma unroll
  for (int s = 0; s < 3; ++s) rstd[s] = rsqrtf(rstd[s] / (float)C + eps);
  E* o3[3] = {oq, ok, ov};
  const size_t o0 = (size_t)b * C * T + t;
  for (int c = 0; c < C; ++c) {
    float y[3];
    conv(c, y);
#pragma unroll
    for (int s = 0; s < 3; ++s)
      st(o3[s] + o0 + (size_t)c * T,
         fmaf((y[s] - mean[s]) * rstd[s], p.lw[s][c], p.lb[s][c]));
  }
}

template <typename E>
int entry(const E* x, const uint8_t* mask, const float* wq, const float* wk, const float* wv,
          const float* lwq, const float* lbq, const float* lwk, const float* lbk,
          const float* lwv, const float* lbv, E* oq, E* ok, E* ov, int B, int C, int T,
          float eps, cudaStream_t stream) {
  if (B <= 0 || C <= 0 || T <= 0) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (T + THREADS - 1) / THREADS;
  if ((long long)B * n_tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  const Params p{{wq, wk, wv}, {lwq, lwk, lwv}, {lbq, lbk, lbv}};
  qkv_depthwise_ln_general_kernel<E><<<(unsigned)(B * n_tiles), THREADS, 0, stream>>>(
      x, mask, p, oq, ok, ov, C, T, (int)n_tiles, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points, f32 and bf16, with the arguments of the tuned kernels'
// (qkv_depthwise_ln.cu) but no launch plan: x (B, C, T) and the outputs
// (B, C, T) of one type; mask (B, T) bytes; w_s (C, 3) taps and the LN params
// (C,) in f32 (the bf16 kernel rounds the taps to bf16); all contiguous on the
// device; any C >= 1. Each returns the cudaError_t of the launch.
extern "C" int decafnet_qkv_depthwise_ln_general_f32(
    const float* x, const uint8_t* mask, const float* wq, const float* wk, const float* wv,
    const float* lwq, const float* lbq, const float* lwk, const float* lbk, const float* lwv,
    const float* lbv, float* oq, float* ok, float* ov, int B, int C, int T, float eps,
    cudaStream_t stream) {
  return entry(x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, B, C, T, eps,
               stream);
}

extern "C" int decafnet_qkv_depthwise_ln_general_bf16(
    const __nv_bfloat16* x, const uint8_t* mask, const float* wq, const float* wk,
    const float* wv, const float* lwq, const float* lbq, const float* lwk, const float* lbk,
    const float* lwv, const float* lbv, __nv_bfloat16* oq, __nv_bfloat16* ok,
    __nv_bfloat16* ov, int B, int C, int T, float eps, cudaStream_t stream) {
  return entry(x, mask, wq, wk, wv, lwq, lbq, lwk, lbk, lwv, lbv, oq, ok, ov, B, C, T, eps,
               stream);
}
