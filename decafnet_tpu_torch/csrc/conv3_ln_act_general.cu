// Fused masked conv3 + channel LayerNorm + activation for Hopper (sm_90a) at
// any output width: the general kernel beside the tuned wgmma kernels of
// conv3_ln_act.cu, which are built for C_out <= 256 (their N). The wrapper
// (ops/fused_conv.py: conv3_route) sends wider layers here, in f32 or bf16:
//
//   out[b, co, t] = act( LN_c( sum_{ci, tap} w[co, ci, tap] * xm[b, ci, t + tap - 1]
//                              + bias[co] ) * ln_w[co] + ln_b[co] )
//   xm = x * mask, zero outside [0, T); LN over co with biased variance and f32
//   statistics (mean first, then the centred variance); act = relu or identity.
//
// Replaces, for C_out > 256, the TPU kernel
// decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl (pallas_call at
// :175). The heads of a model at embd_dim 256 or 512 run cls_head2 and reg_head
// at embd + 32 = 288 or 544 channels.
//
// What bounds it on an H100: operations, 6 * C_in * C_out FLOPs per column
// against 4 * (C_in + C_out) bytes (2 * in bf16). This first design runs the
// products on the CUDA cores in f32 (exact f32 products, as the plain f32
// version's; in bf16 the same products of bf16-rounded values, exact in f32),
// so its roof is the card's f32 rate, not the tensor cores':
//   - one launch covers every level of a head layer, as the tuned kernels'
//     does: a block per work item (level, row, first column) of the table
//     the wrapper builds (ops/fused_conv.py: conv3_work_table), `tile` columns
//     each;
//   - the LN spans every output channel of a column, so the block keeps its
//     tile's C_out x tile pre-LN values in shared memory (f32; in bf16 the
//     values the bf16 composition holds: the conv output rounded, plus the
//     rounded bias, rounded), and normalises once all are there. The wrapper
//     picks the widest tile whose values fit;
//   - the conv runs per block of OB output channels (8 per thread, a thread
//     owning one column) and chunk of CK input channels: the chunk's masked x
//     columns t0 - 1 .. t0 + tile and its weights (the plain (C_out, C_in, 3)
//     layout, read a row of 3 * CK values per channel) are staged in shared
//     memory; a thread reads its column's 3 taps and its 8 channels' weights
//     as float4s (the same for the whole warp at tile 32: a broadcast), 24
//     FMAs per 9 shared loads;
//   - the LN sums go over the block's threads of a column in shared memory,
//     two-pass as in the plain version; the result is written channel-major,
//     a warp's 32 columns of one channel in one coalesced store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 8;  // levels of one launch (ops/fused_conv.py: CONV3_MAX_LEVELS)
constexpr int RO = 8;          // output channels per thread in a channel block
constexpr int CK = 16;         // input channels per staged chunk

struct Levels {
  const void* x[MAX_LEVELS];
  const uint8_t* mask[MAX_LEVELS];
  void* out[MAX_LEVELS];
  int T[MAX_LEVELS];
};

// a[l] with l known only at run time, by selects over constant indices (an
// indexed kernel parameter would be copied to local memory)
template <typename P>
__device__ __forceinline__ P pick(const P (&a)[MAX_LEVELS], int l) {
  P v = a[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (l == i) v = a[i];
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Shared memory of a block, in floats: ys (C_out x tile), xs (CK x (tile + 2)),
// ws (CK x 3 rows of OBP), red (THREADS), stats (2 x tile).
struct Smem {
  int ob, obp, ys, xs, ws, red, stats, total;
  __host__ __device__ Smem(int C_out, int tile) {
    ob = RO * (THREADS / tile);
    obp = ob + 4;  // rows on 16 bytes, 4 banks apart
    ys = 0;
    xs = ys + ((C_out * tile + 3) / 4) * 4;
    ws = xs + ((CK * (tile + 2) + 3) / 4) * 4;
    red = ws + CK * 3 * obp;
    stats = red + THREADS;
    total = stats + 2 * tile;
  }
};

template <typename E>
__global__ void __launch_bounds__(THREADS)
conv3_ln_act_general_kernel(const Levels lv, const int* __restrict__ work,
                            const float* __restrict__ w, const float* __restrict__ bias,
                            const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                            int C_in, int C_out, int tile, float eps, int relu) {
  constexpr bool BF16 = sizeof(E) == 2;
  extern __shared__ __align__(16) float smem[];
  const Smem L(C_out, tile);
  float* ys = smem + L.ys;
  float* xs = smem + L.xs;
  float* ws = smem + L.ws;
  float* red = smem + L.red;
  float* mean = smem + L.stats;
  float* rstd = mean + tile;

  const int* it = work + 3 * blockIdx.x;
  const int level = it[0], b = it[1], t0 = it[2];
  const int T = pick(lv.T, level);
  const E* xb = static_cast<const E*>(pick(lv.x, level)) + (size_t)b * C_in * T;
  const uint8_t* mb = pick(lv.mask, level) + (size_t)b * T;
  E* obase = static_cast<E*>(pick(lv.out, level)) + (size_t)b * C_out * T;

  const int tid = threadIdx.x;
  const int c = tid % tile, g = tid / tile, G = THREADS / tile;
  const int XS = tile + 2;

  for (int o0 = 0; o0 < C_out; o0 += L.ob) {
    float acc[RO];
#pragma unroll
    for (int r = 0; r < RO; ++r) acc[r] = 0.f;
    for (int i0 = 0; i0 < C_in; i0 += CK) {
      __syncthreads();  // the last chunk is consumed
      for (int e = tid; e < CK * XS; e += THREADS) {
        const int i = e / XS, tt = t0 - 1 + e % XS, ci = i0 + i;
        xs[e] = ci < C_in && tt >= 0 && tt < T && mb[tt] != 0 ? ld(xb + (size_t)ci * T + tt)
                                                            : 0.f;
      }
      // weights: channel ol's row of 3 * CK values is contiguous in w
      for (int e = tid; e < L.ob * 3 * CK; e += THREADS) {
        const int ol = e / (3 * CK), k = e % (3 * CK), co = o0 + ol, ci = i0 + k / 3;
        float wv = co < C_out && ci < C_in ? w[((size_t)co * C_in + ci) * 3 + k % 3] : 0.f;
        ws[k * L.obp + ol] = BF16 ? round_bf16(wv) : wv;
      }
      __syncthreads();
      // the chunk's 3 * CK products summed apart, then added to the total:
      // a 3 * C_in-term running sum in f32 would drift from f64 by ~1e-5
      // after the LN at C_in 544
      float part[RO];
#pragma unroll
      for (int r = 0; r < RO; ++r) part[r] = 0.f;
      const int n = C_in - i0 < CK ? C_in - i0 : CK;
      for (int i = 0; i < n; ++i) {
        const float* xr = xs + i * XS + c;
        const float xv[3] = {xr[0], xr[1], xr[2]};
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          const float4* wr = reinterpret_cast<const float4*>(ws + (i * 3 + tap) * L.obp + g * RO);
          const float4 a = wr[0], bq = wr[1];
          part[0] = fmaf(a.x, xv[tap], part[0]);
          part[1] = fmaf(a.y, xv[tap], part[1]);
          part[2] = fmaf(a.z, xv[tap], part[2]);
          part[3] = fmaf(a.w, xv[tap], part[3]);
          part[4] = fmaf(bq.x, xv[tap], part[4]);
          part[5] = fmaf(bq.y, xv[tap], part[5]);
          part[6] = fmaf(bq.z, xv[tap], part[6]);
          part[7] = fmaf(bq.w, xv[tap], part[7]);
        }
      }
#pragma unroll
      for (int r = 0; r < RO; ++r) acc[r] += part[r];
    }
    // the pre-LN value as the plain version holds it
#pragma unroll
    for (int r = 0; r < RO; ++r) {
      const int co = o0 + g * RO + r;
      if (co >= C_out) continue;
      float y = acc[r];
      if (BF16) {
        y = round_bf16(y);
        if (bias != nullptr) y = round_bf16(y + round_bf16(bias[co]));
      } else if (bias != nullptr) {
        y += bias[co];
      }
      ys[co * tile + c] = y;
    }
  }
  __syncthreads();

  // channel LN of each column: G threads per column, partial sums in red
  float s = 0.f;
  for (int co = g; co < C_out; co += G) s += ys[co * tile + c];
  red[tid] = s;
  __syncthreads();
  if (g == 0) {
    float m = 0.f;
    for (int i = 0; i < G; ++i) m += red[i * tile + c];
    mean[c] = m / (float)C_out;
  }
  __syncthreads();
  const float mu = mean[c];
  s = 0.f;
  for (int co = g; co < C_out; co += G) {
    const float d = ys[co * tile + c] - mu;
    s = fmaf(d, d, s);
  }
  red[tid] = s;
  __syncthreads();
  if (g == 0) {
    float v = 0.f;
    for (int i = 0; i < G; ++i) v += red[i * tile + c];
    rstd[c] = rsqrtf(v / (float)C_out + eps);
  }
  __syncthreads();
  const int t = t0 + c;
  if (t >= T) return;
  const float rs = rstd[c];
  for (int co = g; co < C_out; co += G) {
    float y = (ys[co * tile + c] - mu) * rs;
    if (ln_w != nullptr) y = y * ln_w[co] + ln_b[co];
    if (relu) y = fmaxf(y, 0.f);
    st(obase + (size_t)co * T + t, y);
  }
}

}  // namespace

// One level of a launch as the caller describes it (ops/fused_conv.py: _Level;
// the same struct as conv3_ln_act.cu's).
struct Conv3Level {
  const void* x;
  const uint8_t* mask;
  void* out;
  int B, T;
};

namespace {

template <typename E>
int entry(const Conv3Level* levels, int n_levels, const int* work, int n_work, const float* w,
          const float* bias, const float* ln_w, const float* ln_b, int C_in, int C_out,
          int tile, float eps, int relu, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS || n_work <= 0 || C_in <= 0 || C_out <= 0 ||
      tile < 4 || tile > 32 || THREADS % tile != 0 || (ln_w == nullptr) != (ln_b == nullptr))
    return (int)cudaErrorInvalidValue;
  Levels lv{};
  for (int i = 0; i < n_levels; ++i) {
    if (levels[i].B <= 0 || levels[i].T <= 0) return (int)cudaErrorInvalidValue;
    lv.x[i] = levels[i].x;
    lv.mask[i] = levels[i].mask;
    lv.out[i] = levels[i].out;
    lv.T[i] = levels[i].T;
  }
  const size_t bytes = sizeof(float) * (size_t)Smem(C_out, tile).total;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_ln_act_general_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  conv3_ln_act_general_kernel<E><<<n_work, THREADS, bytes, stream>>>(
      lv, work, w, bias, ln_w, ln_b, C_in, C_out, tile, eps, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// The columns per work item at C_out: the widest of 32, 16, 8 and 4 whose
// block's shared memory (Smem above) fits the current device's per-block limit;
// 0 where none fits (C_out above ~8,000 on an H100).
extern "C" int decafnet_conv3_ln_act_general_tile(int C_out) {
  int dev = 0, limit = 0;
  if (C_out <= 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess)
    return 0;
  for (int tile = 32; tile >= 4; tile /= 2)
    if (sizeof(float) * (size_t)Smem(C_out, tile).total <= (size_t)limit) return tile;
  return 0;
}

// C entry points, f32 and bf16: one launch over n_levels levels (at most 8)
// that share the weights. levels (host memory): per level x (B, C_in, T), the
// mask (B, T) bytes and out (B, C_out, T), contiguous on the device, of one
// type. work (device): n_work items of (level, row, first column), each column
// tile of `tile` columns (decafnet_conv3_ln_act_general_tile below) of each row
// of each level once. w: the (C_out, C_in, 3) weight in f32 (the bf16 kernel rounds it to
// bf16, as the plain version's cast does); bias, ln_w, ln_b (C_out,) f32 or
// null. Each returns the cudaError_t of the launch (cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int decafnet_conv3_ln_act_general_f32(const Conv3Level* levels, int n_levels,
                                                 const int* work, int n_work, const float* w,
                                                 const float* bias, const float* ln_w,
                                                 const float* ln_b, int C_in, int C_out,
                                                 int tile, float eps, int relu,
                                                 cudaStream_t stream) {
  return entry<float>(levels, n_levels, work, n_work, w, bias, ln_w, ln_b, C_in, C_out, tile,
                      eps, relu, stream);
}

extern "C" int decafnet_conv3_ln_act_general_bf16(const Conv3Level* levels, int n_levels,
                                                  const int* work, int n_work, const float* w,
                                                  const float* bias, const float* ln_w,
                                                  const float* ln_b, int C_in, int C_out,
                                                  int tile, float eps, int relu,
                                                  cudaStream_t stream) {
  return entry<__nv_bfloat16>(levels, n_levels, work, n_work, w, bias, ln_w, ln_b, C_in,
                              C_out, tile, eps, relu, stream);
}
