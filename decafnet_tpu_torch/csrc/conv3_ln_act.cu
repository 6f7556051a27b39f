// Fused masked conv3 + channel LayerNorm + activation for Hopper (sm_90a), in two
// kernels: for f32 activations the products on the tensor cores in 3xTF32, the
// result at f32 accuracy; for bf16 activations one bf16 pass with f32
// accumulation (the bf16 variant, described after the f32 kernel).
//
//   out[b, co, t] = act( LN_c( sum_{ci, tap} w[co, ci, tap] * xm[b, ci, t + tap - 1]
//                              + bias[co] ) * ln_w[co] + ln_b[co] )
//   xm = x * mask, zero outside [0, T); LN over co with biased variance and f32
//   statistics (mean first, then the centred variance); act = relu or identity.
//
// Replaces the TPU kernel decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl
// (pallas_call at :175). That kernel assembled the conv halo from prev/cur/next
// BlockSpec tiles and pre-shifted mask arrays because of Mosaic's limits, and
// asked the matrix unit for precision=HIGHEST, a multi-pass bf16 product with f32
// accuracy. Here a block stages the halo it needs in shared memory, and the
// products take three TF32 passes, the tensor-core counterpart of HIGHEST.
//
// What bounds it on an H100: the operations. The conv is an implicit GEMM with
// M = C_out, K = 3 * C_in and N = rows x T; one served decode call (64 rows,
// T = 2304, 7 levels, 44 calls) is 266 GFLOP against ~2.4 GB moved. Three TF32
// passes at 495 TFLOP/s take 1.61 ms; the bytes at 3.35 TB/s take 0.72 ms.
//
// Why three passes and not one: a single TF32 product keeps 11 bits of each
// operand. Emulated in numpy at C = 160, T = 2304, conv3 + LN + ReLU in one TF32
// pass is off f64 by 1.36e-3, 13x the 1e-4 this kernel is held to; plain f32 is
// off by 2.5e-6. Split each operand a into hi = tf32(a) and lo = tf32(a - hi)
// (round to nearest, ties away: cvt.rna) and sum lo*hi + hi*lo + hi*hi, small
// terms first. The weight halves are rounded and laid out in fragment order
// once, by the wrapper (ops/fused_conv.py: conv3_weight_operands); x * mask is
// split once per staged chunk, in shared memory, by the thread that copied it.
//
// Why a fresh sum per chunk: the tensor cores do not round their f32 sums to
// nearest. Chained through all of K (3 * 3 * C_in/8 mma per output) the sums
// drift: on the H100 that version was off f64 by 1.6e-5 at C = 160, above the
// 1e-5 it must meet. So each C_in chunk's 9 products per output (3 taps x 3
// passes) start from zero and their sum is added to the accumulator on the CUDA
// cores: 1.7e-6 off f64, under plain f32's 3.9e-6.
//
// Why mma.sync and not wgmma: TF32 wgmma takes its shared-memory operands
// K-major only. K is the channel axis here and x is T-contiguous, so x would have
// to be transposed as it is staged. mma.sync fragments are read by the threads
// themselves, and the conv tap is then a one-column offset of that read: no
// shifted or transposed copy is made. wgmma is the step after this one.
//
// Design. A block owns one row b, TILE_T = 96 time columns and every output
// channel, C_out padded with zero weights to a multiple of 32 (padded channels
// stay out of the LN sums), so the channel LN stays in the epilogue and each
// output is written once. 8 warps as 2 (channels) x 4 (time): a warp holds MW
// m16 tiles x 3 n8 tiles of accumulators. Registers are what limit it: two
// blocks of 256 threads per SM cap a thread at 128, and the accumulators take
// 60 of them at C_out = 160 (96 columns, not 128, leave the compiler room to
// overlap the mma chains; 2304 and its halvings down to 288 are multiples of
// 96). Per chunk a warp reads the x fragments of the 3 taps once, each weight
// fragment once (two 16-byte loads, hi and lo) for its 3 n-tiles, and issues
// 3 x 3 mma per m16n8 tile. C_in is walked in chunks of 8 (zero-padded)
// through a ring of STAGES shared-memory stages filled with cp.async: x with
// its one-column halo (16-byte copies where aligned, 4-byte copies at the halo
// and ragged edges, zero-fill outside [0, T) and past C_in) and the chunk's
// weight fragments; the next chunks' copies overlap this chunk's products. The
// staged x rows have a stride of TILE_T + 8 floats, so the 32 lanes of a
// fragment read (8 columns x 4 channels) hit 32 banks. The epilogue sums each
// column's channels over registers, warp shuffles and one shared-memory
// exchange between the two channel warps, and stores float2 pairs along T:
// each warp store fills whole 32-byte sectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace decafnet;

constexpr int TILE_T = 96;                  // time columns per block
constexpr int WARPS_M = 2;                  // warps along the channels
constexpr int WARPS_N = 4;                  // warps along time
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int NT = TILE_T / WARPS_N / 8;    // n8 tiles per warp
constexpr int KC = 8;                       // input channels per stage (k8 per tap)
constexpr int X0 = 4;                       // shared-memory column of t0
constexpr int XS = TILE_T + 8;              // staged x row: pad | halo | tile | halo | pad
constexpr int STAGES = 3;
static_assert(KC * TILE_T / 4 <= THREADS, "at most one 16-byte x copy per thread");

// tf32(v), rounded to nearest with ties away from zero: what cvt.rna.tf32.f32
// gives for every finite v and for inf, in two integer instructions where
// cvt.rna compiles to four (a NaN stays a NaN in v - tf32(v))
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// d = a * b + c on the tensor cores (m16n8k8, TF32 in, f32 accumulate)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ float sum_over_groups(float s) {
  s += __shfl_xor_sync(0xffffffffu, s, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 8);
  s += __shfl_xor_sync(0xffffffffu, s, 16);
  return s;
}

// Weight operands, each (ceil(C_in/8), 3, 2*MW, 32, 4): for chunk c8, tap, m16
// tile mt and lane (g = lane/4, q = lane%4) the four A-fragment values
// w[mt*16 + g + 8h, c8*8 + q + 4k, tap] at index 2k + h, zero when padded.
template <int MW>
__global__ void __launch_bounds__(THREADS, MW <= 5 ? 2 : 1)
conv3_ln_act_kernel(const float* __restrict__ x, const uint8_t* __restrict__ mask,
                    const float* __restrict__ w_hi, const float* __restrict__ w_lo,
                    const float* __restrict__ bias, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, float* __restrict__ out, int C_in,
                    int C_out, int T, float eps, int relu, int vec_x) {
  constexpr int MT = 2 * MW;                // m16 tiles of the padded C_out
  constexpr int WS = 3 * MT * 128;          // floats of one weight half per chunk
  constexpr int XH = KC * XS;               // floats of one staged x half
  constexpr int STAGE = 2 * WS + 2 * XH;    // floats per ring stage
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][WARPS_M][TILE_T];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int b = blockIdx.y, t0 = blockIdx.x * TILE_T;
  const float* xb = x + (size_t)b * C_in * T;
  const uint8_t* mb = mask + (size_t)b * T;
  const int n_chunks = (C_in + KC - 1) / KC;
  // The x values a thread copies into a stage: on the 16-byte path the same 4
  // columns of one channel row (vr < KC) and, for tid < 2 * KC, one halo
  // column of row hr, in every chunk; else elements i = tid + k * THREADS.
  const int vr = tid / (TILE_T / 4), vcol = 4 * (tid % (TILE_T / 4));
  const int hr = tid >> 1, hj = X0 + ((tid & 1) ? TILE_T : -1);

  auto load_chunk = [&](int stage, int chunk) {
    float* ws = smem + stage * STAGE;
    const float* gh = w_hi + (size_t)chunk * WS;
    const float* gl = w_lo + (size_t)chunk * WS;
    for (int i = 4 * tid; i < WS; i += 4 * THREADS) {
      cp_async16(ws + i, gh + i, true);
      cp_async16(ws + WS + i, gl + i, true);
    }
    float* xs = ws + 2 * WS;
    const int c0 = chunk * KC;
    if (vec_x) {
      if (vr < KC) {                        // T % 4 == 0: a group is wholly in or out
        const int c = c0 + vr, t = t0 + vcol;
        const bool ok = c < C_in && t < T;
        cp_async16(xs + vr * XS + X0 + vcol, ok ? xb + (size_t)c * T + t : x, ok);
      }
      if (tid < 2 * KC) {                   // halo columns t0 - 1 and t0 + TILE_T
        const int c = c0 + hr, t = t0 - X0 + hj;
        const bool ok = c < C_in && t >= 0 && t < T;
        cp_async4(xs + hr * XS + hj, ok ? xb + (size_t)c * T + t : x, ok);
      }
    } else {
      for (int i = tid; i < KC * (TILE_T + 2); i += THREADS) {
        const int r = i / (TILE_T + 2), j = X0 - 1 + i % (TILE_T + 2);
        const int c = c0 + r, t = t0 - X0 + j;
        const bool ok = c < C_in && t >= 0 && t < T;
        cp_async4(xs + r * XS + j, ok ? xb + (size_t)c * T + t : x, ok);
      }
    }
  };

  // start the ring before anything else, so the first copies overlap the set-up
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

  // accumulators start at the bias (rows g and g + 8 of each m16 tile)
  float acc[MW][NT][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
    const int r0 = (wm * MW + mt) * 16 + g, r1 = r0 + 8;
    const float b0 = (bias != nullptr && r0 < C_out) ? bias[r0] : 0.f;
    const float b1 = (bias != nullptr && r1 < C_out) ? bias[r1] : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = b0;
      acc[mt][nt][1] = b0;
      acc[mt][nt][2] = b1;
      acc[mt][nt][3] = b1;
    }
  }
  // x * mask split in hi and lo: each thread takes the x values it copied,
  // once they land, and writes hi in their place and lo one half further
  auto mask_at = [&](int t) { return (t >= 0 && t < T && mb[t]) ? 1.f : 0.f; };
  float vm[4], hm = 0.f;
  if (vec_x) {
#pragma unroll
    for (int i = 0; i < 4; ++i) vm[i] = vr < KC ? mask_at(t0 + vcol + i) : 0.f;
    if (tid < 2 * KC) hm = mask_at(t0 - X0 + hj);
  }
  auto split = [](float v, float& hi, float& lo) {
    hi = __uint_as_float(tf32_rna(v));
    lo = __uint_as_float(tf32_rna(v - hi));
  };
  auto split_chunk = [&](float* xs) {
    if (vec_x) {
      if (vr < KC) {
        float4* v = reinterpret_cast<float4*>(xs + vr * XS + X0 + vcol);
        const float4 a = *v;
        float4 h, l;
        split(a.x * vm[0], h.x, l.x);
        split(a.y * vm[1], h.y, l.y);
        split(a.z * vm[2], h.z, l.z);
        split(a.w * vm[3], h.w, l.w);
        v[0] = h;
        v[XH / 4] = l;
      }
      if (tid < 2 * KC) split(xs[hr * XS + hj] * hm, xs[hr * XS + hj], xs[XH + hr * XS + hj]);
    } else {
      for (int i = tid; i < KC * (TILE_T + 2); i += THREADS) {
        const int r = i / (TILE_T + 2), j = X0 - 1 + i % (TILE_T + 2);
        split(xs[r * XS + j] * mask_at(t0 - X0 + j), xs[r * XS + j], xs[XH + r * XS + j]);
      }
    }
  };

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<STAGES - 2>();            // this thread's copies of the chunk landed
    split_chunk(smem + (chunk % STAGES) * STAGE + 2 * WS);
    __syncthreads();                        // all of them, split; last stage free
    {
      const int next = chunk + STAGES - 1;
      if (next < n_chunks) load_chunk(next % STAGES, next);
      cp_async_commit();
    }
    const float* ws = smem + (chunk % STAGES) * STAGE;
    const float* xs = ws + 2 * WS;
    if (t0 + wn * NT * 8 >= T) continue;    // this warp's columns lie past T
    // B fragments of the three taps: rows (channels) q and q + 4, column g of
    // each n-tile, shifted by the tap
    uint32_t bh[3][NT][2], bl[3][NT][2];
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = X0 - 1 + wn * NT * 8 + nt * 8 + g + tap;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          bh[tap][nt][k] = __float_as_uint(xs[(q + 4 * k) * XS + j]);
          bl[tap][nt][k] = __float_as_uint(xs[XH + (q + 4 * k) * XS + j]);
        }
      }
    }
    const float4* wh = reinterpret_cast<const float4*>(ws) + wm * MW * 32 + lane;
    const float4* wl = reinterpret_cast<const float4*>(ws + WS) + wm * MW * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
      // the chunk's 3 taps x 3 passes (small terms first) into a fresh sum,
      // then added to the accumulator on the CUDA cores
      constexpr float zero[4] = {0.f, 0.f, 0.f, 0.f};
      float d[NT][4];
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const float4 h = wh[(tap * MT + mt) * 32], l = wl[(tap * MT + mt) * 32];
        const uint32_t ah[4] = {__float_as_uint(h.x), __float_as_uint(h.y),
                                __float_as_uint(h.z), __float_as_uint(h.w)};
        const uint32_t al[4] = {__float_as_uint(l.x), __float_as_uint(l.y),
                                __float_as_uint(l.z), __float_as_uint(l.w)};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (tap == 0)
            mma_tf32(d[nt], al, bh[0][nt], zero);
          else
            mma_tf32(d[nt], al, bh[tap][nt], d[nt]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ah, bl[tap][nt], d[nt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_tf32(d[nt], ah, bh[tap][nt], d[nt]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += d[nt][i];
    }
  }
  cp_async_wait<0>();

  // channel LayerNorm per column. Thread holds columns 2q, 2q + 1 of each
  // n-tile (accumulator index p = 0, 1) for rows g, g + 8 (index 2h + p).
  float mean[NT][2], rstd[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if ((wm * MW + mt) * 16 + g + 8 * h < C_out) s += acc[mt][nt][2 * h + p];
      s = sum_over_groups(s);
      if (g == 0) red[0][wm][wn * NT * 8 + nt * 8 + 2 * q + p] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = wn * NT * 8 + nt * 8 + 2 * q + p;
      mean[nt][p] = (red[0][0][col] + red[0][1][col]) / (float)C_out;
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if ((wm * MW + mt) * 16 + g + 8 * h < C_out) {
            const float d = acc[mt][nt][2 * h + p] - mean[nt][p];
            s = fmaf(d, d, s);
          }
      s = sum_over_groups(s);
      if (g == 0) red[1][wm][col] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = wn * NT * 8 + nt * 8 + 2 * q + p;
      rstd[nt][p] = rsqrtf((red[1][0][col] + red[1][1][col]) / (float)C_out + eps);
    }
  }

  float* ob = out + (size_t)b * C_out * T;
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = (wm * MW + mt) * 16 + g + 8 * h;
      if (co >= C_out) continue;
      const float lw = ln_w != nullptr ? ln_w[co] : 1.f;
      const float lb = ln_b != nullptr ? ln_b[co] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int t = t0 + wn * NT * 8 + nt * 8 + 2 * q;
        float y0 = (acc[mt][nt][2 * h] - mean[nt][0]) * rstd[nt][0] * lw + lb;
        float y1 = (acc[mt][nt][2 * h + 1] - mean[nt][1]) * rstd[nt][1] * lw + lb;
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        float* o = ob + (size_t)co * T + t;
        if (t + 1 < T && (T & 1) == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          if (t < T) o[0] = y0;
          if (t + 1 < T) o[1] = y1;
        }
      }
    }
  }
}

template <int MW>
int launch(const float* x, const uint8_t* mask, const float* w_hi, const float* w_lo,
           const float* bias, const float* ln_w, const float* ln_b, float* out, int B,
           int C_in, int C_out, int T, float eps, int relu, cudaStream_t stream) {
  constexpr int bytes = STAGES * (2 * 3 * 2 * MW * 128 + 2 * KC * XS) * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_ln_act_kernel<MW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec_x = (T % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dim3 grid((T + TILE_T - 1) / TILE_T, B);
  conv3_ln_act_kernel<MW><<<grid, THREADS, bytes, stream>>>(
      x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, C_in, C_out, T, eps, relu, vec_x);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bf16
//
// The bf16 variant computes the function of the JAX bf16 composition
// (conv3_ln_act_xla with bf16 x): the weights rounded to bf16, the conv summed in
// f32 and rounded to bf16, the bias (rounded to bf16) added and rounded again,
// then the LN with f32 statistics and the f32 affine on the f32 LN parameters,
// the activation, and one rounding of the result to bf16. The kernel keeps the
// composition's roundings of the conv output, so it computes the same function
// as the plain version and differs only by the order of the f32 sums.
//
// What bounds it on an H100: the bytes, barely. One served decode call (64 rows,
// T = 2304, 7 levels, 44 calls) moves 1.21 GB (x and the output in bf16, the
// weight fragments, the f32 LN parameters, the mask bytes, as chip_smoke.py
// counts them): 0.361 ms at 3.35 TB/s, against 266 GFLOP, 0.269 ms at the
// 989 TFLOP/s of dense bf16. This kernel reaches about 17 % of that bound.
// A redesign with B fragments read by ldmatrix from x transposed as staged,
// a launch plan for the short levels and two blocks per SM was slower on an
// H100 in sum (2.23 against 2.17 ms per decode call): its tensor pipe was busy
// about a quarter of the time, the rest barriers, staging and the epilogue
// (PERF.md). The next design has to take those off the product warps (a
// warp-specialised producer, or wgmma with B read from shared memory).
//
// Design: the f32 kernel's tiling with the m16n8k16 bf16 mma.sync in place of three
// m16n8k8 TF32 passes, so a chunk is 16 input channels and each output takes
// 3 taps x C_in/16 products. A block owns one row b, TILE_T = 96 columns and
// every output channel (C_out padded to a multiple of 32 with zero weights,
// outside the LN sums); 8 warps as 2 (channels) x 4 (time), each holding MW m16
// x 3 n8 accumulator tiles. The weights come in A-fragment order, rounded once
// per weight by the wrapper (ops/fused_conv.py: conv3_bf16_operands), one
// 16-byte load per lane per (tap, m16 tile). x is staged per chunk as bf16 rows
// [channel][time] with a one-column halo, the interior with 16-byte cp.async (8
// columns) where T % 8 == 0 and x is 16-byte aligned, the halo and every other
// layout with plain 2-byte loads (cp.async copies 4, 8 or 16 bytes), through a
// ring of STAGES stages as in the f32 kernel. A B fragment register holds the
// channel pair (2q, 2q + 1) at one column: two 2-byte shared loads, packed; the
// staged row of 120 bf16 puts the four channel pairs of a fragment read in
// distinct banks. The mask is not applied to the staged x: each B register is
// ANDed with its column's mask, computed once per thread for the 3 taps x 3
// n-tiles it reads (a masked bf16 pair is the zero bit pattern). The sums are
// not restarted per chunk as in the TF32 kernel: the bf16 rounding of the conv
// output dwarfs the tensor cores' f32 accumulation error.

constexpr int BKC = 16;                     // input channels per stage (k16 per tap)
constexpr int BX0 = 8;                      // shared-memory column of t0 (16 bytes)
constexpr int BXS = 120;                    // staged x row in bf16 (16-byte multiple)
static_assert(BXS % 8 == 0 && BXS >= BX0 + TILE_T + 1 && (BXS % 32 == 8 || BXS % 32 == 24),
              "16-byte rows holding the halo; rows 2q (q = 0..3) start q * BXS words "
              "apart, in banks 0, 24, 16, 8 (or 0, 8, 16, 24)");
static_assert(BKC * TILE_T / 8 <= THREADS, "at most one 16-byte x copy per thread");

// d = a * b + c on the tensor cores (m16n8k16, bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2], const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(c[0]),
        "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Weight fragments (ceil(C_in/16), 3, 2*MW, 32, 8) bf16: for chunk c16, tap, m16
// tile mt and lane (g = lane/4, q = lane%4) the eight A-fragment values
// w[mt*16 + g + 8h, c16*16 + 8kh + 2q + j, tap] at index 4kh + 2h + j, zero when
// padded (ops/fused_conv.py: conv3_bf16_fragments).
template <int MW>
__global__ void __launch_bounds__(THREADS, MW <= 5 ? 2 : 1)
conv3_ln_act_bf16_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ wf, const float* __restrict__ bias,
                         const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                         __nv_bfloat16* __restrict__ out, int C_in, int C_out, int T,
                         float eps, int relu, int vec_x) {
  constexpr int MT = 2 * MW;                // m16 tiles of the padded C_out
  constexpr int WS = 3 * MT * 256;          // bf16 of the weights per chunk
  constexpr int XH = BKC * BXS;             // bf16 of one staged x chunk
  constexpr int STAGE = WS + XH;            // bf16 per ring stage
  extern __shared__ __align__(16) float smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __shared__ float red[2][WARPS_M][TILE_T];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const int b = blockIdx.y, t0 = blockIdx.x * TILE_T;
  const __nv_bfloat16* xb = x + (size_t)b * C_in * T;
  const uint8_t* mb = mask + (size_t)b * T;
  const int n_chunks = (C_in + BKC - 1) / BKC;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  // the x values a thread stages: on the 16-byte path the same 8 columns of
  // one channel row (vr < BKC) and, for tid < 2 * BKC, one halo column of row
  // hr, in every chunk; else elements i = tid + k * THREADS
  const int vr = tid / (TILE_T / 8), vcol = 8 * (tid % (TILE_T / 8));
  const int hr = tid >> 1, hj = BX0 + ((tid & 1) ? TILE_T : -1);

  auto load_chunk = [&](int stage, int chunk) {
    __nv_bfloat16* ws = smem + stage * STAGE;
    const __nv_bfloat16* gw = wf + (size_t)chunk * WS;
    for (int i = 8 * tid; i < WS; i += 8 * THREADS) cp_async16(ws + i, gw + i);
    __nv_bfloat16* xs = ws + WS;
    const int c0 = chunk * BKC;
    if (vec_x) {
      if (vr < BKC) {                       // T % 8 == 0: a group is wholly in or out
        const int c = c0 + vr, t = t0 + vcol;
        const bool ok = c < C_in && t < T;
        cp_async16(xs + vr * BXS + BX0 + vcol, ok ? xb + (size_t)c * T + t : x, ok);
      }
      if (tid < 2 * BKC) {                  // halo columns t0 - 1 and t0 + TILE_T
        const int c = c0 + hr, t = t0 - BX0 + hj;
        const bool ok = c < C_in && t >= 0 && t < T;
        xs[hr * BXS + hj] = ok ? xb[(size_t)c * T + t] : zero;
      }
    } else {
      for (int i = tid; i < BKC * (TILE_T + 2); i += THREADS) {
        const int r = i / (TILE_T + 2), j = BX0 - 1 + i % (TILE_T + 2);
        const int c = c0 + r, t = t0 - BX0 + j;
        const bool ok = c < C_in && t >= 0 && t < T;
        xs[r * BXS + j] = ok ? xb[(size_t)c * T + t] : zero;
      }
    }
  };

  // start the ring before anything else, so the first copies overlap the set-up
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

  // mask of each column this thread reads as a B fragment (all bits or none)
  uint32_t msk[3][NT];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int t = t0 + wn * NT * 8 + nt * 8 + g + tap - 1;
      msk[tap][nt] = (t >= 0 && t < T && mb[t]) ? 0xffffffffu : 0u;
    }
  float acc[MW][NT][4];
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<STAGES - 2>();            // this thread's copies of the chunk landed
    __syncthreads();                        // everyone's; the last stage is free
    {
      const int next = chunk + STAGES - 1;
      if (next < n_chunks) load_chunk(next % STAGES, next);
      cp_async_commit();
    }
    const __nv_bfloat16* ws = smem + (chunk % STAGES) * STAGE;
    const uint16_t* xs = reinterpret_cast<const uint16_t*>(ws + WS);
    if (t0 + wn * NT * 8 >= T) continue;    // this warp's columns lie past T
    // B fragments of the three taps: channel pairs (2q, 2q + 1) and (2q + 8,
    // 2q + 9) at column g of each n-tile, shifted by the tap, masked
    uint32_t bf[3][NT][2];
#pragma unroll
    for (int tap = 0; tap < 3; ++tap) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = BX0 - 1 + wn * NT * 8 + nt * 8 + g + tap;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh) {
          const int r = 2 * q + 8 * kh;
          const uint32_t lo = xs[r * BXS + j], hi = xs[(r + 1) * BXS + j];
          bf[tap][nt][kh] = (lo | (hi << 16)) & msk[tap][nt];
        }
      }
    }
    const uint4* wa = reinterpret_cast<const uint4*>(ws) + wm * MW * 32 + lane;
#pragma unroll
    for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const uint4 a4 = wa[(tap * MT + mt) * 32];
        const uint32_t a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, bf[tap][nt], acc[mt][nt]);
      }
    }
  }
  cp_async_wait<0>();

  // the conv output as the bf16 composition holds it (rounded, plus the
  // rounded bias, rounded); thread holds columns 2q, 2q + 1 of each n-tile
  // (index p = 0, 1) for rows g, g + 8 (index 2h + p)
#pragma unroll
  for (int mt = 0; mt < MW; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = (wm * MW + mt) * 16 + g + 8 * h;
      const bool with_bias = bias != nullptr && co < C_out;
      const float bb = with_bias ? round_bf16(bias[co]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          float& v = acc[mt][nt][2 * h + p];
          v = round_bf16(v);
          if (with_bias) v = round_bf16(v + bb);
        }
    }

  // channel LayerNorm per column, as in the f32 kernel
  float mean[NT][2], rstd[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if ((wm * MW + mt) * 16 + g + 8 * h < C_out) s += acc[mt][nt][2 * h + p];
      s = sum_over_groups(s);
      if (g == 0) red[0][wm][wn * NT * 8 + nt * 8 + 2 * q + p] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = wn * NT * 8 + nt * 8 + 2 * q + p;
      mean[nt][p] = (red[0][0][col] + red[0][1][col]) / (float)C_out;
      float s = 0.f;
#pragma unroll
      for (int mt = 0; mt < MW; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if ((wm * MW + mt) * 16 + g + 8 * h < C_out) {
            const float d = acc[mt][nt][2 * h + p] - mean[nt][p];
            s = fmaf(d, d, s);
          }
      s = sum_over_groups(s);
      if (g == 0) red[1][wm][col] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int col = wn * NT * 8 + nt * 8 + 2 * q + p;
      rstd[nt][p] = rsqrtf((red[1][0][col] + red[1][1][col]) / (float)C_out + eps);
    }
  }

  __nv_bfloat16* ob = out + (size_t)b * C_out * T;
#pragma unroll
  for (int mt = 0; mt < MW; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = (wm * MW + mt) * 16 + g + 8 * h;
      if (co >= C_out) continue;
      const float lw = ln_w != nullptr ? ln_w[co] : 1.f;
      const float lb = ln_b != nullptr ? ln_b[co] : 0.f;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int t = t0 + wn * NT * 8 + nt * 8 + 2 * q;
        float y0 = (acc[mt][nt][2 * h] - mean[nt][0]) * rstd[nt][0] * lw + lb;
        float y1 = (acc[mt][nt][2 * h + 1] - mean[nt][1]) * rstd[nt][1] * lw + lb;
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        __nv_bfloat16* o = ob + (size_t)co * T + t;
        if (t + 1 < T && (T & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(y0, y1);
        } else {
          if (t < T) o[0] = __float2bfloat16(y0);
          if (t + 1 < T) o[1] = __float2bfloat16(y1);
        }
      }
    }
  }
}

template <int MW>
int launch_bf16(const __nv_bfloat16* x, const uint8_t* mask, const __nv_bfloat16* wf,
                const float* bias, const float* ln_w, const float* ln_b, __nv_bfloat16* out,
                int B, int C_in, int C_out, int T, float eps, int relu, cudaStream_t stream) {
  constexpr int bytes = STAGES * (3 * 2 * MW * 256 + BKC * BXS) * (int)sizeof(__nv_bfloat16);
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_ln_act_bf16_kernel<MW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int vec_x = (T % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  dim3 grid((T + TILE_T - 1) / TILE_T, B);
  conv3_ln_act_bf16_kernel<MW><<<grid, THREADS, bytes, stream>>>(
      x, mask, wf, bias, ln_w, ln_b, out, C_in, C_out, T, eps, relu, vec_x);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. x (B, C_in, T), mask (B, T) bytes, w_hi/w_lo the TF32 halves of
// the conv weight in fragment order (see the kernel; ops/fused_conv.py builds
// them for C_out padded to a multiple of 32), bias/ln_w/ln_b (C_out,) or null,
// out (B, C_out, T); all f32 contiguous on the device, the weight halves 16-byte
// aligned. Returns the cudaError_t of the launch.
extern "C" int decafnet_conv3_ln_act_f32(const float* x, const uint8_t* mask,
                                         const float* w_hi, const float* w_lo,
                                         const float* bias, const float* ln_w,
                                         const float* ln_b, float* out, int B, int C_in,
                                         int C_out, int T, float eps, int relu,
                                         cudaStream_t stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || T <= 0 || B > 65535 || C_out > 256 ||
      reinterpret_cast<uintptr_t>(w_hi) % 16 != 0 || reinterpret_cast<uintptr_t>(w_lo) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch ((C_out + 31) / 32) {
    case 1: return launch<1>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 2: return launch<2>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 3: return launch<3>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 4: return launch<4>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 5: return launch<5>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 6: return launch<6>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 7: return launch<7>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 8: return launch<8>(x, mask, w_hi, w_lo, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// C entry point of the bf16 variant. x (B, C_in, T) bf16, mask (B, T) bytes, wf
// the bf16 weight fragments (see the kernel; ops/fused_conv.py builds them for
// C_out padded to a multiple of 32), bias/ln_w/ln_b (C_out,) f32 or null, out
// (B, C_out, T) bf16; all contiguous on the device, wf 16-byte aligned. Returns
// the cudaError_t of the launch.
extern "C" int decafnet_conv3_ln_act_bf16(const __nv_bfloat16* x, const uint8_t* mask,
                                          const __nv_bfloat16* wf, const float* bias,
                                          const float* ln_w, const float* ln_b,
                                          __nv_bfloat16* out, int B, int C_in, int C_out, int T,
                                          float eps, int relu, cudaStream_t stream) {
  if (B <= 0 || C_in <= 0 || C_out <= 0 || T <= 0 || B > 65535 || C_out > 256 ||
      reinterpret_cast<uintptr_t>(wf) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  switch ((C_out + 31) / 32) {
    case 1: return launch_bf16<1>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 2: return launch_bf16<2>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 3: return launch_bf16<3>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 4: return launch_bf16<4>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 5: return launch_bf16<5>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 6: return launch_bf16<6>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 7: return launch_bf16<7>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    case 8: return launch_bf16<8>(x, mask, wf, bias, ln_w, ln_b, out, B, C_in, C_out, T, eps, relu, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
