// Fused masked conv3 + channel LayerNorm + activation for Hopper (sm_90a), in two
// kernels of one design: for f32 activations the products in three TF32 passes
// on wgmma, the result at f32 accuracy; for bf16 activations one bf16 pass on
// wgmma with f32 accumulation. Both are persistent, warp-specialised and fed by
// TMA.
//
//   out[b, co, t] = act( LN_c( sum_{ci, tap} w[co, ci, tap] * xm[b, ci, t + tap - 1]
//                              + bias[co] ) * ln_w[co] + ln_b[co] )
//   xm = x * mask, zero outside [0, T); LN over co with biased variance and f32
//   statistics (mean first, then the centred variance); act = relu or identity.
//
// One launch covers every FPN level of a head layer (the levels share the
// weights and C_in; each has its own B, T, x, mask and output). The blocks
// walk a table of (level, row, first column) work items that the wrapper
// builds (ops/fused_conv.py: conv3_work_table), and read the level's pointers,
// T and copy path from the kernel's parameters. The short levels' tiles fill
// the card beside the long ones' instead of taking launches of their own: a
// served forward makes 8 launches, not 44.
//
// Replaces the TPU kernel decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl
// (pallas_call at :175). That kernel assembled the conv halo from prev/cur/next
// BlockSpec tiles and pre-shifted mask arrays because of Mosaic's limits, and
// asked the matrix unit for precision=HIGHEST, a multi-pass bf16 product with f32
// accuracy. Here the block stages the halo it needs in shared memory, and the
// f32 products take three TF32 passes, the tensor-core counterpart of HIGHEST.
//
// The design, shared by both kernels. The conv is a GEMM per tap with M = time,
// N = C_out and K = C_in, so C_out = 160 is N exactly (wgmma takes N in steps
// of 8; C_out is padded to 64, 128, 160 or 256, the padded channels zero and
// outside the LN sums). One block of 384 threads per SM walks the work table
// (items of 128 columns of one row of one level) with 3 warpgroups:
//   - the producer: lane 0 of warp 0 keeps a ring of stages in flight, each one
//     chunk of input channels: the chunk's weights (laid out by the wrapper in
//     the order the wgmma descriptor names, one bulk copy from L2) and TMA boxes
//     of x (128-byte swizzle) on 128-byte column boundaries around the item;
//     mbarriers guard the ring (full: the bytes landed and the copying warps
//     are done; empty: the 8 consumer warps are done). Warps 1-3 copy x where
//     TMA cannot read it;
//   - two consumer warpgroups, each owning 64 of the item's columns, issue 3
//     taps of wgmma m64nN per chunk, B (the weights) from shared memory
//     K-major, A (x) from registers, f32 sums in registers (N / 2 per thread);
//   - the epilogue (bias, LN, affine, activation) runs in registers: an
//     accumulator row is one time column with its channels spread over the 4
//     lanes of a quad, so the LN sums are 2 shuffles. While it runs, the
//     producer loads the next item's first stages.
// The traps, and what the design does about each:
//   - the tap is a one-column shift along time, and a wgmma descriptor cannot
//     start one column into a swizzle atom; a TMA box cannot start there
//     either: a box must start on 16 bytes of the row (on the H100 a start at
//     t = -1 or t = 1 faults with an illegal instruction; one reaching past
//     the end is filled with zeros). So x comes once, in boxes on 128-byte
//     boundaries, and each consumer thread reads its A registers from them at
//     the shifted column (the swizzle's XOR folded into per-thread offsets).
//     A design that made shifted copies in shared memory instead, with the
//     producer's warps, measured slower than the mma.sync kernel it was to
//     replace (PERF.md);
//   - TMA needs 16-byte aligned rows: a level whose rows are not (T not a
//     multiple of 16 bytes, x off 16 bytes: the edge shapes; in bf16 level 6
//     at T = 36) is copied by warps 1-3;
//   - the mask: TMA copies x as it is, and the function reads x * mask. Each
//     consumer thread ANDs each A register with its column's keep bits (the
//     column is in [0, T) and unmasked), fetched one item ahead; the same bits
//     zero the columns outside x, so no box needs to be zero-filled;
//   - the weights: at C = 160 they are 150 KB in bf16 and 600 KB as the f32
//     kernel's TF32 halves, so they stream from L2 one chunk per stage, shared
//     by both consumer warpgroups, and every item reads them again;
//   - the descriptors: cuTensorMapEncodeTiled (from libcuda, found through
//     the runtime's entry-point query) once per level per launch on the
//     host, passed as a __grid_constant__ parameter.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "conv3_wgmma.cuh"
#include "cp_async.cuh"

using namespace decafnet;

namespace {

// ------------------------------------------------------------------ f32
//
// The f32 kernel: the products in three TF32 passes, the result at f32
// accuracy.
//
// What bounds it on an H100: the operations. One served decode call (64 rows,
// T = 2304, 7 levels, 8 launches) is 266 GFLOP against ~2.4 GB moved. Three
// TF32 passes at 495 TFLOP/s take 1.61 ms; the bytes at 3.35 TB/s take 0.72 ms.
// Beside them, every 128-column item reads the weight halves from L2 again
// (600 KB at C = 160).
//
// Why three passes and not one: a single TF32 product keeps 11 bits of each
// operand. Emulated in numpy at C = 160, T = 2304, conv3 + LN + ReLU in one TF32
// pass is off f64 by 1.36e-3, 13x the 1e-4 this kernel is held to; plain f32 is
// off by 2.5e-6. Split each operand a into hi = tf32(a) and lo = tf32(a - hi)
// (round to nearest, ties away: cvt.rna) and sum lo*hi + hi*lo + hi*hi, small
// terms first. The weight halves are rounded and laid out once, by the wrapper
// (ops/fused_conv.py: conv3_weight_operands); each consumer thread splits its
// A registers (x * mask) as it reads them.
//
// Why a fresh sum per chunk: the tensor cores do not round their f32 sums to
// nearest. Chained through all of K (3 taps x 3 passes x C_in / 8 products per
// output) the sums drift past the 1e-5 of f64 this kernel must meet (on an
// H100 1.3e-5 at the served shapes: scripts/torch_conv3_variants.py,
// "chained"). So each stage's 9 products (8 input channels) start from zero
// in a second register set and their sum is added to the accumulator on the
// CUDA cores.
//
// Registers: the accumulator and the fresh sum take N / 2 each, 160 at C =
// 160 beside 24 for the A registers of the 3 taps. setmaxnreg gives the
// consumer warpgroups 232 registers a thread and the producer 40; without it
// the launch bound's 168 do not hold both, and on an H100 the kernel takes
// half as long again (scripts/torch_conv3_variants.py, "no_setmaxnreg").
// At C_out above 160 (not served) the two would take 256: there an item is 64
// columns and the two consumer warpgroups split the channels (N = 128 each),
// the LN sums exchanged in shared memory.
//
// TF32 wgmma reads a shared-memory operand K-major only; B, the weights, is
// K-major as the wrapper lays it out (rows of 8 input channels, 32 bytes,
// under the 32-byte swizzle), and A comes from registers, so x is never
// transposed. A stage is 8 input channels: the weight halves of the 3 taps
// (30 KB at C = 160) and 6 boxes of 32 columns x 8 channels of x (t0 - 32 ...
// t0 + 128), a ring of 4. The outputs are stored from the registers: a warp's
// store covers 8 consecutive columns of 4 channels, whole 32-byte sectors.

template <int NP>
struct TfPlan {
  static constexpr bool SPLIT = NP > 160;             // warpgroups split the channels
  static constexpr int NW = SPLIT ? NP / 2 : NP;      // wgmma N of a warpgroup
  static constexpr int TILE = SPLIT ? WM : 2 * WM;    // columns per item
  static constexpr int BOXES = TILE / FBOX + 2;       // x at t0 - 32 ... t0 + TILE
  static constexpr int WBYTES = 2 * 3 * NP * FKC * 4; // hi, lo x 3 taps
  static constexpr int XBYTES = BOXES * FXBOX;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int STAGES = 4;
  static constexpr int RED = STAGES * STAGE;          // LN sums [2][2][WM] (SPLIT)
  static constexpr int PARAMS = RED + 4 * WM * 4;     // bias, ln_w, ln_b
  static constexpr int BARS = PARAMS + 3 * NP * 4;    // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

// Weight image (ceil(C_in/8), 2, 3, NP, 8) f32: for chunk c, half (tf32 hi,
// lo), tap and output channel n, the 8 input channels 8c .. 8c + 7 of that
// half of w[n, :, tap] in a 32-byte row whose 16-byte pieces k sit at
// k ^ ((n / 4) % 2) (the 32-byte swizzle of a K-major wgmma operand), zero
// where padded (ops/fused_conv.py: conv3_weight_fragments).
template <int NP>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_ln_act_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                    const int* __restrict__ work, int n_work, const float* __restrict__ wimg,
                    const float* __restrict__ bias, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, int C_in, int C_out, float eps,
                    int relu) {
  using P = TfPlan<NP>;
  constexpr int NW = P::NW, TILE = P::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + P::RED);
  float* prm = reinterpret_cast<float*>(smem + P::PARAMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int n_chunks = (C_in + FKC - 1) / FKC;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 2);               // the TMA issuer and the copying warps
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < NP; i += W_THREADS) {
    const bool ok = i < C_out;
    prm[i] = ok && bias != nullptr ? bias[i] : 0.f;
    prm[NP + i] = ok ? (ln_w != nullptr ? ln_w[i] : 1.f) : 0.f;
    prm[2 * NP + i] = ok && ln_b != nullptr ? ln_b[i] : 0.f;
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      // lane 0 of warp 0 issues each stage's copies: the weight chunk (one
      // bulk copy) and, on a level TMA can address, the x boxes that start
      // inside x
      if (lane != 0) return;
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
        const Item it = work_item(work, item);
        const int level = it.level, b = it.b, t0 = it.t0;
        const int T = pick(lv.T, level), tma = pick(lv.vec, level);
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sb = smem + stage * P::STAGE;
          int n = 0;
          for (int box = 0; box < P::BOXES; ++box) {
            const int ts = t0 + (box - 1) * FBOX;
            n += tma && ts >= 0 && ts < T;
          }
          mbar_arrive_expect_tx(&full[stage], P::WBYTES + n * FXBOX);
          bulk_load(sb + P::XBYTES, wimg + (size_t)c * (P::WBYTES / 4), P::WBYTES, &full[stage]);
          for (int box = 0; box < P::BOXES; ++box) {
            const int ts = t0 + (box - 1) * FBOX;
            if (tma && ts >= 0 && ts < T)
              tma_load_3d(sb + box * FXBOX, &maps.m[level], ts, c * FKC, b, &full[stage]);
          }
          if (++stage == P::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    // warps 1-3 copy x on a level TMA cannot address: the columns t0 - 1 ..
    // t0 + TILE that lie in [0, T), zero in channel rows past C_in
    const int ptid = tid - 32;
    int stage = 0, phase = 0;
    for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
      const Item it = work_item(work, item);
      const int level = it.level, b = it.b, t0 = it.t0;
      const int T = pick(lv.T, level), tma = pick(lv.vec, level);
      const float* xb = static_cast<const float*>(pick(lv.x, level)) + (size_t)b * C_in * T;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sb = smem + stage * P::STAGE;
        if (!tma) {
          for (int e = ptid; e < FKC * (TILE + 2); e += 96) {
            const int tt = e % (TILE + 2) - 1, r = e / (TILE + 2), t = t0 + tt;
            if (t < 0 || t >= T) continue;
            const int ch = c * FKC + r;
            *reinterpret_cast<float*>(sb + ((tt + FBOX) >> 5) * FXBOX + swz128f(r, tt & 31)) =
                ch < C_in ? xb[(size_t)ch * T + t] : 0.f;
          }
          fence_proxy_async();
        }
        named_sync(3, 96);
        if (ptid == 0) mbar_arrive(&full[stage]);
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes the columns t0 + tw .. t0 + tw + 63 and the
  // channels nc .. nc + NW - 1. A thread's A register i of a tap reads time
  // tw + 16 w4 + g + 8 (i & 1) + tap - 1 of the stage's window [t0 - 32,
  // t0 + TILE + 32) at channel row q + 4 (i >> 1): off[tap][i] is its byte
  // offset. A time outside [0, T) or masked reads as zero (keep[tap][h]: all
  // bits or none), which is x * mask and the conv's zero padding.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int tw = P::SPLIT ? 0 : cw * WM, nc = P::SPLIT ? cw * NW : 0;
  int off[3][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = tw + 16 * w4 + g + 8 * (i & 1) + tap - 1;
      off[tap][i] = ((tt + FBOX) >> 5) * FXBOX + swz128f(q + 4 * (i >> 1), tt & 31);
    }
  auto keep_flags = [&](int item, uint32_t (&k)[3][2]) {
    if (item >= n_work) return;
    const Item it = work_item(work, item);
    const int T = pick(lv.T, it.level);
    const uint8_t* mb = pick(lv.mask, it.level) + (size_t)it.b * T;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = it.t0 + tw + 16 * w4 + g + 8 * h + tap - 1;
        k[tap][h] = t >= 0 && t < T && mb[t] ? 0xFFFFFFFFu : 0u;
      }
  };
  uint32_t next_keep[3][2];
  keep_flags(blockIdx.x, next_keep);
  float acc[NW / 2];
  int stage = 0, phase = 0;
  for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
    const Item it = work_item(work, item);
    const int level = it.level, b = it.b, t0w = it.t0 + tw;
    const int T = pick(lv.T, level);
    uint32_t keep[3][2];
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) keep[tap][h] = next_keep[tap][h];
    keep_flags(item + gridDim.x, next_keep);   // on their way during this item
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[i] = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(&full[stage], phase);
      const uint8_t* xs = smem + stage * P::STAGE;
      const uint8_t* ws = xs + P::XBYTES + nc * 32;
      uint32_t ah[3][4], al[3][4];
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = __uint_as_float(
              *reinterpret_cast<const uint32_t*>(xs + off[tap][i]) & keep[tap][i & 1]);
          ah[tap][i] = tf32_rna(v);
          al[tap][i] = tf32_rna(v - __uint_as_float(ah[tap][i]));
        }
      // the chunk's 3 taps x 3 passes (small terms first) into a fresh sum
      float d[NW / 2];
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const uint64_t wh = gmma_desc(ws + tap * NP * 32, 0, 256, 3);
        const uint64_t wl = gmma_desc(ws + (3 + tap) * NP * 32, 0, 256, 3);
        WgmmaTf32<NW>::mma(d, al[tap], wh, tap != 0);
        WgmmaTf32<NW>::mma(d, ah[tap], wl, 1);
        WgmmaTf32<NW>::mma(d, ah[tap], wh, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] += d[i];
    }

#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[4 * j + i] += prm[nc + 8 * j + 2 * q + (i & 1)];
    // channel LayerNorm of times g and g + 8 (index h): each lane of a quad
    // holds NW / 4 of the channels; with the channels split, the two
    // warpgroups add their sums in shared memory (red[k][cw][time])
    float mean[2], rstd[2];
    auto channel_sum = [&](float (&s)[2], int k) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
        s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
      }
      if (P::SPLIT) {
        float* r = red + k * 2 * WM;
        if (q == 0)
#pragma unroll
          for (int h = 0; h < 2; ++h) r[cw * WM + 16 * w4 + g + 8 * h] = s[h];
        named_sync(1, 256);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          s[h] = r[16 * w4 + g + 8 * h] + r[WM + 16 * w4 + g + 8 * h];
      }
    };
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (nc + 8 * j + 2 * q + p < C_out) s[h] += acc[4 * j + 2 * h + p];
    channel_sum(s, 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = s[h] / (float)C_out;
      s[h] = 0.f;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (nc + 8 * j + 2 * q + p < C_out) {
            const float dv = acc[4 * j + 2 * h + p] - mean[h];
            s[h] = fmaf(dv, dv, s[h]);
          }
    }
    channel_sum(s, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(s[h] / (float)C_out + eps);
    float* ob = static_cast<float*>(pick(lv.out, level)) + (size_t)b * C_out * T;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, co = nc + 8 * j + 2 * q + (i & 1);
        const int t = t0w + 16 * w4 + g + 8 * h;
        float y = (acc[4 * j + i] - mean[h]) * rstd[h] * prm[NP + co] + prm[2 * NP + co];
        if (relu) y = fmaxf(y, 0.f);
        if (co < C_out && t < T) ob[(size_t)co * T + t] = y;
      }
  }
}

template <int NP>
int launch_f32(const TmaMaps& maps, const Levels& lv, const int* work, int n_work,
               const float* wimg, const float* bias, const float* ln_w, const float* ln_b,
               int C_in, int C_out, float eps, int relu, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_ln_act_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, TfPlan<NP>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid(n_work);
  conv3_ln_act_kernel<NP><<<grid, W_THREADS, TfPlan<NP>::BYTES, stream>>>(
      maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ bf16
//
// The bf16 kernel computes the function of the JAX bf16 composition
// (conv3_ln_act_xla with bf16 x): the weights rounded to bf16, the conv summed in
// f32 and rounded to bf16, the bias (rounded to bf16) added and rounded again,
// then the LN with f32 statistics and the f32 affine on the f32 LN parameters,
// the activation, and one rounding of the result to bf16. It keeps both
// roundings of the conv output in its epilogue, so it computes the same
// function as the plain version and differs only by the order of the f32 sums.
//
// What bounds it on an H100: the bytes, barely. One served decode call (64 rows,
// T = 2304, 7 levels, 8 launches) moves 1.2 GB (x and the output in bf16, the
// mask bytes, and once per launch the weights and the f32 LN parameters, as
// chip_smoke.py counts them): 0.359 ms at 3.35 TB/s, against 266 GFLOP, 0.269
// ms at the 989 TFLOP/s of dense bf16.
//
// A stage is 32 input channels: the weights (3 taps x N x 32, 30 KB at C =
// 160, under the 64-byte swizzle) and x at t0 - 64, t0, t0 + 64 and t0 + 128
// (TMA boxes of 32 channels x 64 columns). Per stage each consumer warpgroup
// issues 3 taps x 2 k16 steps of wgmma m64nNk16, each A register read by two
// 2-byte loads at the shifted column. The epilogue rounds as the composition
// does, and the result goes through shared memory (stmatrix .trans gives
// [channel][time]) to 16-byte stores along T, full 32-byte sectors. Warps 1-3
// copy x where TMA cannot: 8-byte cp.async where rows are on 8 bytes (level 6
// at T = 36), else 2-byte loads.
template <int NP>
struct BfPlan {
  static constexpr int WBYTES = 3 * NP * WKC * 2;     // one chunk of the weight image
  static constexpr int XBYTES = 4 * XBOX;             // x at t0 - 64, t0, t0 + 64, t0 + 128
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int STAGES = NP <= 128 ? 4 : NP <= 160 ? 3 : 2;
  static constexpr int OSTAGE = STAGES * STAGE;       // staged outputs, 2 x NP rows
  static constexpr int PARAMS = OSTAGE + 2 * NP * OS; // bias, ln_w, ln_b (f32)
  static constexpr int BARS = PARAMS + 3 * NP * 4;    // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

// Weight image (ceil(C_in/32), 3, NP, 32) bf16: for chunk c, tap and output
// channel n, the 32 input channels 32c .. 32c + 31 of w[n, :, tap] in a 64-byte
// row whose 16-byte pieces k sit at k ^ ((n / 2) % 4) (the 64-byte swizzle of
// a K-major wgmma operand), zero where padded (ops/fused_conv.py:
// conv3_bf16_fragments).
template <int NP>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_ln_act_bf16_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                         const int* __restrict__ work, int n_work,
                         const __nv_bfloat16* __restrict__ wimg,
                         const float* __restrict__ bias, const float* __restrict__ ln_w,
                         const float* __restrict__ ln_b, int C_in, int C_out, float eps,
                         int relu) {
  using P = BfPlan<NP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* prm = reinterpret_cast<float*>(smem + P::PARAMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int n_chunks = (C_in + WKC - 1) / WKC;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 2);               // the TMA issuer and the copying warps
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < NP; i += W_THREADS) {
    const bool ok = i < C_out;
    prm[i] = ok && bias != nullptr ? round_bf16(bias[i]) : 0.f;
    prm[NP + i] = ok ? (ln_w != nullptr ? ln_w[i] : 1.f) : 0.f;
    prm[2 * NP + i] = ok && ln_b != nullptr ? ln_b[i] : 0.f;
  }
  __syncthreads();

  if (wg == 0) {
    if (warp == 0) {
      // lane 0 of warp 0 issues each stage's copies: the weight chunk (one
      // bulk copy) and, on a level TMA can address, the x boxes that start
      // inside x (a box must start on 16 bytes of the row: an H100 faults on
      // a start at t = -1 or t = 1 with an illegal instruction; a box
      // reaching past the end is filled with zeros)
      if (lane != 0) return;
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
        const Item it = work_item(work, item);
        const int level = it.level, b = it.b, t0 = it.t0;
        const int T = pick(lv.T, level), tma = pick(lv.vec, level);
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sb = smem + stage * P::STAGE;
          int n = 0;
          for (int box = 0; box < 4; ++box) {
            const int ts = t0 + (box - 1) * WM;
            n += tma && ts >= 0 && ts < T;
          }
          mbar_arrive_expect_tx(&full[stage], P::WBYTES + n * XBOX);
          bulk_load(sb + P::XBYTES, wimg + (size_t)c * (P::WBYTES / 2), P::WBYTES, &full[stage]);
          for (int box = 0; box < 4; ++box) {
            const int ts = t0 + (box - 1) * WM;
            if (tma && ts >= 0 && ts < T)
              tma_load_3d(sb + box * XBOX, &maps.m[level], ts, c * WKC, b, &full[stage]);
          }
          if (++stage == P::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      return;
    }
    // warps 1-3 copy x on a level TMA cannot address (rows not on 16 bytes:
    // T % 8 != 0 or x off 16 bytes; or T < 64 or C_in < 32): the columns
    // t0 - 1 .. t0 + 128 that lie in [0, T), zero in channel rows past C_in.
    // The columns outside [0, T) are left as they are: the consumers mask them.
    const int ptid = tid - 32;
    int stage = 0, phase = 0;
    for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
      const Item it = work_item(work, item);
      const int level = it.level, b = it.b, t0 = it.t0;
      const int T = pick(lv.T, level), tma = pick(lv.vec, level);
      const uint16_t* xb = static_cast<const uint16_t*>(pick(lv.x, level)) + (size_t)b * C_in * T;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(&empty[stage], phase ^ 1);
        uint8_t* sb = smem + stage * P::STAGE;
        if (!tma && (T & 3) == 0 && (reinterpret_cast<uintptr_t>(xb) & 7) == 0) {
          // 8-byte copies of 4 columns (rows on 8 bytes: level 6 at T = 36)
          for (int e = ptid; e < WKC * (2 * WM / 4 + 2); e += 96) {
            const int r = e / (2 * WM / 4 + 2), tt = 4 * (e % (2 * WM / 4 + 2)) - 4, t = t0 + tt;
            if (t < 0 || t >= T) continue;
            const int ch = c * WKC + r;
            uint8_t* dst = sb + ((tt + WM) >> 6) * XBOX + swz128(r, tt & (WM - 1));
            if (ch < C_in)
              cp_async8(dst, xb + (size_t)ch * T + t);
            else
              *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
          }
          cp_async_wait_all();
          fence_proxy_async();
        } else if (!tma) {
          for (int e = ptid; e < WKC * (2 * WM + 2); e += 96) {
            const int tt = e % (2 * WM + 2) - 1, r = e / (2 * WM + 2), t = t0 + tt;
            if (t < 0 || t >= T) continue;
            const int ch = c * WKC + r;
            *reinterpret_cast<uint16_t*>(sb + ((tt + WM) >> 6) * XBOX + swz128(r, tt & (WM - 1))) =
                ch < C_in ? xb[(size_t)ch * T + t] : (uint16_t)0;
          }
          fence_proxy_async();
        }
        named_sync(3, 96);
        if (ptid == 0) mbar_arrive(&full[stage]);
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw takes the columns t0 + 64 cw .. t0 + 64 cw + 63.
  // A thread's A registers read times tt = 64 cw + 16 w4 + g + 8h + tap - 1 of
  // the stage's window [t0 - 64, t0 + 192) at channel rows 2q + j (+ 8, + 16):
  // off[tap][h][j] is that element's byte offset for channel row 2q + j. A
  // time outside [0, T) or masked reads as zero (keep[tap][h]: all bits or
  // none), which is x * mask and the conv's zero padding.
  const int cw = wg - 1, wtid = tid - 128 * wg, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  uint8_t* os = smem + P::OSTAGE + cw * NP * OS;
  int off[3][2][2];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int tt = cw * WM + 16 * w4 + g + 8 * h + tap - 1;
        off[tap][h][j] = ((tt + WM) >> 6) * XBOX + swz128(2 * q + j, tt & (WM - 1));
      }
  auto keep_flags = [&](int item, uint32_t (&k)[3][2]) {
    if (item >= n_work) return;
    const Item it = work_item(work, item);
    const int T = pick(lv.T, it.level);
    const uint8_t* mb = pick(lv.mask, it.level) + (size_t)it.b * T;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = it.t0 + cw * WM + 16 * w4 + g + 8 * h + tap - 1;
        k[tap][h] = t >= 0 && t < T && mb[t] ? 0xFFFFFFFFu : 0u;
      }
  };
  uint32_t next_keep[3][2];
  keep_flags(blockIdx.x, next_keep);
  float acc[NP / 2];
  int stage = 0, phase = 0;
  for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
    const Item it = work_item(work, item);
    const int level = it.level, b = it.b, t0w = it.t0 + cw * WM;
    const int T = pick(lv.T, level);
    uint32_t keep[3][2];
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) keep[tap][h] = next_keep[tap][h];
    keep_flags(item + gridDim.x, next_keep);   // on their way during this item
    for (int c = 0; c < n_chunks; ++c) {
      mbar_wait(&full[stage], phase);
      const uint8_t* xs = smem + stage * P::STAGE;
      const uint8_t* ws = xs + P::XBYTES;
      uint32_t a[3][2][4];
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int h = i & 1, rows = (16 * ks + 8 * (i >> 1)) * 128;
            const uint32_t lo = *reinterpret_cast<const uint16_t*>(xs + off[tap][h][0] + rows);
            const uint32_t hi = *reinterpret_cast<const uint16_t*>(xs + off[tap][h][1] + rows);
            a[tap][ks][i] = (lo | (hi << 16)) & keep[tap][h];
          }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          Wgmma<NP>::mma(acc, a[tap][ks], gmma_desc(ws + tap * NP * 64 + ks * 32, 0, 512, 2),
                         (c | tap | ks) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == P::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // the conv output as the bf16 composition holds it: rounded, plus the
    // rounded bias, rounded
    const bool with_bias = bias != nullptr;
#pragma unroll
    for (int j = 0; j < NP / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        round_bf16_pair(acc[4 * j + i], acc[4 * j + i + 1]);
        if (with_bias) {
          acc[4 * j + i] += prm[8 * j + 2 * q];
          acc[4 * j + i + 1] += prm[8 * j + 2 * q + 1];
          round_bf16_pair(acc[4 * j + i], acc[4 * j + i + 1]);
        }
      }
    // channel LayerNorm of times g and g + 8 (index h): each lane of a quad
    // holds NP / 4 of the channels
    float mean[2], rstd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (8 * j + 2 * q + p < C_out) s += acc[4 * j + 2 * h + p];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      mean[h] = s / (float)C_out;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (8 * j + 2 * q + p < C_out) {
            const float d = acc[4 * j + 2 * h + p] - mean[h];
            v = fmaf(d, d, v);
          }
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      rstd[h] = rsqrtf(v / (float)C_out + eps);
    }
    // the result to shared memory as [channel][time] (stmatrix transposes
    // each 8 x 8 piece), then 16-byte rows of 8 columns to the output
    named_sync(1 + cw, 128);                // the last item's rows are read
#pragma unroll
    for (int j = 0; j < NP / 8; j += 2) {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = j + i / 2, h = i & 1, col = 8 * jj + 2 * q;
        float y0 = (acc[4 * jj + 2 * h] - mean[h]) * rstd[h] * prm[NP + col] + prm[2 * NP + col];
        float y1 = (acc[4 * jj + 2 * h + 1] - mean[h]) * rstd[h] * prm[NP + col + 1] +
                   prm[2 * NP + col + 1];
        if (relu) {
          y0 = fmaxf(y0, 0.f);
          y1 = fmaxf(y1, 0.f);
        }
        const __nv_bfloat162 y = __floats2bfloat162_rn(y0, y1);
        r[i] = *reinterpret_cast<const uint32_t*>(&y);
      }
      const int mi = lane >> 3, jj = j + (mi >> 1), h = mi & 1;
      stmatrix_x4_trans(os + (8 * jj + (lane & 7)) * OS + (16 * w4 + 8 * h) * 2, r);
    }
    named_sync(1 + cw, 128);
    if (t0w < T) {
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(pick(lv.out, level)) + (size_t)b * C_out * T;
      const bool vec = (T & 7) == 0 && (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
      for (int e = wtid; e < C_out * 8; e += 128) {
        const int co = e >> 3, t = t0w + 8 * (e & 7);
        if (t >= T) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(os + co * OS + (e & 7) * 16);
        __nv_bfloat16* o = ob + (size_t)co * T + t;
        if (vec) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&v);
          for (int i = 0; i < 8 && t + i < T; ++i) o[i] = pv[i];
        }
      }
    }
  }
}

template <int NP>
int launch_bf16(const TmaMaps& maps, const Levels& lv, const int* work, int n_work,
                const __nv_bfloat16* wimg, const float* bias, const float* ln_w,
                const float* ln_b, int C_in, int C_out, float eps, int relu,
                cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_ln_act_bf16_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, BfPlan<NP>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const int grid = persistent_grid(n_work);
  conv3_ln_act_bf16_kernel<NP><<<grid, W_THREADS, BfPlan<NP>::BYTES, stream>>>(
      maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point of the f32 kernel: one launch over n_levels levels (at most
// MAX_LEVELS) that share the weights. levels (host memory): per level x (B,
// C_in, T), the mask (B, T) bytes and out (B, C_out, T), f32 contiguous on the
// device. work (device): n_work items of (level, row, first column), each
// column tile of each row of each level once, the tile 2 * WM columns, or WM
// for C_out above 160. wimg: the weight's TF32 halves as the kernel stages
// them (see the kernel; ops/fused_conv.py builds them for C_out padded to 64,
// 128, 160 or 256), 16-byte aligned; bias/ln_w/ln_b (C_out,) or null. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for arguments the
// kernel does not take, cudaErrorNotSupported when a TMA descriptor cannot be
// made).
extern "C" int decafnet_conv3_ln_act_f32(const Conv3Level* levels, int n_levels,
                                         const int* work, int n_work, const float* wimg,
                                         const float* bias, const float* ln_w,
                                         const float* ln_b, int C_in, int C_out, float eps,
                                         int relu, cudaStream_t stream) {
  if (n_work <= 0 || C_in <= 0 || C_out <= 0 || C_out > 256 ||
      reinterpret_cast<uintptr_t>(wimg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, FBOX,
                              FKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  if (C_out <= 64)
    return launch_f32<64>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  if (C_out <= 128)
    return launch_f32<128>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  if (C_out <= 160)
    return launch_f32<160>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  return launch_f32<256>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
}

// C entry point of the bf16 kernel, as the f32 one: x and out bf16; work
// holds items of 2 * WM columns; wimg the bf16 weight image (see the kernel;
// ops/fused_conv.py builds it for C_out padded to 64, 128, 160 or 256),
// 16-byte aligned; bias/ln_w/ln_b (C_out,) f32 or null.
extern "C" int decafnet_conv3_ln_act_bf16(const Conv3Level* levels, int n_levels,
                                          const int* work, int n_work,
                                          const __nv_bfloat16* wimg, const float* bias,
                                          const float* ln_w, const float* ln_b, int C_in,
                                          int C_out, float eps, int relu,
                                          cudaStream_t stream) {
  if (n_work <= 0 || C_in <= 0 || C_out <= 0 || C_out > 256 ||
      reinterpret_cast<uintptr_t>(wimg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, WM,
                              WKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  if (C_out <= 64)
    return launch_bf16<64>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  if (C_out <= 128)
    return launch_bf16<128>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  if (C_out <= 160)
    return launch_bf16<160>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  return launch_bf16<256>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
}
