// Fused masked conv3 + channel LayerNorm + activation for Hopper (sm_90a) above
// 1024 output channels, on wgmma: one block per work item computes the item's
// C_out in passes of NS channels and keeps each pass's pre-LN sums in the
// output tensor itself until the LN statistics of the column are known. Two
// kernels of one design, as in conv3_ln_act.cu: f32 activations in three TF32
// passes (f32 accuracy), bf16 activations in one bf16 pass with f32
// accumulation.
//
//   out[b, co, t] = act( LN_c( sum_{ci, tap} w[co, ci, tap] * xm[b, ci, t + tap - 1]
//                              + bias[co] ) * ln_w[co] + ln_b[co] )
//   xm = x * mask, zero outside [0, T); LN over co with biased variance and f32
//   statistics (mean first, then the centred variance); act = relu or identity.
//
// Replaces, for C_out from 1025 to 4096, the TPU kernel
// decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl (pallas_call at
// :175), which takes C_out up to ~3,300 (three (C_in, C_out) f32 weight tiles in
// VMEM): a model at embd_dim 1024 runs cls_head2 and reg_head at C_out 1056.
// The wrapper (ops/fused_conv.py: conv3_route) sends C_out up to 256 to the
// tuned kernels of conv3_ln_act.cu, up to 1024 to the cluster kernels of
// conv3_ln_act_wide.cu, and above 4096 to the general kernel of
// conv3_ln_act_general.cu.
//
// What bounds it on an H100: the operations, 6 * C_in * C_out FLOPs per
// column, on the tensor cores three times over in f32 (3xTF32 at 495 TFLOP/s)
// and once in bf16 (at 989). At C = 1056 over a served head layer (64 rows x
// 4,572 columns) that is 11.87 ms in f32 and 1.98 ms in bf16.
//
// What stops the other designs above 1024, and what this one does instead:
//   - the LN spans every output channel of a column, and wgmma's N is at most
//     256 with the sums in registers. The cluster kernel gives each block of
//     a cluster a slice (at most 8 blocks, the portable cluster); one block
//     running passes with the pre-LN columns in shared memory fits them only
//     up to C_out 576 (f32, 64 columns). Here the pre-LN sums of a pass go to
//     the output tensor, where the finished result will be: each thread stores
//     its own accumulator entries (bias added; in bf16 rounded as the bf16
//     composition rounds them, so the stored values are exactly its pre-LN
//     values) and adds them to its columns' running sums. After the last pass
//     the same thread reads its entries back twice, from L2, for the centred
//     variance and for the normalised result, which it writes in place. A
//     thread reads only what it wrote itself, so no barrier or fence orders
//     the passes; shared memory holds only the ring, and nothing limits C_out
//     but the stated MAX_C (the widest the card checks hold it to);
//   - a column's channels lie in one warp (the 4 lanes of a quad, NS / 4 each
//     a pass), so the LN sums are 2 shuffles, with no exchange between
//     warpgroups or blocks;
//   - the weights stream from L2, a chunk of one pass a stage, and every item
//     reads all of them again: 192 * NS bytes a stage in both dtypes. Items
//     of 128 columns (each consumer warpgroup its own 64, all NS channels of
//     the pass) read half the weight bytes per product that the wide kernel's
//     64-column f32 items do; NS is 128 or 160 (the narrowest padding of
//     C_out: 1056 -> 7 x 160), the widths whose accumulator and fresh sum
//     (NS / 2 registers each) the tuned kernels already hold beside their A
//     registers under setmaxnreg;
//   - the block is the tuned kernels' persistent, warp-specialised block of
//     384 threads: a TMA / bulk-copy producer (warps 1-3 copy x where TMA
//     cannot read it: rows off 16 bytes, T shorter than a box), two consumer
//     warpgroups, an mbarrier ring of as many stages as fit (at most 6). The
//     producer walks the same (item, pass, chunk) sequence as the consumers,
//     so it loads the next pass's and the next item's first stages while the
//     consumers store a pass or sweep an item's columns.
// The accumulation is the wide kernel's: in f32 each stage's 9 TF32 products
// start from zero and are added to the sums on the CUDA cores; in bf16 each
// tap's 2 k16 steps do (the tensor cores truncate their f32 sums; a fresh sum
// per tap keeps the bf16 result within 2 bf16 eps of the exactly rounded
// composition, conv3_ln_act_wide.cu).

#include <type_traits>

#include "conv3_wgmma.cuh"
#include "cp_async.cuh"

using namespace decafnet;

namespace {

constexpr int SMEM_LIMIT = 232448;          // shared memory of one block (H100)
constexpr int MAX_C = 4096;                 // the widest C_out the kernels take
constexpr int MAX_STAGES = 6;
constexpr int TILE = 2 * WM;                // columns per item: 64 per consumer warpgroup

// The plan of a block at NS channels a pass: a stage is one chunk of input
// channels (8 in f32, 32 in bf16) of one pass, the chunk's x boxes (TMA boxes
// of BOX_T columns, 128-byte swizzle, at t0 - BOX_T ... t0 + TILE) and its
// weights; as many stages as fit, at most MAX_STAGES; then the barriers.
// Mirrored by ops/fused_conv.py: conv3_passes_plan.
template <bool BF16, int NS>
struct Plan {
  static constexpr int KC = BF16 ? WKC : FKC;         // input channels a stage
  static constexpr int BOX_T = BF16 ? WM : FBOX;
  static constexpr int BOX_BYTES = BF16 ? XBOX : FXBOX;
  static constexpr int BOXES = TILE / BOX_T + 2;
  static constexpr int XBYTES = BOXES * BOX_BYTES;
  static constexpr int WBYTES = BF16 ? 3 * NS * WKC * 2 : 2 * 3 * NS * FKC * 4;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int FIT = (SMEM_LIMIT - 2 * MAX_STAGES * 8 - 1024) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int BARS = STAGES * STAGE;         // full[STAGES], empty[STAGES]
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(STAGES >= 2 && BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// warps 1-3 of the producer copy chunk c of x on a level TMA cannot read: the
// columns t0 - 1 .. t0 + TILE that lie in [0, T), zero in channel rows past
// C_in (the tuned kernels' copies; the consumers mask the columns outside)
__device__ __forceinline__ void copy_x(uint8_t* sb, const float* xb, int c, int t0, int T,
                                       int C_in, int ptid) {
  for (int e = ptid; e < FKC * (TILE + 2); e += 96) {
    const int tt = e % (TILE + 2) - 1, r = e / (TILE + 2), t = t0 + tt;
    if (t < 0 || t >= T) continue;
    const int ch = c * FKC + r;
    *reinterpret_cast<float*>(sb + ((tt + FBOX) >> 5) * FXBOX + swz128f(r, tt & 31)) =
        ch < C_in ? xb[(size_t)ch * T + t] : 0.f;
  }
  fence_proxy_async();
}

// the bf16 copies: 8-byte cp.async where rows are on 8 bytes, else 2-byte loads
__device__ __forceinline__ void copy_x(uint8_t* sb, const __nv_bfloat16* xp, int c, int t0,
                                       int T, int C_in, int ptid) {
  const uint16_t* xb = reinterpret_cast<const uint16_t*>(xp);
  if ((T & 3) == 0 && (reinterpret_cast<uintptr_t>(xb) & 7) == 0) {
    for (int e = ptid; e < WKC * (TILE / 4 + 2); e += 96) {
      const int r = e / (TILE / 4 + 2), tt = 4 * (e % (TILE / 4 + 2)) - 4, t = t0 + tt;
      if (t < 0 || t >= T) continue;
      const int ch = c * WKC + r;
      uint8_t* dst = sb + ((tt + WM) >> 6) * XBOX + swz128(r, tt & (WM - 1));
      if (ch < C_in)
        cp_async8(dst, xb + (size_t)ch * T + t);
      else
        *reinterpret_cast<uint2*>(dst) = make_uint2(0u, 0u);
    }
    cp_async_wait_all();
  } else {
    for (int e = ptid; e < WKC * (TILE + 2); e += 96) {
      const int tt = e % (TILE + 2) - 1, r = e / (TILE + 2), t = t0 + tt;
      if (t < 0 || t >= T) continue;
      const int ch = c * WKC + r;
      *reinterpret_cast<uint16_t*>(sb + ((tt + WM) >> 6) * XBOX + swz128(r, tt & (WM - 1))) =
          ch < C_in ? xb[(size_t)ch * T + t] : (uint16_t)0;
    }
  }
  fence_proxy_async();
}

// the sum of s over the 4 lanes of each quad (a column's channels)
__device__ __forceinline__ void quad_sum(float (&s)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }
}

// Weight image, `passes` images of NS channels one after the other, pass r the
// tuned kernel's image (conv3_ln_act.cu) of output channels r NS .. r NS + NS
// - 1, zero where padded (ops/fused_conv.py: conv3_passes_operands): f32
// (passes, ceil(C_in/8), 2, 3, NS, 8) TF32 hi and lo, bf16 (passes,
// ceil(C_in/32), 3, NS, 32). In bf16 the function is the tuned bf16 kernel's:
// the conv rounded to bf16, plus the rounded bias, rounded, then the LN in f32.
template <bool BF16, int NS>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_ln_act_passes_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                           const int* __restrict__ work, int n_work,
                           const uint8_t* __restrict__ wimg, const float* __restrict__ bias,
                           const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                           int C_in, int C_out, int passes, float eps, int relu) {
  using P = Plan<BF16, NS>;
  using E = std::conditional_t<BF16, __nv_bfloat16, float>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int n_chunks = (C_in + P::KC - 1) / P::KC;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 2);               // the TMA issuer and the copying warps
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      // lane 0 of warp 0 issues each stage's copies: the pass's weight chunk
      // (one bulk copy) and, on a level TMA can address, the x boxes that
      // start inside x
      if (lane != 0) return;
      int stage = 0, phase = 0;
      for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
        const Item it = work_item(work, item);
        const int level = it.level, b = it.b, t0 = it.t0;
        const int T = pick(lv.T, level), tma = pick(lv.vec, level);
        int n = 0;
        for (int box = 0; box < P::BOXES; ++box) {
          const int ts = t0 + (box - 1) * P::BOX_T;
          n += tma && ts >= 0 && ts < T;
        }
        for (int r = 0; r < passes; ++r)
          for (int c = 0; c < n_chunks; ++c) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* sb = smem + stage * P::STAGE;
            mbar_arrive_expect_tx(&full[stage], P::WBYTES + n * P::BOX_BYTES);
            bulk_load(sb + P::XBYTES, wimg + ((size_t)r * n_chunks + c) * P::WBYTES, P::WBYTES,
                      &full[stage]);
            for (int box = 0; box < P::BOXES; ++box) {
              const int ts = t0 + (box - 1) * P::BOX_T;
              if (tma && ts >= 0 && ts < T)
                tma_load_3d(sb + box * P::BOX_BYTES, &maps.m[level], ts, c * P::KC, b,
                            &full[stage]);
            }
            if (++stage == P::STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
      }
      return;
    }
    // warps 1-3 copy x on a level TMA cannot address
    const int ptid = tid - 32;
    int stage = 0, phase = 0;
    for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
      const Item it = work_item(work, item);
      const int level = it.level, b = it.b, t0 = it.t0;
      const int T = pick(lv.T, level), tma = pick(lv.vec, level);
      const E* xb = static_cast<const E*>(pick(lv.x, level)) + (size_t)b * C_in * T;
      for (int r = 0; r < passes; ++r)
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          if (!tma) copy_x(smem + stage * P::STAGE, xb, c, t0, T, C_in, ptid);
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

  // consumers: warpgroup cw takes the item's columns t0 + 64 cw .. t0 + 64 cw
  // + 63 and all NS channels of each pass. A thread's A registers read times
  // tt = 64 cw + 16 w4 + g + 8h + tap - 1 of the stage's window, at channel
  // rows q (+ 4) in f32, 2q + j (+ 8, 16, 24) in bf16: off[] holds their byte
  // offsets, the swizzle's XOR folded in (the tuned kernels' layout).
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, w4 = warp & 3, g = lane >> 2, q = lane & 3, tw = cw * WM;
  int off[12];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = BF16 ? i >> 1 : i & 1, tt = tw + 16 * w4 + g + 8 * h + tap - 1;
      off[4 * tap + i] = BF16 ? ((tt + WM) >> 6) * XBOX + swz128(2 * q + (i & 1), tt & (WM - 1))
                              : ((tt + FBOX) >> 5) * FXBOX + swz128f(q + 4 * (i >> 1), tt & 31);
    }
  // bit 2 tap + h: the column of A rows h at this tap is in [0, T) and unmasked
  auto keep_bits = [&](int item) {
    uint32_t k = 0;
    if (item >= n_work) return k;
    const Item it = work_item(work, item);
    const int T = pick(lv.T, it.level);
    const uint8_t* mb = pick(lv.mask, it.level) + (size_t)it.b * T;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = it.t0 + tw + 16 * w4 + g + 8 * h + tap - 1;
        k |= (uint32_t)(t >= 0 && t < T && mb[t]) << (2 * tap + h);
      }
    return k;
  };
  uint32_t next_keep = keep_bits(blockIdx.x);
  float acc[NS / 2];
  int stage = 0, phase = 0;
  for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
    const Item it = work_item(work, item);
    const int level = it.level, b = it.b, t0w = it.t0 + tw;
    const int T = pick(lv.T, level);
    const uint32_t keep = next_keep;
    next_keep = keep_bits(item + gridDim.x);  // on their way during this item
    E* ob = static_cast<E*>(pick(lv.out, level)) + (size_t)b * C_out * T;
    // the times of accumulator rows h = 0, 1 and whether they are in [0, T)
    const int t[2] = {t0w + 16 * w4 + g, t0w + 16 * w4 + g + 8};
    const bool in[2] = {t[0] < T, t[1] < T};
    float s[2] = {0.f, 0.f};
    for (int r = 0; r < passes; ++r) {
#pragma unroll
      for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        mbar_wait(&full[stage], phase);
        const uint8_t* xs = smem + stage * P::STAGE;
        const uint8_t* ws = xs + P::XBYTES;
        if constexpr (BF16) {
          uint32_t a[3][2][4];
#pragma unroll
          for (int tap = 0; tap < 3; ++tap)
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int h = i & 1, rows = (16 * ks + 8 * (i >> 1)) * 128;
                const uint32_t lo =
                    *reinterpret_cast<const uint16_t*>(xs + off[4 * tap + 2 * h] + rows);
                const uint32_t hi =
                    *reinterpret_cast<const uint16_t*>(xs + off[4 * tap + 2 * h + 1] + rows);
                a[tap][ks][i] = (lo | (hi << 16)) & (0u - ((keep >> (2 * tap + h)) & 1u));
              }
          // each tap's 2 k16 steps (32 products) into a fresh sum, added to
          // the sums on the CUDA cores
#pragma unroll
          for (int tap = 0; tap < 3; ++tap) {
            float d[NS / 2];
            fence_regs(d);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < 2; ++ks)
              Wgmma<NS>::mma(d, a[tap][ks], gmma_desc(ws + tap * NS * 64 + ks * 32, 0, 512, 2),
                             ks != 0);
            wgmma_commit();
            wgmma_wait<0>();
            fence_regs(d);
#pragma unroll
            for (int i = 0; i < NS / 2; ++i) acc[i] += d[i];
          }
        } else {
          uint32_t ah[3][4], al[3][4];
#pragma unroll
          for (int tap = 0; tap < 3; ++tap)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float v = __uint_as_float(
                  *reinterpret_cast<const uint32_t*>(xs + off[4 * tap + i]) &
                  (0u - ((keep >> (2 * tap + (i & 1))) & 1u)));
              ah[tap][i] = tf32_rna(v);
              al[tap][i] = tf32_rna(v - __uint_as_float(ah[tap][i]));
            }
          // the chunk's 3 taps x 3 passes (small terms first) into a fresh sum
          float d[NS / 2];
          fence_regs(d);
          wgmma_fence();
#pragma unroll
          for (int tap = 0; tap < 3; ++tap) {
            const uint64_t wh = gmma_desc(ws + tap * NS * 32, 0, 256, 3);
            const uint64_t wl = gmma_desc(ws + (3 + tap) * NS * 32, 0, 256, 3);
            WgmmaTf32<NS>::mma(d, al[tap], wh, tap != 0);
            WgmmaTf32<NS>::mma(d, ah[tap], wl, 1);
            WgmmaTf32<NS>::mma(d, ah[tap], wh, 1);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(d);
#pragma unroll
          for (int i = 0; i < NS / 2; ++i) acc[i] += d[i];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[stage]);
        if (++stage == P::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the pass's pre-LN values (bf16: the conv rounded, plus the rounded
      // bias, rounded) to the output and into the columns' sums; accumulator
      // entry 4j + 2h + p is (time t[h], channel r NS + 8j + 2q + p)
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        const int co = r * NS + 8 * j + 2 * q;
        const bool ok[2] = {co < C_out, co + 1 < C_out};
        float bv[2] = {0.f, 0.f};
        if (bias != nullptr)
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (ok[p]) bv[p] = BF16 ? round_bf16(bias[co + p]) : bias[co + p];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[2] = {acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]};
          if (BF16) {
            round_bf16_pair(v[0], v[1]);
            if (bias != nullptr) {
              v[0] += bv[0];
              v[1] += bv[1];
              round_bf16_pair(v[0], v[1]);
            }
          } else {
            v[0] += bv[0];
            v[1] += bv[1];
          }
#pragma unroll
          for (int p = 0; p < 2; ++p)
            if (ok[p]) {
              s[h] += v[p];
              if (in[h]) st(ob + (size_t)(co + p) * T + t[h], v[p]);
            }
        }
      }
    }

    // channel LayerNorm of times t[0], t[1]: the mean from the passes' sums,
    // then the centred variance and the result from the stored values (this
    // thread's own)
    float mean[2], rstd[2];
    quad_sum(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = s[h] / (float)C_out;
      s[h] = 0.f;
    }
    for (int r = 0; r < passes; ++r)
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int p = 0; p < 2; ++p) {
            const int co = r * NS + 8 * j + 2 * q + p;
            if (co < C_out && in[h]) {
              const float dv = ld(ob + (size_t)co * T + t[h]) - mean[h];
              s[h] = fmaf(dv, dv, s[h]);
            }
          }
    quad_sum(s);
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(s[h] / (float)C_out + eps);
    for (int r = 0; r < passes; ++r)
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int co = r * NS + 8 * j + 2 * q + p;
          if (co >= C_out) continue;
          const float lw = ln_w != nullptr ? ln_w[co] : 1.f;
          const float lb = ln_b != nullptr ? ln_b[co] : 0.f;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            if (in[h]) {
              E* o = ob + (size_t)co * T + t[h];
              float y = (ld(o) - mean[h]) * rstd[h] * lw + lb;
              if (relu) y = fmaxf(y, 0.f);
              st(o, y);
            }
        }
  }
}

// ------------------------------------------------------------------ plan

// The launch plan at C_out (ops/fused_conv.py: conv3_passes_plan mirrors it).
struct PassPlan {
  int slice, passes, stages, smem, tile;
};

template <bool BF16, int NS>
PassPlan plan_of(int C_out) {
  return {NS, (C_out + NS - 1) / NS, Plan<BF16, NS>::STAGES, Plan<BF16, NS>::BYTES, TILE};
}

// passes of 160 channels where they pad C_out less than passes of 128 (or as
// little, in fewer passes), else of 128; slice 0 for a C_out the kernels do
// not take
PassPlan passes_plan(int C_out, bool bf16) {
  if (C_out < 1 || C_out > MAX_C) return {0, 0, 0, 0, 0};
  const bool wide = 160 * ((C_out + 159) / 160) <= 128 * ((C_out + 127) / 128);
  if (bf16) return wide ? plan_of<true, 160>(C_out) : plan_of<true, 128>(C_out);
  return wide ? plan_of<false, 160>(C_out) : plan_of<false, 128>(C_out);
}

template <bool BF16, int NS>
int launch(const TmaMaps& maps, const Levels& lv, const int* work, int n_work,
           const void* wimg, const float* bias, const float* ln_w, const float* ln_b,
           int C_in, int C_out, int passes, float eps, int relu, cudaStream_t stream) {
  using P = Plan<BF16, NS>;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_ln_act_passes_kernel<BF16, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::BYTES);
  if (err != cudaSuccess) return (int)err;
  conv3_ln_act_passes_kernel<BF16, NS><<<persistent_grid(n_work), W_THREADS, P::BYTES, stream>>>(
      maps, lv, work, n_work, static_cast<const uint8_t*>(wimg), bias, ln_w, ln_b, C_in, C_out,
      passes, eps, relu);
  return (int)cudaGetLastError();
}

template <bool BF16>
int entry(const Conv3Level* levels, int n_levels, const int* work, int n_work,
          const void* wimg, const float* bias, const float* ln_w, const float* ln_b, int C_in,
          int C_out, int slice, int passes, float eps, int relu, cudaStream_t stream) {
  const PassPlan p = passes_plan(C_out, BF16);
  if (n_work <= 0 || C_in <= 0 || p.slice == 0 || slice != p.slice || passes != p.passes ||
      reinterpret_cast<uintptr_t>(wimg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = BF16 ? make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     2, WM, WKC, lv, maps)
                       : make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                     4, FBOX, FKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  if (p.slice == 128)
    return launch<BF16, 128>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out,
                             passes, eps, relu, stream);
  return launch<BF16, 160>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out,
                           passes, eps, relu, stream);
}

}  // namespace

// The launch plan at C_out for f32 (bf16 = 0) or bf16 activations: out[0..4]
// = channels a pass, passes, ring stages, dynamic shared memory bytes and time
// columns per work item. Returns 0, or cudaErrorInvalidValue (out untouched)
// for a C_out the kernels do not take (above 4096).
extern "C" int decafnet_conv3_ln_act_passes_plan(int C_out, int bf16, int* out) {
  const PassPlan p = passes_plan(C_out, bf16 != 0);
  if (p.slice == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.slice;
  out[1] = p.passes;
  out[2] = p.stages;
  out[3] = p.smem;
  out[4] = p.tile;
  return (int)cudaSuccess;
}

// C entry points, f32 and bf16: one launch over n_levels levels (at most
// MAX_LEVELS) that share the weights, as decafnet_conv3_ln_act_f32
// (conv3_ln_act.cu) takes them; work holds items of the plan's tile (128
// columns); wimg the pass images (see the kernel), 16-byte aligned; slice and
// passes must be the plan's (decafnet_conv3_ln_act_passes_plan); bias, ln_w,
// ln_b (C_out,) f32 or null. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments the kernel does not take,
// cudaErrorNotSupported when a TMA descriptor cannot be made).
extern "C" int decafnet_conv3_ln_act_passes_f32(const Conv3Level* levels, int n_levels,
                                                const int* work, int n_work, const float* wimg,
                                                const float* bias, const float* ln_w,
                                                const float* ln_b, int C_in, int C_out,
                                                int slice, int passes, float eps, int relu,
                                                cudaStream_t stream) {
  return entry<false>(levels, n_levels, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out,
                      slice, passes, eps, relu, stream);
}

extern "C" int decafnet_conv3_ln_act_passes_bf16(const Conv3Level* levels, int n_levels,
                                                 const int* work, int n_work,
                                                 const __nv_bfloat16* wimg, const float* bias,
                                                 const float* ln_w, const float* ln_b, int C_in,
                                                 int C_out, int slice, int passes, float eps,
                                                 int relu, cudaStream_t stream) {
  return entry<true>(levels, n_levels, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out,
                     slice, passes, eps, relu, stream);
}
