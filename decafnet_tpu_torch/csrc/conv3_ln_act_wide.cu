// Fused masked conv3 + channel LayerNorm + activation for Hopper (sm_90a) above
// 256 output channels, on wgmma: a thread-block cluster of 2 to 8 blocks (4 in
// f32) takes each work item, every block its own slice of the output
// channels. Two kernels, as in conv3_ln_act.cu: f32 activations in three TF32
// passes (f32 accuracy), bf16 activations in one bf16 pass with f32
// accumulation.
//
//   out[b, co, t] = act( LN_c( sum_{ci, tap} w[co, ci, tap] * xm[b, ci, t + tap - 1]
//                              + bias[co] ) * ln_w[co] + ln_b[co] )
//   xm = x * mask, zero outside [0, T); LN over co with biased variance and f32
//   statistics (mean first, then the centred variance); act = relu or identity.
//
// Replaces, for C_out from 257 to 1024, the TPU kernel
// decafnet_tpu/ops/fused_conv.py:_conv3_ln_act_pallas_impl (pallas_call at
// :175): a model at embd_dim 256 runs cls_head2 and reg_head at C_out 288, one
// at embd_dim 512 every conv3 at 512 or 544. The wrapper (ops/fused_conv.py:
// conv3_route) sends C_out up to 256 to the tuned kernels of conv3_ln_act.cu
// and C_out above 1024 to the general kernel of conv3_ln_act_general.cu.
//
// What bounds it on an H100: the operations, 6 * C_in * C_out FLOPs per
// column (3 taps, a multiply and an add), on the tensor cores three times over
// in f32 (3xTF32 at 495 TFLOP/s) and once in bf16 (at 989), against
// (C_in + C_out) * 4 bytes per column in f32 (2 in bf16). At C = 544 that is
// 408 FLOP per byte in f32 (1224 tensor-core operations, three passes) and 816
// in bf16, far above the card's ~148 and ~295: the tensor cores, not the
// memory, are the limit.
//
// What stops the tuned design at 256, and what this one does about each:
//   - wgmma's N is at most 256 and an immediate of the instruction, and the
//     accumulators sit in registers: here each block of a cluster owns a
//     slice of the output channels and runs the tuned kernels' pipeline on
//     it, a persistent, warp-specialised block of 384 threads (a TMA
//     producer warp, three x copying warps, two consumer warpgroups) over an
//     mbarrier ring. In f32 a cluster is CL = ceil(C_out / 256) blocks (2
//     to 4), each a slice of the narrowest of 144, 192 and 256 channels that
//     holds ceil(C_out / CL) (288 -> 2 x 144, 512 -> 2 x 256, 544 -> 3 x 192,
//     1024 -> 4 x 256), split over the block's two warpgroups (N = 72 to
//     128 each, items of 64 columns), as the tuned kernel splits C_out 256.
//     In bf16 a slice is 128 or 144 channels, a cluster up to 8 blocks (288
//     -> 2 x 144, 512 -> 4 x 128, 544 -> 4 x 144, 1024 -> 8 x 128), each
//     warpgroup all of its slice over 64 of the item's 128 columns: its
//     products start from zero at every tap and are added to the sums on
//     the CUDA cores (below), which takes a second set of N / 2 registers;
//   - a stage of weights costs 192 * N bytes in both dtypes, 104 KB at N =
//     544, so one block could not keep a ring: each block streams only its
//     slice's weight image (the wrapper lays the slices out one after the
//     other) from L2, 24 to 48 KB a stage;
//   - the LN spans every output channel of a column: each block's consumer
//     warps sum their channels of each column (2 shuffles over a quad), and
//     lane q of each quad stores the column's partial into blocks q and q + 4
//     (distributed shared memory: mapa + st.shared::cluster) and arrives on
//     their exchange barriers (mbarriers, release at cluster scope); each
//     block waits on its own barrier (acquire at cluster scope) and adds the
//     partials of every block (f32: of both warpgroups of every block) in
//     one order, so every block gets the same mean. Twice per item: the
//     mean, then the centred variance, each pass with its own buffer and
//     barrier, so a block can run an item ahead of a slower peer without
//     overwriting what the peer still reads (a block writes pass k of item
//     i + 1 only after every block of the cluster arrived for pass k + 1 of
//     item i, or for pass 0 of item i + 1, which they do after their reads).
//     Padded channels stay out of the sums in every block;
//   - x is the same for every block of a cluster; each block loads it by its
//     own TMA boxes (L2 serves the repeats). The rows TMA cannot read (not on
//     16 bytes; bf16 level 6 at T = 36) are copied by the producer's warps
//     1-3, as in the tuned kernels; the mask is ANDed into each A register
//     per thread;
//   - the persistent grid is as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters), launched by cudaLaunchKernelEx with a
//     cluster-dimension attribute; cluster c walks items c, c + n, ... of the
//     wrapper's work table (ops/fused_conv.py: conv3_work_table).
// The accumulation: in f32 each stage's 9 TF32 products start from zero and
// are added to the sums on the CUDA cores (chained through all of K on the
// tensor cores the sums drift past 1e-5 of f64), as in the tuned kernel; in
// bf16 each tap's 2 k16 steps of a stage (32 products) do the same. The
// tensor cores do not round their f32 sums to nearest: they truncate, so a
// sum chained through all of K (the tuned bf16 kernel's way) drifts toward
// zero. On an H100 that moved conv outputs whose exact sum lies just beyond
// a bf16 rounding boundary back across it, with a fresh sum per stage of 32
// input channels too; after a bias that cancels such an output, the LN
// lifts the one-step difference past 2 bf16 eps of the exactly rounded
// composition (chip_smoke.py: conv3_bf16_sweep; cuDNN's bf16 conv, also on
// the tensor cores, lands on the same side there). With a fresh sum per tap
// the sweep stays within 2 eps, as the general kernel's sums rounded to
// nearest do. It costs a wait on the tensor cores per tap.
//
// Why a cluster and not one block computing its C_out in passes: in f32 the
// block would keep its tile's pre-LN columns in shared memory beside the ring,
// 64 columns x 576 x 4 B = 147 KB at C_out 544, room for a ring of 2 stages of
// 144 channels; at C_out above 576 there is no room for a ring. Measured on an
// H100 (scripts/torch_conv3_wide_variants.py, PERF.md section 6), the passes
// were faster than this kernel at C_out 288 and 544 in f32; the cluster
// stays because it takes every C_out up to 1024 in both dtypes.

#include <utility>

#include "conv3_wgmma.cuh"
#include "cp_async.cuh"

using namespace decafnet;

namespace {

constexpr int SMEM_LIMIT = 232448;          // shared memory of one block (H100)
constexpr int MAX_C = 1024;                 // the widest C_out the kernels take
constexpr int RED_SRC = 8;                  // LN partials per column: f32 4 blocks x 2
                                            // warpgroups, bf16 8 blocks
constexpr int RED_BYTES = 2 * RED_SRC * 2 * WM * 4;  // [pass][source][column] f32
constexpr int MAX_STAGES = 4;

// stages of `stage` bytes beside `fixed` bytes: as many as fit, at most 4
constexpr int ring_stages(int stage, int fixed) {
  return (SMEM_LIMIT - fixed) / stage < MAX_STAGES ? (SMEM_LIMIT - fixed) / stage : MAX_STAGES;
}

// the barriers: full[STAGES], empty[STAGES], the exchange's [2]; the fixed
// bytes count them at MAX_STAGES
constexpr int bar_bytes(int stages) { return (2 * stages + 2) * 8; }

// The f32 kernel's plan for a slice of NS channels, split over the two
// warpgroups: the shared memory is the ring, the LN exchange (RED_BYTES), the
// slice's bias, ln_w and ln_b, and the barriers. Mirrored by
// ops/fused_conv.py: conv3_wide_plan.
template <int NS>
struct TfWide {
  static constexpr int NW = NS / 2;                   // wgmma N of a warpgroup
  static constexpr int TILE = WM;                     // columns per item
  static constexpr int BOXES = TILE / FBOX + 2;       // x at t0 - 32 ... t0 + TILE
  static constexpr int WBYTES = 2 * 3 * NS * FKC * 4; // hi, lo x 3 taps
  static constexpr int XBYTES = BOXES * FXBOX;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int FIXED = RED_BYTES + 3 * NS * 4 + bar_bytes(MAX_STAGES) + 1024;
  static constexpr int STAGES = ring_stages(STAGE, FIXED);
  static constexpr int RED = STAGES * STAGE;
  static constexpr int PARAMS = RED + RED_BYTES;
  static constexpr int BARS = PARAMS + 3 * NS * 4;
  static constexpr int BYTES = BARS + bar_bytes(STAGES) + 1024;  // + alignment slack
  static_assert(STAGES >= 2 && BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

// The bf16 kernel's plan: the ring, the staged outputs (2 warpgroups x NS
// rows), the LN exchange, the parameters and the barriers.
template <int NS>
struct BfWide {
  static constexpr int TILE = 2 * WM;
  static constexpr int WBYTES = 3 * NS * WKC * 2;     // one chunk of the slice's image
  static constexpr int XBYTES = 4 * XBOX;             // x at t0 - 64, t0, t0 + 64, t0 + 128
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int OUT = 2 * NS * OS;
  static constexpr int FIXED = OUT + RED_BYTES + 3 * NS * 4 + bar_bytes(MAX_STAGES) + 1024;
  static constexpr int STAGES = ring_stages(STAGE, FIXED);
  static constexpr int OSTAGE = STAGES * STAGE;
  static constexpr int RED = OSTAGE + OUT;
  static constexpr int PARAMS = RED + RED_BYTES;
  static constexpr int BARS = PARAMS + 3 * NS * 4;
  static constexpr int BYTES = BARS + bar_bytes(STAGES) + 1024;
  static_assert(STAGES >= 2 && BYTES <= SMEM_LIMIT, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

// barriers of a block: the ring's, and the exchange's (64 arrivals from each
// block of the cluster: lanes g = 0..7 of one quad column of its 8 consumer
// warps). The caller syncs the cluster before any block arrives on a peer's
__device__ __forceinline__ void init_barriers(uint64_t* full, uint64_t* empty, uint64_t* xch,
                                              int stages, uint32_t cl) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 2);               // the TMA issuer and the copying warps
      mbar_init(&empty[s], 8);              // one arrival per consumer warp
    }
    mbar_init(&xch[0], 64 * cl);
    mbar_init(&xch[1], 64 * cl);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// ------------------------------------------------------------------ f32
//
// Weight image (CL, ceil(C_in/8), 2, 3, NS, 8) f32: per slice r the tuned
// kernel's image (conv3_ln_act.cu) of output channels r NS .. r NS + NS - 1,
// zero where padded (ops/fused_conv.py: conv3_wide_operands).
template <int NS>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_ln_act_wide_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                         const int* __restrict__ work, int n_work,
                         const float* __restrict__ wimg, const float* __restrict__ bias,
                         const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                         int C_in, int C_out, float eps, int relu) {
  using P = TfWide<NS>;
  constexpr int NW = P::NW, TILE = P::TILE;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + P::RED);
  float* prm = reinterpret_cast<float*>(smem + P::PARAMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;
  uint64_t* xch = empty + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const uint32_t rank = cluster_rank(), cl = cluster_size();
  const int first = cluster_id(), step = cluster_count();
  const int n_chunks = (C_in + FKC - 1) / FKC, c0 = rank * NS;
  init_barriers(full, empty, xch, P::STAGES, cl);
  for (int i = tid; i < NS; i += W_THREADS) {
    const int co = c0 + i;
    const bool ok = co < C_out;
    prm[i] = ok && bias != nullptr ? bias[co] : 0.f;
    prm[NS + i] = ok ? (ln_w != nullptr ? ln_w[co] : 1.f) : 0.f;
    prm[2 * NS + i] = ok && ln_b != nullptr ? ln_b[co] : 0.f;
  }
  cluster_sync_aligned();
  const float* wsl = wimg + (size_t)rank * n_chunks * (P::WBYTES / 4);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      // lane 0 of warp 0 issues each stage's copies: the slice's weight
      // chunk (one bulk copy) and, on a level TMA can address, the x boxes
      // that start inside x
      if (lane == 0) {
        int stage = 0, phase = 0;
        for (int item = first; item < n_work; item += step) {
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
            bulk_load(sb + P::XBYTES, wsl + (size_t)c * (P::WBYTES / 4), P::WBYTES, &full[stage]);
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
      }
    } else {
      // warps 1-3 copy x on a level TMA cannot address: the columns t0 - 1 ..
      // t0 + TILE that lie in [0, T), zero in channel rows past C_in
      const int ptid = tid - 32;
      int stage = 0, phase = 0;
      for (int item = first; item < n_work; item += step) {
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
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  // consumers: warpgroup cw takes the item's 64 columns and the slice's
  // channels nc .. nc + NW - 1, as the tuned kernel's at C_out 256 (A
  // registers from the staged x at the shifted column, masked by keep)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int nc = cw * NW, src = 2 * rank + cw, n_src = 2 * cl;
  const int col[2] = {16 * w4 + g, 16 * w4 + g + 8};
  int off[3][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = 16 * w4 + g + 8 * (i & 1) + tap - 1;
      off[tap][i] = ((tt + FBOX) >> 5) * FXBOX + swz128f(q + 4 * (i >> 1), tt & 31);
    }
  // bit 2 tap + h: the column of A rows h at this tap is in [0, T) and
  // unmasked (one register where the tuned kernel keeps six)
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
        const int t = it.t0 + 16 * w4 + g + 8 * h + tap - 1;
        k |= (uint32_t)(t >= 0 && t < T && mb[t]) << (2 * tap + h);
      }
    return k;
  };
  uint32_t next_keep = keep_bits(first);
  float acc[NW / 2];
  int stage = 0, phase = 0, xph = 0;
  for (int item = first; item < n_work; item += step) {
    const Item it = work_item(work, item);
    const int level = it.level, b = it.b, t0w = it.t0;
    const int T = pick(lv.T, level);
    const uint32_t keep = next_keep;
    next_keep = keep_bits(item + step);    // on their way during this item
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
          const float v = __uint_as_float(*reinterpret_cast<const uint32_t*>(xs + off[tap][i]) &
                                          (0u - ((keep >> (2 * tap + (i & 1))) & 1u)));
          ah[tap][i] = tf32_rna(v);
          al[tap][i] = tf32_rna(v - __uint_as_float(ah[tap][i]));
        }
      // the chunk's 3 taps x 3 passes (small terms first) into a fresh sum
      float d[NW / 2];
      fence_regs(d);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 3; ++tap) {
        const uint64_t wh = gmma_desc(ws + tap * NS * 32, 0, 256, 3);
        const uint64_t wl = gmma_desc(ws + (3 + tap) * NS * 32, 0, 256, 3);
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
    // channel LayerNorm of times g and g + 8 (index h) over the cluster's
    // channels: this thread's partial, the cluster's sum (cluster_sum)
    float mean[2], rstd[2], s[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (c0 + nc + 8 * j + 2 * q + p < C_out) s[h] += acc[4 * j + 2 * h + p];
    cluster_sum(s, col, red, &xch[0], xph, q, cl, src, n_src);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = s[h] / (float)C_out;
      s[h] = 0.f;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (c0 + nc + 8 * j + 2 * q + p < C_out) {
            const float dv = acc[4 * j + 2 * h + p] - mean[h];
            s[h] = fmaf(dv, dv, s[h]);
          }
    }
    cluster_sum(s, col, red + RED_SRC * 2 * WM, &xch[1], xph, q, cl, src, n_src);
    xph ^= 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(s[h] / (float)C_out + eps);
    float* ob = static_cast<float*>(pick(lv.out, level)) + (size_t)b * C_out * T;
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1, cs = nc + 8 * j + 2 * q + (i & 1), co = c0 + cs;
        const int t = t0w + 16 * w4 + g + 8 * h;
        float y = (acc[4 * j + i] - mean[h]) * rstd[h] * prm[NS + cs] + prm[2 * NS + cs];
        if (relu) y = fmaxf(y, 0.f);
        if (co < C_out && t < T) ob[(size_t)co * T + t] = y;
      }
  }
  cluster_sync();
}

// ------------------------------------------------------------------ bf16
//
// Weight image (CL, ceil(C_in/32), 3, NS, 32) bf16: per slice r the tuned
// bf16 kernel's image of output channels r NS .. r NS + NS - 1, zero where
// padded (ops/fused_conv.py: conv3_wide_operands). The function is the tuned
// bf16 kernel's (conv3_ln_act.cu), with the LN sums over the cluster.
template <int NS>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_ln_act_wide_bf16_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                              const int* __restrict__ work, int n_work,
                              const __nv_bfloat16* __restrict__ wimg,
                              const float* __restrict__ bias, const float* __restrict__ ln_w,
                              const float* __restrict__ ln_b, int C_in, int C_out, float eps,
                              int relu) {
  using P = BfWide<NS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* red = reinterpret_cast<float*>(smem + P::RED);
  float* prm = reinterpret_cast<float*>(smem + P::PARAMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;
  uint64_t* xch = empty + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const uint32_t rank = cluster_rank(), cl = cluster_size();
  const int first = cluster_id(), step = cluster_count();
  const int n_chunks = (C_in + WKC - 1) / WKC, c0 = rank * NS;
  init_barriers(full, empty, xch, P::STAGES, cl);
  for (int i = tid; i < NS; i += W_THREADS) {
    const int co = c0 + i;
    const bool ok = co < C_out;
    prm[i] = ok && bias != nullptr ? round_bf16(bias[co]) : 0.f;
    prm[NS + i] = ok ? (ln_w != nullptr ? ln_w[co] : 1.f) : 0.f;
    prm[2 * NS + i] = ok && ln_b != nullptr ? ln_b[co] : 0.f;
  }
  cluster_sync_aligned();
  const __nv_bfloat16* wsl = wimg + (size_t)rank * n_chunks * (P::WBYTES / 2);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      // lane 0 of warp 0: the slice's weight chunk and the x boxes, as the
      // tuned bf16 kernel's producer
      if (lane == 0) {
        int stage = 0, phase = 0;
        for (int item = first; item < n_work; item += step) {
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
            bulk_load(sb + P::XBYTES, wsl + (size_t)c * (P::WBYTES / 2), P::WBYTES, &full[stage]);
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
      }
    } else {
      // warps 1-3 copy x on a level TMA cannot address: 8-byte cp.async
      // where rows are on 8 bytes, else 2-byte loads (the tuned kernel's)
      const int ptid = tid - 32;
      int stage = 0, phase = 0;
      for (int item = first; item < n_work; item += step) {
        const Item it = work_item(work, item);
        const int level = it.level, b = it.b, t0 = it.t0;
        const int T = pick(lv.T, level), tma = pick(lv.vec, level);
        const uint16_t* xb =
            static_cast<const uint16_t*>(pick(lv.x, level)) + (size_t)b * C_in * T;
        for (int c = 0; c < n_chunks; ++c) {
          mbar_wait(&empty[stage], phase ^ 1);
          uint8_t* sb = smem + stage * P::STAGE;
          if (!tma && (T & 3) == 0 && (reinterpret_cast<uintptr_t>(xb) & 7) == 0) {
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
              *reinterpret_cast<uint16_t*>(sb + ((tt + WM) >> 6) * XBOX +
                                           swz128(r, tt & (WM - 1))) =
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
    }
    __syncwarp();
    cluster_sync();
    return;
  }

  // consumers: warpgroup cw takes the columns t0 + 64 cw .. t0 + 64 cw + 63
  // and all NS channels of the slice, as the tuned bf16 kernel's; the sums
  // and the fresh sum of a tap take 2 x NS / 2 registers a thread, so the
  // consumers take setmaxnreg's 232
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, wtid = tid - 128 * wg, w4 = warp & 3, g = lane >> 2, q = lane & 3;
  const int col[2] = {cw * WM + 16 * w4 + g, cw * WM + 16 * w4 + g + 8};
  const int n_out = C_out - c0 < NS ? C_out - c0 : NS;   // the slice's real channels
  uint8_t* os = smem + P::OSTAGE + cw * NS * OS;
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
  auto keep_bits = [&](int item) {         // as the f32 kernel's
    uint32_t k = 0;
    if (item >= n_work) return k;
    const Item it = work_item(work, item);
    const int T = pick(lv.T, it.level);
    const uint8_t* mb = pick(lv.mask, it.level) + (size_t)it.b * T;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = it.t0 + cw * WM + 16 * w4 + g + 8 * h + tap - 1;
        k |= (uint32_t)(t >= 0 && t < T && mb[t]) << (2 * tap + h);
      }
    return k;
  };
  uint32_t next_keep = keep_bits(first);
  float acc[NS / 2];
  int stage = 0, phase = 0, xph = 0;
  for (int item = first; item < n_work; item += step) {
    const Item it = work_item(work, item);
    const int level = it.level, b = it.b, t0w = it.t0 + cw * WM;
    const int T = pick(lv.T, level);
    const uint32_t keep = next_keep;
    next_keep = keep_bits(item + step);    // on their way during this item
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) acc[i] = 0.f;
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
            a[tap][ks][i] = (lo | (hi << 16)) & (0u - ((keep >> (2 * tap + h)) & 1u));
          }
      // each tap's 2 k16 steps (32 products) into a fresh sum, added to the
      // sums on the CUDA cores
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
    for (int j = 0; j < NS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
        round_bf16_pair(acc[4 * j + i], acc[4 * j + i + 1]);
        if (with_bias) {
          acc[4 * j + i] += prm[8 * j + 2 * q];
          acc[4 * j + i + 1] += prm[8 * j + 2 * q + 1];
          round_bf16_pair(acc[4 * j + i], acc[4 * j + i + 1]);
        }
      }
    // channel LayerNorm of times g and g + 8 (index h) over the cluster's
    // channels (cluster_sum)
    float mean[2], rstd[2], s[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (8 * j + 2 * q + p < n_out) s[h] += acc[4 * j + 2 * h + p];
    cluster_sum(s, col, red, &xch[0], xph, q, cl, rank, cl);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = s[h] / (float)C_out;
      s[h] = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 8; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          if (8 * j + 2 * q + p < n_out) {
            const float d = acc[4 * j + 2 * h + p] - mean[h];
            s[h] = fmaf(d, d, s[h]);
          }
    }
    cluster_sum(s, col, red + RED_SRC * 2 * WM, &xch[1], xph, q, cl, rank, cl);
    xph ^= 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(s[h] / (float)C_out + eps);
    // the result to shared memory as [channel][time] (stmatrix transposes
    // each 8 x 8 piece), then 16-byte rows of 8 columns to the output
    named_sync(1 + cw, 128);                // the last item's rows are read
#pragma unroll
    for (int j = 0; j < NS / 8; j += 2) {
      uint32_t r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int jj = j + i / 2, h = i & 1, cs = 8 * jj + 2 * q;
        float y0 = (acc[4 * jj + 2 * h] - mean[h]) * rstd[h] * prm[NS + cs] + prm[2 * NS + cs];
        float y1 = (acc[4 * jj + 2 * h + 1] - mean[h]) * rstd[h] * prm[NS + cs + 1] +
                   prm[2 * NS + cs + 1];
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
      __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(pick(lv.out, level)) +
                          ((size_t)b * C_out + c0) * T;
      const bool vec = (T & 7) == 0 && (reinterpret_cast<uintptr_t>(ob) & 15) == 0;
      for (int e = wtid; e < n_out * 8; e += 128) {
        const int cs = e >> 3, t = t0w + 8 * (e & 7);
        if (t >= T) continue;
        const uint4 v = *reinterpret_cast<const uint4*>(os + cs * OS + (e & 7) * 16);
        __nv_bfloat16* o = ob + (size_t)cs * T + t;
        if (vec) {
          *reinterpret_cast<uint4*>(o) = v;
        } else {
          const __nv_bfloat16* pv = reinterpret_cast<const __nv_bfloat16*>(&v);
          for (int i = 0; i < 8 && t + i < T; ++i) o[i] = pv[i];
        }
      }
    }
  }
  cluster_sync();
}

// ------------------------------------------------------------------ plan

// The launch plan at C_out (ops/fused_conv.py: conv3_wide_plan mirrors it).
struct WidePlan {
  int slice, cluster, stages, smem, tile;
};

template <int NS>
WidePlan plan_of(int cluster, bool bf16) {
  if (bf16) return {NS, cluster, BfWide<NS>::STAGES, BfWide<NS>::BYTES, BfWide<NS>::TILE};
  return {NS, cluster, TfWide<NS>::STAGES, TfWide<NS>::BYTES, TfWide<NS>::TILE};
}

// f32: CL = ceil(C_out / 256) blocks, each a slice of the narrowest of 144,
// 192 and 256 channels that holds ceil(C_out / CL); bf16: CL = ceil(C_out /
// 144) blocks, each a slice of 128 or 144. Slice 0 for a C_out the kernels
// do not take.
WidePlan wide_plan(int C_out, bool bf16) {
  if (C_out < 1 || C_out > MAX_C) return {0, 0, 0, 0, 0};
  if (bf16) {
    const int cl = (C_out + 143) / 144, per = (C_out + cl - 1) / cl;
    return per <= 128 ? plan_of<128>(cl, true) : plan_of<144>(cl, true);
  }
  const int cl = (C_out + 255) / 256, per = (C_out + cl - 1) / cl;
  if (per <= 144) return plan_of<144>(cl, false);
  if (per <= 192) return plan_of<192>(cl, false);
  return plan_of<256>(cl, false);
}

// A persistent launch of `kernel` in clusters of `cl` blocks: as many
// clusters as the card holds at once, or one per item when there are fewer.
template <typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int smem, int cl, int n_work, cudaStream_t stream,
                    Args&&... args) {
  const void* fn = (const void*)kernel;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(cl * (n_work < clusters ? n_work : clusters));
  err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int NS>
int launch_f32(const TmaMaps& maps, const Levels& lv, const int* work, int n_work,
               const float* wimg, const float* bias, const float* ln_w, const float* ln_b,
               int C_in, int C_out, int cl, float eps, int relu, cudaStream_t stream) {
  return launch_clusters(conv3_ln_act_wide_kernel<NS>, TfWide<NS>::BYTES, cl, n_work, stream,
                         maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu);
}

template <int NS>
int launch_bf16(const TmaMaps& maps, const Levels& lv, const int* work, int n_work,
                const __nv_bfloat16* wimg, const float* bias, const float* ln_w,
                const float* ln_b, int C_in, int C_out, int cl, float eps, int relu,
                cudaStream_t stream) {
  return launch_clusters(conv3_ln_act_wide_bf16_kernel<NS>, BfWide<NS>::BYTES, cl, n_work,
                         stream, maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out,
                         eps, relu);
}

// the checks both entry points make; the plan when the arguments are taken
bool takes(int n_work, int C_in, int C_out, int slice, int cluster, const void* wimg, bool bf16,
           WidePlan& p) {
  p = wide_plan(C_out, bf16);
  return n_work > 0 && C_in > 0 && p.slice > 0 && slice == p.slice && cluster == p.cluster &&
         reinterpret_cast<uintptr_t>(wimg) % 16 == 0;
}

}  // namespace

// The launch plan at C_out for f32 (bf16 = 0) or bf16 activations: out[0..4]
// = slice width, cluster size, ring stages, dynamic shared memory bytes and
// time columns per work item. Returns 0, or cudaErrorInvalidValue (out
// untouched) for a C_out the kernels do not take (above 1024).
extern "C" int decafnet_conv3_ln_act_wide_plan(int C_out, int bf16, int* out) {
  const WidePlan p = wide_plan(C_out, bf16 != 0);
  if (p.slice == 0) return (int)cudaErrorInvalidValue;
  out[0] = p.slice;
  out[1] = p.cluster;
  out[2] = p.stages;
  out[3] = p.smem;
  out[4] = p.tile;
  return (int)cudaSuccess;
}

// C entry point of the f32 kernel: one launch over n_levels levels (at most
// MAX_LEVELS) that share the weights, as decafnet_conv3_ln_act_f32
// (conv3_ln_act.cu) takes them; work holds items of the plan's tile; wimg the
// sliced TF32 image (see the kernel), 16-byte aligned; slice and cluster must
// be the plan's (decafnet_conv3_ln_act_wide_plan). Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for arguments the kernel does not take,
// cudaErrorNotSupported when a TMA descriptor cannot be made).
extern "C" int decafnet_conv3_ln_act_wide_f32(const Conv3Level* levels, int n_levels,
                                              const int* work, int n_work, const float* wimg,
                                              const float* bias, const float* ln_w,
                                              const float* ln_b, int C_in, int C_out,
                                              int slice, int cluster, float eps, int relu,
                                              cudaStream_t stream) {
  WidePlan p;
  if (!takes(n_work, C_in, C_out, slice, cluster, wimg, false, p))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, FBOX,
                              FKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  const int cl = p.cluster;
  switch (p.slice) {
    case 144:
      return launch_f32<144>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
    case 192:
      return launch_f32<192>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
    default:
      return launch_f32<256>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
  }
}

// C entry point of the bf16 kernel, as the f32 one: x and out bf16; wimg the
// sliced bf16 image (see the kernel); bias/ln_w/ln_b (C_out,) f32 or null.
extern "C" int decafnet_conv3_ln_act_wide_bf16(const Conv3Level* levels, int n_levels,
                                               const int* work, int n_work,
                                               const __nv_bfloat16* wimg, const float* bias,
                                               const float* ln_w, const float* ln_b, int C_in,
                                               int C_out, int slice, int cluster, float eps,
                                               int relu, cudaStream_t stream) {
  WidePlan p;
  if (!takes(n_work, C_in, C_out, slice, cluster, wimg, true, p))
    return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, WM,
                              WKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  const int cl = p.cluster;
  if (p.slice == 128)
    return launch_bf16<128>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
  return launch_bf16<144>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
}
