// Design study, not part of the port: conv3 + LayerNorm + ReLU in f32 (3xTF32
// on wgmma) by a thread-block cluster of CL blocks per work item, each block
// computing its share of C_out in passes of 144 channels and keeping the
// item's pre-LN columns of its share in shared memory; the LN partial sums
// exchanged through distributed shared memory. The alternative, for C_out
// above 1024, to the pass kernel of decafnet_tpu_torch/csrc/conv3_ln_act_passes.cu
// (one block per 128-column item, the pre-LN sums kept in the output tensor).
// scripts/torch_conv3_passes_variants.py builds it and times it in turns
// against the shipped kernels.
//
// A block is scripts/conv3_wide_passes.cu's (items of 64 columns, the pass's
// 144 channels split over the two consumer warpgroups, N = 72 each; up to 4
// passes, 147 KB of pre-LN values beside a ring of 2 stages of 31 KB) with the
// cluster exchange of csrc/conv3_ln_act_wide.cu: lane q of each quad stores
// its partial into blocks q and q + 4 and arrives on their barriers, twice per
// item (the mean, the centred variance; cluster_sum and the other cluster
// helpers of conv3_wgmma.cuh). CL = ceil(C_out / 576) blocks, at
// most 4 here (8 KB of exchange buffers), each ceil(C_out / CL / 144) passes.
// Only levels TMA can read (rows on 16 bytes, T >= 32) are taken: the study's
// shapes are the served levels.

#include "conv3_wgmma.cuh"

using namespace decafnet;

namespace {

constexpr int NS = 144, NW = 72, TILE = WM, BOXES = TILE / FBOX + 2;
constexpr int MAX_CL = 4, RED_SRC = 2 * MAX_CL;
constexpr int RED_BYTES = 2 * RED_SRC * 2 * WM * 4;

template <int PASSES>
struct Plan {
  static constexpr int WBYTES = 2 * 3 * NS * FKC * 4;
  static constexpr int XBYTES = BOXES * FXBOX;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int PRE = PASSES * (NW / 2) * 256 * 4;
  static constexpr int PRM = 3 * PASSES * NS * 4;
  static constexpr int FIXED = PRE + RED_BYTES + PRM + (2 * 4 + 2) * 8 + 1024;
  static constexpr int FIT = (232448 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int PREO = STAGES * STAGE;
  static constexpr int RED = PREO + PRE;
  static constexpr int PARAMS = RED + RED_BYTES;
  static constexpr int BARS = PARAMS + PRM;
  static constexpr int BYTES = BARS + (2 * STAGES + 2) * 8 + 1024;
  static_assert(STAGES >= 2 && BYTES <= 232448, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

template <int PASSES>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_cluster_passes_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                            const int* __restrict__ work, int n_work,
                            const float* __restrict__ wimg, const float* __restrict__ bias,
                            const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                            int C_in, int C_out, float eps, int relu) {
  using P = Plan<PASSES>;
  constexpr int NCH = PASSES * NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* pre = reinterpret_cast<float*>(smem + P::PREO);
  float* red = reinterpret_cast<float*>(smem + P::RED);
  float* prm = reinterpret_cast<float*>(smem + P::PARAMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;
  uint64_t* xch = empty + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const uint32_t rank = cluster_rank(), cl = cluster_size();
  const int first = cluster_id(), step = cluster_count();
  const int n_chunks = (C_in + FKC - 1) / FKC, cb = rank * NCH;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init(&xch[0], 64 * cl);
    mbar_init(&xch[1], 64 * cl);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < NCH; i += W_THREADS) {
    const int co = cb + i;
    const bool ok = co < C_out;
    prm[i] = ok && bias != nullptr ? bias[co] : 0.f;
    prm[NCH + i] = ok ? (ln_w != nullptr ? ln_w[co] : 1.f) : 0.f;
    prm[2 * NCH + i] = ok && ln_b != nullptr ? ln_b[co] : 0.f;
  }
  cluster_sync_aligned();
  const float* wsl = wimg + (size_t)rank * PASSES * n_chunks * (P::WBYTES / 4);

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0 && lane == 0) {
      int stage = 0, phase = 0;
      for (int item = first; item < n_work; item += step) {
        const Item it = work_item(work, item);
        const int level = it.level, b = it.b, t0 = it.t0;
        const int T = pick(lv.T, level);
        for (int r = 0; r < PASSES; ++r)
          for (int c = 0; c < n_chunks; ++c) {
            mbar_wait(&empty[stage], phase ^ 1);
            uint8_t* sb = smem + stage * P::STAGE;
            int n = 0;
            for (int box = 0; box < BOXES; ++box) {
              const int ts = t0 + (box - 1) * FBOX;
              n += ts >= 0 && ts < T;
            }
            mbar_arrive_expect_tx(&full[stage], P::WBYTES + n * FXBOX);
            bulk_load(sb + P::XBYTES, wsl + ((size_t)r * n_chunks + c) * (P::WBYTES / 4),
                      P::WBYTES, &full[stage]);
            for (int box = 0; box < BOXES; ++box) {
              const int ts = t0 + (box - 1) * FBOX;
              if (ts >= 0 && ts < T)
                tma_load_3d(sb + box * FXBOX, &maps.m[level], ts, c * FKC, b, &full[stage]);
            }
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

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, w4 = warp & 3, g = lane >> 2, q = lane & 3, ctid = tid - 128;
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
  float acc[NW / 2];
  int stage = 0, phase = 0, xph = 0;
  for (int item = first; item < n_work; item += step) {
    const Item it = work_item(work, item);
    const int level = it.level, b = it.b, t0 = it.t0;
    const int T = pick(lv.T, level);
    const uint8_t* mb = pick(lv.mask, level) + (size_t)b * T;
    uint32_t keep = 0;
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = t0 + 16 * w4 + g + 8 * h + tap - 1;
        keep |= (uint32_t)(t >= 0 && t < T && mb[t]) << (2 * tap + h);
      }
    float s[2] = {0.f, 0.f};
    for (int r = 0; r < PASSES; ++r) {
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
      const int c0 = r * NS + nc;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = acc[4 * j + i] + prm[c0 + 8 * j + 2 * q + (i & 1)];
          pre[(r * (NW / 2) + 4 * j + i) * 256 + ctid] = v;
          if (cb + c0 + 8 * j + 2 * q + (i & 1) < C_out) s[i >> 1] += v;
        }
    }
    float mean[2], rstd[2];
    cluster_sum(s, col, red, &xch[0], xph, q, cl, src, n_src);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = s[h] / (float)C_out;
      s[h] = 0.f;
    }
    for (int r = 0; r < PASSES; ++r) {
      const int c0 = r * NS + nc;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (cb + c0 + 8 * j + 2 * q + (i & 1) < C_out) {
            const float dv = pre[(r * (NW / 2) + 4 * j + i) * 256 + ctid] - mean[i >> 1];
            s[i >> 1] = fmaf(dv, dv, s[i >> 1]);
          }
    }
    cluster_sum(s, col, red + RED_SRC * 2 * WM, &xch[1], xph, q, cl, src, n_src);
    xph ^= 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(s[h] / (float)C_out + eps);
    float* ob = static_cast<float*>(pick(lv.out, level)) + (size_t)b * C_out * T;
    for (int r = 0; r < PASSES; ++r) {
      const int c0 = r * NS + nc;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1, cs = c0 + 8 * j + 2 * q + (i & 1), co = cb + cs;
          const int t = t0 + 16 * w4 + g + 8 * h;
          float y = (pre[(r * (NW / 2) + 4 * j + i) * 256 + ctid] - mean[h]) * rstd[h] *
                        prm[NCH + cs] + prm[2 * NCH + cs];
          if (relu) y = fmaxf(y, 0.f);
          if (co < C_out && t < T) ob[(size_t)co * T + t] = y;
        }
    }
  }
  cluster_sync();
}

template <int PASSES>
int launch(const TmaMaps& maps, const Levels& lv, const int* work, int n_work, const float* wimg,
           const float* bias, const float* ln_w, const float* ln_b, int C_in, int C_out, int cl,
           float eps, int relu, cudaStream_t stream) {
  using P = Plan<PASSES>;
  const void* fn = (const void*)conv3_cluster_passes_kernel<PASSES>;
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cl);
  cfg.blockDim = dim3(W_THREADS);
  cfg.dynamicSmemBytes = P::BYTES;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, fn, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  cfg.gridDim = dim3(cl * (n_work < clusters ? n_work : clusters));
  err = cudaLaunchKernelEx(&cfg, conv3_cluster_passes_kernel<PASSES>, maps, lv, work, n_work,
                           wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// the plan at C_out: out[0] = blocks a cluster, out[1] = passes of 144 a block
extern "C" int conv3_cluster_passes_plan(int C_out, int* out) {
  const int cl = (C_out + 4 * NS - 1) / (4 * NS);
  if (C_out < 1 || cl > MAX_CL) return (int)cudaErrorInvalidValue;
  out[0] = cl;
  out[1] = ((C_out + cl - 1) / cl + NS - 1) / NS;
  return 0;
}

// work holds items of 64 columns; wimg (cluster x passes, ceil(C_in/8), 2, 3,
// 144, 8): the pass images of block 0, then block 1, ...
extern "C" int conv3_cluster_passes_f32(const Conv3Level* levels, int n_levels, const int* work,
                                        int n_work, const float* wimg, const float* bias,
                                        const float* ln_w, const float* ln_b, int C_in,
                                        int C_out, float eps, int relu, cudaStream_t stream) {
  int plan[2];
  if (conv3_cluster_passes_plan(C_out, plan) != 0 || n_work <= 0 || C_in <= 0)
    return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, FBOX,
                              FKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  for (int i = 0; i < n_levels; ++i)
    if (!lv.vec[i]) return (int)cudaErrorNotSupported;
  const int cl = plan[0];
  switch (plan[1]) {
    case 1:
      return launch<1>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
    case 2:
      return launch<2>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
    case 3:
      return launch<3>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
    default:
      return launch<4>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, cl, eps, relu, stream);
  }
}
