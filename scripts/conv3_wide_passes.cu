// Design study, not part of the port: conv3 + LayerNorm + ReLU above 256 output
// channels in f32 (3xTF32 on wgmma) by one block per work item that computes
// its C_out in passes of 144 channels, keeping the item's pre-LN columns in
// shared memory and normalising once all passes are done: the alternative to
// the thread-block cluster of decafnet_tpu_torch/csrc/conv3_ln_act_wide.cu.
// scripts/torch_conv3_wide_variants.py builds it and times it against the
// shipped kernel.
//
// A pass is the wide kernel's f32 pipeline with the slice split over the two
// consumer warpgroups (items of 64 columns, N = 72 each); its bias-added sums
// go to shared memory, each thread's own slots, 36 floats x 256 threads a
// pass (147 KB at 4 passes), beside a ring of 2 (4 passes) or 4 (2 passes)
// stages of 31 KB. The LN sums over the passes are exchanged between the two
// warpgroups as the tuned kernel's split does. Only levels TMA can read (rows
// on 16 bytes, T >= 32) are taken: the study's shapes are the served levels.

#include "conv3_wgmma.cuh"

using namespace decafnet;

namespace {

constexpr int NS = 144, NW = 72, TILE = WM, BOXES = TILE / FBOX + 2;

template <int PASSES>
struct PassPlan {
  static constexpr int WBYTES = 2 * 3 * NS * FKC * 4;
  static constexpr int XBYTES = BOXES * FXBOX;
  static constexpr int STAGE = XBYTES + WBYTES;
  static constexpr int PRE = PASSES * (NW / 2) * 256 * 4;
  static constexpr int RED_BYTES = 2 * 2 * WM * 4;
  static constexpr int PRM = 3 * PASSES * NS * 4;
  static constexpr int FIXED = PRE + RED_BYTES + PRM + 8 * 8 + 1024;
  static constexpr int FIT = (232448 - FIXED) / STAGE;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int PREO = STAGES * STAGE;
  static constexpr int RED = PREO + PRE;
  static constexpr int PARAMS = RED + RED_BYTES;
  static constexpr int BARS = PARAMS + PRM;
  static constexpr int BYTES = BARS + 2 * STAGES * 8 + 1024;
  static_assert(STAGES >= 2 && BYTES <= 232448, "shared memory of one block");
  static_assert(STAGE % 1024 == 0, "1024-byte aligned swizzle atoms");
};

template <int PASSES>
__global__ void __launch_bounds__(W_THREADS, 1)
conv3_passes_kernel(const __grid_constant__ TmaMaps maps, const Levels lv,
                    const int* __restrict__ work, int n_work, const float* __restrict__ wimg,
                    const float* __restrict__ bias, const float* __restrict__ ln_w,
                    const float* __restrict__ ln_b, int C_in, int C_out, float eps, int relu) {
  using P = PassPlan<PASSES>;
  constexpr int NCH = PASSES * NS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* pre = reinterpret_cast<float*>(smem + P::PREO);
  float* red = reinterpret_cast<float*>(smem + P::RED);
  float* prm = reinterpret_cast<float*>(smem + P::PARAMS);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + P::BARS);
  uint64_t* empty = full + P::STAGES;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int n_chunks = (C_in + FKC - 1) / FKC;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = tid; i < NCH; i += W_THREADS) {
    const bool ok = i < C_out;
    prm[i] = ok && bias != nullptr ? bias[i] : 0.f;
    prm[NCH + i] = ok ? (ln_w != nullptr ? ln_w[i] : 1.f) : 0.f;
    prm[2 * NCH + i] = ok && ln_b != nullptr ? ln_b[i] : 0.f;
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp != 0 || lane != 0) return;
    int stage = 0, phase = 0;
    for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
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
          bulk_load(sb + P::XBYTES, wimg + ((size_t)r * n_chunks + c) * (P::WBYTES / 4),
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
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int cw = wg - 1, w4 = warp & 3, g = lane >> 2, q = lane & 3, ctid = tid - 128;
  const int nc = cw * NW;
  int off[3][4];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int tt = 16 * w4 + g + 8 * (i & 1) + tap - 1;
      off[tap][i] = ((tt + FBOX) >> 5) * FXBOX + swz128f(q + 4 * (i >> 1), tt & 31);
    }
  auto channel_sum = [&](float (&s)[2], int k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
      s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
    }
    float* rr = red + k * 2 * WM;
    if (q == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h) rr[cw * WM + 16 * w4 + g + 8 * h] = s[h];
    named_sync(1, 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) s[h] = rr[16 * w4 + g + 8 * h] + rr[WM + 16 * w4 + g + 8 * h];
  };
  float acc[NW / 2];
  int stage = 0, phase = 0;
  for (int item = blockIdx.x; item < n_work; item += gridDim.x) {
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
          if (c0 + 8 * j + 2 * q + (i & 1) < C_out) s[i >> 1] += v;
        }
    }
    float mean[2], rstd[2];
    channel_sum(s, 0);
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
          if (c0 + 8 * j + 2 * q + (i & 1) < C_out) {
            const float dv = pre[(r * (NW / 2) + 4 * j + i) * 256 + ctid] - mean[i >> 1];
            s[i >> 1] = fmaf(dv, dv, s[i >> 1]);
          }
    }
    channel_sum(s, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) rstd[h] = rsqrtf(s[h] / (float)C_out + eps);
    float* ob = static_cast<float*>(pick(lv.out, level)) + (size_t)b * C_out * T;
    for (int r = 0; r < PASSES; ++r) {
      const int c0 = r * NS + nc;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1, co = c0 + 8 * j + 2 * q + (i & 1), t = t0 + 16 * w4 + g + 8 * h;
          float y = (pre[(r * (NW / 2) + 4 * j + i) * 256 + ctid] - mean[h]) * rstd[h] *
                        prm[NCH + co] + prm[2 * NCH + co];
          if (relu) y = fmaxf(y, 0.f);
          if (co < C_out && t < T) ob[(size_t)co * T + t] = y;
        }
    }
  }
}

template <int PASSES>
int launch(const TmaMaps& maps, const Levels& lv, const int* work, int n_work, const float* wimg,
           const float* bias, const float* ln_w, const float* ln_b, int C_in, int C_out,
           float eps, int relu, cudaStream_t stream) {
  using P = PassPlan<PASSES>;
  const cudaError_t err = cudaFuncSetAttribute(
      conv3_passes_kernel<PASSES>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (err != cudaSuccess) return (int)err;
  conv3_passes_kernel<PASSES><<<persistent_grid(n_work), W_THREADS, P::BYTES, stream>>>(
      maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// passes of 144 channels: 2 (C_out up to 288) or 4 (up to 576); work holds
// items of 64 columns, wimg (passes, ceil(C_in/8), 2, 3, 144, 8) TF32 halves
extern "C" int conv3_passes_plan(int C_out) {
  const int passes = (C_out + NS - 1) / NS;
  return passes <= 2 ? 2 : passes <= 4 ? 4 : 0;
}

extern "C" int conv3_passes_f32(const Conv3Level* levels, int n_levels, const int* work,
                                int n_work, const float* wimg, const float* bias,
                                const float* ln_w, const float* ln_b, int C_in, int C_out,
                                float eps, int relu, cudaStream_t stream) {
  const int passes = conv3_passes_plan(C_out);
  if (passes == 0 || n_work <= 0 || C_in <= 0) return (int)cudaErrorInvalidValue;
  Levels lv;
  TmaMaps maps;
  const int err = make_levels(levels, n_levels, C_in, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, FBOX,
                              FKC, lv, maps);
  if (err != (int)cudaSuccess) return err;
  for (int i = 0; i < n_levels; ++i)
    if (!lv.vec[i]) return (int)cudaErrorNotSupported;
  if (passes == 2)
    return launch<2>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
  return launch<4>(maps, lv, work, n_work, wimg, bias, ln_w, ln_b, C_in, C_out, eps, relu, stream);
}
