// Pieces shared by the Hopper (sm_90a) conv3 + LayerNorm + activation kernels
// fed by TMA and run on wgmma: the tuned kernels of conv3_ln_act.cu (C_out up
// to 256), the wide ones of conv3_ln_act_wide.cu (a thread-block cluster
// splitting C_out) and the pass ones of conv3_ln_act_passes.cu (one block
// computing C_out in passes). The level table of a launch and its TMA
// descriptors, the work items, the TF32 split, the wgmma shared-memory
// descriptor, the warpgroup product instructions in TF32 (m64nNk8) and bf16
// (m64nNk16) at the widths the kernels use, the x boxes' swizzled offsets,
// and the wide kernels' LN exchange between the blocks of a cluster.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

// One level of a launch as the caller describes it (ops/fused_conv.py: _Level).
// Declared outside any anonymous namespace: the C entry points take it.
struct Conv3Level {
  const void* x;
  const uint8_t* mask;
  void* out;
  int B, T;
};

namespace decafnet {

constexpr int MAX_LEVELS = 8;               // FPN levels one launch takes

// The levels of one launch: per level the input (B, C_in, T), its mask (B, T)
// bytes, the output (B, C_out, T), T, and whether TMA reads x.
struct Levels {
  const void* x[MAX_LEVELS];
  const uint8_t* mask[MAX_LEVELS];
  void* out[MAX_LEVELS];
  int T[MAX_LEVELS];
  int vec[MAX_LEVELS];
};

// a[l] with l known only at run time, by selects over constant indices (an
// indexed read of a kernel parameter would copy the array to local memory)
template <typename P>
__device__ __forceinline__ P pick(const P (&a)[MAX_LEVELS], int l) {
  P v = a[0];
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (l == i) v = a[i];
  return v;
}

// Work item i: (level, row, first column) at work[3 * i].
struct Item {
  int level, b, t0;
};
__device__ __forceinline__ Item work_item(const int* __restrict__ work, int i) {
  const int* w = work + 3 * i;
  return {w[0], w[1], w[2]};
}

// tf32(v), rounded to nearest with ties away from zero: what cvt.rna.tf32.f32
// gives for every finite v and for inf, in two integer instructions where
// cvt.rna compiles to four (a NaN stays a NaN in v - tf32(v))
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// ------------------------------------------------------------------ shared
constexpr int W_THREADS = 384;              // a producer warpgroup and 2 consumer ones
constexpr int WM = 64;                      // time columns per consumer warpgroup (M)

// One TMA descriptor of x per level (boxes of 128 bytes of time x the
// stage's channels, 128-byte swizzle), in the kernel's parameter space.
struct TmaMaps {
  CUtensorMap m[MAX_LEVELS];
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// round_bf16 of two values in one conversion (bf16x2)
__device__ __forceinline__ void round_bf16_pair(float& a, float& b) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(a, b);
  a = __low2float(r);
  b = __high2float(r);
}

// shared-memory matrix descriptor of wgmma: start, leading and stride byte
// offsets, swizzle (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t gmma_desc(const void* p, int lbo, int sbo, int swizzle) {
  return ((smem_u32(p) & 0x3FFFFu) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)swizzle << 62);
}

// keep the compiler from moving accumulator reads or writes across wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void stmatrix_x4_trans(void* p, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};" ::"r"(
                   smem_u32(p)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// byte offset of bf16 (row r, column j) in a box of 128-byte rows under the
// 128-byte swizzle (16-byte chunk j / 8 of row r moves to chunk (j / 8) ^ (r % 8))
__device__ __forceinline__ int swz128(int r, int j) {
  return r * 128 + ((((j >> 3) ^ (r & 7)) << 4) | ((j & 7) << 1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// wait until at most N committed groups of this warpgroup's products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d (+)= A * B on the tensor cores: wgmma m64nNk8, TF32 in, f32 accumulate,
// A (64 time columns x 8 input channels) from registers (warp w, lane 4g + q:
// a[0] = time 16w + g, channel q; a[1] time + 8; a[2], a[3] at channel + 4),
// B (8 input channels x N output channels) from shared memory K-major;
// scale_d = 0 starts from zero. The accumulator layout is the bf16 one below:
// d[4j + 2h + p] = (time 16w + g + 8h, channel 8j + 2q + p).
template <int N>
struct WgmmaTf32;

template <>
struct WgmmaTf32<64> {
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<72> {
  __device__ static void mma(float (&d)[36], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35"
                 "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<96> {
  __device__ static void mma(float (&d)[48], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
                 "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<128> {
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                   "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
                   "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaTf32<160> {
  __device__ static void mma(float (&d)[80], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
                 "}, {%80, %81, %82, %83}, %84, p, 1, 1;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                   "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
                   "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
                   "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
                   "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
                   "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

constexpr int FKC = 8;                      // input channels per stage (one k8)
constexpr int FBOX = 32;                    // columns of one x box (128 bytes)
constexpr int FXBOX = FKC * FBOX * 4;       // bytes of one x box

// byte offset of f32 (row r, column j) in a box of 128-byte rows under the
// 128-byte swizzle (16-byte chunk j / 4 of row r moves to chunk (j / 4) ^ (r % 8))
__device__ __forceinline__ int swz128f(int r, int j) {
  return r * 128 + ((((j >> 2) ^ (r & 7)) << 4) | ((j & 3) << 2));
}

constexpr int WKC = 32;                     // input channels per stage
constexpr int XBOX = WKC * WM * 2;          // bytes of one x box: 32 rows of 128 B
constexpr int OS = WM * 2 + 16;             // bytes of a staged output row (one channel)

// d (+)= A * B on the tensor cores: wgmma m64nNk16, bf16 in, f32 accumulate,
// A (64 time columns x 16 input channels) from registers (warp w, lane 4g + q:
// a[0] = times 16w + g, channels 2q, 2q + 1; a[1] the same at time + 8; a[2],
// a[3] at channels + 8), B (16 input channels x N output channels) from shared
// memory K-major (the weight image); scale_d = 0 starts from zero. The
// accumulator layout: d[4j + 2h + p] = (time 16w + g + 8h, channel 8j + 2q + p).
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
                 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
                 "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                   "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
                   "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<144> {
  __device__ static void mma(float (&d)[72], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %77, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
                 "%64, %65, %66, %67, %68, %69, %70, %71"
                 "}, {%72, %73, %74, %75}, %76, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                   "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
                   "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
                   "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
                   "+f"(d[70]), "+f"(d[71])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<160> {
  __device__ static void mma(float (&d)[80], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
                 "}, {%80, %81, %82, %83}, %84, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                   "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
                   "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
                   "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
                   "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
                   "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ static void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b,
                             int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
                 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
                 "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
                 "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
                 "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
                 "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
                 "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
                   "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
                   "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
                   "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
                   "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
                   "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
                   "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
                   "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
                   "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
                   "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
                   "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
                   "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
                   "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
                   "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
                   "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
                   "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
                   "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
                   "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
                   "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
                   "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
                   "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
                   "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
                   "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
                   "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
                   "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
                   "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ------------------------------------------------------------------ cluster
// The LN exchange of the wide kernels (conv3_ln_act_wide.cu): remote stores
// and mbarrier arrivals in a peer block's shared memory, and the cluster's
// sum of an LN partial (the cluster's rank, size and barriers: hopper.cuh).

__device__ __forceinline__ void st_peer(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}
// arrive on a peer's mbarrier, releasing this thread's earlier stores to the cluster
__device__ __forceinline__ void arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// mbar_wait with acquire at cluster scope: the peers' stores released by their
// arrivals are visible after it (a wait past ~2^28 polls traps, as mbar_wait)
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, int parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 28)) __trap();
  }
}

// The cluster's sum of one LN partial of the columns col[0], col[1] of the
// item (s[h], this thread's channels): the quad's lanes add theirs, lane q
// stores the quad's sums as source `src` into red[src][col] of blocks q and
// q + 4 and arrives on their barriers `bar`, then every block waits for all
// 64 * CL arrivals on its own and adds sources 0 .. n_src - 1 in order.
__device__ __forceinline__ void cluster_sum(float (&s)[2], const int (&col)[2], float* red,
                                            uint64_t* bar, int parity, int q, uint32_t cl,
                                            int src, int n_src) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }
#pragma unroll
  for (uint32_t dst = q; dst < cl; dst += 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) st_peer(peer(red + src * 2 * WM + col[h], dst), s[h]);
    arrive_peer(peer(bar, dst));
  }
  mbar_wait_cluster(bar, parity);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = red[col[h]];
    for (int i = 1; i < n_src; ++i) v += red[i * 2 * WM + col[h]];
    s[h] = v;
  }
}

// The kernels' level table from the caller's, and a TMA descriptor of x
// (boxes of box_t columns x box_c channels, 128-byte swizzle) for each level
// TMA can read: rows on 16 bytes (T * elem_bytes a multiple of 16, x on 16
// bytes), T >= box_t and C_in >= box_c; the others take the producer's
// copies (lv.vec = 0). Returns cudaErrorInvalidValue when a level is empty
// or there are too many, cudaErrorNotSupported when a descriptor cannot be
// made.
inline int make_levels(const Conv3Level* levels, int n_levels, int C_in,
                       CUtensorMapDataType type, int elem_bytes, int box_t, int box_c,
                       Levels& lv, TmaMaps& maps) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  lv = Levels{};
  memset(&maps, 0, sizeof(maps));
  for (int i = 0; i < n_levels; ++i) {
    const Conv3Level& l = levels[i];
    if (l.B <= 0 || l.T <= 0) return (int)cudaErrorInvalidValue;
    lv.x[i] = l.x;
    lv.mask[i] = l.mask;
    lv.out[i] = l.out;
    lv.T[i] = l.T;
    lv.vec[i] = (l.T * elem_bytes) % 16 == 0 && reinterpret_cast<uintptr_t>(l.x) % 16 == 0 &&
                l.T >= box_t && C_in >= box_c;
    if (!lv.vec[i]) continue;
    const EncodeTiled encode = encode_tiled();
    const cuuint64_t dims[3] = {(cuuint64_t)l.T, (cuuint64_t)C_in, (cuuint64_t)l.B};
    const cuuint64_t strides[2] = {(cuuint64_t)l.T * elem_bytes,
                                   (cuuint64_t)C_in * l.T * elem_bytes};
    const cuuint32_t box[3] = {(cuuint32_t)box_t, (cuuint32_t)box_c, 1}, elem[3] = {1, 1, 1};
    if (encode == nullptr ||
        encode(&maps.m[i], type, 3, const_cast<void*>(l.x), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorNotSupported;
  }
  return (int)cudaSuccess;
}

}  // namespace decafnet
