#!/usr/bin/env python3
"""The card's rate for TF32 mma.sync.m16n8k8 and bf16 mma.sync.m16n8k16,
the instructions the port's conv3 kernels (decafnet_tpu_torch/csrc/
conv3_ln_act.cu, f32 and bf16) are built on.

    python3 scripts/torch_mma_ceiling.py [--bf16]

Compiles a small kernel with nvcc (sm_90a) in which every warp issues
back-to-back mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 on operands
held in registers, with ILP independent accumulators per warp and W warps
per block, one block per SM and more. Prints one JSON line per
configuration (TFLOP/s, counting 2*16*8*8 operations per mma) and a last
line with the best rate, its share of the 495 TFLOP/s dense TF32 peak of
the H100 data sheet (which wgmma reaches), and the card's name and power
limit. Nothing is read from or written to device memory in the loop. With
--bf16 the same for m16n8k16 bf16 with f32 accumulation (2*16*8*16
operations per mma, against the 989 TFLOP/s dense bf16 peak).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "mma_ceiling")
TF32_PEAK = 495e12
BF16_PEAK = 989e12

SOURCE = r"""
#include <cuda_runtime.h>
#ifndef MMA_SHAPE
#define MMA_SHAPE "m16n8k8"
#define MMA_TYPE "tf32"
#endif
#include <stdint.h>

template <int ILP>
__global__ void mma_loop(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x * 7 + i) << 13;
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x * 3 + i) << 13;
  float c[ILP][4];
  for (int j = 0; j < ILP; ++j)
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < ILP; ++j)
      asm volatile("mma.sync.aligned." MMA_SHAPE ".row.col.f32." MMA_TYPE "." MMA_TYPE ".f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
                   : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  float s = 0.f;
  for (int j = 0; j < ILP; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_run(float* out, int ilp, int blocks, int threads, int iters,
                       cudaStream_t stream) {
  switch (ilp) {
    case 1: mma_loop<1><<<blocks, threads, 0, stream>>>(out, iters); break;
    case 2: mma_loop<2><<<blocks, threads, 0, stream>>>(out, iters); break;
    case 4: mma_loop<4><<<blocks, threads, 0, stream>>>(out, iters); break;
    case 8: mma_loop<8><<<blocks, threads, 0, stream>>>(out, iters); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
"""


def main():
    if not torch.cuda.is_available():
        print("torch_mma_ceiling: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from decafnet_tpu_torch.ops import cuda

    bf16 = "--bf16" in sys.argv[1:]
    os.makedirs(OUT, exist_ok=True)
    tag = "bf16" if bf16 else "tf32"
    cu, so = os.path.join(OUT, f"mma_{tag}.cu"), os.path.join(OUT, f"mma_{tag}.so")
    with open(cu, "w") as f:
        f.write(SOURCE)
    defs = ["-DMMA_SHAPE=\"m16n8k16\"", "-DMMA_TYPE=\"bf16\""] if bf16 else []
    subprocess.run([cuda.toolkit_binary(), *cuda.NVCC_FLAGS, *defs, "-shared", cu,
                    "-o", so], check=True, capture_output=True, text=True)
    k, peak = (16, BF16_PEAK) if bf16 else (8, TF32_PEAK)
    fn = ctypes.CDLL(so).mma_run
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    best = 0.0
    for warps in (4, 8, 16, 32):
        for blocks_per_sm in (1, 2):
            for ilp in (1, 2, 4, 8):
                blocks, threads = sms * blocks_per_sm, 32 * warps
                out = torch.empty(blocks * threads, device="cuda")

                def run():
                    cuda.check(fn(cuda.ptr(out), ilp, blocks, threads, iters,
                                  cuda.stream()), "mma_loop")

                ms = cs.time_ms(run, 5)
                flops = blocks * warps * iters * ilp * 2 * 16 * 8 * k
                tflops = flops / (ms * 1e-3) / 1e12
                best = max(best, tflops)
                print(json.dumps({"warps_per_block": warps,
                                  "blocks_per_sm": blocks_per_sm, "ilp": ilp,
                                  "warps_per_sm": warps * blocks_per_sm,
                                  "ms": ms, "tflops": tflops}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"mma": ("m16n8k16 bf16" if bf16 else "m16n8k8 tf32")
                      + " f32-accumulate, mma.sync", "best_tflops": best,
                      "share_of_peak": best * 1e12 / peak, "peak_tflops": peak / 1e12,
                      "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
