// Helpers shared by the kernels that stage tiles in shared memory with
// cp.async (sm_80 and later): the copies, their waits, and the padded row
// stride of a staged tile.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace decafnet {

// 16-byte copy (L2 only); when !valid nothing is read and the bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid = true) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4-byte copy; when !valid nothing is read and the destination is zeroed
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// wait for every copy this thread issued, committed or not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Row stride, in elements of `elem_bytes` (4: f32, 2: bf16), of a tile staged
// as rows of `tile` columns with `pad` columns on each side (tile + 2 pad a
// multiple of 16 bytes): a multiple of 16 bytes and, when each column is worked
// by `split` lanes of a warp that read rows r, r + 1, .. at the same column, a
// row of 32 / split modulo 32 four-byte words, so those lanes hit distinct banks.
inline int row_stride(int tile, int pad, int split, int elem_bytes = 4) {
  const int per_word = 4 / elem_bytes, vec = 16 / elem_bytes;
  int r = tile + 2 * pad;
  if (split > 1)
    while ((r / per_word) % 32 != 32 / split) r += vec;
  return r;
}

}  // namespace decafnet
