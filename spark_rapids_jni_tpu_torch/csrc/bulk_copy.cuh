// The mbarrier and bulk-copy helpers of the kernels that stage tiles of rows
// in a ring of shared-memory stages: the hash ring (hash_stage.cuh, K6 and
// K7) and the compact-row kernels (compact_encode.cu, string_gather.cu).
//
// A bulk copy (cp.async.bulk on an mbarrier) takes a 16-byte multiple at
// 16-byte addresses on both sides.  So a part that starts anywhere is
// copied as the aligned 16-byte chunks that hold it (never past the chunk
// of a byte the part owns), and read at its address's offset in the first
// chunk (stage_misalign).
#pragma once

#include <cstdint>

namespace {

// the most shared memory a block of this card can take (227 KB)
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ int stage_misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// The bytes a copy of len bytes at src moves: its aligned 16-byte chunks.
__device__ __forceinline__ uint32_t stage_chunk_bytes(const void* src,
                                                      int64_t len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return static_cast<uint32_t>(((a + len + 15) & ~uintptr_t{15}) -
                               (a & ~uintptr_t{15}));
}

// Copies the aligned chunks holding [src, src + len) to dst (16-byte
// aligned) on the mbarrier bar.
__device__ __forceinline__ void stage_copy(uint8_t* dst, const void* src,
                                           int64_t len, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15};
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(a), "r"(stage_chunk_bytes(src, len)), "r"(smem_u32(bar))
      : "memory");
}

}  // namespace
