// Shared by the compact-row kernels (compact_encode.cu, string_gather.cu):
// their column descriptors' limit and the warp's ragged byte copy.
#pragma once

#include <cstdint>

namespace srj {

// The most string columns one launch takes: a JCUDF fixed section holds at
// most 1 KB, so at most 128 eight-byte (offset, length) slots.
constexpr int kMaxStrCols = 128;
// One warp a row, eight rows a block.
constexpr int kCopyThreads = 256;
constexpr int kCopyRowsPerBlock = kCopyThreads / 32;

// Copies len bytes from src to dst with the 32 lanes of a warp, lane l taking
// the l-th of every 32 units in address order.  Where src and dst are equally
// aligned to 16 (or to 4) bytes, the aligned middle moves as 16-byte (or
// 4-byte) units and only the head and tail as bytes; otherwise every unit is
// a byte.
__device__ __forceinline__ void warp_copy(uint8_t* __restrict__ dst,
                                          const uint8_t* __restrict__ src,
                                          int64_t len, int lane) {
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  int width = 1;
  if (((d ^ s) & 15) == 0 && len >= 64) {
    width = 16;
  } else if (((d ^ s) & 3) == 0 && len >= 16) {
    width = 4;
  }
  int64_t head = 0, body = 0;
  if (width > 1) {
    head = static_cast<int64_t>((width - (d & (width - 1))) & (width - 1));
    body = (len - head) / width * width;
  }
  for (int64_t i = lane; i < head; i += 32) dst[i] = src[i];
  if (width == 16) {
    const uint4* s16 = reinterpret_cast<const uint4*>(src + head);
    uint4* d16 = reinterpret_cast<uint4*>(dst + head);
    for (int64_t i = lane; i < body / 16; i += 32) d16[i] = s16[i];
  } else if (width == 4) {
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(src + head);
    uint32_t* d4 = reinterpret_cast<uint32_t*>(dst + head);
    for (int64_t i = lane; i < body / 4; i += 32) d4[i] = s4[i];
  }
  for (int64_t i = head + body + lane; i < len; i += 32) dst[i] = src[i];
}

}  // namespace srj
