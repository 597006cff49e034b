// Shared by the compact-row kernels (compact_encode.cu, string_gather.cu):
// their column descriptors' limit, the ring of tile stages they share in
// shape (kernels._encode_slot and _gather_slot lay a stage out the same
// way), a warp's scan, and the warp's ragged byte copy of their long-row
// route.
#pragma once

#include <cstdint>

namespace srj {

// The most string columns one launch takes: a JCUDF fixed section holds at
// most 1 KB, so at most 128 eight-byte (offset, length) slots.
constexpr int kMaxStrCols = 128;

// The ring: persistent blocks of one producer warp and up to
// kTileMaxWarps consumer warps walk tiles of at most kTileMaxRows rows
// through kTileMaxStages stages or fewer (the plan's).  Shared memory: the
// ring's mbarriers in its first kTileBarBytes, then the stages.
constexpr int kTileMaxRows = 128;
constexpr int kTileMaxWarps = 16;
constexpr int kTileMaxStages = 4;
constexpr int kTileBarBytes = 128;
// A stage's first 16 bytes: what the producer tells the consumers of the
// tile in it (kHdr* int32 slots).
constexpr int kSlotHeader = 16;
constexpr int kHdrLong = 0;   // 1: the tile takes the long-row route
constexpr int kHdrRows = 1;   // stage offset of row_offsets[r0]
constexpr int kHdrFixed = 2;  // encode: stage offset of row r0's fixed
// encode: out + row_offsets[r0], mod 16; gather: the image bytes the
// tile's parts take
constexpr int kHdrImage = 3;

__host__ __device__ constexpr int round16(int64_t bytes) {
  return static_cast<int>((bytes + 15) / 16 * 16);
}

// The room of a staged part of `bytes` bytes: whole 16-byte chunks and
// one more, since its aligned chunks may start inside the first.
__host__ __device__ constexpr int stage_room(int64_t bytes) {
  return round16(bytes) + 16;
}

// Where an encode stage's parts lie, in bytes from its start: the header,
// meta (int2 a column: the stage offsets of its chars' and its offsets'
// row r0), the row offsets [R + 1], each column's offsets [R + 1] (in
// col_room bytes, an odd number of 16-byte units, so that the lanes of a
// warp reading row i of 32 columns' offsets hit 8 bank groups, not 2), the
// fixed sections [R, stride] and the chars (up to chars_bytes: each
// column's aligned chunks back to back).  The image of a tile's output is
// the block's, one for all stages, after them.
struct EncodeSlot {
  int rows, cols, col_room, fixed, chars, bytes;
};

__host__ __device__ inline EncodeSlot encode_slot(int tile_rows, int ncols,
                                                  int stride,
                                                  int chars_bytes) {
  EncodeSlot s;
  s.rows = kSlotHeader + round16(8 * ncols);
  s.cols = s.rows + stage_room(4 * (tile_rows + 1));
  s.col_room = stage_room(4 * (tile_rows + 1));
  if (s.col_room % 32 == 0) s.col_room += 16;
  s.fixed = s.cols + ncols * s.col_room;
  s.chars = s.fixed + stage_room(static_cast<int64_t>(tile_rows) * stride);
  s.bytes = s.chars + chars_bytes;
  return s;
}

// Where a gather stage's parts lie: the header, meta (int2 a column: the
// stage offsets of its pair offsets' and its output offsets' row r0), each
// column's place in the block's image (int32 [ncols]: the image offset of
// its first byte of the tile's output), each row's base in the stage
// (int32 [R]: the stage offset of the row's byte 0, which may lie outside
// the stage: only the row's span is staged), each row's span (int2 [R]: its
// first byte and its bytes), the row offsets [R + 1], each column's pair
// offsets [R] and output offsets [R + 1] (a column's block:
// stage_room(4R) + stage_room(4(R + 1))), and the chars (up to chars_bytes:
// each row's span).  The block's image follows the stages.
struct GatherSlot {
  int places, bases, spans, rows, cols, col_bytes, chars, bytes;
};

__host__ __device__ inline GatherSlot gather_slot(int tile_rows, int ncols,
                                                  int chars_bytes) {
  GatherSlot s;
  s.places = kSlotHeader + round16(8 * ncols);
  s.bases = s.places + round16(4 * ncols);
  s.spans = s.bases + round16(4 * tile_rows);
  s.rows = s.spans + round16(8 * tile_rows);
  s.cols = s.rows + stage_room(4 * (tile_rows + 1));
  s.col_bytes = stage_room(4 * tile_rows) + stage_room(4 * (tile_rows + 1));
  s.chars = s.cols + ncols * s.col_bytes;
  s.bytes = s.chars + chars_bytes;
  return s;
}

// Inclusive sum of v over the warp's lanes.
__device__ __forceinline__ int warp_scan(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(0xFFFFFFFFu, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

// One lane's copy of len bytes between two places in shared memory, at any
// alignment: bytes up to dst's first 4-byte word, then whole words (each
// read as two aligned words and a funnel shift), then the tail's bytes.
// The second aligned word of a read starts at or before the last byte the
// read wants, so it lies in the staged 16-byte chunk that holds that byte.
__device__ __forceinline__ void lane_copy(uint8_t* dst, const uint8_t* src,
                                          int len) {
  int b = 0;
  const int head = min(len, static_cast<int>(
                                (4 - (reinterpret_cast<uintptr_t>(dst) & 3)) &
                                3));
  for (; b < head; ++b) dst[b] = src[b];
  for (; b + 4 <= len; b += 4) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(src + b);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p & ~uintptr_t{3});
    *reinterpret_cast<uint32_t*>(dst + b) =
        (p & 3) ? __funnelshift_r(w[0], w[1], 8 * (p & 3)) : w[0];
  }
  for (; b < len; ++b) dst[b] = src[b];
}

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

// Each warp of a long tile copies a row's strings: lane j of every 32
// holds the j-th piece's (dst, src, len), and the warp copies the pieces
// in turn by warp_copy.
__device__ __forceinline__ void warp_copy_pieces(uint8_t* dst,
                                                 const uint8_t* src,
                                                 int len, int lane) {
  unsigned live = __ballot_sync(0xFFFFFFFFu, len > 0);
  while (live) {
    const int j = __ffs(live) - 1;
    live &= live - 1;
    uint8_t* d = reinterpret_cast<uint8_t*>(__shfl_sync(
        0xFFFFFFFFu, reinterpret_cast<unsigned long long>(dst), j));
    const uint8_t* s = reinterpret_cast<const uint8_t*>(__shfl_sync(
        0xFFFFFFFFu, reinterpret_cast<unsigned long long>(src), j));
    warp_copy(d, s, __shfl_sync(0xFFFFFFFFu, len, j), lane);
  }
}

// A row's strings in the long-row route, lane j of every 32 holding the
// j-th one's (dst, src, len) in device memory: the strings of at most 32
// bytes kShortGroup at a time, lane b taking byte b of each, all their
// loads issued before their stores (so a row's short strings wait on one
// round trip a group, not one each), then each longer one by the whole
// warp (warp_copy_pieces).
constexpr int kShortGroup = 8;

__device__ __forceinline__ void row_copy_pieces(uint8_t* dst,
                                                const uint8_t* src, int len,
                                                int lane) {
  const bool short_one = len <= 32;
  unsigned live = __ballot_sync(0xFFFFFFFFu, short_one && len > 0);
  while (live) {
    uint8_t* d[kShortGroup];
    int n[kShortGroup];
    uint8_t v[kShortGroup];
#pragma unroll
    for (int k = 0; k < kShortGroup; ++k) {
      const bool some = live != 0;
      const int j = some ? __ffs(live) - 1 : 0;
      live &= live - 1;
      d[k] = reinterpret_cast<uint8_t*>(__shfl_sync(
          0xFFFFFFFFu, reinterpret_cast<unsigned long long>(dst), j));
      const uint8_t* s = reinterpret_cast<const uint8_t*>(__shfl_sync(
          0xFFFFFFFFu, reinterpret_cast<unsigned long long>(src), j));
      n[k] = __shfl_sync(0xFFFFFFFFu, len, j);
      if (!some) n[k] = 0;
      v[k] = lane < n[k] ? s[lane] : 0;
    }
#pragma unroll
    for (int k = 0; k < kShortGroup; ++k)
      if (lane < n[k]) d[k][lane] = v[k];
  }
  warp_copy_pieces(dst, src, short_one ? 0 : len, lane);
}

}  // namespace srj
