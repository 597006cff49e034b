// A tile transpose of 32-bit words through shared memory, shared by the
// word-plane pack (planes_to_rows.cu, K4) and unpack (rows_to_planes.cu, K5).
//
// A block of kTile x kTileThreadsY threads moves one kTile x kTile tile: each
// warp reads kTile consecutive words of one source row (128 contiguous
// bytes), the block stores the tile in shared memory with a row pitch of
// kTile + 1 words, so that the transposing reads fall in 32 distinct banks,
// and each warp writes kTile consecutive words of one destination row.  The
// ragged edges of the source in both dimensions are masked.  Every element
// offset is 64-bit: the planes and rows of one batch pass 2^31 bytes.
//
// The grid is one-dimensional, the word tiles of a row tile on consecutive
// blocks: the blocks in flight together cover whole rows, so that the
// 128-byte segments of a row (which a 1008-byte row does not align to
// 32-byte sectors) meet in L2 before they go to device memory.
#pragma once

#include <cstdint>

namespace srj {

constexpr int kTile = 32;
constexpr int kTileThreadsY = 8;
constexpr int kTileThreads = kTile * kTileThreadsY;
// the most blocks a one-dimensional grid takes
constexpr int64_t kMaxBlocks = 2147483647;

// The tiles an extent of words or rows takes.
__host__ __device__ inline int64_t tiles(int64_t extent) {
  return (extent + kTile - 1) / kTile;
}

// dst[c * dst_pitch + r] = src[r * src_pitch + c] for every source element
// (r, c) of the tile [r0, r0 + kTile) x [c0, c0 + kTile) that lies inside the
// source's rows x cols.
__device__ __forceinline__ void transpose_tile(
    const uint32_t* __restrict__ src, int64_t src_pitch, int64_t rows,
    int64_t cols, uint32_t* __restrict__ dst, int64_t dst_pitch, int64_t r0,
    int64_t c0) {
  __shared__ uint32_t tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int64_t c = c0 + tx;
  if (c < cols) {
    for (int k = ty; k < kTile && r0 + k < rows; k += kTileThreadsY)
      tile[k][tx] = src[(r0 + k) * src_pitch + c];
  }
  __syncthreads();
  const int64_t r = r0 + tx;
  if (r < rows) {
    for (int k = ty; k < kTile && c0 + k < cols; k += kTileThreadsY)
      dst[(c0 + k) * dst_pitch + r] = tile[tx][k];
  }
}

}  // namespace srj
