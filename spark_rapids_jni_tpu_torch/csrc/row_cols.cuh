// Shared by to_rows_cols.cu (K10) and from_rows_cols.cu (K11): the columns
// of one launch, as ops/kernels.py's _RowCols lays them out, and the
// shared-memory tile of whole rows both kernels stage.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// The most columns one launch takes: a JCUDF row of at most 1 KB holds at
// most 910 columns (1-byte columns and their validity bytes).  The structure
// is 19,472 bytes: two pointers, a 2-byte slot start and a 1-byte size a
// column fill most of it, inside the kernel's 32 KB parameter space (CUDA
// 12.1+), so nothing is copied to the card before a launch.
constexpr int kMaxRowCols = 1024;

struct SrjRowCols {
  void* data[kMaxRowCols];             // K10: each column read; K11: written
  const uint8_t* valid[kMaxRowCols];   // K10: packed masks, null: all valid
  uint16_t start[kMaxRowCols];         // the column's first byte in a row
  uint8_t size[kMaxRowCols];           // its bytes: 1, 2, 4, 8 or 16
  int32_t ncols;
  int32_t row_size;                    // a multiple of 8, at most 1024
  int32_t validity_offset;
};

namespace srj {

constexpr int kRowThreads = 256;
// A block's dynamic shared memory can reach 227 KB (232,448 bytes); past
// 48 KB only after cudaFuncSetAttribute.
constexpr int kMaxTileBytes = 232448;
constexpr int kDefaultTileBytes = 48 << 10;

// Words of a row in the shared tile.  The row size is a multiple of 8, so
// row_size / 4 is even and a warp whose 32 lanes touch one slot of 32
// rows would hit only 16 of the 32 banks; one more word makes the pitch
// odd, and those 32 words fall in 32 different banks.
__host__ __device__ inline int tile_pitch_words(int row_size) {
  return row_size / 4 + 1;
}

// The launch's checks, shared by both launchers: 0 or a cudaError_t.
inline int check_row_launch(const SrjRowCols* cols, int tile_rows) {
  const int64_t smem = static_cast<int64_t>(tile_rows) * 4 *
                       tile_pitch_words(cols->row_size);
  if (cols->ncols < 1 || cols->ncols > kMaxRowCols ||
      cols->row_size <= 0 || cols->row_size % 8 || cols->row_size > 1024 ||
      tile_rows <= 0 || tile_rows % 32 || smem > kMaxTileBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace srj
