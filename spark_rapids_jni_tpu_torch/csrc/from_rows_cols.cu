// from_rows_cols: JCUDF rows to their columns and packed validity masks, for
// sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/row_kernels.py::_from_rows_kernel
// (pallas_call at row_kernels.py:174, through _from_rows_pallas).  The TPU
// kernel writes one [tile, size] byte block per column and the rows'
// validity bytes, and XLA then unpacks the bits and bitcasts the bytes
// (bytes_to_col, pack_bools).  Here the kernel writes each column's values
// and its packed mask itself, as the reference's copy_from_rows does
// (row_conversion.cu:892-993): a tile of whole rows staged in shared memory.
//
// Input: uint8 [n, row_size] rows.  Output: for each column a buffer of n
// values of its size (one pointer a column, in the kernel's parameters,
// row_cols.cuh), and uint8 [ncols, mask_stride] packed masks, mask_stride =
// ceil(n / 8), bit r % 8 of byte r / 8 of row c set when row r's validity
// byte c / 8 has bit c % 8 set; the bits past n zero.
//
// Bound: bytes, the same as K10's the other way: at the 212-column
// benchmark schema 1008 row bytes read, 856 value bytes and 26.5 mask
// bytes written a row, 0.564 ms per million rows at 3.35 TB/s.
//
// Design for that bound: a block owns a tile of tile_rows rows (a multiple
// of 32, so that every 32-row group starts on a mask byte that is a
// multiple of 4) and loads them, one contiguous span, in 8-byte coalesced
// loads, four in flight a thread, into shared memory at a pitch of an odd
// number of words.  Then each warp takes (column, 32 rows) tasks: lane l
// reads row l's slot (its 32 words in 32 banks) and stores the value, so a
// warp's store is 32 consecutive values (coalesced); __ballot_sync of the
// 32 rows' validity bits is the column's mask word for those rows, which
// lanes 0 to 3 store as four bytes.  Every index into device memory is
// 64-bit: at 10.24M rows of 1008 bytes the rows pass 2^31 bytes.

#include <cstdint>

#include "launch.cuh"
#include "row_cols.cuh"

namespace {

constexpr int kUnroll = 4;

__global__ void __launch_bounds__(srj::kRowThreads)
from_rows_cols_kernel(const __grid_constant__ SrjRowCols cols,
                      const uint8_t* __restrict__ rows_in, int64_t n,
                      int tile_rows, uint8_t* __restrict__ vmask,
                      int64_t mask_stride) {
  extern __shared__ uint32_t tile[];
  const int rs = cols.row_size;
  const int pw = srj::tile_pitch_words(rs);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows =
      n - row0 < tile_rows ? static_cast<int>(n - row0) : tile_rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int groups = (rows + 31) >> 5;

  // the tile's rows: one contiguous span of the input, 8 bytes a load
  const int per_row = rs / 8;
  const int chunks = rows * per_row;
  const uint2* src = reinterpret_cast<const uint2*>(rows_in + row0 * rs);
  for (int i0 = threadIdx.x; i0 < chunks; i0 += kUnroll * blockDim.x) {
    uint2 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < chunks) v[u] = __ldg(src + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < chunks) {
        uint32_t* dst = tile + (i / per_row) * pw + 2 * (i % per_row);
        dst[0] = v[u].x;
        dst[1] = v[u].y;
      }
    }
  }
  __syncthreads();

  // columns: task t is column t / groups, rows 32 (t % groups) + lane.  The
  // task index is the same for the warp's 32 lanes, so all of them reach
  // the ballot.
  const uint8_t* tile_bytes = reinterpret_cast<const uint8_t*>(tile);
  for (int t = warp; t < cols.ncols * groups; t += nwarps) {
    const int c = t / groups;
    const int g = t % groups;
    const int r = g * 32 + lane;
    const bool live = r < rows;
    const int64_t row = row0 + r;
    const int s = cols.start[c];
    const uint32_t* w = tile + r * pw + s / 4;
    void* out = cols.data[c];
    if (live) {
      switch (cols.size[c]) {
        case 16:
          static_cast<uint4*>(out)[row] = make_uint4(w[0], w[1], w[2], w[3]);
          break;
        case 8:
          static_cast<uint2*>(out)[row] = make_uint2(w[0], w[1]);
          break;
        case 4:
          static_cast<uint32_t*>(out)[row] = w[0];
          break;
        case 2:
          static_cast<uint16_t*>(out)[row] =
              reinterpret_cast<const uint16_t*>(tile + r * pw)[s / 2];
          break;
        default:
          static_cast<uint8_t*>(out)[row] = tile_bytes[r * pw * 4 + s];
      }
    }
    const uint32_t bit =
        live ? (tile_bytes[r * pw * 4 + cols.validity_offset + c / 8] >>
                (c & 7)) & 1u
             : 0u;
    const uint32_t word = __ballot_sync(0xffffffffu, bit);
    const int64_t b = ((row0 + g * 32) >> 3) + lane;
    if (lane < 4 && b < mask_stride)
      vmask[c * mask_stride + b] = static_cast<uint8_t>(word >> (8 * lane));
  }
}

}  // namespace

// Decodes rows (uint8 [n, row_size]) into the column buffers at `cols`
// (host memory) and vmask (uint8 [ncols, mask_stride], mask_stride =
// ceil(n / 8)), tile_rows rows (a multiple of 32) a block.  Launches on
// stream, of card `device`, and returns the launch's cudaError_t.
extern "C" int srj_from_rows_cols(const SrjRowCols* cols, const void* rows,
                                  int64_t n, int tile_rows, void* vmask,
                                  int64_t mask_stride, int device,
                                  void* stream) {
  if (n <= 0) return 0;
  const int bad = srj::check_row_launch(cols, tile_rows);
  if (bad) return bad;
  const int64_t blocks = (n + tile_rows - 1) / tile_rows;
  if (mask_stride != (n + 7) / 8 || blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = tile_rows * 4 * srj::tile_pitch_words(cols->row_size);
  if (smem > srj::kDefaultTileBytes) {
    err = cudaFuncSetAttribute(from_rows_cols_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  from_rows_cols_kernel<<<static_cast<unsigned>(blocks), srj::kRowThreads,
                          smem, static_cast<cudaStream_t>(stream)>>>(
      *cols, static_cast<const uint8_t*>(rows), n, tile_rows,
      static_cast<uint8_t*>(vmask), mask_stride);
  return static_cast<int>(cudaGetLastError());
}
