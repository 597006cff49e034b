// to_rows_cols: a batch of table rows, read column by column, to JCUDF rows,
// for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/row_kernels.py::_to_rows_kernel
// (pallas_call at row_kernels.py:97, through _to_rows_pallas).  The TPU
// kernel takes one [tile, size] byte block per column, which XLA has cut out
// of each column first (col_to_bytes, the validity bytes built by
// _validity_row_bytes), because Mosaic lane-pads every such block to 128
// lanes; it zeroes a VMEM row block and stores each block at its slot.
// Hopper has no such constraint, so the kernel computes the function the way
// the reference's copy_to_rows does (row_conversion.cu:575-693): a tile of
// whole rows staged in shared memory, every column read where it lies.
//
// Input: one pointer a column (its values, at any start row), its slot and
// size in the row, and its packed validity mask (null: all valid), in the
// kernel's parameters (row_cols.cuh).  Output: uint8 [size, row_size] rows
// of table rows [start, start + size): each value's little-endian bytes at
// its slot, validity byte j bit k set when column 8j + k is valid, every
// other byte zero.
//
// Bound: bytes.  Per row the kernel must read each column's value and 1/8
// of a mask byte a column, and write the row: at the 212-column benchmark
// schema 856 value bytes, 26.5 mask bytes and 1008 row bytes, 1.89 GB at 1M
// rows, 0.564 ms at 3.35 TB/s (K1's bound: the same bytes).  It does no
// arithmetic worth counting.
//
// Design for that bound: a block owns a tile of tile_rows consecutive rows
// (a multiple of 32; 32 rows of a 1 KB row, more of a narrow one), staged in
// dynamic shared memory at a pitch of an odd number of words.  It zeroes the
// tile; then each warp takes (column, 32 rows) tasks, four at a time so that
// four loads are in flight before their stores: lane l reads row l's value,
// so a warp's load is 32 consecutive values (coalesced), and stores it at
// row * pitch + slot, the 32 rows' words in 32 banks.  Validity tasks (one
// row byte, 32 rows) load eight masks' bytes together and take each bit at
// the row's own bit offset, which need not be byte-aligned.  Then the
// tile's rows, one contiguous span of the output, leave in 8-byte
// coalesced stores.  Every index into device memory is 64-bit: at 10.24M
// rows of 1008 bytes the rows pass 2^31 bytes.

#include <cstdint>

#include "launch.cuh"
#include "row_cols.cuh"

namespace {

constexpr int kUnroll = 4;

// Column c's value of row `row`, widened to four words.
__device__ __forceinline__ uint4 load_value(const SrjRowCols& cols, int c,
                                            int64_t row) {
  const void* p = cols.data[c];
  switch (cols.size[c]) {
    case 16:
      return __ldg(static_cast<const uint4*>(p) + row);
    case 8: {
      const uint2 v = __ldg(static_cast<const uint2*>(p) + row);
      return make_uint4(v.x, v.y, 0u, 0u);
    }
    case 4:
      return make_uint4(__ldg(static_cast<const uint32_t*>(p) + row), 0u, 0u,
                        0u);
    case 2:
      return make_uint4(__ldg(static_cast<const uint16_t*>(p) + row), 0u, 0u,
                        0u);
    default:
      return make_uint4(__ldg(static_cast<const uint8_t*>(p) + row), 0u, 0u,
                        0u);
  }
}

// Stores value v of column c into its slot of the tile row at `row_base`.
__device__ __forceinline__ void store_value(const SrjRowCols& cols, int c,
                                            uint32_t* row_base, uint4 v) {
  const int s = cols.start[c];
  uint32_t* w = row_base + s / 4;  // slots of 4 bytes or more: word-aligned
  switch (cols.size[c]) {
    case 16:
      w[3] = v.w;
      w[2] = v.z;
      [[fallthrough]];
    case 8:
      w[1] = v.y;
      [[fallthrough]];
    case 4:
      w[0] = v.x;
      break;
    case 2:
      reinterpret_cast<uint16_t*>(row_base)[s / 2] =
          static_cast<uint16_t>(v.x);
      break;
    default:
      reinterpret_cast<uint8_t*>(row_base)[s] = static_cast<uint8_t>(v.x);
  }
}

__global__ void __launch_bounds__(srj::kRowThreads)
to_rows_cols_kernel(const __grid_constant__ SrjRowCols cols, int64_t start,
                    int64_t size, int tile_rows, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t tile[];
  const int rs = cols.row_size;
  const int pw = srj::tile_pitch_words(rs);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * tile_rows;
  const int rows =
      size - row0 < tile_rows ? static_cast<int>(size - row0) : tile_rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int groups = (rows + 31) >> 5;

  for (int i = threadIdx.x; i < rows * pw; i += blockDim.x) tile[i] = 0u;
  __syncthreads();

  // values: task t is column t / groups, rows 32 (t % groups) + lane
  const int ntasks = cols.ncols * groups;
  for (int t0 = warp; t0 < ntasks; t0 += kUnroll * nwarps) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * nwarps;
      const int r = (t % groups) * 32 + lane;
      if (t < ntasks && r < rows)
        v[u] = load_value(cols, t / groups, start + row0 + r);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u * nwarps;
      const int r = (t % groups) * 32 + lane;
      if (t < ntasks && r < rows)
        store_value(cols, t / groups, tile + r * pw, v[u]);
    }
  }

  // validity: task t is row byte t / groups, rows 32 (t % groups) + lane
  uint8_t* tile_bytes = reinterpret_cast<uint8_t*>(tile);
  const int vtasks = ((cols.ncols + 7) >> 3) * groups;
  for (int t = warp; t < vtasks; t += nwarps) {
    const int j = t / groups;
    const int r = (t % groups) * 32 + lane;
    if (r >= rows) continue;
    const int64_t row = start + row0 + r;
    const int64_t byte = row >> 3;
    const int bit = static_cast<int>(row & 7);
    // the eight masks' bytes are loaded before any is used, so that their
    // loads are in flight together
    uint32_t m[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 8 * j + k;
      const uint8_t* mask = c < cols.ncols ? cols.valid[c] : nullptr;
      m[k] = mask != nullptr ? __ldg(mask + byte)
                             : (c < cols.ncols ? 0xFFu : 0u);
    }
    uint32_t v = 0u;
#pragma unroll
    for (int k = 0; k < 8; ++k) v |= ((m[k] >> bit) & 1u) << k;
    tile_bytes[r * pw * 4 + cols.validity_offset + j] =
        static_cast<uint8_t>(v);
  }
  __syncthreads();

  // the tile's rows: one contiguous span of the output, 8 bytes a store
  const int per_row = rs / 8;
  uint2* dst = reinterpret_cast<uint2*>(out + row0 * rs);
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const uint32_t* src = tile + (i / per_row) * pw + 2 * (i % per_row);
    dst[i] = make_uint2(src[0], src[1]);
  }
}

}  // namespace

// Writes the JCUDF rows of table rows [start, start + size) of the columns
// at `cols` (host memory) into out (uint8 [size, row_size]), tile_rows rows
// (a multiple of 32) a block.  Launches on stream, of card `device`, and
// returns the launch's cudaError_t.
extern "C" int srj_to_rows_cols(const SrjRowCols* cols, int64_t start,
                                int64_t size, int tile_rows, void* out,
                                int device, void* stream) {
  if (size <= 0) return 0;
  const int bad = srj::check_row_launch(cols, tile_rows);
  if (bad) return bad;
  const int64_t blocks = (size + tile_rows - 1) / tile_rows;
  if (start < 0 || blocks >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = tile_rows * 4 * srj::tile_pitch_words(cols->row_size);
  if (smem > srj::kDefaultTileBytes) {
    err = cudaFuncSetAttribute(to_rows_cols_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  to_rows_cols_kernel<<<static_cast<unsigned>(blocks), srj::kRowThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      *cols, start, size, tile_rows, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
