// string_gather: every string column's chars out of a batch of compact JCUDF
// rows, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package gathers these chars in XLA
// (spark_rapids_jni_tpu/ops/row_conversion.py::_gather_one_string, one gather
// per column with an index per char).  In PyTorch that gather needs an int64
// index per char moved; this kernel is the reference's own GPU design instead
// (copy_strings_from_rows, row_conversion.cu): one warp a row, all string
// columns in one launch.
//
// Inputs: the blob (uint8, flat), its row offsets int32 [n + 1], and per
// string column the rows' (offset in the row, length) pair as two int32 [n]
// vectors (the decoded pair planes), and the output offsets int32 [n + 1]
// (the lengths' exclusive sum).  Output: per column uint8 [total]: row r's
// chars at out_offsets[r].
//
// Bound: memory.  The kernel must read the rows' offsets, each column's pair
// and output offsets (12 bytes a row a column) and every char once, and write
// every char once.
//
// Design: each warp copies its row's strings, column after column, by
// srj::warp_copy.  The caller checks every pair against its row and the blob
// before the launch (convert_from_rows does, with one reduction): an address
// outside the blob would fault, and a fault on the card is sticky.  Every
// global offset is 64-bit.

#include <cstdint>

#include "launch.cuh"
#include "ragged_copy.cuh"

struct SrjGatherStr {
  const int32_t* str_off;  // each row's char start, from the row's start [n]
  const int32_t* str_len;  // each row's length [n]
  const int32_t* out_off;  // each row's place in out [n + 1]
  uint8_t* out;            // the column's chars
};

struct SrjGatherCols {
  SrjGatherStr col[srj::kMaxStrCols];
  int32_t ncols;
};

namespace {

__global__ void __launch_bounds__(srj::kCopyThreads)
string_gather_kernel(const __grid_constant__ SrjGatherCols cols,
                     const uint8_t* __restrict__ blob,
                     const int32_t* __restrict__ row_offsets, int64_t n) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * srj::kCopyRowsPerBlock +
                    (threadIdx.x >> 5);
  if (r >= n) return;
  const uint8_t* row = blob + row_offsets[r];
  for (int c = 0; c < cols.ncols; ++c) {
    const SrjGatherStr& s = cols.col[c];
    const int64_t len = s.str_len[r];
    if (len > 0)
      srj::warp_copy(s.out + s.out_off[r], row + s.str_off[r], len, lane);
  }
}

}  // namespace

// Gathers the chars of n rows of blob (row offsets int32 [n + 1]) for each
// column of cols.  Launches on stream, of card `device`, and returns the
// launch's cudaError_t.
extern "C" int srj_string_gather(const void* cols, const void* blob,
                                 const void* row_offsets, int64_t n,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(
      (n + srj::kCopyRowsPerBlock - 1) / srj::kCopyRowsPerBlock);
  string_gather_kernel<<<blocks, srj::kCopyThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const SrjGatherCols*>(cols),
      static_cast<const uint8_t*>(blob),
      static_cast<const int32_t*>(row_offsets), n);
  return static_cast<int>(cudaGetLastError());
}
