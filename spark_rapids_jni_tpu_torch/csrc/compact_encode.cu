// compact_encode: one batch of compact JCUDF rows, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package builds these rows in XLA
// (spark_rapids_jni_tpu/ops/row_conversion.py::_to_rows_variable_jit): a
// word-space scatter of the fixed sections, then one scatter-add of every
// char byte at its byte lane.  In PyTorch that scatter needs an int64 index
// per char moved; this kernel is the reference's own GPU design instead
// (copy_strings_to_rows, row_conversion.cu): one warp a row.
//
// Inputs: fixed uint8 [n, fixed_stride] (each row's fixed section, the
// string slots' (offset, length) pairs filled in, zeros from fixed_end to
// fe_pad, fixed_end rounded up to 4; fixed_stride a multiple of 4),
// row offsets int32 [n + 1] (multiples of 8), and per string column its chars
// (the batch's slice, starting at absolute char offset lo) and its absolute
// offsets at the batch's first row.  Output: uint8 [row_offsets[n]]: row r is
// its fixed section, then its strings' chars back to back from fixed_end, then
// zeros up to row_offsets[r + 1].
//
// Bound: memory.  The kernel must read n * fixed_end fixed bytes, 4 (n + 1)
// bytes of row offsets and of each column's offsets, and every char, and
// write the blob once.
//
// Design: each warp writes its row's bytes once, in address order.
//  1. The fixed section as fe_pad / 4 words (rows start 8-aligned); the
//     bytes past fixed_end carry zeros.
//  2. After __syncwarp (the chars of step 2 overwrite step 1's zeros in
//     [fixed_end, fe_pad)), each string column's chars by srj::warp_copy.
//  3. Zeros from the end of the chars to the row's end.
// Nothing is written past a row's end, whatever its offsets say.  Every
// global offset is 64-bit.

#include <cstdint>

#include "launch.cuh"
#include "ragged_copy.cuh"

struct SrjCompactStr {
  const uint8_t* chars;    // the batch's chars, starting at absolute offset lo
  const int32_t* offsets;  // absolute offsets of the batch's rows [n + 1]
  int64_t lo;
};

struct SrjCompactCols {
  SrjCompactStr col[srj::kMaxStrCols];
  int32_t ncols;
};

namespace {

__global__ void __launch_bounds__(srj::kCopyThreads)
compact_encode_kernel(const __grid_constant__ SrjCompactCols cols,
                      const uint8_t* __restrict__ fixed, int fixed_stride,
                      int fixed_end, const int32_t* __restrict__ row_offsets,
                      int64_t n, uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * srj::kCopyRowsPerBlock +
                    (threadIdx.x >> 5);
  if (r >= n) return;
  const int64_t base = row_offsets[r];
  const int64_t size = static_cast<int64_t>(row_offsets[r + 1]) - base;
  uint8_t* row = out + base;

  const uint32_t* src =
      reinterpret_cast<const uint32_t*>(fixed + r * fixed_stride);
  uint32_t* dst = reinterpret_cast<uint32_t*>(row);
  const int64_t words = min(static_cast<int64_t>((fixed_end + 3) / 4),
                            size / 4);
  for (int64_t i = lane; i < words; i += 32) dst[i] = src[i];
  __syncwarp();

  int64_t pos = fixed_end;
  for (int c = 0; c < cols.ncols; ++c) {
    const SrjCompactStr& s = cols.col[c];
    const int64_t o0 = s.offsets[r];
    const int64_t len = min(static_cast<int64_t>(s.offsets[r + 1]) - o0,
                            size - pos);
    if (len > 0) {
      srj::warp_copy(row + pos, s.chars + (o0 - s.lo), len, lane);
      pos += len;
    }
  }
  for (int64_t i = max(pos, words * 4) + lane; i < size; i += 32) row[i] = 0;
}

}  // namespace

// Writes n compact rows into out (uint8 [row_offsets[n]]) from fixed (uint8
// [n, fixed_stride]), row_offsets (int32 [n + 1]) and the string columns of
// cols.  The caller guarantees every row's offsets inside its chars.  Launches on
// stream, of card `device`, and returns the launch's cudaError_t.
extern "C" int srj_compact_encode(const void* cols, const void* fixed,
                                  int fixed_stride, int fixed_end,
                                  const void* row_offsets, int64_t n,
                                  void* out, int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>(
      (n + srj::kCopyRowsPerBlock - 1) / srj::kCopyRowsPerBlock);
  compact_encode_kernel<<<blocks, srj::kCopyThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      *static_cast<const SrjCompactCols*>(cols),
      static_cast<const uint8_t*>(fixed), fixed_stride, fixed_end,
      static_cast<const int32_t*>(row_offsets), n,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
