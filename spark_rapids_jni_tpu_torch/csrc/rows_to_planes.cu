// rows_to_planes: JCUDF rows to 32-bit word planes, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_unpack_kernel
// (pallas_call at pallas_kernels.py:228, through _from_rows_planes_jit).  The
// TPU kernel reads a [tile, rs] block of row bytes into VMEM, combines each
// four bytes into a word with strided lane slices (no narrow bitcast, which
// the TPU's vregs would pad 32 times) and writes the words transposed.  On
// Hopper a row's bytes already are its words in order, so the kernel is a
// plain word transpose.
//
// Input: rows uint8 [n, 4 * W], 4-byte aligned.  Output: planes uint32
// [W, n], planes[j, r] being bytes 4j .. 4j + 3 of row r, little-endian: the
// inverse of planes_to_rows.cu.
//
// Bound: bytes.  The kernel must read 4 * W bytes a row and write as many:
// at the 212-column benchmark schema (1008-byte rows) 2016 bytes, about
// 0.60 ms per million rows at 3.35 TB/s.  It does no arithmetic.
//
// Design for that bound: the shared-memory tile transpose of
// word_transpose.cuh, one block per 32 x 32 tile of words, the word tiles
// of 32 rows on consecutive blocks.  The reads run along the rows and the
// writes along the planes, 128 contiguous bytes a warp on both sides; a row
// of fewer than 32 words leaves most of each warp's loads masked.

#include <cstdint>

#include "launch.cuh"
#include "word_transpose.cuh"

namespace {

__global__ void __launch_bounds__(srj::kTileThreads)
rows_to_planes_kernel(const uint32_t* __restrict__ rows, int64_t num_words,
                      int64_t n, uint32_t* __restrict__ planes) {
  // the source is [n, num_words]; the destination [num_words, n]
  const int64_t word_tiles = srj::tiles(num_words);
  const int64_t b = blockIdx.x;
  srj::transpose_tile(rows, num_words, n, num_words, planes, n,
                      (b / word_tiles) * srj::kTile,
                      (b % word_tiles) * srj::kTile);
}

}  // namespace

// Writes the planes of n rows (uint32 [n, num_words], the rows' bytes) into
// planes (uint32 [num_words, n]).  Launches on stream, of card `device`, and
// returns the launch's cudaError_t.
extern "C" int srj_rows_to_planes(const void* rows, int64_t n, int num_words,
                                  void* planes, int device, void* stream) {
  if (n <= 0) return 0;
  if (num_words < 1 ||
      srj::tiles(n) > srj::kMaxBlocks / srj::tiles(num_words))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>(srj::tiles(n) * srj::tiles(num_words)));
  const dim3 block(srj::kTile, srj::kTileThreadsY);
  rows_to_planes_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows), num_words, n,
      static_cast<uint32_t*>(planes));
  return static_cast<int>(cudaGetLastError());
}
