// planes_to_rows: 32-bit word planes to JCUDF rows, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_pack_kernel
// (pallas_call at pallas_kernels.py:390, through _to_rows_planes_jit).  The
// TPU kernel reads a [W, tile] block of planes into VMEM, transposes it and
// expands each word into four byte lanes with a repeat and a tiled shift,
// the byte expansion the TPU's vregs allow.  On Hopper a row is the plane
// words' bytes in order, so the kernel is a plain word transpose: no byte is
// ever moved on its own.
//
// Input: planes uint32 [W, N] (plane j holds word j of every row; the
// validity bytes and the zero padding are already in their words) and a
// window [start, start + size) of its columns.  Output: uint8 [size, 4 * W]
// rows, byte 4j + t of row r being byte t of planes[j, start + r].
//
// Bound: bytes.  The kernel must read 4 * W bytes a row and write as many:
// at the 212-column benchmark schema (1008-byte rows) 2016 bytes, about
// 0.60 ms per million rows at 3.35 TB/s.  It does no arithmetic.
//
// Design for that bound: the shared-memory tile transpose of
// word_transpose.cuh, one block per 32 x 32 tile of words, the word tiles
// of 32 rows on consecutive blocks.  The reads run along the planes and the
// writes along the rows, 128 contiguous bytes a warp on both sides.  A row
// of fewer than 32 words (W = 2 for one INT32 column) leaves most of each
// warp's stores masked: right, not fast.

#include <cstdint>

#include "launch.cuh"
#include "word_transpose.cuh"

namespace {

__global__ void __launch_bounds__(srj::kTileThreads)
planes_to_rows_kernel(const uint32_t* __restrict__ planes,
                      int64_t plane_stride, int64_t num_words, int64_t start,
                      int64_t size, uint32_t* __restrict__ out) {
  // the source is the [num_words, size] window; the destination [size, W]
  const int64_t word_tiles = srj::tiles(num_words);
  const int64_t b = blockIdx.x;
  srj::transpose_tile(planes + start, plane_stride, num_words, size, out,
                      num_words, (b % word_tiles) * srj::kTile,
                      (b / word_tiles) * srj::kTile);
}

}  // namespace

// Writes the rows of columns [start, start + size) of planes (uint32
// [num_words, plane_stride]) into out (uint32 [size, num_words], the rows'
// bytes).  Launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_planes_to_rows(const void* planes, int64_t plane_stride,
                                  int num_words, int64_t start, int64_t size,
                                  void* out, int device, void* stream) {
  if (size <= 0) return 0;
  if (num_words < 1 || start < 0 || start + size > plane_stride ||
      srj::tiles(size) > srj::kMaxBlocks / srj::tiles(num_words))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(
      static_cast<unsigned>(srj::tiles(size) * srj::tiles(num_words)));
  const dim3 block(srj::kTile, srj::kTileThreadsY);
  planes_to_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), plane_stride, num_words, start,
      size, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
