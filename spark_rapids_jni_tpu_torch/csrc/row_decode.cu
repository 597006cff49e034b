// decode_planes: JCUDF rows to word planes plus packed validity, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/row_mxu.py::_fused_decode_kernel
// (pallas_call at row_mxu.py:1003, through _decode_planes_pallas_jit).  The
// TPU kernel runs the inverse byte permutation as an int8 matmul on the
// matrix unit and packs validity bits with a second one.  On Hopper both are
// data moves, so this kernel is a shared-memory tile transpose instead, in
// the manner of the reference's copy_from_rows (row_conversion.cu:892-993).
//
// Inputs: rows uint8 [n, row_stride] (row_stride may exceed the layout's
// row_size, for padded string rows) and a static map from each plane byte to
// its source row byte.  Outputs: planes int32 [W, n] (the inverse word plan:
// data words, then the rows' validity bytes packed four to a word) and vmask
// uint8 [ncols, ceil(n/8)] (packed LSB-first validity per column; bits of
// rows >= n are zero).
//
// Bound: memory.  Per row the kernel must read row_size bytes and write 4*W
// plane bytes and ncols/8 mask bytes; at the 212-column benchmark schema
// (row_size = 1008, W = 221) that is 1008 read + 884 + 26.5 written =
// 1918.5 bytes, about 0.57 ms per million rows at 3.35 TB/s.
//
// Design for that bound: one block per tile of kTileRows rows (a multiple of
// 8, so a tile owns whole validity bytes).
//  1. The block copies the bytes of its rows that the map reads (load_bytes
//     of each row) into shared memory as 4-byte words, neighbouring threads
//     on neighbouring addresses.  The row pitch is odd in words.
//  2. Each warp assembles one plane word for 32 consecutive rows from four
//     shared-memory bytes each (distinct banks, thanks to the odd pitch) and
//     writes them as 128 contiguous bytes of the plane.
//  3. The block packs each column's validity bits, 8 rows to a byte.
// Every global offset is 64-bit.

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kTileRows = 32;
constexpr int kThreads = 256;
constexpr int kMaskBytes = kTileRows / 8;

// word_map[4 * w + k]: the row byte that is byte k of plane word w, or -1.
__global__ void __launch_bounds__(kThreads)
decode_planes_kernel(const uint8_t* __restrict__ rows, int64_t row_stride,
                     int load_words, int words_pitch,
                     const int16_t* __restrict__ word_map, int num_words,
                     int num_cols, int validity_offset, int64_t n,
                     uint32_t* __restrict__ planes,
                     uint8_t* __restrict__ vmask, int64_t vmask_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem);
  int16_t* map = reinterpret_cast<int16_t*>(tile + kTileRows * words_pitch);

  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int nrows =
      static_cast<int>(min(static_cast<int64_t>(kTileRows), n - row0));

  for (int j = threadIdx.x; j < 4 * num_words; j += kThreads)
    map[j] = word_map[j];
  for (int i = threadIdx.x; i < nrows * load_words; i += kThreads) {
    const int r = i / load_words, c = i - r * load_words;
    tile[r * words_pitch + c] = *reinterpret_cast<const uint32_t*>(
        rows + (row0 + r) * row_stride + 4 * c);
  }
  __syncthreads();

  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(tile);
  for (int i = threadIdx.x; i < num_words * kTileRows; i += kThreads) {
    const int w = i / kTileRows, r = i % kTileRows;
    if (r >= nrows) continue;
    const uint8_t* src = bytes + r * words_pitch * 4;
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = map[4 * w + k];
      if (s >= 0) v |= static_cast<uint32_t>(src[s]) << (8 * k);
    }
    planes[w * n + row0 + r] = v;
  }

  for (int i = threadIdx.x; i < num_cols * kMaskBytes; i += kThreads) {
    const int c = i / kMaskBytes, j = i % kMaskBytes;
    if (8 * j >= nrows) continue;
    const uint8_t* src = bytes + validity_offset + c / 8;
    unsigned v = 0;
    for (int t = 0; t < 8 && 8 * j + t < nrows; ++t)
      v |= ((src[(8 * j + t) * words_pitch * 4] >> (c % 8)) & 1u) << t;
    vmask[c * vmask_stride + row0 / 8 + j] = static_cast<uint8_t>(v);
  }
}

}  // namespace

// Decodes n rows of row_stride bytes into planes (int32 [num_words, n]) and
// vmask (uint8 [num_cols, vmask_stride = ceil(n/8)]).  load_bytes (a multiple
// of 4, at most row_stride) covers every byte the map names; rows and
// row_stride must be 4-byte aligned.  Launches on stream, of card `device`,
// and returns the launch's cudaError_t.
extern "C" int srj_decode_planes(const void* rows, int64_t row_stride,
                                 int load_bytes, const void* word_map,
                                 int num_words, int num_cols,
                                 int validity_offset, int64_t n, void* planes,
                                 void* vmask, int64_t vmask_stride,
                                 int device, void* stream) {
  if (n <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int load_words = load_bytes / 4;
  const int words_pitch = load_words | 1;
  // under the 48 KB a launch gets without opting in: the map names bytes of
  // the 1 KB fixed section only, so load_words <= 256 and num_words <= 289,
  // which makes at most 32.9 + 2.3 KB
  const size_t smem = sizeof(uint32_t) * kTileRows * words_pitch +
                      sizeof(int16_t) * 4 * num_words;
  const unsigned blocks =
      static_cast<unsigned>((n + kTileRows - 1) / kTileRows);
  decode_planes_kernel<<<blocks, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rows), row_stride, load_words, words_pitch,
      static_cast<const int16_t*>(word_map), num_words, num_cols,
      validity_offset, n, static_cast<uint32_t*>(planes),
      static_cast<uint8_t*>(vmask), vmask_stride);
  return static_cast<int>(cudaGetLastError());
}
