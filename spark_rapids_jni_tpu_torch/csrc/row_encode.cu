// grouped_encode: JCUDF row encode from the plane-major backing, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/row_mxu.py::_grouped_encode_kernel
// (pallas_call at row_mxu.py:580, through _grouped_encode_impl).  The TPU
// kernel writes the byte permutation as one int8 matmul on the matrix unit.
// On Hopper that would spend tensor-core work on a pure data move, so this
// kernel is a shared-memory tile transpose instead, in the manner of the
// reference's copy_to_rows and copy_validity_to_rows
// (row_conversion.cu:575-810).
//
// Inputs: planes int32 [W_in >= Wd, n] (plane w holds data word w of every
// row; only the first Wd planes are read), vmask uint8 [ncols, ceil(n/8)]
// (packed LSB-first validity per column), a static map from each row byte to
// its source, and the batch [start, start + size).  Output: uint8
// [size, row_size] rows.
//
// Bound: memory.  Per row the kernel must read 4*Wd plane bytes and ncols/8
// mask bytes and write row_size bytes; at the 212-column benchmark schema
// (Wd = 214, row_size = 1008) that is 856 + 26.5 read + 1008 written =
// 1890.5 bytes, about 0.56 ms per million rows at 3.35 TB/s.  It does no
// arithmetic worth counting.
//
// Design for that bound: one block per tile of kTileRows rows, so every
// global access is coalesced.
//  1. Each warp reads 32 consecutive rows of one plane (128 contiguous bytes)
//     and stores them row-major in shared memory.  The row pitch is odd in
//     words, so the 32 transposing stores fall in 32 distinct banks.
//  2. The block builds each row's validity bytes from the packed masks.
//  3. The tile's rows are one contiguous span of the output.  The block
//     writes it with 8-byte stores, neighbouring threads on neighbouring
//     addresses.  Each store gathers its 8 bytes from the row in shared
//     memory through the byte map (plane byte, validity byte or zero), read
//     as one 16-byte load.
// Every global offset is 64-bit: at 4M rows the planes and the blob each
// pass 2^31 bytes.

#include <cstdint>
#include <cstring>

#include "launch.cuh"

namespace {

constexpr int kTileRows = 32;
constexpr int kThreads = 256;

// byte_map[j] for row byte j: >= 0 the byte's index in the row's data words
// (4 * word + byte), -1 zero padding, <= -2 validity byte (-2 - m).
__global__ void __launch_bounds__(kThreads)
grouped_encode_kernel(const uint32_t* __restrict__ planes,
                      int64_t plane_stride,
                      const uint8_t* __restrict__ vmask,
                      int64_t vmask_stride,
                      const int16_t* __restrict__ byte_map, int data_words,
                      int words_pitch, int num_cols, int validity_bytes,
                      int row_size, int64_t start, int64_t size,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);
  uint8_t* valid = smem + sizeof(uint32_t) * kTileRows * words_pitch;
  const int validity_pitch = validity_bytes;
  // 16-byte aligned: both regions before it hold a multiple of 16 bytes
  // (kTileRows = 32 rows of each)
  int16_t* map =
      reinterpret_cast<int16_t*>(valid + kTileRows * validity_pitch);

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(kTileRows), size - tile0));
  const int64_t row0 = start + tile0;  // first table row of the tile

  for (int j = threadIdx.x; j < row_size; j += kThreads) map[j] = byte_map[j];
  for (int i = threadIdx.x; i < data_words * kTileRows; i += kThreads) {
    const int w = i / kTileRows, r = i % kTileRows;
    if (r < rows)
      words[r * words_pitch + w] = planes[w * plane_stride + row0 + r];
  }
  for (int i = threadIdx.x; i < validity_bytes * kTileRows; i += kThreads) {
    const int b = i / kTileRows, r = i % kTileRows;
    if (r >= rows) continue;
    const int64_t row = row0 + r;
    const uint8_t* mask = vmask + (row >> 3);
    const int bit = static_cast<int>(row & 7);
    unsigned v = 0;
    for (int j = 0; j < 8 && 8 * b + j < num_cols; ++j)
      v |= ((mask[(8 * b + j) * vmask_stride] >> bit) & 1u) << j;
    valid[r * validity_pitch + b] = static_cast<uint8_t>(v);
  }
  __syncthreads();

  const int chunks = row_size / 8;
  const uint8_t* tile_bytes = reinterpret_cast<const uint8_t*>(words);
  uint64_t* dst = reinterpret_cast<uint64_t*>(out + tile0 * row_size);
  for (int q = threadIdx.x; q < rows * chunks; q += kThreads) {
    const int r = q / chunks, c = q - r * chunks;
    const uint8_t* src = tile_bytes + r * words_pitch * 4;
    const uint8_t* vsrc = valid + r * validity_pitch;
    const int4 packed = *reinterpret_cast<const int4*>(map + 8 * c);
    int16_t m[8];
    memcpy(m, &packed, sizeof(m));
    uint64_t chunk = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int s = m[k];
      const uint32_t byte = s >= 0 ? src[s] : (s == -1 ? 0u : vsrc[-2 - s]);
      chunk |= static_cast<uint64_t>(byte) << (8 * k);
    }
    dst[q] = chunk;
  }
}

}  // namespace

// Encodes table rows [start, start + size) into out (uint8 [size, row_size]).
// row_size must be a multiple of 8 and out 8-byte aligned; launches on
// stream, of card `device`, and returns the launch's cudaError_t.
extern "C" int srj_grouped_encode(const void* planes, int64_t plane_stride,
                                  const void* vmask, int64_t vmask_stride,
                                  const void* byte_map, int data_words,
                                  int num_cols, int validity_bytes,
                                  int row_size, int64_t start, int64_t size,
                                  void* out, int device, void* stream) {
  if (size <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int words_pitch = data_words | 1;
  // under the 48 KB a launch gets without opting in: a JCUDF row holds at
  // most 1 KB, so data_words <= 257 and validity_bytes <= 128, which makes
  // at most 32.9 + 4.1 + 2 KB
  const size_t smem = sizeof(uint32_t) * kTileRows * words_pitch +
                      kTileRows * validity_bytes +
                      sizeof(int16_t) * row_size;
  const unsigned blocks =
      static_cast<unsigned>((size + kTileRows - 1) / kTileRows);
  grouped_encode_kernel<<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), plane_stride,
      static_cast<const uint8_t*>(vmask), vmask_stride,
      static_cast<const int16_t*>(byte_map), data_words, words_pitch,
      num_cols, validity_bytes, row_size, start, size,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
