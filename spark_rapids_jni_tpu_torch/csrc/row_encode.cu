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
// (packed LSB-first validity per column), static maps from each row word and
// byte to its source (kernels._encode_maps), and the batch [start, start +
// size).  Output: uint8 [size, row_size] rows.
//
// Bound: memory.  Per row the kernel must read 4*Wd plane bytes and ncols/8
// mask bytes and write row_size bytes; at the 212-column benchmark schema
// (Wd = 214, row_size = 1008) that is 856 + 26.5 read + 1008 written =
// 1890.5 bytes, about 0.56 ms per million rows at 3.35 TB/s.  It does no
// arithmetic worth counting.
//
// Design for that bound: one block per tile of kTileRows rows, every global
// access coalesced, and whole 32-bit words moved wherever the row allows.
//  1. Each warp reads 32 consecutive rows of one plane (128 contiguous bytes),
//     four planes' loads in flight before their stores, and stores them
//     row-major in shared memory.  The row pitch is odd in words, so the 32
//     transposing stores fall in 32 distinct banks.  Beside them, each
//     column's 32 validity bits of the tile are read as two aligned mask
//     words and a funnel shift, which takes the bits at the rows' own
//     offset: a batch may start at any row.
//  2. Each tile row's validity bytes are gathered from those column words
//     into the words after its data words.
//  3. The tile's rows are one contiguous span of the output, stored in
//     16-byte stores (8-byte where the output or the row size is only
//     8-byte aligned), a warp's lanes on 4 (2) rows of 8 (16) neighbouring
//     stores.  The word map (kernels.encode_word_map) makes most row words
//     one shared-memory word load (at the 212-column schema 184 of 252) or
//     a zero (31); only the mixed words (37) are assembled byte by byte
//     through the byte map.
// Every global offset is 64-bit: at 4M rows the planes and the blob each
// pass 2^31 bytes.

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kTileRows = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;

// maps: int16 [row_size] byte map, then int16 [row_size / 4] word map.  Byte
// map entry e >= 0: byte e of the tile row (4 * w + b for data word w, 4 *
// data_words + v for validity byte v); -1: zero.  Word map entry w >= 0: the
// row word is tile word w whole; -1: zero; -2: mixed, its bytes by the byte
// map.  kVec: words a store (4 or 2).
template <int kVec>
__global__ void __launch_bounds__(kThreads)
grouped_encode_kernel(const uint32_t* __restrict__ planes,
                      int64_t plane_stride,
                      const uint8_t* __restrict__ vmask, int64_t vmask_stride,
                      const int16_t* __restrict__ maps, int data_words,
                      int pitch, int num_cols, int validity_bytes,
                      int row_size, int64_t start, int64_t size,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_words = row_size / 4;
  uint32_t* words = reinterpret_cast<uint32_t*>(smem);  // [kTileRows, pitch]
  // 8-byte aligned: kTileRows rows of words hold a multiple of 128 bytes
  int16_t* wmap = reinterpret_cast<int16_t*>(words + kTileRows * pitch);
  int16_t* bmap = wmap + row_words;
  // 4-byte aligned: row_size is a multiple of 8
  uint32_t* colbits = reinterpret_cast<uint32_t*>(bmap + row_size);

  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTileRows;
  const int rows = static_cast<int>(
      min(static_cast<int64_t>(kTileRows), size - tile0));
  const int64_t row0 = start + tile0;  // first table row of the tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int j = threadIdx.x; j < row_size; j += kThreads) bmap[j] = maps[j];
  for (int j = threadIdx.x; j < row_words; j += kThreads)
    wmap[j] = maps[row_size + j];

  // 1. planes: lane = tile row, kUnroll planes a warp in flight
  const bool lane_row = lane < rows;
  for (int w0 = warp; w0 < data_words; w0 += kUnroll * kWarps) {
    uint32_t v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * kWarps;
      if (w < data_words && lane_row)
        v[u] = __ldg(planes + w * plane_stride + row0 + lane);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int w = w0 + u * kWarps;
      if (w < data_words && lane_row) words[lane * pitch + w] = v[u];
    }
  }
  // column c's bits of table rows [row0, row0 + 32): the two aligned mask
  // words around its byte row0 / 8, shifted to the row's bit.  The words
  // never leave the aligned words that hold a byte of vmask (the second is
  // read only where it starts inside vmask), so they cannot fault; bits past
  // the column's own bytes belong to rows past the batch, which no tile row
  // reads.
  const uintptr_t vend =
      reinterpret_cast<uintptr_t>(vmask + num_cols * vmask_stride);
  for (int c = threadIdx.x; c < num_cols; c += kThreads) {
    const uintptr_t b =
        reinterpret_cast<uintptr_t>(vmask + c * vmask_stride + (row0 >> 3));
    const uintptr_t a = b & ~uintptr_t{3};
    const uint32_t lo = __ldg(reinterpret_cast<const uint32_t*>(a));
    const uint32_t hi =
        a + 4 < vend ? __ldg(reinterpret_cast<const uint32_t*>(a + 4)) : 0u;
    colbits[c] = __funnelshift_r(
        lo, hi, static_cast<uint32_t>(8 * (b & 3) + (row0 & 7)));
  }
  __syncthreads();

  // 2. validity byte v of each tile row, after its data words
  uint8_t* tile_bytes = reinterpret_cast<uint8_t*>(words);
  for (int v = warp; v < validity_bytes; v += kWarps) {
    if (!lane_row) continue;
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = 8 * v + k;
      if (c < num_cols) byte |= ((colbits[c] >> lane) & 1u) << k;
    }
    tile_bytes[4 * (lane * pitch + data_words) + v] =
        static_cast<uint8_t>(byte);
  }
  __syncthreads();

  // 3. the rows: a warp's lanes on kVec rows of 32 / kVec stores each, so
  // that a store's k-th words (tile words 4c + k of rows with odd pitch) fall
  // in distinct banks, and each row's part of the warp is contiguous
  constexpr int kRowLanes = 32 / kVec;
  const int chunks = row_words / kVec;
  const int cgroups = (chunks + kRowLanes - 1) / kRowLanes;
  const int tasks = (kTileRows / kVec) * cgroups;
  uint8_t* dst = out + tile0 * row_size;
  for (int t = warp; t < tasks; t += kWarps) {
    const int r = (t / cgroups) * kVec + lane / kRowLanes;
    const int c = (t % cgroups) * kRowLanes + lane % kRowLanes;
    if (r >= rows || c >= chunks) continue;
    const uint32_t* src = words + r * pitch;
    int16_t e[kVec];
    if constexpr (kVec == 4) {
      const uint2 m = *reinterpret_cast<const uint2*>(wmap + 4 * c);
      e[0] = static_cast<int16_t>(m.x);
      e[1] = static_cast<int16_t>(m.x >> 16);
      e[2] = static_cast<int16_t>(m.y);
      e[3] = static_cast<int16_t>(m.y >> 16);
    } else {
      const uint32_t m = *reinterpret_cast<const uint32_t*>(wmap + 2 * c);
      e[0] = static_cast<int16_t>(m);
      e[1] = static_cast<int16_t>(m >> 16);
    }
    uint32_t v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      v[k] = e[k] >= 0 ? src[e[k]] : 0u;
      if (e[k] == -2) {
        const int16_t* bm = bmap + 4 * (kVec * c + k);
        const uint8_t* row_bytes = tile_bytes + 4 * r * pitch;
        uint32_t word = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (bm[b] >= 0)
            word |= static_cast<uint32_t>(row_bytes[bm[b]]) << (8 * b);
        v[k] = word;
      }
    }
    uint8_t* d = dst + static_cast<int64_t>(r) * row_size + 4 * kVec * c;
    if constexpr (kVec == 4) {
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    } else {
      *reinterpret_cast<uint2*>(d) = make_uint2(v[0], v[1]);
    }
  }
}

}  // namespace

// Encodes table rows [start, start + size) into out (uint8 [size,
// row_size]).  maps is int16 [row_size + row_size / 4] on the card (see
// grouped_encode_kernel).  row_size must be a multiple of 8 and out 8-byte
// aligned; launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_grouped_encode(const void* planes, int64_t plane_stride,
                                  const void* vmask, int64_t vmask_stride,
                                  const void* maps, int data_words,
                                  int num_cols, int validity_bytes,
                                  int row_size, int64_t start, int64_t size,
                                  void* out, int device, void* stream) {
  if (size <= 0) return 0;
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  if (row_size % 8 != 0 || (o & 7) != 0 || start < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int pitch = (data_words + (validity_bytes + 3) / 4) | 1;
  // under the 48 KB a launch gets without opting in: a JCUDF row holds at
  // most 1 KB, so data_words <= 257, num_cols <= 910 (1-byte columns and
  // their validity) and validity_bytes <= 114, which makes at most 36.7 +
  // 2.5 + 3.6 KB
  const size_t smem = sizeof(uint32_t) * kTileRows * pitch +
                      sizeof(int16_t) * (row_size + row_size / 4) +
                      sizeof(uint32_t) * num_cols;
  const bool wide = (o & 15) == 0 && row_size % 16 == 0;
  const auto kernel =
      wide ? grouped_encode_kernel<4> : grouped_encode_kernel<2>;
  const unsigned blocks =
      static_cast<unsigned>((size + kTileRows - 1) / kTileRows);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes), plane_stride,
      static_cast<const uint8_t*>(vmask), vmask_stride,
      static_cast<const int16_t*>(maps), data_words, pitch, num_cols,
      validity_bytes, row_size, start, size, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
