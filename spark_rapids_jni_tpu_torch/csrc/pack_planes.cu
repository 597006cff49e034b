// pack_planes: a batch of table rows to its forward word planes, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/row_mxu.py::_pack_kernel (pallas_call at
// row_mxu.py:307, through _pack_planes_pallas :267).  The TPU kernel reads
// columns that XLA passes have grouped first (the 64-bit columns stacked into
// one [2 * n8, n] block, every column's validity bits unpacked into 0/1
// quads), in 2048-row tiles of VMEM.  Here the kernel reads each column
// where it lies, at the batch's start row, through one pointer per column in
// the kernel's parameter space, and unpacks the validity bits itself.
//
// Output: uint32 [W, size] planes of the forward word plan
// (row_mxu._forward_plan): the 8-byte columns as (lo, hi) plane pairs, then
// the 4-byte columns, the 2-byte columns two to a word (the first in the low
// half), the 1-byte columns four to a word (the first in the low byte), each
// class in table order; then the validity quads, byte c % 4 of word c / 4
// holding column c's validity as 0 or 1 (1 for a column without a mask),
// the pad bytes of the last quad zero.  Plane w of batch row r lands at
// out[w * size + r].
//
// Bound: bytes.  Per row the kernel must read each column's value and 1/8
// of a mask byte, and write 4 * W bytes; at the 212-column benchmark schema
// (856 value bytes, 26.5 mask bytes, W = 267) that is 1950.5 bytes, about
// 0.58 ms per million rows at 3.35 TB/s.  It does no arithmetic worth
// counting.
//
// Design for that bound: one thread a row, 256 threads a block, consecutive
// threads on consecutive rows.  Every thread walks the same planes in the
// same order, so a warp's loads of one column and its stores of one plane
// each fall on consecutive addresses: both coalesce.  The column pointers
// are read from the kernel's parameters (__grid_constant__): nothing is
// copied to the card before the launch.  The mask bytes a warp reads are
// the same few bytes for all its threads and come from L1.  Every index is
// 64-bit: at 6M rows of the 212-column schema the planes pass 2^31 bytes.

#include <cstdint>

#include "launch.cuh"

// The most columns one launch takes: a JCUDF row of at most 1 KB holds at
// most 910 columns (1-byte columns and their validity bytes).  Two pointers
// a column fill 16 KB of the kernel's 32 KB parameter space (CUDA 12.1+).
constexpr int kMaxPackCols = 1024;

// The columns of one launch, as ops/kernels.py's _PackCols lays them out.
struct SrjPackCols {
  const void* data[kMaxPackCols];      // plan order: 8-, 4-, 2-, 1-byte
  const uint8_t* valid[kMaxPackCols];  // table order; null: all valid
  int32_t n8, n4, n2, n1;
};

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pack_planes_kernel(const __grid_constant__ SrjPackCols cols, int64_t start,
                   int64_t size, uint32_t* __restrict__ out) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= size) return;
  const int64_t row = start + r;
  uint32_t* dst = out + r;
  int64_t w = 0;  // the next plane
  int c = 0;      // the next column, in plan order
  for (int i = 0; i < cols.n8; ++i, ++c, w += 2) {
    const unsigned long long v =
        __ldg(static_cast<const unsigned long long*>(cols.data[c]) + row);
    dst[w * size] = static_cast<uint32_t>(v);
    dst[(w + 1) * size] = static_cast<uint32_t>(v >> 32);
  }
  for (int i = 0; i < cols.n4; ++i, ++c, ++w)
    dst[w * size] = __ldg(static_cast<const uint32_t*>(cols.data[c]) + row);
  for (int i = 0; i < cols.n2; i += 2, ++w) {
    uint32_t word = __ldg(static_cast<const uint16_t*>(cols.data[c++]) + row);
    if (i + 1 < cols.n2)
      word |= static_cast<uint32_t>(
                  __ldg(static_cast<const uint16_t*>(cols.data[c++]) + row))
              << 16;
    dst[w * size] = word;
  }
  for (int i = 0; i < cols.n1; i += 4, ++w) {
    uint32_t word = 0;
    for (int j = 0; j < 4 && i + j < cols.n1; ++j)
      word |= static_cast<uint32_t>(
                  __ldg(static_cast<const uint8_t*>(cols.data[c++]) + row))
              << (8 * j);
    dst[w * size] = word;
  }
  const int ncols = c;
  const int64_t byte = row >> 3;
  const int bit = static_cast<int>(row & 7);
  for (int q = 0; q < ncols; q += 4, ++w) {
    uint32_t word = 0;
    for (int j = 0; j < 4 && q + j < ncols; ++j) {
      const uint8_t* mask = cols.valid[q + j];
      const uint32_t v =
          mask == nullptr ? 1u : (__ldg(mask + byte) >> bit) & 1u;
      word |= v << (8 * j);
    }
    dst[w * size] = word;
  }
}

}  // namespace

// Packs table rows [start, start + size) of the columns at `cols` (host
// memory; at most kMaxPackCols) into out (uint32 [W, size]).  Launches on
// stream, of card `device`, and returns the launch's cudaError_t.
extern "C" int srj_pack_planes(const SrjPackCols* cols, int64_t start,
                               int64_t size, void* out, int device,
                               void* stream) {
  if (size <= 0) return 0;
  const int ncols = cols->n8 + cols->n4 + cols->n2 + cols->n1;
  if (ncols < 1 || ncols > kMaxPackCols)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((size + kThreads - 1) / kThreads);
  pack_planes_kernel<<<blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      *cols, start, size, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
