// murmur3_cols: Spark's Murmur3Hash chained over columns, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_mm3_kernel
// (pallas_call at pallas_kernels.py:564, string lanes _mm3_string_lanes
// :510).  The TPU kernel reads one stacked [K, n] word matrix that an XLA
// pass builds first from every column's normalised words (_hash_mats); that
// pass is a full extra trip over the keys.  Here the kernel reads each
// column where it lies, through one descriptor per column (SrjHashCol), and
// normalises by type code as it loads (hash_common.cuh).
//
// Per row, in chain order: a null field leaves the running hash as it is; a
// fixed-width value mixes its one or two 32-bit words and finalises with its
// byte length (4 or 8); a padded string mixes len/4 little-endian blocks,
// then each of its up-to-3 tail bytes sign-extended as Java's getByte (Spark
// hashUnsafeBytes), then finalises with len.  The hash starts at `seed`.
//
// Bound: bytes.  Per row and fixed-width column the kernel reads the value
// (1 to 8 bytes) and 1/8 of a mask byte, and it writes 4 bytes a row; the
// arithmetic of a value is 14 instructions for 4 bytes and 20 for 8 (one or
// two mixes and a finalisation, counted in the SASS; chip_smoke.py counts
// them for its inputs).  At 8 INT64 keys with 25% nulls that is 69 bytes
// against 120 instructions a row: 20.6 us of bytes and 3.6 us of
// instructions per million rows (3.35 TB/s; 33.4 T instructions issued a
// second), so the memory side bounds it.
//
// Design for that bound: one thread per row, 256 threads a block.  The
// column walk is the same for every thread, so the descriptors are read
// from the kernel's parameter space (__grid_constant__: no per-thread
// copy, no copy to the card before the launch), and neighbouring threads
// load neighbouring values of a fixed-width column: those loads coalesce.  A string row is read from its own row of
// chars in 4-byte words (the pitch is a multiple of 4), so across a warp
// those loads do not coalesce: each thread walks its own row.  The L1 keeps
// the 128-byte lines a warp touches while its threads walk them; a tile
// transpose through shared memory is left for a later change.  Every global
// offset is 64-bit.

#include <cstdint>

#include "hash_common.cuh"

namespace {

__device__ __forceinline__ uint32_t mm3_string(const SrjHashCol& c,
                                               int64_t row, uint32_t h) {
  int len;
  const uint8_t* p = srj_string_row(c, row, &len);
  const int nblocks = len >> 2;
  for (int j = 0; j < nblocks; ++j)
    h = srj_mm3_mix_h1(h, srj_load32(p + 4 * j));
  const int rem = len & 3;
  if (rem) {
    // the tail bytes lie in the word after the blocks, inside the row:
    // len <= pitch and the pitch is a multiple of 4
    const uint32_t tail = srj_load32(p + 4 * nblocks);
    for (int t = 0; t < rem; ++t) {
      const int8_t b = static_cast<int8_t>(tail >> (8 * t));
      h = srj_mm3_mix_h1(h, static_cast<uint32_t>(static_cast<int32_t>(b)));
    }
  }
  return srj_mm3_fmix(h, static_cast<uint32_t>(len));
}

// The chain over one launch's columns from h.
__device__ __forceinline__ uint32_t mm3_row(const SrjHashCols& cols,
                                            int64_t row, uint32_t h) {
  for (int i = 0; i < cols.ncols; ++i) {
    const SrjHashCol& c = cols.col[i];
    if (!srj_row_valid(c, row)) continue;
    if (c.type == kString) {
      h = mm3_string(c, row, h);
    } else if (c.type == kB64 || c.type == kF64) {
      const uint64_t v = srj_word64(c, row);
      h = srj_mm3_mix_h1(srj_mm3_mix_h1(h, static_cast<uint32_t>(v)),
                         static_cast<uint32_t>(v >> 32));
      h = srj_mm3_fmix(h, 8);
    } else {
      h = srj_mm3_fmix(srj_mm3_mix_h1(h, srj_word32(c, row)), 4);
    }
  }
  return h;
}

// A chain's first launch: every row starts at seed.
__global__ void __launch_bounds__(kHashThreads)
murmur3_kernel(const __grid_constant__ SrjHashCols cols, int64_t n,
               uint32_t seed, uint32_t* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (row >= n) return;
  out[row] = mm3_row(cols, row, seed);
}

// A later launch: each row starts from its word of row_seeds, which may be
// `out` itself (each thread reads its own row's word before it writes it),
// so neither pointer is __restrict__.
__global__ void __launch_bounds__(kHashThreads)
murmur3_chain_kernel(const __grid_constant__ SrjHashCols cols, int64_t n,
                     const uint32_t* row_seeds, uint32_t* out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (row >= n) return;
  out[row] = mm3_row(cols, row, row_seeds[row]);
}

}  // namespace

// Hashes n rows over the ncols (<= kMaxHashCols) descriptors at `cols`, in
// host memory, into out (int32 bits of uint32 [n]), every row starting at
// seed, or, where row_seeds is not null, at its own word of row_seeds (the
// output of the chain's previous launch; it may be out).  Launches on
// stream, of card `device`, and returns the launch's cudaError_t.
extern "C" int srj_murmur3_cols(const SrjHashCol* cols, int ncols,
                                int64_t n, uint32_t seed,
                                const void* row_seeds, void* out,
                                int device, void* stream) {
  return srj_launch_hash(murmur3_kernel, murmur3_chain_kernel, cols, ncols,
                         n, seed,
                         static_cast<const uint32_t*>(row_seeds),
                         static_cast<uint32_t*>(out), device, stream);
}
