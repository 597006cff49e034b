// xxhash64_cols: Spark's XxHash64 chained over columns, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_xx_kernel
// (pallas_call at pallas_kernels.py:706, string lanes _xx64_string_lanes
// :596).  The TPU has no 64-bit lanes, so the TPU kernel carries every
// 64-bit value as a (hi, lo) pair of uint32 and multiplies in 16-bit limbs;
// it also reads one stacked [K, n] word matrix built by an extra XLA pass
// (_hash_mats).  Here the arithmetic is native uint64_t, and the kernel
// reads each column where it lies through one descriptor per column
// (SrjHashCol), normalising by type code as it loads (hash_common.cuh).
//
// Per row, in chain order, a null field leaves the running hash as it is.
// A fixed-width value is one 8-byte block (4-byte-or-narrower values
// sign-extended): XXH64 of 8 bytes seeded by the running hash.  A padded
// string is XXH64 of its bytes seeded by the running hash: the v1..v4
// accumulators over 32-byte chunks while offset <= len - 32, then + len,
// 8-byte stripes, one 4-byte block when len % 8 >= 4, the byte tail, and
// the avalanche.  The hash starts at `seed` (zero-extended from 32 bits,
// as in the JAX package).
//
// Bound: bytes.  Per row and 8-byte column the kernel reads 8 bytes and
// 1/8 of a mask byte, and it writes 8 bytes a row; the arithmetic of a
// value is 41 instructions in the SASS (each of its five 64x64-bit
// multiplies takes 3 or 4), so at 8 INT64 keys with 25% nulls that is 73
// bytes against 246 instructions a row: 21.8 us of bytes and 7.4 us of
// instructions per million rows (3.35 TB/s; 33.4 T instructions issued a
// second; chip_smoke.py counts both for its inputs).  A string costs 1.5
// to 3 instructions a byte against the byte read.
//
// Design for that bound: one thread per row, 256 threads a block, enough
// rows in flight to keep the loads streaming behind the multiplies; no
// shared memory.
// Descriptors come from the kernel's parameter space (__grid_constant__),
// fixed-width loads coalesce across the warp, and a string row is read from
// its own row in 4-byte words (its pitch is a multiple of 4 only), so those
// loads do not coalesce across the warp.  Every global offset is 64-bit.

#include <cstdint>

#include "hash_common.cuh"

namespace {

__device__ __forceinline__ uint64_t xx_string(const SrjHashCol& c,
                                              int64_t row, uint64_t seed) {
  int len;
  const uint8_t* p = srj_string_row(c, row, &len);
  int off = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kXxP1 + kXxP2;
    uint64_t v2 = seed + kXxP2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - kXxP1;
    for (; off <= len - 32; off += 32) {
      v1 = srj_xx_round(v1, srj_load64(p + off));
      v2 = srj_xx_round(v2, srj_load64(p + off + 8));
      v3 = srj_xx_round(v3, srj_load64(p + off + 16));
      v4 = srj_xx_round(v4, srj_load64(p + off + 24));
    }
    h = srj_rotl64(v1, 1) + srj_rotl64(v2, 7) + srj_rotl64(v3, 12) +
        srj_rotl64(v4, 18);
    h = srj_xx_merge(h, v1);
    h = srj_xx_merge(h, v2);
    h = srj_xx_merge(h, v3);
    h = srj_xx_merge(h, v4);
  } else {
    h = seed + kXxP5;
  }
  h += static_cast<uint64_t>(len);
  for (; off + 8 <= len; off += 8) {
    h ^= srj_xx_round(0, srj_load64(p + off));
    h = srj_rotl64(h, 27) * kXxP1 + kXxP4;
  }
  if (off + 4 <= len) {
    h ^= static_cast<uint64_t>(srj_load32(p + off)) * kXxP1;
    h = srj_rotl64(h, 23) * kXxP2 + kXxP3;
    off += 4;
  }
  for (; off < len; ++off) {
    h ^= static_cast<uint64_t>(__ldg(p + off)) * kXxP5;
    h = srj_rotl64(h, 11) * kXxP1;
  }
  return srj_xx_fmix(h);
}

// The chain over one launch's columns from h.
__device__ __forceinline__ uint64_t xx_row(const SrjHashCols& cols,
                                           int64_t row, uint64_t h) {
  for (int i = 0; i < cols.ncols; ++i) {
    const SrjHashCol& c = cols.col[i];
    if (!srj_row_valid(c, row)) continue;
    if (c.type == kString) {
      h = xx_string(c, row, h);
      continue;
    }
    const uint64_t block =
        (c.type == kB64 || c.type == kF64)
            ? srj_word64(c, row)
            : static_cast<uint64_t>(static_cast<int64_t>(
                  static_cast<int32_t>(srj_word32(c, row))));
    uint64_t hc = h + kXxP5 + 8;
    hc ^= srj_xx_round(0, block);
    hc = srj_rotl64(hc, 27) * kXxP1 + kXxP4;
    h = srj_xx_fmix(hc);
  }
  return h;
}

// A chain's first launch: every row starts at seed.
__global__ void __launch_bounds__(kHashThreads)
xxhash64_kernel(const __grid_constant__ SrjHashCols cols, int64_t n,
                uint64_t seed, uint64_t* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (row >= n) return;
  out[row] = xx_row(cols, row, seed);
}

// A later launch: each row starts from its value of row_seeds, which may
// be `out` itself (see murmur3.cu).
__global__ void __launch_bounds__(kHashThreads)
xxhash64_chain_kernel(const __grid_constant__ SrjHashCols cols, int64_t n,
                      const uint64_t* row_seeds, uint64_t* out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (row >= n) return;
  out[row] = xx_row(cols, row, row_seeds[row]);
}

}  // namespace

// Hashes n rows over the ncols (<= kMaxHashCols) descriptors at `cols`, in
// host memory, into out (int64 bits of uint64 [n]), every row starting at
// seed, or, where row_seeds is not null, at its own value of row_seeds (the
// output of the chain's previous launch; it may be out).  Launches on
// stream, of card `device`, and returns the launch's cudaError_t.
extern "C" int srj_xxhash64_cols(const SrjHashCol* cols, int ncols,
                                 int64_t n, uint64_t seed,
                                 const void* row_seeds, void* out,
                                 int device, void* stream) {
  return srj_launch_hash(xxhash64_kernel, xxhash64_chain_kernel, cols, ncols,
                         n, seed,
                         static_cast<const uint64_t*>(row_seeds),
                         static_cast<uint64_t*>(out), device, stream);
}
