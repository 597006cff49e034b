// xxhash64_cols: Spark's XxHash64 chained over columns, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_xx_kernel
// (pallas_call at pallas_kernels.py:706, string lanes _xx64_string_lanes
// :596).  The TPU has no 64-bit lanes, so the TPU kernel carries every
// 64-bit value as a (hi, lo) pair of uint32 and multiplies in 16-bit limbs;
// it also reads one stacked [K, n] word matrix built by an extra XLA pass
// (_hash_mats), a [K, tile] block of every column at once.  Here the
// arithmetic is native uint64_t, and the kernel reads each column where it
// lies through one descriptor per column (SrjHashCol), normalising by type
// code as it loads (hash_common.cuh).
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
// Design for that bound: the bytes must stream, so each SM needs many of
// them in flight; the staging ring of hash_stage.cuh, which K6 shares, keeps
// them so: a producer warp bulk-copies each tile's values, masks, string
// lengths and chars into a ring of shared-memory stages and consumer
// threads hash their rows from there (two rows a thread over fixed-width
// tables, whose chains interleave; one where a string is staged, whose
// byte loop diverges).  A string is staged whole (its tile_rows x pitch
// chars, one bulk copy), or, too wide for a stage, read in place.  Strings
// are hashed by one routine for both places: a row 16-byte aligned reads
// its 32-byte chunks as two 16-byte loads, any other row 4-byte words (its
// pitch is a multiple of 4 only).  Every global offset is 64-bit.

#include <cstdint>

#include "hash_stage.cuh"

namespace {

// ---------------------------------------------------------------------------
// The hash steps
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t pair64(uint32_t lo, uint32_t hi) {
  return static_cast<uint64_t>(lo) | (static_cast<uint64_t>(hi) << 32);
}

// XXH64 of the len bytes at p (4-byte aligned) seeded by seed.
template <class L>
__device__ __forceinline__ uint64_t xx_bytes(const uint8_t* p, int len,
                                             uint64_t seed) {
  int off = 0;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + kXxP1 + kXxP2;
    uint64_t v2 = seed + kXxP2;
    uint64_t v3 = seed;
    uint64_t v4 = seed - kXxP1;
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      for (; off <= len - 32; off += 32) {
        const uint4 a = L::u128(p + off), b = L::u128(p + off + 16);
        v1 = srj_xx_round(v1, pair64(a.x, a.y));
        v2 = srj_xx_round(v2, pair64(a.z, a.w));
        v3 = srj_xx_round(v3, pair64(b.x, b.y));
        v4 = srj_xx_round(v4, pair64(b.z, b.w));
      }
    } else {
      for (; off <= len - 32; off += 32) {
        v1 = srj_xx_round(v1, pair64(L::u32(p + off), L::u32(p + off + 4)));
        v2 = srj_xx_round(v2,
                          pair64(L::u32(p + off + 8), L::u32(p + off + 12)));
        v3 = srj_xx_round(v3,
                          pair64(L::u32(p + off + 16), L::u32(p + off + 20)));
        v4 = srj_xx_round(v4,
                          pair64(L::u32(p + off + 24), L::u32(p + off + 28)));
      }
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
    h ^= srj_xx_round(0, pair64(L::u32(p + off), L::u32(p + off + 4)));
    h = srj_rotl64(h, 27) * kXxP1 + kXxP4;
  }
  if (off + 4 <= len) {
    h ^= static_cast<uint64_t>(L::u32(p + off)) * kXxP1;
    h = srj_rotl64(h, 23) * kXxP2 + kXxP3;
    off += 4;
  }
  for (; off < len; ++off) {
    h ^= static_cast<uint64_t>(L::u8(p + off)) * kXxP5;
    h = srj_rotl64(h, 11) * kXxP1;
  }
  return srj_xx_fmix(h);
}

// XXH64 of one 8-byte block seeded by h.
__device__ __forceinline__ uint64_t xx_block(uint64_t h, uint64_t block) {
  uint64_t hc = h + kXxP5 + 8;
  hc ^= srj_xx_round(0, block);
  hc = srj_rotl64(hc, 27) * kXxP1 + kXxP4;
  return srj_xx_fmix(hc);
}

// The hash policy of hash_stage.cuh's kernel.
struct XxHash64 {
  using State = uint64_t;
  static constexpr int kOneRowBlocks = 1;

  // one 8-byte block: a value of 4 bytes or fewer sign-extended
  template <int kType>
  static __device__ __forceinline__ uint64_t fixed(uint64_t h,
                                                   const uint8_t* p) {
    if constexpr (kType == kB64 || kType == kF64)
      return xx_block(h, stage_word64_at(p, kType));
    return xx_block(h, static_cast<uint64_t>(static_cast<int64_t>(
                           static_cast<int32_t>(stage_word32_at(p, kType)))));
  }

  template <class L>
  static __device__ __forceinline__ uint64_t string(const uint8_t* p,
                                                    int len, int64_t,
                                                    uint64_t h) {
    return xx_bytes<L>(p, len, h);
  }

  static __device__ __forceinline__ uint64_t field_global(
      const SrjHashCol& c, int64_t row, uint64_t h) {
    if (!srj_row_valid(c, row)) return h;
    if (c.type == kString) {
      int len;
      const uint8_t* p = srj_string_row(c, row, &len);
      return xx_bytes<GlobalBytes>(p, len, h);
    }
    const uint64_t block =
        (c.type == kB64 || c.type == kF64)
            ? srj_word64(c, row)
            : static_cast<uint64_t>(static_cast<int64_t>(
                  static_cast<int32_t>(srj_word32(c, row))));
    return xx_block(h, block);
  }
};

}  // namespace

// Hashes n rows over the ncols (<= kMaxHashCols) descriptors at `cols`, in
// host memory, into out (int64 bits of uint64 [n]), every row starting at
// seed, or, where row_seeds is not null, at its own value of row_seeds (the
// output of the chain's previous launch; it may be out).  The descriptors
// carry hash_kernels._stage_plan's groups and offsets; tile_rows,
// rows_per_thread and stage_bytes are the plan's (hash_stage.cuh).
// Launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_xxhash64_cols(const SrjHashCol* cols, int ncols,
                                 int64_t n, uint64_t seed,
                                 const void* row_seeds, void* out,
                                 int tile_rows, int rows_per_thread,
                                 int stage_bytes, int device, void* stream) {
  return srj_staged_hash_launch<XxHash64>(cols, ncols, n, seed, row_seeds,
                                          out, tile_rows, rows_per_thread,
                                          stage_bytes, device, stream);
}
