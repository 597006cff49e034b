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
// second), so the memory side bounds it.  A string needs the bytes under
// its length and 1.5 instructions a byte.
//
// Design for that bound: the staging ring of hash_stage.cuh, which K7
// shares.  A producer warp bulk-copies each tile's values and masks into a
// ring of shared-memory stages, so that many bytes are in flight on each
// SM, and consumer threads hash their rows from there, two rows a thread
// over fixed-width tables (two chains that interleave), one over tables
// with a string.  A string is read in place, each thread its own row, 16
// bytes a load where its rows are 16-byte aligned: only the sectors under
// the row's length are read, and on the card this beat staging the
// string, whether its whole tile (K7's way) or only the 16-byte chunks
// under each valid row's length, fetched into shared memory by the warp
// that owns the rows (PERF.md).  Such a walk waits on its loads and
// its chain, so the blocks of one row a thread are bounded to 32 registers
// a thread: 7 of them fit an SM.

#include <cstdint>

#include "hash_stage.cuh"

namespace {

__device__ __forceinline__ uint32_t mm3_mix_byte(uint32_t h, uint32_t word,
                                                 int t) {
  // Java's getByte sign-extends
  const int8_t b = static_cast<int8_t>(word >> (8 * t));
  return srj_mm3_mix_h1(h, static_cast<uint32_t>(static_cast<int32_t>(b)));
}

// h after the up-to-3 tail bytes in the low bytes of word.
__device__ __forceinline__ uint32_t mm3_tail(uint32_t h, uint32_t word,
                                             int rem) {
  for (int t = 0; t < rem; ++t) h = mm3_mix_byte(h, word, t);
  return h;
}

// hashUnsafeBytes of the len bytes at p (4-byte aligned) from h.  With
// `wide` p is 16-byte aligned and the bytes are read a 16-byte chunk at a
// time, the last chunk whole (its bytes past len are never hashed);
// otherwise 4-byte words, the tail bytes in the word after the blocks
// (len <= pitch, a multiple of 4).
template <class L>
__device__ __forceinline__ uint32_t mm3_bytes(const uint8_t* p, int len,
                                              bool wide, uint32_t h) {
  if (wide) {
    int off = 0;
    for (; off + 16 <= len; off += 16) {
      const uint4 q = L::u128(p + off);
      h = srj_mm3_mix_h1(srj_mm3_mix_h1(srj_mm3_mix_h1(srj_mm3_mix_h1(
                                            h, q.x), q.y), q.z), q.w);
    }
    const int rest = len - off;
    if (rest) {
      const uint4 q = L::u128(p + off);
      const int words = rest >> 2;
      if (words > 0) h = srj_mm3_mix_h1(h, q.x);
      if (words > 1) h = srj_mm3_mix_h1(h, q.y);
      if (words > 2) h = srj_mm3_mix_h1(h, q.z);
      const uint32_t tail =
          words == 0 ? q.x : (words == 1 ? q.y : (words == 2 ? q.z : q.w));
      h = mm3_tail(h, tail, rest & 3);
    }
  } else {
    const int nblocks = len >> 2;
    for (int j = 0; j < nblocks; ++j)
      h = srj_mm3_mix_h1(h, L::u32(p + 4 * j));
    if (len & 3) h = mm3_tail(h, L::u32(p + 4 * nblocks), len & 3);
  }
  return srj_mm3_fmix(h, static_cast<uint32_t>(len));
}

// The hash policy of hash_stage.cuh's kernel.
struct Murmur3 {
  using State = uint32_t;
  // a string walk read in place: 7 blocks of 256 consumers an SM (32
  // registers a thread)
  static constexpr int kOneRowBlocks = 7;

  template <int kType>
  static __device__ __forceinline__ uint32_t fixed(uint32_t h,
                                                   const uint8_t* p) {
    if constexpr (kType == kB64 || kType == kF64) {
      const uint64_t v = stage_word64_at(p, kType);
      h = srj_mm3_mix_h1(srj_mm3_mix_h1(h, static_cast<uint32_t>(v)),
                         static_cast<uint32_t>(v >> 32));
      return srj_mm3_fmix(h, 8);
    }
    return srj_mm3_fmix(srj_mm3_mix_h1(h, stage_word32_at(p, kType)), 4);
  }

  // 16-byte loads where the row is 16-byte aligned and so is its pitch, so
  // that a chunk read whole stays inside the row
  template <class L>
  static __device__ __forceinline__ uint32_t string(const uint8_t* p,
                                                    int len, int64_t pitch,
                                                    uint32_t h) {
    return mm3_bytes<L>(p, len, stage_misalign(p) == 0 && (pitch & 15) == 0,
                        h);
  }

  static __device__ __forceinline__ uint32_t field_global(
      const SrjHashCol& c, int64_t row, uint32_t h) {
    if (!srj_row_valid(c, row)) return h;
    if (c.type == kString) {
      int len;
      const uint8_t* p = srj_string_row(c, row, &len);
      return string<GlobalBytes>(p, len, c.pitch, h);
    }
    if (c.type == kB64 || c.type == kF64) {
      const uint64_t v = srj_word64(c, row);
      h = srj_mm3_mix_h1(srj_mm3_mix_h1(h, static_cast<uint32_t>(v)),
                         static_cast<uint32_t>(v >> 32));
      return srj_mm3_fmix(h, 8);
    }
    return srj_mm3_fmix(srj_mm3_mix_h1(h, srj_word32(c, row)), 4);
  }
};

}  // namespace

// Hashes n rows over the ncols (<= kMaxHashCols) descriptors at `cols`, in
// host memory, into out (int32 bits of uint32 [n]), every row starting at
// seed, or, where row_seeds is not null, at its own word of row_seeds (the
// output of the chain's previous launch; it may be out).  The descriptors
// carry hash_kernels._stage_plan's groups and offsets; tile_rows,
// rows_per_thread and stage_bytes are the plan's (hash_stage.cuh).
// Launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_murmur3_cols(const SrjHashCol* cols, int ncols,
                                int64_t n, uint32_t seed,
                                const void* row_seeds, void* out,
                                int tile_rows, int rows_per_thread,
                                int stage_bytes, int device, void* stream) {
  return srj_staged_hash_launch<Murmur3>(cols, ncols, n, seed, row_seeds,
                                         out, tile_rows, rows_per_thread,
                                         stage_bytes, device, stream);
}
