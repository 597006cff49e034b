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
// them in flight, whereas one thread a row walking its columns holds one
// column's loads in flight at a time (each field's hash waits on the last).
// So, as the TPU kernel reads a [K, tile] block at once, a block here stages
// tiles of rows in a ring of kXxStages shared-memory stages:
//  - Persistent blocks of one producer warp and tile_rows / (32 x
//    rows_per_thread) consumer warps walk the row tiles (tile_rows rows
//    each, a multiple of 128).
//  - The columns form groups in chain order, each small enough for one
//    stage; the plan (hash_kernels._xx_stage_plan, in Python) gives each
//    column its group and its offset in the stage, in SrjHashCol::stage.
//  - For each (tile, group) the producer waits for a free stage and copies
//    the tile's part of every staged column into it with bulk copies
//    (cp.async.bulk on the stage's mbarrier): the values, the mask bytes
//    and, for a string, its lengths and its tile_rows x pitch chars, which
//    lie contiguous.  A bulk copy takes 16-byte multiples at 16-byte
//    addresses, so each copy takes the aligned 16-byte chunks that hold the
//    part (never past the page of a byte the column owns) and the consumers
//    read it from the part's offset in its first chunk: a column view at
//    any element offset stages as well as an aligned one.
//  - Each consumer thread owns rows_per_thread rows of the tile (2 for
//    fixed-width tables, two independent chains whose instructions
//    interleave; 1 where a string is staged, whose byte loop diverges) and
//    hashes their fields from the stage, each running hash in a register
//    across the tile's groups and stored once.  Where a column's place in the stage lies (its offsets, with its
//    addresses' offsets in their chunks) is worked out once a block into a
//    table in shared memory (XxMeta), so that a field costs the consumer
//    one table read besides its own loads and arithmetic.  A column the
//    plan does not stage (a string too wide for a stage) is read from
//    device memory inside the same loop.
// Strings are hashed by one routine for both places: a row 16-byte aligned
// reads its 32-byte chunks as two 16-byte loads, any other row 4-byte
// words (its pitch is a multiple of 4 only).  Every global offset is
// 64-bit.

#include <cstdint>

#include "hash_common.cuh"

namespace {

// stages in a block's ring (hash_kernels._XX_STAGES)
constexpr int kXxStages = 3;
// the most consumer threads a block (each hashes 1 or 2 rows of a tile:
// the plan's rows_per_thread)
constexpr int kXxMaxConsumers = 512;
// SrjHashCol::stage: bit 24 where the column starts a group of the plan,
// bits 0-23 its offset in its stage in 16-byte units plus one (0: read from
// device memory)
constexpr int32_t kXxGroupStart = 1 << 24;
constexpr int32_t kXxSlotMask = kXxGroupStart - 1;
// shared memory before the columns' XxMeta: the ring's 2 * kXxStages
// mbarriers
constexpr int kXxBarBytes = 128;
// the most shared memory a block of this card can take (227 KB)
constexpr int kMaxSmemBytes = 232448;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// The hash steps
// ---------------------------------------------------------------------------

// Bytes read from device memory (read-only path) or from shared memory.
struct GlobalBytes {
  static __device__ __forceinline__ uint32_t u32(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint32_t*>(p));
  }
  static __device__ __forceinline__ uint4 u128(const uint8_t* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ uint32_t u8(const uint8_t* p) {
    return __ldg(p);
  }
};

struct SharedBytes {
  static __device__ __forceinline__ uint32_t u32(const uint8_t* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ uint4 u128(const uint8_t* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  static __device__ __forceinline__ uint32_t u8(const uint8_t* p) {
    return *p;
  }
};

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

// The 8-byte block of a fixed-width value of type `type` at p (its own
// alignment), in shared memory: hash_common.cuh's normalisation.
__device__ __forceinline__ uint64_t xx_value_at(const uint8_t* p, int type) {
  uint32_t w;
  switch (type) {
    case kS8:
      w = static_cast<uint32_t>(static_cast<int32_t>(
          *reinterpret_cast<const int8_t*>(p)));
      break;
    case kU8: w = *p; break;
    case kS16:
      w = static_cast<uint32_t>(static_cast<int32_t>(
          *reinterpret_cast<const int16_t*>(p)));
      break;
    case kU16: w = *reinterpret_cast<const uint16_t*>(p); break;
    case kF32: w = srj_canon_f32(*reinterpret_cast<const uint32_t*>(p));
      break;
    case kB64: return *reinterpret_cast<const unsigned long long*>(p);
    case kF64:
      return srj_canon_f64(*reinterpret_cast<const unsigned long long*>(p));
    default: w = *reinterpret_cast<const uint32_t*>(p); break;
  }
  return static_cast<uint64_t>(static_cast<int64_t>(static_cast<int32_t>(w)));
}

// A column's field of `row` read from device memory: the running hash h
// after it.
__device__ __forceinline__ uint64_t xx_field_global(const SrjHashCol& c,
                                                    int64_t row, uint64_t h) {
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

// ---------------------------------------------------------------------------
// The staged block of a column (hash_kernels._xx_regions): regions of
// round16(bytes) + 16 bytes, the part of a tile at its address's offset in
// its first 16-byte chunk.  Fixed width: [values][mask]; string:
// [lengths][chars][mask]; the mask region only where the column has one.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int64_t xx_region(int64_t bytes) {
  return (bytes + 15) / 16 * 16 + 16;
}

__host__ __device__ constexpr int xx_elem_bytes(int type) {
  return type <= kU8 ? 1 : (type <= kU16 ? 2 : (type <= kF32 ? 4 : 8));
}

// Offsets in the block of the mask region and, for a string, of the chars.
__device__ __forceinline__ int64_t xx_chars_off(int rows) {
  return xx_region(4 * static_cast<int64_t>(rows));
}

__device__ __forceinline__ int64_t xx_mask_off(const SrjHashCol& c,
                                               int rows) {
  if (c.type == kString)
    return xx_chars_off(rows) +
           (c.pitch ? xx_region(rows * c.pitch) : int64_t{0});
  return xx_region(static_cast<int64_t>(rows) * xx_elem_bytes(c.type));
}

__device__ __forceinline__ int xx_misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// Shared memory the columns' XxMeta (8 bytes each) take, 16-byte rounded.
__host__ __device__ __forceinline__ int xx_meta_bytes(int ncols) {
  return (8 * ncols + 15) / 16 * 16;
}

// The bytes a copy of len bytes at src moves: its aligned 16-byte chunks.
__device__ __forceinline__ uint32_t xx_chunk_bytes(const void* src,
                                                   int64_t len) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return static_cast<uint32_t>(((a + len + 15) & ~uintptr_t{15}) -
                               (a & ~uintptr_t{15}));
}

// Copies the aligned chunks holding [src, src + len) to dst (16-byte
// aligned) on the mbarrier bar.
__device__ __forceinline__ void xx_copy(uint8_t* dst, const void* src,
                                        int64_t len, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15};
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(a), "r"(xx_chunk_bytes(src, len)), "r"(smem_u32(bar))
      : "memory");
}

// The bytes a staged column's copies of rows [r0, r0 + m) move (kCopy
// false), or those copies started into its block blk (kCopy true).
template <bool kCopy>
__device__ __forceinline__ uint32_t xx_stage_col(const SrjHashCol& c,
                                                 int tile_rows, int64_t r0,
                                                 int m, uint8_t* blk,
                                                 uint64_t* bar) {
  uint32_t bytes = 0;
  auto part = [&](uint8_t* dst, const void* src, int64_t len) {
    if (kCopy) {
      xx_copy(dst, src, len, bar);
    } else {
      bytes += xx_chunk_bytes(src, len);
    }
  };
  if (c.type == kString) {
    part(blk, c.lens + r0, 4 * static_cast<int64_t>(m));
    if (c.pitch)
      part(blk + xx_chars_off(tile_rows),
           static_cast<const uint8_t*>(c.data) + r0 * c.pitch, m * c.pitch);
  } else {
    const int sz = xx_elem_bytes(c.type);
    part(blk, static_cast<const uint8_t*>(c.data) + r0 * sz,
         static_cast<int64_t>(m) * sz);
  }
  if (c.valid != nullptr)
    part(blk + xx_mask_off(c, tile_rows), c.valid + (r0 >> 3), (m + 7) >> 3);
  return bytes;
}

// A column's place in the stages, worked out once a block from its
// descriptor: byte offsets in its group's stage of row 0's value (a
// string: its length), of a string's row 0 chars, and of the tile's first
// mask byte (kXxNoMask: no mask), each at its address's offset in its first
// 16-byte chunk.
struct XxMeta {
  uint16_t values;
  uint16_t chars;
  uint16_t mask;
  uint8_t type;
  uint8_t flags;  // kXxMetaStart, kXxMetaStaged
};
constexpr uint16_t kXxNoMask = 0xFFFF;
constexpr uint8_t kXxMetaStart = 1;
constexpr uint8_t kXxMetaStaged = 2;

__device__ __forceinline__ XxMeta xx_meta(const SrjHashCol& c,
                                          int tile_rows) {
  XxMeta m = {0, 0, kXxNoMask, static_cast<uint8_t>(c.type), 0};
  const int32_t slot = c.stage & kXxSlotMask;
  if (c.stage & kXxGroupStart) m.flags |= kXxMetaStart;
  if (!slot) return m;
  m.flags |= kXxMetaStaged;
  const int base = 16 * (slot - 1);
  if (c.type == kString) {
    m.values = static_cast<uint16_t>(base + xx_misalign(c.lens));
    m.chars = static_cast<uint16_t>(base + xx_chars_off(tile_rows) +
                                    xx_misalign(c.data));
  } else {
    m.values = static_cast<uint16_t>(base + xx_misalign(c.data));
  }
  if (c.valid != nullptr)
    m.mask = static_cast<uint16_t>(base + xx_mask_off(c, tile_rows) +
                                   xx_misalign(c.valid));
  return m;
}

// A staged fixed-width column of type kType (values from v) hashed into
// a consumer's rows: every row's value is read and hashed and a null one's
// hash dropped, so no branch separates the rows' chains.
template <int kRows, int kType>
__device__ __forceinline__ void xx_fixed_rows(const uint8_t* v, const int* ii,
                                              const bool* ok, uint64_t* h) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const uint64_t hc = xx_block(
        h[r], xx_value_at(v + ii[r] * xx_elem_bytes(kType), kType));
    h[r] = ok[r] ? hc : h[r];
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// kChain false: every row starts at seed (a chain's first launch); true:
// each row starts from its value of row_seeds, which may be `out` itself
// (a later launch; a row's seed is read before its hash is written, by the
// same thread).  Threads: one producer warp, then tile_rows / kRows
// consumers, each hashing kRows rows of a tile.  Shared memory: the ring's
// mbarriers, the columns' XxMeta (16-byte rounded), the kXxStages stages.
template <bool kChain, int kRows>
__global__ void __launch_bounds__(kXxMaxConsumers + 32)
xxhash64_staged_kernel(const __grid_constant__ SrjHashCols cols, int64_t n,
                       uint64_t seed, const uint64_t* row_seeds,
                       uint64_t* out, int tile_rows, int stage_bytes) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kXxStages;
  const int ncols = cols.ncols;
  XxMeta* meta = reinterpret_cast<XxMeta*>(smem + kXxBarBytes);
  uint8_t* stages = smem + kXxBarBytes + xx_meta_bytes(ncols);
  const int consumers = tile_rows / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kXxStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + s)),
                   "r"(consumers / 32)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = threadIdx.x; j < ncols; j += blockDim.x)
    meta[j] = xx_meta(cols.col[j], tile_rows);
  __syncthreads();
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  int s = 0;
  uint32_t phase = 0;

  if (warp == 0) {
    // the producer: for each (tile, group), a free stage filled by bulk
    // copies, its mbarrier told the bytes to expect
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t r0 = t * tile_rows;
      const int m = static_cast<int>(n - r0 < tile_rows ? n - r0 : tile_rows);
      for (int g = 0; g < ncols;) {
        int end = g + 1;
        while (end < ncols && !(meta[end].flags & kXxMetaStart)) ++end;
        mbar_wait(empty + s, phase ^ 1);
        uint8_t* stage = stages + static_cast<int64_t>(s) * stage_bytes;
        uint32_t bytes = 0;
        for (int j = g + lane; j < end; j += 32) {
          if (meta[j].flags & kXxMetaStaged)
            bytes += xx_stage_col<false>(cols.col[j], tile_rows, r0, m,
                                         nullptr, nullptr);
        }
        bytes = __reduce_add_sync(0xFFFFFFFFu, bytes);
        if (lane == 0)
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  smem_u32(full + s)),
              "r"(bytes)
              : "memory");
        __syncwarp();
        for (int j = g + lane; j < end; j += 32) {
          const int32_t slot = cols.col[j].stage & kXxSlotMask;
          if (slot)
            xx_stage_col<true>(cols.col[j], tile_rows, r0, m,
                               stage + 16 * (slot - 1), full + s);
        }
        if (++s == kXxStages) {
          s = 0;
          phase ^= 1;
        }
        g = end;
      }
    }
    return;
  }

  // the consumers: rows i + r * consumers (r < kRows) of each tile, one
  // independent hash chain a row, each hash in a register across the
  // tile's groups
  const int i = threadIdx.x - 32;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    int ii[kRows];
    int64_t row[kRows];
    bool live[kRows];
    uint64_t h[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ii[r] = i + r * consumers;
      row[r] = t * tile_rows + ii[r];
      live[r] = row[r] < n;
      h[r] = live[r] ? (kChain ? row_seeds[row[r]] : seed) : 0;
    }
    mbar_wait(full + s, phase);
    const uint8_t* st = stages + static_cast<int64_t>(s) * stage_bytes;
    for (int j = 0; j < ncols; ++j) {
      const XxMeta m = meta[j];
      if (j > 0 && (m.flags & kXxMetaStart)) {
        // the group's stage is read: hand it back, take the next
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (++s == kXxStages) {
          s = 0;
          phase ^= 1;
        }
        mbar_wait(full + s, phase);
        st = stages + static_cast<int64_t>(s) * stage_bytes;
      }
      if (!(m.flags & kXxMetaStaged)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (live[r]) h[r] = xx_field_global(cols.col[j], row[r], h[r]);
        continue;
      }
      bool ok[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ok[r] = live[r] &&
                (m.mask == kXxNoMask ||
                 ((st[m.mask + (ii[r] >> 3)] >> (ii[r] & 7)) & 1u));
      if (m.type == kString) {
        const int64_t pitch = cols.col[j].pitch;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (!ok[r]) continue;
          const int32_t l =
              *reinterpret_cast<const int32_t*>(st + m.values + 4 * ii[r]);
          // clamped to [0, pitch] as srj_string_row clamps it
          const int len =
              static_cast<int>(l < 0 ? 0 : (l > pitch ? pitch : l));
          h[r] = xx_bytes<SharedBytes>(st + m.chars + ii[r] * pitch, len,
                                       h[r]);
        }
      } else {
        const uint8_t* v = st + m.values;
        switch (m.type) {  // the same for every thread: no divergence
          case kS8: xx_fixed_rows<kRows, kS8>(v, ii, ok, h); break;
          case kU8: xx_fixed_rows<kRows, kU8>(v, ii, ok, h); break;
          case kS16: xx_fixed_rows<kRows, kS16>(v, ii, ok, h); break;
          case kU16: xx_fixed_rows<kRows, kU16>(v, ii, ok, h); break;
          case kF32: xx_fixed_rows<kRows, kF32>(v, ii, ok, h); break;
          case kB64: xx_fixed_rows<kRows, kB64>(v, ii, ok, h); break;
          case kF64: xx_fixed_rows<kRows, kF64>(v, ii, ok, h); break;
          default: xx_fixed_rows<kRows, kB32>(v, ii, ok, h); break;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == kXxStages) {
      s = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (live[r]) out[row[r]] = h[r];
  }
}

}  // namespace

// Hashes n rows over the ncols (<= kMaxHashCols) descriptors at `cols`, in
// host memory, into out (int64 bits of uint64 [n]), every row starting at
// seed, or, where row_seeds is not null, at its own value of row_seeds (the
// output of the chain's previous launch; it may be out).  The descriptors
// carry hash_kernels._xx_stage_plan's groups and offsets (SrjHashCol::
// stage); tile_rows (a multiple of 128), rows_per_thread (1 or 2, at most
// kXxMaxConsumers consumers) and stage_bytes (a multiple of 16) are the
// plan's.  Launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_xxhash64_cols(const SrjHashCol* cols, int ncols,
                                 int64_t n, uint64_t seed,
                                 const void* row_seeds, void* out,
                                 int tile_rows, int rows_per_thread,
                                 int stage_bytes, int device, void* stream) {
  const int smem =
      kXxBarBytes + xx_meta_bytes(ncols) + kXxStages * stage_bytes;
  // XxMeta's 16-bit offsets: a stage under 64 KiB
  if (ncols < 1 || ncols > kMaxHashCols || tile_rows < 128 ||
      tile_rows % 128 || (rows_per_thread != 1 && rows_per_thread != 2) ||
      tile_rows / rows_per_thread > kXxMaxConsumers || stage_bytes < 0 ||
      stage_bytes % 16 || stage_bytes >= 65536 || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SrjHashCols params;
  for (int i = 0; i < ncols; ++i) params.col[i] = cols[i];
  params.ncols = ncols;
  auto kernel = row_seeds == nullptr
                    ? (rows_per_thread == 1 ? xxhash64_staged_kernel<false, 1>
                                            : xxhash64_staged_kernel<false, 2>)
                    : (rows_per_thread == 1 ? xxhash64_staged_kernel<true, 1>
                                            : xxhash64_staged_kernel<true, 2>);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = tile_rows / rows_per_thread + 32;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const auto blocks = static_cast<unsigned>(tiles < resident ? tiles
                                                             : resident);
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      params, n, seed, static_cast<const uint64_t*>(row_seeds),
      static_cast<uint64_t*>(out), tile_rows, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}
