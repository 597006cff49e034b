// The staging layer of the column-chained hash kernels, K6 (murmur3.cu) and
// K7 (xxhash64.cu): persistent blocks that stage tiles of rows in a ring of
// shared-memory stages and hash them there.  The kernel is a template on a
// hash policy P, which gives:
//  - State: the running hash a row carries through the chain, and the
//    output word (uint32_t for murmur3, uint64_t for xxhash64);
//  - fixed<kType>(h, p): h after a fixed-width value of type kType at p, in
//    shared memory (hash_common.cuh's normalisation);
//  - string<L>(p, len, pitch, h): h after the len bytes at p (4-byte
//    aligned) of a string row of `pitch` bytes, read through L
//    (GlobalBytes or SharedBytes);
//  - field_global(c, row, h): h after column c's field of `row`, read from
//    device memory (a null field leaves h as it is);
//  - kOneRowBlocks: the blocks of one row a thread that an SM should hold
//    (1: no bound on a block's registers).
//
// Why stage: the bytes must stream, so each SM needs many of them in
// flight, whereas one thread a row walking its columns holds one column's
// loads in flight at a time (each field's hash waits on the last).  So, as
// the TPU kernels read a [K, tile] block at once:
//  - Persistent blocks of one producer warp and tile_rows / (32 x kRows)
//    consumer warps walk the row tiles (tile_rows rows each, a multiple of
//    128).
//  - The columns form groups in chain order, each small enough for one
//    stage; the plan (hash_kernels._stage_plan, in Python) gives each
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
//  - Each consumer thread owns kRows rows of the tile and hashes their
//    fields from the stage, each running hash in a register across the
//    tile's groups and stored once.  Where a column's place in the stage
//    lies is worked out once a block into a table in shared memory
//    (StageMeta), so that a field costs the consumer one table read besides
//    its own loads and arithmetic.  A column the plan does not stage (a
//    string too wide for a stage, or any string of K6, whose plan reads
//    strings in place: PERF.md) is read from device memory inside the same
//    loop.
// Every global offset is 64-bit.
#pragma once

#include <cstdint>

#include "bulk_copy.cuh"
#include "hash_common.cuh"

namespace {

// stages in a block's ring (hash_kernels._STAGES)
constexpr int kStages = 3;
// the most consumer threads a block (each hashes 1 or 2 rows of a tile:
// the plan's rows_per_thread)
constexpr int kStageMaxConsumers = 512;
// A policy whose kOneRowBlocks is over 1 has its one-row-a-thread blocks
// take at most kStageOneRowConsumers consumers and launch as
// srj_staged_hash_one_row, bounded so that kOneRowBlocks of them fit an
// SM's registers: a string walk read in place waits on its loads and its
// chain, and more threads hide that.
constexpr int kStageOneRowConsumers = 256;

template <class P, int kRows>
constexpr bool stage_bounded() {
  return kRows == 1 && P::kOneRowBlocks > 1;
}

// SrjHashCol::stage (hash_kernels._GROUP_START): bit 24 where the column
// starts a group of the plan, bits 0-23 its offset in its stage in 16-byte
// units plus one (0: read from device memory)
constexpr int32_t kStageGroupStart = 1 << 24;
constexpr int32_t kStageSlotMask = kStageGroupStart - 1;
// shared memory before the columns' StageMeta: the ring's 2 * kStages
// mbarriers
constexpr int kStageBarBytes = 128;
// ---------------------------------------------------------------------------
// Reading bytes from device memory (read-only path) or from shared memory
// ---------------------------------------------------------------------------

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

// The 32-bit word of a value of 4 bytes or fewer (types kS8..kF32) at p,
// and the 64-bit value of an 8-byte one (kB64, kF64), each at its own
// alignment in shared memory: hash_common.cuh's normalisation.
__device__ __forceinline__ uint32_t stage_word32_at(const uint8_t* p,
                                                    int type) {
  switch (type) {
    case kS8:
      return static_cast<uint32_t>(
          static_cast<int32_t>(*reinterpret_cast<const int8_t*>(p)));
    case kU8: return *p;
    case kS16:
      return static_cast<uint32_t>(
          static_cast<int32_t>(*reinterpret_cast<const int16_t*>(p)));
    case kU16: return *reinterpret_cast<const uint16_t*>(p);
    case kF32: return srj_canon_f32(*reinterpret_cast<const uint32_t*>(p));
    default: return *reinterpret_cast<const uint32_t*>(p);
  }
}

__device__ __forceinline__ uint64_t stage_word64_at(const uint8_t* p,
                                                    int type) {
  const uint64_t v = *reinterpret_cast<const unsigned long long*>(p);
  return type == kF64 ? srj_canon_f64(v) : v;
}

// ---------------------------------------------------------------------------
// The staged block of a column (hash_kernels._stage_regions): regions of
// round16(bytes) + 16 bytes, the part of a tile at its address's offset in
// its first 16-byte chunk.  Fixed width: [values][mask]; string:
// [lengths][chars][mask], the chars tile_rows x pitch, none at a zero
// pitch; the mask region only where the column has one.
// ---------------------------------------------------------------------------

__device__ __forceinline__ int64_t stage_region(int64_t bytes) {
  return (bytes + 15) / 16 * 16 + 16;
}

__host__ __device__ constexpr int stage_elem_bytes(int type) {
  return type <= kU8 ? 1 : (type <= kU16 ? 2 : (type <= kF32 ? 4 : 8));
}

__device__ __forceinline__ int64_t stage_chars_off(int rows) {
  return stage_region(4 * static_cast<int64_t>(rows));
}

__device__ __forceinline__ int64_t stage_mask_off(const SrjHashCol& c,
                                                  int rows) {
  if (c.type == kString)
    return stage_chars_off(rows) +
           (c.pitch ? stage_region(rows * c.pitch) : int64_t{0});
  return stage_region(static_cast<int64_t>(rows) *
                      stage_elem_bytes(c.type));
}

// Shared memory the columns' StageMeta (8 bytes each) take, 16-byte rounded.
__host__ __device__ __forceinline__ int stage_meta_bytes(int ncols) {
  return (8 * ncols + 15) / 16 * 16;
}

// The bytes the producer's copies of a staged column's rows [r0, r0 + m)
// move (kCopy false), or those copies started into its block blk (kCopy
// true).
template <bool kCopy>
__device__ __forceinline__ uint32_t stage_col(const SrjHashCol& c,
                                              int tile_rows, int64_t r0,
                                              int m, uint8_t* blk,
                                              uint64_t* bar) {
  uint32_t bytes = 0;
  auto part = [&](uint8_t* dst, const void* src, int64_t len) {
    if (kCopy) {
      stage_copy(dst, src, len, bar);
    } else {
      bytes += stage_chunk_bytes(src, len);
    }
  };
  if (c.type == kString) {
    part(blk, c.lens + r0, 4 * static_cast<int64_t>(m));
    if (c.pitch)
      part(blk + stage_chars_off(tile_rows),
           static_cast<const uint8_t*>(c.data) + r0 * c.pitch, m * c.pitch);
  } else {
    const int sz = stage_elem_bytes(c.type);
    part(blk, static_cast<const uint8_t*>(c.data) + r0 * sz,
         static_cast<int64_t>(m) * sz);
  }
  if (c.valid != nullptr)
    part(blk + stage_mask_off(c, tile_rows), c.valid + (r0 >> 3),
         (m + 7) >> 3);
  return bytes;
}

// A column's place in the stages, worked out once a block from its
// descriptor: byte offsets in its group's stage of row 0's value (a
// string: its length), of a string's row 0 chars, and of the tile's first
// mask byte (kStageNoMask: no mask), each at its address's offset in its
// first 16-byte chunk.
struct StageMeta {
  uint16_t values;
  uint16_t chars;
  uint16_t mask;
  uint8_t type;
  uint8_t flags;  // kMetaStart, kMetaStaged
};
constexpr uint16_t kStageNoMask = 0xFFFF;
constexpr uint8_t kMetaStart = 1;
constexpr uint8_t kMetaStaged = 2;

__device__ __forceinline__ StageMeta stage_meta(const SrjHashCol& c,
                                                int tile_rows) {
  StageMeta m = {0, 0, kStageNoMask, static_cast<uint8_t>(c.type), 0};
  const int32_t slot = c.stage & kStageSlotMask;
  if (c.stage & kStageGroupStart) m.flags |= kMetaStart;
  if (!slot) return m;
  m.flags |= kMetaStaged;
  const int base = 16 * (slot - 1);
  if (c.type == kString) {
    m.values = static_cast<uint16_t>(base + stage_misalign(c.lens));
    m.chars = static_cast<uint16_t>(base + stage_chars_off(tile_rows) +
                                    stage_misalign(c.data));
  } else {
    m.values = static_cast<uint16_t>(base + stage_misalign(c.data));
  }
  if (c.valid != nullptr)
    m.mask = static_cast<uint16_t>(base + stage_mask_off(c, tile_rows) +
                                   stage_misalign(c.valid));
  return m;
}

// A staged fixed-width column of type kType (values from v) hashed into a
// consumer's rows: every row's value is read and hashed and a null one's
// hash dropped, so no branch separates the rows' chains.
template <class P, int kRows, int kType>
__device__ __forceinline__ void stage_fixed_rows(const uint8_t* v,
                                                 const int* ii, const bool* ok,
                                                 typename P::State* h) {
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const typename P::State hc = P::template fixed<kType>(
        h[r], v + ii[r] * stage_elem_bytes(kType));
    h[r] = ok[r] ? hc : h[r];
  }
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The kernels' body.  kChain false: every row starts at seed (a chain's
// first launch); true: each row starts from its value of row_seeds, which
// may be `out` itself (a later launch; a row's seed is read before its hash
// is written, by the same thread).  Threads: one producer warp, then
// tile_rows / kRows consumers, each hashing kRows rows of a tile.  Shared
// memory: the ring's mbarriers, the columns' StageMeta (16-byte rounded),
// the kStages stages.
template <class P, bool kChain, int kRows>
__device__ __forceinline__ void stage_hash_tiles(
    const SrjHashCols& cols, int64_t n, typename P::State seed,
    const typename P::State* row_seeds, typename P::State* out,
    int tile_rows, int stage_bytes) {
  using State = typename P::State;
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  const int ncols = cols.ncols;
  StageMeta* meta = reinterpret_cast<StageMeta*>(smem + kStageBarBytes);
  uint8_t* stages = smem + kStageBarBytes + stage_meta_bytes(ncols);
  const int consumers = tile_rows / kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
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
    meta[j] = stage_meta(cols.col[j], tile_rows);
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
        while (end < ncols && !(meta[end].flags & kMetaStart)) ++end;
        mbar_wait(empty + s, phase ^ 1);
        uint8_t* stage = stages + static_cast<int64_t>(s) * stage_bytes;
        uint32_t bytes = 0;
        for (int j = g + lane; j < end; j += 32) {
          if (meta[j].flags & kMetaStaged)
            bytes += stage_col<false>(cols.col[j], tile_rows, r0, m, nullptr,
                                      nullptr);
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
          const int32_t slot = cols.col[j].stage & kStageSlotMask;
          if (slot)
            stage_col<true>(cols.col[j], tile_rows, r0, m,
                            stage + 16 * (slot - 1), full + s);
        }
        if (++s == kStages) {
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
    State h[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ii[r] = i + r * consumers;
      row[r] = t * tile_rows + ii[r];
      live[r] = row[r] < n;
      h[r] = live[r] ? (kChain ? row_seeds[row[r]] : seed) : State{0};
    }
    mbar_wait(full + s, phase);
    const uint8_t* st = stages + static_cast<int64_t>(s) * stage_bytes;
    for (int j = 0; j < ncols; ++j) {
      const StageMeta m = meta[j];
      if (j > 0 && (m.flags & kMetaStart)) {
        // the group's stage is read: hand it back, take the next
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
        if (++s == kStages) {
          s = 0;
          phase ^= 1;
        }
        mbar_wait(full + s, phase);
        st = stages + static_cast<int64_t>(s) * stage_bytes;
      }
      if (!(m.flags & kMetaStaged)) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (live[r]) h[r] = P::field_global(cols.col[j], row[r], h[r]);
        continue;
      }
      bool ok[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        ok[r] = live[r] &&
                (m.mask == kStageNoMask ||
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
          h[r] = P::template string<SharedBytes>(st + m.chars + ii[r] * pitch,
                                                 len, pitch, h[r]);
        }
      } else {
        const uint8_t* v = st + m.values;
        switch (m.type) {  // the same for every thread: no divergence
          case kS8: stage_fixed_rows<P, kRows, kS8>(v, ii, ok, h); break;
          case kU8: stage_fixed_rows<P, kRows, kU8>(v, ii, ok, h); break;
          case kS16: stage_fixed_rows<P, kRows, kS16>(v, ii, ok, h); break;
          case kU16: stage_fixed_rows<P, kRows, kU16>(v, ii, ok, h); break;
          case kF32: stage_fixed_rows<P, kRows, kF32>(v, ii, ok, h); break;
          case kB64: stage_fixed_rows<P, kRows, kB64>(v, ii, ok, h); break;
          case kF64: stage_fixed_rows<P, kRows, kF64>(v, ii, ok, h); break;
          default: stage_fixed_rows<P, kRows, kB32>(v, ii, ok, h); break;
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (live[r]) out[row[r]] = h[r];
  }
}

// The kernel, and the one of one row a thread for a policy whose
// kOneRowBlocks is over 1.
template <class P, bool kChain, int kRows>
__global__ void __launch_bounds__(kStageMaxConsumers + 32)
srj_staged_hash_kernel(const __grid_constant__ SrjHashCols cols, int64_t n,
                       typename P::State seed,
                       const typename P::State* row_seeds,
                       typename P::State* out, int tile_rows,
                       int stage_bytes) {
  stage_hash_tiles<P, kChain, kRows>(cols, n, seed, row_seeds, out,
                                     tile_rows, stage_bytes);
}

template <class P, bool kChain>
__global__ void __launch_bounds__(kStageOneRowConsumers + 32,
                                  P::kOneRowBlocks)
srj_staged_hash_one_row(const __grid_constant__ SrjHashCols cols, int64_t n,
                        typename P::State seed,
                        const typename P::State* row_seeds,
                        typename P::State* out, int tile_rows,
                        int stage_bytes) {
  stage_hash_tiles<P, kChain, 1>(cols, n, seed, row_seeds, out, tile_rows,
                                 stage_bytes);
}

// A hash kernel's C entry point: hashes n rows over the ncols (<=
// kMaxHashCols) descriptors at `cols`, in host memory, into out (P::State
// [n]), every row starting at seed, or, where row_seeds is not null, at its
// own value of row_seeds (the output of the chain's previous launch; it may
// be out).  The descriptors carry hash_kernels._stage_plan's groups and
// offsets (SrjHashCol::stage); tile_rows (a multiple of 128),
// rows_per_thread (1 or 2, at most stage_max_threads - 32 consumers) and
// stage_bytes (a multiple of 16) are the plan's.  Launches on stream, of
// card `device`, and returns the launch's cudaError_t.
template <class P>
int srj_staged_hash_launch(const SrjHashCol* cols, int ncols, int64_t n,
                           typename P::State seed, const void* row_seeds,
                           void* out, int tile_rows, int rows_per_thread,
                           int stage_bytes, int device, void* stream) {
  const int smem =
      kStageBarBytes + stage_meta_bytes(ncols) + kStages * stage_bytes;
  // StageMeta's 16-bit offsets: a stage under 64 KiB
  const int threads = tile_rows / rows_per_thread + 32;
  const bool bounded = rows_per_thread == 1 && stage_bounded<P, 1>();
  if (ncols < 1 || ncols > kMaxHashCols || tile_rows < 128 ||
      tile_rows % 128 || (rows_per_thread != 1 && rows_per_thread != 2) ||
      threads > (bounded ? kStageOneRowConsumers : kStageMaxConsumers) + 32 ||
      stage_bytes < 0 || stage_bytes % 16 || stage_bytes >= 65536 ||
      smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  SrjHashCols params;
  for (int i = 0; i < ncols; ++i) params.col[i] = cols[i];
  params.ncols = ncols;
  const bool chain = row_seeds != nullptr;
  auto kernel = chain ? (rows_per_thread == 1
                             ? srj_staged_hash_kernel<P, true, 1>
                             : srj_staged_hash_kernel<P, true, 2>)
                      : (rows_per_thread == 1
                             ? srj_staged_hash_kernel<P, false, 1>
                             : srj_staged_hash_kernel<P, false, 2>);
  if constexpr (stage_bounded<P, 1>()) {
    if (bounded)
      kernel = chain ? srj_staged_hash_one_row<P, true>
                     : srj_staged_hash_one_row<P, false>;
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
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
      params, n, seed, static_cast<const typename P::State*>(row_seeds),
      static_cast<typename P::State*>(out), tile_rows, stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
