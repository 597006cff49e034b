// string_gather: every string column's chars out of a batch of compact JCUDF
// rows, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package gathers these chars in XLA
// (spark_rapids_jni_tpu/ops/row_conversion.py::_gather_one_string, one gather
// per column with an index per char).  In PyTorch that gather needs an int64
// index per char moved; this kernel moves each char once instead, all
// string columns in one launch.
//
// Inputs: the blob (uint8, flat), its row offsets int32 [n + 1], and per
// string column the rows' offsets in their rows (int32 [n], the decoded
// pair plane) and the output offsets int32 [n + 1] (the lengths' exclusive
// sum: row r's length is out_off[r + 1] - out_off[r]).  Output: per column
// uint8 [total] (16-byte aligned): row r's chars at out_off[r].
//
// Bound: memory.  The kernel must read the rows' offsets, each column's pair
// and output offsets (8 bytes a row a column) and every char once, and
// write every char once.
//
// Design: a tile of R rows reads contiguous ranges (each column's R pair
// offsets and R + 1 output offsets, the rows' R + 1 offsets, and each row's
// span of the blob) and writes one contiguous range of each column's
// output.  So persistent blocks walk the tiles through a ring of
// shared-memory stages (ragged_copy.cuh's GatherSlot,
// kernels.string_gather_plan sizes them):
//  - The producer warp bulk-copies the tile's pairs, output offsets and
//    row offsets into a free stage (stage A, on one mbarrier), two tiles
//    ahead of its chars (stage B): once the consumer warps have written
//    each row's span (from its least string offset to its greatest string
//    end), it places the spans' aligned 16-byte chunks back to back and
//    bulk-copies them on a second mbarrier (the spans skip the rows' fixed
//    sections, which staging the tile's rows whole would read too, for
//    more time), and places each column's part of the tile's output in
//    the block's image.  A tile whose chars or output pass their rooms
//    is flagged instead and takes the long-row route (and, where the
//    caller asks, marked in long_tiles).  Each row's chunk bytes and each
//    column's part are capped 16 bytes past their room before they are
//    summed: a capped one sends the tile long, and 128 stay far inside
//    int.
//  - The consumer warps work out the next tile's spans (a warp a row, a
//    lane a column, the warp's min and max: the producer's one warp took
//    longer), then copy this tile's strings into the image, a warp a row
//    and a lane a column, so that the lanes read one row's neighbouring
//    strings; after a barrier of the consumers they store the image as
//    16-byte words, coalesced, each thread taking words of every column's
//    part in turn so that no warp waits on another's longer column (bytes
//    only in the word at a part's head and tail, which it shares with the
//    neighbouring tiles').
//  - Long-row route: a warp a row, a lane a column reading its staged pair
//    at once, the chars copied from device memory, the strings of at most 32
//    bytes eight at a time, lane b taking byte b of each, and each longer
//    one by the whole warp (srj::row_copy_pieces).
// The caller checks every pair against its row and the blob before the
// launch (convert_from_rows does, with one reduction): an address outside
// the blob would fault, and a fault on the card is sticky.  Every global
// offset is 64-bit.

#include <climits>
#include <cstdint>

#include "bulk_copy.cuh"
#include "launch.cuh"
#include "ragged_copy.cuh"

struct SrjGatherStr {
  const int32_t* str_off;  // each row's char start, from the row's start [n]
  const int32_t* out_off;  // each row's place in out [n + 1]
  uint8_t* out;            // the column's chars
};

struct SrjGatherCols {
  SrjGatherStr col[srj::kMaxStrCols];
  int32_t ncols;
};

namespace {

constexpr int kMaxThreads = 32 * (srj::kTileMaxWarps + 1);
constexpr int kColsPerLane = srj::kMaxStrCols / 32;
constexpr int kRowsPerLane = srj::kTileMaxRows / 32;

struct GatherArgs {
  const uint8_t* blob;
  const int32_t* row_offsets;
  int64_t n;
  int tile_rows, stages, chars_bytes, image_bytes;
  uint8_t* long_tiles;  // null, or [tiles]: 1 where a tile went long
};

// A consumer warp's rows of a staged tile: each row's span over the
// columns with chars, from its least string offset (x) and of y bytes up to
// its greatest string end (0: no chars), into the stage's span records, a
// lane a column and the warp's min and max.
__device__ __forceinline__ void span_rows(const uint8_t* slot,
                                          const int2* meta, int ncols, int m,
                                          int cw, int cwarps, int2* rec,
                                          int lane) {
  for (int i = cw; i < m; i += cwarps) {
    int lo = INT_MAX, hi = 0;
    for (int cb = 0; cb < ncols; cb += 32) {
      const int c = cb + lane;
      if (c < ncols) {
        const int2 mt = meta[c];
        const int32_t* oo = reinterpret_cast<const int32_t*>(slot + mt.y);
        const int32_t len = oo[i + 1] - oo[i];
        const int32_t o = reinterpret_cast<const int32_t*>(slot + mt.x)[i];
        if (len > 0) {
          lo = min(lo, o);
          hi = max(hi, o + len);
        }
      }
    }
    lo = __reduce_min_sync(0xFFFFFFFFu, lo);
    hi = __reduce_max_sync(0xFFFFFFFFu, hi);
    if (lane == 0) rec[i] = hi > lo ? make_int2(lo, hi - lo) : make_int2(0, 0);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
string_gather_kernel(const __grid_constant__ SrjGatherCols cols,
                     const GatherArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  // per stage: its chars are in (full), its pairs are in (pairs), the
  // consumers have written its rows' spans (spans), they are done with it
  // (empty)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* pairs = full + srj::kTileMaxStages;
  uint64_t* spans = pairs + srj::kTileMaxStages;
  uint64_t* empty = spans + srj::kTileMaxStages;
  uint8_t* slots = smem + srj::kTileBarBytes;
  const int ncols = cols.ncols;
  const int R = a.tile_rows;
  const srj::GatherSlot L = srj::gather_slot(R, ncols, a.chars_bytes);
  // the block's image of a tile's output, after the stages
  uint8_t* image = slots + static_cast<int64_t>(a.stages) * L.bytes;
  const int cwarps = static_cast<int>(blockDim.x >> 5) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(pairs + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(spans + s)),
                   "r"(cwarps)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + s)),
                   "r"(cwarps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the block's k-th tile, its stage and the parity of the stage's use
  const int64_t tiles = (a.n + R - 1) / R;
  const int64_t mine =
      tiles > blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto tile_of = [&](int64_t k) { return blockIdx.x + k * gridDim.x; };
  auto rows_of = [&](int64_t k) {
    return static_cast<int>(min(static_cast<int64_t>(R),
                                a.n - tile_of(k) * R));
  };
  auto stage_of = [&](int64_t k) { return static_cast<int>(k % a.stages); };
  auto parity_of = [&](int64_t k) {
    return static_cast<uint32_t>((k / a.stages) & 1);
  };
  auto slot_of = [&](int64_t k) {
    return slots + static_cast<int64_t>(stage_of(k)) * L.bytes;
  };

  if (warp == 0) {
    // the producer
    auto stage_a = [&](int64_t k) {
      const int64_t r0 = tile_of(k) * R;
      const int m = rows_of(k);
      const int s = stage_of(k);
      mbar_wait(empty + s, parity_of(k) ^ 1);
      uint8_t* slot = slot_of(k);
      int2* meta = reinterpret_cast<int2*>(slot + srj::kSlotHeader);
      const int32_t* rsrc = a.row_offsets + r0;
      // the copies' bytes, which the mbarrier is told to expect
      uint32_t bytes = 0;
      if (lane == 0) {
        reinterpret_cast<int32_t*>(slot)[srj::kHdrRows] =
            L.rows + stage_misalign(rsrc);
        bytes = stage_chunk_bytes(rsrc, 4 * (m + 1));
      }
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < ncols) {
          const int base = L.cols + c * L.col_bytes;
          const int32_t* osrc = cols.col[c].str_off + r0;
          const int32_t* qsrc = cols.col[c].out_off + r0;
          meta[c] = make_int2(base + stage_misalign(osrc),
                              base + srj::stage_room(4 * R) +
                                  stage_misalign(qsrc));
          bytes += stage_chunk_bytes(osrc, 4 * m) +
                   stage_chunk_bytes(qsrc, 4 * (m + 1));
        }
      }
      bytes = __reduce_add_sync(0xFFFFFFFFu, bytes);
      __syncwarp();
      if (lane == 0)
        asm volatile(
            "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                smem_u32(pairs + s)),
            "r"(bytes)
            : "memory");
      __syncwarp();
      if (lane == 0) stage_copy(slot + L.rows, rsrc, 4 * (m + 1), pairs + s);
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        if (c < ncols) {
          const int base = L.cols + c * L.col_bytes;
          stage_copy(slot + base, cols.col[c].str_off + r0, 4 * m, pairs + s);
          stage_copy(slot + base + srj::stage_room(4 * R),
                     cols.col[c].out_off + r0, 4 * (m + 1), pairs + s);
        }
      }
    };
    auto stage_b = [&](int64_t k) {
      const int m = rows_of(k);
      const int s = stage_of(k);
      mbar_wait(spans + s, parity_of(k));
      uint8_t* slot = slot_of(k);
      int32_t* hdr = reinterpret_cast<int32_t*>(slot);
      const int2* meta = reinterpret_cast<const int2*>(slot + srj::kSlotHeader);
      const int2* rec = reinterpret_cast<const int2*>(slot + L.spans);
      int32_t* bases = reinterpret_cast<int32_t*>(slot + L.bases);
      int32_t* places = reinterpret_cast<int32_t*>(slot + L.places);
      const int32_t* ro =
          reinterpret_cast<const int32_t*>(slot + hdr[srj::kHdrRows]);
      // each of the lane's rows: its span [lo, lo + span) in the row, the
      // bytes of the span's chunks and their place in the stage
      int lo[kRowsPerLane], span[kRowsPerLane], pos[kRowsPerLane];
      const uint32_t cap = a.chars_bytes + 16u;
      int carry = 0;
#pragma unroll
      for (int j = 0; j < kRowsPerLane; ++j) {
        const int i = lane + 32 * j;
        lo[j] = 0;
        span[j] = 0;
        if (i < m) {
          const int2 r = rec[i];
          lo[j] = r.x;
          span[j] = r.y;
        }
        const int b = span[j] > 0
                          ? static_cast<int>(min(
                                stage_chunk_bytes(a.blob + ro[i] + lo[j],
                                                  span[j]),
                                cap))
                          : 0;
        const int incl = srj::warp_scan(b, lane);
        pos[j] = carry + incl - b;
        carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      // each column's part of the tile's output in the image, at its
      // address's offset in its first 16-byte word
      int place[kColsPerLane];
      int room = 0;
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) {
        const int c = lane + 32 * j;
        int b = 0, mis = 0;
        if (c < ncols) {
          const int32_t* oo =
              reinterpret_cast<const int32_t*>(slot + meta[c].y);
          mis = stage_misalign(cols.col[c].out + oo[0]);
          const int64_t part = mis + static_cast<int64_t>(oo[m] - oo[0]);
          b = oo[m] > oo[0]
                  ? static_cast<int>(min((part + 15) & ~int64_t{15},
                                         a.image_bytes + int64_t{16}))
                  : 0;
        }
        const int incl = srj::warp_scan(b, lane);
        place[j] = room + incl - b + mis;
        room += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      const bool fits = carry <= a.chars_bytes && room <= a.image_bytes;
      if (fits) {
#pragma unroll
        for (int j = 0; j < kColsPerLane; ++j)
          if (lane + 32 * j < ncols) places[lane + 32 * j] = place[j];
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const int i = lane + 32 * j;
          if (span[j] > 0)
            bases[i] = L.chars + pos[j] +
                       stage_misalign(a.blob + ro[i] + lo[j]) - lo[j];
        }
      }
      __syncwarp();
      if (lane == 0) {
        hdr[srj::kHdrLong] = !fits;
        hdr[srj::kHdrImage] = room;
        if (!fits && a.long_tiles) a.long_tiles[tile_of(k)] = 1;
        if (fits) {
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  smem_u32(full + s)),
              "r"(static_cast<uint32_t>(carry))
              : "memory");
        } else {
          mbar_arrive(full + s);
        }
      }
      __syncwarp();
      if (fits) {
#pragma unroll
        for (int j = 0; j < kRowsPerLane; ++j) {
          const int i = lane + 32 * j;
          if (span[j] > 0)
            stage_copy(slot + L.chars + pos[j], a.blob + ro[i] + lo[j],
                       span[j], full + s);
        }
      }
    };
    for (int64_t k = 0; k < 2 && k < mine; ++k) stage_a(k);
    for (int64_t k = 0; k < mine; ++k) {
      stage_b(k);
      if (k + 2 < mine) stage_a(k + 2);
    }
    return;
  }

  // the consumers: the spans of the next tile, then this tile's strings
  const int cw = warp - 1;
  const int ct = threadIdx.x - 32, cthreads = 32 * cwarps;
  auto next_spans = [&](int64_t k) {
    const int s = stage_of(k);
    mbar_wait(pairs + s, parity_of(k));
    uint8_t* slot = slot_of(k);
    span_rows(slot, reinterpret_cast<const int2*>(slot + srj::kSlotHeader),
              ncols, rows_of(k), cw, cwarps,
              reinterpret_cast<int2*>(slot + L.spans), lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(spans + s);
  };
  if (mine > 0) next_spans(0);
  for (int64_t k = 0; k < mine; ++k) {
    if (k + 1 < mine) next_spans(k + 1);
    const int m = rows_of(k);
    const int s = stage_of(k);
    mbar_wait(full + s, parity_of(k));
    const uint8_t* slot = slot_of(k);
    const int32_t* hdr = reinterpret_cast<const int32_t*>(slot);
    const int2* meta = reinterpret_cast<const int2*>(slot + srj::kSlotHeader);
    if (hdr[srj::kHdrLong]) {
      const int32_t* ro =
          reinterpret_cast<const int32_t*>(slot + hdr[srj::kHdrRows]);
      for (int i = cw; i < m; i += cwarps) {
        const uint8_t* row = a.blob + ro[i];
        for (int cb = 0; cb < ncols; cb += 32) {
          const int c = cb + lane;
          uint8_t* dst = nullptr;
          const uint8_t* src = nullptr;
          int len = 0;
          if (c < ncols) {
            const int2 mt = meta[c];
            const int32_t* oo = reinterpret_cast<const int32_t*>(slot + mt.y);
            len = oo[i + 1] - oo[i];
            src = row + reinterpret_cast<const int32_t*>(slot + mt.x)[i];
            dst = cols.col[c].out + oo[i];
          }
          srj::row_copy_pieces(dst, src, len, lane);
        }
      }
    } else {
      const int32_t* bases = reinterpret_cast<const int32_t*>(slot + L.bases);
      const int32_t* places =
          reinterpret_cast<const int32_t*>(slot + L.places);
      // the tile's strings into the image, a warp a row, a lane a column
      for (int i = cw; i < m; i += cwarps) {
        const int32_t base = bases[i];
        for (int cb = 0; cb < ncols; cb += 32) {
          const int c = cb + lane;
          if (c < ncols) {
            const int2 mt = meta[c];
            const int32_t* oo = reinterpret_cast<const int32_t*>(slot + mt.y);
            const int32_t o0 = oo[i], len = oo[i + 1] - o0;
            if (len > 0)
              srj::lane_copy(image + places[c] + (o0 - oo[0]),
                        slot + base +
                            reinterpret_cast<const int32_t*>(slot + mt.x)[i],
                        len);
          }
        }
      }
      asm volatile("bar.sync 1, %0;\n" ::"r"(cthreads) : "memory");
      // the image to the columns' outputs as 16-byte words, the consumers'
      // threads taking the words of every part in turn: word w belongs to
      // the last column whose part starts at or before it (places less
      // their offsets in a 16-byte word, nondecreasing)
      const int words = hdr[srj::kHdrImage] >> 4;
      for (int w = ct; w < words; w += cthreads) {
        int c = 0, top = ncols;
        while (top - c > 1) {
          const int mid = (c + top) >> 1;
          if ((places[mid] & ~15) <= 16 * w) {
            c = mid;
          } else {
            top = mid;
          }
        }
        const int32_t* oo =
            reinterpret_cast<const int32_t*>(slot + meta[c].y);
        const uintptr_t from =
            reinterpret_cast<uintptr_t>(cols.col[c].out + oo[0]);
        const uintptr_t to = from + (oo[m] - oo[0]);
        const uintptr_t wa =
            (from & ~uintptr_t{15}) + (16 * w - (places[c] & ~15));
        uint8_t* dst = reinterpret_cast<uint8_t*>(wa);
        const uint8_t* src = image + 16 * w;
        if (wa >= from && wa + 16 <= to) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          const int lo = static_cast<int>((wa < from ? from : wa) - wa);
          const int hi = static_cast<int>((wa + 16 > to ? to : wa + 16) - wa);
          for (int b = lo; b < hi; ++b) dst[b] = src[b];
        }
      }
      // the image is read: the next tile may write it
      asm volatile("bar.sync 1, %0;\n" ::"r"(cthreads) : "memory");
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }
}

}  // namespace

// Gathers the chars of n rows of blob (row offsets int32 [n + 1]) for each
// column of cols (each output 16-byte aligned), by the tile plan of
// kernels.string_gather_plan: tiles of tile_rows rows, consumer_warps
// consumer warps a block, a ring of `stages` stages, each with room for
// chars_bytes of chars, and an image of image_bytes (both multiples of 16).
// Where long_tiles (uint8 [tiles], zeros) is given, the tiles that take the
// long-row route are set to 1 in it.  Launches on stream, of card `device`,
// and returns the launch's cudaError_t.
extern "C" int srj_string_gather(const void* cols, const void* blob,
                                 const void* row_offsets, int64_t n,
                                 int tile_rows, int consumer_warps,
                                 int stages, int chars_bytes, int image_bytes,
                                 void* long_tiles, int device, void* stream) {
  const SrjGatherCols* c = static_cast<const SrjGatherCols*>(cols);
  const srj::GatherSlot L = srj::gather_slot(tile_rows, c->ncols,
                                             chars_bytes);
  const int64_t smem = srj::kTileBarBytes +
                       static_cast<int64_t>(stages) * L.bytes + image_bytes;
  bool aligned = true;
  for (int i = 0; i < c->ncols; ++i)
    aligned &= reinterpret_cast<uintptr_t>(c->col[i].out) % 16 == 0;
  if (tile_rows < 1 || tile_rows > srj::kTileMaxRows || consumer_warps < 1 ||
      consumer_warps > srj::kTileMaxWarps || stages < 2 ||
      stages > srj::kTileMaxStages || chars_bytes < 0 || chars_bytes % 16 ||
      image_bytes < 0 || image_bytes % 16 || !aligned || c->ncols < 1 ||
      c->ncols > srj::kMaxStrCols || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * (consumer_warps + 1);
  err = cudaFuncSetAttribute(string_gather_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, string_gather_kernel, threads, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const GatherArgs a = {static_cast<const uint8_t*>(blob),
                        static_cast<const int32_t*>(row_offsets),
                        n,
                        tile_rows,
                        stages,
                        chars_bytes,
                        image_bytes,
                        static_cast<uint8_t*>(long_tiles)};
  string_gather_kernel<<<static_cast<unsigned>(min(tiles, resident)),
                         threads, smem, static_cast<cudaStream_t>(stream)>>>(
      *c, a);
  return static_cast<int>(cudaGetLastError());
}
