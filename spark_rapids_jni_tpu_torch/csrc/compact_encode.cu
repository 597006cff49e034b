// compact_encode: one batch of compact JCUDF rows, for sm_90a.
//
// Replaces no TPU kernel.  The JAX package builds these rows in XLA
// (spark_rapids_jni_tpu/ops/row_conversion.py::_to_rows_variable_jit): a
// word-space scatter of the fixed sections, then one scatter-add of every
// char byte at its byte lane.  In PyTorch that scatter needs an int64 index
// per char moved; this kernel moves each byte once instead.
//
// Inputs: fixed uint8 [n, fixed_stride] (each row's fixed section, the
// string slots' (offset, length) pairs filled in, zeros from fixed_end to
// fe_pad, fixed_end rounded up to 4; fixed_stride a multiple of 4, the rows
// 4-byte aligned), row offsets int32 [n + 1] (multiples of 8), and per
// string column its chars (the batch's slice, starting at absolute char
// offset lo) and its absolute offsets at the batch's rows (nondecreasing).
// Output: uint8 [row_offsets[n]] (16-byte aligned): row r is its fixed
// section, then its strings' chars back to back from fixed_end, then zeros
// up to row_offsets[r + 1].
//
// Bound: memory.  The kernel must read n * fixed_end fixed bytes, 4 (n + 1)
// bytes of row offsets and of each column's offsets, and every char, and
// write the blob once.
//
// Design: a tile of R rows needs only contiguous ranges: R consecutive
// fixed sections, each column's R + 1 offsets and its chars between the
// tile's first and last offset, and it writes one contiguous output range.
// So persistent blocks walk the tiles through a ring of shared-memory
// stages (ragged_copy.cuh's EncodeSlot, kernels.compact_encode_plan sizes
// them):
//  - The producer warp loads each column's first and last offset of the
//    tile (a lane a column, two tiles ahead, so that the loads hide behind
//    a fill), waits for a free stage and fills it with bulk copies of the
//    aligned 16-byte chunks around each range (bulk_copy.cuh), on the
//    stage's mbarrier.  A tile whose chars or output pass their rooms is
//    flagged instead and takes the long-row route (and, where the caller
//    asks, marked in long_tiles).  Each column's chunk bytes are capped a
//    chunk past the chars room before they are summed: a capped column
//    sends the tile long, and 128 capped columns stay far inside int.
//  - The consumer warps assemble the tile's output rows in the block's
//    image, a warp a row: the fixed words, then each string's chars, a
//    lane a column (the lengths' warp scan gives each its place, so no
//    column waits on another), then the zero tail.  After a barrier of
//    the consumers they hand the stage back and store the image as 16-byte
//    words, coalesced (an 8-byte word at a tile's head or tail, where a
//    row starts 8 bytes off a 16-byte line).  One image serves every
//    stage (the stores read it out before the next tile's rows go in), so
//    that the stages can hold the biggest tiles: the bulk copies have a
//    fixed cost each, and a tile takes two a column.
//  - Long-row route: a warp a row straight from device memory, a lane a
//    column loading its offsets at once, the strings of at most 32 bytes
//    eight at a time, lane b taking byte b of each, and each longer one
//    by the whole warp (srj::row_copy_pieces).
// Nothing is written past a row's end, whatever its offsets say.  Every
// global offset is 64-bit.

#include <cstdint>

#include "bulk_copy.cuh"
#include "launch.cuh"
#include "ragged_copy.cuh"

struct SrjCompactStr {
  const uint8_t* chars;    // the batch's chars, starting at absolute offset lo
  const int32_t* offsets;  // absolute offsets of the batch's rows [n + 1]
  int64_t lo;
};

struct SrjCompactCols {
  SrjCompactStr col[srj::kMaxStrCols];
  int32_t ncols;
};

namespace {

constexpr int kMaxThreads = 32 * (srj::kTileMaxWarps + 1);
constexpr int kColsPerLane = srj::kMaxStrCols / 32;

struct EncodeArgs {
  const uint8_t* fixed;
  int stride, fixed_end;
  const int32_t* row_offsets;
  int64_t n;
  uint8_t* out;
  int tile_rows, stages, chars_bytes, image_bytes;
  uint8_t* long_tiles;  // null, or [tiles]: 1 where a tile went long
};

// Row r's fixed words and zero tail around its chars, which `chars` (a
// functor of the row's size, returning the end of its chars) writes from
// fixed_end on: the words first, then (after __syncwarp: the chars
// overwrite the words' zeros in [fixed_end, fe_pad)) the chars, then zeros
// to the row's end.
template <class Chars>
__device__ __forceinline__ void encode_row(uint8_t* row, const uint8_t* fsrc,
                                           int size, int fixed_end, int lane,
                                           Chars chars) {
  const int words = min((fixed_end + 3) / 4, size / 4);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(fsrc);
  uint32_t* dst = reinterpret_cast<uint32_t*>(row);
  for (int i = lane; i < words; i += 32) dst[i] = src[i];
  __syncwarp();
  const int end = chars(size);
  for (int i = max(end, 4 * words) + lane; i < size; i += 32) row[i] = 0;
}

// The long-row route: row r straight from device memory.
__device__ void encode_row_global(const SrjCompactCols& cols,
                                  const EncodeArgs& a, int64_t r, int lane) {
  const int64_t base = a.row_offsets[r];
  const int size = static_cast<int>(a.row_offsets[r + 1] - base);
  uint8_t* row = a.out + base;
  encode_row(row, a.fixed + r * a.stride, size, a.fixed_end, lane,
             [&](int size) {
               int pos = a.fixed_end;
               for (int cb = 0; cb < cols.ncols; cb += 32) {
                 const int c = cb + lane;
                 int len = 0;
                 const uint8_t* src = nullptr;
                 if (c < cols.ncols) {
                   const SrjCompactStr& s = cols.col[c];
                   const int32_t o0 = s.offsets[r];
                   len = s.offsets[r + 1] - o0;
                   src = s.chars + (o0 - s.lo);
                 }
                 const int incl = srj::warp_scan(len, lane);
                 const int dst = pos + incl - len;
                 len = max(0, min(len, size - dst));
                 srj::row_copy_pieces(row + dst, src, len, lane);
                 pos += __shfl_sync(0xFFFFFFFFu, incl, 31);
               }
               return min(pos, size);
             });
}

// Row i of a staged tile into the block's image (img: the image byte of
// the tile's row 0), a lane a column copying its string (srj::lane_copy).
__device__ __forceinline__ void encode_row_staged(
    const uint8_t* slot, const int2* meta, const int32_t* ro, int ncols,
    const EncodeArgs& a, int i, uint8_t* img, const uint8_t* fixed0,
    int lane) {
  const int size = ro[i + 1] - ro[i];
  uint8_t* row = img + (ro[i] - ro[0]);
  encode_row(row, fixed0 + i * a.stride, size, a.fixed_end, lane,
             [&](int size) {
               int pos = a.fixed_end;
               for (int cb = 0; cb < ncols; cb += 32) {
                 const int c = cb + lane;
                 int len = 0;
                 const uint8_t* src = slot;
                 if (c < ncols) {
                   const int2 m = meta[c];
                   const int32_t* of =
                       reinterpret_cast<const int32_t*>(slot + m.y);
                   const int32_t o0 = of[i];
                   len = of[i + 1] - o0;
                   src = slot + m.x + (o0 - of[0]);
                 }
                 const int incl = srj::warp_scan(len, lane);
                 const int dst = pos + incl - len;
                 len = max(0, min(len, size - dst));
                 srj::lane_copy(row + dst, src, len);
                 pos += __shfl_sync(0xFFFFFFFFu, incl, 31);
               }
               return min(pos, size);
             });
}

// Bytes [lo, hi) of the image (img) to dst + lo: one 8-byte word where it
// is one, else bytes (a tile's head or tail).
__device__ __forceinline__ void store_part(uint8_t* dst, const uint8_t* img,
                                           int lo, int hi) {
  if (hi - lo == 8 && (lo & 7) == 0) {
    *reinterpret_cast<uint2*>(dst + lo) =
        *reinterpret_cast<const uint2*>(img + lo);
  } else {
    for (int b = lo; b < hi; ++b) dst[b] = img[b];
  }
}

// The producer's view of a tile: its rows [r0, r0 + m) and, for the lane's
// columns c = lane + 32 k, their first and last offsets.
struct TileEnds {
  int64_t r0;
  int m;
  int32_t ro0, ro1;
  int32_t lo[kColsPerLane], hi[kColsPerLane];
};

__device__ __forceinline__ void load_ends(const SrjCompactCols& cols,
                                          const EncodeArgs& a, int64_t t,
                                          int lane, TileEnds& e) {
  e.r0 = t * a.tile_rows;
  e.m = static_cast<int>(min(static_cast<int64_t>(a.tile_rows), a.n - e.r0));
  e.ro0 = a.row_offsets[e.r0];
  e.ro1 = a.row_offsets[e.r0 + e.m];
#pragma unroll
  for (int k = 0; k < kColsPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < cols.ncols) {
      e.lo[k] = cols.col[c].offsets[e.r0];
      e.hi[k] = cols.col[c].offsets[e.r0 + e.m];
    }
  }
}

__global__ void __launch_bounds__(kMaxThreads)
compact_encode_kernel(const __grid_constant__ SrjCompactCols cols,
                      const EncodeArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + srj::kTileMaxStages;
  uint8_t* slots = smem + srj::kTileBarBytes;
  const int ncols = cols.ncols;
  const srj::EncodeSlot L =
      srj::encode_slot(a.tile_rows, ncols, a.stride, a.chars_bytes);
  uint8_t* image = slots + static_cast<int64_t>(a.stages) * L.bytes;
  const int cwarps = static_cast<int>(blockDim.x >> 5) - 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_u32(full + s))
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                       smem_u32(empty + s)),
                   "r"(cwarps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t tiles = (a.n + a.tile_rows - 1) / a.tile_rows;
  int s = 0;
  uint32_t phase = 0;

  if (warp == 0) {
    // the producer: the ends of the tile it fills (e) and of the next one
    // (next), loaded a tile ahead so that their latency hides behind a
    // fill
    TileEnds e, next;
    if (blockIdx.x < tiles) load_ends(cols, a, blockIdx.x, lane, e);
    if (blockIdx.x + gridDim.x < tiles)
      load_ends(cols, a, blockIdx.x + gridDim.x, lane, next);
    for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int64_t r0 = e.r0;
      const int m = e.m;
      const int32_t ro0 = e.ro0, ro1 = e.ro1;
      // each column's chars: its chunks' bytes and place in the stage
      int cpos[kColsPerLane], cbytes[kColsPerLane];
      const uint8_t* csrc[kColsPerLane];
      const uint32_t cap = a.chars_bytes + 16u;
      int carry = 0;
#pragma unroll
      for (int k = 0; k < kColsPerLane; ++k) {
        const int c = lane + 32 * k;
        int b = 0;
        csrc[k] = nullptr;
        if (c < ncols) {
          csrc[k] = cols.col[c].chars + (e.lo[k] - cols.col[c].lo);
          const int len = e.hi[k] - e.lo[k];
          b = len > 0 ? static_cast<int>(
                            min(stage_chunk_bytes(csrc[k], len), cap))
                      : 0;
        }
        const int incl = srj::warp_scan(b, lane);
        cpos[k] = carry + incl - b;
        cbytes[k] = b;
        carry += __shfl_sync(0xFFFFFFFFu, incl, 31);
      }
      uint8_t* const gbase = a.out + ro0;
      const int imis = stage_misalign(gbase);
      const bool fits = carry <= a.chars_bytes &&
                        imis + static_cast<int64_t>(ro1 - ro0) <=
                            a.image_bytes;
      mbar_wait(empty + s, phase ^ 1);
      uint8_t* slot = slots + static_cast<int64_t>(s) * L.bytes;
      int32_t* hdr = reinterpret_cast<int32_t*>(slot);
      if (!fits) {
        if (lane == 0) {
          hdr[srj::kHdrLong] = 1;
          mbar_arrive(full + s);
          if (a.long_tiles) a.long_tiles[t] = 1;
        }
      } else {
        const uint8_t* fsrc = a.fixed + r0 * a.stride;
        const int64_t flen = static_cast<int64_t>(m) * a.stride;
        const int32_t* rsrc = a.row_offsets + r0;
        const int olen = 4 * (m + 1);
        int2* meta = reinterpret_cast<int2*>(slot + srj::kSlotHeader);
        // the copies' bytes, which the mbarrier is told to expect
        uint32_t bytes = 0;
        if (lane == 0) {
          hdr[srj::kHdrLong] = 0;
          hdr[srj::kHdrRows] = L.rows + stage_misalign(rsrc);
          hdr[srj::kHdrFixed] = L.fixed + stage_misalign(fsrc);
          hdr[srj::kHdrImage] = imis;
          bytes = stage_chunk_bytes(fsrc, flen) + stage_chunk_bytes(rsrc, olen);
        }
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = lane + 32 * k;
          if (c < ncols) {
            const int32_t* osrc = cols.col[c].offsets + r0;
            meta[c] = make_int2(L.chars + cpos[k] + stage_misalign(csrc[k]),
                                L.cols + c * L.col_room + stage_misalign(osrc));
            bytes += stage_chunk_bytes(osrc, olen) + cbytes[k];
          }
        }
        bytes = __reduce_add_sync(0xFFFFFFFFu, bytes);
        __syncwarp();
        if (lane == 0)
          asm volatile(
              "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                  smem_u32(full + s)),
              "r"(bytes)
              : "memory");
        __syncwarp();
        if (lane == 0) stage_copy(slot + L.fixed, fsrc, flen, full + s);
        if (lane == 1) stage_copy(slot + L.rows, rsrc, olen, full + s);
#pragma unroll
        for (int k = 0; k < kColsPerLane; ++k) {
          const int c = lane + 32 * k;
          if (c < ncols) {
            stage_copy(slot + L.cols + c * L.col_room, cols.col[c].offsets + r0,
                       olen, full + s);
            if (cbytes[k])
              stage_copy(slot + L.chars + cpos[k], csrc[k], e.hi[k] - e.lo[k],
                         full + s);
          }
        }
      }
      // the tile after next: its ends load while the copies fly
      e = next;
      if (t + 2 * static_cast<int64_t>(gridDim.x) < tiles)
        load_ends(cols, a, t + 2 * static_cast<int64_t>(gridDim.x), lane,
                  next);
      if (++s == a.stages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // the consumers
  const int cw = warp - 1;
  const int ct = threadIdx.x - 32, cthreads = 32 * cwarps;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int64_t r0 = t * a.tile_rows;
    const int m =
        static_cast<int>(min(static_cast<int64_t>(a.tile_rows), a.n - r0));
    mbar_wait(full + s, phase);
    const uint8_t* slot = slots + static_cast<int64_t>(s) * L.bytes;
    const int32_t* hdr = reinterpret_cast<const int32_t*>(slot);
    if (hdr[srj::kHdrLong]) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
      for (int i = cw; i < m; i += cwarps)
        encode_row_global(cols, a, r0 + i, lane);
    } else {
      const int32_t* ro =
          reinterpret_cast<const int32_t*>(slot + hdr[srj::kHdrRows]);
      const uint8_t* fixed0 = slot + hdr[srj::kHdrFixed];
      const int imis = hdr[srj::kHdrImage];
      const int2* meta = reinterpret_cast<const int2*>(slot + srj::kSlotHeader);
      for (int i = cw; i < m; i += cwarps)
        encode_row_staged(slot, meta, ro, ncols, a, i, image + imis, fixed0,
                          lane);
      const int end = imis + (ro[m] - ro[0]);
      uint8_t* dst = a.out + ro[0] - imis;  // 16-byte aligned
      // every row of the image is in place: the stage goes back, the image
      // is stored
      asm volatile("bar.sync 1, %0;\n" ::"r"(cthreads) : "memory");
      if (lane == 0) mbar_arrive(empty + s);
      for (int k = ct; 16 * k < end; k += cthreads) {
        const int lo = 16 * k;
        if (lo >= imis && lo + 16 <= end) {
          *reinterpret_cast<uint4*>(dst + lo) =
              *reinterpret_cast<const uint4*>(image + lo);
        } else {
          store_part(dst, image, max(lo, imis), min(lo + 16, end));
        }
      }
      // the image is read: the next tile may write it
      asm volatile("bar.sync 1, %0;\n" ::"r"(cthreads) : "memory");
    }
    if (++s == a.stages) {
      s = 0;
      phase ^= 1;
    }
  }
}

}  // namespace

// Writes n compact rows into out (uint8 [row_offsets[n]], 16-byte aligned)
// from fixed (uint8 [n, fixed_stride]), row_offsets (int32 [n + 1]) and the
// string columns of cols, by the tile plan of kernels.compact_encode_plan:
// tiles of tile_rows rows, consumer_warps consumer warps a block, a ring of
// `stages` stages, each with room for chars_bytes of chars, and an image of
// image_bytes for a tile's output (both multiples of 16).  Where long_tiles
// (uint8 [tiles], zeros) is given, the tiles that take the long-row route
// are set to 1 in it.  The caller guarantees every row's offsets inside its
// chars.  Launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_compact_encode(const void* cols, const void* fixed,
                                  int fixed_stride, int fixed_end,
                                  const void* row_offsets, int64_t n,
                                  void* out, int tile_rows,
                                  int consumer_warps, int stages,
                                  int chars_bytes, int image_bytes,
                                  void* long_tiles, int device,
                                  void* stream) {
  const SrjCompactCols* c = static_cast<const SrjCompactCols*>(cols);
  const srj::EncodeSlot L =
      srj::encode_slot(tile_rows, c->ncols, fixed_stride, chars_bytes);
  const int64_t smem = srj::kTileBarBytes +
                       static_cast<int64_t>(stages) * L.bytes + image_bytes;
  if (tile_rows < 1 || tile_rows > srj::kTileMaxRows || consumer_warps < 1 ||
      consumer_warps > srj::kTileMaxWarps || stages < 2 ||
      stages > srj::kTileMaxStages || chars_bytes < 0 || chars_bytes % 16 ||
      image_bytes < 16 || image_bytes % 16 || fixed_stride % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16 || c->ncols < 0 ||
      c->ncols > srj::kMaxStrCols || smem > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 32 * (consumer_warps + 1);
  err = cudaFuncSetAttribute(compact_encode_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, compact_encode_kernel, threads, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t tiles = (n + tile_rows - 1) / tile_rows;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const EncodeArgs a = {static_cast<const uint8_t*>(fixed),
                        fixed_stride,
                        fixed_end,
                        static_cast<const int32_t*>(row_offsets),
                        n,
                        static_cast<uint8_t*>(out),
                        tile_rows,
                        stages,
                        chars_bytes,
                        image_bytes,
                        static_cast<uint8_t*>(long_tiles)};
  compact_encode_kernel<<<static_cast<unsigned>(min(tiles, resident)),
                          threads, smem, static_cast<cudaStream_t>(stream)>>>(
      *c, a);
  return static_cast<int>(cudaGetLastError());
}
