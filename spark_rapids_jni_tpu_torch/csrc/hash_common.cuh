// Shared by the hash kernels (murmur3.cu, xxhash64.cu, bloom_probe.cu): the
// column descriptor the wrappers hand over, the launch of one thread a row
// (the bloom probe's L2 route; the column hashes stage their tiles through
// hash_stage.cuh), Spark's normalisation of a fixed-width value by type
// code, and the murmur3_x86_32 and xxhash64 primitives in native 32- and
// 64-bit unsigned arithmetic.
//
// The normalisation is the JAX package's hashing._as_u32_words (murmur3)
// and _col_u64_blocks (xxhash64):
//  - int8/int16 sign-extend to 32 bits; uint8/bool8/uint16 zero-extend;
//  - 4-byte values are their raw bits, 8-byte values their (lo, hi) words;
//  - float32/float64 map -0.0 to 0 and every NaN to the canonical quiet NaN
//    (0x7FC00000 / 0x7FF8000000000000), on the bits, so no flush of
//    denormals can touch them;
//  - xxhash64 takes a value of 4 bytes or fewer as its 32-bit word
//    sign-extended to one 8-byte block.
#pragma once

#include <cstdint>

#include "launch.cuh"

// Type codes: the Python wrapper's hash_kernels._TYPE_CODES.
enum SrjHashType : int32_t {
  kS8 = 0,      // int8
  kU8 = 1,      // uint8, bool8
  kS16 = 2,     // int16
  kU16 = 3,     // uint16
  kB32 = 4,     // int32, uint32, date32, decimal32: raw bits
  kF32 = 5,     // float32
  kB64 = 6,     // int64, uint64, timestamp_us, decimal64: raw bits
  kF64 = 7,     // float64
  kString = 8,  // dense-padded string: chars [n, pitch] and lens [n]
};

// One column, as hash_kernels._ColDesc lays it out (40 bytes).
struct SrjHashCol {
  const void* data;      // values [n], or a string column's chars
  const uint8_t* valid;  // packed LSB-first validity, or null: all valid
  const int32_t* lens;   // string lengths [n]; null for fixed width
  int64_t pitch;         // string row pitch in bytes (a multiple of 4)
  int32_t type;          // SrjHashType
  int32_t stage;         // the staging plan's group, offset and string
                         // route for the column (hash_stage.cuh)
};

// The descriptors of one hash launch, passed by value in the kernel's
// parameter space (__grid_constant__), which holds 32,764 bytes on sm_70
// and later with CUDA 12.1 or newer: room for 800 columns beside the other
// parameters.  The wrapper chains a longer list through further launches,
// each starting every row from the hash the previous launch wrote
// (hash_kernels.MAX_HASH_COLS).
constexpr int kMaxHashCols = 800;

struct SrjHashCols {
  SrjHashCol col[kMaxHashCols];
  int32_t ncols;
};

constexpr int kHashThreads = 256;

// Launches kernel(args...) over n rows, one thread a row in blocks of
// kHashThreads, on `stream` of card `device`, and returns the launch's
// cudaError_t (0, launching nothing, when n <= 0).  The bloom probe's L2
// route launches through it.
template <typename... Params, typename... Args>
int srj_launch_rows(void (*kernel)(Params...), int64_t n, int device,
                    void* stream, Args... args) {
  if (n <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((n + kHashThreads - 1) / kHashThreads);
  kernel<<<blocks, kHashThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args...);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ bool srj_row_valid(const SrjHashCol& c,
                                              int64_t row) {
  return c.valid == nullptr ||
         ((__ldg(c.valid + (row >> 3)) >> (row & 7)) & 1u);
}

__device__ __forceinline__ uint32_t srj_canon_f32(uint32_t b) {
  if ((b & 0x7FFFFFFFu) == 0) return 0;
  if ((b & 0x7F800000u) == 0x7F800000u && (b & 0x007FFFFFu))
    return 0x7FC00000u;
  return b;
}

__device__ __forceinline__ uint64_t srj_canon_f64(uint64_t b) {
  if ((b & 0x7FFFFFFFFFFFFFFFull) == 0) return 0;
  if ((b & 0x7FF0000000000000ull) == 0x7FF0000000000000ull &&
      (b & 0x000FFFFFFFFFFFFFull))
    return 0x7FF8000000000000ull;
  return b;
}

// The 32-bit word of a value of 4 bytes or fewer (types kS8..kF32).
__device__ __forceinline__ uint32_t srj_word32(const SrjHashCol& c,
                                               int64_t row) {
  switch (c.type) {
    case kS8:
      return static_cast<uint32_t>(static_cast<int32_t>(
          __ldg(static_cast<const int8_t*>(c.data) + row)));
    case kU8:
      return __ldg(static_cast<const uint8_t*>(c.data) + row);
    case kS16:
      return static_cast<uint32_t>(static_cast<int32_t>(
          __ldg(static_cast<const int16_t*>(c.data) + row)));
    case kU16:
      return __ldg(static_cast<const uint16_t*>(c.data) + row);
    case kF32:
      return srj_canon_f32(__ldg(static_cast<const uint32_t*>(c.data) + row));
    default:
      return __ldg(static_cast<const uint32_t*>(c.data) + row);
  }
}

// The 64-bit value of an 8-byte column (types kB64, kF64).
__device__ __forceinline__ uint64_t srj_word64(const SrjHashCol& c,
                                               int64_t row) {
  const uint64_t v =
      __ldg(static_cast<const unsigned long long*>(c.data) + row);
  return c.type == kF64 ? srj_canon_f64(v) : v;
}

// A string row's bytes and its length, clamped to [0, pitch] so that no
// read leaves the row (the entry points reject longer lengths).
__device__ __forceinline__ const uint8_t* srj_string_row(const SrjHashCol& c,
                                                         int64_t row,
                                                         int* len) {
  const int32_t l = __ldg(c.lens + row);
  *len = static_cast<int>(l < 0 ? 0 : (l > c.pitch ? c.pitch : l));
  return static_cast<const uint8_t*>(c.data) + row * c.pitch;
}

// ---------------------------------------------------------------------------
// murmur3_x86_32 (Spark's Murmur3_x86_32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t srj_rotl32(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ uint32_t srj_mm3_mix_h1(uint32_t h1, uint32_t k1) {
  k1 *= 0xCC9E2D51u;
  k1 = srj_rotl32(k1, 15);
  k1 *= 0x1B873593u;
  h1 ^= k1;
  h1 = srj_rotl32(h1, 13);
  return h1 * 5u + 0xE6546B64u;
}

__device__ __forceinline__ uint32_t srj_mm3_fmix(uint32_t h1,
                                                 uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85EBCA6Bu;
  h1 ^= h1 >> 13;
  h1 *= 0xC2B2AE35u;
  return h1 ^ (h1 >> 16);
}

// Spark's Murmur3_x86_32.hashLong: the low word, then the high word.
__device__ __forceinline__ uint32_t srj_mm3_hash_long(uint64_t v,
                                                      uint32_t seed) {
  const uint32_t h = srj_mm3_mix_h1(
      srj_mm3_mix_h1(seed, static_cast<uint32_t>(v)),
      static_cast<uint32_t>(v >> 32));
  return srj_mm3_fmix(h, 8);
}

// ---------------------------------------------------------------------------
// xxhash64 (Spark's XXH64)
// ---------------------------------------------------------------------------

constexpr uint64_t kXxP1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t kXxP2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t kXxP3 = 0x165667B19E3779F9ull;
constexpr uint64_t kXxP4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t kXxP5 = 0x27D4EB2F165667C5ull;

__device__ __forceinline__ uint64_t srj_rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t srj_xx_round(uint64_t acc,
                                                 uint64_t input) {
  acc += input * kXxP2;
  acc = srj_rotl64(acc, 31);
  return acc * kXxP1;
}

__device__ __forceinline__ uint64_t srj_xx_merge(uint64_t acc, uint64_t v) {
  acc ^= srj_xx_round(0, v);
  return acc * kXxP1 + kXxP4;
}

__device__ __forceinline__ uint64_t srj_xx_fmix(uint64_t h) {
  h ^= h >> 33;
  h *= kXxP2;
  h ^= h >> 29;
  h *= kXxP3;
  return h ^ (h >> 32);
}
