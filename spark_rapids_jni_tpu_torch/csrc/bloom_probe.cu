// bloom_might_contain: Spark's BloomFilterImpl.mightContainLong over a
// column, for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_bloom_kernel
// (pallas_call at pallas_kernels.py:847).  The TPU kernel keeps the uint32
// view of the bitset resident in VMEM and computes its bit index modulo an
// int32 num_bits, so the JAX package sends filters of 2^31 bits or more to
// the host.  Here num_bits is int64: the index is Spark's combinedHash %
// bitSize in 64 bits, and every filter size runs on the card.
//
// Per row: a null row gives false.  Otherwise the value, sign-extended to a
// long (int8/int16/int32/date32/int64/timestamp), gives h1 = hashLong(v, 0)
// and h2 = hashLong(v, h1) (murmur3_x86_32 over its low then high word);
// for i in 1..k, c = (int32)(h1 + i * h2), c = ~c if negative, and bit
// c % num_bits of the long[] bitset must be set.  All k probes are taken
// (no early exit), so the work does not depend on the data.
//
// Bound: by the counts in chip_smoke.py, instructions, narrowly.  A row
// reads its value (1 to 8 bytes) and 1/8 of a mask byte and writes one
// byte; in the SASS the two hashLong take 33 arithmetic instructions and
// each probe 20 more (the remainder by multiplies, the word's address and
// the bit test), so at k = 6 some 153 instructions against 9.1 bytes of an
// INT64 row: 4.6 us of instructions and 2.7 us of bytes per million rows
// (33.4 T instructions issued a second; 3.35 TB/s).  The bitset is read
// once by that count; the k probes of a row are scattered 8-byte reads that
// land in L2, each moving a 32-byte sector.
//
// Design: one thread per row, 256 threads a block.  A filter of Spark's
// default 1 MiB or its 8 MiB maximum stays resident in the 50 MB L2 by
// itself, and the probes read it through the read-only path (__ldg); the k
// loads of a row are independent, so they are all in flight at once.
// Staging the bitset in shared memory does not fit past 227 KB a block and
// is left for a later change.  When num_bits > 2^31 - 1 the index c (< 2^31)
// is its own remainder; otherwise the remainder takes two multiplies by a
// constant that the host computes once a launch, not a division a probe.
// Every global offset is 64-bit.

#include <cstdint>

#include "hash_common.cuh"

namespace {

__global__ void __launch_bounds__(kHashThreads)
bloom_kernel(const unsigned long long* __restrict__ bits, uint32_t nb32,
             uint64_t magic, int k, const void* __restrict__ values,
             int elem_bytes, const uint8_t* __restrict__ valid, int64_t n,
             uint8_t* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (row >= n) return;
  if (valid != nullptr && !((__ldg(valid + (row >> 3)) >> (row & 7)) & 1u)) {
    out[row] = 0;
    return;
  }
  int64_t v;
  switch (elem_bytes) {
    case 1: v = __ldg(static_cast<const int8_t*>(values) + row); break;
    case 2: v = __ldg(static_cast<const int16_t*>(values) + row); break;
    case 4: v = __ldg(static_cast<const int32_t*>(values) + row); break;
    default: v = __ldg(static_cast<const long long*>(values) + row); break;
  }
  const uint64_t u = static_cast<uint64_t>(v);
  const uint32_t h1 = srj_mm3_hash_long(u, 0);
  const uint32_t h2 = srj_mm3_hash_long(u, h1);
  unsigned ok = 1;
  for (int i = 1; i <= k; ++i) {
    int32_t c = static_cast<int32_t>(h1 + static_cast<uint32_t>(i) * h2);
    if (c < 0) c = ~c;
    // c % num_bits without a division: the high word of (magic * c mod
    // 2^64) * num_bits (Lemire, Kaser and Kurz, "Faster remainder by
    // direct computation", 2019), exact for every 32-bit c and divisor
    const uint64_t idx =
        magic ? __umul64hi(magic * static_cast<uint32_t>(c), nb32)
              : static_cast<uint64_t>(c);
    ok &= static_cast<unsigned>((__ldg(bits + (idx >> 6)) >> (idx & 63)) &
                                1ull);
  }
  out[row] = static_cast<uint8_t>(ok);
}

}  // namespace

// Probes n values (elem_bytes 1, 2, 4 or 8, signed) with packed validity
// `valid` (null: all valid) against the filter's long[] bitset `bits`
// (num_bits = 64 * its words, k hash functions), writing one byte 0/1 a row
// into out.  Launches on stream, of card `device`, and returns the launch's
// cudaError_t.
extern "C" int srj_bloom_might_contain(const void* bits, int64_t num_bits,
                                       int k, const void* values,
                                       int elem_bytes, const void* valid,
                                       int64_t n, void* out, int device,
                                       void* stream) {
  if (num_bits <= 0 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  // past 2^31 - 1 bits the index c (< 2^31) is its own remainder: magic 0
  const uint64_t magic =
      num_bits > 0x7FFFFFFF ? 0 : ~0ull / static_cast<uint64_t>(num_bits) + 1;
  return srj_launch_rows(
      bloom_kernel, n, device, stream,
      static_cast<const unsigned long long*>(bits),
      static_cast<uint32_t>(num_bits), magic, k, values, elem_bytes,
      static_cast<const uint8_t*>(valid), n, static_cast<uint8_t*>(out));
}
