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
// once by that count.
//
// Design: the TPU kernel keeps the bitset on chip (a constant index map);
// so does the block route here, where the filter fits.  Read from device
// memory, each probe is an 8-byte load at a random word, which moves a
// 32-byte L2 sector: at Spark's default filter (8,388,608 bits, k = 6) that
// is 32 sectors' worth of L2 traffic for every byte the kernel must read.
// The wrapper picks the route from the filter's size alone
// (hash_kernels._bloom_route):
//  - block route (route 1, up to 128 KiB): each persistent block copies the
//    whole bitset into its shared memory with one bulk copy (cp.async.bulk,
//    completed on an mbarrier) and walks the rows grid-stride, each thread
//    loading its next row's value while it hashes and probes this one; a
//    probe is one 32-bit shared-memory load, and its remainder is taken in
//    32 bits (bloom_index32).
//  - L2 route (route 0): larger filters (Spark's default 1 MiB, its 8 MiB
//    maximum, the 2^31-bit ones) stay in device memory and L2; one thread a
//    row reads the probed words through the read-only path (__ldg), all k
//    loads of a row in flight at once.  Splitting such a filter over the
//    blocks of a thread block cluster and probing it through distributed
//    shared memory was slower than this at every size from 2 to 8 blocks
//    (PERF.md): scattered 4-byte reads of a peer's shared memory.
// In shared memory bit b of long word w is bit b & 31 of 32-bit word
// 2w + ((b >> 5) & 1), so the bit index idx is bit idx & 31 of 32-bit word
// idx >> 5.  When num_bits > 2^31 - 1 (L2 route only) the index c (< 2^31)
// is its own remainder; otherwise the remainder takes two multiplies by a
// constant that the host computes once a launch, not a division a probe.
// Every global offset is 64-bit.

#include <cstdint>

#include "hash_common.cuh"

namespace {

// threads of a block on the block route
constexpr int kSmemThreads = 1024;
// the most shared memory a block of this card can take (227 KB)
constexpr int kMaxSmemBytes = 232448;

// A probe's bit index: c % num_bits without a division, the high word of
// (magic * c mod 2^64) * num_bits (Lemire, Kaser and Kurz, "Faster
// remainder by direct computation", 2019), exact for every 32-bit c and
// divisor; c itself where magic is 0 (num_bits > 2^31 - 1).
__device__ __forceinline__ uint64_t bloom_index(uint32_t h1, uint32_t h2,
                                                int i, uint64_t magic,
                                                uint32_t nb32) {
  int32_t c = static_cast<int32_t>(h1 + static_cast<uint32_t>(i) * h2);
  if (c < 0) c = ~c;
  return magic ? __umul64hi(magic * static_cast<uint32_t>(c), nb32)
               : static_cast<uint64_t>(c);
}

// The same index in 32 bits, for the block route's filters (exact for any
// num_bits < 2^32): with m32 = floor((2^32 - 1) / num_bits), q = (c * m32)
// >> 32 is floor(c / num_bits) or one less (c < 2^31 keeps the error under
// one half), so one correction step gives the remainder.
__device__ __forceinline__ uint32_t bloom_index32(uint32_t h1, uint32_t h2,
                                                  int i, uint32_t m32,
                                                  uint32_t nb32) {
  int32_t c = static_cast<int32_t>(h1 + static_cast<uint32_t>(i) * h2);
  if (c < 0) c = ~c;
  const uint32_t u = static_cast<uint32_t>(c);
  const uint32_t r = u - __umulhi(u, m32) * nb32;
  return r >= nb32 ? r - nb32 : r;
}

__device__ __forceinline__ uint64_t bloom_value(const void* values,
                                                int elem_bytes, int64_t row) {
  int64_t v;
  switch (elem_bytes) {
    case 1: v = __ldg(static_cast<const int8_t*>(values) + row); break;
    case 2: v = __ldg(static_cast<const int16_t*>(values) + row); break;
    case 4: v = __ldg(static_cast<const int32_t*>(values) + row); break;
    default: v = __ldg(static_cast<const long long*>(values) + row); break;
  }
  return static_cast<uint64_t>(v);
}

__device__ __forceinline__ bool bloom_row_valid(const uint8_t* valid,
                                                int64_t row) {
  return valid == nullptr || ((__ldg(valid + (row >> 3)) >> (row & 7)) & 1u);
}

// The L2 route.
__global__ void __launch_bounds__(kHashThreads)
bloom_kernel(const unsigned long long* __restrict__ bits, uint32_t nb32,
             uint64_t magic, int k, const void* __restrict__ values,
             int elem_bytes, const uint8_t* __restrict__ valid, int64_t n,
             uint8_t* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kHashThreads + threadIdx.x;
  if (row >= n) return;
  if (!bloom_row_valid(valid, row)) {
    out[row] = 0;
    return;
  }
  const uint64_t u = bloom_value(values, elem_bytes, row);
  const uint32_t h1 = srj_mm3_hash_long(u, 0);
  const uint32_t h2 = srj_mm3_hash_long(u, h1);
  unsigned ok = 1;
  for (int i = 1; i <= k; ++i) {
    const uint64_t idx = bloom_index(h1, h2, i, magic, nb32);
    ok &= static_cast<unsigned>((__ldg(bits + (idx >> 6)) >> (idx & 63)) &
                                1ull);
  }
  out[row] = static_cast<uint8_t>(ok);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// The block route: the bitset's num_words long words as 32-bit words in
// the block's dynamic shared memory.
__global__ void __launch_bounds__(kSmemThreads)
bloom_block_kernel(const unsigned long long* __restrict__ bits,
                   int64_t num_words, uint32_t nb32, uint32_t m32, int k,
                   const void* __restrict__ values, int elem_bytes,
                   const uint8_t* __restrict__ valid, int64_t n,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t words32[];
  __shared__ __align__(8) uint64_t bar;
  // the bulk copy takes 16-byte multiples at 16-byte addresses; a word
  // left over, or a bitset at an 8-byte address, is copied by the threads
  const uint32_t bulk =
      (reinterpret_cast<uintptr_t>(bits) & 15) == 0
          ? static_cast<uint32_t>(num_words * 8) & ~15u
          : 0u;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_u32(&bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && bulk) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(&bar)),
        "r"(bulk)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(words32)),
        "l"(bits), "r"(bulk), "r"(smem_u32(&bar))
        : "memory");
  }
  unsigned long long* words64 =
      reinterpret_cast<unsigned long long*>(words32);
  for (int64_t w = bulk / 8 + threadIdx.x; w < num_words; w += kSmemThreads)
    words64[w] = __ldg(bits + w);
  if (bulk) {
    while (!mbar_try_wait(smem_u32(&bar), 0)) {
    }
  }
  __syncthreads();

  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSmemThreads;
  // software-pipelined: the next row's value and mask bit are loaded before
  // this row's hashes and probes, so their latency hides behind them
  int64_t row = static_cast<int64_t>(blockIdx.x) * kSmemThreads + threadIdx.x;
  uint64_t u_next = 0;
  bool valid_next = false;
  if (row < n) {
    valid_next = bloom_row_valid(valid, row);
    u_next = bloom_value(values, elem_bytes, row);
  }
  for (; row < n; row += stride) {
    const uint64_t u = u_next;
    const bool row_valid = valid_next;
    if (row + stride < n) {
      valid_next = bloom_row_valid(valid, row + stride);
      u_next = bloom_value(values, elem_bytes, row + stride);
    }
    const uint32_t h1 = srj_mm3_hash_long(u, 0);
    const uint32_t h2 = srj_mm3_hash_long(u, h1);
    unsigned ok = row_valid;
    for (int i = 1; i <= k; ++i) {
      const uint32_t idx = bloom_index32(h1, h2, i, m32, nb32);
      ok &= (words32[idx >> 5] >> (idx & 31)) & 1u;
    }
    out[row] = static_cast<uint8_t>(ok);
  }
}

// Launches bloom_block_kernel over n rows: as many blocks as can be
// resident at once, and no more than the rows need.
int launch_block(int smem, const unsigned long long* bits, int64_t num_words,
                 uint32_t nb32, int k, const void* values, int elem_bytes,
                 const uint8_t* valid, int64_t n, uint8_t* out, int device,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bloom_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, bloom_block_kernel, kSmemThreads, smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t need = (n + kSmemThreads - 1) / kSmemThreads;
  const int64_t resident = static_cast<int64_t>(per_sm) * sms;
  const auto blocks =
      static_cast<unsigned>(need < resident ? need : resident);
  bloom_block_kernel<<<blocks, kSmemThreads, smem, stream>>>(
      bits, num_words, nb32, 0xFFFFFFFFu / nb32, k, values, elem_bytes,
      valid, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Probes n values (elem_bytes 1, 2, 4 or 8, signed) with packed validity
// `valid` (null: all valid) against the filter's long[] bitset `bits`
// (num_bits = 64 * its words, k hash functions), writing one byte 0/1 a row
// into out, by hash_kernels._bloom_route's route: 0 the L2 route, 1 the
// block route.  Launches on stream, of card `device`, and returns the
// launch's cudaError_t (cudaErrorInvalidValue for a route the filter does
// not fit).
extern "C" int srj_bloom_might_contain(const void* bits, int64_t num_bits,
                                       int k, const void* values,
                                       int elem_bytes, const void* valid,
                                       int64_t n, void* out, int route,
                                       int device, void* stream) {
  if (num_bits <= 0 || num_bits % 64 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // past 2^31 - 1 bits the index c (< 2^31) is its own remainder: magic 0
  const uint64_t magic =
      num_bits > 0x7FFFFFFF ? 0 : ~0ull / static_cast<uint64_t>(num_bits) + 1;
  const auto* words = static_cast<const unsigned long long*>(bits);
  const auto* vmask = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint8_t*>(out);
  const auto nb32 = static_cast<uint32_t>(num_bits);
  if (route == 0)
    return srj_launch_rows(bloom_kernel, n, device, stream, words, nb32,
                           magic, k, values, elem_bytes, vmask, n, o);
  // the block route: the whole bitset in shared memory
  const int64_t smem = (num_bits / 8 + 15) / 16 * 16;
  if (route != 1 || smem + 16 > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_block(static_cast<int>(smem), words, num_bits / 64, nb32, k,
                      values, elem_bytes, vmask, n, o, device,
                      static_cast<cudaStream_t>(stream));
}
