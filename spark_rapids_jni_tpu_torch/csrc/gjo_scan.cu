// gjo_scan: get_json_object's path automaton over dense-padded char rows,
// for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_gjo_scan_kernel
// (pallas_call at pallas_kernels.py:771).  The TPU kernel holds a [W, tile]
// transposed char tile in VMEM, rows as lanes, and replays the JAX
// package's select-only step (get_json._automaton_pieces) once per char
// column inside a fori_loop; its per-level lookups are select-sums because
// TPU gathers are slow, and its window is capped at 32 KiB by VMEM
// (_gjo_sig_eligible).  Here one thread walks one row: the automaton's
// carry lives in registers, the char row is read in 4-byte words, and the
// path's tables are read from a small device buffer that stays in L1.  No
// cap on the window or the path beyond the JAX package's own (at most 256
// segments, keys of at most 254 bytes).
//
// Per row and char, in order, the step of get_json._automaton_pieces:
// string and escape state, the uint8 depth (opens past 250 saturate and set
// `deep`; a close at depth 0 wraps to 255), key scanning at the match
// frontier, the value after a matched key's colon or at the subscript's
// element, descent into the next segment's container, dead ends, the
// element counter of an index segment, key position tracking, the capture
// and its end.  Every uint8 carry wraps as in the JAX package: each sum is
// cast back to uint8_t before it is compared.  The whole window is scanned,
// padding zeros included (a zero is an "other" char to the automaton), and
// null rows are scanned like any other.  Output: int32 [6, n], the rows
// start, end, found, capturing, bad and deep (the Pallas output's layout).
//
// Bound: bytes.  A row of W chars is read once (W bytes) and six words are
// written: 0.31 ms for 1M rows of 1 KiB at 3.35 TB/s.  The function needs
// little arithmetic for most chars: inside a string (most of a document)
// only a quote test and a backslash test, four chars to one SIMD byte
// compare (chip_smoke.py's GJO_LEAST_OPS_4_CHARS), far under the bytes.
// This kernel does not reach that bound: it runs the whole step for every
// char, 217 compares, logic ops, selects and predicate moves on the common
// path (no key byte read, no descent, no capture end), counted in its SASS
// (CUDA 12.8: 869 in the main loop's four chars, branches, loads and moves
// left out; chip_smoke.py's GJO_STEP), so its instruction issue holds it
// near 6.65 ms for those rows, some 21 times the bound.  A step that skips
// the automaton for string and settled chars (flags packed into bits, a
// char-class table) is a later change.
//
// Design (a simple right kernel first): no shared memory and no
// synchronisation, so the step's instructions are all the kernel issues
// besides one 4-byte load per four chars; the carry (about 25 values)
// stays in registers; the lookups of the current path segment (its key
// length, whether it is a subscript, its target) are cached in registers
// and reloaded only when a row descends a level, and a key byte is read
// only for a char inside a key at the frontier.  A warp's 32 rows are 32 different lines, each reused for 32
// words, and the L1 keeps them while the threads walk them (as for the
// string hashes).  128 threads a block leave the scheduler many warps to
// hide the loads behind.  Row offsets are int64_t: n * pitch passes 2^31.

#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kThreads = 128;

// What the step reads of one path segment.
struct Seg {
  uint8_t len;   // key length (0 for a subscript)
  bool is_idx;   // an array subscript
  int32_t tgt;   // the subscript
};

// The path's tables: key bytes [L, max_key_len], then int32 [3, L] of key
// lengths, subscript flags and subscripts.
struct Path {
  const uint8_t* keys;
  const int32_t* tab;
  int L;
  int max_key_len;
  uint8_t last;  // uint8(L - 1), L <= 256

  // segment min(m, L - 1), as the JAX package's _select_lut reads it
  __device__ __forceinline__ Seg at(uint8_t m) const {
    const int k = m < last ? m : last;
    return {static_cast<uint8_t>(__ldg(tab + k)), __ldg(tab + L + k) != 0,
            __ldg(tab + 2 * L + k)};
  }

  __device__ __forceinline__ uint8_t key_byte(uint8_t m, uint8_t kpos) const {
    const int k = m < last ? m : last;
    const int j = kpos < max_key_len - 1 ? kpos : max_key_len - 1;
    return __ldg(keys + static_cast<int64_t>(k) * max_key_len + j);
  }
};

// The automaton's carry for one row (get_json._automaton_pieces'
// make_carry0), plus the cached lookups of segment min(matched, L - 1) and
// the subscript flag of segment min(matched + 1, L - 1).
struct Scan {
  bool in_str = false, esc = false, in_key = false, key_ok = true;
  bool await_colon = false, capturing = false, elem_pending = false;
  bool found = false, bad = false, pending = false, cap_is_str = false;
  bool expect_key = false, deep = false;
  uint8_t depth = 0, matched = 0, key_pos = 0, cap_depth = 0;
  int32_t elem_count = 0, start = -1, end = -1;
  Seg cur;
  bool next_idx;
};

__device__ __forceinline__ void step(Scan& s, const Path& path, int32_t pos,
                                     uint8_t x) {
  const bool is_q = x == '"';
  const bool is_bs = x == '\\';
  const bool is_ws = x == 32 || x == 9 || x == 10 || x == 13;
  const bool is_open = x == '{' || x == '[';
  const bool is_close = x == '}' || x == ']';
  const bool is_colon = x == ':';
  const bool is_comma = x == ',';

  const bool in_str = s.in_str;
  const bool esc = s.esc;
  const bool eff_q = is_q && !esc;
  const bool outside = !in_str;

  const uint8_t depth = s.depth;
  const bool opens = outside && is_open;
  const bool deep = s.deep || (opens && depth >= 250);
  const uint8_t new_depth = static_cast<uint8_t>(
      depth + ((opens && depth < 250) ? 1 : 0) -
      ((outside && is_close) ? 1 : 0));

  const uint8_t matched0 = s.matched;
  const bool capturing0 = s.capturing;
  const bool found0 = s.found;
  const bool at_frontier = depth == static_cast<uint8_t>(matched0 + 1);

  // --- key scanning at the frontier
  const bool key_opening = outside && eff_q && s.expect_key && !s.in_key &&
                           !s.await_colon && !capturing0 && !found0 &&
                           at_frontier;
  const bool key_char = s.in_key && in_str && !eff_q;
  const Seg cur = s.cur;
  bool key_ok = s.key_ok;
  uint8_t key_pos = s.key_pos;
  if (key_char) {
    const bool ok_char = key_pos < cur.len &&
                         x == path.key_byte(matched0, key_pos) && !esc;
    key_ok = key_ok && ok_char;
    key_pos = static_cast<uint8_t>(key_pos + 1);
  }
  const bool key_closing = s.in_key && eff_q && in_str;
  const bool full_match = key_closing && key_ok && key_pos == cur.len;
  bool await_colon = key_closing ? full_match : s.await_colon;
  const bool in_key = (s.in_key || key_opening) && !key_closing;
  if (key_opening) key_pos = 0;
  key_ok = key_ok || key_opening;

  // --- value entry after a matched key's colon
  const bool saw_colon = s.await_colon && outside && is_colon;
  await_colon = await_colon && !saw_colon;
  const bool pending = s.pending || saw_colon;
  const bool key_value_starts = pending && !is_ws && !saw_colon;

  // --- element entry at an index segment's frontier array
  const bool fr_is_idx = cur.is_idx;
  const bool elem_value_starts = s.elem_pending && fr_is_idx && outside &&
                                 !is_ws && !is_comma && !is_close &&
                                 at_frontier && !capturing0 && !found0;
  const bool value_starts = key_value_starts || elem_value_starts;

  const bool is_last = matched0 == path.last;
  const uint8_t expected_open = s.next_idx ? '[' : '{';
  const bool live = !capturing0 && !found0;
  const bool descend = value_starts && !is_last && x == expected_open && live;
  const bool deadend = value_starts && !is_last && x != expected_open && live;
  const bool start_cap = value_starts && is_last && live;
  const uint8_t matched = static_cast<uint8_t>(matched0 + (descend ? 1 : 0));
  const bool exhausted = outside && is_close && !capturing0 && matched0 > 0 &&
                         new_depth == matched0 && !found0;
  s.pending = pending && !(value_starts || deadend);
  s.bad = s.bad || deadend || exhausted;

  // --- the element counter: commas at the frontier array's depth
  const bool elem_comma = outside && is_comma && fr_is_idx && at_frontier &&
                          !capturing0 && !found0;
  int32_t elem_count = s.elem_count + (elem_comma ? 1 : 0);
  bool elem_pending = elem_comma ? elem_count == cur.tgt
                                 : (s.elem_pending && !elem_value_starts);

  // --- key position for the (possibly new) frontier
  if (descend) {
    s.cur = path.at(matched);
    s.next_idx = path.at(static_cast<uint8_t>(matched + 1)).is_idx;
  }
  const Seg nxt = s.cur;
  const uint8_t new_frontier = static_cast<uint8_t>(matched + 1);
  const bool opens_frontier = outside && x == '{' &&
                              new_depth == new_frontier && !nxt.is_idx;
  const bool comma_frontier = outside && is_comma && depth == new_frontier &&
                              !capturing0 && !nxt.is_idx;
  const bool clears_key_pos =
      !is_ws && outside && !eff_q && !is_open && !is_comma;
  s.expect_key = opens_frontier || comma_frontier ||
                 (s.expect_key && !(key_opening || clears_key_pos));

  // entering the frontier array arms the element counter
  const bool arr_open = outside && x == '[' && nxt.is_idx &&
                        new_depth == new_frontier && !capturing0 && !found0;
  if (arr_open) {
    elem_count = 0;
    elem_pending = nxt.tgt == 0;
  }

  // --- capture start and end
  int32_t start = s.start;
  uint8_t cap_depth = s.cap_depth;
  bool cap_is_str = s.cap_is_str;
  if (start_cap) {
    start = pos;
    cap_depth = depth;
    cap_is_str = is_q;
  }
  const bool capturing = capturing0 || start_cap;
  const bool started = capturing && start >= 0 && !found0;
  const bool cont_end = started && outside && is_close &&
                        new_depth == cap_depth && pos > start;
  const bool scalar_term = started && !cap_is_str && outside &&
                           (is_comma || is_close) && depth == cap_depth &&
                           pos > start;
  const bool str_end = started && cap_is_str && eff_q && in_str && pos > start;
  const bool ends_now = cont_end || scalar_term || str_end;
  if (ends_now) s.end = (scalar_term && !cont_end && !str_end) ? pos : pos + 1;

  s.found = found0 || ends_now;
  s.capturing = capturing && !ends_now;
  s.in_str = in_str != eff_q;
  s.esc = in_str && !esc && is_bs;
  s.depth = new_depth;
  s.deep = deep;
  s.matched = matched;
  s.in_key = in_key;
  s.key_pos = key_pos;
  s.key_ok = key_ok;
  s.await_colon = await_colon;
  s.elem_count = elem_count;
  s.elem_pending = elem_pending;
  s.start = start;
  s.cap_depth = cap_depth;
  s.cap_is_str = cap_is_str;
}

template <bool kWords>
__global__ void __launch_bounds__(kThreads)
gjo_scan_kernel(const uint8_t* __restrict__ ch, int64_t pitch, int64_t n,
                int32_t W, Path path, int32_t* __restrict__ out) {
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint8_t* p = ch + row * pitch;
  Scan s;
  s.cur = path.at(0);
  s.next_idx = path.at(1).is_idx;
  int32_t pos = 0;
  if (kWords) {
    // rows and their pitch are 4-byte aligned: one load per four chars
    const uint32_t* w = reinterpret_cast<const uint32_t*>(p);
    for (const int32_t whole = W & ~3; pos < whole; pos += 4) {
      const uint32_t word = __ldg(w + (pos >> 2));
#pragma unroll
      for (int b = 0; b < 4; ++b)
        step(s, path, pos + b, static_cast<uint8_t>(word >> (8 * b)));
    }
  }
  for (; pos < W; ++pos) step(s, path, pos, __ldg(p + pos));
  out[row] = s.start;
  out[n + row] = s.end;
  out[2 * n + row] = s.found;
  out[3 * n + row] = s.capturing;
  out[4 * n + row] = s.bad;
  out[5 * n + row] = s.deep;
}

}  // namespace

// Scans n rows of W chars (row r at ch + r * pitch) with the path whose
// tables are `keys` (uint8 [L, max_key_len]) and `tab` (int32 [3, L]: key
// lengths, subscript flags, subscripts), both on the card, into out (int32
// [6, n]).  1 <= L <= 256, 1 <= max_key_len <= 254.  Launches on stream, of
// card `device`, and returns the launch's cudaError_t (0, launching
// nothing, when n == 0).
extern "C" int srj_gjo_scan(const void* ch, int64_t pitch, int64_t n,
                            int32_t W, const void* keys, int max_key_len,
                            const void* tab, int L, void* out, int device,
                            void* stream) {
  if (n <= 0) return 0;
  if (L < 1 || L > 256 || max_key_len < 1 || max_key_len > 254 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Path path{static_cast<const uint8_t*>(keys),
                  static_cast<const int32_t*>(tab), L, max_key_len,
                  static_cast<uint8_t>(L - 1)};
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  const auto* c = static_cast<const uint8_t*>(ch);
  const bool words = (reinterpret_cast<uintptr_t>(ch) & 3) == 0 &&
                     (pitch & 3) == 0;
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (words)
    gjo_scan_kernel<true><<<blocks, kThreads, 0, s>>>(c, pitch, n, W, path, o);
  else
    gjo_scan_kernel<false><<<blocks, kThreads, 0, s>>>(c, pitch, n, W, path,
                                                       o);
  return static_cast<int>(cudaGetLastError());
}
