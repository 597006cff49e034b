// gjo_scan: get_json_object's path automaton over dense-padded char rows,
// for sm_90a.
//
// Replaces: spark_rapids_jni_tpu/ops/pallas_kernels.py::_gjo_scan_kernel
// (pallas_call at pallas_kernels.py:771).  The TPU kernel holds a [W, tile]
// transposed char tile in VMEM, rows as lanes, and replays the JAX
// package's select-only step (get_json._automaton_pieces) once per char
// column inside a fori_loop; its per-level lookups are select-sums because
// TPU gathers are slow, and its window is capped at 32 KiB by VMEM
// (_gjo_sig_eligible).  Here one thread walks one row at its own position
// and runs the step only for the chars that can change the automaton's
// carry: a run of chars that leaves the carry as it is (a string's body, the
// zeros after a document) is skipped, up to 16 chars at a time.  No cap on
// the window or the path beyond the JAX package's own (at most 256
// segments, keys of at most 254 bytes).
//
// Per row and stepped char, in order, the step of
// get_json._automaton_pieces: string and escape state, the uint8 depth
// (opens past 250 saturate and set `deep`; a close at depth 0 wraps to 255),
// key scanning at the match frontier, the value after a matched key's colon
// or at the subscript's element, descent into the next segment's container,
// dead ends, the element counter of an index segment, key position
// tracking, the capture and its end.  Every uint8 carry wraps as in the JAX
// package: each sum is cast back to uint8_t before it is compared.  The
// whole window is scanned, padding zeros included (a zero is an "other" char
// to the automaton), and null rows are scanned like any other.  Output:
// int32 [6, n], the rows start, end, found, capturing, bad and deep (the
// Pallas output's layout).
//
// Bound: bytes.  A row of W chars is read once (W bytes) and six words are
// written: 0.31 ms for 1M rows of 1 KiB at 3.35 TB/s.  The function needs
// little arithmetic for most chars: inside a string (most of a document)
// only a quote test and a backslash test, four chars to one SIMD byte
// compare (chip_smoke.py's GJO_LEAST_OPS_4_CHARS), far under the bytes.
//
// Design for that bound: the step is some 300 instructions (chip_smoke.py's
// GJO_STEP, from the SASS), so the kernel runs it as rarely as the carry
// allows, and runs a short one where it can.
//  - Each thread loads its row 16 chars at a time (one 16-byte load where
//    the pointer and pitch allow it, else four words or sixteen bytes) and
//    marks, with SIMD byte compares, the chars of the chunk that a quiet
//    carry must still step (`chunk_stops`).
//  - Each iteration of a thread's loop skips the quiet chars from its
//    position (at most to the chunk's end) and steps the next char, so a
//    warp takes about max over its rows of (stepped chars + chunks that end
//    quiet) iterations, not W steps.  The chunk stays in registers until
//    the position leaves it.
//  - The step classifies its char from a 256-entry table in shared memory,
//    and keeps the boolean carry as bits of one word; depth, matched,
//    key_pos and cap_depth stay uint8.
//  - A row whose value is found (with no key, colon or value pending) can
//    change only in_str, esc, depth, deep and expect_key: step_found
//    computes just those, in some 60 instructions.
// A window's last W % 16 chars are stepped one by one.  The lookups of the
// current path segment are cached in registers and reloaded only when a row
// descends a level, and a key byte is read only for a char inside a key at
// the frontier.  128 threads a block.  Row offsets are int64_t: n * pitch
// passes 2^31.

#include <cstdint>

#include "launch.cuh"

namespace {

// threads a block (64 and 256 timed within 1.3% of it on the H100)
constexpr int kThreads = 128;
constexpr int kChunk = 16;

// char classes: the bits of the shared-memory table's entries
enum : uint32_t {
  kQuote = 1u << 0,
  kBackslash = 1u << 1,
  kSpace = 1u << 2,    // ' ', '\t', '\n', '\r'
  kOpen = 1u << 3,     // '{' or '['
  kClose = 1u << 4,    // '}' or ']'
  kColon = 1u << 5,
  kComma = 1u << 6,
  kBracket = 1u << 7,  // '[' (with kOpen)
};

__device__ __forceinline__ uint32_t char_class(uint32_t x) {
  return (x == '"' ? kQuote : 0u) | (x == '\\' ? kBackslash : 0u) |
         (x == ' ' || x == '\t' || x == '\n' || x == '\r' ? kSpace : 0u) |
         (x == '{' || x == '[' ? kOpen : 0u) |
         (x == '}' || x == ']' ? kClose : 0u) | (x == ':' ? kColon : 0u) |
         (x == ',' ? kComma : 0u) | (x == '[' ? kBracket : 0u);
}

// the boolean carry, one bit each (get_json._automaton_pieces' make_carry0
// names), and two cached lookups: whether segment min(matched, L - 1) and
// segment min(matched + 1, L - 1) are subscripts
enum : uint32_t {
  kInStr = 1u << 0,
  kEsc = 1u << 1,
  kInKey = 1u << 2,
  kKeyOk = 1u << 3,
  kAwaitColon = 1u << 4,
  kCapturing = 1u << 5,
  kElemPending = 1u << 6,
  kFound = 1u << 7,
  kBad = 1u << 8,
  kPending = 1u << 9,
  kCapIsStr = 1u << 10,
  kExpectKey = 1u << 11,
  kDeep = 1u << 12,
  kCurIdx = 1u << 13,
  kNextIdx = 1u << 14,
};

__device__ __forceinline__ uint32_t bit_if(bool c, uint32_t b) {
  return c ? b : 0u;
}

// The path's tables: key bytes [L, max_key_len], then int32 [3, L] of key
// lengths, subscript flags and subscripts.
struct Path {
  const uint8_t* keys;
  const int32_t* tab;
  int L;
  int max_key_len;
  uint8_t last;  // uint8(L - 1), L <= 256

  // segment min(m, L - 1), as the JAX package's _select_lut reads it
  __device__ __forceinline__ int seg(uint8_t m) const {
    return m < last ? m : last;
  }
  __device__ __forceinline__ uint8_t len(uint8_t m) const {
    return static_cast<uint8_t>(__ldg(tab + seg(m)));
  }
  __device__ __forceinline__ bool is_idx(uint8_t m) const {
    return __ldg(tab + L + seg(m)) != 0;
  }
  __device__ __forceinline__ int32_t tgt(uint8_t m) const {
    return __ldg(tab + 2 * L + seg(m));
  }
  __device__ __forceinline__ uint8_t key_byte(uint8_t m, uint8_t kpos) const {
    const int j = kpos < max_key_len - 1 ? kpos : max_key_len - 1;
    return __ldg(keys + static_cast<int64_t>(seg(m)) * max_key_len + j);
  }
};

// The automaton's carry for one row, plus the cached key length and
// subscript of segment min(matched, L - 1).
struct Scan {
  uint32_t f;
  uint8_t depth, matched, key_pos, cap_depth, cur_len;
  int32_t cur_tgt, elem_count, start, end;

  __device__ __forceinline__ explicit Scan(const Path& path)
      : f(kKeyOk | bit_if(path.is_idx(0), kCurIdx) |
          bit_if(path.is_idx(1), kNextIdx)),
        depth(0), matched(0), key_pos(0), cap_depth(0), cur_len(path.len(0)),
        cur_tgt(path.tgt(0)), elem_count(0), start(-1), end(-1) {}
};

// When a run of chars leaves every field of Scan as it is (derived from
// step() below, field by field), so that the kernel may skip it.
//
// In a string (in_str, !esc, !in_key, !pending), a char that is neither '"'
// nor '\\' (zeros included):
//   eff_q = 0 and outside = 0, so in_str stays set; esc = in_str && !esc &&
//   is_bs stays 0; depth and deep need `outside`; key_opening needs
//   `outside`, key_char and key_closing need in_key, so in_key, key_pos,
//   key_ok and await_colon stay; saw_colon needs `outside`, so pending
//   stays 0 and key_value_starts = pending && ... is 0 (a pending value
//   would start at any non-space char: hence !pending); elem_value_starts,
//   elem_comma, opens_frontier, comma_frontier, clears_key_pos and arr_open
//   all need `outside`, so elem_pending, elem_count, expect_key and matched
//   stay and nothing descends or dead-ends (bad stays); start_cap is 0, so
//   start, cap_depth and cap_is_str stay; cont_end and scalar_term need
//   `outside`, str_end needs eff_q, so end, found and capturing stay (an
//   open string capture included).
//
// Settled outside a string (!in_str, !esc, !pending, !expect_key, and not
// elem_pending at an index segment's frontier), a char outside
// '"' '{' '[' '}' ']' ':' ',' (spaces, zeros and a scalar's chars):
//   eff_q = 0, so in_str stays 0 and esc = in_str && ... stays 0 (!esc is
//   the carry's own value); not an open or a close, so depth, deep,
//   exhausted, cont_end and scalar_term stay put; key_opening needs eff_q,
//   key_char and key_closing need in_str: in_key, key_pos, key_ok and
//   await_colon stay; saw_colon needs ':', so pending stays 0 and
//   key_value_starts is 0; elem_value_starts needs elem_pending && cur is a
//   subscript && at_frontier, which the test excludes (depth and matched do
//   not change in the run, so at_frontier does not either); so nothing
//   descends, dead-ends or starts a capture (matched, bad, start,
//   cap_depth, cap_is_str stay); elem_comma and comma_frontier need ',',
//   opens_frontier and arr_open an open: elem_count and elem_pending stay;
//   expect_key = ... || (expect_key && ...) stays 0 (the first non-space
//   char would clear a set expect_key: hence !expect_key); str_end needs
//   eff_q, so end, found and capturing stay.
//
// Every other carry steps every char.
__device__ __forceinline__ bool quiet_in_string(const Scan& s) {
  return (s.f & (kInStr | kEsc | kInKey | kPending)) == kInStr;
}

__device__ __forceinline__ bool quiet_settled(const Scan& s) {
  const bool elem_frontier =
      (s.f & (kElemPending | kCurIdx)) == (kElemPending | kCurIdx) &&
      s.depth == static_cast<uint8_t>(s.matched + 1);
  return (s.f & (kInStr | kEsc | kPending | kExpectKey)) == 0 &&
         !elem_frontier;
}

// 0x80 in each byte of v that is zero, 0 in every other byte (no carry
// crosses a byte: (v & 0x7F) + 0x7F is at most 0xFE)
__device__ __forceinline__ uint32_t zero_bytes(uint32_t v) {
  return ~(((v & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | v) & 0x80808080u;
}

// bit k for byte k of a word of zero_bytes flags
__device__ __forceinline__ uint32_t byte_bits(uint32_t z) {
  return (z * 0x00204081u) >> 28;
}

// The chars of a chunk (bit k for char k) that a quiet carry steps: in a
// string '"' and '\\'; settled outside one '"' ',' ':' and every char c
// with (c | 0x26) == 0x7F, which are '[' ']' '{' '}' and 'Y' '_' 'y' DEL.
__device__ __forceinline__ void chunk_stops(const uint4& c,
                                            uint32_t& in_string,
                                            uint32_t& settled) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
  in_string = 0;
  settled = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t q = zero_bytes(w[k] ^ 0x22222222u);
    const uint32_t b = zero_bytes(w[k] ^ 0x5C5C5C5Cu);
    const uint32_t s = q | zero_bytes(w[k] ^ 0x2C2C2C2Cu) |
                       zero_bytes(w[k] ^ 0x3A3A3A3Au) |
                       zero_bytes((w[k] | 0x26262626u) ^ 0x7F7F7F7Fu);
    in_string |= byte_bits(q | b) << (4 * k);
    settled |= byte_bits(s) << (4 * k);
  }
}

template <int kAlign>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* p) {
  if constexpr (kAlign == 16) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (kAlign == 4) {
        w[k] = __ldg(reinterpret_cast<const uint32_t*>(p) + k);
      } else {
        w[k] = __ldg(p + 4 * k) | (__ldg(p + 4 * k + 1) << 8) |
               (__ldg(p + 4 * k + 2) << 16) |
               (static_cast<uint32_t>(__ldg(p + 4 * k + 3)) << 24);
      }
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__device__ __forceinline__ uint32_t char_at(const uint4& c, int i) {
  const uint32_t w = (i & 8) ? ((i & 4) ? c.w : c.z) : ((i & 4) ? c.y : c.x);
  return (w >> (8 * (i & 3))) & 0xFFu;
}

__device__ __forceinline__ void step(Scan& s, const Path& path,
                                     const uint8_t* cls, int32_t pos,
                                     uint32_t x) {
  const uint32_t c = cls[x];
  const uint32_t f = s.f;
  const bool is_q = c & kQuote;
  const bool is_bs = c & kBackslash;
  const bool is_ws = c & kSpace;
  const bool is_open = c & kOpen;
  const bool is_close = c & kClose;
  const bool is_colon = c & kColon;
  const bool is_comma = c & kComma;
  const bool is_lbracket = c & kBracket;
  const bool is_lbrace = is_open && !is_lbracket;

  const bool in_str = f & kInStr;
  const bool esc = f & kEsc;
  const bool eff_q = is_q && !esc;
  const bool outside = !in_str;

  const uint8_t depth = s.depth;
  const bool opens = outside && is_open;
  const bool deep = (f & kDeep) || (opens && depth >= 250);
  const uint8_t new_depth = static_cast<uint8_t>(
      depth + ((opens && depth < 250) ? 1 : 0) -
      ((outside && is_close) ? 1 : 0));

  const uint8_t matched0 = s.matched;
  const bool live = !(f & (kCapturing | kFound));
  const bool at_frontier = depth == static_cast<uint8_t>(matched0 + 1);
  const bool in_key0 = f & kInKey;
  const bool await0 = f & kAwaitColon;

  // --- key scanning at the frontier
  const bool key_opening = outside && eff_q && (f & kExpectKey) && !in_key0 &&
                           !await0 && live && at_frontier;
  const bool key_char = in_key0 && in_str && !eff_q;
  bool key_ok = f & kKeyOk;
  uint8_t key_pos = s.key_pos;
  if (key_char) {
    const bool ok_char = key_pos < s.cur_len &&
                         x == path.key_byte(matched0, key_pos) && !esc;
    key_ok = key_ok && ok_char;
    key_pos = static_cast<uint8_t>(key_pos + 1);
  }
  const bool key_closing = in_key0 && eff_q && in_str;
  const bool full_match = key_closing && key_ok && key_pos == s.cur_len;
  bool await_colon = key_closing ? full_match : await0;
  const bool in_key = (in_key0 || key_opening) && !key_closing;
  if (key_opening) key_pos = 0;
  key_ok = key_ok || key_opening;

  // --- value entry after a matched key's colon
  const bool saw_colon = await0 && outside && is_colon;
  await_colon = await_colon && !saw_colon;
  const bool pending = (f & kPending) || saw_colon;
  const bool key_value_starts = pending && !is_ws && !saw_colon;

  // --- element entry at an index segment's frontier array
  const bool fr_is_idx = f & kCurIdx;
  const bool elem_pending0 = f & kElemPending;
  const bool elem_value_starts = elem_pending0 && fr_is_idx && outside &&
                                 !is_ws && !is_comma && !is_close &&
                                 at_frontier && live;
  const bool value_starts = key_value_starts || elem_value_starts;

  const bool is_last = matched0 == path.last;
  const bool is_expected_open = (f & kNextIdx) ? is_lbracket : is_lbrace;
  const bool descend = value_starts && !is_last && is_expected_open && live;
  const bool deadend = value_starts && !is_last && !is_expected_open && live;
  const bool start_cap = value_starts && is_last && live;
  const uint8_t matched = static_cast<uint8_t>(matched0 + (descend ? 1 : 0));
  const bool exhausted = outside && is_close && !(f & kCapturing) &&
                         matched0 > 0 && new_depth == matched0 &&
                         !(f & kFound);
  const bool pending_out = pending && !(value_starts || deadend);
  const bool bad = (f & kBad) || deadend || exhausted;

  // --- the element counter: commas at the frontier array's depth
  const bool elem_comma =
      outside && is_comma && fr_is_idx && at_frontier && live;
  int32_t elem_count = s.elem_count + (elem_comma ? 1 : 0);
  bool elem_pending = elem_comma ? elem_count == s.cur_tgt
                                 : (elem_pending0 && !elem_value_starts);

  // --- key position for the (possibly new) frontier
  uint32_t idx_bits = f & (kCurIdx | kNextIdx);
  if (descend) {
    s.cur_len = path.len(matched);
    s.cur_tgt = path.tgt(matched);
    idx_bits = bit_if(path.is_idx(matched), kCurIdx) |
               bit_if(path.is_idx(static_cast<uint8_t>(matched + 1)),
                      kNextIdx);
  }
  const bool nxt_is_idx = idx_bits & kCurIdx;
  const uint8_t new_frontier = static_cast<uint8_t>(matched + 1);
  const bool opens_frontier =
      outside && is_lbrace && new_depth == new_frontier && !nxt_is_idx;
  const bool comma_frontier = outside && is_comma && depth == new_frontier &&
                              !(f & kCapturing) && !nxt_is_idx;
  const bool clears_key_pos =
      !is_ws && outside && !eff_q && !is_open && !is_comma;
  const bool expect_key =
      opens_frontier || comma_frontier ||
      ((f & kExpectKey) && !(key_opening || clears_key_pos));

  // entering the frontier array arms the element counter
  const bool arr_open = outside && is_lbracket && nxt_is_idx &&
                        new_depth == new_frontier && live;
  if (arr_open) {
    elem_count = 0;
    elem_pending = s.cur_tgt == 0;
  }

  // --- capture start and end
  int32_t start = s.start;
  uint8_t cap_depth = s.cap_depth;
  bool cap_is_str = f & kCapIsStr;
  if (start_cap) {
    start = pos;
    cap_depth = depth;
    cap_is_str = is_q;
  }
  const bool found0 = f & kFound;
  const bool capturing = (f & kCapturing) || start_cap;
  const bool started = capturing && start >= 0 && !found0;
  const bool cont_end = started && outside && is_close &&
                        new_depth == cap_depth && pos > start;
  const bool scalar_term = started && !cap_is_str && outside &&
                           (is_comma || is_close) && depth == cap_depth &&
                           pos > start;
  const bool str_end = started && cap_is_str && eff_q && in_str && pos > start;
  const bool ends_now = cont_end || scalar_term || str_end;
  if (ends_now) s.end = (scalar_term && !cont_end && !str_end) ? pos : pos + 1;

  s.f = idx_bits | bit_if(in_str != eff_q, kInStr) |
        bit_if(in_str && !esc && is_bs, kEsc) | bit_if(in_key, kInKey) |
        bit_if(key_ok, kKeyOk) | bit_if(await_colon, kAwaitColon) |
        bit_if(capturing && !ends_now, kCapturing) |
        bit_if(elem_pending, kElemPending) |
        bit_if(found0 || ends_now, kFound) | bit_if(bad, kBad) |
        bit_if(pending_out, kPending) | bit_if(cap_is_str, kCapIsStr) |
        bit_if(expect_key, kExpectKey) | bit_if(deep, kDeep);
  s.depth = new_depth;
  s.matched = matched;
  s.key_pos = key_pos;
  s.elem_count = elem_count;
  s.start = start;
  s.cap_depth = cap_depth;
}

// The step of a row whose value is found, with no key, colon or value
// pending: it changes only in_str, esc, depth, deep and expect_key.  From
// step() with found0 (so live is 0) and !in_key, !await_colon, !pending:
// key_opening needs live, key_char and key_closing need in_key, so in_key,
// key_pos, key_ok and await_colon stay; saw_colon needs await_colon, so
// pending stays 0 and key_value_starts is 0; elem_value_starts, elem_comma
// and arr_open need live, so nothing descends, dead-ends or starts a capture
// and matched, bad, elem_count, elem_pending, the cached lookups, start,
// cap_depth and cap_is_str stay; exhausted needs !found; started needs
// !found, so end, found and capturing stay.  What is left is step()'s own
// arithmetic for the five fields, key_opening being 0.
__device__ __forceinline__ void step_found(Scan& s, uint32_t c) {
  const uint32_t f = s.f;
  const bool in_str = f & kInStr;
  const bool esc = f & kEsc;
  const bool eff_q = (c & kQuote) && !esc;
  const bool outside = !in_str;
  const uint8_t depth = s.depth;
  const bool opens = outside && (c & kOpen);
  const uint8_t new_depth = static_cast<uint8_t>(
      depth + ((opens && depth < 250) ? 1 : 0) -
      ((outside && (c & kClose)) ? 1 : 0));
  const uint8_t frontier = static_cast<uint8_t>(s.matched + 1);
  const bool key_level = !(f & kCurIdx);
  const bool opens_frontier = outside && (c & (kOpen | kBracket)) == kOpen &&
                              new_depth == frontier && key_level;
  const bool comma_frontier = outside && (c & kComma) && depth == frontier &&
                              !(f & kCapturing) && key_level;
  const bool clears_key_pos =
      !(c & (kSpace | kOpen | kComma)) && outside && !eff_q;
  const bool expect_key = opens_frontier || comma_frontier ||
                          ((f & kExpectKey) && !clears_key_pos);
  s.f = (f & ~(kInStr | kEsc | kExpectKey)) |
        bit_if(in_str != eff_q, kInStr) |
        bit_if(in_str && !esc && (c & kBackslash), kEsc) |
        bit_if(expect_key, kExpectKey) |
        bit_if(opens && depth >= 250, kDeep);
  s.depth = new_depth;
}

__device__ __forceinline__ void advance(Scan& s, const Path& path,
                                        const uint8_t* cls, int32_t pos,
                                        uint32_t x) {
  if ((s.f & (kFound | kInKey | kAwaitColon | kPending)) == kFound)
    step_found(s, cls[x]);
  else
    step(s, path, cls, pos, x);
}

// kAlign: 16 when every row starts 16-byte aligned, 4 when 4-byte aligned,
// else 1; the chunks are loaded accordingly.
template <int kAlign>
__global__ void __launch_bounds__(kThreads)
gjo_scan_kernel(const uint8_t* __restrict__ ch, int64_t pitch, int64_t n,
                int32_t W, Path path, int32_t* __restrict__ out) {
  __shared__ uint8_t cls[256];
  for (int i = threadIdx.x; i < 256; i += kThreads)
    cls[i] = static_cast<uint8_t>(char_class(i));
  __syncthreads();
  const int64_t row =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint8_t* p = ch + row * pitch;
  Scan s(path);
  const int32_t whole = W & ~(kChunk - 1);
  int32_t pos = 0;
  uint4 chunk = make_uint4(0u, 0u, 0u, 0u);
  uint32_t str_stops = 0, out_stops = 0;
  while (pos < whole) {
    const int off = pos & (kChunk - 1);
    if (off == 0) {
      chunk = load_chunk<kAlign>(p + pos);
      chunk_stops(chunk, str_stops, out_stops);
    }
    // the chars from `off` to the chunk's end that this carry steps (bit
    // 16: the chunk's end); the quiet ones before the first are skipped
    const uint32_t stops = quiet_in_string(s) ? str_stops
                           : quiet_settled(s) ? out_stops
                                              : 0xFFFFu;
    const int at = __ffs((stops | 0x10000u) >> off) - 1 + off;
    pos += at - off;
    if (at == kChunk) continue;
    advance(s, path, cls, pos, char_at(chunk, at));
    ++pos;
  }
  for (; pos < W; ++pos) advance(s, path, cls, pos, __ldg(p + pos));
  const uint32_t f = s.f;
  out[row] = s.start;
  out[n + row] = s.end;
  out[2 * n + row] = (f & kFound) ? 1 : 0;
  out[3 * n + row] = (f & kCapturing) ? 1 : 0;
  out[4 * n + row] = (f & kBad) ? 1 : 0;
  out[5 * n + row] = (f & kDeep) ? 1 : 0;
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
  const uint64_t where = reinterpret_cast<uintptr_t>(ch) |
                         static_cast<uint64_t>(pitch);
  auto* o = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if ((where & 15) == 0)
    gjo_scan_kernel<16><<<blocks, kThreads, 0, s>>>(c, pitch, n, W, path, o);
  else if ((where & 3) == 0)
    gjo_scan_kernel<4><<<blocks, kThreads, 0, s>>>(c, pitch, n, W, path, o);
  else
    gjo_scan_kernel<1><<<blocks, kThreads, 0, s>>>(c, pitch, n, W, path, o);
  return static_cast<int>(cudaGetLastError());
}
