// Native pre-tokenizer: the three tiktoken regex pattern generations as
// hand-rolled scanners over UTF-8, plus single-pass piece deduplication.
//
// This is the TPU framework's native host component (SURVEY.md §2.2):
// the reference's pre-split runs a backtracking regex engine
// (TokenizerBuilder.cs:112,140; tokenizerBuilder.ts:66-89) at a few
// MB/s; these scanners implement the exact same leftmost-alternation
// and backtracking semantics deterministically at memory speed.
//
// Pattern semantics are derived from models/registry.py
// REGEX_PATTERN_1/2/3 (which reproduce the reference byte-for-byte) and
// validated by differential fuzzing against the python `regex` module
// (tests/test_native_presplit.py).  Unicode classes come from
// unicode_tables.h, generated by querying that same module per
// codepoint, so host and native agree on every character.
//
// Build: g++ -O3 -shared -fPIC presplit.cpp -o libttpresplit.so

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

// Vector fast path: one vpermi2b is a full 128-entry ASCII class-table
// lookup for 64 bytes at once (AVX-512BW + VBMI, present on the target
// fleet's Ice-Lake-and-later hosts; the scalar loops below remain the
// portable fallback when built without -march=native).
#if defined(__AVX512BW__) && defined(__AVX512VBMI__)
#define TT_SIMD 1
#include <immintrin.h>
#else
#define TT_SIMD 0
#endif

#include "unicode_tables.h"

#define F_L 0x01   // \p{L}
#define F_N 0x02   // \p{N}
#define F_S 0x04   // \s
#define F_UPR 0x08 // [\p{Lu}\p{Lt}\p{Lm}\p{Lo}\p{M}]
#define F_LWR 0x10 // [\p{Ll}\p{Lm}\p{Lo}\p{M}]

namespace {

struct Cp {
  uint32_t cp;
  int len;     // bytes consumed (>=1 even on invalid input)
  uint8_t fl;  // class flags
};

// Flat ASCII class table (== tt_uc_flags for cp < 128): skips the
// two-level page lookup on the dominant path.
static uint8_t g_ascii[128];
#if TT_SIMD
// The same table split for vpermi2b: low 7 bits of each input byte
// index across the two 64-byte halves, giving per-byte class flags for
// a whole cache line in one instruction (non-ASCII lanes produce
// garbage there and are masked via the sign bit).
alignas(64) static uint8_t g_tbl_lo[64];
alignas(64) static uint8_t g_tbl_hi[64];
#endif
static const bool g_ascii_init = [] {
  for (uint32_t c = 0; c < 128; c++) g_ascii[c] = tt_uc_flags(c);
#if TT_SIMD
  for (uint32_t c = 0; c < 64; c++) {
    g_tbl_lo[c] = g_ascii[c];
    g_tbl_hi[c] = g_ascii[c + 64];
  }
#endif
  return true;
}();

#if TT_SIMD
// Stop mask for a 64-byte window at s+i (clamped to n): bit k set where
// byte i+k is NOT an ASCII byte whose class flags intersect ``mask`` —
// i.e. where a run_while(mask) scan must leave the vector path (ASCII
// class fail, non-ASCII byte needing a real decode, or end of input).
// ``invert`` flips the class test for run_other-style scans (stop where
// flags DO intersect).
template <bool invert>
static inline uint64_t tt_stop64(const uint8_t* s, int64_t i, int64_t n,
                                 uint8_t mask) {
  int64_t rem = n - i;
  __mmask64 lm =
      rem >= 64 ? ~0ULL : (~0ULL >> (64 - (unsigned)rem));
  __m512i v = _mm512_maskz_loadu_epi8(lm, s + i);
  uint64_t nonascii = _mm512_movepi8_mask(v);  // sign bit: byte >= 0x80
  __m512i fl = _mm512_permutex2var_epi8(
      _mm512_load_si512(g_tbl_lo), v, _mm512_load_si512(g_tbl_hi));
  uint64_t has =
      _mm512_test_epi8_mask(fl, _mm512_set1_epi8((char)mask));
  uint64_t fail = invert ? has : ~has;
  return ((fail | nonascii) & lm) | ~(uint64_t)lm;
}
#endif

// Decode one codepoint at s[i]; invalid sequences advance one byte with
// class 0 (the python path never produces them — str.encode is strict).
static inline Cp decode(const uint8_t* s, int64_t i, int64_t n) {
  Cp r;
  uint8_t b0 = s[i];
  if (b0 < 0x80) {
    r.cp = b0;
    r.len = 1;
    r.fl = g_ascii[b0];
    return r;
  }
  if ((b0 >> 5) == 0x6 && i + 1 < n && (s[i + 1] & 0xC0) == 0x80) {
    r.cp = ((b0 & 0x1F) << 6) | (s[i + 1] & 0x3F);
    r.len = 2;
  } else if ((b0 >> 4) == 0xE && i + 2 < n && (s[i + 1] & 0xC0) == 0x80 &&
             (s[i + 2] & 0xC0) == 0x80) {
    r.cp = ((b0 & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
    r.len = 3;
  } else if ((b0 >> 3) == 0x1E && i + 3 < n && (s[i + 1] & 0xC0) == 0x80 &&
             (s[i + 2] & 0xC0) == 0x80 && (s[i + 3] & 0xC0) == 0x80) {
    r.cp = ((b0 & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
           ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    r.len = 4;
  } else {
    r.cp = 0xFFFFFFFFu;
    r.len = 1;
    r.fl = 0;
    return r;
  }
  r.fl = tt_uc_flags(r.cp);
  return r;
}

static inline uint8_t flags_at(const uint8_t* s, int64_t i, int64_t n) {
  return (i < n) ? decode(s, i, n).fl : 0;
}

// ---- shared run scanners -------------------------------------------------

static inline int64_t run_while(const uint8_t* s, int64_t i, int64_t n,
                                uint8_t mask) {
#if TT_SIMD
  while (i < n) {
    uint64_t stop = tt_stop64<false>(s, i, n, mask);
    if (!stop) {
      i += 64;
      continue;
    }
    i += __builtin_ctzll(stop);
    if (i >= n || s[i] < 0x80) return i;  // EOI or ASCII class fail
    // Non-ASCII stretch: decode scalar until ASCII resumes.
    do {
      Cp c = decode(s, i, n);
      if (!(c.fl & mask)) return i;
      i += c.len;
    } while (i < n && s[i] >= 0x80);
  }
  return i;
#else
  while (i < n) {
    // ASCII fast loop: one table byte per input byte, no decode struct.
    uint8_t b0 = s[i];
    if (b0 < 0x80) {
      if (!(g_ascii[b0] & mask)) break;
      i++;
      continue;
    }
    Cp c = decode(s, i, n);
    if (!(c.fl & mask)) break;
    i += c.len;
  }
  return i;
#endif
}

// "other" for pattern1 alt4 / pattern2-3 alt "other": not \s, \p{L}, \p{N}.
static inline int64_t run_other(const uint8_t* s, int64_t i, int64_t n) {
#if TT_SIMD
  while (i < n) {
    uint64_t stop = tt_stop64<true>(s, i, n, F_S | F_L | F_N);
    if (!stop) {
      i += 64;
      continue;
    }
    i += __builtin_ctzll(stop);
    if (i >= n || s[i] < 0x80) return i;
    do {
      Cp c = decode(s, i, n);
      if (c.fl & (F_S | F_L | F_N)) return i;
      i += c.len;
    } while (i < n && s[i] >= 0x80);
  }
  return i;
#else
  while (i < n) {
    uint8_t b0 = s[i];
    if (b0 < 0x80) {
      if (g_ascii[b0] & (F_S | F_L | F_N)) break;
      i++;
      continue;
    }
    Cp c = decode(s, i, n);
    if (c.fl & (F_S | F_L | F_N)) break;
    i += c.len;
  }
  return i;
#endif
}

static inline bool is_crlf(uint32_t cp) { return cp == '\r' || cp == '\n'; }

// Contractions.  Pattern 1: lowercase only ('s|'t|'re|'ve|'m|'ll|'d).
// Returns bytes matched after the apostrophe, 0 if none.
static inline int contraction1(const uint8_t* s, int64_t i, int64_t n) {
  if (i >= n) return 0;
  uint8_t c1 = s[i];
  uint8_t c2 = (i + 1 < n) ? s[i + 1] : 0;
  switch (c1) {
    case 's': case 't': case 'm': case 'd': return 1;
    case 'r': return c2 == 'e' ? 2 : 0;
    case 'v': return c2 == 'e' ? 2 : 0;
    case 'l': return c2 == 'l' ? 2 : 0;
    default: return 0;
  }
}

// Patterns 2/3: the TS-enumerated case list (tokenizerBuilder.ts:73):
// 's|'S|'t|'T|'re|'RE|'Re|'eR|'ve|'VE|'vE|'Ve|'m|'M|'ll|'lL|'Ll|'LL|'d|'D
// (note the asymmetric 'eR and the absent 'rE).
static inline int contraction2(const uint8_t* s, int64_t i, int64_t n) {
  if (i >= n) return 0;
  uint8_t c1 = s[i];
  uint8_t c2 = (i + 1 < n) ? s[i + 1] : 0;
  switch (c1) {
    case 's': case 'S': case 't': case 'T':
    case 'm': case 'M': case 'd': case 'D': return 1;
    case 'r': return c2 == 'e' ? 2 : 0;
    case 'R': return (c2 == 'E' || c2 == 'e') ? 2 : 0;
    case 'e': return c2 == 'R' ? 2 : 0;
    case 'v': return (c2 == 'e' || c2 == 'E') ? 2 : 0;
    case 'V': return (c2 == 'E' || c2 == 'e') ? 2 : 0;
    case 'l': return (c2 == 'l' || c2 == 'L') ? 2 : 0;
    case 'L': return (c2 == 'l' || c2 == 'L') ? 2 : 0;
    default: return 0;
  }
}

// ---- whitespace alternatives ---------------------------------------------

// Maximal \s run from i; records the byte offset of the run's LAST
// codepoint (needed because \s+(?!\S) backs off one CODEPOINT, and
// whitespace like U+00A0/U+3000 is multi-byte).
static inline int64_t ws_run(const uint8_t* s, int64_t i, int64_t n,
                             int64_t* last_start) {
  int64_t last = i, j = i;
#if TT_SIMD
  for (;;) {
    // Vector over the ASCII-whitespace stretch (each byte is its own
    // codepoint, so ``last`` is simply the stretch's final byte).
    while (j < n) {
      uint64_t stop = tt_stop64<false>(s, j, n, F_S);
      if (!stop) {
        last = j + 63;
        j += 64;
        continue;
      }
      int k = (int)__builtin_ctzll(stop);
      if (k > 0) {
        last = j + k - 1;
        j += k;
      }
      break;
    }
    if (j >= n || s[j] < 0x80) break;  // EOI or ASCII non-ws
    Cp c = decode(s, j, n);
    if (!(c.fl & F_S)) break;
    last = j;
    j += c.len;
  }
#else
  while (j < n) {
    uint8_t b0 = s[j];
    if (b0 < 0x80) {
      if (!(g_ascii[b0] & F_S)) break;
      last = j;
      j++;
      continue;
    }
    Cp c = decode(s, j, n);
    if (!(c.fl & F_S)) break;
    last = j;
    j += c.len;
  }
#endif
  *last_start = last;
  return j;
}

// \s+(?!\S) | \s+  given the maximal ws run [i, e) and end-of-input n.
// (Callers have already rejected earlier alternatives.)
static inline int64_t ws_tail(int64_t i, int64_t e, int64_t last_start,
                              int64_t n) {
  if (e >= n) return e;        // \s+(?!\S) matches the whole run at EOF
  if (last_start > i) return last_start;  // leave the last ws codepoint
  return e;                    // single-codepoint run: plain \s+
}

// \s*[\r\n]+ over the maximal ws run [i, e): match ends after the LAST
// CR/LF codepoint in the run (backtracking: largest \s* split whose
// remainder starts with [\r\n]).  Returns -1 if the run has no CR/LF.
static inline int64_t ws_nl(const uint8_t* s, int64_t i, int64_t e) {
  int64_t last = -1;
  int64_t j = i;
  while (j < e) {
    uint8_t b0 = s[j];
    if (b0 < 0x80) {
      j++;
      if (b0 == '\r' || b0 == '\n') last = j;
      continue;
    }
    Cp c = decode(s, j, e);
    j += c.len;
    if (is_crlf(c.cp)) last = j;
  }
  return last;
}

// ---- pattern 1: gpt2/r50k/p50k -------------------------------------------
// 's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+

static int64_t next_piece_p1(const uint8_t* s, int64_t i, int64_t n) {
  Cp c = decode(s, i, n);
  if (c.cp == '\'') {
    int k = contraction1(s, i + 1, n);
    if (k) return i + 1 + k;
  }
  if (c.cp == ' ' && i + 1 < n) {
    Cp c2 = decode(s, i + 1, n);
    if (c2.fl & F_L) return run_while(s, i + 1, n, F_L);
    if (c2.fl & F_N) return run_while(s, i + 1, n, F_N);
    if (!(c2.fl & F_S)) return run_other(s, i + 1, n);
  }
  if (c.fl & F_L) return run_while(s, i, n, F_L);
  if (c.fl & F_N) return run_while(s, i, n, F_N);
  if (!(c.fl & F_S)) return run_other(s, i, n);
  int64_t last;
  int64_t e = ws_run(s, i, n, &last);
  return ws_tail(i, e, last, n);
}

// ---- pattern 2: cl100k ---------------------------------------------------
// (?:contraction2)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}
//   | ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+

static int64_t next_piece_p2(const uint8_t* s, int64_t i, int64_t n) {
  Cp c = decode(s, i, n);
  if (c.cp == '\'') {
    int k = contraction2(s, i + 1, n);
    if (k) return i + 1 + k;
  }
  // [^\r\n\p{L}\p{N}]?\p{L}+  (prefix may be any char incl. whitespace
  // except CR/LF; the ? is greedy).
  if (c.fl & F_L) return run_while(s, i, n, F_L);
  if (!is_crlf(c.cp) && !(c.fl & (F_L | F_N)) && i + c.len < n) {
    if (flags_at(s, i + c.len, n) & F_L)
      return run_while(s, i + c.len, n, F_L);
  }
  // \p{N}{1,3}
  if (c.fl & F_N) {
    int64_t j = i;
    for (int k = 0; k < 3 && j < n; k++) {
      Cp d = decode(s, j, n);
      if (!(d.fl & F_N)) break;
      j += d.len;
    }
    return j;
  }
  //  ?[^\s\p{L}\p{N}]+[\r\n]*
  {
    int64_t q = -1;
    if (!(c.fl & (F_S | F_L | F_N))) {
      q = i;
    } else if (c.cp == ' ' && i + 1 < n) {
      uint8_t f2 = flags_at(s, i + 1, n);
      if (!(f2 & (F_S | F_L | F_N))) q = i + 1;
    }
    if (q >= 0) {
      int64_t e = run_other(s, q, n);
      while (e < n && (s[e] == '\r' || s[e] == '\n')) e++;
      return e;
    }
  }
  // whitespace alternatives
  int64_t last;
  int64_t e = ws_run(s, i, n, &last);
  int64_t nl = ws_nl(s, i, e);  // \s*[\r\n]+
  if (nl >= 0) return nl;
  return ws_tail(i, e, last, n);
}

// ---- pattern 3: o200k ----------------------------------------------------
// [^\r\n\p{L}\p{N}]?[UPR]*[LWR]+(?:c2)? | [^\r\n\p{L}\p{N}]?[UPR]+[LWR]*(?:c2)?
//   |\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+

// [UPR]*[LWR]+ from q; -1 on fail.  Greedy A* with full backtracking:
// regex tries the longest A-prefix whose successor can start LWR+.  If
// no LWR follows the maximal UPR run, the winning split puts the run's
// LAST both-class codepoint (LWR ∩ UPR: Lm/Lo/M) into LWR+, and the
// match ends right after it (its successor is UPR-only by maximality).
// The ASCII stretch vectorizes (same shape as ws_run): no ASCII char is
// both-class (LWR ∩ UPR is Lm/Lo/M, all non-ASCII), so ``last_b_end``
// tracking is only needed on the scalar non-ASCII path.
static int64_t rest_lower(const uint8_t* s, int64_t q, int64_t n) {
  int64_t j = q, last_b_end = -1;
  // Dominant case (` word`): an ASCII lowercase head means the greedy
  // [UPR]* prefix is empty — skip its probe entirely.
  if (q < n && s[q] >= 'a' && s[q] <= 'z')
    return run_while(s, q, n, F_LWR);
#if TT_SIMD
  for (;;) {
    while (j < n) {
      uint64_t stop = tt_stop64<false>(s, j, n, F_UPR);
      if (!stop) {
        j += 64;
        continue;
      }
      j += __builtin_ctzll(stop);
      break;
    }
    if (j >= n || s[j] < 0x80) break;  // EOI or ASCII non-UPR
    Cp c = decode(s, j, n);
    if (!(c.fl & F_UPR)) break;
    j += c.len;
    if (c.fl & F_LWR) last_b_end = j;
  }
#else
  while (j < n) {
    uint8_t b0 = s[j];
    if (b0 < 0x80) {  // ASCII fast loop: never both-class
      if (!(g_ascii[b0] & F_UPR)) break;
      j++;
      continue;
    }
    Cp c = decode(s, j, n);
    if (!(c.fl & F_UPR)) break;
    j += c.len;
    if (c.fl & F_LWR) last_b_end = j;
  }
#endif
  int64_t b_end = run_while(s, j, n, F_LWR);
  if (b_end > j) return b_end;  // A* = full run, LWR+ after it
  return last_b_end;            // ends after the last both-class cp, or -1
}

// [UPR]+[LWR]* from q; -1 on fail.
static inline int64_t rest_upper(const uint8_t* s, int64_t q, int64_t n) {
  int64_t a_end = run_while(s, q, n, F_UPR);
  if (a_end == q) return -1;
  return run_while(s, a_end, n, F_LWR);
}

static inline int64_t add_contraction2(const uint8_t* s, int64_t e, int64_t n) {
  if (e < n && s[e] == '\'') {
    int k = contraction2(s, e + 1, n);
    if (k) return e + 1 + k;
  }
  return e;
}

static int64_t next_piece_p3(const uint8_t* s, int64_t i, int64_t n) {
  Cp c = decode(s, i, n);
  bool prefixable = !is_crlf(c.cp) && !(c.fl & (F_L | F_N));

  // Class dispatch replaces the naive try-every-alternative order
  // (exactly equivalent, ~2x fewer scanner calls on mixed text):
  //  * every letter carries F_UPR or F_LWR (Lu/Lt -> UPR, Ll -> LWR,
  //    Lm/Lo/M -> both), so the NO-PREFIX letter alts can only match
  //    when c is a letter;
  //  * the WITH-prefix alts require ``prefixable`` (c not a letter);
  //  * a pure-LWR start means alt1's greedy [UPR]* prefix is empty —
  //    the match is simply the LWR+ run.
  if (c.fl & F_LWR) {
    if (!(c.fl & F_UPR)) {  // pure lowercase: alt1 with empty A*
      int64_t e = run_while(s, i, n, F_LWR);
      return add_contraction2(s, e, n);
    }
    int64_t e = rest_lower(s, i, n);  // both-class start
    if (e >= 0) return add_contraction2(s, e, n);
    e = rest_upper(s, i, n);
    if (e >= 0) return add_contraction2(s, e, n);
  } else if (c.fl & F_UPR) {
    int64_t e = rest_lower(s, i, n);
    if (e >= 0) return add_contraction2(s, e, n);
    e = rest_upper(s, i, n);
    if (e >= 0) return add_contraction2(s, e, n);
  } else if (prefixable && i + c.len < n &&
             (flags_at(s, i + c.len, n) & (F_UPR | F_LWR))) {
    // alt1/alt2 with the optional one-char prefix (greedy ?) — both
    // need a [UPR]/[LWR]-class char right after the prefix (letters
    // and marks: the pattern's classes include \p{M}, which is NOT
    // \p{L}), so one class lookup gates up to four scanner probes
    // (digits/punct after a space).
    int64_t e = rest_lower(s, i + c.len, n);
    if (e >= 0) return add_contraction2(s, e, n);
    e = rest_upper(s, i + c.len, n);
    if (e >= 0) return add_contraction2(s, e, n);
  }
  // \p{N}{1,3}
  if (c.fl & F_N) {
    int64_t j = i;
    for (int k = 0; k < 3 && j < n; k++) {
      Cp d = decode(s, j, n);
      if (!(d.fl & F_N)) break;
      j += d.len;
    }
    return j;
  }
  //  ?[^\s\p{L}\p{N}]+[\r\n/]*
  {
    int64_t q = -1;
    if (!(c.fl & (F_S | F_L | F_N))) {
      q = i;
    } else if (c.cp == ' ' && i + 1 < n) {
      uint8_t f2 = flags_at(s, i + 1, n);
      if (!(f2 & (F_S | F_L | F_N))) q = i + 1;
    }
    if (q >= 0) {
      int64_t e = run_other(s, q, n);
      while (e < n && (s[e] == '\r' || s[e] == '\n' || s[e] == '/')) e++;
      return e;
    }
  }
  int64_t last;
  int64_t e = ws_run(s, i, n, &last);
  int64_t nl = ws_nl(s, i, e);
  if (nl >= 0) return nl;
  return ws_tail(i, e, last, n);
}

typedef int64_t (*next_fn)(const uint8_t*, int64_t, int64_t);

static inline next_fn pick(int pattern) {
  switch (pattern) {
    case 1: return next_piece_p1;
    case 2: return next_piece_p2;
    case 3: return next_piece_p3;
    default: return nullptr;
  }
}

// Long-piece interning hash (pieces > 8 bytes): 8 bytes per round of
// xor-multiply-shift, ~8x fewer dependent ops than a per-byte chain on
// the multi-hundred-byte `\p{L}+` runs CJK text produces.  Only
// internal consistency within one process matters (the table never
// leaves the Ctx); the memcmp in the probe is the correctness arbiter.
static inline uint64_t long_hash(const uint8_t* s, int64_t a, int64_t b) {
  uint64_t h = 0x9E3779B97F4A7C15ULL ^ (uint64_t)(b - a);
  int64_t i = a;
  for (; i + 8 <= b; i += 8) {
    uint64_t x;
    memcpy(&x, s + i, 8);
    h = (h ^ x) * 0xFF51AFD7ED558CCDULL;
    h ^= h >> 29;
  }
  if (i < b) {
    uint64_t x = 0;
    memcpy(&x, s + i, (size_t)(b - i));
    h = (h ^ x) * 0xFF51AFD7ED558CCDULL;
    h ^= h >> 29;
  }
  return h;
}

// Raw padded 8-byte key of a short piece (len <= 8).  MUST be
// position-independent: the same bytes give the same value whether
// loaded wide mid-buffer or byte-copied at a buffer tail, so dedup
// never splits a piece into two uids.  The wide-load+mask path keeps
// the LOW n bytes, which equal the tail byte-copy only on a
// little-endian host; (key8, len) equality is the sole correctness
// arbiter for short pieces, so refuse to build big-endian.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "load_key8 wide/tail paths agree only on little-endian");
static inline uint64_t load_key8(const uint8_t* s, int64_t i, int64_t n,
                                 int64_t bufend) {
  uint64_t x = 0;
  if (i + 8 <= bufend) {
    memcpy(&x, s + i, 8);
    if (n < 8) x &= (1ULL << (8 * n)) - 1;
  } else {
    memcpy(&x, s + i, (size_t)n);
  }
  return x;
}

// Short-piece interning hash: one multiply + shift over the padded key.
// (key8, len) is the FULL content of a short piece, so equal (key8,
// len) is equality itself — the probe needs no byte compare at all.
// Regex pieces average ~4 bytes, where a serial per-byte chain
// dominates; short pieces hash with one wide load, one multiply and
// one shift instead (only internal consistency matters).
static inline uint64_t short_hash(uint64_t key8, int64_t n) {
  uint64_t x = key8 ^ ((uint64_t)n << 56);
  x *= 0x9E3779B97F4A7C15ULL;
  return x ^ (x >> 32);
}

}  // namespace

extern "C" {

// Scan [start, end) of buf with the given pattern (1, 2 or 3); write
// piece END byte offsets into out_ends (capacity cap).  Returns the
// piece count, or -1 on bad pattern, or -2 if cap was insufficient.
int64_t tt_presplit(const uint8_t* buf, int64_t start, int64_t end,
                    int pattern, int32_t* out_ends, int64_t cap) {
  next_fn next = pick(pattern);
  if (!next) return -1;
  if (end > (int64_t)INT32_MAX) return -5;  // int32 piece offsets
  int64_t count = 0;
  int64_t i = start;
  while (i < end) {
    int64_t e = next(buf, i, end);
    if (e <= i) e = i + 1;  // defensive: always progress
    if (count >= cap) return -2;
    out_ends[count++] = (int32_t)e;
    i = e;
  }
  return count;
}

// The host fallback for pieces longer than the widest device bucket
// (pathological p50k digit runs, no-whitespace CJK sentences).  Exact
// tiktoken semantics (BytePairEncoder.cs:45-64) via the same
// (left_id,right_id)->merged_id open-addressed table the device probes
// (ops/pair_table.py — identical uint32 hash), reformulated as a lazy
// min-heap keyed ((rank<<32)|position): rank-ascending then
// position-ascending pops reproduce the reference scan's strict-<
// first-minimal-index tie break, and only the two pair ranks adjacent
// to a merge are recomputed — O(n log n) instead of the reference's
// O(n^2) rescans, with bit-identical output.

static inline int32_t tt_pair_rank(int32_t l, int32_t r, const int32_t* kl,
                                   const int32_t* kr, const int32_t* vv,
                                   int32_t slot_bits, int32_t max_probes) {
  const int32_t MAXR = 0x7FFFFFFF;
  uint32_t h = ((uint32_t)l * 0x85EBCA6Bu) ^ ((uint32_t)r * 0xC2B2AE35u);
  h ^= h >> 16;
  uint32_t slot = (uint32_t)(((uint64_t)h * 0x9E3779B9u & 0xFFFFFFFFu)) >>
                  (32 - slot_bits);
  uint32_t mask = ((uint32_t)1 << slot_bits) - 1;
  for (int32_t p = 0; p < max_probes; p++) {
    int32_t k1 = kl[slot];
    if (k1 == -1) return MAXR;  // stop at empty
    if (k1 == l && kr[slot] == r) return vv[slot];
    slot = (slot + 1) & mask;
  }
  return MAXR;
}

namespace {

// Reusable per-thread merge scratch: the per-call vector/priority_queue
// allocations dominated short-piece merges (~100 us/piece measured
// through ctypes), so the batch entry point amortizes them away.
// Thread-local BYTE-pair rank memo: every piece's FIRST probe round is
// byte-id x byte-id (the byte-to-id map covers 0..255), so a direct
// collision-free 256x256 table answers roughly half of all probes from
// L2 after warm-up — no tags, no eviction, no pollution from the
// diverse merged-id pairs (a tagged hash memo measured SLOWER because
// high-id pairs kept evicting the hot byte pairs).  Ranks are
// immutable per vocabulary; -2 marks unfilled (ranks are >= 0, misses
// store MAX_RANK).
constexpr int64_t BP_MEMO = 256 * 256;  // int32 -> 256 KB per thread

// Second memo tier for MERGED-id pairs (the byte-pair table above
// deliberately excludes them): long-piece merges — CJK/no-space runs —
// re-probe the same few thousand (char_id, char_id) / (mid_id,
// byte_id) pairs across every piece of a script.  A small SEPARATE
// tagged direct-mapped cache serves those from L2.  Separate is the
// point: an earlier experiment that shared ONE table measured slower
// because high-id pairs evicted the hot byte pairs (comment above).
// MEASURED (r5 A/B, this box): cold e2e NEUTRAL (72 vs 73 MB/s ± run
// noise, steady unchanged) — the CI box's 260 MB L3 keeps the whole
// 25 MB pair table cache-resident, so the probes this tier
// short-circuits were already ~L3-cheap.  Kept because production
// hosts with ordinary (1–2 MB/core) L3 pay DRAM per probe, which is
// exactly the case this tier converts to an L2 hit; worst case
// (one-shot pairs) is ~2 ALU + one L2 line per miss.
// Thread-private via BpeScratch; ranks immutable per vocab.
struct PairMemoEnt {
  int32_t l, r, rank;  // l == -1 marks empty (ids are >= 0)
};
constexpr int64_t PM2_SLOTS = 1 << 14;  // 12 B/entry -> 192 KB

struct BpeScratch {
  std::vector<int32_t> id, prev, next, rank;
  std::vector<uint8_t> alive;
  std::vector<uint64_t> heap;  // manual binary min-heap, capacity reused
  std::vector<int32_t> bpm;    // lazily sized byte-pair memo
  std::vector<PairMemoEnt> pm2;  // lazily sized merged-pair memo

  int32_t* memo() {
    if (bpm.empty()) bpm.assign(BP_MEMO, -2);
    return bpm.data();
  }
  PairMemoEnt* memo2() {
    if (pm2.empty()) pm2.assign(PM2_SLOTS, PairMemoEnt{-1, -1, 0});
    return pm2.data();
  }
};

static inline int32_t pair_rank_memo(int32_t l, int32_t r,
                                     const int32_t* kl, const int32_t* kr,
                                     const int32_t* vv, int32_t slot_bits,
                                     int32_t max_probes, int32_t* pm,
                                     PairMemoEnt* pm2) {
  if (((uint32_t)l | (uint32_t)r) < 256) {
    int32_t& e = pm[(l << 8) | r];
    if (e != -2) return e;
    e = tt_pair_rank(l, r, kl, kr, vv, slot_bits, max_probes);
    return e;
  }
  uint32_t h = ((uint32_t)l * 0x85EBCA6Bu) ^ ((uint32_t)r * 0xC2B2AE35u);
  h ^= h >> 16;
  PairMemoEnt& e = pm2[h & (PM2_SLOTS - 1)];
  if (e.l == l && e.r == r) return e.rank;
  int32_t v = tt_pair_rank(l, r, kl, kr, vv, slot_bits, max_probes);
  e.l = l;
  e.r = r;
  e.rank = v;
  return v;
}

static inline void heap_push(std::vector<uint64_t>& h, uint64_t v) {
  h.push_back(v);
  size_t i = h.size() - 1;
  while (i > 0) {
    size_t p = (i - 1) / 2;
    if (h[p] <= h[i]) break;
    std::swap(h[p], h[i]);
    i = p;
  }
}

static inline uint64_t heap_pop(std::vector<uint64_t>& h) {
  uint64_t top = h[0];
  h[0] = h.back();
  h.pop_back();
  size_t i = 0, n = h.size();
  for (;;) {
    size_t l = 2 * i + 1, r = l + 1, m = i;
    if (l < n && h[l] < h[m]) m = l;
    if (r < n && h[r] < h[m]) m = r;
    if (m == i) break;
    std::swap(h[i], h[m]);
    i = m;
  }
  return top;
}

// Small-piece merge: regex pieces average ~4 bytes, where the heap
// reformulation's allocation/lazy-invalidation machinery costs ~690 ns
// per piece (measured) — the reference's own O(n^2) first-min scan
// (BytePairEncoder.cs:45-64) over stack arrays is both bit-exact BY
// CONSTRUCTION and several times faster at n <= 16 (<= 15 merges x
// <= 15-wide scans in registers).  MEASURED threshold: 48 was SLOWER
// (2585 vs 2147 ns/piece on realistic 41-byte-avg cold uniques — the
// O(n^2) rescans overtake the heap's machinery well before that), so
// 16 stands.
static inline int64_t bpe_merge_small(const uint8_t* piece, int64_t n,
                                      const int32_t* byte_to_id,
                                      const int32_t* kl, const int32_t* kr,
                                      const int32_t* vv, int32_t slot_bits,
                                      int32_t max_probes, int32_t* out,
                                      int64_t out_cap, int32_t* pm,
                                      PairMemoEnt* pm2) {
  const int32_t MAXR = 0x7FFFFFFF;
  int32_t id[16];
  int32_t rank[16];
  int m = (int)n;
  for (int i = 0; i < m; i++) id[i] = byte_to_id[piece[i]];
  for (int i = 0; i < m - 1; i++)
    rank[i] = pair_rank_memo(id[i], id[i + 1], kl, kr, vv, slot_bits,
                             max_probes, pm, pm2);
  for (;;) {
    int32_t best = MAXR;
    int bj = -1;
    for (int i = 0; i < m - 1; i++)
      if (rank[i] < best) {  // strict <: first-minimal-index tie break
        best = rank[i];
        bj = i;
      }
    if (bj < 0) break;
    id[bj] = best;  // the pair table maps to the merged token id
    for (int i = bj + 1; i < m - 1; i++) id[i] = id[i + 1];
    for (int i = bj + 1; i < m - 2; i++) rank[i] = rank[i + 1];
    m--;
    // Re-rank only (bj-1, bj) and (bj, bj+1) — BytePairEncoder.cs:55-64.
    if (bj < m - 1)
      rank[bj] = pair_rank_memo(id[bj], id[bj + 1], kl, kr, vv, slot_bits,
                                max_probes, pm, pm2);
    if (bj > 0)
      rank[bj - 1] = pair_rank_memo(id[bj - 1], id[bj], kl, kr, vv,
                                    slot_bits, max_probes, pm, pm2);
  }
  if (out_cap < m) return -1;
  memcpy(out, id, (size_t)m * sizeof(int32_t));
  return m;
}

// Exact tiktoken merge of one piece into out; returns ids written or
// -1 on out_cap overflow.  Scratch reused across calls.
static int64_t bpe_merge_core(const uint8_t* piece, int64_t n,
                              const int32_t* byte_to_id, const int32_t* kl,
                              const int32_t* kr, const int32_t* vv,
                              int32_t slot_bits, int32_t max_probes,
                              int32_t* out, int64_t out_cap,
                              BpeScratch& s) {
  const int32_t MAXR = 0x7FFFFFFF;
  if (n <= 0) return 0;
  if (out_cap < 1) return -1;
  if (n == 1) {
    out[0] = byte_to_id[piece[0]];
    return 1;
  }
  if (n <= 16)
    return bpe_merge_small(piece, n, byte_to_id, kl, kr, vv, slot_bits,
                           max_probes, out, out_cap, s.memo(), s.memo2());
  s.id.resize(n);
  s.prev.resize(n);
  s.next.resize(n);
  s.rank.resize(n);
  s.alive.assign(n, 1);
  s.heap.clear();
  auto& id = s.id;
  auto& prev = s.prev;
  auto& next = s.next;
  auto& rank = s.rank;
  auto& alive = s.alive;
  auto& heap = s.heap;
  for (int64_t i = 0; i < n; i++) {
    id[i] = byte_to_id[piece[i]];
    prev[i] = (int32_t)i - 1;
    next[i] = (i + 1 < n) ? (int32_t)(i + 1) : -1;
  }
  int32_t* pm = s.memo();
  PairMemoEnt* pm2 = s.memo2();
  for (int64_t i = 0; i + 1 < n; i++) {
    rank[i] = pair_rank_memo(id[i], id[i + 1], kl, kr, vv, slot_bits,
                             max_probes, pm, pm2);
    if (rank[i] != MAXR)
      heap_push(heap, ((uint64_t)(uint32_t)rank[i] << 32) | (uint32_t)i);
  }
  rank[n - 1] = MAXR;
  while (!heap.empty()) {
    uint64_t top = heap_pop(heap);
    int32_t pos = (int32_t)(top & 0xFFFFFFFFu);
    int32_t r = (int32_t)(top >> 32);
    // Lazy invalidation: the entry is live iff the position is alive
    // and still carries exactly this rank.
    if (!alive[pos] || rank[pos] != r) continue;
    // Merge pos with its successor; the merged segment's id IS the
    // rank value (the pair table maps to the merged token id).
    int32_t nx = next[pos];
    id[pos] = r;
    alive[nx] = 0;
    next[pos] = next[nx];
    if (next[nx] != -1) prev[next[nx]] = pos;
    // Re-rank only (pos-1, pos) and (pos, pos+1) —
    // BytePairEncoder.cs:55-64.
    int32_t nn = next[pos];
    rank[pos] = (nn == -1) ? MAXR
                           : pair_rank_memo(id[pos], id[nn], kl, kr, vv,
                                            slot_bits, max_probes, pm, pm2);
    if (rank[pos] != MAXR)
      heap_push(heap,
                ((uint64_t)(uint32_t)rank[pos] << 32) | (uint32_t)pos);
    int32_t pv = prev[pos];
    if (pv != -1) {
      rank[pv] = pair_rank_memo(id[pv], id[pos], kl, kr, vv, slot_bits,
                                max_probes, pm, pm2);
      if (rank[pv] != MAXR)
        heap_push(heap,
                  ((uint64_t)(uint32_t)rank[pv] << 32) | (uint32_t)pv);
    }
  }
  int64_t w = 0;
  for (int32_t p = 0; p != -1; p = next[p]) {
    if (w >= out_cap) return -1;
    out[w++] = id[p];
  }
  return w;
}

}  // namespace

// ---- scan counters -------------------------------------------------------
// The first-seen work of a cold scan, counted where it happens.  The
// split entry points (tt_ctx_split_batch, tt_ctx_split_merge_batch,
// tt_ctx_split_emit_batch) and tt_bpe_encode_batch take a nullable
// ``int64_t* counters`` as their last argument: SC_COUNT slots indexed
// by ScanCounter; null means no counting.  Each worker counts into slots
// of its own, and the caller's array is ADDED to after the join, so
// calls accumulate and the scan path takes no atomic.  Times are
// steady_clock nanoseconds, read only around first-seen work (an intern
// miss, a fused merge, a long-piece merge) and once per call and worker,
// never on a memo hit or on the staged resolve of a known uid.  A
// worker's times are thread time: summed over workers they exceed a
// call's wall.  SCAN_COUNTERS in runtime/native/__init__.py names the
// slots in this order, an *_NS slot as *_s (reported in seconds).
enum ScanCounter {
  // split calls
  SC_CALLS,
  SC_CALL_NS,      // their wall, entry to return
  SC_WORKERS,      // worker threads they ran (the caller's own thread: 1)
  SC_BUSY_NS,      // the workers' busy time, summed
  SC_BUSIEST_NS,   // each call's busiest worker, summed over calls
  // interning (ctx_insert; lock-free but for growth, see Ctx).  The
  // names date from when every insert took Ctx::mu.
  SC_INTERN_LOCKS,    // misses in the worker's snapshot that took the
                      // insert path (inserts, plus pieces it then found)
  SC_INSERTS,         // inserts that created a uid (won a slot's claim)
  SC_INTERN_NS,       // the insert path, entry to return: probe, claim,
                      // writes, and every wait and rebuild below
  SC_INTERN_WAIT_NS,  // its waiting: for a claimed slot's uid, for
                      // Ctx::mu before a growth, for another's rebuild
  SC_REBUILDS,        // snapshot rebuilds (slots or arena full)
  SC_REBUILD_NS,      // their time (drain included), a part of
                      // SC_INTERN_NS
  // fused first-seen merges (fuse_new_piece): count, bytes, ns of each
  // class; the ns include a merge that then deferred, and the probe of
  // an old generation that missed
  SC_FUSED_SHORT, SC_FUSED_SHORT_BYTES, SC_FUSED_SHORT_NS,  // <= 16 bytes:
                                                            // bpe_merge_small
  SC_FUSED_LONG, SC_FUSED_LONG_BYTES, SC_FUSED_LONG_NS,  // the heap merge
  SC_GEN_COPIES, SC_GEN_COPY_BYTES, SC_GEN_COPY_NS,  // old-generation rows
  // first-seen pieces deferred to the news list, by reason
  SC_DEFER_OFF,       // fusing off: no FuseState, or row_cap 0 (device route)
  SC_DEFER_CAPACITY,  // the uid table or the row matrix is full
  SC_DEFER_WIDE,      // the merge (or the old generation's row) is wider
                      // than a row
  // emit mode
  SC_PATCHES,  // holes written
  SC_STAGED,   // staged pieces resolved from the uid table or the rows
  // tt_bpe_encode_batch
  SC_BPE_CALLS,
  SC_BPE_PIECES,
  SC_BPE_BYTES,
  SC_BPE_MERGE_NS,    // merge time, summed over pieces
  SC_BPE_CALL_NS,     // the calls' wall
  SC_BPE_LONGEST_NS,  // each call's longest single piece, summed over calls
  // a first-seen piece deferred to the news list unmerged because it is
  // longer than the fused calls' ``defer_len`` (ABI 14; after the slots
  // above so that they keep their index)
  SC_DEFER_LONG,
  SC_COUNT
};
static_assert(SC_FUSED_LONG == SC_FUSED_SHORT + 3 &&
                  SC_GEN_COPIES == SC_FUSED_LONG + 3,
              "each merge class is (count, bytes, ns)");

namespace {

static inline int64_t now_ns() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

// One worker's slots; a cache line apart from its neighbours'.
struct alignas(64) ScanSlots {
  int64_t v[SC_COUNT] = {};
};

// Adds a call's count and wall to ``counters`` (nullable) when it ends.
struct CallTimer {
  int64_t* c;
  int calls, ns;
  int64_t t0;
  CallTimer(int64_t* c_, int calls_, int ns_)
      : c(c_), calls(calls_), ns(ns_), t0(c_ ? now_ns() : 0) {}
  ~CallTimer() {
    if (c) {
      c[calls] += 1;
      c[ns] += now_ns() - t0;
    }
  }
};

// Adds the first ``n`` workers' slots to ``counters``: every slot summed
// but ``max_dst``, which gets the largest ``max_src`` of a worker.
static void add_worker_counts(int64_t* counters,
                              const std::vector<ScanSlots>& tc, int n,
                              int max_src, int max_dst) {
  int64_t most = 0;
  for (int t = 0; t < n; t++) {
    for (int s = 0; s < SC_COUNT; s++)
      if (s != max_dst) counters[s] += tc[(size_t)t].v[s];
    most = std::max(most, tc[(size_t)t].v[max_src]);
  }
  counters[max_dst] += most;
}

}  // namespace

// ---- persistent split+dedup context --------------------------------------
// Long-lived interning table: piece bytes -> stable uid (0,1,2,...).
// Each call scans a buffer, writes per-piece uids, and reports which
// uids are NEW (first seen), with their byte ranges in the current
// buffer so the caller can fetch the bytes.  Piece bytes are copied
// into an internal arena so dedup spans calls and buffers.
//
// Concurrency model (the batch entry point scans segments on multiple
// threads with the inner loop fully fused — scan, hash, probe):
//   * lookups are lock-free: probe a Snapshot (slot array + arena),
//     whose slots hold a uid, EMPTY (-1) or CLAIMED (-2); a probe that
//     meets either of the last two reports a miss;
//   * a miss takes the insert path (ctx_insert), also lock-free: it
//     enters the CURRENT snapshot (Snap::inflight), probes again, and at
//     the first EMPTY slot of the piece's run CLAIMS it by a
//     compare-and-swap EMPTY -> CLAIMED.  The winner then takes its uid
//     (n_ent.fetch_add, so uids stay dense: a uid is taken only after a
//     claim succeeds), writes len and key8 (a long piece: the arena
//     bytes, whose range it reserved from arena_len before the claim),
//     and PUBLISHES the uid last, with release ordering.  A loser, or
//     any inserter that meets a CLAIMED slot, spins (pause, then yield)
//     until the uid is published and compares as usual, so a piece
//     never gets two uids: every inserter of a piece walks the same run
//     and slots only ever go EMPTY -> CLAIMED -> uid.  A reader that
//     acquires a uid sees the slot's len, key8 and arena bytes whole;
//   * Ctx::mu serializes growth alone.  An insert that would cross the
//     load limit (half the slots) or the arena's capacity leaves its
//     snapshot and grows it under the mutex: SEAL it (no insert enters
//     a sealed snapshot; one that tries waits for the mutex, then
//     retries on the new snapshot), drain Snap::inflight to zero (the
//     inserters still writing into it finish; none of them waits on
//     anything but another in-flight claim), copy it into a larger
//     snapshot (the slots, the arena or both doubled), and publish
//     that with release ordering.
//     Superseded snapshots are retired, never freed while the context
//     lives, so readers of an old one stay valid: they can miss a fresh
//     entry, which just routes them through the insert path, which
//     hands them the current snapshot for their next probes.
// The first snapshot is large enough that a cold pass over 8 MB of
// text grows nothing (tt_ctx_new), so the cold scan's threads meet only
// at a slot both want, and a warm scan inserts nothing at all.

namespace {

constexpr int32_t SLOT_EMPTY = -1;
constexpr int32_t SLOT_CLAIMED = -2;

struct SlotRec {
  // SLOT_EMPTY, SLOT_CLAIMED (an insert is writing the slot), or the
  // piece's uid, published LAST (release).
  std::atomic<int32_t> uid;
  int32_t len;
  // len <= 8: key8 holds the piece bytes INLINE (zero-padded) — the
  // probe compares it directly, touching no second cache line.  The
  // dominant warm-path cost used to be the dependent arena-byte miss
  // after the (prefetched) slot load; short pieces (avg ~4 bytes, the
  // overwhelming majority) now resolve entirely inside the slot line.
  // len > 8: long_.off is the arena offset of the bytes, long_.hash the
  // low 32 bits of long_hash (filter; the memcmp is the arbiter).
  union {
    uint64_t key8;
    struct {
      uint32_t off;  // arena < 4 GB
      uint32_t hash;
    } long_;
  };
};
static_assert(sizeof(SlotRec) == 16, "slot record must be 16 bytes");

struct Snap {
  SlotRec* slot;
  int64_t slots, mask;
  uint8_t* arena;
  int64_t arena_cap;
  std::atomic<int64_t> inflight{0};  // inserters inside (see ctx_insert)
  std::atomic<bool> sealed{false};   // set by a rebuild, under Ctx::mu
};

struct MemoEnt;
struct MemoEnt16;

struct Ctx {
  int pattern;
  //: oversized-segment subdivision target, read from
  //: TOKENIZER_TPU_SUBSEG_BYTES at CONTEXT CREATION (not cached in a
  //: process-wide static) so in-process tests / long-lived services can
  //: retune the knob by building a fresh context.
  int64_t subseg;
  std::atomic<Snap*> snap;
  std::mutex mu;  // guards growth (and ``retired``) alone
  std::atomic<int64_t> n_ent;      // uids handed out
  std::atomic<int64_t> arena_len;  // arena bytes reserved
  std::vector<Snap*> retired;
  // Per-worker-slot short-piece memos (see MemoEnt/MemoEnt16): sized on
  // the calling thread, each allocated by the worker that uses it (see
  // ctx_memo_for), retained across calls so steady-state traffic hits a
  // warm memo.
  std::vector<MemoEnt*> memos;
  std::vector<MemoEnt16*> memos16;

  ~Ctx();

  static void free_snap(Snap* s) {
    if (!s) return;
    ::operator delete[](s->slot, std::align_val_t(64), std::nothrow);
    delete[] s->arena;
    delete s;
  }
};

static Snap* make_snap(int64_t slots, int64_t arena_cap) {
  Snap* s = new (std::nothrow) Snap();
  if (!s) return nullptr;
  void* raw = ::operator new[]((size_t)slots * sizeof(SlotRec),
                               std::align_val_t(64), std::nothrow);
  s->slot = (SlotRec*)raw;
  s->arena = new (std::nothrow) uint8_t[arena_cap];
  if (!s->slot || !s->arena) {
    Ctx::free_snap(s);
    return nullptr;
  }
  s->slots = slots;
  s->mask = slots - 1;
  s->arena_cap = arena_cap;
  for (int64_t i = 0; i < slots; i++) {
    new (&s->slot[i]) SlotRec();
    s->slot[i].uid.store(SLOT_EMPTY, std::memory_order_relaxed);
  }
  return s;
}

// Short-piece equality: regex pieces average ~4 bytes, where a libc
// memcmp call costs more than the compare; a plain byte loop stays in
// registers and predicts perfectly.
static inline bool bytes_eq(const uint8_t* a, const uint8_t* b, int64_t n) {
  if (n >= 16) return memcmp(a, b, (size_t)n) == 0;
  for (int64_t j = 0; j < n; j++)
    if (a[j] != b[j]) return false;
  return true;
}

// Whether published slot ``rec`` holds the piece (plen, h, key8 or the
// bytes at buf + i).
static inline bool slot_holds(const Snap* sn, const SlotRec& rec,
                              const uint8_t* buf, int64_t i, int64_t plen,
                              uint64_t h, uint64_t key8) {
  if (rec.len != (int32_t)plen) return false;
  if (plen <= 8) return rec.key8 == key8;
  return rec.long_.hash == (uint32_t)h &&
         bytes_eq(sn->arena + rec.long_.off, buf + i, plen);
}

// Lock-free probe of one snapshot. Returns uid or -1 (not found / not
// yet visible here: an EMPTY or a CLAIMED slot ends the probe).
// *out_slot gets that slot's index when -1.  ``key8`` is the padded
// inline key when plen <= 8 (ignored otherwise).
static inline int32_t snap_find(const Snap* sn, const uint8_t* buf, int64_t i,
                                int64_t plen, uint64_t h, uint64_t key8,
                                int64_t* out_slot) {
  int64_t s_ = (int64_t)(h & (uint64_t)sn->mask);
  if (plen <= 8) {
    // Inline-key path: (len, key8) IS the content; one 16-byte record
    // read decides the match — no arena touch.
    for (;;) {
      const SlotRec& rec = sn->slot[s_];
      int32_t u = rec.uid.load(std::memory_order_acquire);
      if (u < 0) {
        *out_slot = s_;
        return -1;
      }
      if (rec.len == (int32_t)plen && rec.key8 == key8) return u;
      s_ = (s_ + 1) & sn->mask;
    }
  }
  for (;;) {
    const SlotRec& rec = sn->slot[s_];
    int32_t u = rec.uid.load(std::memory_order_acquire);
    if (u < 0) {
      *out_slot = s_;
      return -1;
    }
    if (rec.len == (int32_t)plen && rec.long_.hash == (uint32_t)h &&
        bytes_eq(sn->arena + rec.long_.off, buf + i, plen)) {
      return u;
    }
    s_ = (s_ + 1) & sn->mask;
  }
}

static inline void cpu_relax() {
#if defined(__x86_64__) || defined(__i386__)
  __builtin_ia32_pause();
#elif defined(__aarch64__)
  asm volatile("yield");
#endif
}

// Waits until a CLAIMED slot's uid is published; returns it.  The
// claimant is inside its snapshot and waits on nothing, so this ends.
static int32_t await_uid(const SlotRec& rec, int64_t* cnt) {
  int64_t t0 = cnt ? now_ns() : 0;
  int32_t u;
  for (int spin = 0;
       (u = rec.uid.load(std::memory_order_acquire)) == SLOT_CLAIMED;
       spin++) {
    if (spin < 64)
      cpu_relax();
    else
      std::this_thread::yield();
  }
  if (cnt) cnt[SC_INTERN_WAIT_NS] += now_ns() - t0;
  return u;
}

constexpr int32_t NEED_GROW = -3;

// One insert attempt inside snapshot ``sn``, which the caller has
// entered (see ctx_insert).  Returns the piece's uid (*fresh when this
// call created it), NEED_GROW when ``sn`` must grow first, or -4 when
// the arena would pass 4 GB.
static int32_t snap_insert(Ctx* c, Snap* sn, const uint8_t* buf, int64_t i,
                           int64_t plen, uint64_t h, uint64_t key8,
                           bool* fresh, int64_t* cnt) {
  const int64_t need = plen > 8 ? plen : 0;  // short pieces live inline
  int64_t off = -1;  // this attempt's arena range [off, off + need)
  auto give_back = [&]() {  // an unused range: returned if still last
    int64_t end = off + need;
    if (off >= 0)
      c->arena_len.compare_exchange_strong(end, off,
                                           std::memory_order_relaxed);
  };
  int64_t s_ = (int64_t)(h & (uint64_t)sn->mask);
  for (;;) {
    SlotRec& rec = sn->slot[s_];
    int32_t u = rec.uid.load(std::memory_order_acquire);
    if (u == SLOT_CLAIMED) u = await_uid(rec, cnt);
    if (u == SLOT_EMPTY) {
      if (2 * (c->n_ent.load(std::memory_order_relaxed) + 1) >= sn->slots) {
        give_back();
        return NEED_GROW;
      }
      if (need && off < 0) {
        int64_t cur = c->arena_len.load(std::memory_order_relaxed);
        do {
          if (cur + need > (int64_t)UINT32_MAX) return -4;
          if (cur + need > sn->arena_cap) return NEED_GROW;
        } while (!c->arena_len.compare_exchange_weak(
            cur, cur + need, std::memory_order_relaxed));
        off = cur;
      }
      int32_t expect = SLOT_EMPTY;
      if (rec.uid.compare_exchange_strong(expect, SLOT_CLAIMED,
                                          std::memory_order_acquire)) {
        int32_t uid =
            (int32_t)c->n_ent.fetch_add(1, std::memory_order_relaxed);
        rec.len = (int32_t)plen;
        if (plen <= 8) {
          rec.key8 = key8;
        } else {
          rec.long_.off = (uint32_t)off;
          rec.long_.hash = (uint32_t)h;
          memcpy(sn->arena + off, buf + i, (size_t)plen);
        }
        // Release: readers that acquire this uid see len/key8 (and, for
        // long pieces, the arena bytes).
        rec.uid.store(uid, std::memory_order_release);
        *fresh = true;
        return uid;
      }
      // Another insert claimed the slot first: it may be this piece.
      u = expect == SLOT_CLAIMED ? await_uid(rec, cnt) : expect;
    }
    if (slot_holds(sn, rec, buf, i, plen, h, key8)) {
      give_back();
      return u;
    }
    s_ = (s_ + 1) & sn->mask;
  }
}

// Grows ``sn`` (if it is still the current snapshot) under Ctx::mu: seal,
// drain, copy into a new snapshot with room for one more entry and
// ``need`` more arena bytes, publish.  Returns false on allocation
// failure.
static bool ctx_grow(Ctx* c, Snap* sn, int64_t need, int64_t* cnt) {
  int64_t t0 = cnt ? now_ns() : 0;
  std::lock_guard<std::mutex> lk(c->mu);
  int64_t t_rebuild = cnt ? now_ns() : 0;
  if (cnt) cnt[SC_INTERN_WAIT_NS] += t_rebuild - t0;
  if (c->snap.load(std::memory_order_relaxed) != sn) return true;  // grown
  sn->sealed.store(true, std::memory_order_seq_cst);
  while (sn->inflight.load(std::memory_order_seq_cst) != 0) cpu_relax();
  // Every insert into sn has published; nothing writes it again.
  int64_t n = c->n_ent.load(std::memory_order_relaxed);
  int64_t alen = c->arena_len.load(std::memory_order_relaxed);
  int64_t nslots = sn->slots;
  while (2 * (n + 1) >= nslots) nslots <<= 1;
  int64_t narena = sn->arena_cap;
  while (narena < alen + need) narena <<= 1;
  Snap* ns = make_snap(nslots, narena);
  if (!ns) {
    sn->sealed.store(false, std::memory_order_seq_cst);
    return false;
  }
  memcpy(ns->arena, sn->arena, (size_t)alen);
  for (int64_t t = 0; t < sn->slots; t++) {
    const SlotRec& r = sn->slot[t];
    int32_t uid0 = r.uid.load(std::memory_order_relaxed);
    if (uid0 == SLOT_EMPTY) continue;
    // Recompute the home slot: short entries rehash from their inline
    // key (identical to the scan loop's short_hash); long entries use
    // the stored low-32 filter bits (mask < 2^32, so insert-time
    // h & mask == (uint32_t)h & mask).
    uint64_t rh = r.len <= 8 ? short_hash(r.key8, r.len)
                             : (uint64_t)r.long_.hash;
    int64_t d = (int64_t)(rh & (uint64_t)ns->mask);
    while (ns->slot[d].uid.load(std::memory_order_relaxed) != SLOT_EMPTY)
      d = (d + 1) & ns->mask;
    ns->slot[d].len = r.len;
    ns->slot[d].key8 = r.key8;
    ns->slot[d].uid.store(uid0, std::memory_order_relaxed);
  }
  c->retired.push_back(sn);
  // Release pairs with the acquire of c->snap: a reader that sees the
  // new pointer sees the fully rebuilt table.
  c->snap.store(ns, std::memory_order_release);
  if (cnt) {
    cnt[SC_REBUILDS] += 1;
    cnt[SC_REBUILD_NS] += now_ns() - t_rebuild;
  }
  return true;
}

// The insert path of a piece missed in a snapshot: enter the current
// snapshot (count in, then check the seal: with both seq_cst, either a
// rebuild's drain sees this inserter or this inserter sees the seal),
// insert or find the piece, leave; grow and retry when full.  Returns
// the piece's uid (*fresh when this call created it) or -4 (allocation
// failure, arena past 4 GB).  *snp gets the snapshot that answered.
static int32_t ctx_insert(Ctx* c, Snap** snp, const uint8_t* buf, int64_t i,
                          int64_t plen, uint64_t h, uint64_t key8,
                          bool* fresh, int64_t* cnt) {
  *fresh = false;
  for (;;) {
    Snap* sn = c->snap.load(std::memory_order_acquire);
    sn->inflight.fetch_add(1, std::memory_order_seq_cst);
    if (sn->sealed.load(std::memory_order_seq_cst)) {
      sn->inflight.fetch_sub(1, std::memory_order_release);
      // Sealed under the mutex, which its rebuild holds until the new
      // snapshot is published: wait for it, then retry.
      int64_t t0 = cnt ? now_ns() : 0;
      { std::lock_guard<std::mutex> lk(c->mu); }
      if (cnt) cnt[SC_INTERN_WAIT_NS] += now_ns() - t0;
      continue;
    }
    int32_t u = snap_insert(c, sn, buf, i, plen, h, key8, fresh, cnt);
    sn->inflight.fetch_sub(1, std::memory_order_release);
    if (u != NEED_GROW) {
      *snp = sn;
      return u;
    }
    if (!ctx_grow(c, sn, plen > 8 ? plen : 0, cnt)) return -4;
  }
}

struct NewRec {
  int32_t uid, start, end;
};

// ---- inline id emission (fused scan+emit) --------------------------------
//
// In steady state the scan already knows every piece's resolved row
// (uid -> uid_rows -> row matrix), so the token ids can be emitted
// DURING the scan — eliminating the uid-buffer round trip and the
// separate assemble re-walk entirely (measured: the two-phase pipeline
// spends ~45% of its CPU in the assemble pass on warm streams).
//
// Ordering/visibility protocol: uid_rows entries are written with
// RELEASE (after the row's ids are complete) and read with ACQUIRE, so
// a piece first seen by ANOTHER scanning thread either reads a fully
// published row or a negative value.  A negative read — deferred fuse,
// uid beyond capacity, or simply not-yet-published — emits a HOLE: the
// piece's byte length is reserved in the output (ids never exceed
// bytes) and a Patch records (subsegment, cursor, uid, reserved) for
// the Python layer to backfill and compact once the wave resolves.
// Steady state emits zero holes.
struct EmitState {
  int32_t* out;             // id output; per-subsegment regions
  const int32_t* uid_rows;  // atomic protocol above
  int64_t uid_cap;
  const int32_t* rows;
  const int32_t* row_len;
  int64_t row_width;
  const int32_t* ovf_pool;  // nullable; overflow rows defer when null
  int64_t ovf_len;
  // Compact uid-keyed id table (nullable): [uid_cap, 8] int32 — slot 0
  // is the id count (release-published; 0 = unpublished/doesn't-fit),
  // slots 1..7 the ids.  The wide row matrix strides 512 B per row with
  // ~8 useful bytes, so the steady-state emit gather thrashed L2/L3
  // (measured 195 vs 271 MB/s single-thread against uid-mode on this
  // box); at 32 B/entry the hot Zipf set stays L2-resident.  Pieces
  // emitting > 7 ids (or overflow rows) read the wide matrix as before.
  const int32_t* uid_ids;
};

struct Patch {
  int64_t sub;       // subsegment index (fixed up to segment later)
  int64_t pos;       // id-slot offset within the subsegment's stream
  int32_t uid;
  int32_t reserved;  // slots reserved (piece byte length)
};

static inline int32_t uid_row_acquire(const int32_t* uid_rows,
                                      int32_t uid) {
  return __atomic_load_n(&uid_rows[uid], __ATOMIC_ACQUIRE);
}

static inline void uid_row_release(int32_t* uid_rows, int32_t uid,
                                   int32_t row) {
  __atomic_store_n(&uid_rows[uid], row, __ATOMIC_RELEASE);
}


// Fused first-seen merge (ROADMAP cold-path item): when a scan interns
// a NEW piece, merge it RIGHT THERE on the scanning thread — the piece
// bytes are hot in L1 and the merge overlaps the rest of the scan —
// writing ids/len/UTF-16 units directly into the caller's row matrix.
// This collapses the cold path's separate register -> route -> batched
// merge -> numpy row scatter passes into the scan itself.  Capacity-
// bounded: a piece that cannot be fused (uid table or row matrix full,
// or its merge emits more ids than one row holds) is DEFERRED to the
// ordinary news list, which the Python layer resolves through the
// existing wave machinery — fusion is an optimization, never a
// correctness dependency.
struct FuseState {
  const int32_t* byte_to_id;
  const int32_t *kl, *kr, *vv;
  int32_t slot_bits, max_probes;
  int32_t* rows;      // [row_cap, row_width] int32, fresh rows zeroed
  int32_t* row_len;   // [row_cap]
  int32_t* row_u16;   // [row_cap] UTF-16 units of the source piece
  int64_t row_width, row_cap;
  int32_t* uid_rows;  // [uid_cap] uid -> row
  int64_t uid_cap;
  int32_t* uid_ids;   // nullable [uid_cap, 8] compact table (EmitState)
  // A piece longer than this defers to the news list unmerged (0: none
  // does): the caller merges long pieces elsewhere (the card's wave).
  int64_t defer_len;
  std::atomic<int64_t> row_next;  // next free row (starts at _n_rows)
  std::atomic<int64_t> n_fused;   // pieces fully resolved in this call
  // Optional FROZEN previous dedup generation (generational eviction,
  // VERDICT r3 next #4): a first-seen piece probes the retired
  // context's intern table (lock-free — no writers exist once a
  // generation is frozen) and, on a hit, COPIES its already-resolved
  // row instead of re-merging, so a post-rotation stream warms at
  // memcpy speed rather than re-merge speed.  All nullable.
  const void* old_ctx;            // frozen Ctx*
  const int32_t* old_uid_rows;
  const int32_t* old_rows;
  const int32_t* old_row_len;
  const int32_t* old_row_u16;
  int64_t old_row_width;
  int64_t old_n_rows;             // resolved rows in the old bank
  std::atomic<int64_t> n_copied;  // old-gen row copies this call
};

struct FuseScratch {
  BpeScratch bpe;
  std::vector<int32_t> ids;  // merge output, sized to the piece bytes
};

// Counts one outcome of fuse_new_piece in ``cnt`` (nullable): the merge
// class ``k`` (SC_FUSED_SHORT, SC_FUSED_LONG or SC_GEN_COPIES) took the
// time since ``t0``; a success counts the piece and its bytes, a
// deferral its reason ``why``.  Returns whether the piece fused.
static inline bool fuse_outcome(int64_t* cnt, int k, int64_t t0,
                                int64_t plen, int why) {
  if (cnt) {
    cnt[k + 2] += now_ns() - t0;
    if (why < 0) {
      cnt[k] += 1;
      cnt[k + 1] += plen;
    } else {
      cnt[why] += 1;
    }
  }
  return why < 0;
}

// Merge one freshly-interned piece into its own row.  Returns true on
// success; false defers the piece to the news list.  Thread-safe by
// construction: rows are claimed with an atomic counter, each claimed
// row (and uid_rows slot) is written by exactly one thread, and the
// caller joins all workers before any read.  ``h``/``key8`` are the
// piece's intern hash / padded inline key (already computed by the
// scan), reused for the optional old-generation probe.  ``cnt``
// (nullable) counts the merge by class and the deferral by reason; a
// null ``fs`` or a ``row_cap`` of 0 is fusing turned off.  A piece longer
// than ``fs->defer_len`` (when not 0) is neither merged nor copied from
// an old generation: it defers at once (the caller's news path probes
// the old generation too).
static bool fuse_new_piece(FuseState* fs, FuseScratch* sc,
                           const uint8_t* buf, int64_t i, int64_t plen,
                           int32_t uid, uint64_t h, uint64_t key8,
                           int64_t* cnt) {
  if (!fs || fs->row_cap == 0) {
    if (cnt) cnt[SC_DEFER_OFF] += 1;
    return false;
  }
  if (fs->defer_len > 0 && plen > fs->defer_len) {
    if (cnt) cnt[SC_DEFER_LONG] += 1;
    return false;
  }
  if (uid >= fs->uid_cap ||
      fs->row_next.load(std::memory_order_relaxed) >= fs->row_cap) {
    if (cnt) cnt[SC_DEFER_CAPACITY] += 1;
    return false;
  }
  int64_t t0 = cnt ? now_ns() : 0;
  // Generational resurrection: a piece the RETIRED generation already
  // resolved copies its row instead of re-merging.
  if (fs->old_ctx) {
    const Ctx* oc = (const Ctx*)fs->old_ctx;
    const Snap* osn = oc->snap.load(std::memory_order_acquire);
    int64_t s_;
    int32_t ouid = snap_find(osn, buf, i, plen, h, key8, &s_);
    if (ouid >= 0) {
      int32_t orow = fs->old_uid_rows[ouid];
      if (orow >= 0 && orow < fs->old_n_rows) {
        int32_t m = fs->old_row_len[orow];
        // Overflow rows (m < 0, ids in the retired python-side pool)
        // defer to the news path; everything else is one memcpy.
        if (m >= 0 && m <= fs->row_width) {
          int64_t row = fs->row_next.fetch_add(1, std::memory_order_relaxed);
          if (row >= fs->row_cap)
            return fuse_outcome(cnt, SC_GEN_COPIES, t0, plen,
                                SC_DEFER_CAPACITY);
          memcpy(fs->rows + row * fs->row_width,
                 fs->old_rows + (int64_t)orow * fs->old_row_width,
                 (size_t)m * sizeof(int32_t));
          fs->row_len[row] = m;
          fs->row_u16[row] = fs->old_row_u16[orow];
          if (fs->uid_ids && m >= 1 && m <= 7) {
            int32_t* cc = fs->uid_ids + (int64_t)uid * 8;
            memcpy(cc + 1, fs->old_rows + (int64_t)orow * fs->old_row_width,
                   (size_t)m * sizeof(int32_t));
            __atomic_store_n(cc, m, __ATOMIC_RELEASE);
          }
          // RELEASE publish: emit-path readers acquire a complete row.
          uid_row_release(fs->uid_rows, uid, (int32_t)row);
          fs->n_fused.fetch_add(1, std::memory_order_relaxed);
          fs->n_copied.fetch_add(1, std::memory_order_relaxed);
          return fuse_outcome(cnt, SC_GEN_COPIES, t0, plen, -1);
        }
        if (m < 0)  // retired overflow row: defer
          return fuse_outcome(cnt, SC_GEN_COPIES, t0, plen, SC_DEFER_WIDE);
      }
    }
  }
  const int cls = plen <= 16 ? SC_FUSED_SHORT : SC_FUSED_LONG;
  if ((int64_t)sc->ids.size() < plen) sc->ids.resize((size_t)plen);
  int64_t w = bpe_merge_core(buf + i, plen, fs->byte_to_id, fs->kl, fs->kr,
                             fs->vv, fs->slot_bits, fs->max_probes,
                             sc->ids.data(), plen, sc->bpe);
  if (w < 0 || w > fs->row_width)  // overflow row: defer
    return fuse_outcome(cnt, cls, t0, plen, SC_DEFER_WIDE);
  int64_t row = fs->row_next.fetch_add(1, std::memory_order_relaxed);
  if (row >= fs->row_cap)  // lost the race for the tail
    return fuse_outcome(cnt, cls, t0, plen, SC_DEFER_CAPACITY);
  memcpy(fs->rows + row * fs->row_width, sc->ids.data(),
         (size_t)w * sizeof(int32_t));
  fs->row_len[row] = (int32_t)w;
  int32_t u16 = 0;
  for (int64_t j = 0; j < plen; j++) {
    uint8_t bb = buf[i + j];
    u16 += (int32_t)((bb & 0xC0) != 0x80) + (int32_t)(bb >= 0xF0);
  }
  fs->row_u16[row] = u16;
  if (fs->uid_ids && w >= 1 && w <= 7) {
    int32_t* cc = fs->uid_ids + (int64_t)uid * 8;
    memcpy(cc + 1, sc->ids.data(), (size_t)w * sizeof(int32_t));
    __atomic_store_n(cc, (int32_t)w, __ATOMIC_RELEASE);
  }
  // RELEASE publish: emit-path readers acquire a complete row.
  uid_row_release(fs->uid_rows, uid, (int32_t)row);
  fs->n_fused.fetch_add(1, std::memory_order_relaxed);
  return fuse_outcome(cnt, cls, t0, plen, -1);
}

// Per-thread direct-mapped memo for short pieces: (key8, len) IS the
// piece content, and uid assignments are stable and grow-only, so a
// filled entry never goes stale.  512 KB stays L2-resident where the
// authoritative snapshot table (multi-MB under diverse corpora) lives
// in DRAM — under Zipf the hot pieces resolve here, skipping the probe
// entirely.  Strictly thread-private (no atomics, no tearing hazard).
struct MemoEnt {
  uint64_t key8;
  int32_t len;    // 0 = empty (pieces are >= 1 byte)
  int32_t uid;
  int32_t n_ids;  // 0 = ids not cached yet
  int32_t ids[3];  // the piece's token ids when n_ids in [1, 3]
};
constexpr int64_t MEMO_SLOTS = 1 << 16;  // 32 B/entry -> 2 MB

// Second memo tier for 9-16-byte pieces (ROADMAP r3 #4): code corpora
// put ~6% of pieces (13% of bytes) in this window — identifiers,
// ` function`-style words — and every repeat paid a DRAM snapshot
// probe.  (k0, k1, len) is again the full zero-padded content, so a
// match IS equality.  Thread-private like tier 1.
struct MemoEnt16 {
  uint64_t k0, k1;
  int32_t len;  // 0 = empty
  int32_t uid;
  int32_t n_ids;   // 0 = ids not cached yet
  int32_t ids[5];  // token ids when n_ids in [1, 5]
};
constexpr int64_t MEMO16_SLOTS = 1 << 14;  // 48 B/entry -> 768 KB

// Zero-padded 16-byte key of a piece with 9 <= n <= 16 (same
// position-independence contract as load_key8).
static inline void load_key16(const uint8_t* s, int64_t i, int64_t n,
                              int64_t bufend, uint64_t* k0, uint64_t* k1) {
  memcpy(k0, s + i, 8);
  uint64_t hi = 0;
  if (i + 16 <= bufend) {
    memcpy(&hi, s + i + 8, 8);
    if (n < 16) hi &= (1ULL << (8 * (n - 8))) - 1;
  } else {
    memcpy(&hi, s + i + 8, (size_t)(n - 8));
  }
  *k1 = hi;
}

Ctx::~Ctx() {
  for (Snap* s : retired) free_snap(s);
  free_snap(snap.load(std::memory_order_relaxed));
  for (MemoEnt* m : memos) free(m);
  for (MemoEnt16* m : memos16) free(m);
}

// Room for ``n`` worker slots' memos; CALLING THREAD ONLY, before the
// workers start (no lock — per-Ctx calls are serialized above this
// layer), so that no worker resizes the vectors.
static void ctx_size_memos(Ctx* c, int n) {
  if ((int)c->memos.size() < n) c->memos.resize((size_t)n, nullptr);
  if ((int)c->memos16.size() < n) c->memos16.resize((size_t)n, nullptr);
}

// Worker slot t's memos, allocated on first use by the worker that owns
// slot t for the call.  calloc hands back zeroed (empty) entries whose
// pages fault in as the scan touches them, on that worker: allocating
// and zeroing all of them on the calling thread before the workers
// started cost a fresh context's first call ~3 ms a worker (measured
// on an 8-core host of an H100).  Null on allocation failure, which
// just disables the memo for that worker.
static MemoEnt* ctx_memo_for(Ctx* c, int t) {
  if (!c->memos[(size_t)t])
    c->memos[(size_t)t] = (MemoEnt*)calloc(MEMO_SLOTS, sizeof(MemoEnt));
  return c->memos[(size_t)t];
}

static MemoEnt16* ctx_memo16_for(Ctx* c, int t) {
  if (!c->memos16[(size_t)t])
    c->memos16[(size_t)t] =
        (MemoEnt16*)calloc(MEMO16_SLOTS, sizeof(MemoEnt16));
  return c->memos16[(size_t)t];
}

// Fused scan+hash+intern of one segment, SOFTWARE-PIPELINED: pieces are
// scanned and hashed in small batches whose home slot lines are
// prefetched before any probe runs, so the probe's DRAM miss — the
// dominant interning cost once the table outgrows L2 — overlaps the
// scanning of the rest of the batch.  ``memo`` (nullable) short-circuits
// repeat short pieces before they enter the probe batch.  New uids
// collected per thread; merged by the caller.  ``cnt`` (nullable) is the
// worker's counter slots (see ScanCounter).  Returns piece count or -4.
static int64_t scan_segment(Ctx* c, next_fn next, const uint8_t* buf,
                            int64_t a, int64_t b, int32_t* out,
                            std::vector<NewRec>& news, MemoEnt* memo,
                            MemoEnt16* memo16, FuseState* fs = nullptr,
                            FuseScratch* fsc = nullptr,
                            EmitState* es = nullptr,
                            std::vector<Patch>* patches = nullptr,
                            int64_t sub_idx = 0,
                            int64_t* n_tokens_out = nullptr,
                            int64_t* cnt = nullptr) {
  // Two output modes: uid mode (es == null) writes one uid per piece
  // to ``out``; EMIT mode (es != null) writes each piece's token IDS
  // to ``out`` instead (one pass, no uid buffer, no assemble phase —
  // see EmitState).  Emit's steady fast path is the widened memo entry
  // itself: once a piece's ids are cached there (n_ids > 0), a repeat
  // resolves bytes -> ids from ONE thread-private line with no staging,
  // no atomics, and no row/uid_ids access — order-safe whenever nothing
  // is currently staged (nb == 0, the ~always case under Zipf).  Pieces
  // that do stage resolve through uid_ids/rows in the batched sub-loop
  // below, which then backfills their memo ids for the next repeat.
  constexpr int BATCH = 64;
  int64_t pi[BATCH];
  int32_t pl[BATCH];
  uint64_t ph[BATCH];
  uint64_t pk[BATCH];
  uint64_t pk1[BATCH];   // high key half (9-16B pieces; memo16 refill)
  int64_t po[BATCH];     // uid mode: reserved out slot; emit mode: the
                         // piece's memo slot << 1 | tier16 (-1 none)
  int32_t pu[BATCH];     // resolved uid per staged piece
  int64_t count = 0;
  int64_t cursor = 0;    // emit mode: id slots written
  // Emit region bound: ids never exceed bytes, so while cursor + K fits
  // a fixed K-id copy is safe and the tail falls back to exact sizes.
  const int64_t cap_ids = b - a;
  int64_t i = a;
  // A stale snapshot is safe: it can only MISS fresh entries, which
  // routes those pieces through the insert path, which probes the
  // current snapshot and hands it back here (ctx_insert sets ``sn``);
  // retired snapshots stay allocated, never freed.
  Snap* sn = c->snap.load(std::memory_order_acquire);
  int nb = 0;
  bool failed = false;
  // Flush the staged batch: probe/intern pass (prefetch-pipelined),
  // then — emit mode — the resolve+copy pass.  Called at BATCH
  // capacity, at end of input, and (emit mode) whenever an
  // inline-capable piece arrives with pieces staged: the inline fast
  // path must stay in piece order, and WITHOUT the early flush one
  // cold piece would drag the next 63 pieces into the staged path
  // (measured: a rare word every ~37 pieces put whole batches on the
  // slow path and cost ~25% of emit throughput).
  auto flush = [&]() {
    for (int k = 0; k < nb; k++) {
      int32_t uid = pu[k];
      if (uid < 0) {
        int64_t s_;
        uid = snap_find(sn, buf, pi[k], pl[k], ph[k], pk[k], &s_);
        if (uid < 0) {
          bool fresh;
          int64_t t_in = cnt ? now_ns() : 0;
          uid = ctx_insert(c, &sn, buf, pi[k], pl[k], ph[k], pk[k], &fresh,
                           cnt);
          if (uid < 0) {
            failed = true;
            return;
          }
          if (cnt) {
            cnt[SC_INTERN_LOCKS] += 1;
            cnt[SC_INSERTS] += fresh;
            cnt[SC_INTERN_NS] += now_ns() - t_in;
          }
          // First-seen pieces on different threads merge concurrently.
          if (fresh &&
              !fuse_new_piece(fs, fsc, buf, pi[k], pl[k], uid, ph[k],
                              pk[k], cnt)) {
            news.push_back(
                NewRec{uid, (int32_t)pi[k], (int32_t)(pi[k] + pl[k])});
          }
        }
        if (pl[k] <= 8) {
          if (memo) {
            MemoEnt& me = memo[ph[k] & (MEMO_SLOTS - 1)];
            me.key8 = pk[k];
            me.len = pl[k];
            me.uid = uid;
            me.n_ids = 0;  // new key: cached ids (if any) are stale
          }
        } else if (pl[k] <= 16 && memo16) {
          MemoEnt16& me = memo16[ph[k] & (MEMO16_SLOTS - 1)];
          me.k0 = pk[k];
          me.k1 = pk1[k];
          me.len = pl[k];
          me.uid = uid;
          me.n_ids = 0;
        }
        pu[k] = uid;
      }
      if (!es) out[po[k]] = uid;
    }
    if (es) {
      count += nb;
      // Emit sub-loop for STAGED pieces (first repeats, cold pieces,
      // > 16 B pieces).  Resolution order: the compact uid-keyed table
      // (one 32 B line, L2-class), then uid_rows -> the wide row matrix
      // (unpublished compact entries, > 7-id rows, overflow rows).
      // Resolved ids then backfill the piece's memo slot so the NEXT
      // repeat takes the inline fast path in the staging loop above.
      const int32_t* uic = es->uid_ids;
      if (uic) {
        for (int k = 0; k < nb; k++) {
          int32_t uid = pu[k];
          if (uid >= 0 && uid < es->uid_cap)
            __builtin_prefetch(uic + (int64_t)uid * 8, 0, 1);
        }
      }
      for (int k = 0; k < nb; k++) {
        int32_t uid = pu[k];
        int32_t m = -1;
        const int32_t* src = nullptr;
        if (uid >= 0 && uid < es->uid_cap) {
          if (uic) {
            const int32_t* cc = uic + (int64_t)uid * 8;
            int32_t mm = __atomic_load_n(cc, __ATOMIC_ACQUIRE);
            if (mm > 0) {
              m = mm;
              src = cc + 1;
            }
          }
          if (m < 0) {
            int32_t v = uid_row_acquire(es->uid_rows, uid);
            if (v >= 0) {
              int32_t mm = es->row_len[v];
              const int32_t* s2 = es->rows + (int64_t)v * es->row_width;
              if (mm < 0) {
                if (es->ovf_pool) {
                  m = -mm - 1;
                  src = es->ovf_pool + s2[0];
                }
              } else {
                m = mm;
                src = s2;
              }
            }
          }
        }
        if (m < 0) {
          // Hole: deferred/unpublished piece — reserve its byte length
          // (ids never exceed bytes) for the Python backfill.
          patches->push_back(Patch{sub_idx, cursor, pu[k], pl[k]});
          if (cnt) cnt[SC_PATCHES] += 1;
          cursor += pl[k];
          continue;
        }
        if (cnt) cnt[SC_STAGED] += 1;
        memcpy(out + cursor, src, (size_t)m * sizeof(int32_t));
        cursor += m;
        // Memo-ids backfill (key-checked: a colliding piece may have
        // refilled the slot since staging).
        int64_t se = po[k];
        if (se >= 0 && m >= 1) {
          if (se & 1) {
            if (m <= 5) {
              MemoEnt16& me = memo16[se >> 1];
              if (me.len == pl[k] && me.k0 == pk[k] && me.k1 == pk1[k]) {
                memcpy(me.ids, src, (size_t)m * sizeof(int32_t));
                me.n_ids = m;
              }
            }
          } else if (m <= 3) {
            MemoEnt& me = memo[se >> 1];
            if (me.len == pl[k] && me.key8 == pk[k]) {
              memcpy(me.ids, src, (size_t)m * sizeof(int32_t));
              me.n_ids = m;
            }
          }
        }
      }
    }
    nb = 0;
  };

  while (i < b) {
    int64_t pe = next(buf, i, b);
    if (pe <= i) pe = i + 1;
    int64_t n = pe - i;
    uint64_t key8 = 0, k1 = 0, h;
    int32_t uid = -1;
    int64_t slot_enc = -1;
    if (n <= 8) {
      key8 = load_key8(buf, i, n, b);
      h = short_hash(key8, n);
      if (memo) {
        const MemoEnt& me = memo[h & (MEMO_SLOTS - 1)];
        if (me.len == (int32_t)n && me.key8 == key8) {
          // STEADY FAST PATH (uid mode): a memo hit writes its uid
          // straight to ``out`` and skips the staging arrays entirely —
          // under Zipf this is ~every piece, and the staged stores +
          // second-loop pass were pure overhead.
          if (!es) {
            out[count++] = me.uid;
            i = pe;
            continue;
          }
          // STEADY FAST PATH (emit mode): ids cached in this memo line.
          if (me.n_ids > 0) {
            if (nb) {
              // flush() refills memo entries for the staged pieces,
              // and a slot COLLISION would invalidate `me` under us
              // (found by the giant-segment conformance test: the
              // stale reference read n_ids == 0 after the refill and
              // the piece silently emitted nothing) — snapshot the
              // ids before flushing.
              int32_t m = me.n_ids;
              int32_t tmp[3];
              memcpy(tmp, me.ids, sizeof(tmp));
              flush();
              if (failed) return -4;
              sn = c->snap.load(std::memory_order_acquire);
              if (cursor + 3 <= cap_ids) {
                memcpy(out + cursor, tmp, 3 * sizeof(int32_t));
              } else {
                memcpy(out + cursor, tmp, (size_t)m * sizeof(int32_t));
              }
              cursor += m;
            } else {
              if (cursor + 3 <= cap_ids) {
                memcpy(out + cursor, me.ids, 3 * sizeof(int32_t));
              } else {
                memcpy(out + cursor, me.ids,
                       (size_t)me.n_ids * sizeof(int32_t));
              }
              cursor += me.n_ids;
            }
            count++;
            i = pe;
            continue;
          }
          uid = me.uid;
        }
        slot_enc = (int64_t)(h & (MEMO_SLOTS - 1)) << 1;
      }
    } else if (n <= 16) {
      load_key16(buf, i, n, b, &key8, &k1);
      h = long_hash(buf, i, pe);
      if (memo16) {
        const MemoEnt16& me = memo16[h & (MEMO16_SLOTS - 1)];
        if (me.len == (int32_t)n && me.k0 == key8 && me.k1 == k1) {
          if (!es) {
            out[count++] = me.uid;
            i = pe;
            continue;
          }
          if (me.n_ids > 0) {
            if (nb) {
              // Snapshot before flush — same stale-reference hazard as
              // the tier-1 path above.
              int32_t m = me.n_ids;
              int32_t tmp[5];
              memcpy(tmp, me.ids, sizeof(tmp));
              flush();
              if (failed) return -4;
              sn = c->snap.load(std::memory_order_acquire);
              if (cursor + 5 <= cap_ids) {
                memcpy(out + cursor, tmp, 5 * sizeof(int32_t));
              } else {
                memcpy(out + cursor, tmp, (size_t)m * sizeof(int32_t));
              }
              cursor += m;
            } else {
              if (cursor + 5 <= cap_ids) {
                memcpy(out + cursor, me.ids, 5 * sizeof(int32_t));
              } else {
                memcpy(out + cursor, me.ids,
                       (size_t)me.n_ids * sizeof(int32_t));
              }
              cursor += me.n_ids;
            }
            count++;
            i = pe;
            continue;
          }
          uid = me.uid;
        }
        slot_enc = ((int64_t)(h & (MEMO16_SLOTS - 1)) << 1) | 1;
      }
      // key8 keeps the low half: snap_find ignores it for n > 8
      // (arena compare is the arbiter) and the memo16 refill reuses
      // it as k0.
    } else {
      h = long_hash(buf, i, pe);
    }
    pl[nb] = (int32_t)n;
    pu[nb] = uid;
    pk[nb] = key8;
    pk1[nb] = k1;
    if (es) po[nb] = slot_enc;  // memo backfill target (key-checked)
    if (uid < 0) {
      pi[nb] = i;
      ph[nb] = h;
      __builtin_prefetch(&sn->slot[h & (uint64_t)sn->mask], 0, 1);
    }
    if (!es) po[nb] = count++;  // out slot filled after the probe
    nb++;
    i = pe;
    if (nb == BATCH) {
      flush();
      if (failed) return -4;
      sn = c->snap.load(std::memory_order_acquire);
    }
  }
  if (nb) {
    flush();
    if (failed) return -4;
  }
  if (n_tokens_out) *n_tokens_out = cursor;
  return count;
}

}  // namespace

static int64_t subseg_bytes() {
  const char* e = getenv("TOKENIZER_TPU_SUBSEG_BYTES");
  int64_t n = e ? atoll(e) : 0;
  return n >= 4096 ? n : (int64_t)512 * 1024;
}

void* tt_ctx_new(int pattern) {
  if (!pick(pattern)) return nullptr;
  Ctx* c = new (std::nothrow) Ctx();
  if (!c) return nullptr;
  c->pattern = pattern;
  c->subseg = subseg_bytes();
  c->n_ent.store(0, std::memory_order_relaxed);
  c->arena_len.store(0, std::memory_order_relaxed);
  // 2^16 slots (1 MiB at 16 bytes a slot) and a 2 MiB arena, of which
  // only the bytes written are touched: a cold pass over 8 MB of text
  // interns ~17k pieces (the load limit is 2^15) with ~0.64 MB of
  // pieces over 8 bytes, so it grows nothing mid-scan.
  Snap* s = make_snap(1 << 16, 1 << 21);
  if (!s) {
    delete c;
    return nullptr;
  }
  c->snap.store(s, std::memory_order_relaxed);
  return c;
}

void tt_ctx_free(void* p) { delete (Ctx*)p; }

int64_t tt_ctx_n_pieces(void* p) {
  return ((Ctx*)p)->n_ent.load(std::memory_order_acquire);
}

// Single-segment convenience wrapper (also the nthreads=1 path).
int64_t tt_ctx_split(void* p, const uint8_t* buf, int64_t start, int64_t end,
                     int32_t* piece_uid, int64_t cap, int32_t* new_uid,
                     int32_t* new_start, int32_t* new_end, int64_t new_cap,
                     int64_t* n_new) {
  Ctx* c = (Ctx*)p;
  if (end > (int64_t)INT32_MAX) return -5;  // int32 news spans
  if (end - start > cap) return -2;
  std::vector<NewRec> news;
  ctx_size_memos(c, 1);
  int64_t n = scan_segment(c, pick(c->pattern), buf, start, end, piece_uid,
                           news, ctx_memo_for(c, 0), ctx_memo16_for(c, 0));
  if (n < 0) return n;
  if ((int64_t)news.size() > new_cap) return -3;
  for (size_t j = 0; j < news.size(); j++) {
    new_uid[j] = news[j].uid;
    new_start[j] = news[j].start;
    new_end[j] = news[j].end;
  }
  *n_new = (int64_t)news.size();
  return n;
}

// Oversized-segment subdivision: a single giant document is ONE scan
// segment, which would pin the whole scan to one worker (measured:
// 8 MB one-file docs cap the corpus pipeline at ~2 threads/chunk).
// Split such segments at points where the piece decomposition is
// PROVABLY position-independent, so subdivided output is bit-identical
// to the whole-segment scan:
//
//   buf[p-1] and buf[p+1] are ASCII graphic (0x21..0x7E) and buf[p] is
//   ' '  — or buf[p] is '\n' with buf[p-1] an ASCII letter/digit — a
//   single-codepoint whitespace run flanked by non-whitespace.
//
// Why this is safe for all three patterns (tokenizerBuilder.ts:66-89):
//   * the LEFT part ends at p with a non-ws byte, so the `\s+(?!\S)`
//     end-of-input special case (ws_tail e>=n) can never trigger at
//     the cut — the left part's pieces end exactly where the
//     whole-segment scan ends them;
//   * no alternative's match can SPAN p: nothing absorbs a trailing
//     ' ' (the only trailing-ws suffix in any pattern is the punct
//     alternative's `[\r\n]*`, which is exactly why a '\n' cut is
//     allowed only after a letter/digit — letter and digit pieces
//     have no trailing absorption);
//   * the RIGHT part starts with exactly one ASCII ws then a graphic
//     byte.  Every alternative that can consume that ws decides using
//     only the ws itself and the following char — ` ?\p{L}+` etc.
//     absorb it as the optional one-char prefix, `\s+(?!\S)` backs off
//     to nothing (single-cp run), `\s*[\r\n]+` matches iff the ws IS
//     the newline — all positional decisions the whole-segment scan
//     makes identically when it reaches p (no lookbehind exists in any
//     pattern, and contractions anchor on an apostrophe, not ws);
//   * boundaries sit between ASCII bytes, so no UTF-8 codepoint (or
//     multi-byte unicode whitespace) is ever straddled.
// Differential-fuzzed against the whole-segment scan and the python
// `regex` oracle (tests/test_native_presplit.py).
static inline bool ascii_alnum(uint8_t a) {
  return (a >= '0' && a <= '9') || (a >= 'A' && a <= 'Z') ||
         (a >= 'a' && a <= 'z');
}

static inline bool safe_split_point(const uint8_t* s, int64_t p) {
  uint8_t a = s[p - 1], w = s[p], b = s[p + 1];
  if (b <= 0x20 || b >= 0x7F) return false;
  if (w == ' ') return a > 0x20 && a < 0x7F;
  return w == '\n' && ascii_alnum(a);
}

// Parallel batch split: segments fan out over threads (work stealing),
// each running the fused scan; uids land at (seg_start[k] -
// seg_start[0]) in piece_uid, counts in seg_npieces.  Returns total
// pieces, or -3/-4 (see tt_ctx_split).  ``fs`` (nullable) enables the
// fused first-seen merge (see FuseState).
// ``es`` (nullable) switches to EMIT mode: piece_uid becomes the ID
// output buffer (per-segment regions at seg_start[k]-base, compacted
// like uids), seg_ntokens receives per-segment id counts, and holes
// are reported through the patch arrays (seg index relative to the
// caller's segment list, position within the segment's id stream, uid,
// reserved slots).  Returns -6 if patch_cap is insufficient.
// ``counters`` (nullable) is added to (see ScanCounter).
static int64_t split_batch_impl(Ctx* c, const uint8_t* buf,
                                const int64_t* seg_start,
                                const int64_t* seg_end, int64_t n_segs,
                                int nthreads, int32_t* piece_uid,
                                int64_t* seg_npieces, int32_t* new_uid,
                                int32_t* new_start, int32_t* new_end,
                                int64_t new_cap, int64_t* n_new,
                                int64_t* counters, FuseState* fs,
                                EmitState* es = nullptr,
                                int64_t* seg_ntokens = nullptr,
                                int64_t* patch_seg = nullptr,
                                int64_t* patch_pos = nullptr,
                                int32_t* patch_uid = nullptr,
                                int32_t* patch_res = nullptr,
                                int64_t patch_cap = 0,
                                int64_t* n_patches = nullptr) {
  CallTimer call_timer(counters, SC_CALLS, SC_CALL_NS);
  next_fn next = pick(c->pattern);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  // NewRec (and the caller's news arrays) store piece start/end as
  // int32 ABSOLUTE buffer offsets: a >= 2 GiB buffer would silently
  // truncate deferred-news spans.  Reject with a distinct error; the
  // Python layer chunks its batches far below this.
  if (n_segs && seg_end[n_segs - 1] > (int64_t)INT32_MAX) return -5;
  int64_t base = n_segs ? seg_start[0] : 0;

  // Expand oversized segments into safe subsegments (see above).
  struct Sub {
    int64_t orig, start, end;
  };
  const int64_t SUB = c->subseg;
  std::vector<Sub> subs;
  subs.reserve((size_t)n_segs);
  bool any_split = false;
  for (int64_t k = 0; k < n_segs; k++) {
    int64_t cur = seg_start[k], b = seg_end[k];
    while (b - cur > 2 * SUB) {
      int64_t target = cur + SUB;
      int64_t limit = std::min(b - 2, target + SUB);
      int64_t p = target;
      while (p < limit && !safe_split_point(buf, p)) p++;
      if (p >= limit) break;  // no safe point in window: stop splitting
      subs.push_back(Sub{k, cur, p});
      any_split = true;
      cur = p;
    }
    subs.push_back(Sub{k, cur, b});
  }
  int64_t n_subs = (int64_t)subs.size();
  std::vector<int64_t> sub_np((size_t)n_subs, 0);
  std::vector<int64_t> sub_nt(es ? (size_t)n_subs : 0, 0);

  std::atomic<int64_t> next_k{0};
  std::atomic<int64_t> err{0};
  std::vector<std::vector<NewRec>> tnews((size_t)nthreads);
  std::vector<std::vector<Patch>> tpatches(es ? (size_t)nthreads : 0);
  std::vector<ScanSlots> tc;  // each worker's counters

  auto worker = [&](int t) {
    int64_t* cnt = counters ? tc[(size_t)t].v : nullptr;
    int64_t t0 = cnt ? now_ns() : 0;
    MemoEnt* memo = ctx_memo_for(c, t);
    MemoEnt16* memo16 = ctx_memo16_for(c, t);
    FuseScratch fsc;
    for (;;) {
      int64_t k = next_k.fetch_add(1);
      if (k >= n_subs || err.load(std::memory_order_relaxed)) break;
      int64_t n = scan_segment(c, next, buf, subs[(size_t)k].start,
                               subs[(size_t)k].end,
                               piece_uid + (subs[(size_t)k].start - base),
                               tnews[(size_t)t], memo, memo16, fs,
                               fs ? &fsc : nullptr, es,
                               es ? &tpatches[(size_t)t] : nullptr, k,
                               es ? &sub_nt[(size_t)k] : nullptr, cnt);
      if (n < 0) {
        err.store(n, std::memory_order_relaxed);
        break;
      }
      sub_np[(size_t)k] = n;
    }
    if (cnt) cnt[SC_BUSY_NS] += now_ns() - t0;
  };
  int t_count = (int)(nthreads < n_subs ? nthreads : n_subs);
  int n_workers = t_count > 1 ? t_count : 1;
  if (counters) tc.resize((size_t)n_workers);
  // Worker t owns memo slot t for the call's duration.
  ctx_size_memos(c, n_workers);
  if (t_count <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < t_count; t++) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
  }
  if (counters) {
    counters[SC_WORKERS] += n_workers;
    add_worker_counts(counters, tc, n_workers, SC_BUSY_NS, SC_BUSIEST_NS);
  }
  if (int64_t e = err.load(std::memory_order_relaxed)) return e;

  // Compact each original segment's subsegment runs so segment k's
  // output is contiguous at (seg_start[k] - base), the layout the
  // callers' (offset, count) views assume.  dest <= src always (uid
  // and id counts never exceed bytes), so left-to-right memmove is
  // safe; a segment's compacted run stays inside its own byte span,
  // never touching k+1.  In emit mode the compacted unit is the ID
  // stream (sub_nt) and each sub's final dest is recorded for the
  // patch fixup below.
  for (int64_t k = 0; k < n_segs; k++) seg_npieces[k] = 0;
  if (es)
    for (int64_t k = 0; k < n_segs; k++) seg_ntokens[k] = 0;
  const std::vector<int64_t>& sub_cnt = es ? sub_nt : sub_np;
  std::vector<int64_t> sub_dest(es ? (size_t)n_subs : 0, 0);
  if (any_split || es) {
    int64_t dest = 0, cur_orig = -1;
    for (int64_t i = 0; i < n_subs; i++) {
      const Sub& s = subs[(size_t)i];
      if (s.orig != cur_orig) {
        cur_orig = s.orig;
        dest = seg_start[s.orig] - base;
      }
      int64_t src = s.start - base;
      if (src != dest && sub_cnt[(size_t)i] > 0) {
        memmove(piece_uid + dest, piece_uid + src,
                (size_t)sub_cnt[(size_t)i] * sizeof(int32_t));
      }
      if (es) sub_dest[(size_t)i] = dest;
      dest += sub_cnt[(size_t)i];
      seg_npieces[s.orig] += sub_np[(size_t)i];
      if (es) seg_ntokens[s.orig] += sub_nt[(size_t)i];
    }
  } else {
    for (int64_t i = 0; i < n_subs; i++)
      seg_npieces[subs[(size_t)i].orig] += sub_np[(size_t)i];
  }


  int64_t nnew = 0, total = 0;
  for (auto& v : tnews) {
    for (const NewRec& r : v) {
      if (nnew >= new_cap) return -3;
      new_uid[nnew] = r.uid;
      new_start[nnew] = r.start;
      new_end[nnew] = r.end;
      nnew++;
    }
  }
  for (int64_t k = 0; k < n_segs; k++) total += seg_npieces[k];
  *n_new = nnew;

  if (es) {
    // Patch fixup LAST: a -6 overflow therefore returns with the news
    // arrays and *n_new already valid, so the caller can still
    // register + resolve the deferred pieces before falling back to
    // the classic path (every interned uid must end up with a row).
    int64_t np = 0;
    for (auto& v : tpatches) {
      for (const Patch& p : v) {
        if (np >= patch_cap) return -6;
        const Sub& s = subs[(size_t)p.sub];
        patch_seg[np] = s.orig;
        patch_pos[np] =
            (sub_dest[(size_t)p.sub] - (seg_start[s.orig] - base)) + p.pos;
        patch_uid[np] = p.uid;
        patch_res[np] = p.reserved;
        np++;
      }
    }
    *n_patches = np;
  }
  return total;
}

int64_t tt_ctx_split_batch(void* p, const uint8_t* buf,
                           const int64_t* seg_start, const int64_t* seg_end,
                           int64_t n_segs, int nthreads, int32_t* piece_uid,
                           int64_t* seg_npieces, int32_t* new_uid,
                           int32_t* new_start, int32_t* new_end,
                           int64_t new_cap, int64_t* n_new,
                           int64_t* counters) {
  return split_batch_impl((Ctx*)p, buf, seg_start, seg_end, n_segs, nthreads,
                          piece_uid, seg_npieces, new_uid, new_start,
                          new_end, new_cap, n_new, counters, nullptr);
}

// Fused variant: first-seen pieces are merged on the scanning threads
// and written straight into the caller's row matrix (see FuseState);
// only pieces that could NOT be fused land in the news arrays.  On
// return *row_next is the new row high-water mark (clamped to row_cap)
// and *n_fused counts fully-resolved pieces.  The caller must route
// the news through its ordinary wave path and must not pass a fs row
// region that any other thread concurrently reads or writes.
// ``old_*`` (all nullable) supply a FROZEN retired dedup generation:
// first-seen pieces probe it and copy already-resolved rows instead of
// re-merging (generational eviction; see FuseState).  *n_copied counts
// those copies (a subset of *n_fused).  ``defer_len`` (0: none) defers
// every first-seen piece longer than it to the news arrays unmerged.
int64_t tt_ctx_split_merge_batch(
    void* p, const uint8_t* buf, const int64_t* seg_start,
    const int64_t* seg_end, int64_t n_segs, int nthreads,
    int32_t* piece_uid, int64_t* seg_npieces, int32_t* new_uid,
    int32_t* new_start, int32_t* new_end, int64_t new_cap, int64_t* n_new,
    const int32_t* byte_to_id, const int32_t* kl, const int32_t* kr,
    const int32_t* vv, int32_t slot_bits, int32_t max_probes, int32_t* rows,
    int32_t* row_len, int32_t* row_u16, int64_t row_width, int64_t row_cap,
    int32_t* uid_rows, int64_t uid_cap, int64_t* row_next, int64_t* n_fused,
    const void* old_ctx, const int32_t* old_uid_rows,
    const int32_t* old_rows, const int32_t* old_row_len,
    const int32_t* old_row_u16, int64_t old_row_width, int64_t old_n_rows,
    int64_t* n_copied, int32_t* uid_ids, int64_t defer_len,
    int64_t* counters) {
  FuseState fs;
  fs.byte_to_id = byte_to_id;
  fs.kl = kl;
  fs.kr = kr;
  fs.vv = vv;
  fs.slot_bits = slot_bits;
  fs.max_probes = max_probes;
  fs.rows = rows;
  fs.row_len = row_len;
  fs.row_u16 = row_u16;
  fs.row_width = row_width;
  fs.row_cap = row_cap;
  fs.uid_rows = uid_rows;
  fs.uid_cap = uid_cap;
  fs.uid_ids = uid_ids;
  fs.defer_len = defer_len;
  fs.row_next.store(*row_next, std::memory_order_relaxed);
  fs.n_fused.store(0, std::memory_order_relaxed);
  fs.old_ctx = old_ctx;
  fs.old_uid_rows = old_uid_rows;
  fs.old_rows = old_rows;
  fs.old_row_len = old_row_len;
  fs.old_row_u16 = old_row_u16;
  fs.old_row_width = old_row_width;
  fs.old_n_rows = old_n_rows;
  fs.n_copied.store(0, std::memory_order_relaxed);
  int64_t rc = split_batch_impl((Ctx*)p, buf, seg_start, seg_end, n_segs,
                                nthreads, piece_uid, seg_npieces, new_uid,
                                new_start, new_end, new_cap, n_new, counters,
                                &fs);
  int64_t rn = fs.row_next.load(std::memory_order_relaxed);
  *row_next = rn < row_cap ? rn : row_cap;
  *n_fused = fs.n_fused.load(std::memory_order_relaxed);
  if (n_copied) *n_copied = fs.n_copied.load(std::memory_order_relaxed);
  return rc;
}

// Fused scan+merge+EMIT: one pass from bytes to token ids.  The
// split_merge_batch contract plus: ``out_ids`` receives each segment's
// id stream at (seg_start[k] - base) with counts in ``seg_ntokens``
// (the uid buffer is not written at all); first-seen pieces merge on
// the scanning threads and their ids emit inline; pieces that cannot
// resolve inline (deferred fuse, uid capacity) become HOLES reported
// via the patch arrays for the caller to backfill + compact.  Steady
// state emits zero holes and runs at scan speed.  ``defer_len`` as in
// tt_ctx_split_merge_batch: a first-seen piece longer than it is a hole.
// Returns total pieces or -3/-4/-5/-6.
int64_t tt_ctx_split_emit_batch(
    void* p, const uint8_t* buf, const int64_t* seg_start,
    const int64_t* seg_end, int64_t n_segs, int nthreads,
    int32_t* out_ids, int64_t* seg_ntokens, int64_t* seg_npieces,
    int32_t* new_uid, int32_t* new_start, int32_t* new_end,
    int64_t new_cap, int64_t* n_new, const int32_t* byte_to_id,
    const int32_t* kl, const int32_t* kr, const int32_t* vv,
    int32_t slot_bits, int32_t max_probes, int32_t* rows,
    int32_t* row_len, int32_t* row_u16, int64_t row_width,
    int64_t row_cap, int32_t* uid_rows, int64_t uid_cap,
    int64_t* row_next, int64_t* n_fused, const void* old_ctx,
    const int32_t* old_uid_rows, const int32_t* old_rows,
    const int32_t* old_row_len, const int32_t* old_row_u16,
    int64_t old_row_width, int64_t old_n_rows, int64_t* n_copied,
    const int32_t* ovf_pool, int64_t ovf_len, int64_t* patch_seg,
    int64_t* patch_pos, int32_t* patch_uid, int32_t* patch_res,
    int64_t patch_cap, int64_t* n_patches, int32_t* uid_ids,
    int64_t defer_len, int64_t* counters) {
  FuseState fs;
  fs.byte_to_id = byte_to_id;
  fs.kl = kl;
  fs.kr = kr;
  fs.vv = vv;
  fs.slot_bits = slot_bits;
  fs.max_probes = max_probes;
  fs.rows = rows;
  fs.row_len = row_len;
  fs.row_u16 = row_u16;
  fs.row_width = row_width;
  fs.row_cap = row_cap;
  fs.uid_rows = uid_rows;
  fs.uid_cap = uid_cap;
  fs.uid_ids = uid_ids;
  fs.defer_len = defer_len;
  fs.row_next.store(*row_next, std::memory_order_relaxed);
  fs.n_fused.store(0, std::memory_order_relaxed);
  fs.old_ctx = old_ctx;
  fs.old_uid_rows = old_uid_rows;
  fs.old_rows = old_rows;
  fs.old_row_len = old_row_len;
  fs.old_row_u16 = old_row_u16;
  fs.old_row_width = old_row_width;
  fs.old_n_rows = old_n_rows;
  fs.n_copied.store(0, std::memory_order_relaxed);
  EmitState es;
  es.out = out_ids;
  es.uid_rows = uid_rows;
  es.uid_cap = uid_cap;
  es.rows = rows;
  es.row_len = row_len;
  es.row_width = row_width;
  es.ovf_pool = ovf_pool;
  es.ovf_len = ovf_len;
  es.uid_ids = uid_ids;
  int64_t rc = split_batch_impl(
      (Ctx*)p, buf, seg_start, seg_end, n_segs, nthreads, out_ids,
      seg_npieces, new_uid, new_start, new_end, new_cap, n_new, counters,
      &fs, &es,
      seg_ntokens, patch_seg, patch_pos, patch_uid, patch_res, patch_cap,
      n_patches);
  int64_t rn = fs.row_next.load(std::memory_order_relaxed);
  *row_next = rn < row_cap ? rn : row_cap;
  *n_fused = fs.n_fused.load(std::memory_order_relaxed);
  if (n_copied) *n_copied = fs.n_copied.load(std::memory_order_relaxed);
  return rc;
}

// Backfill emit HOLES in place: patches (seg, pos-within-segment-
// stream, uid, reserved slots) splice each now-resolved row's ids into
// segment k's stream at out + seg_off[k] and close the reserved gaps.
// In-place left-to-right compaction is safe because a row never emits
// more ids than its reserved piece length.  Patches may arrive
// unsorted (per-thread collection order); sorted here.  seg_ntokens is
// updated in place.  Returns 0, or -1 if any patch's uid has no
// resolved row (caller bug — every news uid must have a row by now).
int64_t tt_backfill_patches(int32_t* out, const int64_t* seg_off,
                            int64_t* seg_ntokens, const int64_t* patch_seg,
                            const int64_t* patch_pos,
                            const int32_t* patch_uid,
                            const int32_t* patch_res, int64_t n_patches,
                            const int32_t* rows, const int32_t* row_len,
                            int64_t stride, const int32_t* uid_rows,
                            const int32_t* ovf_pool) {
  if (n_patches <= 0) return 0;
  std::vector<int64_t> order((size_t)n_patches);
  for (int64_t i = 0; i < n_patches; i++) order[(size_t)i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (patch_seg[a] != patch_seg[b]) return patch_seg[a] < patch_seg[b];
    return patch_pos[a] < patch_pos[b];
  });
  int64_t i = 0;
  while (i < n_patches) {
    int64_t k = patch_seg[order[(size_t)i]];
    int64_t j = i;
    while (j < n_patches && patch_seg[order[(size_t)j]] == k) j++;
    int32_t* seg = out + seg_off[k];
    int64_t nt = seg_ntokens[k];
    int64_t r = 0, w = 0;
    for (int64_t t = i; t < j; t++) {
      int64_t p = order[(size_t)t];
      int64_t pos = patch_pos[p];
      int64_t gap = pos - r;
      if (gap > 0 && w != r) memmove(seg + w, seg + r, gap * 4);
      w += gap;
      r = pos;
      int32_t row = uid_rows[patch_uid[p]];
      if (row < 0) return -1;
      int64_t m = row_len[row];
      const int32_t* src = rows + (int64_t)row * stride;
      if (m < 0) {
        if (!ovf_pool) return -1;
        m = -m - 1;
        src = ovf_pool + src[0];
      }
      memcpy(seg + w, src, (size_t)m * 4);
      w += m;
      r += patch_res[p];
    }
    if (r < nt && w != r) memmove(seg + w, seg + r, (nt - r) * 4);
    seg_ntokens[k] = w + (nt - r);
    i = j;
  }
  return 0;
}

// Probe-only batched span lookup against a FROZEN context (no inserts,
// no locks): out_uids[i] = the interned uid of blob[starts[i]:ends[i]],
// or -1 when absent.  Used to resurrect retired-generation rows on the
// unfused news path.
void tt_ctx_lookup_spans(const void* p, const uint8_t* blob,
                         const int64_t* starts, const int64_t* ends,
                         int64_t n, int64_t blob_len, int32_t* out_uids) {
  const Ctx* c = (const Ctx*)p;
  const Snap* sn = c->snap.load(std::memory_order_acquire);
  for (int64_t k = 0; k < n; k++) {
    int64_t i = starts[k], plen = ends[k] - starts[k];
    uint64_t key8 = plen <= 8 ? load_key8(blob, i, plen, blob_len) : 0;
    uint64_t h =
        plen <= 8 ? short_hash(key8, plen) : long_hash(blob, i, i + plen);
    int64_t s_;
    out_uids[k] = snap_find(sn, blob, i, plen, h, key8, &s_);
  }
}

// Decode assembly: concatenate blob[offs[id] : offs[id+1]] for each id.
// Ids >= n_ids (or with empty ranges — unknown ids) contribute nothing,
// matching the reference's silent skip (TikTokenizer.cs:591-599).
// Returns bytes written, or -1 on out_cap overflow.
int64_t tt_gather_bytes(const uint8_t* blob, const int64_t* offs,
                        int64_t n_ids, const int32_t* ids, int64_t n,
                        uint8_t* out, int64_t out_cap) {
  int64_t w = 0;
  for (int64_t k = 0; k < n; k++) {
    int32_t id = ids[k];
    if (id < 0 || id >= n_ids) continue;
    int64_t a = offs[id], b = offs[id + 1];
    if (w + (b - a) > out_cap) return -1;
    memcpy(out + w, blob + a, b - a);
    w += b - a;
  }
  return w;
}

// Batched id -> bytes gather for decode_batch: one call per WHOLE
// batch, texts fanned over threads.  Text t's ids are
// ids[id_bounds[t] : id_bounds[t+1]]; unknown ids (< 0 or >= n_ids)
// are skipped silently, the reference's decode semantics
// (TikTokenizer.cs:591-599).  Two phases like tt_assemble_batch:
//   out == null: write each text's gathered byte LENGTH to
//     text_offs[t+1] (text_offs[0] = 0, not prefix-summed) and return
//     the grand total;
//   out != null: text_offs must hold the prefix-summed offsets from
//     phase 1; copy text t's bytes to out + text_offs[t].  Returns
//     total bytes, or -1 on out_cap overrun.
// Replaces the former per-batch numpy passes (valid mask, safe where,
// lens, 2.3M-element cumsum) that dominated bulk-decode time.
int64_t tt_gather_bytes_batch(const uint8_t* blob, const int64_t* offs,
                              int64_t n_ids, const int32_t* ids,
                              const int64_t* id_bounds, int64_t n_texts,
                              int nthreads, int64_t* text_offs,
                              uint8_t* out, int64_t out_cap) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::atomic<int64_t> next_t{0};
  std::atomic<bool> overrun{false};
  auto worker = [&]() {
    for (;;) {
      int64_t t = next_t.fetch_add(1);
      if (t >= n_texts || overrun.load(std::memory_order_relaxed)) return;
      int64_t lo = id_bounds[t], hi = id_bounds[t + 1];
      if (!out) {
        int64_t sz = 0;
        for (int64_t k = lo; k < hi; k++) {
          int32_t id = ids[k];
          if (id < 0 || id >= n_ids) continue;
          sz += offs[id + 1] - offs[id];
        }
        text_offs[t + 1] = sz;
      } else {
        int64_t w = text_offs[t];
        for (int64_t k = lo; k < hi; k++) {
          int32_t id = ids[k];
          if (id < 0 || id >= n_ids) continue;
          int64_t a = offs[id], b = offs[id + 1];
          if (w + (b - a) > out_cap) {
            overrun.store(true, std::memory_order_relaxed);
            return;
          }
          memcpy(out + w, blob + a, b - a);
          w += b - a;
        }
      }
    }
  };
  int t_count = (int)(nthreads < n_texts ? nthreads : n_texts);
  if (t_count <= 1) {
    worker();
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < t_count; t++) threads.emplace_back(worker);
    for (auto& th : threads) th.join();
  }
  if (overrun.load(std::memory_order_relaxed)) return -1;
  if (!out) {
    text_offs[0] = 0;
    int64_t total = 0;
    for (int64_t t = 0; t < n_texts; t++) total += text_offs[t + 1];
    return total;
  }
  int64_t last = n_texts ? text_offs[n_texts] : 0;
  return last;
}

// Packs a span wave's tiles for the merge kernel straight into the
// wave's int32 upload buffer, in parallel/encode_step.py's shard-major
// layout: for each of n_shards shards, each tile's [L, B/n_shards] ids
// block (row-major, the shard's columns k*B/n .. (k+1)*B/n), then each
// tile's B/n lengths.  Tile t is tile_l[t] rows by tile_b[t] columns, of
// which the first tile_n[t] carry pieces: column c of tile t is piece
// piece_idx[sum(tile_n[:t]) + c], the bytes buf[starts[p] : ends[p]].
// A live cell holds byte_to_id of its byte, every other cell -1, a
// padding column's length 0: each cell is written once, row by row.
// Returns 0, -1 on a malformed plan (a tile shape, a width that does not
// split into n_shards, out_len), -2 on a piece index, span or length that
// does not fit; out is then partly written.
int tt_pack_span_tiles(const uint8_t* buf, int64_t buf_len,
                       const int64_t* starts, const int64_t* ends,
                       int64_t n_pieces, const int32_t* byte_to_id,
                       const int32_t* tile_l, const int32_t* tile_b,
                       const int32_t* tile_n, int32_t n_tiles,
                       const int64_t* piece_idx, int32_t n_shards,
                       int32_t* out, int64_t out_len) {
  if (n_shards < 1 || n_tiles < 0) return -1;
  int64_t n_ids = 0, part = 0, n_cols = 0;
  for (int32_t t = 0; t < n_tiles; t++) {
    int64_t L = tile_l[t], B = tile_b[t], nr = tile_n[t];
    if (L < 1 || B < 1 || B % n_shards || nr < 0 || nr > B) return -1;
    n_ids += L * (B / n_shards);
    part += L * (B / n_shards) + B / n_shards;
    n_cols += nr;
  }
  if (part * n_shards != out_len) return -1;
  for (int64_t c = 0; c < n_cols; c++) {
    int64_t p = piece_idx[c];
    if (p < 0 || p >= n_pieces) return -2;
    if (starts[p] < 0 || ends[p] < starts[p] || ends[p] > buf_len) return -2;
  }
  std::vector<const uint8_t*> src;
  std::vector<int32_t> len;
  for (int32_t k = 0; k < n_shards; k++) {
    int32_t* ids = out + k * part;
    int32_t* lens = ids + n_ids;
    const int64_t* pidx = piece_idx;
    for (int32_t t = 0; t < n_tiles; t++) {
      int64_t L = tile_l[t], bs = tile_b[t] / n_shards, nr = tile_n[t];
      int64_t c0 = k * bs;
      int64_t live = nr > c0 ? std::min(bs, nr - c0) : 0;
      src.resize((size_t)live);
      len.resize((size_t)live);
      int64_t rows = 0;  // the longest live column: rows below it are padding
      for (int64_t c = 0; c < live; c++) {
        int64_t p = pidx[c0 + c];
        int64_t n = ends[p] - starts[p];
        if (n > L) return -2;
        src[c] = buf + starts[p];
        len[c] = (int32_t)n;
        lens[c] = (int32_t)n;
        rows = std::max(rows, n);
      }
      for (int64_t c = live; c < bs; c++) lens[c] = 0;
      for (int64_t r = 0; r < rows; r++) {
        int32_t* row = ids + r * bs;
        for (int64_t c = 0; c < live; c++)
          row[c] = r < len[c] ? byte_to_id[src[c][r]] : -1;
        for (int64_t c = live; c < bs; c++) row[c] = -1;
      }
      std::fill(ids + rows * bs, ids + L * bs, -1);
      ids += L * bs;
      lens += bs;
      pidx += nr;
    }
  }
  return 0;
}

// Batched token-stream assembly: one call for a whole encode_batch.
// Segment k's pieces are uid_buf[seg_offs[k] : seg_offs[k]+seg_counts[k]];
// each uid maps through uid_rows (identity when uid_rows == null) to a
// row of the [n_rows, stride] id matrix.
//
// Overflow rows — pieces producing more ids than the row matrix is
// wide (long low-merge pieces, e.g. CJK runs) — live in a flat side
// pool: row_len[r] == -(k+1) encodes k ids at ovf_pool + rows[r*stride]
// (the row's first cell holds the pool offset).  With ovf_pool
// supplied every segment assembles natively; with ovf_pool == null the
// old behavior applies (totals[k] = -1 marks the caller's slow path).
//
// Phase 1 (out == null): write per-segment token totals into totals[k]
// and return the grand total. Phase 2 (out != null): copy segment k's
// ids to out + out_offs[k] (skip totals[k] < 0 segments).  Returns
// tokens written, or -1 if any segment would overrun out_cap.
// Segments fan out over nthreads with work stealing in both phases.
int64_t tt_assemble_batch(const int32_t* rows, const int32_t* row_len,
                          int64_t stride, const int32_t* uid_rows,
                          const int32_t* uid_buf, const int64_t* seg_offs,
                          const int64_t* seg_counts, int64_t n_segs,
                          int nthreads, int64_t* totals,
                          const int64_t* out_offs, int32_t* out,
                          int64_t out_cap, const int32_t* ovf_pool) {
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::atomic<int64_t> next_k{0};
  std::atomic<int64_t> err{0};

  // Work items: segments, with oversized segments subdivided by uid
  // RANGE so one giant document's assembly parallelizes like its scan
  // (the split layer's safe-point subdivision, applied downstream).
  struct AItem {
    int64_t k, off, cnt;  // uid range [off, off+cnt) within segment k
  };
  constexpr int64_t ACH = 1 << 16;
  std::vector<AItem> items;
  items.reserve((size_t)n_segs);
  for (int64_t k = 0; k < n_segs; k++) {
    int64_t cnt = seg_counts[k], off = 0;
    do {
      int64_t c = cnt - off > ACH ? ACH : cnt - off;
      items.push_back(AItem{k, off, c});
      off += c;
    } while (off < cnt);
  }
  int64_t n_items = (int64_t)items.size();
  // Per-item id totals; the gather call recomputes them (a row_len-only
  // pass, ~8 bytes/uid vs the gather's full id traffic) so multi-item
  // segments get exact intra-segment output offsets.
  std::vector<int64_t> item_tot((size_t)n_items, 0);
  std::vector<int64_t> item_dst((size_t)n_items, 0);

  // Both phases walk uid -> row -> row_len/rows, a dependent chain of
  // random accesses whose DRAM misses dominate once the row matrix
  // outgrows L2; rows are resolved in small batches with the next
  // batch's lines prefetched, mirroring the interning scan.
  constexpr int AB = 64;
  auto count_item = [&](int64_t i) {
    const AItem& it = items[(size_t)i];
    const int32_t* u = uid_buf + seg_offs[it.k] + it.off;
    int64_t cnt = it.cnt;
    int32_t rr[AB];
    int64_t total = 0;
    for (int64_t j0 = 0; j0 < cnt && total >= 0; j0 += AB) {
      int nb = (int)(cnt - j0 < AB ? cnt - j0 : AB);
      for (int t = 0; t < nb; t++) {
        int32_t r = uid_rows ? uid_rows[u[j0 + t]] : u[j0 + t];
        rr[t] = r;
        if (r >= 0) __builtin_prefetch(&row_len[r], 0, 1);
      }
      for (int t = 0; t < nb; t++) {
        if (rr[t] < 0) {
          // Unpublished uid (in-flight wave): caller protocol
          // violation — fail loudly instead of reading row_len[-1].
          err.store(-7, std::memory_order_relaxed);
          return;
        }
        int32_t m = row_len[rr[t]];
        if (m < 0) {
          if (!ovf_pool) {
            total = -1;
            break;
          }
          m = -m - 1;
        }
        total += m;
      }
    }
    item_tot[(size_t)i] = total;
  };

  auto run_items = [&](auto&& fn) {
    next_k.store(0, std::memory_order_relaxed);
    auto w = [&]() {
      for (;;) {
        int64_t i = next_k.fetch_add(1);
        if (i >= n_items || err.load(std::memory_order_relaxed)) return;
        fn(i);
      }
    };
    int t_count = (int)(nthreads < n_items ? nthreads : n_items);
    if (t_count <= 1) {
      w();
    } else {
      std::vector<std::thread> threads;
      for (int t = 0; t < t_count; t++) threads.emplace_back(w);
      for (auto& t : threads) t.join();
    }
  };

  run_items(count_item);
  if (int64_t e = err.load(std::memory_order_relaxed)) return e;

  if (!out) {
    for (int64_t k = 0; k < n_segs; k++) totals[k] = 0;
    for (int64_t i = 0; i < n_items; i++) {
      int64_t k = items[(size_t)i].k;
      if (item_tot[(size_t)i] < 0 || totals[k] < 0)
        totals[k] = -1;
      else
        totals[k] += item_tot[(size_t)i];
    }
  } else {
    // Exact per-item destinations from the recount, then parallel
    // gather.  A segment whose count call reported -1 is skipped (the
    // caller routes it through its python overflow fallback).
    for (int64_t i = 0; i < n_items; i++) {
      const AItem& it = items[(size_t)i];
      if (totals[it.k] < 0 || item_tot[(size_t)i] < 0) {
        item_tot[(size_t)i] = -1;
        continue;
      }
      int64_t dst = it.off == 0
                        ? out_offs[it.k]
                        : item_dst[(size_t)i - 1] + item_tot[(size_t)i - 1];
      item_dst[(size_t)i] = dst;
      if (dst + item_tot[(size_t)i] > out_cap) return -1;
    }
    run_items([&](int64_t i) {
      const AItem& it = items[(size_t)i];
      if (item_tot[(size_t)i] < 0) return;
      const int32_t* u = uid_buf + seg_offs[it.k] + it.off;
      int64_t cnt = it.cnt;
      int32_t rr[AB];
      int32_t* dst = out + item_dst[(size_t)i];
      for (int64_t j0 = 0; j0 < cnt; j0 += AB) {
        int nb = (int)(cnt - j0 < AB ? cnt - j0 : AB);
        for (int t = 0; t < nb; t++) {
          int32_t r = uid_rows ? uid_rows[u[j0 + t]] : u[j0 + t];
          rr[t] = r;
          if (r < 0) {
            err.store(-7, std::memory_order_relaxed);
            return;
          }
          __builtin_prefetch(&row_len[r], 0, 1);
          __builtin_prefetch(rows + (int64_t)r * stride, 0, 1);
        }
        for (int t = 0; t < nb; t++) {
          int32_t r = rr[t];
          int64_t m = row_len[r];
          const int32_t* src = rows + (int64_t)r * stride;
          if (m < 0) {
            m = -m - 1;
            src = ovf_pool + src[0];
          }
          memcpy(dst, src, m * sizeof(int32_t));
          dst += m;
        }
      }
    });
  }
  if (int64_t e = err.load(std::memory_order_relaxed)) return e;
  if (!out) {
    int64_t grand = 0;
    for (int64_t k = 0; k < n_segs; k++)
      if (totals[k] > 0) grand += totals[k];
    return grand;
  }
  int64_t written = 0;
  for (int64_t k = 0; k < n_segs; k++)
    if (totals[k] > 0) written += totals[k];
  return written;
}

// ---- exact byte-pair merge for oversized pieces ------------------------
//

// Returns the number of ids written to out, or -1 if out_cap is too
// small.  out_cap == n always suffices.
int64_t tt_bpe_encode(const uint8_t* piece, int64_t n,
                      const int32_t* byte_to_id, const int32_t* kl,
                      const int32_t* kr, const int32_t* vv,
                      int32_t slot_bits, int32_t max_probes, int32_t* out,
                      int64_t out_cap) {
  BpeScratch s;
  return bpe_merge_core(piece, n, byte_to_id, kl, kr, vv, slot_bits,
                        max_probes, out, out_cap, s);
}

// Batched merge: piece i is blob[starts[i] : ends[i]] (spans may be
// scattered — e.g. first-occurrence ranges inside a corpus buffer);
// its ids land at out + out_offs[i], whose capacity out_offs[i+1] -
// out_offs[i] must be >= the piece's byte length (a merge never emits
// more ids than input bytes), with the count in out_counts[i].
// A LOOKUP-FIRST step mirrors the engine order of operations
// (TikTokenizer.cs:261-268): whole_ids[i] >= 0 short-circuits piece i
// to that single id (the caller resolves whole-piece hits against its
// encoder dict and passes them in; whole_ids == null skips the step —
// valid whenever force-host/unreachable tokens were filtered upstream,
// because the merge of any REACHABLE vocab token reproduces its id).
// Pieces fan out over nthreads with work stealing.  ``counters``
// (nullable) is added to (SC_BPE_*, see ScanCounter).  Returns 0, or -1
// if any piece overflowed its capacity.
int64_t tt_bpe_encode_batch(const uint8_t* blob, const int64_t* starts,
                            const int64_t* ends, const int64_t* out_offs,
                            int64_t n_pieces, const int32_t* whole_ids,
                            const int32_t* byte_to_id, const int32_t* kl,
                            const int32_t* kr, const int32_t* vv,
                            int32_t slot_bits, int32_t max_probes,
                            int nthreads, int32_t* out,
                            int32_t* out_counts, int64_t* counters) {
  CallTimer call_timer(counters, SC_BPE_CALLS, SC_BPE_CALL_NS);
  if (nthreads < 1) nthreads = 1;
  if (nthreads > 64) nthreads = 64;
  std::atomic<int64_t> next_i{0};
  std::atomic<int64_t> err{0};
  std::vector<ScanSlots> tc;  // each worker's counters
  auto worker = [&](int t) {
    BpeScratch s;
    int64_t* cnt = counters ? tc[(size_t)t].v : nullptr;
    for (;;) {
      int64_t i = next_i.fetch_add(1);
      if (i >= n_pieces || err.load(std::memory_order_relaxed)) return;
      int64_t a = starts[i], b = ends[i], o = out_offs[i];
      if (cnt) {
        cnt[SC_BPE_PIECES] += 1;
        cnt[SC_BPE_BYTES] += b - a;
      }
      if (whole_ids && whole_ids[i] >= 0) {
        out[o] = whole_ids[i];
        out_counts[i] = 1;
        continue;
      }
      int64_t t0 = cnt ? now_ns() : 0;
      int64_t w = bpe_merge_core(blob + a, b - a, byte_to_id, kl, kr, vv,
                                 slot_bits, max_probes, out + o,
                                 out_offs[i + 1] - o, s);
      if (cnt) {
        int64_t dt = now_ns() - t0;
        cnt[SC_BPE_MERGE_NS] += dt;
        cnt[SC_BPE_LONGEST_NS] = std::max(cnt[SC_BPE_LONGEST_NS], dt);
      }
      if (w < 0) {
        err.store(-1, std::memory_order_relaxed);
        return;
      }
      out_counts[i] = (int32_t)w;
    }
  };
  int t_count = (int)(nthreads < n_pieces ? nthreads : n_pieces);
  int n_workers = t_count > 1 ? t_count : 1;
  if (counters) tc.resize((size_t)n_workers);
  if (t_count <= 1) {
    worker(0);
  } else {
    std::vector<std::thread> threads;
    for (int t = 0; t < t_count; t++) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
  }
  if (counters)
    add_worker_counts(counters, tc, n_workers, SC_BPE_LONGEST_NS,
                      SC_BPE_LONGEST_NS);
  return err.load(std::memory_order_relaxed);
}

int tt_abi_version(void) { return 14; }

}  // extern "C"
