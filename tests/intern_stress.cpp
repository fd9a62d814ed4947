// Stress of the port scanner's intern table (tokenizer_tpu_torch's
// presplit.cpp), built with ThreadSanitizer by
// tests/test_torch_intern_concurrency.py:
//
//   g++ -std=c++17 -O1 -g -fsanitize=thread -pthread -fno-exceptions \
//       tokenizer_tpu_torch/runtime/native/presplit.cpp \
//       tests/intern_stress.cpp -o intern_stress
//   ./intern_stress [rounds]
//
// For each thread count (1, 2, 8, 16) and round, a fresh context splits
// three inputs in turn through tt_ctx_split_batch:
//   collide  100 segments of 150 fresh words and 150 words of a shared
//            pool of 2,000, each segment listed 4 times in a row, so
//            that several threads meet the same first-seen pieces at
//            once;
//   grow     90,000 fresh pieces (half of 3-8 bytes, half of 41-71
//            bytes) in 90 segments listed twice: more than 70,000
//            distinct pieces in one call, so the slots and the arena
//            grow mid-call;
//   collide  again: every piece known, no news.
// After each call every piece occurrence (cut by tt_presplit) must map
// to one uid and every uid to one piece, uids must be dense, every
// fresh uid must be reported exactly once with its own bytes, and
// tt_ctx_n_pieces and the inserts counter must equal the distinct
// pieces seen.
//
// Then the fused calls, at 8 threads: for each round, each of
// tt_ctx_split_merge_batch and tt_ctx_split_emit_batch, ``defer_len`` 0
// and 6, and a row matrix that holds every piece or only 4,000 rows (so
// that the workers race for its tail), a fresh context splits collide
// with a small pair table (letter pairs merge).  After each call a
// tt_ctx_split_batch of the same input gives each occurrence's uid (and
// must find nothing new); then: a uid with a row was merged in the scan
// (a row below the cap, no row claimed twice, the ids of
// tt_bpe_encode_batch,
// the compact table's entry, no piece longer than ``defer_len``), a uid
// without one is reported in the news exactly once with its bytes; the
// counters add up (fused, deferred long, deferred for capacity); in emit
// mode every occurrence is either its ids inline or a hole of its
// length naming its uid, and a piece without a row is always a hole.
//
// Prints one line "ok ..." and exits 0, or names the first fault and
// exits 1.

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#include <algorithm>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {
void* tt_ctx_new(int pattern);
void tt_ctx_free(void* p);
int64_t tt_ctx_n_pieces(void* p);
int64_t tt_presplit(const uint8_t* buf, int64_t start, int64_t end,
                    int pattern, int32_t* out_ends, int64_t cap);
int64_t tt_ctx_split_batch(void* p, const uint8_t* buf,
                           const int64_t* seg_start, const int64_t* seg_end,
                           int64_t n_segs, int nthreads, int32_t* piece_uid,
                           int64_t* seg_npieces, int32_t* new_uid,
                           int32_t* new_start, int32_t* new_end,
                           int64_t new_cap, int64_t* n_new,
                           int64_t* counters);
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
    int64_t* counters);
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
    int64_t defer_len, int64_t* counters);
int64_t tt_bpe_encode_batch(const uint8_t* blob, const int64_t* starts,
                            const int64_t* ends, const int64_t* out_offs,
                            int64_t n_pieces, const int32_t* whole_ids,
                            const int32_t* byte_to_id, const int32_t* kl,
                            const int32_t* kr, const int32_t* vv,
                            int32_t slot_bits, int32_t max_probes,
                            int nthreads, int32_t* out, int32_t* out_counts,
                            int64_t* counters);
}

namespace {

constexpr int PATTERN = 2;  // cl100k: " word" is one piece
// ScanCounter slots (presplit.cpp).
constexpr int SC_COUNT = 32;
constexpr int SC_INSERTS = 6;
constexpr int SC_REBUILDS = 9;
constexpr int SC_FUSED_SHORT = 11;
constexpr int SC_FUSED_LONG = 14;
constexpr int SC_DEFER_OFF = 20;
constexpr int SC_DEFER_CAPACITY = 21;
constexpr int SC_DEFER_WIDE = 22;
constexpr int SC_DEFER_LONG = 31;
constexpr int FUSED_THREADS = 8;
constexpr int64_t ROW_WIDTH = 128;
constexpr int64_t TIGHT_ROWS = 4000;
// Rows (and uids) for every distinct piece of collide (17,000).
constexpr int64_t AMPLE_ROWS = 1 << 15;

struct Rng {
  uint64_t s;
  uint64_t next() {  // splitmix64
    uint64_t z = (s += 0x9E3779B97F4A7C15ULL);
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
  }
  int64_t in(int64_t lo, int64_t hi) {  // [lo, hi]
    return lo + (int64_t)(next() % (uint64_t)(hi - lo + 1));
  }
};

// ``n`` pieces " word" with word lengths in [lo, hi], none in ``seen``.
std::vector<std::string> fresh(Rng& r, size_t n, int lo, int hi,
                               std::unordered_set<std::string>& seen) {
  std::vector<std::string> out;
  while (out.size() < n) {
    std::string w = " ";
    for (int64_t k = r.in(lo, hi); k > 0; k--) w += (char)('a' + r.in(0, 25));
    if (seen.insert(w).second) out.push_back(w);
  }
  return out;
}

struct Input {
  std::string buf;
  std::vector<int64_t> start, end;
  void add(const std::string& seg, int copies) {
    for (int c = 0; c < copies; c++) {
      start.push_back((int64_t)buf.size());
      buf += seg;
      end.push_back((int64_t)buf.size());
    }
  }
};

void fail(const char* what, int threads, int round, const char* input) {
  printf("FAIL %s (threads %d, round %d, input %s)\n", what, threads, round,
         input);
  exit(1);
}

// What one context has handed out so far.
struct Seen {
  std::unordered_map<std::string, int32_t> uid_of;
  std::vector<std::string> bytes_of;  // by uid
  std::vector<char> reported;         // by uid
};

// One split_batch call of ``in`` and every check of it; returns the call's
// rebuilds.
int64_t run_call(void* ctx, const Input& in, int threads, Seen& seen,
                 int round, const char* name, int64_t* news_total) {
  const uint8_t* buf = (const uint8_t*)in.buf.data();
  int64_t n_segs = (int64_t)in.start.size();
  int64_t cap = (int64_t)in.buf.size();
  std::vector<int32_t> uid((size_t)cap), nu((size_t)cap), ns((size_t)cap),
      ne((size_t)cap), ends((size_t)cap);
  std::vector<int64_t> np((size_t)n_segs), cnt(SC_COUNT, 0);
  int64_t n_new = 0;
  int64_t before = tt_ctx_n_pieces(ctx);
  int64_t rc = tt_ctx_split_batch(ctx, buf, in.start.data(), in.end.data(),
                                  n_segs, threads, uid.data(), np.data(),
                                  nu.data(), ns.data(), ne.data(), cap,
                                  &n_new, cnt.data());
  if (rc < 0) fail("tt_ctx_split_batch returned an error", threads, round, name);
  int64_t n = tt_ctx_n_pieces(ctx);
  // Every occurrence: one uid per piece, one piece per uid, uids dense.
  for (int64_t k = 0; k < n_segs; k++) {
    int64_t a = in.start[(size_t)k], b = in.end[(size_t)k];
    int64_t m = tt_presplit(buf, a, b, PATTERN, ends.data(), cap);
    if (m != np[(size_t)k]) fail("piece count differs from tt_presplit", threads, round, name);
    const int32_t* u = uid.data() + (a - in.start[0]);
    int64_t p = a;
    for (int64_t j = 0; j < m; j++) {
      std::string piece(in.buf, (size_t)p, (size_t)(ends[(size_t)j] - p));
      p = ends[(size_t)j];
      if (u[j] < 0 || u[j] >= n) fail("uid outside 0..n_pieces-1", threads, round, name);
      auto it = seen.uid_of.find(piece);
      if (it != seen.uid_of.end()) {
        if (it->second != u[j]) fail("one piece, two uids", threads, round, name);
        continue;
      }
      if ((size_t)n > seen.bytes_of.size()) {
        seen.bytes_of.resize((size_t)n);
        seen.reported.resize((size_t)n, 0);
      }
      if (!seen.bytes_of[(size_t)u[j]].empty()) fail("one uid, two pieces", threads, round, name);
      seen.bytes_of[(size_t)u[j]] = piece;
      seen.uid_of.emplace(piece, u[j]);
    }
  }
  // Every fresh uid reported once, with its own bytes.
  for (int64_t j = 0; j < n_new; j++) {
    int32_t v = nu[(size_t)j];
    if (v < before || v >= n) fail("a reported uid is not fresh", threads, round, name);
    if (seen.reported[(size_t)v]) fail("a uid reported twice", threads, round, name);
    seen.reported[(size_t)v] = 1;
    std::string piece(in.buf, (size_t)ns[(size_t)j], (size_t)(ne[(size_t)j] - ns[(size_t)j]));
    if (piece != seen.bytes_of[(size_t)v]) fail("a reported span is not its uid's piece", threads, round, name);
  }
  if (n_new != n - before) fail("fresh uids and reports differ in number", threads, round, name);
  if ((int64_t)seen.uid_of.size() != n) fail("n_pieces is not the distinct pieces", threads, round, name);
  if (cnt[SC_INSERTS] != n - before) fail("the inserts counter is not the growth", threads, round, name);
  *news_total += n_new;
  return cnt[SC_REBUILDS];
}

// A pair table in the scanner's layout (tt_pair_rank): every pair of
// letters (x, y) with (x + y) % 3 == 0 merges into 256 + 26 x + y.
struct Table {
  static constexpr int32_t SLOT_BITS = 12, MAX_PROBES = 32;
  std::vector<int32_t> b2i, kl, kr, vv;
  Table() : b2i(256), kl(1 << SLOT_BITS, -1), kr(1 << SLOT_BITS, -1),
            vv(1 << SLOT_BITS, -1) {
    for (int b = 0; b < 256; b++) b2i[(size_t)b] = b;
    for (int x = 0; x < 26; x++)
      for (int y = 0; y < 26; y++)
        if ((x + y) % 3 == 0) put('a' + x, 'a' + y, 256 + 26 * x + y);
  }
  void put(int32_t l, int32_t r, int32_t v) {
    uint32_t h = ((uint32_t)l * 0x85EBCA6Bu) ^ ((uint32_t)r * 0xC2B2AE35u);
    h ^= h >> 16;
    uint32_t slot = (uint32_t)(((uint64_t)h * 0x9E3779B9u & 0xFFFFFFFFu)) >>
                    (32 - SLOT_BITS);
    while (kl[slot] != -1) slot = (slot + 1) & ((1u << SLOT_BITS) - 1);
    kl[slot] = l;
    kr[slot] = r;
    vv[slot] = v;
  }
  // Each distinct piece of ``in`` (cut by tt_presplit) and its ids, by
  // one tt_bpe_encode_batch call on one thread.
  std::unordered_map<std::string, std::vector<int32_t>> encode_all(
      const Input& in) const {
    std::unordered_map<std::string, std::vector<int32_t>> out;
    std::vector<int32_t> ends(in.buf.size());
    std::vector<int64_t> st, en, offs;
    for (size_t k = 0; k < in.start.size(); k++) {
      int64_t p = in.start[k];
      int64_t m = tt_presplit((const uint8_t*)in.buf.data(), p, in.end[k], PATTERN,
                              ends.data(), (int64_t)ends.size());
      for (int64_t j = 0; j < m; j++) {
        std::string piece(in.buf, (size_t)p, (size_t)(ends[(size_t)j] - p));
        if (out.emplace(piece, std::vector<int32_t>()).second) {
          offs.push_back(st.empty() ? 0 : offs.back() + (en.back() - st.back()));
          st.push_back(p);
          en.push_back(ends[(size_t)j]);
        }
        p = ends[(size_t)j];
      }
    }
    offs.push_back(st.empty() ? 0 : offs.back() + (en.back() - st.back()));
    std::vector<int32_t> ids(in.buf.size()), counts(st.size());
    if (tt_bpe_encode_batch((const uint8_t*)in.buf.data(), st.data(), en.data(), offs.data(),
                            (int64_t)st.size(), nullptr, b2i.data(), kl.data(), kr.data(),
                            vv.data(), SLOT_BITS, MAX_PROBES, 1, ids.data(), counts.data(),
                            nullptr) < 0) {
      printf("FAIL tt_bpe_encode_batch\n");
      exit(1);
    }
    for (size_t i = 0; i < st.size(); i++)
      out[std::string(in.buf, (size_t)st[i], (size_t)(en[i] - st[i]))].assign(
          ids.begin() + offs[i], ids.begin() + offs[i] + counts[i]);
    return out;
  }
};

void fused_fail(const char* what, bool emit, int64_t defer_len, int64_t row_cap,
                int round) {
  printf("FAIL %s (fused %s, defer_len %lld, row_cap %lld, round %d)\n", what,
         emit ? "emit" : "merge", (long long)defer_len, (long long)row_cap,
         round);
  exit(1);
}

// One fused call of ``in`` on a fresh context and every check of it;
// returns the pieces it merged in the scan.
int64_t run_fused(const Table& t, const Input& in,
                  const std::unordered_map<std::string, std::vector<int32_t>>& ids,
                  bool emit, int64_t defer_len, int64_t row_cap, int round) {
#define FAIL(what) fused_fail(what, emit, defer_len, row_cap, round)
  void* ctx = tt_ctx_new(PATTERN);
  if (!ctx) FAIL("tt_ctx_new");
  const uint8_t* buf = (const uint8_t*)in.buf.data();
  int64_t n_segs = (int64_t)in.start.size();
  int64_t cap = (int64_t)in.buf.size();
  int64_t uid_cap = AMPLE_ROWS;
  std::vector<int32_t> out((size_t)cap), nu((size_t)cap), ns((size_t)cap),
      ne((size_t)cap), rows((size_t)(row_cap * ROW_WIDTH), 0),
      row_len((size_t)row_cap, 0), row_u16((size_t)row_cap, 0),
      uid_rows((size_t)uid_cap, -1), uid_ids((size_t)(uid_cap * 8), 0),
      p_uid((size_t)cap), p_res((size_t)cap);
  std::vector<int64_t> np((size_t)n_segs), nt((size_t)n_segs),
      p_seg((size_t)cap), p_pos((size_t)cap), cnt(SC_COUNT, 0);
  int64_t n_new = 0, row_next = 0, n_fused = 0, n_copied = 0, n_patches = 0;
  int64_t rc;
  if (emit) {
    rc = tt_ctx_split_emit_batch(
        ctx, buf, in.start.data(), in.end.data(), n_segs, FUSED_THREADS,
        out.data(), nt.data(), np.data(), nu.data(), ns.data(), ne.data(),
        cap, &n_new, t.b2i.data(), t.kl.data(), t.kr.data(), t.vv.data(),
        Table::SLOT_BITS, Table::MAX_PROBES, rows.data(), row_len.data(),
        row_u16.data(), ROW_WIDTH, row_cap, uid_rows.data(), uid_cap,
        &row_next, &n_fused, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
        0, &n_copied, nullptr, 0, p_seg.data(), p_pos.data(), p_uid.data(),
        p_res.data(), cap, &n_patches, uid_ids.data(), defer_len, cnt.data());
  } else {
    rc = tt_ctx_split_merge_batch(
        ctx, buf, in.start.data(), in.end.data(), n_segs, FUSED_THREADS,
        out.data(), np.data(), nu.data(), ns.data(), ne.data(), cap, &n_new,
        t.b2i.data(), t.kl.data(), t.kr.data(), t.vv.data(), Table::SLOT_BITS,
        Table::MAX_PROBES, rows.data(), row_len.data(), row_u16.data(),
        ROW_WIDTH, row_cap, uid_rows.data(), uid_cap, &row_next, &n_fused,
        nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, &n_copied,
        uid_ids.data(), defer_len, cnt.data());
  }
  if (rc < 0) FAIL("the fused call returned an error");
  int64_t n = tt_ctx_n_pieces(ctx);
  // Each occurrence's uid, from the same context (nothing may be new).
  std::vector<int32_t> uid((size_t)cap), nu2((size_t)cap), ns2((size_t)cap),
      ne2((size_t)cap), ends((size_t)cap);
  std::vector<int64_t> np2((size_t)n_segs);
  int64_t n_new2 = 0;
  if (tt_ctx_split_batch(ctx, buf, in.start.data(), in.end.data(), n_segs,
                         FUSED_THREADS, uid.data(), np2.data(), nu2.data(),
                         ns2.data(), ne2.data(), cap, &n_new2, nullptr) < 0 ||
      n_new2 != 0 || tt_ctx_n_pieces(ctx) != n)
    FAIL("a second split found new pieces");
  std::vector<std::string> piece_of((size_t)n);
  std::vector<std::vector<int32_t>> ids_of((size_t)n);
  for (int64_t k = 0; k < n_segs; k++) {
    int64_t a = in.start[(size_t)k], b = in.end[(size_t)k];
    int64_t m = tt_presplit(buf, a, b, PATTERN, ends.data(), cap);
    if (m != np[(size_t)k] || m != np2[(size_t)k]) FAIL("piece count differs from tt_presplit");
    const int32_t* u = uid.data() + (a - in.start[0]);
    int64_t p = a;
    for (int64_t j = 0; j < m; j++) {
      std::string piece(in.buf, (size_t)p, (size_t)(ends[(size_t)j] - p));
      p = ends[(size_t)j];
      if (u[j] < 0 || u[j] >= n) FAIL("uid outside 0..n_pieces-1");
      std::string& known = piece_of[(size_t)u[j]];
      if (known.empty()) {
        known = piece;
        ids_of[(size_t)u[j]] = ids.at(piece);
      } else if (known != piece) {
        FAIL("one uid, two pieces");
      }
    }
  }
  // Rows: merged in the scan, one row each, below the cap, exact.
  std::vector<char> row_taken((size_t)row_cap, 0), reported((size_t)n, 0);
  int64_t with_row = 0, longer = 0;
  for (int64_t v = 0; v < n; v++) {
    const std::string& piece = piece_of[(size_t)v];
    if (piece.empty()) FAIL("a uid without an occurrence");
    if (defer_len > 0 && (int64_t)piece.size() > defer_len) longer++;
    int32_t r = uid_rows[(size_t)v];
    if (r < 0) continue;
    with_row++;
    if (r >= row_cap || r >= row_next) FAIL("a row beyond the cap or the high-water mark");
    if (row_taken[(size_t)r]) FAIL("one row claimed twice");
    row_taken[(size_t)r] = 1;
    if (defer_len > 0 && (int64_t)piece.size() > defer_len) FAIL("a piece longer than defer_len merged");
    const std::vector<int32_t>& want = ids_of[(size_t)v];
    if (row_len[(size_t)r] != (int32_t)want.size() ||
        !std::equal(want.begin(), want.end(), rows.begin() + r * ROW_WIDTH))
      FAIL("a row's ids are not tt_bpe_encode's");
    if (row_u16[(size_t)r] != (int32_t)piece.size()) FAIL("a row's UTF-16 units");
    if (want.size() <= 7) {
      const int32_t* cc = uid_ids.data() + v * 8;
      if (cc[0] != (int32_t)want.size() || !std::equal(want.begin(), want.end(), cc + 1))
        FAIL("the compact table's entry");
    }
  }
  // The rest: in the news exactly once, with their bytes.
  for (int64_t j = 0; j < n_new; j++) {
    int32_t v = nu[(size_t)j];
    if (v < 0 || v >= n || uid_rows[(size_t)v] >= 0 || reported[(size_t)v])
      FAIL("a news entry that has a row or came twice");
    reported[(size_t)v] = 1;
    if (std::string(in.buf, (size_t)ns[(size_t)j], (size_t)(ne[(size_t)j] - ns[(size_t)j])) !=
        piece_of[(size_t)v])
      FAIL("a news span is not its uid's piece");
  }
  if (with_row != n_fused || with_row + n_new != n) FAIL("fused and news do not add up to the pieces");
  if (cnt[SC_INSERTS] != n || cnt[SC_FUSED_SHORT] + cnt[SC_FUSED_LONG] != n_fused ||
      cnt[SC_DEFER_LONG] != longer || cnt[SC_DEFER_OFF] != 0 || cnt[SC_DEFER_WIDE] != 0 ||
      cnt[SC_DEFER_LONG] + cnt[SC_DEFER_CAPACITY] != n_new)
    FAIL("the counters do not add up");
  if (row_cap >= n && cnt[SC_DEFER_CAPACITY] != 0) FAIL("a capacity deferral with rows to spare");
  if (row_cap < n - longer && row_next < row_cap) FAIL("the tail was not reached");
  if (emit) {
    // Each segment's stream: inline ids, or a hole of the piece's length.
    std::vector<std::vector<std::pair<int64_t, int64_t>>> holes((size_t)n_segs);
    for (int64_t j = 0; j < n_patches; j++)
      holes[(size_t)p_seg[(size_t)j]].push_back({p_pos[(size_t)j], j});
    for (auto& h : holes) std::sort(h.begin(), h.end());
    for (int64_t k = 0; k < n_segs; k++) {
      const int32_t* u = uid.data() + (in.start[(size_t)k] - in.start[0]);
      const int32_t* o = out.data() + (in.start[(size_t)k] - in.start[0]);
      int64_t cur = 0;
      size_t h = 0;
      for (int64_t j = 0; j < np[(size_t)k]; j++) {
        int32_t v = u[j];
        const std::string& piece = piece_of[(size_t)v];
        if (h < holes[(size_t)k].size() && holes[(size_t)k][h].first == cur) {
          int64_t q = holes[(size_t)k][h++].second;
          if (p_uid[(size_t)q] != v || p_res[(size_t)q] != (int32_t)piece.size())
            FAIL("a hole names another piece");
          cur += (int64_t)piece.size();
          continue;
        }
        if (uid_rows[(size_t)v] < 0) FAIL("a piece without a row emitted inline");
        const std::vector<int32_t>& want = ids_of[(size_t)v];
        if (!std::equal(want.begin(), want.end(), o + cur)) FAIL("inline ids differ");
        cur += (int64_t)want.size();
      }
      if (h != holes[(size_t)k].size() || cur != nt[(size_t)k]) FAIL("a segment's stream length");
    }
  }
#undef FAIL
  tt_ctx_free(ctx);
  return n_fused;
}

}  // namespace

int main(int argc, char** argv) {
  int rounds = argc > 1 ? atoi(argv[1]) : 3;
  Rng r{15};
  std::unordered_set<std::string> used;
  std::vector<std::string> pool = fresh(r, 2000, 2, 11, used);
  Input collide, grow;
  for (int s = 0; s < 100; s++) {
    std::vector<std::string> own = fresh(r, 150, 2, 11, used);
    std::string seg;
    for (int j = 0; j < 150; j++) seg += own[(size_t)j] + pool[(size_t)r.in(0, 1999)];
    collide.add(seg, 4);
  }
  std::vector<std::string> shorts = fresh(r, 45000, 2, 7, used);
  std::vector<std::string> longs = fresh(r, 45000, 40, 70, used);
  for (int s = 0; s < 90; s++) {
    std::string seg;
    for (int j = 0; j < 500; j++)
      seg += shorts[(size_t)(s * 500 + j)] + longs[(size_t)(s * 500 + j)];
    grow.add(seg, 2);
  }
  int64_t calls = 0, news = 0, grow_rebuilds = -1, distinct = 0;
  for (int threads : {1, 2, 8, 16}) {
    for (int round = 0; round < rounds; round++) {
      void* ctx = tt_ctx_new(PATTERN);
      if (!ctx) fail("tt_ctx_new", threads, round, "-");
      Seen seen;
      run_call(ctx, collide, threads, seen, round, "collide", &news);
      int64_t rb = run_call(ctx, grow, threads, seen, round, "grow", &news);
      if (rb < 2) fail("the table grew fewer than two times mid-call", threads, round, "grow");
      if (grow_rebuilds < 0 || rb < grow_rebuilds) grow_rebuilds = rb;
      int64_t n0 = tt_ctx_n_pieces(ctx);
      run_call(ctx, collide, threads, seen, round, "collide again", &news);
      if (tt_ctx_n_pieces(ctx) != n0) fail("a warm call interned", threads, round, "collide again");
      for (size_t v = 0; v < seen.reported.size(); v++)
        if (!seen.reported[v]) fail("a uid never reported", threads, round, "-");
      distinct = n0;
      calls += 3;
      tt_ctx_free(ctx);
    }
  }
  Table table;
  auto ids = table.encode_all(collide);
  int64_t fused_calls = 0, fused_pieces = 0;
  for (int round = 0; round < rounds; round++)
    for (bool emit : {false, true})
      for (int64_t defer_len : {0, 6})
        for (int64_t row_cap : {AMPLE_ROWS, TIGHT_ROWS}) {
          fused_pieces += run_fused(table, collide, ids, emit, defer_len, row_cap, round);
          fused_calls++;
        }
  printf("ok calls %lld distinct %lld news %lld grow_rebuilds_min %lld "
         "fused_calls %lld fused_pieces %lld\n",
         (long long)calls, (long long)distinct, (long long)news,
         (long long)grow_rebuilds, (long long)fused_calls,
         (long long)fused_pieces);
  return 0;
}
