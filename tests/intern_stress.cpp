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
// pieces seen.  Prints one line "ok ..." and exits 0, or names the
// first fault and exits 1.

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

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
}

namespace {

constexpr int PATTERN = 2;  // cl100k: " word" is one piece
constexpr int SC_COUNT = 31;
constexpr int SC_INSERTS = 6;
constexpr int SC_REBUILDS = 9;

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
  printf("ok calls %lld distinct %lld news %lld grow_rebuilds_min %lld\n",
         (long long)calls, (long long)distinct, (long long)news,
         (long long)grow_rebuilds);
  return 0;
}
