// mvtpu_data: native host-side data pipeline for multiverso_tpu.
//
// TPU-native equivalent of the reference's C++ data-loading stack
// (upstream layout Applications/WordEmbedding/{dictionary,reader,
// huffman_encoder}.cpp and the LightLDA DataBlock/doc streaming —
// SURVEY.md §3.6): corpus tokenization + vocabulary build, corpus
// encoding, Huffman coding for hierarchical softmax, skip-gram/CBOW
// pair generation with subsampling, and bag-of-words doc-block reading
// for LDA. The TPU chips consume the int32 arrays this produces; the
// host must keep up with the device, hence native code (the Python
// fallback in multiverso_tpu/data/pydata.py is ~30x slower).
//
// C ABI (consumed via ctypes, no pybind11 in this image): handle-based
// corpus objects + flat-array fills. All exported symbols use the
// mv_ prefix. Thread-safety: each handle is independently usable; the
// handle registry itself is mutex-guarded.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Corpus: tokenize whitespace-separated text, build vocab, encode ids.
// ---------------------------------------------------------------------------

struct Corpus {
  std::vector<std::string> words;        // id -> word
  std::vector<int64_t> counts;           // id -> corpus frequency
  std::vector<int32_t> ids;              // encoded corpus token stream
  int64_t total_raw_tokens = 0;          // before min_count filtering
};

static std::mutex g_reg_mutex;
static std::unordered_map<uint64_t, std::unique_ptr<Corpus>> g_corpora;
static uint64_t g_next_handle = 1;

static uint64_t register_corpus(std::unique_ptr<Corpus> c) {
  std::lock_guard<std::mutex> lock(g_reg_mutex);
  uint64_t h = g_next_handle++;
  g_corpora[h] = std::move(c);
  return h;
}

static Corpus* lookup(uint64_t handle) {
  std::lock_guard<std::mutex> lock(g_reg_mutex);
  auto it = g_corpora.find(handle);
  return it == g_corpora.end() ? nullptr : it->second.get();
}

// Build a corpus from a whitespace-tokenized text file. Words seen fewer
// than min_count times are dropped (word2vec convention). Returns a
// handle (0 on failure).
uint64_t mv_corpus_build(const char* path, int32_t min_count) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 0;

  auto corpus = std::make_unique<Corpus>();
  std::unordered_map<std::string, int64_t> freq;
  std::vector<std::string> stream_words;  // first pass stores tokens

  // Single pass over the file collecting tokens; memory-heavy for huge
  // corpora but simple; the two-pass id-encoding below avoids re-reading.
  {
    std::string tok;
    tok.reserve(64);
    constexpr size_t kBuf = 1 << 20;
    std::vector<char> buf(kBuf);
    size_t got;
    while ((got = std::fread(buf.data(), 1, kBuf, f)) > 0) {
      for (size_t i = 0; i < got; ++i) {
        char c = buf[i];
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r') {
          if (!tok.empty()) {
            freq[tok]++;
            stream_words.push_back(tok);
            tok.clear();
          }
        } else {
          tok.push_back(c);
        }
      }
    }
    if (!tok.empty()) {
      freq[tok]++;
      stream_words.push_back(tok);
    }
  }
  std::fclose(f);
  corpus->total_raw_tokens = (int64_t)stream_words.size();

  // Vocab sorted by descending frequency (stable word ids across runs;
  // id 0 = most frequent, matching word2vec convention).
  std::vector<std::pair<std::string, int64_t>> vocab;
  vocab.reserve(freq.size());
  for (auto& kv : freq) {
    if (kv.second >= min_count) vocab.emplace_back(kv.first, kv.second);
  }
  std::sort(vocab.begin(), vocab.end(), [](const auto& a, const auto& b) {
    if (a.second != b.second) return a.second > b.second;
    return a.first < b.first;
  });

  std::unordered_map<std::string, int32_t> word2id;
  word2id.reserve(vocab.size());
  corpus->words.reserve(vocab.size());
  corpus->counts.reserve(vocab.size());
  for (size_t i = 0; i < vocab.size(); ++i) {
    word2id[vocab[i].first] = (int32_t)i;
    corpus->words.push_back(vocab[i].first);
    corpus->counts.push_back(vocab[i].second);
  }

  corpus->ids.reserve(stream_words.size());
  for (auto& w : stream_words) {
    auto it = word2id.find(w);
    if (it != word2id.end()) corpus->ids.push_back(it->second);
  }
  return register_corpus(std::move(corpus));
}

int32_t mv_corpus_vocab_size(uint64_t handle) {
  Corpus* c = lookup(handle);
  return c ? (int32_t)c->words.size() : -1;
}

int64_t mv_corpus_num_tokens(uint64_t handle) {
  Corpus* c = lookup(handle);
  return c ? (int64_t)c->ids.size() : -1;
}

int64_t mv_corpus_total_raw_tokens(uint64_t handle) {
  Corpus* c = lookup(handle);
  return c ? c->total_raw_tokens : -1;
}

// Fill caller-allocated buffers.
int32_t mv_corpus_counts(uint64_t handle, int64_t* out, int32_t cap) {
  Corpus* c = lookup(handle);
  if (!c || cap < (int32_t)c->counts.size()) return -1;
  std::memcpy(out, c->counts.data(), c->counts.size() * sizeof(int64_t));
  return (int32_t)c->counts.size();
}

int64_t mv_corpus_ids(uint64_t handle, int32_t* out, int64_t cap) {
  Corpus* c = lookup(handle);
  if (!c || cap < (int64_t)c->ids.size()) return -1;
  std::memcpy(out, c->ids.data(), c->ids.size() * sizeof(int32_t));
  return (int64_t)c->ids.size();
}

// Word string for id (valid until corpus freed).
const char* mv_corpus_word(uint64_t handle, int32_t id) {
  Corpus* c = lookup(handle);
  if (!c || id < 0 || id >= (int32_t)c->words.size()) return nullptr;
  return c->words[id].c_str();
}

void mv_corpus_free(uint64_t handle) {
  std::lock_guard<std::mutex> lock(g_reg_mutex);
  g_corpora.erase(handle);
}

// ---------------------------------------------------------------------------
// Huffman coding (hierarchical softmax), word2vec-style.
// ---------------------------------------------------------------------------

// Builds the Huffman tree over word frequencies. For each word id fills:
//   codes[id*max_len .. ]  : 0/1 branch labels  (padded with -1)
//   points[id*max_len .. ] : inner-node indices (padded with -1)
//   lengths[id]            : code length
// Inner nodes are numbered 0..vocab-2 (root = vocab-2). Returns max code
// length actually used, or -1 on error (e.g. a code exceeds max_len).
int32_t mv_huffman_build(const int64_t* counts, int32_t vocab,
                         int32_t max_len, int8_t* codes, int32_t* points,
                         int32_t* lengths) {
  if (vocab < 1) return -1;
  if (vocab == 1) {  // degenerate: single word, empty code
    lengths[0] = 0;
    for (int32_t i = 0; i < max_len; ++i) {
      codes[i] = -1;
      points[i] = -1;
    }
    return 0;
  }
  // word2vec's O(V) two-queue construction over sorted counts.
  // counts arrive sorted descending (vocab built that way); the merge
  // queue is built ascending.
  int64_t n = vocab;
  std::vector<int64_t> count(2 * n - 1);
  std::vector<int32_t> parent(2 * n - 1, -1);
  std::vector<int8_t> branch(2 * n - 1, 0);
  for (int64_t i = 0; i < n; ++i) count[i] = counts[n - 1 - i];  // ascending
  for (int64_t i = n; i < 2 * n - 1; ++i) count[i] = INT64_MAX;

  int64_t pos1 = 0, pos2 = n;
  for (int64_t a = 0; a < n - 1; ++a) {
    int64_t min1, min2;
    if (pos1 < n && (pos2 >= n + a || count[pos1] <= count[pos2]))
      min1 = pos1++;
    else
      min1 = pos2++;
    if (pos1 < n && (pos2 >= n + a || count[pos1] <= count[pos2]))
      min2 = pos1++;
    else
      min2 = pos2++;
    count[n + a] = count[min1] + count[min2];
    parent[min1] = (int32_t)(n + a);
    parent[min2] = (int32_t)(n + a);
    branch[min2] = 1;
  }

  int32_t max_used = 0;
  for (int64_t w = 0; w < n; ++w) {
    // leaf index in the merge arrays (ascending order) for word id w
    int64_t leaf = n - 1 - w;
    int8_t code_rev[128];
    int32_t point_rev[128];
    int32_t len = 0;
    for (int64_t node = leaf; parent[node] != -1; node = parent[node]) {
      if (len >= 128 || len >= max_len) return -1;
      code_rev[len] = branch[node];
      point_rev[len] = parent[node] - (int32_t)n;  // inner-node index
      ++len;
    }
    lengths[w] = len;
    if (len > max_used) max_used = len;
    for (int32_t i = 0; i < len; ++i) {
      codes[w * max_len + i] = code_rev[len - 1 - i];
      points[w * max_len + i] = point_rev[len - 1 - i];
    }
    for (int32_t i = len; i < max_len; ++i) {
      codes[w * max_len + i] = -1;
      points[w * max_len + i] = -1;
    }
  }
  return max_used;
}

// ---------------------------------------------------------------------------
// Skip-gram / CBOW pair generation with word2vec subsampling.
// ---------------------------------------------------------------------------

// Shared fill core for the single-thread entry point and each worker of
// the multi-threaded one (identical rng consumption order, so a chunk
// generated by a worker is bit-identical to mv_skipgram_pairs called on
// that chunk with the worker's derived seed — the property the Python
// parity tests pin).
static int64_t skipgram_fill(const int32_t* ids, int64_t n, int32_t window,
                             const float* keep_prob, uint64_t seed,
                             int32_t* out_center, int32_t* out_context,
                             int64_t cap) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);
  // subsample pass
  std::vector<int32_t> kept;
  kept.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t w = ids[i];
    if (keep_prob == nullptr || uni(rng) < keep_prob[w]) kept.push_back(w);
  }
  int64_t m = (int64_t)kept.size();
  int64_t out = 0;
  for (int64_t i = 0; i < m && out < cap; ++i) {
    int32_t b = 1 + (int32_t)(rng() % (uint64_t)window);
    for (int64_t j = i - b; j <= i + b && out < cap; ++j) {
      if (j == i || j < 0 || j >= m) continue;
      out_center[out] = kept[i];
      out_context[out] = kept[j];
      ++out;
    }
  }
  return out;
}

// Generate skip-gram (center, context) pairs from ids[start, start+n):
// dynamic window b = 1 + rand % window, subsampling by keep_prob[id]
// (caller computes 1.0 = keep always). Fills out arrays up to cap pairs;
// returns the number generated. Deterministic for a given seed.
int64_t mv_skipgram_pairs(const int32_t* ids, int64_t n, int32_t window,
                          const float* keep_prob, uint64_t seed,
                          int32_t* out_center, int32_t* out_context,
                          int64_t cap) {
  return skipgram_fill(ids, n, window, keep_prob, seed, out_center,
                       out_context, cap);
}

// Per-chunk seed for the multi-threaded generators: thread 0 keeps the
// caller's seed; later chunks step by the golden-ratio increment.
// Exposed to Python (data/native.py mirrors it) so tests can oracle a
// worker's chunk against the single-thread entry point.
static inline uint64_t chunk_seed(uint64_t seed, int32_t t) {
  return seed + (uint64_t)t * 0x9E3779B97F4A7C15ULL;
}

// Multi-threaded skip-gram fill: splits [0, n) into n_threads contiguous
// chunks, each generated independently (subsample + dynamic windows stay
// WITHIN the chunk — the reference word2vec partitions the corpus across
// worker threads at arbitrary boundaries the same way, losing only
// O(threads * window) cross-boundary pairs out of ~2*window*n). Output
// is the in-order concatenation of the per-chunk outputs; deterministic
// for a given (seed, n_threads). Falls back to the single-thread fill
// when cap cannot hold every chunk's worst case (keeps the cap contract
// exact without inter-thread coordination).
int64_t mv_skipgram_pairs_mt(const int32_t* ids, int64_t n, int32_t window,
                             const float* keep_prob, uint64_t seed,
                             int32_t n_threads, int32_t* out_center,
                             int32_t* out_context, int64_t cap) {
  if (n_threads > n) n_threads = n > 0 ? (int32_t)n : 1;
  if (n_threads <= 1)
    return skipgram_fill(ids, n, window, keep_prob, seed, out_center,
                         out_context, cap);
  // per-chunk slice bounds in the output buffers (worst case per chunk)
  std::vector<int64_t> begin(n_threads), len(n_threads), slice(n_threads);
  int64_t need = 0;
  for (int32_t t = 0; t < n_threads; ++t) {
    begin[t] = n * t / n_threads;
    len[t] = n * (t + 1) / n_threads - begin[t];
    slice[t] = 2 * (int64_t)window * len[t] + 16;
    need += slice[t];
  }
  if (need > cap)
    return skipgram_fill(ids, n, window, keep_prob, seed, out_center,
                         out_context, cap);
  std::vector<int64_t> produced(n_threads, 0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  int64_t off = 0;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back(
        [&, t, off] {
          produced[t] = skipgram_fill(ids + begin[t], len[t], window,
                                      keep_prob, chunk_seed(seed, t),
                                      out_center + off, out_context + off,
                                      slice[t]);
        });
    off += slice[t];
  }
  for (auto& w : workers) w.join();
  // compact the per-chunk runs left over the slice gaps (memmove: the
  // destination can overlap the source run's slice)
  int64_t total = produced[0];
  off = slice[0];
  for (int32_t t = 1; t < n_threads; ++t) {
    std::memmove(out_center + total, out_center + off,
                 produced[t] * sizeof(int32_t));
    std::memmove(out_context + total, out_context + off,
                 produced[t] * sizeof(int32_t));
    total += produced[t];
    off += slice[t];
  }
  return total;
}

// Shared CBOW fill core (same single-thread/worker split as skip-gram).
static int64_t cbow_fill(const int32_t* ids, int64_t n, int32_t window,
                         const float* keep_prob, uint64_t seed,
                         int32_t* out_context, int32_t* out_target,
                         int64_t cap) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<float> uni(0.0f, 1.0f);
  std::vector<int32_t> kept;
  kept.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    int32_t w = ids[i];
    if (keep_prob == nullptr || uni(rng) < keep_prob[w]) kept.push_back(w);
  }
  int64_t m = (int64_t)kept.size();
  int32_t width = 2 * window;
  int64_t out = 0;
  for (int64_t i = 0; i < m && out < cap; ++i) {
    int32_t b = 1 + (int32_t)(rng() % (uint64_t)window);
    int32_t k = 0;
    for (int64_t j = i - b; j <= i + b; ++j) {
      if (j == i || j < 0 || j >= m) continue;
      if (k < width) out_context[out * width + k] = kept[j];
      ++k;
    }
    if (k == 0) continue;
    for (int32_t z = k < width ? k : width; z < width; ++z)
      out_context[out * width + z] = -1;
    out_target[out] = kept[i];
    ++out;
  }
  return out;
}

// CBOW variant: for each kept position, emit (context_bag[2*window],
// target). Context bag padded with -1. Returns number of examples.
int64_t mv_cbow_examples(const int32_t* ids, int64_t n, int32_t window,
                         const float* keep_prob, uint64_t seed,
                         int32_t* out_context, int32_t* out_target,
                         int64_t cap) {
  return cbow_fill(ids, n, window, keep_prob, seed, out_context,
                   out_target, cap);
}

// Multi-threaded CBOW fill (same chunking/seeding/compaction contract as
// mv_skipgram_pairs_mt; context rows are width=2*window each).
int64_t mv_cbow_examples_mt(const int32_t* ids, int64_t n, int32_t window,
                            const float* keep_prob, uint64_t seed,
                            int32_t n_threads, int32_t* out_context,
                            int32_t* out_target, int64_t cap) {
  if (n_threads > n) n_threads = n > 0 ? (int32_t)n : 1;
  if (n_threads <= 1)
    return cbow_fill(ids, n, window, keep_prob, seed, out_context,
                     out_target, cap);
  int32_t width = 2 * window;
  std::vector<int64_t> begin(n_threads), len(n_threads), slice(n_threads);
  int64_t need = 0;
  for (int32_t t = 0; t < n_threads; ++t) {
    begin[t] = n * t / n_threads;
    len[t] = n * (t + 1) / n_threads - begin[t];
    slice[t] = len[t] + 16;        // <=1 example per kept position
    need += slice[t];
  }
  if (need > cap)
    return cbow_fill(ids, n, window, keep_prob, seed, out_context,
                     out_target, cap);
  std::vector<int64_t> produced(n_threads, 0);
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  int64_t off = 0;
  for (int32_t t = 0; t < n_threads; ++t) {
    workers.emplace_back(
        [&, t, off] {
          produced[t] = cbow_fill(ids + begin[t], len[t], window,
                                  keep_prob, chunk_seed(seed, t),
                                  out_context + off * width,
                                  out_target + off, slice[t]);
        });
    off += slice[t];
  }
  for (auto& w : workers) w.join();
  int64_t total = produced[0];
  off = slice[0];
  for (int32_t t = 1; t < n_threads; ++t) {
    std::memmove(out_context + total * width, out_context + off * width,
                 produced[t] * (int64_t)width * sizeof(int32_t));
    std::memmove(out_target + total, out_target + off,
                 produced[t] * sizeof(int32_t));
    total += produced[t];
    off += slice[t];
  }
  return total;
}

// ---------------------------------------------------------------------------
// LDA doc blocks: libsvm-ish "word_id:count word_id:count ..." per line.
// ---------------------------------------------------------------------------

// Parse a bag-of-words file into CSR arrays. Line format: tokens
// "w:c" separated by whitespace (doc id implicit = line number).
// Fills doc_offsets (num_docs+1), word_ids / word_counts (nnz).
// Two-call protocol: pass null outputs to query sizes.
int64_t mv_lda_read_docs(const char* path, int64_t* out_num_docs,
                         int64_t* out_nnz, int64_t* doc_offsets,
                         int32_t* word_ids, int32_t* word_counts,
                         int64_t cap_docs, int64_t cap_nnz) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  bool counting = (doc_offsets == nullptr);
  int64_t docs = 0, nnz = 0;
  std::string line;
  line.reserve(1 << 16);
  int ch;
  auto flush_line = [&]() -> bool {
    // whitespace-only lines are not documents (Python-fallback parity)
    if (line.find_first_not_of(" \t") == std::string::npos) {
      line.clear();
      return true;
    }
    if (!counting && docs >= cap_docs) return false;
    if (!counting) doc_offsets[docs] = nnz;
    const char* p = line.c_str();
    while (*p) {
      while (*p == ' ' || *p == '\t') ++p;
      if (!*p) break;
      char* end;
      long w = std::strtol(p, &end, 10);
      if (end == p || *end != ':') {  // skip malformed token
        while (*p && *p != ' ' && *p != '\t') ++p;
        continue;
      }
      p = end + 1;
      long c = std::strtol(p, &end, 10);
      if (end == p) continue;
      p = end;
      if (c <= 0 || w < 0) continue;
      if (!counting) {
        if (nnz >= cap_nnz) return false;
        word_ids[nnz] = (int32_t)w;
        word_counts[nnz] = (int32_t)c;
      }
      ++nnz;
    }
    ++docs;
    line.clear();
    return true;
  };
  constexpr size_t kBuf = 1 << 20;
  std::vector<char> buf(kBuf);
  size_t got;
  bool ok = true;
  while (ok && (got = std::fread(buf.data(), 1, kBuf, f)) > 0) {
    for (size_t i = 0; i < got && ok; ++i) {
      ch = buf[i];
      if (ch == '\n') {
        ok = flush_line();
      } else if (ch != '\r') {
        line.push_back((char)ch);
      }
    }
  }
  if (ok) ok = flush_line();
  std::fclose(f);
  if (!ok) return -1;
  if (!counting && docs <= cap_docs) doc_offsets[docs] = nnz;
  *out_num_docs = docs;
  *out_nnz = nnz;
  return 0;
}

// ---------------------------------------------------------------------------
// Version stamp (lets Python detect a stale .so).
// ---------------------------------------------------------------------------

int32_t mv_data_abi_version() { return 5; }

}  // extern "C"
