// Native ingest hot path: tokenizer + vocabulary + per-doc TF builder.
//
// The reference delegates this work to Lucene's analysis chain inside the
// JVM (StandardAnalyzer, Worker.java:71-73); here it is the host-side
// bottleneck feeding the device (text -> sorted (term id, tf) arrays), so it
// is native C++ behind a C ABI consumed via ctypes
// (tfidf_tpu_torch/native/__init__.py).
//
// Scope: the ASCII fast path of the Python analyzer
// (tfidf_tpu_torch/ops/analyzer.py) with BIT-IDENTICAL tokenization; documents
// containing non-ASCII bytes are rejected with TFIDF_NONASCII and the
// caller falls back to the (Unicode-complete) Python chain against the
// SAME vocabulary handle, so results are independent of which path ran.
//
// Tokenizer rules replicated exactly (see _TOKEN_RE in ops/analyzer.py):
//   - at a digit: digits, optionally extended by ('.'|',')digits groups
//     ("3.14", "1,000"; "3abc" -> "3","abc" — the digit branch wins and
//     letters do NOT extend it);
//   - at a letter/underscore: [A-Za-z0-9_]+ runs, optionally extended by
//     '<apostrophe>word' groups ("can't");
//   - lowercase filter, stopword filter, and >max_token_length splitting
//     applied in the same order as the Python chain.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" {

#define TFIDF_NONASCII (-2)
#define TFIDF_OVERFLOW (-1)
#define TFIDF_BADID (-3)

struct Engine {
    // vocabulary: term -> dense id, append-only, first-seen order
    std::unordered_map<std::string, int32_t> ids;
    std::vector<std::string> terms;
    // analyzer params
    std::unordered_set<std::string> stopwords;
    int lowercase = 1;
    int64_t max_token_len = 255;
    // scratch (reused across calls; one Engine per Python engine, used
    // under the ingest lock, so no concurrency here)
    std::unordered_map<int32_t, float> doc_counts;
    std::vector<std::pair<int32_t, float>> sorted;
};

Engine* tfidf_engine_new(int lowercase, int64_t max_token_len,
                         const char* stops, int64_t stops_len) {
    Engine* e = new Engine();
    e->lowercase = lowercase;
    e->max_token_len = max_token_len;
    // stopwords arrive newline-joined
    int64_t start = 0;
    for (int64_t i = 0; i <= stops_len; ++i) {
        if (i == stops_len || stops[i] == '\n') {
            if (i > start)
                e->stopwords.emplace(stops + start, i - start);
            start = i + 1;
        }
    }
    return e;
}

void tfidf_engine_free(Engine* e) { delete e; }

int64_t tfidf_vocab_size(const Engine* e) {
    return (int64_t)e->terms.size();
}

// term -> id; add=0 returns -1 for unknown terms
int32_t tfidf_vocab_lookup(Engine* e, const char* tok, int64_t len,
                           int add) {
    std::string key(tok, (size_t)len);
    auto it = e->ids.find(key);
    if (it != e->ids.end()) return it->second;
    if (!add) return -1;
    int32_t tid = (int32_t)e->terms.size();
    e->ids.emplace(std::move(key), tid);
    e->terms.emplace_back(tok, (size_t)len);
    return tid;
}

// id -> term (for checkpoints / debugging); returns length, or
// TFIDF_BADID / TFIDF_OVERFLOW
int64_t tfidf_vocab_term(const Engine* e, int32_t tid, char* buf,
                         int64_t cap) {
    if (tid < 0 || (size_t)tid >= e->terms.size()) return TFIDF_BADID;
    const std::string& t = e->terms[(size_t)tid];
    if ((int64_t)t.size() > cap) return TFIDF_OVERFLOW;
    std::memcpy(buf, t.data(), t.size());
    return (int64_t)t.size();
}

// all terms, newline-joined, in id order; returns bytes written or -1 if
// the buffer is too small (call tfidf_vocab_dump_size first)
int64_t tfidf_vocab_dump_size(const Engine* e) {
    int64_t n = 0;
    for (const auto& t : e->terms) n += (int64_t)t.size() + 1;
    return n;
}

int64_t tfidf_vocab_dump(const Engine* e, char* buf, int64_t cap) {
    int64_t pos = 0;
    for (const auto& t : e->terms) {
        if (pos + (int64_t)t.size() + 1 > cap) return TFIDF_OVERFLOW;
        std::memcpy(buf + pos, t.data(), t.size());
        pos += (int64_t)t.size();
        buf[pos++] = '\n';
    }
    return pos;
}

static inline bool is_word(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_';
}
static inline bool is_digit(unsigned char c) {
    return c >= '0' && c <= '9';
}

// Analyze one ASCII document: tokenize+filter+count+map in one pass.
// Fills out_ids/out_tfs (sorted by id) up to `cap` entries.
// Returns the number of distinct terms, TFIDF_OVERFLOW if cap is too
// small, or TFIDF_NONASCII if the text has non-ASCII bytes (caller must
// use the Python analyzer). *out_len receives the kept-token count (the
// document length for BM25).
int64_t tfidf_analyze_doc(Engine* e, const char* text, int64_t len,
                          int add, int32_t* out_ids, float* out_tfs,
                          int64_t cap, double* out_len) {
    for (int64_t i = 0; i < len; ++i)
        if ((unsigned char)text[i] >= 0x80) return TFIDF_NONASCII;

    auto& counts = e->doc_counts;
    counts.clear();
    double total = 0.0;
    std::string tok;
    const bool lower = e->lowercase != 0;
    const int64_t maxlen = e->max_token_len;
    const bool has_stops = !e->stopwords.empty();

    auto emit = [&](const char* s, int64_t n) {
        tok.assign(s, (size_t)n);
        if (lower)
            for (auto& ch : tok)
                if (ch >= 'A' && ch <= 'Z') ch += 32;
        // overlong tokens are split into maxlen pieces (StandardTokenizer
        // behavior), each filtered independently — same as the Python chain
        for (size_t off = 0; off < tok.size(); off += (size_t)maxlen) {
            std::string piece = tok.substr(off, (size_t)maxlen);
            if (piece.empty()) continue;
            if (has_stops && e->stopwords.count(piece)) continue;
            int32_t tid;
            if (add) {
                tid = tfidf_vocab_lookup(e, piece.data(),
                                         (int64_t)piece.size(), 1);
            } else {
                auto it = e->ids.find(piece);
                if (it == e->ids.end()) continue;
                tid = it->second;
            }
            counts[tid] += 1.0f;
            total += 1.0;
        }
    };

    int64_t i = 0;
    while (i < len) {
        unsigned char c = (unsigned char)text[i];
        if (is_digit(c)) {
            int64_t start = i;
            while (i < len && is_digit((unsigned char)text[i])) ++i;
            // (?:[.,]\d+)* extensions
            while (i + 1 < len &&
                   (text[i] == '.' || text[i] == ',') &&
                   is_digit((unsigned char)text[i + 1])) {
                ++i;
                while (i < len && is_digit((unsigned char)text[i])) ++i;
            }
            emit(text + start, i - start);
        } else if (is_word(c)) {
            int64_t start = i;
            while (i < len && is_word((unsigned char)text[i])) ++i;
            // (?:'\w+)* extensions (ASCII apostrophe only; '’' is non-ASCII)
            while (i + 1 < len && text[i] == '\'' &&
                   is_word((unsigned char)text[i + 1])) {
                ++i;
                while (i < len && is_word((unsigned char)text[i])) ++i;
            }
            emit(text + start, i - start);
        } else {
            ++i;
        }
    }

    if ((int64_t)counts.size() > cap) return TFIDF_OVERFLOW;
    auto& sorted = e->sorted;
    sorted.assign(counts.begin(), counts.end());
    std::sort(sorted.begin(), sorted.end());
    int64_t n = 0;
    for (const auto& kv : sorted) {
        out_ids[n] = kv.first;
        out_tfs[n] = kv.second;
        ++n;
    }
    *out_len = total;
    return n;
}

}  // extern "C"
