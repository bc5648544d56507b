// Native WordPiece tokenizer fast path.
//
// The reference's data pipeline leans on torch's C++ DataLoader worker pool
// (reference: main_task_retrieval.py:38,217); this library is the equivalent
// native component for univl_tpu_torch (a copy of the JAX package's
// csrc/wordpiece.cc): tokenization is the dominant host-side
// cost per sample (HowTo100M re-tokenizes neighbor clips during transcript
// expansion), and the Python tokenizer holds the GIL.
//
// Scope: full UTF-8 implementation of the exact BERT basic+wordpiece
// algorithm (clean, CJK spacing, never_split, lowercase + NFD accent
// stripping, punctuation split, greedy longest-match with "##"
// continuations). Unicode semantics come from a table blob generated by
// Python's unicodedata (univl_tpu_torch/data/native.py:build_unicode_blob), so
// the native path agrees with the Python tokenizer by construction. The
// rare cases a per-codepoint table cannot express — context-sensitive
// lowercasing (final sigma), non-Mn combining characters whose canonical
// reordering crosses characters, codepoints beyond the table, invalid
// UTF-8 — are REJECTED (return -1) and the caller falls back to the
// Python implementation, so behavior is always correct.
//
// C API (ctypes):
//   void* wp_create(const char* vocab_newline_joined, int do_lower_case);
//     ASCII-only tokenizer (non-ASCII input -> -1).
//   void* wp_create_utf8(const char* vocab_newline_joined, int do_lower_case,
//                        const uint8_t* blob, int64_t blob_len);
//     full-UTF-8 tokenizer using the unicode table blob.
//   void  wp_free(void* handle);
//   int   wp_tokenize(void* handle, const char* text,
//                     int32_t* out_ids, int max_out);
//     returns #tokens written, or -1 if the text needs the Python fallback.

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// Unicode table blob (see univl_tpu_torch/data/native.py for the layout).
struct UnicodeTables {
  static constexpr uint8_t kWhitespace = 1;
  static constexpr uint8_t kDrop = 2;
  static constexpr uint8_t kPunct = 4;
  static constexpr uint8_t kCjk = 8;
  static constexpr uint8_t kNeedsPython = 16;

  std::vector<uint8_t> flags;
  std::vector<int32_t> map_off;
  std::vector<uint8_t> map_len;
  std::vector<uint32_t> pool;
  uint32_t max_cp = 0;

  bool parse(const uint8_t* blob, int64_t len) {
    if (len < 16) return false;
    uint32_t magic, version, pool_len;
    memcpy(&magic, blob, 4);
    memcpy(&version, blob + 4, 4);
    memcpy(&max_cp, blob + 8, 4);
    memcpy(&pool_len, blob + 12, 4);
    if (magic != 0x55544B31u) return false;
    int64_t need = 16 + (int64_t)max_cp * (1 + 4 + 1) + (int64_t)pool_len * 4;
    if (len != need) return false;
    const uint8_t* p = blob + 16;
    flags.assign(p, p + max_cp);
    p += max_cp;
    map_off.resize(max_cp);
    memcpy(map_off.data(), p, (size_t)max_cp * 4);
    p += (int64_t)max_cp * 4;
    map_len.assign(p, p + max_cp);
    p += max_cp;
    pool.resize(pool_len);
    memcpy(pool.data(), p, (size_t)pool_len * 4);
    return true;
  }
};

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  // Whitespace-delimited chunks equal to one of these skip lowercasing and
  // punctuation splitting (BasicTokenizer.never_split; the reference's
  // modules/tokenization.py:198-310 default set).
  std::unordered_set<std::string> never_split{"[UNK]", "[SEP]", "[MASK]",
                                              "[CLS]"};
  bool lower;
  int32_t unk_id;
  UnicodeTables tables;
  bool has_tables = false;
  static constexpr int kMaxCharsPerWord = 100;
};

// Appends cp as UTF-8 to s.
inline void utf8_append(std::string* s, uint32_t cp) {
  if (cp < 0x80) {
    s->push_back((char)cp);
  } else if (cp < 0x800) {
    s->push_back((char)(0xC0 | (cp >> 6)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    s->push_back((char)(0xE0 | (cp >> 12)));
    s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  } else {
    s->push_back((char)(0xF0 | (cp >> 18)));
    s->push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
    s->push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
    s->push_back((char)(0x80 | (cp & 0x3F)));
  }
}

// Decodes one UTF-8 codepoint at p (end-bounded). Returns #bytes consumed
// or -1 on malformed input (caller falls back to Python).
inline int utf8_decode(const char* p, const char* end, uint32_t* cp) {
  const unsigned char c0 = (unsigned char)p[0];
  if (c0 < 0x80) {
    *cp = c0;
    return 1;
  }
  int n;
  uint32_t acc;
  if ((c0 & 0xE0) == 0xC0) {
    n = 2;
    acc = c0 & 0x1F;
  } else if ((c0 & 0xF0) == 0xE0) {
    n = 3;
    acc = c0 & 0x0F;
  } else if ((c0 & 0xF8) == 0xF0) {
    n = 4;
    acc = c0 & 0x07;
  } else {
    return -1;
  }
  if (p + n > end) return -1;
  for (int i = 1; i < n; ++i) {
    const unsigned char c = (unsigned char)p[i];
    if ((c & 0xC0) != 0x80) return -1;
    acc = (acc << 6) | (c & 0x3F);
  }
  static const uint32_t kMin[5] = {0, 0, 0x80, 0x800, 0x10000};
  if (acc < kMin[n] || acc > 0x10FFFF) return -1;
  *cp = acc;
  return n;
}

inline bool is_ascii(unsigned char c) { return c < 0x80; }

inline bool is_space(char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_ctrl(unsigned char c) {
  return c < 0x20 && !is_space(static_cast<char>(c));
}

inline bool is_punct(unsigned char c) {
  return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
         (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

// Greedy longest-match WordPiece over one word; appends ids. ``offs`` maps
// character (codepoint) index -> byte offset, with offs.back() == size;
// max-chars and match boundaries are in CHARACTERS like the Python path.
void wordpiece_cps(const Tokenizer& tk, const std::string& word,
                   const std::vector<int>& offs, std::vector<int32_t>* out) {
  const size_t n = offs.size() - 1;  // number of characters
  if (n == 0) return;
  if (n > Tokenizer::kMaxCharsPerWord) {
    out->push_back(tk.unk_id);
    return;
  }
  std::vector<int32_t> pieces;
  size_t start = 0;
  while (start < n) {
    size_t end = n;
    int32_t cur = -1;
    while (start < end) {
      std::string sub =
          word.substr(offs[start], offs[end] - offs[start]);
      if (start > 0) sub = "##" + sub;
      auto it = tk.vocab.find(sub);
      if (it != tk.vocab.end()) {
        cur = it->second;
        break;
      }
      --end;
    }
    if (cur < 0) {
      out->push_back(tk.unk_id);
      return;
    }
    pieces.push_back(cur);
    start = end;
  }
  out->insert(out->end(), pieces.begin(), pieces.end());
}

// ASCII convenience wrapper: every byte is one character.
void wordpiece(const Tokenizer& tk, const std::string& word,
               std::vector<int32_t>* out) {
  std::vector<int> offs(word.size() + 1);
  for (size_t i = 0; i <= word.size(); ++i) offs[i] = (int)i;
  wordpiece_cps(tk, word, offs, out);
}

// Full-UTF-8 tokenize using the unicode tables. Returns 0 on success,
// -1 when the string needs the Python fallback.
int tokenize_utf8(const Tokenizer& tk, const char* text,
                  std::vector<int32_t>* ids) {
  const UnicodeTables& t = tk.tables;
  const char* end = text + strlen(text);

  std::string chunk;            // UTF-8 bytes of the current chunk
  std::vector<uint32_t> ccps;   // its codepoints

  std::string word;             // current mapped word being assembled
  std::vector<int> woffs{0};    // cp-index -> byte offset into word

  auto flush_word = [&]() {
    if (!word.empty()) {
      wordpiece_cps(tk, word, woffs, ids);
      word.clear();
      woffs.assign(1, 0);
    }
  };

  auto emit_mapped = [&](uint32_t ocp) {
    // punctuation splits on the MAPPED characters, matching the Python
    // order (lower+strip first, _split_punct second).
    if (ocp < t.max_cp && (t.flags[ocp] & UnicodeTables::kPunct)) {
      flush_word();
      utf8_append(&word, ocp);
      woffs.push_back((int)word.size());
      flush_word();
      return;
    }
    utf8_append(&word, ocp);
    woffs.push_back((int)word.size());
  };

  auto process_chunk = [&]() {
    if (chunk.empty()) return;
    if (tk.never_split.count(chunk)) {
      std::vector<int> offs;
      offs.reserve(ccps.size() + 1);
      int pos = 0;
      std::string tmp;
      offs.push_back(0);
      for (uint32_t cp : ccps) {
        tmp.clear();
        utf8_append(&tmp, cp);
        pos += (int)tmp.size();
        offs.push_back(pos);
      }
      wordpiece_cps(tk, chunk, offs, ids);
    } else {
      for (uint32_t cp : ccps) {
        if (tk.lower) {
          int32_t off = t.map_off[cp];
          if (off < 0) {
            emit_mapped(cp);
          } else {
            for (int i = 0; i < t.map_len[cp]; ++i) {
              emit_mapped(t.pool[off + i]);
            }
          }
        } else {
          emit_mapped(cp);
        }
      }
      flush_word();
    }
    chunk.clear();
    ccps.clear();
  };

  for (const char* p = text; p < end;) {
    uint32_t cp;
    int n = utf8_decode(p, end, &cp);
    if (n < 0) return -1;
    p += n;
    if (cp >= t.max_cp) return -1;
    const uint8_t f = t.flags[cp];
    if (f & UnicodeTables::kNeedsPython) return -1;
    if (f & UnicodeTables::kDrop) continue;
    if (f & UnicodeTables::kWhitespace) {
      process_chunk();
      continue;
    }
    if (f & UnicodeTables::kCjk) {
      // _space_cjk pads CJK chars with spaces BEFORE splitting, so a CJK
      // char always forms its own chunk (reference tokenization semantics).
      process_chunk();
      utf8_append(&chunk, cp);
      ccps.push_back(cp);
      process_chunk();
      continue;
    }
    utf8_append(&chunk, cp);
    ccps.push_back(cp);
  }
  process_chunk();
  return 0;
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_newline_joined, int do_lower_case) {
  auto* tk = new Tokenizer();
  tk->lower = do_lower_case != 0;
  const char* p = vocab_newline_joined;
  int32_t idx = 0;
  while (*p) {
    const char* q = strchr(p, '\n');
    size_t len = q ? static_cast<size_t>(q - p) : strlen(p);
    // strip token like Python's str.strip()
    size_t b = 0, e = len;
    while (b < e && is_space(p[b])) ++b;
    while (e > b && is_space(p[e - 1])) --e;
    tk->vocab.emplace(std::string(p + b, e - b), idx);
    ++idx;
    if (!q) break;
    p = q + 1;
  }
  auto it = tk->vocab.find("[UNK]");
  tk->unk_id = it != tk->vocab.end() ? it->second : 0;
  return tk;
}

void* wp_create_utf8(const char* vocab_newline_joined, int do_lower_case,
                     const uint8_t* blob, int64_t blob_len) {
  auto* tk = static_cast<Tokenizer*>(wp_create(vocab_newline_joined,
                                               do_lower_case));
  if (!tk->tables.parse(blob, blob_len)) {
    delete tk;
    return nullptr;
  }
  tk->has_tables = true;
  return tk;
}

// Replaces the never_split set (newline-joined tokens). The default set
// matches the reference BertTokenizer ctor (modules/tokenization.py:78);
// the from_pretrained path uses a 5-token set including [PAD]
// (modules/tokenization.py:157) — callers pass whatever the Python
// tokenizer was configured with so both paths always agree.
void wp_set_never_split(void* handle, const char* newline_joined) {
  auto* tk = static_cast<Tokenizer*>(handle);
  tk->never_split.clear();
  const char* p = newline_joined;
  while (*p) {
    const char* q = strchr(p, '\n');
    size_t len = q ? static_cast<size_t>(q - p) : strlen(p);
    if (len > 0) tk->never_split.emplace(p, len);
    if (!q) break;
    p = q + 1;
  }
}

void wp_free(void* handle) { delete static_cast<Tokenizer*>(handle); }

int wp_tokenize(void* handle, const char* text, int32_t* out_ids, int max_out) {
  const Tokenizer& tk = *static_cast<Tokenizer*>(handle);
  std::vector<int32_t> ids;

  if (tk.has_tables) {
    if (tokenize_utf8(tk, text, &ids) != 0) return -1;
    if (static_cast<int>(ids.size()) > max_out) return -1;
    memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
    return static_cast<int>(ids.size());
  }

  std::string chunk;  // whitespace-delimited token, control chars removed

  auto process_chunk = [&]() {
    if (chunk.empty()) return;
    // never_split check happens on the raw (pre-lowercase) chunk, exactly
    // like BasicTokenizer.tokenize; the chunk then goes straight to
    // WordPiece (full-word vocab hit first, same as the Python path).
    if (tk.never_split.count(chunk)) {
      wordpiece(tk, chunk, &ids);
      chunk.clear();
      return;
    }
    std::string word;
    auto flush = [&]() {
      if (!word.empty()) {
        wordpiece(tk, word, &ids);
        word.clear();
      }
    };
    for (char ch : chunk) {
      unsigned char c = static_cast<unsigned char>(ch);
      if (is_punct(c)) {
        flush();
        word.push_back(ch);
        flush();
        continue;
      }
      if (tk.lower && ch >= 'A' && ch <= 'Z') ch = static_cast<char>(ch - 'A' + 'a');
      word.push_back(ch);
    }
    flush();
    chunk.clear();
  };

  for (const char* p = text; *p; ++p) {
    unsigned char c = static_cast<unsigned char>(*p);
    if (!is_ascii(c)) return -1;  // Python fallback handles Unicode
    if (c == 0 || is_ctrl(c)) continue;
    if (is_space(static_cast<char>(c))) {
      process_chunk();
      continue;
    }
    chunk.push_back(static_cast<char>(c));
  }
  process_chunk();

  if (static_cast<int>(ids.size()) > max_out) return -1;
  memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  return static_cast<int>(ids.size());
}

}  // extern "C"
