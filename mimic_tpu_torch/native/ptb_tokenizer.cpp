// Native PTB-style caption tokenizer.
//
// The reference shells out to Stanford-CoreNLP's Java PTBTokenizer for CIDEr
// scoring (testbed/evaluate/metrics/CIDEr/CIDEr.py:80-101) — its one native
// dependency.  This is the C++ equivalent: byte-for-byte the same rules as the
// pure-Python fallback in mimic_tpu/evaluate/ptb_tokenizer.py (which is the
// parity oracle in tests), built once with g++ and loaded via ctypes.
//
// Scanner rules (Stanford default ptb3Escaping conventions): see the Python
// twin's module docstring.  Lowercasing here is ASCII-only; callers with
// non-ASCII uppercase text should lowercase on the Python side first (caption
// generation output is ASCII in practice).
//
// Exported C ABI:
//   int ptb_tokenize_line(const char* line, int lowercase,
//                         char* out, int out_cap);
// Writes space-joined tokens into `out` (NUL-terminated); returns the number of
// bytes written (excluding NUL), or -1 if `out_cap` is too small.

#include <cctype>
#include <cstring>
#include <string>
#include <vector>

namespace {

inline bool is_word_byte(unsigned char c) {
  // ASCII word chars plus all non-ASCII bytes (UTF-8 letters approximate \w)
  return std::isalnum(c) || c == '_' || c >= 0x80;
}

inline bool is_alpha_byte(unsigned char c) {
  return std::isalpha(c) || c >= 0x80;
}

inline bool is_space_byte(unsigned char c) { return std::isspace(c) != 0; }

const char* bracket_token(char c) {
  switch (c) {
    case '(': return "-LRB-";
    case ')': return "-RRB-";
    case '{': return "-LCB-";
    case '}': return "-RCB-";
    case '[': return "-LSB-";
    case ']': return "-RSB-";
    default: return nullptr;
  }
}

bool is_clause_punct(char c) {
  switch (c) {
    case ',': case ';': case ':': case '@': case '#': case '$': case '%':
    case '&':
      return true;
    default:
      return false;
  }
}

// PTB sed-script special splits (mirrors SPECIAL_SPLITS in the Python twin)
struct Special { const char* word; const char* parts[3]; };
const Special kSpecials[] = {
    {"cannot", {"can", "not", nullptr}},
    {"gonna", {"gon", "na", nullptr}},
    {"gotta", {"got", "ta", nullptr}},
    {"wanna", {"wan", "na", nullptr}},
    {"lemme", {"lem", "me", nullptr}},
    {"gimme", {"gim", "me", nullptr}},
    {"more'n", {"more", "'n", nullptr}},
    {"'tis", {"'t", "is", nullptr}},
    {"'twas", {"'t", "was", nullptr}},
    {"d'ye", {"d'", "ye", nullptr}},
    {"whaddya", {"wha", "dd", "ya"}},
    {"whatcha", {"wha", "t", "cha"}},
};

bool special_split(const std::string& tok, std::vector<std::string>* out) {
  for (const Special& sp : kSpecials) {
    if (tok == sp.word) {
      for (const char* p : sp.parts) {
        if (p) out->push_back(p);
      }
      return true;
    }
  }
  return false;
}

// title/unit abbreviations that keep their period (TITLE_ABBREVS twin)
const char* kTitleAbbrevs[] = {
    "mr", "mrs", "ms", "dr", "prof", "rev", "gen", "sen", "rep", "gov",
    "st", "jr", "sr", "capt", "col", "sgt", "lt", "maj", "vs", "etc",
    "inc", "ltd", "co", "corp", "ft", "oz", "lb", "lbs",
};

bool is_title_abbrev(const std::string& tok) {
  for (const char* a : kTitleAbbrevs) {
    if (tok == a) return true;
  }
  return false;
}

// split trailing contractions recursively: n't 's 'm 're 've 'll 'd
void split_contractions(const std::string& tok, std::vector<std::string>* out) {
  if (special_split(tok, out)) return;
  size_t n = tok.size();
  auto tail_is = [&](const char* suf) {
    size_t m = std::strlen(suf);
    if (n < m + 1) return false;  // need at least one head char
    for (size_t i = 0; i < m; ++i) {
      char a = tok[n - m + i];
      char b = suf[i];
      if (std::tolower(static_cast<unsigned char>(a)) != b) return false;
    }
    // head must end in a word byte
    return is_word_byte(static_cast<unsigned char>(tok[n - m - 1]));
  };
  static const char* three[] = {"n't", "'re", "'ve", "'ll"};
  static const char* two[] = {"'s", "'m", "'d"};
  for (const char* suf : three) {
    if (tail_is(suf)) {
      split_contractions(tok.substr(0, n - 3), out);
      out->push_back(tok.substr(n - 3));
      return;
    }
  }
  for (const char* suf : two) {
    if (tail_is(suf)) {
      split_contractions(tok.substr(0, n - 2), out);
      out->push_back(tok.substr(n - 2));
      return;
    }
  }
  out->push_back(tok);
}

// unicode (UTF-8) normalization: curly quotes, ellipsis, em/en dashes
void normalize_unicode(std::string* s) {
  std::string out;
  out.reserve(s->size());
  size_t i = 0, n = s->size();
  while (i < n) {
    unsigned char a = (*s)[i];
    if (a == 0xE2 && i + 2 < n) {
      unsigned char b = (*s)[i + 1], c = (*s)[i + 2];
      if (b == 0x80) {
        if (c == 0x99 || c == 0x98) { out += '\''; i += 3; continue; }   // ’ ‘
        if (c == 0x9C || c == 0x9D) { out += '"'; i += 3; continue; }    // “ ”
        if (c == 0xA6) { out += "..."; i += 3; continue; }               // …
        if (c == 0x94 || c == 0x93) { out += "--"; i += 3; continue; }   // — –
      }
    }
    out += static_cast<char>(a);
    ++i;
  }
  s->swap(out);
}

void tokenize(const std::string& line, std::vector<std::string>* out) {
  size_t i = 0;
  const size_t n = line.size();
  bool prev_is_boundary = true;
  while (i < n) {
    unsigned char c = line[i];
    if (is_space_byte(c)) {
      ++i;
      prev_is_boundary = true;
      continue;
    }
    bool start_boundary = prev_is_boundary;
    prev_is_boundary = false;
    // ellipsis
    if (c == '.' && i + 2 < n && line[i + 1] == '.' && line[i + 2] == '.') {
      out->push_back("...");
      i += 3;
      continue;
    }
    // dash runs
    if (c == '-' && i + 1 < n && line[i + 1] == '-') {
      size_t j = i;
      while (j < n && line[j] == '-') ++j;
      out->push_back(line.substr(i, j - i));
      i = j;
      continue;
    }
    // clause punctuation / symbols
    if (is_clause_punct(static_cast<char>(c))) {
      out->push_back(std::string(1, static_cast<char>(c)));
      ++i;
      continue;
    }
    // letter-period acronym (u.s., a.m.): >= 2 letter-dot groups, not running
    // into a longer word
    if (is_alpha_byte(c) && i + 1 < n && line[i + 1] == '.') {
      size_t j = i;
      int groups = 0;
      while (j + 1 < n && is_alpha_byte(static_cast<unsigned char>(line[j])) &&
             line[j + 1] == '.') {
        j += 2;
        ++groups;
      }
      if (groups >= 2 &&
          (j >= n || !is_word_byte(static_cast<unsigned char>(line[j])))) {
        out->push_back(line.substr(i, j - i));
        i = j;
        continue;
      }
    }
    // word / number with internal joiners
    if (is_word_byte(c)) {
      size_t j = i;
      while (j < n) {
        unsigned char ch = line[j];
        if (is_word_byte(ch)) {
          ++j;
        } else if ((ch == '-' || ch == '\'') && j + 1 < n &&
                   is_word_byte(static_cast<unsigned char>(line[j + 1]))) {
          j += 2;
        } else if ((ch == '.' || ch == ',') && j > i &&
                   std::isdigit(static_cast<unsigned char>(line[j - 1])) &&
                   j + 1 < n &&
                   std::isdigit(static_cast<unsigned char>(line[j + 1]))) {
          j += 2;
        } else {
          break;
        }
      }
      std::string word = line.substr(i, j - i);
      bool trailing_quote = false;
      if (j < n && line[j] == '\'') {
        // dogs' -> dogs + ' (possessive plural; Stanford splits it)
        trailing_quote = true;
        ++j;
      }
      if (j < n && line[j] == '.' && !trailing_quote && is_title_abbrev(word)) {
        word += '.';
        ++j;
      }
      split_contractions(word, out);
      if (trailing_quote) out->push_back("'");
      i = j;
      continue;
    }
    // brackets
    if (const char* tok = bracket_token(static_cast<char>(c))) {
      out->push_back(tok);
      ++i;
      continue;
    }
    // apostrophe-leading PTB specials ('tis, 'twas)
    if (c == '\'' && i + 1 < n &&
        is_word_byte(static_cast<unsigned char>(line[i + 1]))) {
      size_t j = i + 1;
      while (j < n && is_word_byte(static_cast<unsigned char>(line[j]))) ++j;
      if (special_split(line.substr(i, j - i), out)) {
        i = j;
        continue;
      }
    }
    // quotes: side-aware PTB forms
    if (c == '"') {
      out->push_back(start_boundary ? "``" : "''");
      ++i;
      continue;
    }
    if (c == '\'') {
      out->push_back(start_boundary ? "`" : "'");
      ++i;
      prev_is_boundary = start_boundary;  // 'hello: quote then word
      continue;
    }
    // any other single non-space char
    out->push_back(std::string(1, static_cast<char>(c)));
    ++i;
  }
}

}  // namespace

extern "C" int ptb_tokenize_line(const char* line, int lowercase, char* out,
                                 int out_cap) {
  std::string text(line);
  if (lowercase) {
    for (auto& ch : text) {
      ch = static_cast<char>(std::tolower(static_cast<unsigned char>(ch)));
    }
  }
  for (auto& ch : text) {
    if (ch == '\n') ch = ' ';
  }
  normalize_unicode(&text);
  std::vector<std::string> toks;
  tokenize(text, &toks);
  std::string joined;
  for (size_t i = 0; i < toks.size(); ++i) {
    if (i) joined += ' ';
    joined += toks[i];
  }
  if (static_cast<int>(joined.size()) + 1 > out_cap) return -1;
  std::memcpy(out, joined.c_str(), joined.size() + 1);
  return static_cast<int>(joined.size());
}
