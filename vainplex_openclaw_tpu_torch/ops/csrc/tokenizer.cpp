// The hash tokenizer's rows in one host pass (models/tokenizer.py).
//
// Each row is the UTF-8 of one lowered text. The pass decodes each code
// point only to classify it by the caller's table (WORD: \w or one of
// $#@/.-; SPACE: \s; anything else OTHER), forms the tokens of
// [\w$#@/.-]+|[^\w\s] (a run of WORD code points, or one OTHER code
// point), hashes each token's bytes with 64-bit FNV-1a and writes
// 2 + h % (vocab_size - 2) after CLS, up to seq_len - 1 tokens; the rest
// of the row is PAD. It stops at the last token it keeps.
//
// The table covers U+0000..U+FFFF. A row that reaches a code point above
// it before its last kept token is left as PAD and flagged: the caller
// encodes it with Python's own regex. A row flagged on entry is skipped.
//
// Plain C interface, loaded with ctypes; built with the host compiler:
//   c++ -std=c++17 -O3 -shared -fPIC -o libtokenizer-<hash>.so tokenizer.cpp

#include <cstdint>
#include <cstring>

namespace {

constexpr uint8_t kOther = 0;
constexpr uint8_t kWord = 1;
constexpr uint8_t kSpace = 2;
constexpr uint64_t kFnvOffset = 0xCBF29CE484222325ull;
constexpr uint64_t kFnvPrime = 0x100000001B3ull;
constexpr int32_t kCls = 1;
constexpr int32_t kReserved = 2;

// The code point at p (valid UTF-8, as Python's strict encoder writes it)
// and its length in bytes; a code point above U+FFFF reads as -1.
inline int32_t decode(const uint8_t* p, int* len) {
    const uint8_t b = p[0];
    if (b < 0x80) {
        *len = 1;
        return b;
    }
    if (b < 0xE0) {
        *len = 2;
        return ((b & 0x1F) << 6) | (p[1] & 0x3F);
    }
    if (b < 0xF0) {
        *len = 3;
        return ((b & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
    }
    *len = 4;
    return -1;
}

// One row; false where it reached a code point above the table.
bool encode_row(const uint8_t* p, const uint8_t* end, int seq_len,
                uint64_t buckets, const uint8_t* cls, int32_t* row) {
    row[0] = kCls;
    int j = 1;
    while (j < seq_len && p < end) {
        int len;
        int32_t cp = decode(p, &len);
        if (cp < 0)
            return false;
        const uint8_t c = cls[cp];
        if (c == kSpace) {
            p += len;
            continue;
        }
        const uint8_t* tok = p;
        p += len;
        if (c == kWord) {
            while (p < end) {
                cp = decode(p, &len);
                if (cp < 0)
                    return false;
                if (cls[cp] != kWord)
                    break;
                p += len;
            }
        }
        uint64_t h = kFnvOffset;
        for (const uint8_t* q = tok; q < p; ++q)
            h = (h ^ *q) * kFnvPrime;
        row[j++] = kReserved + static_cast<int32_t>(h % buckets);
    }
    return true;
}

}  // namespace

extern "C" {

// Encodes rows 0..n-1 of text (row i: bytes offsets[i]..offsets[i+1])
// into out[n][seq_len], which the caller zeroes. skipped[i] set on entry
// leaves row i untouched; set on return, the row is all PAD and the
// caller encodes it. seq_len >= 1 and 3 <= vocab_size <= 2^31.
void tokenize_rows(const uint8_t* text, const int64_t* offsets, int64_t n,
                   int seq_len, int64_t vocab_size, const uint8_t* classes,
                   int32_t* out, uint8_t* skipped) {
    const uint64_t buckets = static_cast<uint64_t>(vocab_size - kReserved);
    for (int64_t i = 0; i < n; ++i) {
        if (skipped[i])
            continue;
        int32_t* row = out + i * seq_len;
        if (!encode_row(text + offsets[i], text + offsets[i + 1], seq_len,
                        buckets, classes, row)) {
            std::memset(row, 0, sizeof(int32_t) * seq_len);
            skipped[i] = 1;
        }
    }
}

}  // extern "C"
