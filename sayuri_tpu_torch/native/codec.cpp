// Host-side codec for the 53-line v2 training-chunk format (the port's
// own copy of the JAX package's native codec, same symbols and layout).
//
// Native counterpart of the Python parser in
// sayuri_tpu_torch/train/dataset.py (Sample.parse) and of the writer in
// sayuri_tpu_torch/selfplay/data.py. The loader parses each kept sample
// with sayuri_parse_positions; the writer stays in Python.
//
// Exposed as plain C symbols for ctypes.
//
// Layout contracts (must match train/dataset.py):
//   planes  : [cap, 37, hw] float32, binary features
//   prob    : [cap, hw+1]   float32
//   aux     : [cap, hw+1]   float32
//   own     : [cap, hw]     float32 in {-1, 0, 1}
//   scalars : [cap, 18]     float32 =
//     {bsize, komi, rule, wave, to_move, result,
//      avg_q, short_q, mid_q, long_q, final_score,
//      avg_s, short_s, mid_s, long_s, q_stddev, score_stddev, kld}

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kNumBinaryPlanes = 37;
constexpr int kNumScalars = 18;
constexpr int kDataLines = 53;

struct Cursor {
    const char* p;
    const char* end;

    bool eof() const { return p >= end; }

    // Return the current line (trimmed of trailing \r\n) and advance.
    bool next_line(const char** line, long* len) {
        if (eof()) return false;
        const char* nl = static_cast<const char*>(
            memchr(p, '\n', static_cast<size_t>(end - p)));
        const char* stop = nl ? nl : end;
        *line = p;
        *len = static_cast<long>(stop - p);
        while (*len > 0 && ((*line)[*len - 1] == '\r')) --(*len);
        p = nl ? nl + 1 : end;
        return true;
    }
};

bool is_space(char c) { return isspace(static_cast<unsigned char>(c)) != 0; }

// Read one number at `s` (after blanks) that ends at a blank or at `end`,
// and advance past it; false when there is none (strtod did not advance)
// or when it runs into other characters ("1.5x", "1.52.5").
bool parse_float(const char*& s, const char* end, float* dst) {
    while (s < end && is_space(*s)) ++s;
    if (s >= end) return false;
    char* out = nullptr;
    const double v = strtod(s, &out);
    if (out == s || out > end || (out < end && !is_space(*out))) return false;
    s = out;
    *dst = static_cast<float>(v);
    return true;
}

// True when only blanks are left before `end`.
bool rest_blank(const char* s, const char* end) {
    while (s < end && is_space(*s)) ++s;
    return s >= end;
}

// Exactly `n` numbers on the line, nothing else.
bool parse_floats(const char* s, long len, float* dst, int n) {
    const char* end = s + len;
    for (int i = 0; i < n; ++i) {
        if (!parse_float(s, end, dst + i)) return false;
    }
    return rest_blank(s, end);
}

// One integer on the line, nothing else.
bool parse_int(const char* s, long len, int* dst) {
    const char* end = s + len;
    while (s < end && is_space(*s)) ++s;
    if (s >= end) return false;
    char* out = nullptr;
    const long v = strtol(s, &out, 10);
    if (out == s || out > end || !rest_blank(out, end)) return false;
    *dst = static_cast<int>(v);
    return true;
}

// A hex digit's value, -1 for any other character.
int hexval(char c) {
    if (c >= '0' && c <= '9') return c - '0';
    if (c >= 'a' && c <= 'f') return c - 'a' + 10;
    if (c >= 'A' && c <= 'F') return c - 'A' + 10;
    return -1;
}

}  // namespace

extern "C" {

// Parse up to `cap` positions of board size `bsize` from `text`.
// Returns the number parsed; -1 on format error, -2 on size mismatch.
// A format error is any line the Python parser rejects (a missing, extra
// or garbled number, a plane digit that is not hex), and also a plane or
// ownership line of the wrong length, which that parser would pad with
// zeros or cut.
int sayuri_parse_positions(const char* text, long text_len, int bsize,
                           float* planes, float* prob, float* aux,
                           float* own, float* scalars, int cap) {
    const int hw = bsize * bsize;
    Cursor cur{text, text + text_len};
    int count = 0;
    const char* line;
    long len;

    while (count < cap) {
        // L1 version
        if (!cur.next_line(&line, &len)) break;
        if (len == 0) continue;  // tolerate blank separators
        if (!(len == 1 && line[0] == '2')) return -1;
        // L2 mode
        if (!cur.next_line(&line, &len)) return -1;
        // L3 board size
        if (!cur.next_line(&line, &len)) return -1;
        int size = 0;
        if (!parse_int(line, len, &size)) return -1;
        if (size != bsize) return -2;

        float* sc = scalars + count * kNumScalars;
        sc[0] = static_cast<float>(bsize);
        // L4 komi, L5 rule, L6 wave
        for (int k = 1; k <= 3; ++k) {
            if (!cur.next_line(&line, &len)) return -1;
            if (!parse_floats(line, len, sc + k, 1)) return -1;
        }
        // L7-L43 binary planes (hex packed, low bit first)
        float* pl = planes + static_cast<long>(count) * kNumBinaryPlanes * hw;
        const int n4 = (hw / 4) * 4;
        for (int pidx = 0; pidx < kNumBinaryPlanes; ++pidx) {
            if (!cur.next_line(&line, &len)) return -1;
            float* row = pl + pidx * hw;
            memset(row, 0, sizeof(float) * hw);
            const int ndigits = n4 / 4;
            while (len > 0 && is_space(line[len - 1])) --len;
            if (len != ndigits + (hw % 4 ? 1 : 0)) return -1;
            for (int d = 0; d < ndigits; ++d) {
                const int v = hexval(line[d]);
                if (v < 0) return -1;
                row[d * 4 + 0] = static_cast<float>(v & 1);
                row[d * 4 + 1] = static_cast<float>((v >> 1) & 1);
                row[d * 4 + 2] = static_cast<float>((v >> 2) & 1);
                row[d * 4 + 3] = static_cast<float>((v >> 3) & 1);
            }
            if (hw % 4) {
                row[hw - 1] = (line[ndigits] == '1') ? 1.f : 0.f;
            }
        }
        // L44 side to move (1 = black)
        if (!cur.next_line(&line, &len)) return -1;
        int to_move = 0;
        if (!parse_int(line, len, &to_move)) return -1;
        sc[4] = static_cast<float>(to_move);
        // L45 probabilities, L46 aux probabilities
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, prob + static_cast<long>(count) * (hw + 1), hw + 1))
            return -1;
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, aux + static_cast<long>(count) * (hw + 1), hw + 1))
            return -1;
        // L47 ownership chars
        if (!cur.next_line(&line, &len)) return -1;
        while (len > 0 && is_space(line[len - 1])) --len;
        if (len != hw) return -1;
        float* ow = own + static_cast<long>(count) * hw;
        for (int i = 0; i < hw; ++i) {
            ow[i] = line[i] == '1' ? 1.f : (line[i] == '3' ? -1.f : 0.f);
        }
        // L48 result
        if (!cur.next_line(&line, &len)) return -1;
        int result = 0;
        if (!parse_int(line, len, &result)) return -1;
        sc[5] = static_cast<float>(result);
        // L49 avg/short/mid/long q
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, sc + 6, 4)) return -1;
        // L50 final score
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, sc + 10, 1)) return -1;
        // L51 avg/short/mid/long score
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, sc + 11, 4)) return -1;
        // L52 stddevs
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, sc + 15, 2)) return -1;
        // L53 kld
        if (!cur.next_line(&line, &len)) return -1;
        if (!parse_floats(line, len, sc + 17, 1)) return -1;
        ++count;
    }
    return count;
}

// Serialize `n` positions into `out` (caller-sized buffer); returns bytes
// written or -1 if the buffer is too small. Inputs follow the layout
// contract above; float formatting matches C++ iostream defaults (%.6g).
long sayuri_serialize_positions(int n, int bsize, const float* planes,
                                const float* prob, const float* aux,
                                const float* own, const float* scalars,
                                char* out, long out_cap) {
    const int hw = bsize * bsize;
    char* w = out;
    char* end = out + out_cap;

#define EMIT(...)                                                   \
    do {                                                            \
        int _k = snprintf(w, static_cast<size_t>(end - w), __VA_ARGS__); \
        if (_k < 0 || w + _k >= end) return -1;                     \
        w += _k;                                                    \
    } while (0)

    for (int i = 0; i < n; ++i) {
        const float* sc = scalars + i * kNumScalars;
        EMIT("2\n0\n%d\n%.6g\n%.6g\n%.6g\n", bsize, sc[1], sc[2], sc[3]);
        const float* pl = planes + static_cast<long>(i) * kNumBinaryPlanes * hw;
        const int n4 = (hw / 4) * 4;
        for (int p = 0; p < kNumBinaryPlanes; ++p) {
            const float* row = pl + p * hw;
            for (int d = 0; d < n4; d += 4) {
                int v = (row[d] != 0.f) | ((row[d + 1] != 0.f) << 1) |
                        ((row[d + 2] != 0.f) << 2) | ((row[d + 3] != 0.f) << 3);
                EMIT("%x", v);
            }
            if (hw % 4) EMIT("%d", row[hw - 1] != 0.f ? 1 : 0);
            EMIT("\n");
        }
        EMIT("%d\n", static_cast<int>(sc[4]));
        const float* pr = prob + static_cast<long>(i) * (hw + 1);
        for (int k = 0; k <= hw; ++k) EMIT(k ? " %.6g" : "%.6g", pr[k]);
        EMIT("\n");
        const float* ax = aux + static_cast<long>(i) * (hw + 1);
        for (int k = 0; k <= hw; ++k) EMIT(k ? " %.6g" : "%.6g", ax[k]);
        EMIT("\n");
        const float* ow = own + static_cast<long>(i) * hw;
        for (int k = 0; k < hw; ++k) {
            EMIT("%c", ow[k] > 0.5f ? '1' : (ow[k] < -0.5f ? '3' : '0'));
        }
        EMIT("\n%d\n", static_cast<int>(sc[5]));
        EMIT("%.6g %.6g %.6g %.6g\n", sc[6], sc[7], sc[8], sc[9]);
        EMIT("%.6g\n", sc[10]);
        EMIT("%.6g %.6g %.6g %.6g\n", sc[11], sc[12], sc[13], sc[14]);
        EMIT("%.6g %.6g\n", sc[15], sc[16]);
        EMIT("%.6g\n", sc[17]);
    }
#undef EMIT
    return static_cast<long>(w - out);
}

int sayuri_codec_version() { return 1; }

}  // extern "C"
