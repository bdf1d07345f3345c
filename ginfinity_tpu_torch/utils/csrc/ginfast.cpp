// Native host-side parsers of the PyTorch port: the extended dot-bracket
// pair-table scan and a strict scanner for JSON float matrices (the
// node-embedding cells of the MSA and alignment TSVs).  A copy of the JAX
// package's native/ginfast.cpp, so that the port builds it itself.
//
// Built at first use by ginfinity_tpu_torch/utils/native.py with the host
// C++ compiler into ginfinity_tpu_torch/_build/<hash>/, and bound with
// ctypes.

#include <cstdint>
#include <cstdlib>
#include <vector>

#include <locale.h>  // newlocale/strtod_l: LC_NUMERIC-proof parsing

namespace {

// Length of a STRICT JSON number at p ("-?(0|[1-9][0-9]*)(\.[0-9]+)?"
// "([eE][+-]?[0-9]+)?"), or -1.  strtod alone is laxer (hex floats,
// "inf"/"nan", trailing '.', leading '+'), and json.loads rejects all
// of those — validating first keeps the contract "bit-matches the
// json.loads path or returns -1".
long json_number_len(const char* p, const char* end) {
    const char* q = p;
    if (q < end && *q == '-') ++q;
    if (q >= end) return -1;
    if (*q == '0') {
        ++q;
    } else if (*q >= '1' && *q <= '9') {
        while (q < end && *q >= '0' && *q <= '9') ++q;
    } else {
        return -1;
    }
    if (q < end && *q == '.') {
        ++q;
        if (q >= end || *q < '0' || *q > '9') return -1;
        while (q < end && *q >= '0' && *q <= '9') ++q;
    }
    if (q < end && (*q == 'e' || *q == 'E')) {
        ++q;
        if (q < end && (*q == '+' || *q == '-')) ++q;
        if (q >= end || *q < '0' || *q > '9') return -1;
        while (q < end && *q >= '0' && *q <= '9') ++q;
    }
    return q - p;
}

}  // namespace

extern "C" {

// Extended dot-bracket pair-table scan.
// Supports '.', '()', '[]', '{}', '<>' and letter pairs A..Z / a..z.
// Writes pt[i] = partner index or -1. Returns 0 on success, nonzero on
// malformed input (mirrors utils.py:144-177 validation semantics).
int gf_pair_table(const char* s, int n, int32_t* pt) {
    // 4 bracket families + 26 letter families.
    std::vector<int32_t> stacks[30];
    for (int i = 0; i < n; ++i) pt[i] = -1;
    for (int i = 0; i < n; ++i) {
        const char c = s[i];
        int open_slot = -1, close_slot = -1;
        switch (c) {
            case '.': continue;
            case '(': open_slot = 0; break;
            case '[': open_slot = 1; break;
            case '{': open_slot = 2; break;
            case '<': open_slot = 3; break;
            case ')': close_slot = 0; break;
            case ']': close_slot = 1; break;
            case '}': close_slot = 2; break;
            case '>': close_slot = 3; break;
            default:
                if (c >= 'A' && c <= 'Z') open_slot = 4 + (c - 'A');
                else if (c >= 'a' && c <= 'z') close_slot = 4 + (c - 'a');
                else return 1;  // not dot-bracket
        }
        if (open_slot >= 0) {
            stacks[open_slot].push_back(i);
        } else {
            auto& st = stacks[close_slot];
            if (st.empty()) return 2;  // unmatched closer
            const int32_t j = st.back();
            st.pop_back();
            pt[i] = j;
            pt[j] = i;
        }
    }
    for (auto& st : stacks)
        if (!st.empty()) return 3;  // unmatched opener
    return 0;
}

// Parse a JSON 2-D numeric matrix cell ("[[1.0,-2e-3],...]") into a flat
// float buffer.  The reference stores per-node embedding matrices as JSON
// text columns (generate_node_embeddings.py:54-63); at MSA family scale
// that is ~10^7 floats per input file and CPython json.loads dominates
// the pipeline's host tail.  Each number is parsed with strtod then cast
// to float so the result bit-matches the json.loads -> float64 -> float32
// path.  Rectangularity is enforced (every row the same width) and the
// row width is written to *ncols.  Returns the total count written
// (<= cap), or -1 on malformed/ragged/non-numeric input.
long gf_parse_floats(const char* s, long n, float* out, long cap,
                     long* ncols) {
    const char* p = s;
    const char* end = s + n;
    long count = 0;
    int depth = 0;
    long row_count = 0, first_row = -1;
    while (p < end) {
        const char c = *p;
        if ((c >= '0' && c <= '9') || c == '-') {
            if (depth != 2) return -1;  // numbers live only inside a row
            const long tok_len = json_number_len(p, end);
            if (tok_len <= 0) return -1;  // not a strict JSON number
            // strtod honours LC_NUMERIC (a comma-decimal locale would
            // silently mis-parse "[[1,5]]"); pin the C locale, and
            // reject any parse that does not consume exactly the
            // validated token
            static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
            char* tok_end = nullptr;
            const double v = c_loc ? strtod_l(p, &tok_end, c_loc)
                                   : strtod(p, &tok_end);
            if (tok_end != p + tok_len) return -1;
            if (count >= cap) return -1;
            out[count++] = (float)v;
            ++row_count;
            p = tok_end;
        } else if (c == '[') {
            if (++depth > 2) return -1;
            if (depth == 2) row_count = 0;
            ++p;
        } else if (c == ']') {
            if (depth == 2) {
                if (first_row < 0) first_row = row_count;
                else if (row_count != first_row) return -1;  // ragged
            }
            if (--depth < 0) return -1;
            ++p;
        } else if (c == ',' || c == ' ' || c == '\t' || c == '\n' ||
                   c == '\r') {
            ++p;
        } else {
            return -1;  // not a plain numeric matrix (null, strings, ...)
        }
    }
    if (depth != 0 || first_row <= 0) return -1;
    *ncols = first_row;
    return count;
}

}  // extern "C"
