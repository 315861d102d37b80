// swtpu native runtime: host-side hot paths that don't belong on the device.
//
// The reference keeps its runtime in native code (stringtape, forkunion,
// automaton builders inside aho-corasick/stringzilla — SURVEY.md §2.3);
// this library is this build's equivalent for the host side:
//   - corpus tokenization scans (lines/words span extraction at memory
//     bandwidth, feeding Tape construction),
//   - Aho-Corasick automaton construction (goto/fail BFS compressed into a
//     dense DFA with accumulated output counts; the device runs the dense
//     table as a gather chain — ops/ahocorasick.py),
//   - BinaryFuse8 peeling (sequential pointer-chasing, unfit for XLA).
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 dependency).

#include <array>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Tokenization scans
// ---------------------------------------------------------------------------

// Writes token (start, end) pairs for whitespace-delimited words.
// Returns the token count; call with spans == nullptr to size first.
int64_t swtpu_word_spans(const uint8_t* data, int64_t n, int64_t* spans) {
    static bool is_ws[256] = {};
    is_ws[' '] = is_ws['\t'] = is_ws['\n'] = is_ws['\r'] = is_ws['\v'] = is_ws['\f'] = true;
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && is_ws[data[i]]) i++;
        if (i >= n) break;
        int64_t start = i;
        while (i < n && !is_ws[data[i]]) i++;
        if (spans) {
            spans[2 * count] = start;
            spans[2 * count + 1] = i;
        }
        count++;
    }
    return count;
}

// Line spans (split on LF, keeping empty lines like bytes.split("\n")).
int64_t swtpu_line_spans(const uint8_t* data, int64_t n, int64_t* spans) {
    int64_t count = 0;
    int64_t start = 0;
    for (int64_t i = 0; i <= n; i++) {
        if (i == n || data[i] == '\n') {
            if (spans) {
                spans[2 * count] = start;
                spans[2 * count + 1] = i;
            }
            count++;
            start = i + 1;
        }
    }
    return count;
}

// ---------------------------------------------------------------------------
// Aho-Corasick: trie + BFS fail links, compressed to a dense DFA.
// ---------------------------------------------------------------------------

struct AcBuilder {
    std::vector<std::array<int32_t, 256>> next;  // dense goto (DFA after build)
    std::vector<int32_t> fail;
    std::vector<int32_t> out_count;  // patterns ending here (incl. via fails)
    std::vector<int64_t> out_len_sum;
};

static thread_local AcBuilder g_builder;

// Build from concatenated patterns. Returns the state count.
// patterns: flat bytes; offsets: [n_patterns + 1].
int64_t swtpu_ac_build(const uint8_t* patterns, const int64_t* offsets,
                       int64_t n_patterns) {
    AcBuilder& b = g_builder;
    b.next.clear();
    b.fail.clear();
    b.out_count.clear();
    b.next.emplace_back();
    b.next[0].fill(-1);
    b.fail.assign(1, 0);
    b.out_count.assign(1, 0);
    for (int64_t p = 0; p < n_patterns; p++) {
        int32_t state = 0;
        for (int64_t i = offsets[p]; i < offsets[p + 1]; i++) {
            uint8_t c = patterns[i];
            if (b.next[state][c] < 0) {
                b.next[state][c] = (int32_t)b.next.size();
                b.next.emplace_back();
                b.next.back().fill(-1);
                b.fail.push_back(0);
                b.out_count.push_back(0);
            }
            state = b.next[state][c];
        }
        b.out_count[state] += 1;
    }
    // BFS: fail links + DFA compression + output accumulation.
    std::queue<int32_t> q;
    for (int c = 0; c < 256; c++) {
        int32_t s = b.next[0][c];
        if (s < 0) {
            b.next[0][c] = 0;
        } else {
            b.fail[s] = 0;
            q.push(s);
        }
    }
    while (!q.empty()) {
        int32_t u = q.front();
        q.pop();
        b.out_count[u] += b.out_count[b.fail[u]];
        for (int c = 0; c < 256; c++) {
            int32_t v = b.next[u][c];
            if (v < 0) {
                b.next[u][c] = b.next[b.fail[u]][c];
            } else {
                b.fail[v] = b.next[b.fail[u]][c];
                q.push(v);
            }
        }
    }
    return (int64_t)b.next.size();
}

// Copy the dense DFA out: delta [states * 256] i32, out_count [states] i32.
void swtpu_ac_export(int32_t* delta, int32_t* out_count) {
    AcBuilder& b = g_builder;
    for (size_t s = 0; s < b.next.size(); s++) {
        std::memcpy(delta + s * 256, b.next[s].data(), 256 * sizeof(int32_t));
        out_count[s] = b.out_count[s];
    }
}

// Reference host scan (conformance oracle + baseline variant): returns the
// total number of pattern occurrences in data.
int64_t swtpu_ac_count(const uint8_t* data, int64_t n) {
    AcBuilder& b = g_builder;
    int64_t total = 0;
    int32_t state = 0;
    for (int64_t i = 0; i < n; i++) {
        state = b.next[state][data[i]];
        total += b.out_count[state];
    }
    return total;
}

}  // extern "C"
