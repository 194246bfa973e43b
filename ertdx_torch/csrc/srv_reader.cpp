// Fast .srv survey-file column reader.
//
// The reference parses PFLOTRAN ERT survey files with np.genfromtxt
// (Generate_ERT_utils.py:219) — ~100x slower than needed for the
// thousands-of-files ingest that builds the training set. This reader
// mmap-free, single-pass, zero-allocation-per-row parses one whitespace-
// delimited column after skipping a fixed header.
//
// The port's copy of csrc/srv_reader.cpp, built at first use with g++
// by ertdx_torch/utils/srv_native.py (host code: no CUDA here).
//
// C ABI for ctypes (no pybind11):
//   srv_read_column(path, skip_header, usecols, out, max_rows) -> n_rows
//     out: caller-allocated double buffer (max_rows)
//     returns -1 on open failure, -2 on truncated/short rows.
//   srv_count_rows(path, skip_header) -> row count (for sizing).
#include <cstdio>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>
#include <atomic>
#include <functional>
#include <thread>
#include <vector>
#include <locale.h>

// strtod is LC_NUMERIC-sensitive: a host setlocale(LC_ALL, "") under a
// comma-decimal locale would silently mis-parse every value. Parse with
// an explicit "C" locale instead (np.genfromtxt is locale-independent).
static locale_t c_locale() {
    static locale_t loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
    return loc;
}

static int64_t run_pool(int64_t n_files, int64_t n_threads,
                     const std::function<int64_t(int64_t)>& job) {
    if (n_threads <= 0) {
        n_threads = (int64_t)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 4;
    }
    if (n_threads > n_files) n_threads = n_files;
    std::atomic<int64_t> next(0);
    std::atomic<int64_t> fail(0);   // 0 = ok, else 1-based failing index
    auto worker = [&]() {
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_files || fail.load()) break;
            if (job(i) < 0) {
                int64_t expected = 0;
                fail.compare_exchange_strong(expected, i + 1);
                break;
            }
        }
    };
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
    return fail.load() ? -fail.load() : 0;
}


extern "C" {

static inline const char* skip_ws(const char* p) {
    while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
    return p;
}

// 1 = complete line (newline-terminated or final line at EOF);
// 0 = the 64 KiB buffer split a longer physical line — treating the
// chunks as separate lines would corrupt skip_header accounting AND
// row parsing identically in count+read (no mismatch to catch it), so
// callers must fail the file instead.
static inline int line_complete(const char* buf, FILE* f) {
    size_t len = std::strlen(buf);
    return (len && buf[len - 1] == '\n') || std::feof(f);
}

int64_t srv_count_rows(const char* path, int64_t skip_header) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t rows = 0, line = 0;
    char buf[1 << 16];
    while (std::fgets(buf, sizeof buf, f)) {
        if (!line_complete(buf, f)) { std::fclose(f); return -2; }
        if (line++ < skip_header) continue;
        const char* p = skip_ws(buf);
        // '#' comment lines are skipped (np.genfromtxt's default)
        if (*p && *p != '\n' && *p != '#') ++rows;
    }
    std::fclose(f);
    return rows;
}

int64_t srv_read_column(const char* path, int64_t skip_header, int64_t usecols,
                     double* out, int64_t max_rows) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    int64_t line = 0, n = 0;
    char buf[1 << 16];
    while (std::fgets(buf, sizeof buf, f)) {
        if (!line_complete(buf, f)) { std::fclose(f); return -2; }
        if (line++ < skip_header) continue;
        const char* p = skip_ws(buf);
        if (!*p || *p == '\n' || *p == '#') continue;
        // advance to column `usecols` (0-based)
        for (int64_t c = 0; c < usecols; ++c) {
            while (*p && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
                ++p;
            p = skip_ws(p);
            if (!*p || *p == '\n') { std::fclose(f); return -2; }
        }
        char* end = nullptr;
        double v = strtod_l(p, &end, c_locale());
        if (end == p) { std::fclose(f); return -2; }
        if (n >= max_rows) { std::fclose(f); return -2; }
        out[n++] = v;
    }
    std::fclose(f);
    return n;
}

// ---------------------------------------------------------------------------
// Threaded batch ingest: the training-set build parses thousands of files
// (reference: a serial np.genfromtxt loop, Generate_ERT_utils.py:203-224).
// Files are independent, so a work-stealing thread pool parses them
// concurrently. Two phases because row counts vary per survey:
//   srv_count_batch(paths, n, skip, counts, threads)      -> 0 / -(i+1)
//   srv_read_batch(paths, n, skip, col, out, offsets, counts, threads)
//     each file i parses into out[offsets[i] .. offsets[i]+counts[i])
//     returns 0, or -(i+1) naming the first failing file.
// ---------------------------------------------------------------------------

int64_t srv_count_batch(const char** paths, int64_t n_files, int64_t skip_header,
                     int64_t* counts, int64_t n_threads) {
    return run_pool(n_files, n_threads, [&](int64_t i) -> int64_t {
        int64_t n = srv_count_rows(paths[i], skip_header);
        if (n < 0) return -1;
        counts[i] = n;
        return 0;
    });
}

int64_t srv_read_batch(const char** paths, int64_t n_files, int64_t skip_header,
                    int64_t usecols, double* out, const int64_t* offsets,
                    const int64_t* counts, int64_t n_threads) {
    return run_pool(n_files, n_threads, [&](int64_t i) -> int64_t {
        int64_t got = srv_read_column(paths[i], skip_header, usecols,
                                   out + offsets[i], counts[i]);
        return got == counts[i] ? 0 : -1;
    });
}

}  // extern "C"
