// Fast host-side CSV parsing for heat_tpu_torch.core.io.load_csv (the port's
// own copy of heat_tpu/native/fastcsv.cpp, built by heat_tpu_torch.native).
//
// The reference framework's CSV loader splits byte ranges per MPI rank and
// tokenizes in Python (reference heat/core/io.py:710-860). The host feeds the
// card, so host-side tokenization is on the data path; this parser memory-
// maps the file, splits it into per-thread byte ranges aligned to line
// boundaries (the same byte-range rule the reference uses across ranks) and
// tokenizes with strtod in parallel.
//
// C ABI (ctypes):
//   csv_dims(path, sep, skip_header, &rows, &cols) -> 0 on success
//   csv_parse(path, sep, skip_header, out, rows, cols) -> 0 on success
//   csv_parse_range(path, sep, skip_header, row_offset, row_count, out, cols)
//     -> 0 on success; parses only rows [row_offset, row_offset+row_count)
//     — the per-process block of a multi-host load (each host tokenizes just
//     its canonical chunk; only the newline scan touches the whole file)
// Missing trailing fields parse as NaN; extra fields are ignored.

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <locale.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <string>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Mapped {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;
    bool heap = false;
    // fd stays >= 0 exactly when open+fstat(+mmap/read) succeeded
    bool ok() const { return fd >= 0; }
};

// strtod is not length-bounded, so the byte after the last file byte must be
// readable and non-numeric. For non-page-multiple sizes the kernel zero-fills
// the mmap'd tail of the last page ('\0' stops strtod); for exact
// page-multiple sizes there is no such guard page, so fall back to a heap
// buffer with an explicit NUL terminator.
Mapped map_file(const char* path) {
    Mapped m;
    m.fd = open(path, O_RDONLY);
    if (m.fd < 0) return m;
    struct stat st;
    if (fstat(m.fd, &st) != 0) { close(m.fd); m.fd = -1; return m; }
    m.size = static_cast<size_t>(st.st_size);
    if (m.size == 0) { m.data = ""; return m; }
    size_t page = static_cast<size_t>(sysconf(_SC_PAGESIZE));
    if (m.size % page != 0) {
        void* p = mmap(nullptr, m.size, PROT_READ, MAP_PRIVATE, m.fd, 0);
        if (p != MAP_FAILED) {
            m.data = static_cast<const char*>(p);
            return m;
        }
    }
    char* buf = static_cast<char*>(malloc(m.size + 1));
    if (!buf) { close(m.fd); m.fd = -1; return m; }
    size_t got = 0;
    while (got < m.size) {
        ssize_t r = read(m.fd, buf + got, m.size - got);
        if (r <= 0) { free(buf); close(m.fd); m.fd = -1; return m; }
        got += static_cast<size_t>(r);
    }
    buf[m.size] = '\0';
    m.data = buf;
    m.heap = true;
    return m;
}

void unmap_file(Mapped& m) {
    if (m.heap) free(const_cast<char*>(m.data));
    else if (m.data && m.size) munmap(const_cast<char*>(m.data), m.size);
    if (m.fd >= 0) close(m.fd);
}

// Advance past `skip` lines; returns offset of the first kept byte.
size_t skip_lines(const char* data, size_t size, long skip) {
    size_t pos = 0;
    while (skip > 0 && pos < size) {
        const char* nl = static_cast<const char*>(
            memchr(data + pos, '\n', size - pos));
        if (!nl) return size;
        pos = static_cast<size_t>(nl - data) + 1;
        --skip;
    }
    return pos;
}

// Collect the start offset of the first (up to) max_n non-empty lines in
// [lo, hi) — a range parse only needs the prefix, so the scan stops early.
void line_starts(const char* data, size_t lo, size_t hi,
                 std::vector<size_t>* out, size_t max_n = SIZE_MAX) {
    size_t pos = lo;
    while (pos < hi && out->size() < max_n) {
        const char* nl = static_cast<const char*>(
            memchr(data + pos, '\n', hi - pos));
        size_t end = nl ? static_cast<size_t>(nl - data) : hi;
        size_t len = end - pos;
        if (len > 0 && !(len == 1 && data[pos] == '\r')) out->push_back(pos);
        pos = end + 1;
    }
}

// strtod honors LC_NUMERIC; a host app running under a comma-decimal locale
// (de_DE etc.) would silently truncate "1.5" to 1.0. Pin the C locale.
locale_t c_locale() {
    static locale_t c_loc = newlocale(LC_NUMERIC_MASK, "C", nullptr);
    return c_loc;
}

double strtod_c(const char* s, char** end) {
    locale_t c_loc = c_locale();
    if (!c_loc) return strtod(s, end);  // newlocale failed: plain strtod
    return strtod_l(s, end, c_loc);
}

long count_fields(const char* line, size_t len, char sep) {
    if (len == 0) return 0;
    long n = 1;
    for (size_t i = 0; i < len; ++i)
        if (line[i] == sep) ++n;
    return n;
}

size_t line_len(const char* data, size_t start, size_t size) {
    const char* nl = static_cast<const char*>(
        memchr(data + start, '\n', size - start));
    size_t end = nl ? static_cast<size_t>(nl - data) : size;
    if (end > start && data[end - 1] == '\r') --end;
    return end - start;
}

void parse_rows(const char* data, size_t size, char sep,
                const std::vector<size_t>& starts, size_t row_lo,
                size_t row_hi, long cols, double* out) {
    for (size_t r = row_lo; r < row_hi; ++r) {
        size_t pos = starts[r];
        size_t end = pos + line_len(data, pos, size);
        double* row = out + static_cast<size_t>(cols) * r;
        long c = 0;
        while (c < cols) {
            if (pos >= end) {
                row[c++] = NAN;  // ragged short row: pad like genfromtxt
                continue;
            }
            // bound the field FIRST: strtod treats '\t'/' '/'\n' as skippable
            // whitespace, so an empty field under a whitespace separator
            // would otherwise consume the NEXT field's value ("1\t\t2" must
            // read [1, NaN, 2], the genfromtxt oracle)
            const char* sp = static_cast<const char*>(
                memchr(data + pos, sep, end - pos));
            const char* field_end = sp ? sp : data + end;
            char* after = nullptr;
            double v = strtod_c(data + pos, &after);
            if (after == data + pos || after > field_end) {
                // empty/non-numeric field, or strtod skipped whitespace past
                // the separator (or the newline) into a later field/row
                row[c] = NAN;
            } else {
                row[c] = v;
            }
            ++c;
            pos = sp ? static_cast<size_t>(sp - data) + 1 : end;
        }
    }
}

// Parse rows [first, first+count) of the post-header lines into `out`
// (count x cols, row-major), multithreaded. Shared by the whole-file and
// per-process-range entry points; the line scan stops after first+count
// lines, so a range parse only scans the file prefix it needs.
int parse_span(const char* path, char sep, long skip_header, long first,
               long count, long cols, double* out) {
    if (first < 0 || count < 0) return -2;
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    size_t lo = skip_lines(m.data, m.size, skip_header);
    size_t want = static_cast<size_t>(first) + static_cast<size_t>(count);
    std::vector<size_t> starts;
    line_starts(m.data, lo, m.size, &starts, want);
    if (starts.size() < want) {
        unmap_file(m);
        return -2;
    }
    // slice the range so parse_rows' row->out indexing starts at 0
    std::vector<size_t> span(starts.begin() + first, starts.end());
    size_t n = static_cast<size_t>(count);
    unsigned hw = std::thread::hardware_concurrency();
    size_t nthreads = hw ? hw : 4;
    if (nthreads > n / 1024 + 1) nthreads = n / 1024 + 1;  // small spans: fewer threads
    std::vector<std::thread> threads;
    size_t chunk = (n + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; ++t) {
        size_t r0 = t * chunk;
        size_t r1 = r0 + chunk < n ? r0 + chunk : n;
        if (r0 >= r1) break;
        threads.emplace_back(parse_rows, m.data, m.size, sep, std::cref(span),
                             r0, r1, cols, out);
    }
    for (auto& th : threads) th.join();
    unmap_file(m);
    return 0;
}

}  // namespace

extern "C" {

int csv_dims(const char* path, char sep, long skip_header, long* rows,
             long* cols) {
    Mapped m = map_file(path);
    if (!m.ok()) return -1;
    size_t lo = skip_lines(m.data, m.size, skip_header);
    std::vector<size_t> starts;
    line_starts(m.data, lo, m.size, &starts);
    *rows = static_cast<long>(starts.size());
    *cols = starts.empty()
                ? 0
                : count_fields(m.data + starts[0],
                               line_len(m.data, starts[0], m.size), sep);
    unmap_file(m);
    return 0;
}

int csv_parse(const char* path, char sep, long skip_header, double* out,
              long rows, long cols) {
    return parse_span(path, sep, skip_header, 0, rows, cols, out);
}

int csv_parse_range(const char* path, char sep, long skip_header,
                    long row_offset, long row_count, double* out, long cols) {
    return parse_span(path, sep, skip_header, row_offset, row_count, cols, out);
}

// Format (rows x cols, row-major f64) as CSV into `path`. %.17g keeps every
// double bit-exact on round-trip (and is several times faster than
// numpy.savetxt's Python-level formatting). Rows are formatted into
// per-thread buffers in parallel, then written sequentially in order.
// append != 0 opens in append mode (the multi-host slab-ring writer).
int csv_write(const char* path, const double* data, long rows, long cols,
              char sep, int append) {
    if (rows < 0 || cols < 0) return -2;
    size_t n = static_cast<size_t>(rows);
    unsigned hw = std::thread::hardware_concurrency();
    size_t nthreads = hw ? hw : 4;
    if (nthreads > n / 2048 + 1) nthreads = n / 2048 + 1;
    size_t chunk = n ? (n + nthreads - 1) / nthreads : 0;
    std::vector<std::string> bufs(nthreads);

    auto format_rows = [&](size_t t, size_t r0, size_t r1) {
        // snprintf %g honors LC_NUMERIC like strtod — pin the C locale in
        // each formatting thread so a comma-decimal host locale can't
        // corrupt the output
        locale_t c_loc = c_locale();
        locale_t prev = c_loc ? uselocale(c_loc) : static_cast<locale_t>(0);
        std::string& b = bufs[t];
        b.reserve((r1 - r0) * static_cast<size_t>(cols) * 26);
        char tmp[40];
        for (size_t r = r0; r < r1; ++r) {
            const double* row = data + static_cast<size_t>(cols) * r;
            for (long c = 0; c < cols; ++c) {
                int len = snprintf(tmp, sizeof(tmp), "%.17g", row[c]);
                b.append(tmp, static_cast<size_t>(len));
                b.push_back(c + 1 < cols ? sep : '\n');
            }
            if (cols == 0) b.push_back('\n');
        }
        if (prev) uselocale(prev);
    };

    std::vector<std::thread> threads;
    for (size_t t = 0; t < nthreads; ++t) {
        size_t r0 = t * chunk;
        size_t r1 = r0 + chunk < n ? r0 + chunk : n;
        if (r0 >= r1) break;
        threads.emplace_back(format_rows, t, r0, r1);
    }
    for (auto& th : threads) th.join();

    FILE* f = fopen(path, append ? "ab" : "wb");
    if (!f) return -1;
    for (const auto& b : bufs) {
        if (!b.empty() && fwrite(b.data(), 1, b.size(), f) != b.size()) {
            fclose(f);
            return -1;
        }
    }
    if (fclose(f) != 0) return -1;
    return 0;
}

}  // extern "C"
