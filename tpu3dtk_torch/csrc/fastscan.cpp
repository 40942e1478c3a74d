// Whitespace-separated float table parser: the port's copy of
// tpu3dtk/native/fastscan.cpp (the reference's scan readers are C++
// per-format plugins, src/scanio/*.cc + helper.cc readASCII).  The scan
// loader (io/scandir.py) hands it the text files numpy.loadtxt rejects:
// ragged rows and stray tokens.
//
// Exposed as a tiny C ABI for ctypes (tpu3dtk_torch/native):
//   parse_table(path, skip_lines, out_rows, out_cols) -> double* (owned)
//   free_table(ptr)
//
// One buffered read of the whole file, strtod in a tight loop, a
// growable arena.  Built with the host compiler at first use
// (ops/cuda_build.py::load_host_library).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <vector>

extern "C" {

// Parses the file; infers the column count from the first data row.
// Rows with a different column count are skipped (matching numpy's
// tolerance is not needed; scan files are regular).  Lines starting
// with '#' are comments.  skip_lines header lines are dropped.
double* parse_table(const char* path, int skip_lines,
                    int64_t* out_rows, int32_t* out_cols) {
    *out_rows = 0;
    *out_cols = 0;
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(std::malloc(size + 1));
    if (!buf) { std::fclose(f); return nullptr; }
    size_t rd = std::fread(buf, 1, size, f);
    std::fclose(f);
    buf[rd] = '\0';

    char* p = buf;
    char* end = buf + rd;
    // skip header lines
    for (int i = 0; i < skip_lines && p < end; i++) {
        while (p < end && *p != '\n') p++;
        if (p < end) p++;
    }

    std::vector<double> data;
    data.reserve(1 << 20);
    int32_t ncols = -1;
    int64_t nrows = 0;

    while (p < end) {
        // skip blank space at line start
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        if (p >= end) break;
        if (*p == '\n') { p++; continue; }
        if (*p == '#') {  // comment line
            while (p < end && *p != '\n') p++;
            continue;
        }
        // parse one line
        int32_t c = 0;
        size_t row_start = data.size();
        while (p < end && *p != '\n') {
            char* next = nullptr;
            double v = std::strtod(p, &next);
            if (next == p) {  // unparsable token: skip it
                while (p < end && *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r') p++;
            } else {
                data.push_back(v);
                c++;
                p = next;
            }
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        }
        if (p < end) p++;  // consume '\n'
        if (c == 0) continue;
        if (ncols < 0) ncols = c;
        if (c != ncols) {  // ragged row: drop it
            data.resize(row_start);
            continue;
        }
        nrows++;
    }
    std::free(buf);

    if (nrows == 0 || ncols <= 0) {
        *out_cols = ncols > 0 ? ncols : 0;
        return nullptr;
    }
    double* out = static_cast<double*>(std::malloc(sizeof(double) * data.size()));
    if (!out) return nullptr;
    std::memcpy(out, data.data(), sizeof(double) * data.size());
    *out_rows = nrows;
    *out_cols = ncols;
    return out;
}

void free_table(double* ptr) { std::free(ptr); }

}  // extern "C"
