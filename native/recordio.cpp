// recordio — native runtime IO for tamcmc-tpu.
//
// Native equivalent of the reference's buffered binary sample writer
// (`outputs.cpp` [U], SURVEY.md section 2 "Outputs") and of its ASCII
// spectrum reader (`string_handler.cpp`/`data.h` [U]).  The hot MCMC loop
// streams thinned sample blocks from device to host; this library makes the
// host side non-blocking: a double-buffered background flush thread eats the
// fwrite latency so the Python driver never stalls on disk.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
//
// Build: make -C native   (g++ -O3 -shared -fPIC -pthread)

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Writer {
    FILE* f = nullptr;
    int nvars = 0;
    std::vector<double> buf[2];     // double buffer
    int active = 0;                  // buffer currently being filled
    std::atomic<long> nrecords{0};
    std::thread flusher;
    std::mutex m;
    std::condition_variable cv_work, cv_done;
    bool pending = false;            // inactive buffer awaits flush
    bool stop = false;
    int err = 0;

    void flush_loop() {
        std::unique_lock<std::mutex> lk(m);
        for (;;) {
            cv_work.wait(lk, [&] { return pending || stop; });
            if (pending) {
                std::vector<double>& b = buf[1 - active];
                lk.unlock();
                if (!b.empty() &&
                    fwrite(b.data(), sizeof(double), b.size(), f) != b.size())
                    err = 1;
                b.clear();
                lk.lock();
                pending = false;
                cv_done.notify_all();
            }
            if (stop && !pending) return;
        }
    }
};

}  // namespace

extern "C" {

// ---------------- buffered record writer ----------------

void* rw_open(const char* path, int nvars) {
    Writer* w = new Writer();
    w->f = fopen(path, "wb");
    if (!w->f) { delete w; return nullptr; }
    w->nvars = nvars;
    w->flusher = std::thread([w] { w->flush_loop(); });
    return w;
}

// append nrec records of w->nvars doubles; copies into the active buffer and
// triggers an async flush of the previous one.
int rw_append(void* h, const double* data, long nrec) {
    Writer* w = static_cast<Writer*>(h);
    if (!w || w->err) return 1;
    size_t n = static_cast<size_t>(nrec) * w->nvars;
    {
        std::unique_lock<std::mutex> lk(w->m);
        std::vector<double>& b = w->buf[w->active];
        b.insert(b.end(), data, data + n);
        // hand the filled buffer to the flusher, keep filling the other
        w->cv_done.wait(lk, [&] { return !w->pending; });
        w->active = 1 - w->active;
        w->pending = true;
        w->cv_work.notify_one();
    }
    w->nrecords += nrec;
    return w->err;
}

long rw_count(void* h) {
    Writer* w = static_cast<Writer*>(h);
    return w ? w->nrecords.load() : -1;
}

// Synchronous barrier: returns only when every appended record is in the
// file (kernel page cache).  Needed at intra-phase checkpoints — the .bin
// must cover at least as many records as the restore file claims, or a
// crash-resume would truncate into data the checkpoint depends on.
int rw_flush(void* h) {
    Writer* w = static_cast<Writer*>(h);
    if (!w) return 1;
    std::unique_lock<std::mutex> lk(w->m);
    w->cv_done.wait(lk, [&] { return !w->pending; });   // drain async buffer
    std::vector<double>& b = w->buf[w->active];          // drain active buffer
    if (!b.empty() &&
        fwrite(b.data(), sizeof(double), b.size(), w->f) != b.size())
        w->err = 1;
    b.clear();
    if (fflush(w->f) != 0) w->err = 1;
    return w->err;
}

int rw_close(void* h) {
    Writer* w = static_cast<Writer*>(h);
    if (!w) return 1;
    {
        std::unique_lock<std::mutex> lk(w->m);
        w->cv_done.wait(lk, [&] { return !w->pending; });
        // flush whatever is left in the active buffer synchronously
        std::vector<double>& b = w->buf[w->active];
        if (!b.empty() &&
            fwrite(b.data(), sizeof(double), b.size(), w->f) != b.size())
            w->err = 1;
        b.clear();
        w->stop = true;
        w->cv_work.notify_one();
    }
    w->flusher.join();
    int err = w->err | (fclose(w->f) != 0);
    delete w;
    return err;
}

// ---------------- fast ASCII table reader ----------------

// Parses a whitespace-separated numeric table, skipping '#','!','*' comment
// lines.  Returns rows parsed; fills out[] (caller-allocated, cap doubles)
// row-major with `*ncols` columns (detected from the first data row).
long ascii_read_table(const char* path, double* out, long cap, int* ncols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    std::string line;
    line.reserve(1 << 12);
    long n = 0;
    int cols = 0;
    char buf[1 << 16];
    while (fgets(buf, sizeof buf, f)) {
        char* p = buf;
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '#' || *p == '!' || *p == '*' || *p == '\n' || *p == '\0')
            continue;
        int c = 0;
        char* end = p;
        while (true) {
            double v = strtod(p, &end);
            if (end == p) break;
            if (n + c < cap) out[n + c] = v;
            ++c;
            p = end;
        }
        if (c == 0) continue;
        if (cols == 0) cols = c;
        if (c != cols) { fclose(f); return -2; }  // ragged table
        n += cols;
        if (n > cap) { fclose(f); return -3; }     // caller buffer too small
    }
    fclose(f);
    *ncols = cols;
    return cols ? n / cols : 0;
}

}  // extern "C"
