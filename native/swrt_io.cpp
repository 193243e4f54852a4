// swrt_io — native frame-addressed binary I/O core.
//
// C++ implementation of the reference's direct-access binary format
// (/root/reference/qg_flow_ray_trace/write_field.m:31-48,
// read_field.m:59-101): float64 frames addressed by seek at
// unit*nx*ny*nz*(frame-1) (doubled for complex fields, which are stored
// as staggered real/imag blocks per frame), column-major within a frame.
//
// The Python layer (swraytracing/io/binio.py) binds these via
// ctypes; a pure-numpy fallback exists for environments without a
// compiler. This library is the hot path for streaming packet
// trajectories at 1e6 packets (16 MB/frame) without GIL-bound Python
// write loops: writes use a single pwrite-style positioned fwrite and
// readv-style batched frame reads.
//
// Build: g++ -O3 -shared -fPIC -o libswrt_io.so swrt_io.cpp
// (see native/Makefile; the Python wrapper auto-builds on first use.)

#include <cstdio>
#include <cstdint>
#include <cstring>
#include <sys/stat.h>

extern "C" {

// Return codes: 0 ok, negative errno-style failures.
enum SwrtErr {
    SWRT_OK = 0,
    SWRT_EOPEN = -1,
    SWRT_ESEEK = -2,
    SWRT_EWRITE = -3,
    SWRT_EREAD = -4,
    SWRT_ESHORT = -5,
};

// Write one frame (1-based `frame`) of n float64 values. For complex
// fields pass the real block and imag block concatenated (2n values)
// and is_complex=1; the frame stride doubles, matching write_field.m.
int swrt_write_frame(const char* path, int64_t frame, const double* data,
                     int64_t n, int is_complex) {
    // "a" then reopen r+ so the file exists without truncating it
    FILE* f = std::fopen(path, "ab");
    if (!f) return SWRT_EOPEN;
    std::fclose(f);
    f = std::fopen(path, "r+b");
    if (!f) return SWRT_EOPEN;

    const int64_t stride = is_complex ? 2 * n : n;
    if (std::fseek(f, (long)(8 * stride * (frame - 1)), SEEK_SET) != 0) {
        std::fclose(f);
        return SWRT_ESEEK;
    }
    const size_t count = (size_t)stride;
    size_t wrote = std::fwrite(data, sizeof(double), count, f);
    std::fclose(f);
    return wrote == count ? SWRT_OK : SWRT_EWRITE;
}

// Read `nframes` frames listed in `frames` (1-based) into out
// (nframes * stride doubles, frame-major).
int swrt_read_frames(const char* path, const int64_t* frames,
                     int64_t nframes, double* out, int64_t n,
                     int is_complex) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return SWRT_EOPEN;
    const int64_t stride = is_complex ? 2 * n : n;
    for (int64_t j = 0; j < nframes; ++j) {
        if (std::fseek(f, (long)(8 * stride * (frames[j] - 1)),
                       SEEK_SET) != 0) {
            std::fclose(f);
            return SWRT_ESEEK;
        }
        size_t got = std::fread(out + j * stride, sizeof(double),
                                (size_t)stride, f);
        if (got != (size_t)stride) {
            std::fclose(f);
            return SWRT_ESHORT;
        }
    }
    std::fclose(f);
    return SWRT_OK;
}

// Number of complete frames currently in the file (for resume).
int64_t swrt_frame_count(const char* path, int64_t n, int is_complex) {
    struct stat st;
    if (stat(path, &st) != 0) return 0;
    const int64_t stride_bytes = 8 * (is_complex ? 2 * n : n);
    return st.st_size / stride_bytes;
}

// Append a scalar time-series value (the reference's 0-d series files,
// e.g. pv_time.bin).
int swrt_append_scalar(const char* path, int64_t frame, double value) {
    return swrt_write_frame(path, frame, &value, 1, 0);
}

}  // extern "C"
