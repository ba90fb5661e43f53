// Native host-side data-loading kernels for the VOCASET pipeline.
//
// The reference feeds training with 8 torch DataLoader worker *processes*
// running a per-item Python fragmenter (reference: train.py:39,
// src/dataset/vocaset.py:408-430). Here the per-batch hot path — windowed
// fragment gather + int16 -> float32 normalization (vocaset.py:64-69), and
// batch assembly of vertex rows from the mmapped array — is a C++ kernel
// parallelized with std::thread, invoked zero-copy through ctypes. The
// Python Prefetcher (runtime/hostloader.py) overlaps batch assembly and the
// host-to-device copies with device compute.
//
// Build (runtime/hostloader.py does it at first use, into build/torch_kernels/):
//   g++ -O3 -shared -fPIC -o libhostloader.so hostloader.cpp -pthread

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr float kInt16Scale = 1.0f / 32768.0f;

void parallel_for(int64_t n, int n_threads, void (*fn)(int64_t, int64_t, void*), void* ctx) {
    if (n_threads <= 1 || n < 2) {
        fn(0, n, ctx);
        return;
    }
    n_threads = static_cast<int>(std::min<int64_t>(n_threads, n));
    std::vector<std::thread> threads;
    threads.reserve(n_threads);
    int64_t chunk = (n + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * chunk;
        int64_t hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        threads.emplace_back(fn, lo, hi, ctx);
    }
    for (auto& th : threads) th.join();
}

struct FragmentCtx {
    const int16_t* audio;
    int64_t audio_len;
    const int64_t* starts;  // fragment start offsets relative to audio[0],
                            // may be negative (left zero padding)
    int64_t window;
    float* out;  // (n, window)
};

void fragment_rows(int64_t lo, int64_t hi, void* p) {
    auto* c = static_cast<FragmentCtx*>(p);
    for (int64_t i = lo; i < hi; ++i) {
        int64_t start = c->starts[i];
        float* row = c->out + i * c->window;
        for (int64_t j = 0; j < c->window; ++j) {
            int64_t src = start + j;
            row[j] = (src >= 0 && src < c->audio_len)
                         ? static_cast<float>(c->audio[src]) * kInt16Scale
                         : 0.0f;
        }
    }
}

struct GatherCtx {
    const float* src;  // (n_rows_total, row_elems)
    const int64_t* indices;
    int64_t row_elems;
    float* out;
};

void gather_rows(int64_t lo, int64_t hi, void* p) {
    auto* c = static_cast<GatherCtx*>(p);
    for (int64_t i = lo; i < hi; ++i) {
        std::memcpy(c->out + i * c->row_elems,
                    c->src + c->indices[i] * c->row_elems,
                    sizeof(float) * static_cast<size_t>(c->row_elems));
    }
}

}  // namespace

extern "C" {

// Gather `n` windowed fragments of length `window` from an int16 clip,
// normalizing to float32 in [-1, 1). Out-of-range samples are zero
// (equivalent to the reference's zero padding, vocaset.py:408-430).
void a2f_fragment_batch_i16(const int16_t* audio, int64_t audio_len,
                            const int64_t* starts, int64_t n, int64_t window,
                            float* out, int n_threads) {
    FragmentCtx ctx{audio, audio_len, starts, window, out};
    parallel_for(n, n_threads, fragment_rows, &ctx);
}

// Gather `n` float32 rows of `row_elems` elements by index (vertex-batch
// assembly from the mmapped data_verts array, vocaset.py:212-214).
void a2f_gather_rows_f32(const float* src, const int64_t* indices, int64_t n,
                         int64_t row_elems, float* out, int n_threads) {
    GatherCtx ctx{src, indices, row_elems, out};
    parallel_for(n, n_threads, gather_rows, &ctx);
}

int a2f_runtime_version() { return 1; }

}  // extern "C"
