// Binary scan-log reader/writer with background prefetch.
//
// The port's own copy of the native scan log (built by
// `mr_slam_torch/native.py` with g++). A native data loader in place of
// rosbag playback + message deserialization: a compact binary log feeds
// fixed-capacity frame buffers that the host moves to the device.
//
// Format (little endian):
//   header: magic "MRSL" u32 | version u32 | n_frames u32 |
//           max_points u32
//   frame:  stamp f64 | pose f32[12] (R row-major 9, t 3) |
//           n_points u32 | xyz f32[n_points*3]
//
// The reader owns a prefetch thread filling a bounded ring of decoded
// frames (points padded to max_points with a count), so disk decode
// overlaps device compute.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4C53524D;  // "MRSL"

struct Frame {
    double stamp;
    float pose[12];
    uint32_t n_points;
    std::vector<float> xyz;
};

struct Writer {
    FILE* f = nullptr;
    uint32_t n_frames = 0;
    uint32_t max_points = 0;
    long header_pos = 0;
};

struct Reader {
    FILE* f = nullptr;
    uint32_t n_frames = 0;
    uint32_t max_points = 0;
    uint32_t next_read = 0;

    std::thread worker;
    std::mutex mu;
    std::condition_variable cv_full, cv_empty;
    std::deque<Frame> ring;
    size_t ring_cap = 8;
    std::atomic<bool> stop{false};

    ~Reader() {
        stop = true;
        cv_full.notify_all();
        if (worker.joinable()) worker.join();
        if (f) fclose(f);
    }

    bool read_frame_locked(Frame& fr) {
        if (next_read >= n_frames) return false;
        if (fread(&fr.stamp, sizeof(double), 1, f) != 1) return false;
        if (fread(fr.pose, sizeof(float), 12, f) != 12) return false;
        if (fread(&fr.n_points, sizeof(uint32_t), 1, f) != 1) return false;
        fr.xyz.resize(static_cast<size_t>(fr.n_points) * 3);
        if (fr.n_points &&
            fread(fr.xyz.data(), sizeof(float), fr.xyz.size(), f) !=
                fr.xyz.size())
            return false;
        ++next_read;
        return true;
    }

    void run() {
        while (!stop) {
            Frame fr;
            {
                // file access is only from this thread; no lock needed
                if (!read_frame_locked(fr)) break;
            }
            std::unique_lock<std::mutex> lk(mu);
            cv_full.wait(lk, [&] { return ring.size() < ring_cap || stop; });
            if (stop) break;
            ring.push_back(std::move(fr));
            cv_empty.notify_one();
        }
        std::unique_lock<std::mutex> lk(mu);
        ring.push_back(Frame{0, {0}, UINT32_MAX, {}});  // sentinel EOF
        cv_empty.notify_one();
    }
};

}  // namespace

extern "C" {

void* mrslam_scanlog_writer_open(const char* path, uint32_t max_points) {
    auto* w = new Writer();
    w->f = fopen(path, "wb");
    if (!w->f) { delete w; return nullptr; }
    w->max_points = max_points;
    uint32_t version = 1, zero = 0;
    fwrite(&kMagic, 4, 1, w->f);
    fwrite(&version, 4, 1, w->f);
    w->header_pos = ftell(w->f);
    fwrite(&zero, 4, 1, w->f);
    fwrite(&max_points, 4, 1, w->f);
    return w;
}

int mrslam_scanlog_write(void* handle, double stamp, const float* pose12,
                         const float* xyz, uint32_t n_points) {
    auto* w = static_cast<Writer*>(handle);
    if (!w || !w->f) return -1;
    if (n_points > w->max_points) n_points = w->max_points;
    fwrite(&stamp, sizeof(double), 1, w->f);
    fwrite(pose12, sizeof(float), 12, w->f);
    fwrite(&n_points, sizeof(uint32_t), 1, w->f);
    fwrite(xyz, sizeof(float), static_cast<size_t>(n_points) * 3, w->f);
    ++w->n_frames;
    return 0;
}

void mrslam_scanlog_writer_close(void* handle) {
    auto* w = static_cast<Writer*>(handle);
    if (!w) return;
    if (w->f) {
        fseek(w->f, w->header_pos, SEEK_SET);
        fwrite(&w->n_frames, 4, 1, w->f);
        fclose(w->f);
    }
    delete w;
}

void* mrslam_scanlog_open(const char* path) {
    auto* r = new Reader();
    r->f = fopen(path, "rb");
    if (!r->f) { delete r; return nullptr; }
    uint32_t magic = 0, version = 0;
    if (fread(&magic, 4, 1, r->f) != 1 || magic != kMagic) {
        fclose(r->f); r->f = nullptr; delete r; return nullptr;
    }
    (void)!fread(&version, 4, 1, r->f);
    (void)!fread(&r->n_frames, 4, 1, r->f);
    (void)!fread(&r->max_points, 4, 1, r->f);
    r->worker = std::thread([r] { r->run(); });
    return r;
}

uint32_t mrslam_scanlog_n_frames(void* handle) {
    return static_cast<Reader*>(handle)->n_frames;
}

uint32_t mrslam_scanlog_max_points(void* handle) {
    return static_cast<Reader*>(handle)->max_points;
}

// Blocks for the next prefetched frame. Fills xyz (max_points*3,
// padded with 1e6), pose12, stamp; returns point count, or -1 at EOF.
int64_t mrslam_scanlog_next(void* handle, double* stamp, float* pose12,
                            float* xyz_out) {
    auto* r = static_cast<Reader*>(handle);
    Frame fr;
    {
        std::unique_lock<std::mutex> lk(r->mu);
        r->cv_empty.wait(lk, [&] { return !r->ring.empty(); });
        fr = std::move(r->ring.front());
        r->ring.pop_front();
        r->cv_full.notify_one();
    }
    if (fr.n_points == UINT32_MAX) return -1;  // EOF sentinel
    *stamp = fr.stamp;
    std::memcpy(pose12, fr.pose, sizeof(float) * 12);
    size_t n = fr.n_points;
    std::memcpy(xyz_out, fr.xyz.data(), sizeof(float) * n * 3);
    for (size_t i = n * 3; i < static_cast<size_t>(r->max_points) * 3; ++i)
        xyz_out[i] = 1e6f;
    return static_cast<int64_t>(n);
}

void mrslam_scanlog_close(void* handle) {
    delete static_cast<Reader*>(handle);
}

}  // extern "C"
