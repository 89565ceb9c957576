// RawPack: mmap-backed packed image dataset with a parallel crop sampler
// (a copy of super_resolution_tpu/native/rawpack.cpp; the same file format
// and C ABI).
//
// The decode-free alternative to the reference's LMDB input path (ref:
// basicsr/utils/lmdb_util.py + file_client.py): images are decoded ONCE at
// pack time into raw uint8 HWC records; training reads are mmap'd memcpys
// of crop windows, fanned out over a thread pool, with no per-item PNG
// decode and no Python in the loop. Host code: built with g++ by
// super_resolution_tpu_torch/native.py, not with nvcc.
//
// File layout (little endian):
//   [0:4]   magic "SRPK"
//   [4:8]   uint32 version (1)
//   [8:16]  uint64 n_items
//   [16:..] n_items * {uint32 h, uint32 w, uint32 c, uint32 reserved,
//                      uint64 offset}
//   [...]   raw uint8 payloads (HWC, row-major)
//
// Exposed C ABI (ctypes):
//   rawpack_open(path) -> handle | NULL
//   rawpack_len(handle) -> int64
//   rawpack_info(handle, idx, out_h, out_w, out_c) -> 0/-1
//   rawpack_read(handle, idx, out) -> 0/-1           (whole item)
//   rawpack_crop_batch(handle, n, idxs, tops, lefts, crop, hflips, rots,
//                      out, n_threads) -> 0/-1       (parallel crops)
//   rawpack_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

namespace {

struct ItemMeta {
    uint32_t h, w, c, reserved;
    uint64_t offset;
};

struct Pack {
    int fd = -1;
    const uint8_t* base = nullptr;
    size_t size = 0;
    uint64_t n_items = 0;
    const ItemMeta* meta = nullptr;
};

// copy one (possibly flipped/rotated) crop into out (crop*crop*c uint8)
void copy_crop(const Pack* p, int64_t idx, int top, int left, int crop,
               int hflip, int rot90, uint8_t* out) {
    const ItemMeta& m = p->meta[idx];
    const uint8_t* src = p->base + m.offset;
    const int w = static_cast<int>(m.w);
    const int c = static_cast<int>(m.c);

    if (!hflip && !rot90) {
        for (int y = 0; y < crop; ++y) {
            std::memcpy(out + static_cast<size_t>(y) * crop * c,
                        src + (static_cast<size_t>(top + y) * w + left) * c,
                        static_cast<size_t>(crop) * c);
        }
        return;
    }
    // general path: per-pixel gather with flip/rot applied
    for (int y = 0; y < crop; ++y) {
        for (int x = 0; x < crop; ++x) {
            int sy = y, sx = x;
            if (rot90) { int t = sy; sy = sx; sx = t; }
            if (hflip) { sx = crop - 1 - sx; }
            const uint8_t* pix =
                src + (static_cast<size_t>(top + sy) * w + (left + sx)) * c;
            std::memcpy(out + (static_cast<size_t>(y) * crop + x) * c, pix, c);
        }
    }
}

}  // namespace

extern "C" {

void* rawpack_open(const char* path) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < 16) { ::close(fd); return nullptr; }
    void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (mem == MAP_FAILED) { ::close(fd); return nullptr; }
    const uint8_t* base = static_cast<const uint8_t*>(mem);
    if (std::memcmp(base, "SRPK", 4) != 0) {
        munmap(mem, st.st_size); ::close(fd); return nullptr;
    }
    auto* p = new Pack();
    p->fd = fd;
    p->base = base;
    p->size = st.st_size;
    std::memcpy(&p->n_items, base + 8, 8);
    p->meta = reinterpret_cast<const ItemMeta*>(base + 16);
    return p;
}

int64_t rawpack_len(void* handle) {
    return static_cast<Pack*>(handle)->n_items;
}

int rawpack_info(void* handle, int64_t idx, int64_t* h, int64_t* w, int64_t* c) {
    auto* p = static_cast<Pack*>(handle);
    if (idx < 0 || static_cast<uint64_t>(idx) >= p->n_items) return -1;
    const ItemMeta& m = p->meta[idx];
    *h = m.h; *w = m.w; *c = m.c;
    return 0;
}

int rawpack_read(void* handle, int64_t idx, uint8_t* out) {
    auto* p = static_cast<Pack*>(handle);
    if (idx < 0 || static_cast<uint64_t>(idx) >= p->n_items) return -1;
    const ItemMeta& m = p->meta[idx];
    std::memcpy(out, p->base + m.offset,
                static_cast<size_t>(m.h) * m.w * m.c);
    return 0;
}

int rawpack_crop_batch(void* handle, int64_t n, const int64_t* idxs,
                       const int64_t* tops, const int64_t* lefts,
                       int64_t crop, const uint8_t* hflips,
                       const uint8_t* rots, uint8_t* out,
                       int64_t n_threads) {
    auto* p = static_cast<Pack*>(handle);
    // validate first (workers must not fail)
    for (int64_t i = 0; i < n; ++i) {
        if (idxs[i] < 0 || static_cast<uint64_t>(idxs[i]) >= p->n_items)
            return -1;
        const ItemMeta& m = p->meta[idxs[i]];
        if (tops[i] < 0 || lefts[i] < 0 ||
            tops[i] + crop > m.h || lefts[i] + crop > m.w)
            return -1;
    }
    const int64_t c = p->meta[idxs[0]].c;
    const size_t item_bytes = static_cast<size_t>(crop) * crop * c;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > n) n_threads = n;

    auto worker = [&](int64_t t) {
        for (int64_t i = t; i < n; i += n_threads) {
            copy_crop(p, idxs[i], static_cast<int>(tops[i]),
                      static_cast<int>(lefts[i]), static_cast<int>(crop),
                      hflips ? hflips[i] : 0, rots ? rots[i] : 0,
                      out + static_cast<size_t>(i) * item_bytes);
        }
    };
    std::vector<std::thread> threads;
    for (int64_t t = 1; t < n_threads; ++t) threads.emplace_back(worker, t);
    worker(0);
    for (auto& th : threads) th.join();
    return 0;
}

void rawpack_close(void* handle) {
    auto* p = static_cast<Pack*>(handle);
    munmap(const_cast<uint8_t*>(p->base), p->size);
    ::close(p->fd);
    delete p;
}

}  // extern "C"
