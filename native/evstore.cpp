// Native event store: mmap-backed, time-indexed columnar event files.
//
// Replacement for the reference's rosbag data-loading layer
// (reference: mapper_emvs_stereo/src/data_loading.cpp — C++ rosbag parsing,
// re-executed for EVERY sliding-window chunk, main.cpp:191-199).  Here the
// stream is ingested once into a columnar binary file; chunk windows are
// O(log E) binary searches over the mmap'd timestamp column, and an async
// prefetch thread warms the next window's pages while the device computes
// the current chunk (the ingest/compute overlap noted in SURVEY.md §2's
// pipeline-parallelism row).
//
// File layout (little-endian):
//   header: magic "EVST0001" | u64 count | f64 t0 | f64 t1
//   columns: f32 t[count] | u16 x[count] | u16 y[count] | i8 p[count]
// Timestamps are seconds relative to the stored t0 (f32 keeps sub-ms
// precision over typical sequence lengths; t0 carries the absolute epoch).
//
// C ABI for ctypes binding (io/evstore.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr char kMagic[8] = {'E', 'V', 'S', 'T', '0', '0', '0', '1'};
constexpr size_t kHeaderBytes = 8 + 8 + 8 + 8;

struct Store {
  int fd = -1;
  uint8_t* map = nullptr;
  size_t map_bytes = 0;
  uint64_t count = 0;
  double t0 = 0.0;
  double t1 = 0.0;
  const float* t = nullptr;
  const uint16_t* x = nullptr;
  const uint16_t* y = nullptr;
  const int8_t* p = nullptr;
  std::thread prefetcher;
  std::atomic<bool> prefetch_busy{false};
};

size_t file_bytes(uint64_t count) {
  return kHeaderBytes + count * (sizeof(float) + 2 * sizeof(uint16_t) + 1);
}

// Lower/upper bound over the mmap'd timestamp column.
uint64_t lower_bound_t(const Store* s, float tq) {
  uint64_t lo = 0, hi = s->count;
  while (lo < hi) {
    uint64_t mid = lo + (hi - lo) / 2;
    if (s->t[mid] < tq) lo = mid + 1; else hi = mid;
  }
  return lo;
}

uint64_t upper_bound_t(const Store* s, float tq) {
  uint64_t lo = 0, hi = s->count;
  while (lo < hi) {
    uint64_t mid = lo + (hi - lo) / 2;
    if (s->t[mid] <= tq) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace

extern "C" {

// Write a store file from caller-provided columns (t absolute seconds,
// sorted ascending).  Returns 0 on success.
int evs_create(const char* path, const double* t, const uint16_t* x,
               const uint16_t* y, const int8_t* p, uint64_t count) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  double t0 = count ? t[0] : 0.0;
  double t1 = count ? t[count - 1] : 0.0;
  if (fwrite(kMagic, 1, 8, f) != 8) { fclose(f); return -2; }
  fwrite(&count, 8, 1, f);
  fwrite(&t0, 8, 1, f);
  fwrite(&t1, 8, 1, f);
  // Column t: f32 relative seconds, streamed in blocks.
  constexpr size_t B = 1 << 20;
  static thread_local float buf[B];
  for (uint64_t i = 0; i < count; i += B) {
    size_t n = (count - i) < B ? (count - i) : B;
    for (size_t j = 0; j < n; ++j) buf[j] = (float)(t[i + j] - t0);
    if (fwrite(buf, sizeof(float), n, f) != n) { fclose(f); return -3; }
  }
  if (count) {
    if (fwrite(x, sizeof(uint16_t), count, f) != count) { fclose(f); return -3; }
    if (fwrite(y, sizeof(uint16_t), count, f) != count) { fclose(f); return -3; }
    if (p) {
      if (fwrite(p, 1, count, f) != count) { fclose(f); return -3; }
    } else {
      static const int8_t zeros[4096] = {0};
      for (uint64_t i = 0; i < count; i += 4096) {
        size_t n = (count - i) < 4096 ? (count - i) : 4096;
        fwrite(zeros, 1, n, f);
      }
    }
  }
  fclose(f);
  return 0;
}

void* evs_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return nullptr; }
  if ((size_t)st.st_size < kHeaderBytes) { close(fd); return nullptr; }
  uint8_t* map = (uint8_t*)mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (map == MAP_FAILED) { close(fd); return nullptr; }
  if (memcmp(map, kMagic, 8) != 0) { munmap(map, st.st_size); close(fd); return nullptr; }

  Store* s = new Store();
  s->fd = fd;
  s->map = map;
  s->map_bytes = st.st_size;
  memcpy(&s->count, map + 8, 8);
  memcpy(&s->t0, map + 16, 8);
  memcpy(&s->t1, map + 24, 8);
  if (file_bytes(s->count) > (size_t)st.st_size) {
    munmap(map, st.st_size); close(fd); delete s; return nullptr;
  }
  s->t = (const float*)(map + kHeaderBytes);
  s->x = (const uint16_t*)(map + kHeaderBytes + s->count * 4);
  s->y = (const uint16_t*)(map + kHeaderBytes + s->count * 4 + s->count * 2);
  s->p = (const int8_t*)(map + kHeaderBytes + s->count * 8);
  return s;
}

void evs_close(void* h) {
  Store* s = (Store*)h;
  if (!s) return;
  if (s->prefetcher.joinable()) s->prefetcher.join();
  if (s->map) munmap(s->map, s->map_bytes);
  if (s->fd >= 0) close(s->fd);
  delete s;
}

uint64_t evs_count(void* h) { return ((Store*)h)->count; }
double evs_t0(void* h) { return ((Store*)h)->t0; }
double evs_t1(void* h) { return ((Store*)h)->t1; }

// [t_start, t_end) window (absolute seconds) -> index range [lo, hi).
void evs_window(void* h, double t_start, double t_end,
                uint64_t* lo, uint64_t* hi) {
  Store* s = (Store*)h;
  float a = (float)(t_start - s->t0);
  float b = (float)(t_end - s->t0);
  *lo = lower_bound_t(s, a);
  *hi = lower_bound_t(s, b);  // [t0, t1): end-exclusive like Events.time_window
}

// Inclusive-end variant matching numpy searchsorted(side="right").
void evs_window_inclusive(void* h, double t_start, double t_end,
                          uint64_t* lo, uint64_t* hi) {
  Store* s = (Store*)h;
  *lo = lower_bound_t(s, (float)(t_start - s->t0));
  *hi = upper_bound_t(s, (float)(t_end - s->t0));
}

// Copy a decoded index range into caller buffers (any pointer may be null).
void evs_read(void* h, uint64_t lo, uint64_t hi,
              int32_t* out_x, int32_t* out_y, float* out_t, int8_t* out_p) {
  Store* s = (Store*)h;
  if (hi > s->count) hi = s->count;
  if (lo > hi) lo = hi;
  uint64_t n = hi - lo;
  if (out_t) memcpy(out_t, s->t + lo, n * sizeof(float));
  if (out_x) for (uint64_t i = 0; i < n; ++i) out_x[i] = s->x[lo + i];
  if (out_y) for (uint64_t i = 0; i < n; ++i) out_y[i] = s->y[lo + i];
  if (out_p && s->p) memcpy(out_p, s->p + lo, n);
}

// Raw column pointers for zero-copy numpy views (caller must keep the
// store open while the views live).
const float* evs_t_ptr(void* h) { return ((Store*)h)->t; }
const uint16_t* evs_x_ptr(void* h) { return ((Store*)h)->x; }
const uint16_t* evs_y_ptr(void* h) { return ((Store*)h)->y; }
const int8_t* evs_p_ptr(void* h) { return ((Store*)h)->p; }

// Async page-warm of a future window: madvise(WILLNEED) + touch on a
// background thread so the next chunk's pages are resident when the host
// assembles device buffers.  Returns immediately; 1 if a prefetch was
// started, 0 if one is still in flight.
int evs_prefetch(void* h, double t_start, double t_end) {
  Store* s = (Store*)h;
  bool expected = false;
  if (!s->prefetch_busy.compare_exchange_strong(expected, true)) return 0;
  if (s->prefetcher.joinable()) s->prefetcher.join();
  uint64_t lo, hi;
  evs_window(h, t_start, t_end, &lo, &hi);
  s->prefetcher = std::thread([s, lo, hi]() {
    long pagesz = sysconf(_SC_PAGESIZE);
    auto warm = [&](const uint8_t* base, size_t lo_b, size_t hi_b) {
      const uint8_t* a = base + (lo_b / pagesz) * pagesz;
      size_t len = hi_b - (a - base);
      madvise((void*)a, len, MADV_WILLNEED);
      volatile uint8_t sink = 0;
      for (const uint8_t* q = a; q < base + hi_b; q += pagesz) sink ^= *q;
      (void)sink;
    };
    const uint8_t* m = s->map;
    size_t c = s->count;
    warm(m, kHeaderBytes + lo * 4, kHeaderBytes + hi * 4);                 // t
    warm(m, kHeaderBytes + c * 4 + lo * 2, kHeaderBytes + c * 4 + hi * 2); // x
    warm(m, kHeaderBytes + c * 6 + lo * 2, kHeaderBytes + c * 6 + hi * 2); // y
    warm(m, kHeaderBytes + c * 8 + lo, kHeaderBytes + c * 8 + hi);         // p
    s->prefetch_busy.store(false);
  });
  return 1;
}

int evs_prefetch_busy(void* h) {
  return ((Store*)h)->prefetch_busy.load() ? 1 : 0;
}

}  // extern "C"
