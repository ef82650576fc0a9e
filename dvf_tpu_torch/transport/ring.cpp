// Host-side frame ring — the port's copy of the JAX package's native
// transport primitive (dvf_tpu/transport/ring.cpp; the code below is that
// file's, unchanged, so both packages share one wire and one eviction
// order).
//
// Role: the local replacement for the reference's ZeroMQ frame hop
// (distributor.py:27-35 / worker.py:17-25). Camera/ingress producers push
// encoded or raw frames into this ring; the batch assembler pops them.
// Semantics mirror the reference's ingest queue exactly
// (distributor.py:188-203): bounded, and on overflow the OLDEST frames are
// dropped to make room — freshness beats completeness in a soft-real-time
// pipeline. Drops are counted and reported.
//
// Design: single-producer/single-consumer lock-free byte ring with a
// per-frame record header (64-bit frame index, double timestamp, payload
// length). SPSC needs only two atomics with acquire/release ordering — no
// mutexes on the hot path. The drop-oldest path is safe because only the
// producer advances the tail during an overflow, and it does so before
// publishing its own write (consumer re-validates its read position).
// The region can live in private memory (threads) or POSIX shared memory
// (processes) — creation is the caller's choice via ring_create /
// ring_create_shm.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC ring.cpp -lrt, into
// dvf_tpu_torch/_build/ (driven by transport/_native.py for ring.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct RecordHeader {
  uint64_t frame_index;
  double timestamp;
  uint32_t payload_len;
  uint32_t _pad;  // keep records 8-byte aligned
};

constexpr uint64_t kAlign = 8;

inline uint64_t align_up(uint64_t v) { return (v + kAlign - 1) & ~(kAlign - 1); }

struct Control {
  // head: next write offset (monotonic, mod capacity on use).
  // tail: next read offset (monotonic).
  std::atomic<uint64_t> head;
  std::atomic<uint64_t> tail;
  std::atomic<uint64_t> dropped;
  std::atomic<uint64_t> pushed;
  std::atomic<uint64_t> popped;
  uint64_t capacity;  // bytes of the data region
  uint32_t magic;
  uint32_t _pad;
};

// Bumped ("dvfs") when Control grew the popped counter — a layout change;
// a stale peer attaching to the old shm layout must be refused, not read
// garbage offsets.
constexpr uint32_t kMagic = 0x64766673;  // "dvfs"

struct Ring {
  Control* ctl;
  uint8_t* data;
  bool owns_shm;
  char shm_name[64];
  void* base;       // mmap/malloc base (ctl)
  uint64_t total;   // total mapped bytes
};

// Copy bytes into the ring at logical offset (wrapping).
void ring_write(Ring* r, uint64_t off, const void* src, uint64_t len) {
  uint64_t cap = r->ctl->capacity;
  uint64_t p = off % cap;
  uint64_t first = (p + len <= cap) ? len : cap - p;
  std::memcpy(r->data + p, src, first);
  if (first < len) std::memcpy(r->data, static_cast<const uint8_t*>(src) + first, len - first);
}

void ring_read(Ring* r, uint64_t off, void* dst, uint64_t len) {
  uint64_t cap = r->ctl->capacity;
  uint64_t p = off % cap;
  uint64_t first = (p + len <= cap) ? len : cap - p;
  std::memcpy(dst, r->data + p, first);
  if (first < len) std::memcpy(static_cast<uint8_t*>(dst) + first, r->data, len - first);
}

Ring* make_ring(void* base, uint64_t total, bool init, bool owns_shm, const char* name) {
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->base = base;
  r->total = total;
  r->ctl = static_cast<Control*>(base);
  r->data = static_cast<uint8_t*>(base) + align_up(sizeof(Control));
  r->owns_shm = owns_shm;
  r->shm_name[0] = '\0';
  if (name) {
    std::strncpy(r->shm_name, name, sizeof(r->shm_name) - 1);
    r->shm_name[sizeof(r->shm_name) - 1] = '\0';
  }
  if (init) {
    r->ctl->head.store(0, std::memory_order_relaxed);
    r->ctl->tail.store(0, std::memory_order_relaxed);
    r->ctl->dropped.store(0, std::memory_order_relaxed);
    r->ctl->pushed.store(0, std::memory_order_relaxed);
    r->ctl->popped.store(0, std::memory_order_relaxed);
    r->ctl->capacity = total - align_up(sizeof(Control));
    r->ctl->magic = kMagic;
  } else if (r->ctl->magic != kMagic ||
             r->ctl->capacity > total - align_up(sizeof(Control))) {
    // Reject segments whose recorded capacity exceeds the mapped size —
    // a stale/mid-recreation segment would otherwise drive ring_read/
    // ring_write past the mapping (SIGBUS), since the attach path takes
    // geometry from the segment itself.
    delete r;
    return nullptr;
  }
  return r;
}

}  // namespace

extern "C" {

// In-process (thread-to-thread) ring.
Ring* ring_create(uint64_t capacity_bytes) {
  uint64_t total = align_up(sizeof(Control)) + align_up(capacity_bytes);
  void* base = std::malloc(total);
  if (!base) return nullptr;
  return make_ring(base, total, /*init=*/true, /*owns_shm=*/false, nullptr);
}

// Cross-process ring backed by POSIX shared memory. create=1 initializes
// with the given capacity; create=0 ATTACHES and takes the geometry from
// the segment itself (capacity_bytes is ignored — the creator decided it;
// requiring the attacher to guess would reject any mismatch).
Ring* ring_create_shm(const char* name, uint64_t capacity_bytes, int create) {
  uint64_t total = align_up(sizeof(Control)) + align_up(capacity_bytes);
  int flags = create ? (O_CREAT | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return nullptr;
  if (create && ftruncate(fd, static_cast<off_t>(total)) != 0) {
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  if (!create) {
    struct stat st;
    if (fstat(fd, &st) != 0 ||
        static_cast<uint64_t>(st.st_size) < align_up(sizeof(Control))) {
      close(fd);
      return nullptr;
    }
    total = static_cast<uint64_t>(st.st_size);
  }
  void* base = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return nullptr;
  return make_ring(base, total, create != 0, /*owns_shm=*/create != 0, name);
}

// Push one frame. Returns the number of frames dropped to make room
// (0 = clean push), or -1 if the frame can never fit.
int64_t ring_push(Ring* r, const uint8_t* payload, uint64_t len,
                  uint64_t frame_index, double timestamp) {
  uint64_t rec = align_up(sizeof(RecordHeader) + len);
  uint64_t cap = r->ctl->capacity;
  if (rec > cap) return -1;

  uint64_t head = r->ctl->head.load(std::memory_order_relaxed);
  int64_t dropped_now = 0;
  // Drop-oldest until the new record fits (distributor.py:193-203).
  // Each eviction is a CAS so a concurrently-advancing consumer wins the
  // race for any given record: a plain store here could move tail
  // BACKWARDS past the consumer's committed position and re-deliver
  // already-popped frames.
  while (true) {
    uint64_t tail = r->ctl->tail.load(std::memory_order_acquire);
    if (head + rec - tail <= cap) break;
    RecordHeader oldh;
    ring_read(r, tail, &oldh, sizeof(oldh));
    uint64_t next = tail + align_up(sizeof(RecordHeader) + oldh.payload_len);
    if (r->ctl->tail.compare_exchange_strong(tail, next,
                                             std::memory_order_acq_rel)) {
      ++dropped_now;
    }
    // CAS failure: the consumer popped that record first — re-read tail,
    // which may already have made enough room.
  }
  if (dropped_now > 0) {
    r->ctl->dropped.fetch_add(static_cast<uint64_t>(dropped_now), std::memory_order_relaxed);
  }

  RecordHeader h{frame_index, timestamp, static_cast<uint32_t>(len), 0};
  ring_write(r, head, &h, sizeof(h));
  ring_write(r, head + sizeof(h), payload, len);
  r->ctl->head.store(head + rec, std::memory_order_release);
  r->ctl->pushed.fetch_add(1, std::memory_order_relaxed);
  return dropped_now;
}

// Pop one frame into buf (size buflen). Returns payload length, 0 if the
// ring is empty, or -(needed) if buflen is too small (frame stays queued).
int64_t ring_pop(Ring* r, uint8_t* buf, uint64_t buflen,
                 uint64_t* frame_index, double* timestamp) {
  while (true) {
    uint64_t tail = r->ctl->tail.load(std::memory_order_relaxed);
    uint64_t head = r->ctl->head.load(std::memory_order_acquire);
    if (tail == head) return 0;
    RecordHeader h;
    ring_read(r, tail, &h, sizeof(h));
    if (h.payload_len > buflen) {
      // The header may be torn if the producer just dropped this record
      // and is overwriting it; only trust the size if tail is unchanged
      // (the producer CASes tail forward BEFORE writing over the bytes).
      if (r->ctl->tail.load(std::memory_order_acquire) == tail) {
        return -static_cast<int64_t>(h.payload_len);
      }
      continue;  // raced with a drop — retry from the new tail
    }
    ring_read(r, tail + sizeof(h), buf, h.payload_len);
    uint64_t next = tail + align_up(sizeof(RecordHeader) + h.payload_len);
    // The producer may have advanced tail past us (drop-oldest) while we
    // copied; only commit if our view was still current.
    uint64_t expect = tail;
    if (r->ctl->tail.compare_exchange_strong(expect, next,
                                             std::memory_order_acq_rel)) {
      r->ctl->popped.fetch_add(1, std::memory_order_relaxed);
      if (frame_index) *frame_index = h.frame_index;
      if (timestamp) *timestamp = h.timestamp;
      return static_cast<int64_t>(h.payload_len);
    }
    // Raced with a drop — retry from the new tail.
  }
}

uint64_t ring_approx_len(Ring* r) {
  // Pure counter arithmetic — no header walk. Walking record headers
  // raced with the producer: a header mid-overwrite could yield a garbage
  // payload_len, skipping the walk past head and returning a wrong count.
  // The three relaxed loads below are each coherent; the combination can
  // be transiently off by one under concurrent push/pop (hence "approx"),
  // never garbage.
  uint64_t pushed = r->ctl->pushed.load(std::memory_order_relaxed);
  uint64_t dropped = r->ctl->dropped.load(std::memory_order_relaxed);
  uint64_t popped = r->ctl->popped.load(std::memory_order_relaxed);
  uint64_t consumed = dropped + popped;
  return pushed > consumed ? pushed - consumed : 0;
}

uint64_t ring_dropped(Ring* r) { return r->ctl->dropped.load(std::memory_order_relaxed); }
uint64_t ring_pushed(Ring* r) { return r->ctl->pushed.load(std::memory_order_relaxed); }
uint64_t ring_popped(Ring* r) { return r->ctl->popped.load(std::memory_order_relaxed); }
uint64_t ring_capacity(Ring* r) { return r->ctl->capacity; }

void ring_destroy(Ring* r) {
  if (!r) return;
  if (r->shm_name[0]) {
    munmap(r->base, r->total);
    if (r->owns_shm) shm_unlink(r->shm_name);
  } else {
    std::free(r->base);
  }
  delete r;
}

}  // extern "C"
