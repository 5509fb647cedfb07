// Host core of scann_tpu_torch's mutator: a concurrent mutable dataset and
// a bounded mutation buffer (counterpart of the JAX package's
// native/scann_host.cpp, of which this is the port's own copy).
//
// Device tensors are immutable snapshots, so the mutable state lives on
// the host in this C++ core: an append-only float slab with a deleted
// bitset and a bounded MPMC mutation queue. Readers take a shared lock (no
// copy); writers take the exclusive lock only to grow the slab. Row
// payload accesses (update/get/snapshot) also take a striped per-row mutex
// so a concurrent update and read of the same row never observe a torn
// (half-written) vector; deleted[] is only accessed atomically.
//
// A plain C ABI, loaded with ctypes (native_host/__init__.py builds it
// with g++ at first use).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <shared_mutex>
#include <vector>

namespace {
constexpr uint64_t kRowStripes = 64;

inline uint8_t atomic_load_u8(const uint8_t* p) {
  return __atomic_load_n(p, __ATOMIC_ACQUIRE);
}
}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// MutableDataset core
// ---------------------------------------------------------------------------

struct MDS {
  uint64_t dim;
  std::shared_mutex grow_mu;           // exclusive only while reallocating
  std::vector<float> slab;             // rows * dim, append-only
  std::vector<uint8_t> deleted;        // per row, atomic access only
  std::atomic<uint64_t> rows{0};       // committed row count
  std::atomic<uint64_t> live{0};       // rows - deleted
  uint64_t capacity_rows;
  std::mutex append_mu;                // serializes appends (row id assignment)
  std::mutex row_mu[kRowStripes];      // striped row-payload locks
};

// Exceptions (std::bad_alloc from vector/deque growth) must not cross the
// C ABI into ctypes — that aborts the Python process. Allocating entry
// points catch everything and return their error value instead so the
// caller can fall back.
void* mds_create(uint64_t dim, uint64_t initial_capacity) try {
  auto* m = new MDS();
  m->dim = dim;
  m->capacity_rows = initial_capacity ? initial_capacity : 64;
  m->slab.resize(m->capacity_rows * dim);
  m->deleted.resize(m->capacity_rows, 0);
  return m;
} catch (...) {
  return nullptr;
}

void mds_destroy(void* h) { delete static_cast<MDS*>(h); }

int64_t mds_add(void* h, const float* data) try {
  auto* m = static_cast<MDS*>(h);
  std::lock_guard<std::mutex> ap(m->append_mu);
  uint64_t r = m->rows.load(std::memory_order_relaxed);
  if (r >= m->capacity_rows) {
    // grow: exclusive lock blocks readers only during the realloc
    std::unique_lock<std::shared_mutex> ex(m->grow_mu);
    uint64_t ncap = m->capacity_rows * 2;
    m->slab.resize(ncap * m->dim);
    m->deleted.resize(ncap, 0);
    m->capacity_rows = ncap;
  }
  {
    std::shared_lock<std::shared_mutex> sh(m->grow_mu);
    std::memcpy(&m->slab[r * m->dim], data, m->dim * sizeof(float));
    m->deleted[r] = 0;
  }
  m->rows.store(r + 1, std::memory_order_release);
  m->live.fetch_add(1, std::memory_order_relaxed);
  return static_cast<int64_t>(r);
} catch (...) {
  return -1;  // allocation failure: caller keeps the pre-add state
}

// Append n rows at once, in order; returns the first row's index, or -1 on
// an allocation failure (nothing appended). The same result as n calls of
// mds_add, with one lock and at most one reallocation.
int64_t mds_add_many(void* h, const float* data, uint64_t n) try {
  auto* m = static_cast<MDS*>(h);
  std::lock_guard<std::mutex> ap(m->append_mu);
  uint64_t r = m->rows.load(std::memory_order_relaxed);
  if (r + n > m->capacity_rows) {
    std::unique_lock<std::shared_mutex> ex(m->grow_mu);
    uint64_t ncap = std::max<uint64_t>(m->capacity_rows, 1);
    while (ncap < r + n) ncap *= 2;
    m->slab.resize(ncap * m->dim);
    m->deleted.resize(ncap, 0);
    m->capacity_rows = ncap;
  }
  if (n) {
    std::shared_lock<std::shared_mutex> sh(m->grow_mu);
    std::memcpy(&m->slab[r * m->dim], data, n * m->dim * sizeof(float));
    std::memset(&m->deleted[r], 0, n);
  }
  m->rows.store(r + n, std::memory_order_release);
  m->live.fetch_add(n, std::memory_order_relaxed);
  return static_cast<int64_t>(r);
} catch (...) {
  return -1;
}

int mds_remove(void* h, uint64_t idx) {
  auto* m = static_cast<MDS*>(h);
  std::shared_lock<std::shared_mutex> sh(m->grow_mu);
  if (idx >= m->rows.load(std::memory_order_acquire)) return -1;
  uint8_t expected = 0;
  if (__atomic_compare_exchange_n(&m->deleted[idx], &expected, 1, false,
                                  __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE)) {
    m->live.fetch_sub(1, std::memory_order_relaxed);
    return 0;
  }
  return -1;  // already deleted
}

int mds_update(void* h, uint64_t idx, const float* data) {
  auto* m = static_cast<MDS*>(h);
  std::shared_lock<std::shared_mutex> sh(m->grow_mu);
  if (idx >= m->rows.load(std::memory_order_acquire)) return -1;
  if (atomic_load_u8(&m->deleted[idx])) return -1;
  std::lock_guard<std::mutex> row(m->row_mu[idx % kRowStripes]);
  std::memcpy(&m->slab[idx * m->dim], data, m->dim * sizeof(float));
  return 0;
}

int mds_get(void* h, uint64_t idx, float* out) {
  auto* m = static_cast<MDS*>(h);
  std::shared_lock<std::shared_mutex> sh(m->grow_mu);
  if (idx >= m->rows.load(std::memory_order_acquire)) return -1;
  if (atomic_load_u8(&m->deleted[idx])) return -1;
  std::lock_guard<std::mutex> row(m->row_mu[idx % kRowStripes]);
  std::memcpy(out, &m->slab[idx * m->dim], m->dim * sizeof(float));
  return 0;
}

int mds_exists(void* h, uint64_t idx) {
  auto* m = static_cast<MDS*>(h);
  std::shared_lock<std::shared_mutex> sh(m->grow_mu);
  return idx < m->rows.load(std::memory_order_acquire) &&
         !atomic_load_u8(&m->deleted[idx]);
}

uint64_t mds_size(void* h) {  // live count
  return static_cast<MDS*>(h)->live.load(std::memory_order_relaxed);
}

uint64_t mds_rows(void* h) {  // total committed rows incl. deleted
  return static_cast<MDS*>(h)->rows.load(std::memory_order_acquire);
}

// Copy the committed slab + deleted flags into caller buffers; returns rows
// copied. This is the immutable snapshot handed to the device re-upload.
// Rows are copied stripe-locked, so each individual row is torn-free; the
// snapshot as a whole is some valid interleaving of concurrent updates.
uint64_t mds_snapshot(void* h, float* out_data, uint8_t* out_deleted,
                      uint64_t max_rows) {
  auto* m = static_cast<MDS*>(h);
  std::shared_lock<std::shared_mutex> sh(m->grow_mu);
  uint64_t r = m->rows.load(std::memory_order_acquire);
  if (r > max_rows) r = max_rows;
  if (out_data) {
    for (uint64_t i = 0; i < r; ++i) {
      std::lock_guard<std::mutex> row(m->row_mu[i % kRowStripes]);
      std::memcpy(out_data + i * m->dim, &m->slab[i * m->dim],
                  m->dim * sizeof(float));
    }
  }
  if (out_deleted) {
    for (uint64_t i = 0; i < r; ++i) out_deleted[i] = atomic_load_u8(&m->deleted[i]);
  }
  return r;
}

// Drop deleted rows in place; returns new row count. Caller must hold no
// outstanding row ids across a compact (ids are remapped), matching the
// reference's compact() contract (mutator/mod.rs:433-460).
uint64_t mds_compact(void* h) {
  auto* m = static_cast<MDS*>(h);
  std::lock_guard<std::mutex> ap(m->append_mu);
  std::unique_lock<std::shared_mutex> ex(m->grow_mu);
  uint64_t r = m->rows.load(std::memory_order_acquire);
  uint64_t w = 0;
  for (uint64_t i = 0; i < r; ++i) {
    if (!m->deleted[i]) {
      if (w != i) {
        std::memmove(&m->slab[w * m->dim], &m->slab[i * m->dim],
                     m->dim * sizeof(float));
      }
      m->deleted[w] = 0;
      ++w;
    }
  }
  m->rows.store(w, std::memory_order_release);
  m->live.store(w, std::memory_order_relaxed);
  return w;
}

// ---------------------------------------------------------------------------
// Mutation buffer (bounded MPMC queue)
// ---------------------------------------------------------------------------

struct MBufEntry {
  int32_t kind;  // 0 add, 1 remove, 2 update
  uint64_t index;
  uint64_t timestamp;
  std::vector<float> data;
};

struct MBuf {
  std::mutex mu;
  std::deque<MBufEntry> q;
  uint64_t max_size;
  std::atomic<uint64_t> ts{0};
};

void* mbuf_create(uint64_t max_size) try {
  auto* b = new MBuf();
  b->max_size = max_size ? max_size : 1024;
  return b;
} catch (...) {
  return nullptr;
}

void mbuf_destroy(void* h) { delete static_cast<MBuf*>(h); }

int mbuf_push(void* h, int32_t kind, uint64_t index, const float* data,
              uint64_t dim) try {
  auto* b = static_cast<MBuf*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  if (b->q.size() >= b->max_size) return -1;
  MBufEntry e;
  e.kind = kind;
  e.index = index;
  e.timestamp = b->ts.fetch_add(1, std::memory_order_relaxed);
  if (data && dim) e.data.assign(data, data + dim);
  b->q.push_back(std::move(e));
  return 0;
} catch (...) {
  return -1;  // bad_alloc on entry copy/deque growth: reject the push
}

uint64_t mbuf_len(void* h) {
  auto* b = static_cast<MBuf*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  return b->q.size();
}

// Pop one entry; returns 0 and fills outputs, or -1 when empty. data buffer
// must hold dim floats (dim passed at push time is the dataset dim).
int mbuf_pop(void* h, int32_t* kind, uint64_t* index, uint64_t* timestamp,
             float* data, uint64_t dim) {
  auto* b = static_cast<MBuf*>(h);
  std::lock_guard<std::mutex> lk(b->mu);
  if (b->q.empty()) return -1;
  MBufEntry& e = b->q.front();
  *kind = e.kind;
  *index = e.index;
  *timestamp = e.timestamp;
  if (data && !e.data.empty()) {
    uint64_t n = e.data.size() < dim ? e.data.size() : dim;
    std::memcpy(data, e.data.data(), n * sizeof(float));
  }
  b->q.pop_front();
  return 0;
}

}  // extern "C"
