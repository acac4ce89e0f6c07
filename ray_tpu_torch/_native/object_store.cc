// ray_tpu shared-memory object store — the plasma equivalent.
//
// Reference behavior being matched (not translated):
//   src/ray/object_manager/plasma/store.cc          (create/seal/get/release)
//   src/ray/object_manager/plasma/object_lifecycle_manager.cc
//   src/ray/object_manager/plasma/eviction_policy.cc (LRU)
//   src/ray/object_manager/plasma/client.cc          (worker-side mmap client)
//
// Design: ONE POSIX shm segment per node holds a header, a fixed open-address
// hash table of object entries, and a data arena managed by a boundary-tag
// free list.  Every process (daemon + workers) maps the same segment, so a
// "get" is just (base + offset) — zero-copy, exactly plasma's trick, without
// the unix-socket handshake: coordination is a process-shared robust mutex
// living inside the segment itself.
//
// All offsets are relative to the start of the data arena so mappings at
// different virtual addresses agree.

#include <pthread.h>
#include <stdint.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <fcntl.h>
#include <unistd.h>

#include <errno.h>
#include <deque>
#include <mutex>
#include <new>

namespace {

constexpr uint64_t kMagic = 0x5241595f545055ULL;  // "RAY_TPU"
constexpr uint64_t kNil = ~0ULL;
constexpr uint64_t kAlign = 64;
constexpr int kIdLen = 20;

enum State : uint8_t {
  kFree = 0,      // slot never used (stops probe)
  kCreated = 1,   // allocated, being written, not readable, not evictable
  kSealed = 2,    // immutable, readable, evictable when unpinned
  kTombstone = 3, // deleted slot (probe continues)
};

struct Entry {
  uint8_t id[kIdLen];
  uint8_t state;
  uint8_t pending_delete;
  uint8_t pad_[2];
  uint32_t refcount;
  uint64_t offset;  // data offset (arena-relative) of the payload
  uint64_t size;
  uint64_t lru_tick;
};

// Free block: header lives at the block's arena offset.
struct FreeBlock {
  uint64_t size;  // total block size including the 8-byte alloc header
  uint64_t next;  // arena offset of next free block, or kNil
};

// Allocated block: 8-byte header holding total block size, then payload.
struct AllocHeader {
  uint64_t size;
};

struct Header {
  uint64_t magic;
  uint64_t capacity;   // arena bytes
  uint64_t used;       // bytes currently allocated (incl. headers)
  uint32_t max_objects;
  uint32_t n_objects;
  uint64_t lru_counter;
  uint64_t free_head;  // arena offset of first free block, or kNil
  uint64_t n_evictions;
  uint64_t bytes_evicted;
  pthread_mutex_t mutex;
};

struct Mapping {
  void* addr = nullptr;
  size_t len = 0;
  Header* hdr = nullptr;
  Entry* entries = nullptr;
  uint8_t* arena = nullptr;
  bool valid = false;
};

// deque: elements never move on push_back, so Mapping* stays valid while
// another thread attaches; the mutex guards push_back vs. size reads
// (ctypes releases the GIL during calls, so rts_* can run concurrently)
std::deque<Mapping>& mappings() {
  static std::deque<Mapping> m;
  return m;
}

std::mutex& mappings_mutex() {
  static std::mutex mu;
  return mu;
}

uint64_t align_up(uint64_t x, uint64_t a) { return (x + a - 1) & ~(a - 1); }

uint64_t entries_offset() { return align_up(sizeof(Header), kAlign); }

uint64_t arena_offset(uint32_t max_objects) {
  return align_up(entries_offset() + sizeof(Entry) * (uint64_t)max_objects, kAlign);
}

// A lock guard that heals robust mutexes left locked by a dead worker.
struct Lock {
  pthread_mutex_t* m;
  explicit Lock(pthread_mutex_t* mu) : m(mu) {
    int rc = pthread_mutex_lock(m);
    if (rc == EOWNERDEAD) pthread_mutex_consistent(m);
  }
  ~Lock() { pthread_mutex_unlock(m); }
};

uint64_t hash_id(const uint8_t* id) {
  uint64_t h;
  memcpy(&h, id, 8);
  // ids are content-random (sha/random), so the raw prefix is already a hash;
  // mix anyway so adversarial low-entropy ids don't cluster.
  h ^= h >> 33; h *= 0xff51afd7ed558ccdULL; h ^= h >> 33;
  return h;
}

// Find the slot holding `id`, or -1.
int64_t find_slot(Mapping& m, const uint8_t* id) {
  uint32_t n = m.hdr->max_objects;
  uint64_t i = hash_id(id) % n;
  for (uint32_t probes = 0; probes < n; ++probes) {
    Entry& e = m.entries[i];
    if (e.state == kFree) return -1;
    if (e.state != kTombstone && memcmp(e.id, id, kIdLen) == 0) return (int64_t)i;
    i = (i + 1) % n;
  }
  return -1;
}

// Find a slot to insert `id` into (first tombstone or free), or -1 if full.
int64_t insert_slot(Mapping& m, const uint8_t* id) {
  uint32_t n = m.hdr->max_objects;
  uint64_t i = hash_id(id) % n;
  int64_t first_tomb = -1;
  for (uint32_t probes = 0; probes < n; ++probes) {
    Entry& e = m.entries[i];
    if (e.state == kFree) return first_tomb >= 0 ? first_tomb : (int64_t)i;
    if (e.state == kTombstone && first_tomb < 0) first_tomb = (int64_t)i;
    i = (i + 1) % n;
  }
  return first_tomb;
}

// First-fit allocation from the free list.  Returns arena offset of the
// payload (past the AllocHeader), or kNil.
uint64_t arena_alloc(Mapping& m, uint64_t payload) {
  uint64_t need = align_up(payload + sizeof(AllocHeader), kAlign);
  uint64_t prev = kNil;
  uint64_t cur = m.hdr->free_head;
  while (cur != kNil) {
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(m.arena + cur);
    if (fb->size >= need) {
      uint64_t remain = fb->size - need;
      uint64_t next = fb->next;
      if (remain >= kAlign * 2) {
        // split: tail remains free
        uint64_t tail_off = cur + need;
        FreeBlock* tail = reinterpret_cast<FreeBlock*>(m.arena + tail_off);
        tail->size = remain;
        tail->next = next;
        next = tail_off;
      } else {
        need = fb->size;  // absorb the sliver
      }
      if (prev == kNil) m.hdr->free_head = next;
      else reinterpret_cast<FreeBlock*>(m.arena + prev)->next = next;
      AllocHeader* ah = reinterpret_cast<AllocHeader*>(m.arena + cur);
      ah->size = need;
      m.hdr->used += need;
      return cur + sizeof(AllocHeader);
    }
    prev = cur;
    cur = fb->next;
  }
  return kNil;
}

// Free the block whose payload starts at `payload_off`, coalescing with
// adjacent free blocks (the free list is kept address-ordered to make
// coalescing a local operation).
void arena_free(Mapping& m, uint64_t payload_off) {
  uint64_t block = payload_off - sizeof(AllocHeader);
  uint64_t size = reinterpret_cast<AllocHeader*>(m.arena + block)->size;
  m.hdr->used -= size;

  uint64_t prev = kNil, cur = m.hdr->free_head;
  while (cur != kNil && cur < block) {
    prev = cur;
    cur = reinterpret_cast<FreeBlock*>(m.arena + cur)->next;
  }
  // link in
  FreeBlock* nb = reinterpret_cast<FreeBlock*>(m.arena + block);
  nb->size = size;
  nb->next = cur;
  if (prev == kNil) m.hdr->free_head = block;
  else reinterpret_cast<FreeBlock*>(m.arena + prev)->next = block;
  // coalesce with next
  if (cur != kNil && block + nb->size == cur) {
    FreeBlock* cn = reinterpret_cast<FreeBlock*>(m.arena + cur);
    nb->size += cn->size;
    nb->next = cn->next;
  }
  // coalesce with prev
  if (prev != kNil) {
    FreeBlock* pb = reinterpret_cast<FreeBlock*>(m.arena + prev);
    if (prev + pb->size == block) {
      pb->size += nb->size;
      pb->next = nb->next;
    }
  }
}

void free_entry(Mapping& m, Entry& e) {
  arena_free(m, e.offset);
  e.state = kTombstone;
  e.refcount = 0;
  e.pending_delete = 0;
  m.hdr->n_objects -= 1;
}

// Evict least-recently-used sealed, unpinned objects until `need` bytes could
// plausibly be satisfied (or nothing evictable remains).  Returns bytes freed.
uint64_t evict_lru(Mapping& m, uint64_t need) {
  uint64_t freed = 0;
  while (freed < need) {
    int64_t victim = -1;
    uint64_t best = ~0ULL;
    for (uint32_t i = 0; i < m.hdr->max_objects; ++i) {
      Entry& e = m.entries[i];
      if (e.state == kSealed && e.refcount == 0 && e.lru_tick < best) {
        best = e.lru_tick;
        victim = (int64_t)i;
      }
    }
    if (victim < 0) break;
    Entry& e = m.entries[victim];
    uint64_t sz = align_up(e.size + sizeof(AllocHeader), kAlign);
    freed += sz;
    m.hdr->n_evictions += 1;
    m.hdr->bytes_evicted += e.size;
    free_entry(m, e);
  }
  return freed;
}

int64_t do_map(const char* name, bool create, uint64_t capacity, uint32_t max_objects) {
  int flags = create ? (O_CREAT | O_EXCL | O_RDWR) : O_RDWR;
  int fd = shm_open(name, flags, 0600);
  if (fd < 0) return -(int64_t)errno;

  uint64_t total = 0;
  if (create) {
    total = arena_offset(max_objects) + align_up(capacity, kAlign);
    if (ftruncate(fd, (off_t)total) != 0) {
      int e = errno;
      close(fd);
      shm_unlink(name);
      return -(int64_t)e;
    }
  } else {
    struct stat st;
    if (fstat(fd, &st) != 0) { int e = errno; close(fd); return -(int64_t)e; }
    total = (uint64_t)st.st_size;
  }

  void* addr = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (addr == MAP_FAILED) return -(int64_t)errno;

  Mapping m;
  m.addr = addr;
  m.len = total;
  m.hdr = reinterpret_cast<Header*>(addr);

  if (create) {
    Header* h = new (addr) Header();
    h->magic = kMagic;
    h->capacity = align_up(capacity, kAlign);
    h->used = 0;
    h->max_objects = max_objects;
    h->n_objects = 0;
    h->lru_counter = 0;
    h->n_evictions = 0;
    h->bytes_evicted = 0;
    pthread_mutexattr_t attr;
    pthread_mutexattr_init(&attr);
    pthread_mutexattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
    pthread_mutexattr_setrobust(&attr, PTHREAD_MUTEX_ROBUST);
    pthread_mutex_init(&h->mutex, &attr);
    pthread_mutexattr_destroy(&attr);
    memset(reinterpret_cast<uint8_t*>(addr) + entries_offset(), 0,
           sizeof(Entry) * (uint64_t)max_objects);
    m.entries = reinterpret_cast<Entry*>(reinterpret_cast<uint8_t*>(addr) + entries_offset());
    m.arena = reinterpret_cast<uint8_t*>(addr) + arena_offset(max_objects);
    FreeBlock* fb = reinterpret_cast<FreeBlock*>(m.arena);
    fb->size = h->capacity;
    fb->next = kNil;
    h->free_head = 0;
  } else {
    if (m.hdr->magic != kMagic) {
      munmap(addr, total);
      return -1000;  // not a ray_tpu store
    }
    m.entries = reinterpret_cast<Entry*>(reinterpret_cast<uint8_t*>(addr) + entries_offset());
    m.arena = reinterpret_cast<uint8_t*>(addr) + arena_offset(m.hdr->max_objects);
  }

  m.valid = true;
  std::lock_guard<std::mutex> g(mappings_mutex());
  mappings().push_back(m);
  return (int64_t)mappings().size() - 1;
}

Mapping* get_mapping(int64_t h) {
  // hold the lock across operator[] too: push_back may rewrite the deque's
  // internal block map even though elements themselves never move; the
  // returned Mapping* stays valid after unlock
  auto& ms = mappings();
  std::lock_guard<std::mutex> g(mappings_mutex());
  if (h < 0 || (size_t)h >= ms.size() || !ms[h].valid) return nullptr;
  return &ms[h];
}

}  // namespace

extern "C" {

// All functions return >=0 on success; negative values are errors:
//   -1 generic / not found, -2 out of memory (after eviction),
//   -3 object not sealed / wrong state, -4 already exists, -errno from OS.

int64_t rts_create(const char* name, uint64_t capacity, uint32_t max_objects) {
  return do_map(name, /*create=*/true, capacity, max_objects);
}

int64_t rts_attach(const char* name) { return do_map(name, false, 0, 0); }

int rts_detach(int64_t h) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  munmap(m->addr, m->len);
  m->valid = false;
  return 0;
}

int rts_unlink(const char* name) { return shm_unlink(name) == 0 ? 0 : -errno; }

// Base address of this process's mapping of the data arena (for zero-copy
// pointer math in the client: payload pointer = rts_base(h) + offset).
uint8_t* rts_base(int64_t h) {
  Mapping* m = get_mapping(h);
  return m ? m->arena : nullptr;
}

// allow_evict=0 returns -2 instead of silently dropping LRU objects, so an
// owner that layers disk spilling on top (reference: local_object_manager.cc)
// gets to persist victims before the space is reused.
int64_t rts_obj_create2(int64_t h, const uint8_t* id, uint64_t size,
                        int allow_evict) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  if (find_slot(*m, id) >= 0) return -4;
  int64_t slot = insert_slot(*m, id);
  if (slot < 0) return -2;  // table full
  uint64_t off = arena_alloc(*m, size);
  // evict_lru counts freed bytes that may be non-contiguous; keep evicting
  // until the allocation fits or nothing evictable remains
  while (off == kNil) {
    if (!allow_evict) return -2;  // no entry written yet: clean abort
    if (evict_lru(*m, align_up(size + sizeof(AllocHeader), kAlign)) == 0)
      return -2;
    off = arena_alloc(*m, size);
  }
  Entry& e = m->entries[slot];
  memcpy(e.id, id, kIdLen);
  e.state = kCreated;
  e.pending_delete = 0;
  e.refcount = 0;
  e.offset = off;
  e.size = size;
  e.lru_tick = ++m->hdr->lru_counter;
  m->hdr->n_objects += 1;
  return (int64_t)off;
}

int64_t rts_obj_create(int64_t h, const uint8_t* id, uint64_t size) {
  return rts_obj_create2(h, id, size, /*allow_evict=*/1);
}

int rts_obj_seal(int64_t h, const uint8_t* id) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  int64_t slot = find_slot(*m, id);
  if (slot < 0) return -1;
  Entry& e = m->entries[slot];
  if (e.state != kCreated) return -3;
  e.state = kSealed;
  e.lru_tick = ++m->hdr->lru_counter;
  return 0;
}

// Pins the object.  On success writes size and returns the arena offset.
int64_t rts_obj_get(int64_t h, const uint8_t* id, uint64_t* size_out) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  int64_t slot = find_slot(*m, id);
  if (slot < 0) return -1;
  Entry& e = m->entries[slot];
  if (e.state != kSealed) return -3;
  e.refcount += 1;
  e.lru_tick = ++m->hdr->lru_counter;
  if (size_out) *size_out = e.size;
  return (int64_t)e.offset;
}

int rts_obj_release(int64_t h, const uint8_t* id) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  int64_t slot = find_slot(*m, id);
  if (slot < 0) return -1;
  Entry& e = m->entries[slot];
  if (e.refcount > 0) e.refcount -= 1;
  if (e.pending_delete && e.refcount == 0) free_entry(*m, e);
  return 0;
}

int rts_obj_delete(int64_t h, const uint8_t* id) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  int64_t slot = find_slot(*m, id);
  if (slot < 0) return -1;
  Entry& e = m->entries[slot];
  if (e.refcount > 0) {
    e.pending_delete = 1;  // freed on last release
    return 1;
  }
  free_entry(*m, e);
  return 0;
}

int rts_obj_contains(int64_t h, const uint8_t* id) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  int64_t slot = find_slot(*m, id);
  if (slot < 0) return 0;
  return m->entries[slot].state == kSealed ? 2 : 1;
}

uint64_t rts_evict(int64_t h, uint64_t nbytes) {
  Mapping* m = get_mapping(h);
  if (!m) return 0;
  Lock lock(&m->hdr->mutex);
  return evict_lru(*m, nbytes);
}

int rts_stats(int64_t h, uint64_t* used, uint64_t* capacity, uint32_t* n_objects,
              uint64_t* n_evictions, uint64_t* bytes_evicted) {
  Mapping* m = get_mapping(h);
  if (!m) return -1;
  Lock lock(&m->hdr->mutex);
  if (used) *used = m->hdr->used;
  if (capacity) *capacity = m->hdr->capacity;
  if (n_objects) *n_objects = m->hdr->n_objects;
  if (n_evictions) *n_evictions = m->hdr->n_evictions;
  if (bytes_evicted) *bytes_evicted = m->hdr->bytes_evicted;
  return 0;
}

// List sealed, unpinned object ids (for the spill scan).  Writes up to
// max_ids ids (20 bytes each) into out; returns count written.
uint32_t rts_list_evictable(int64_t h, uint8_t* out, uint32_t max_ids) {
  Mapping* m = get_mapping(h);
  if (!m) return 0;
  Lock lock(&m->hdr->mutex);
  uint32_t n = 0;
  for (uint32_t i = 0; i < m->hdr->max_objects && n < max_ids; ++i) {
    Entry& e = m->entries[i];
    if (e.state == kSealed && e.refcount == 0) {
      memcpy(out + (uint64_t)n * kIdLen, e.id, kIdLen);
      ++n;
    }
  }
  return n;
}

}  // extern "C"
