// Shared-memory message queue: the native transport of the serving data
// plane, between the predictor (admin process) and inference worker
// processes on one host.
//
// Own copy of rafiki_tpu/native/src/shmqueue.cpp. A POSIX shm ring buffer
// of length-prefixed messages with a process-shared robust mutex and
// condvars: co-located processes hand off messages with no broker server,
// no TCP and no polling. Bound through ctypes
// (rafiki_tpu_torch/native/shm_queue.py).
//
// The one difference from the original: shmq_create reserves the
// segment's pages when it creates it (posix_fallocate), and reports why a
// create failed through its `err` argument. The original sized the
// segment with ftruncate alone, which succeeds on a tmpfs smaller than
// the ring (containers often mount /dev/shm at 64 MB); the first write
// past the limit then killed the process with SIGBUS. Here such a ring is
// refused at create time with ENOSPC. The header, the message framing
// and the ring protocol are unchanged, byte for byte, so either package
// can attach to a ring the other created.
//
// Concurrency: MPMC. One mutex guards head/tail; not_empty/not_full condvars
// wake blocked readers/writers. Robustness: PTHREAD_MUTEX_ROBUST so a
// crashed holder doesn't deadlock survivors (EOWNERDEAD is recovered).
//
// Layout in the shm segment:
//   [Header][data ring of capacity bytes]
// Messages are [u32 length][payload], contiguous; a write that would
// straddle the end writes a u32 0xFFFFFFFF wrap marker (if >= 4 bytes
// remain) and restarts at offset 0.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>

#include <fcntl.h>
#include <pthread.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x52465451;  // "RFTQ"
constexpr uint32_t kWrapMarker = 0xFFFFFFFFu;

struct Header {
  uint32_t magic;
  uint32_t capacity;      // bytes in the data ring
  uint64_t head;          // read offset  (monotonic, mod capacity)
  uint64_t tail;          // write offset (monotonic, mod capacity)
  uint64_t used;          // bytes currently in the ring
  uint32_t closed;
  pthread_mutex_t mutex;
  pthread_cond_t not_empty;
  pthread_cond_t not_full;
};

struct Handle {
  Header* hdr;
  uint8_t* data;
  size_t map_size;
  int owner;  // created (vs opened): unlink responsibility
  char name[256];
};

void timeout_to_abs(long timeout_ms, timespec* ts) {
  clock_gettime(CLOCK_REALTIME, ts);
  ts->tv_sec += timeout_ms / 1000;
  ts->tv_nsec += (timeout_ms % 1000) * 1000000L;
  if (ts->tv_nsec >= 1000000000L) {
    ts->tv_sec += 1;
    ts->tv_nsec -= 1000000000L;
  }
}

// Lock, recovering from a crashed previous owner.
int robust_lock(pthread_mutex_t* m) {
  int rc = pthread_mutex_lock(m);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(m);
    rc = 0;
  }
  return rc;
}

int robust_timedlock(pthread_mutex_t* m, const timespec* ts) {
  int rc = pthread_mutex_timedlock(m, ts);
  if (rc == EOWNERDEAD) {
    pthread_mutex_consistent(m);
    rc = 0;
  }
  return rc;
}

}  // namespace

extern "C" {

// Create a queue (this handle owns it and unlinks it at destroy). Returns
// nullptr on error, with the errno of the failed call in *err (ENOSPC:
// the shm filesystem has no room for the ring).
void* shmq_create(const char* name, uint32_t capacity, int* err) {
  *err = 0;
  size_t map_size = sizeof(Header) + capacity;
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    *err = errno;
    return nullptr;
  }
  // reserve every page now: a tmpfs that cannot hold the ring fails here,
  // not with SIGBUS at the first write past its limit
  int rc = ftruncate(fd, (off_t)map_size) != 0
               ? errno
               : posix_fallocate(fd, 0, (off_t)map_size);
  if (rc != 0) {
    close(fd);
    shm_unlink(name);
    *err = rc;
    return nullptr;
  }
  void* mem =
      mmap(nullptr, map_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) {
    *err = errno;
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  close(fd);
  Header* hdr = (Header*)mem;
  std::memset(hdr, 0, sizeof(Header));
  hdr->capacity = capacity;

  pthread_mutexattr_t ma;
  pthread_mutexattr_init(&ma);
  pthread_mutexattr_setpshared(&ma, PTHREAD_PROCESS_SHARED);
  pthread_mutexattr_setrobust(&ma, PTHREAD_MUTEX_ROBUST);
  pthread_mutex_init(&hdr->mutex, &ma);
  pthread_mutexattr_destroy(&ma);

  pthread_condattr_t ca;
  pthread_condattr_init(&ca);
  pthread_condattr_setpshared(&ca, PTHREAD_PROCESS_SHARED);
  pthread_cond_init(&hdr->not_empty, &ca);
  pthread_cond_init(&hdr->not_full, &ca);
  pthread_condattr_destroy(&ca);

  hdr->magic = kMagic;  // last: marks fully-initialized

  Handle* h = new Handle;
  h->hdr = hdr;
  h->data = (uint8_t*)mem + sizeof(Header);
  h->map_size = map_size;
  h->owner = 1;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  h->name[sizeof(h->name) - 1] = 0;
  return h;
}

void* shmq_open(const char* name) {
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || (size_t)st.st_size < sizeof(Header)) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                   MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  Header* hdr = (Header*)mem;
  if (hdr->magic != kMagic) {
    munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  Handle* h = new Handle;
  h->hdr = hdr;
  h->data = (uint8_t*)mem + sizeof(Header);
  h->map_size = (size_t)st.st_size;
  h->owner = 0;
  std::strncpy(h->name, name, sizeof(h->name) - 1);
  h->name[sizeof(h->name) - 1] = 0;
  return h;
}

// Push one message. Returns 0 ok, -1 timeout, -2 closed, -3 too large.
int shmq_push(void* hv, const uint8_t* buf, uint32_t len, long timeout_ms) {
  Handle* h = (Handle*)hv;
  Header* q = h->hdr;
  if (4ull + len > q->capacity) return -3;  // unfittable even when empty
  timespec ts;
  timeout_to_abs(timeout_ms, &ts);
  // timed, so a stopped (e.g. SIGSTOP'd) lock holder can't block a push
  // past its deadline — mirrors shmq_pop
  if (robust_timedlock(&q->mutex, &ts) != 0) return -1;
  // The space requirement depends on where tail sits (a wrap skips the
  // remainder of the ring), and tail moves whenever another producer gets
  // in between our waits — so recompute it every iteration.
  uint32_t cap = q->capacity;
  for (;;) {
    if (q->closed) {
      pthread_mutex_unlock(&q->mutex);
      return -2;
    }
    uint64_t tail = q->tail % cap;
    uint64_t room_to_end = cap - tail;
    uint64_t required = 4ull + len;
    if (room_to_end < required) required += room_to_end;  // wrap skip bytes
    if (cap - q->used >= required) break;
    if (q->used == 0) {
      // ring empty (head == tail, nothing in flight) yet insufficient:
      // only the wrap-skip remainder is in the way. Rebase both cursors
      // to 0 — any message that fits an empty ring now fits (the entry
      // check guarantees 4+len <= capacity), so the recompute breaks.
      q->head = 0;
      q->tail = 0;
      continue;
    }
    int rc = pthread_cond_timedwait(&q->not_full, &q->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&q->mutex);
      return -1;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&q->mutex);
  }
  uint64_t tail = q->tail % cap;
  uint64_t room_to_end = cap - tail;
  if (room_to_end < 4 + (uint64_t)len) {
    // not enough contiguous room: lay a wrap marker (if >= 4 bytes) and
    // restart at 0. `used` accounts the skipped bytes.
    if (room_to_end >= 4) {
      uint32_t marker = kWrapMarker;
      std::memcpy(h->data + tail, &marker, 4);
    }
    q->tail += room_to_end;
    q->used += room_to_end;
    tail = 0;
  }
  std::memcpy(h->data + tail, &len, 4);
  std::memcpy(h->data + tail + 4, buf, len);
  q->tail += 4 + len;
  q->used += 4 + len;
  pthread_cond_signal(&q->not_empty);
  pthread_mutex_unlock(&q->mutex);
  return 0;
}

// Pop one message into buf. Returns payload length (>=0), -1 timeout,
// -2 closed-and-empty, -4 buffer too small (message left in place; required
// size written into *required_out if non-null).
int shmq_pop(void* hv, uint8_t* buf, uint32_t buflen, long timeout_ms,
             uint32_t* required_out) {
  Handle* h = (Handle*)hv;
  Header* q = h->hdr;
  timespec ts;
  timeout_to_abs(timeout_ms, &ts);
  if (robust_timedlock(&q->mutex, &ts) != 0) return -1;
  while (q->used == 0 && !q->closed) {
    int rc = pthread_cond_timedwait(&q->not_empty, &q->mutex, &ts);
    if (rc == ETIMEDOUT) {
      pthread_mutex_unlock(&q->mutex);
      return -1;
    }
    if (rc == EOWNERDEAD) pthread_mutex_consistent(&q->mutex);
  }
  if (q->used == 0 && q->closed) {
    pthread_mutex_unlock(&q->mutex);
    return -2;
  }
  uint32_t cap = q->capacity;
  uint64_t head = q->head % cap;
  uint64_t room_to_end = cap - head;
  uint32_t len;
  if (room_to_end < 4) {
    // writer wrapped without room for a marker
    q->head += room_to_end;
    q->used -= room_to_end;
    head = 0;
  } else {
    std::memcpy(&len, h->data + head, 4);
    if (len == kWrapMarker) {
      q->head += room_to_end;
      q->used -= room_to_end;
      head = 0;
    }
  }
  std::memcpy(&len, h->data + head, 4);
  if (len > buflen) {
    if (required_out) *required_out = len;
    pthread_mutex_unlock(&q->mutex);
    return -4;
  }
  std::memcpy(buf, h->data + head + 4, len);
  q->head += 4 + len;
  q->used -= 4 + len;
  pthread_cond_signal(&q->not_full);
  pthread_mutex_unlock(&q->mutex);
  return (int)len;
}

// Number of queued bytes (diagnostics).
uint64_t shmq_used(void* hv) {
  Handle* h = (Handle*)hv;
  if (robust_lock(&h->hdr->mutex) != 0) return 0;
  uint64_t u = h->hdr->used;
  pthread_mutex_unlock(&h->hdr->mutex);
  return u;
}

// Mark closed: pending/future pops drain then return -2; pushes return -2.
void shmq_close(void* hv) {
  Handle* h = (Handle*)hv;
  if (robust_lock(&h->hdr->mutex) == 0) {
    h->hdr->closed = 1;
    pthread_cond_broadcast(&h->hdr->not_empty);
    pthread_cond_broadcast(&h->hdr->not_full);
    pthread_mutex_unlock(&h->hdr->mutex);
  }
}

// Unmap; owner also unlinks the shm name.
void shmq_destroy(void* hv) {
  Handle* h = (Handle*)hv;
  int owner = h->owner;
  char name[256];
  std::memcpy(name, h->name, sizeof(name));
  munmap((void*)h->hdr, h->map_size);
  if (owner) shm_unlink(name);
  delete h;
}

}  // extern "C"
