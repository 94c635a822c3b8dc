// object_arena — shared-memory arena allocator for the ray_tpu object
// store.
//
// Equivalent role to the reference's plasma allocator
// (src/ray/object_manager/plasma/plasma_allocator.cc: dlmalloc over one
// mmap'd shm region) rebuilt from scratch: one file-backed mapping in
// /dev/shm per node, a best-fit free list with boundary-tag coalescing,
// 64-byte-aligned blocks. The node store process is the only allocator;
// reader processes attach the same file read-only and use offsets, so a
// process touching N objects costs one mmap, not N.
//
// C ABI (used from Python via ctypes):
//   arena_create(path, capacity)        -> handle (owner; truncates)
//   arena_attach(path)                  -> handle (reader)
//   arena_alloc(handle, size)           -> offset, or -1 if full
//   arena_free(handle, offset)          -> 0 ok / -1 bad offset
//   arena_base(handle)                  -> mapped base pointer
//   arena_capacity(handle)              -> usable bytes
//   arena_used(handle)                  -> allocated bytes (incl. headers)
//   arena_num_blocks(handle)            -> live allocation count
//   arena_close(handle, unlink)         -> unmap (+ unlink file)

#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <mutex>
#include <new>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x52545055'41524e41ULL;  // "RTPUARNA"
constexpr uint64_t kAlign = 64;
constexpr uint64_t kHeaderSize = 64;   // block header, one cache line
constexpr uint64_t kUsedBit = 1ULL << 63;

inline uint64_t align_up(uint64_t v, uint64_t a) {
  return (v + a - 1) & ~(a - 1);
}

// Block layout: [BlockHeader | payload ...]; blocks are physically
// contiguous, walked by size for coalescing. size field includes the
// header. prev_size lets us find the previous block for merging.
// refcnt counts mapper references: any attached process increments it
// while it hands out zero-copy views into the payload, so the owner
// can tell "no live reader" apart from "freed but maybe still aliased"
// (plasma analogue: the per-object client refcount in the store's
// object table). Updated with atomic builtins — the field lives in
// shared memory and is touched from multiple processes.
struct BlockHeader {
  uint64_t size_flags;   // size | kUsedBit
  uint64_t prev_size;    // size of physically-previous block (0 = first)
  uint64_t payload;      // requested payload size
  uint64_t refcnt;       // live mapper references (cross-process atomic)
  uint64_t pad[4];
  uint64_t size() const { return size_flags & ~kUsedBit; }
  bool used() const { return size_flags & kUsedBit; }
};
static_assert(sizeof(BlockHeader) == kHeaderSize, "header must be 64B");

// Arena file layout: [ArenaSuper | blocks ...]
struct ArenaSuper {
  uint64_t magic;
  uint64_t capacity;      // total bytes of block space
  uint64_t used;          // bytes allocated (incl. headers)
  uint64_t num_blocks;    // live allocations
};

struct Arena {
  ArenaSuper* super = nullptr;
  uint8_t* base = nullptr;       // start of block space
  uint64_t capacity = 0;
  bool owner = false;
  char path[4096] = {0};
  std::mutex mu;                 // allocator is single-process (owner)
};

BlockHeader* block_at(Arena* a, uint64_t off) {
  return reinterpret_cast<BlockHeader*>(a->base + off);
}

}  // namespace

extern "C" {

void* arena_create(const char* path, uint64_t capacity) {
  capacity = align_up(capacity, kAlign);
  int fd = ::open(path, O_RDWR | O_CREAT | O_TRUNC, 0600);
  if (fd < 0) return nullptr;
  uint64_t total = sizeof(ArenaSuper) + capacity;
  total = align_up(total, 4096);
  if (::ftruncate(fd, (off_t)total) != 0) {
    ::close(fd);
    return nullptr;
  }
  void* mem = ::mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED,
                     fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;

  Arena* a = new (std::nothrow) Arena();
  if (!a) { ::munmap(mem, total); return nullptr; }
  a->super = static_cast<ArenaSuper*>(mem);
  a->base = reinterpret_cast<uint8_t*>(mem) + sizeof(ArenaSuper);
  a->capacity = capacity;
  a->owner = true;
  std::strncpy(a->path, path, sizeof(a->path) - 1);

  a->super->magic = kMagic;
  a->super->capacity = capacity;
  a->super->used = 0;
  a->super->num_blocks = 0;
  // one giant free block
  BlockHeader* first = block_at(a, 0);
  first->size_flags = capacity;
  first->prev_size = 0;
  first->payload = 0;
  return a;
}

void* arena_attach(const char* path) {
  int fd = ::open(path, O_RDWR);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
  void* mem = ::mmap(nullptr, (size_t)st.st_size, PROT_READ | PROT_WRITE,
                     MAP_SHARED, fd, 0);
  ::close(fd);
  if (mem == MAP_FAILED) return nullptr;
  ArenaSuper* super = static_cast<ArenaSuper*>(mem);
  if (super->magic != kMagic) {
    ::munmap(mem, (size_t)st.st_size);
    return nullptr;
  }
  Arena* a = new (std::nothrow) Arena();
  if (!a) { ::munmap(mem, (size_t)st.st_size); return nullptr; }
  a->super = super;
  a->base = reinterpret_cast<uint8_t*>(mem) + sizeof(ArenaSuper);
  a->capacity = super->capacity;
  a->owner = false;
  std::strncpy(a->path, path, sizeof(a->path) - 1);
  return a;
}

// Best-fit scan over the free list (physical walk; blocks are few
// relative to bytes, and the walk is O(blocks)).
int64_t arena_alloc(void* handle, uint64_t payload) {
  Arena* a = static_cast<Arena*>(handle);
  if (!a || !a->owner) return -1;
  std::lock_guard<std::mutex> g(a->mu);
  uint64_t need = align_up(payload, kAlign) + kHeaderSize;
  uint64_t best_off = UINT64_MAX;
  uint64_t best_size = UINT64_MAX;
  uint64_t off = 0;
  while (off < a->capacity) {
    BlockHeader* b = block_at(a, off);
    uint64_t bsize = b->size();
    if (bsize == 0) break;  // corrupt; stop
    if (!b->used() && bsize >= need && bsize < best_size) {
      best_off = off;
      best_size = bsize;
      if (bsize == need) break;
    }
    off += bsize;
  }
  if (best_off == UINT64_MAX) return -1;

  BlockHeader* b = block_at(a, best_off);
  uint64_t remainder = best_size - need;
  if (remainder >= kHeaderSize + kAlign) {
    // split: tail stays free
    b->size_flags = need | kUsedBit;
    BlockHeader* tail = block_at(a, best_off + need);
    tail->size_flags = remainder;
    tail->prev_size = need;
    tail->payload = 0;
    uint64_t after_off = best_off + best_size;
    if (after_off < a->capacity)
      block_at(a, after_off)->prev_size = remainder;
  } else {
    need = best_size;
    b->size_flags = need | kUsedBit;
  }
  b->payload = payload;
  __atomic_store_n(&b->refcnt, 0, __ATOMIC_RELAXED);
  a->super->used += need;
  a->super->num_blocks += 1;
  return (int64_t)(best_off + kHeaderSize);
}

namespace {
// Shared validation for the refcount entry points: any attached process
// (owner or reader) may call them, so only offset sanity is checked.
BlockHeader* ref_block(void* handle, int64_t payload_off) {
  Arena* a = static_cast<Arena*>(handle);
  if (!a || payload_off < (int64_t)kHeaderSize) return nullptr;
  uint64_t off = (uint64_t)payload_off - kHeaderSize;
  if (off >= a->capacity) return nullptr;
  return block_at(a, off);
}
}  // namespace

int arena_free(void* handle, int64_t payload_off) {
  Arena* a = static_cast<Arena*>(handle);
  if (!a || !a->owner) return -1;
  std::lock_guard<std::mutex> g(a->mu);
  if (payload_off < (int64_t)kHeaderSize) return -1;
  uint64_t off = (uint64_t)payload_off - kHeaderSize;
  if (off >= a->capacity) return -1;
  BlockHeader* b = block_at(a, off);
  if (!b->used()) return -1;
  uint64_t size = b->size();
  a->super->used -= size;
  a->super->num_blocks -= 1;
  b->size_flags = size;
  b->payload = 0;

  // coalesce with next
  uint64_t next_off = off + size;
  if (next_off < a->capacity) {
    BlockHeader* next = block_at(a, next_off);
    if (!next->used()) {
      size += next->size();
      b->size_flags = size;
    }
  }
  // coalesce with prev
  if (b->prev_size) {
    BlockHeader* prev = block_at(a, off - b->prev_size);
    if (!prev->used()) {
      off -= b->prev_size;
      size += prev->size();
      prev->size_flags = size;
      b = prev;
    }
  }
  // fix prev_size of the block after the merged region
  uint64_t after_off = off + size;
  if (after_off < a->capacity)
    block_at(a, after_off)->prev_size = size;
  return 0;
}

int64_t arena_incref(void* handle, int64_t payload_off) {
  BlockHeader* b = ref_block(handle, payload_off);
  if (!b || !b->used()) return -1;
  return (int64_t)(__atomic_add_fetch(&b->refcnt, 1, __ATOMIC_ACQ_REL));
}

int64_t arena_decref(void* handle, int64_t payload_off) {
  BlockHeader* b = ref_block(handle, payload_off);
  if (!b) return -1;
  // decref may land after the owner already freed the block (reader
  // dropped its last view late); the count still balances because free
  // doesn't recycle header bytes until realloc, and alloc re-zeroes it.
  uint64_t prev = __atomic_fetch_sub(&b->refcnt, 1, __ATOMIC_ACQ_REL);
  if (prev == 0) {  // underflow guard: restore and report
    __atomic_store_n(&b->refcnt, 0, __ATOMIC_RELAXED);
    return -1;
  }
  return (int64_t)(prev - 1);
}

int64_t arena_refcount(void* handle, int64_t payload_off) {
  BlockHeader* b = ref_block(handle, payload_off);
  if (!b) return -1;
  return (int64_t)__atomic_load_n(&b->refcnt, __ATOMIC_ACQUIRE);
}

uint8_t* arena_base(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  return a ? a->base : nullptr;
}

uint64_t arena_capacity(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  return a ? a->capacity : 0;
}

uint64_t arena_used(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  return a ? a->super->used : 0;
}

uint64_t arena_num_blocks(void* handle) {
  Arena* a = static_cast<Arena*>(handle);
  return a ? a->super->num_blocks : 0;
}

void arena_close(void* handle, int unlink_file) {
  Arena* a = static_cast<Arena*>(handle);
  if (!a) return;
  uint64_t total = align_up(sizeof(ArenaSuper) + a->capacity, 4096);
  ::munmap(a->super, total);
  if (unlink_file && a->owner) ::unlink(a->path);
  delete a;
}

}  // extern "C"
