// Plasma-style shared-memory arena store.
//
// TPU-native equivalent of the reference's plasma core (src/ray/object_manager/
// plasma/store.h:55, dlmalloc.cc over mmap, object_lifecycle_manager.h):
// one shm segment per store, a first-fit free-list allocator with boundary
// coalescing, and an object index (id -> offset/size/sealed).  The head
// process owns allocation; readers in any process mmap the same segment
// (/dev/shm/<name>) and take zero-copy views at the returned offsets.
//
// Exposed as a C ABI for ctypes (the image has no pybind11).  All exported
// functions are thread-safe via a per-store mutex.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

constexpr size_t kAlign = 64;  // cache-line alignment for numpy views

inline size_t align_up(size_t n) { return (n + kAlign - 1) & ~(kAlign - 1); }

struct ObjectEntry {
  size_t offset;
  size_t size;
  bool sealed;
  std::string metadata;
};

struct Store {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t capacity = 0;
  std::string name;
  std::mutex mu;
  // Free list: offset -> size (ordered, for coalescing).
  std::map<size_t, size_t> free_by_offset;
  std::unordered_map<std::string, ObjectEntry> objects;
  std::atomic<size_t> used{0};

  ~Store() {
    if (base) munmap(base, capacity);
    if (fd >= 0) close(fd);
    if (!name.empty()) shm_unlink(name.c_str());
  }

  int64_t allocate(size_t size) {
    size = align_up(size ? size : 1);
    // First fit.
    for (auto it = free_by_offset.begin(); it != free_by_offset.end(); ++it) {
      if (it->second >= size) {
        size_t off = it->first;
        size_t remaining = it->second - size;
        free_by_offset.erase(it);
        if (remaining > 0) free_by_offset[off + size] = remaining;
        used += size;
        return static_cast<int64_t>(off);
      }
    }
    return -1;
  }

  void release(size_t offset, size_t size) {
    size = align_up(size ? size : 1);
    used -= size;
    auto next = free_by_offset.lower_bound(offset);
    // Coalesce with previous block.
    if (next != free_by_offset.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == offset) {
        offset = prev->first;
        size += prev->second;
        free_by_offset.erase(prev);
      }
    }
    // Coalesce with next block.
    if (next != free_by_offset.end() && offset + size == next->first) {
      size += next->second;
      free_by_offset.erase(next);
    }
    free_by_offset[offset] = size;
  }
};

std::string id_key(const uint8_t* id, int id_len) {
  return std::string(reinterpret_cast<const char*>(id), id_len);
}

}  // namespace

extern "C" {

// Returns an opaque handle (owner side creates the segment).
void* rtpu_store_create(const char* name, uint64_t capacity) {
  auto* s = new Store();
  s->name = name;
  shm_unlink(name);  // stale segment from a crashed run
  s->fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (s->fd < 0) { delete s; return nullptr; }
  if (ftruncate(s->fd, static_cast<off_t>(capacity)) != 0) {
    delete s; return nullptr;
  }
  s->base = static_cast<uint8_t*>(mmap(nullptr, capacity,
                                       PROT_READ | PROT_WRITE, MAP_SHARED,
                                       s->fd, 0));
  if (s->base == MAP_FAILED) { s->base = nullptr; delete s; return nullptr; }
  s->capacity = capacity;
  s->free_by_offset[0] = capacity;
  return s;
}

void rtpu_store_destroy(void* handle) {
  delete static_cast<Store*>(handle);
}

// Allocate space for an object; returns offset or -1 (full / exists).
int64_t rtpu_store_allocate(void* handle, const uint8_t* id, int id_len,
                            uint64_t size) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  auto key = id_key(id, id_len);
  if (s->objects.count(key)) return -1;
  int64_t off = s->allocate(size);
  if (off < 0) return -1;
  s->objects[key] = ObjectEntry{static_cast<size_t>(off), size, false, {}};
  return off;
}

int rtpu_store_seal(void* handle, const uint8_t* id, int id_len,
                    const uint8_t* meta, int meta_len) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->objects.find(id_key(id, id_len));
  if (it == s->objects.end()) return -1;
  it->second.metadata.assign(reinterpret_cast<const char*>(meta), meta_len);
  it->second.sealed = true;
  return 0;
}

// Lookup: returns offset or -1; fills size and metadata length.
int64_t rtpu_store_get(void* handle, const uint8_t* id, int id_len,
                       uint64_t* size_out, int* meta_len_out) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->objects.find(id_key(id, id_len));
  if (it == s->objects.end() || !it->second.sealed) return -1;
  *size_out = it->second.size;
  *meta_len_out = static_cast<int>(it->second.metadata.size());
  return static_cast<int64_t>(it->second.offset);
}

int rtpu_store_get_meta(void* handle, const uint8_t* id, int id_len,
                        uint8_t* meta_buf, int meta_buf_len) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->objects.find(id_key(id, id_len));
  if (it == s->objects.end()) return -1;
  int n = static_cast<int>(it->second.metadata.size());
  if (n > meta_buf_len) return -1;
  std::memcpy(meta_buf, it->second.metadata.data(), n);
  return n;
}

int rtpu_store_delete(void* handle, const uint8_t* id, int id_len) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  auto it = s->objects.find(id_key(id, id_len));
  if (it == s->objects.end()) return -1;
  s->release(it->second.offset, it->second.size);
  s->objects.erase(it);
  return 0;
}

uint64_t rtpu_store_used(void* handle) {
  return static_cast<Store*>(handle)->used.load();
}

uint64_t rtpu_store_num_objects(void* handle) {
  auto* s = static_cast<Store*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  return s->objects.size();
}

}  // extern "C"
