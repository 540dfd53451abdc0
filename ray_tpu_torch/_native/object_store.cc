// Native shared-memory object store: the plasma equivalent
// (reference: src/ray/object_manager/plasma/store.h, object_lifecycle_manager.h,
// plasma_allocator.h, eviction_policy.h), redesigned for the host-granular
// TPU runtime:
//
// - One mmap'd arena per host backed by memfd (sealed host-object bytes).
//   The arena is MAP_SHARED so future helper processes can map the same fd;
//   in the single-owner-process runtime, workers are threads and read the
//   buffers zero-copy through pointers handed across the C ABI.
// - Boundary-coalescing free-list allocator (dlmalloc.cc's role, simplified:
//   first-fit over an ordered free map with neighbor coalescing on free).
// - LRU eviction over sealed, unpinned objects (eviction_policy.h LRUCache):
//   the caller asks for candidates, spills them (local_object_manager.h:99
//   SpillObjects is the Python side), then deletes.
// - create -> write -> seal lifecycle with get() blocking handled in Python
//   (the store itself is non-blocking; CreateRequestQueue backpressure is
//   expressed as the -NOSPACE error code the caller turns into spilling).
//
// Host-sharing (this round): the arena owner can serve the store over a
// Unix domain socket (``nps_serve``). On connect the memfd is passed via
// SCM_RIGHTS and the client (``npc_*``) maps the SAME pages — a same-host
// get is a pointer into shared memory, not a TCP round-trip (reference:
// plasma's store socket + MaybeMmap fd passing, plasma/client.cc).
// Per-connection pin counts are rolled back on disconnect so a crashed
// client cannot pin objects forever.
//
// C ABI only — bound from Python via ctypes (no pybind11 in the image).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <set>
#include <thread>
#include <unordered_map>
#include <vector>

#include <sys/mman.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/un.h>
#include <unistd.h>

#ifdef __linux__
#include <sys/syscall.h>
#endif

namespace {

struct IdKey {
  uint8_t bytes[16];
  bool operator==(const IdKey& o) const {
    return std::memcmp(bytes, o.bytes, 16) == 0;
  }
};

struct IdHash {
  size_t operator()(const IdKey& k) const {
    uint64_t h;
    std::memcpy(&h, k.bytes, 8);
    uint64_t l;
    std::memcpy(&l, k.bytes + 8, 8);
    return static_cast<size_t>(h ^ (l * 0x9e3779b97f4a7c15ULL));
  }
};

struct Entry {
  uint64_t offset = 0;
  uint64_t size = 0;
  int64_t pin_count = 0;
  uint64_t lru_tick = 0;
  bool sealed = false;
};

class Store {
 public:
  explicit Store(uint64_t capacity) : capacity_(capacity) {
#ifdef __linux__
    fd_ = static_cast<int>(syscall(SYS_memfd_create, "ray_tpu_plasma", 0));
#else
    fd_ = -1;
#endif
    if (fd_ >= 0 && ftruncate(fd_, static_cast<off_t>(capacity)) == 0) {
      base_ = static_cast<uint8_t*>(mmap(nullptr, capacity,
                                         PROT_READ | PROT_WRITE, MAP_SHARED,
                                         fd_, 0));
      if (base_ != MAP_FAILED) shared_backed_ = true;
    }
    if (base_ == MAP_FAILED || base_ == nullptr) {
      // Fallback: anonymous private mapping (no cross-process sharing).
      base_ = static_cast<uint8_t*>(mmap(nullptr, capacity,
                                         PROT_READ | PROT_WRITE,
                                         MAP_PRIVATE | MAP_ANONYMOUS, -1, 0));
    }
    free_by_offset_[0] = capacity;
  }

  // True only when the live mapping is the memfd-backed MAP_SHARED one —
  // serving a private fallback mapping would SCM_RIGHTS-pass an fd whose
  // pages are NOT the ones the owner writes.
  bool SharedBacked() const { return shared_backed_; }

  ~Store() {
    if (base_ != nullptr && base_ != MAP_FAILED) munmap(base_, capacity_);
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return base_ != nullptr && base_ != MAP_FAILED; }

  int CreateObject(const IdKey& id, uint64_t size, uint8_t** out) {
    std::lock_guard<std::mutex> g(mu_);
    if (objects_.count(id)) return -1;
    uint64_t aligned = Align(size == 0 ? 1 : size);
    uint64_t offset;
    if (!Allocate(aligned, &offset)) return -2;
    Entry e;
    e.offset = offset;
    e.size = size;
    e.pin_count = 1;  // pinned until sealed
    e.lru_tick = ++tick_;
    objects_[id] = e;
    used_ += aligned;
    alloc_sizes_[offset] = aligned;
    *out = base_ + offset;
    return 0;
  }

  int Seal(const IdKey& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    if (!it->second.sealed) {
      it->second.sealed = true;
      it->second.pin_count -= 1;
    }
    return 0;
  }

  int Get(const IdKey& id, uint8_t** out, uint64_t* out_size, int pin) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end() || !it->second.sealed) return -1;
    it->second.lru_tick = ++tick_;
    if (pin) it->second.pin_count += 1;
    *out = base_ + it->second.offset;
    *out_size = it->second.size;
    return 0;
  }

  int Unpin(const IdKey& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    if (it->second.pin_count > 0) it->second.pin_count -= 1;
    return 0;
  }

  int Delete(const IdKey& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    if (it->second.pin_count > 0) return -3;  // in use
    Free(it->second.offset);
    objects_.erase(it);
    return 0;
  }

  int Contains(const IdKey& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    return it != objects_.end() && it->second.sealed ? 1 : 0;
  }

  // LRU candidates (sealed, unpinned) totalling at least nbytes of arena.
  uint64_t EvictCandidates(uint64_t nbytes, uint8_t* out_ids, uint64_t max) {
    std::lock_guard<std::mutex> g(mu_);
    std::map<uint64_t, const IdKey*> by_tick;
    for (auto& kv : objects_) {
      if (kv.second.sealed && kv.second.pin_count == 0)
        by_tick[kv.second.lru_tick] = &kv.first;
    }
    uint64_t freed = 0, n = 0;
    for (auto& kv : by_tick) {
      if (freed >= nbytes || n >= max) break;
      const Entry& e = objects_[*kv.second];
      auto it = alloc_sizes_.find(e.offset);
      freed += it != alloc_sizes_.end() ? it->second : e.size;
      std::memcpy(out_ids + n * 16, kv.second->bytes, 16);
      n += 1;
    }
    return freed >= nbytes ? n : (n > 0 ? n : 0);
  }

  void Stats(uint64_t* used, uint64_t* capacity, uint64_t* count) {
    std::lock_guard<std::mutex> g(mu_);
    *used = used_;
    *capacity = capacity_;
    *count = objects_.size();
  }

  // Free an unsealed (aborted) object regardless of its create-pin — the
  // disconnect path for a client that died between CREATE and SEAL.
  int Abort(const IdKey& id) {
    std::lock_guard<std::mutex> g(mu_);
    auto it = objects_.find(id);
    if (it == objects_.end()) return -1;
    if (it->second.sealed) return -2;
    Free(it->second.offset);
    objects_.erase(it);
    return 0;
  }

  int Fd() const { return fd_; }
  uint8_t* Base() const { return base_; }

 private:
  static uint64_t Align(uint64_t n) { return (n + 63) & ~uint64_t(63); }

  bool Allocate(uint64_t size, uint64_t* out_offset) {
    // First fit over the ordered free map.
    for (auto it = free_by_offset_.begin(); it != free_by_offset_.end();
         ++it) {
      if (it->second >= size) {
        *out_offset = it->first;
        uint64_t rem = it->second - size;
        uint64_t off = it->first;
        free_by_offset_.erase(it);
        if (rem > 0) free_by_offset_[off + size] = rem;
        return true;
      }
    }
    return false;
  }

  void Free(uint64_t offset) {
    auto sz = alloc_sizes_.find(offset);
    if (sz == alloc_sizes_.end()) return;
    uint64_t size = sz->second;
    alloc_sizes_.erase(sz);
    used_ -= size;
    auto next = free_by_offset_.lower_bound(offset);
    // Coalesce with following free block.
    if (next != free_by_offset_.end() && next->first == offset + size) {
      size += next->second;
      next = free_by_offset_.erase(next);
    }
    // Coalesce with preceding free block.
    if (next != free_by_offset_.begin()) {
      auto prev = std::prev(next);
      if (prev->first + prev->second == offset) {
        prev->second += size;
        return;
      }
    }
    free_by_offset_[offset] = size;
  }

  std::mutex mu_;
  uint64_t capacity_;
  uint64_t used_ = 0;
  uint64_t tick_ = 0;
  int fd_ = -1;
  bool shared_backed_ = false;
  uint8_t* base_ = nullptr;
  std::unordered_map<IdKey, Entry, IdHash> objects_;
  std::map<uint64_t, uint64_t> free_by_offset_;   // offset -> size
  std::unordered_map<uint64_t, uint64_t> alloc_sizes_;  // offset -> size
};

IdKey MakeKey(const uint8_t* id) {
  IdKey k;
  std::memcpy(k.bytes, id, 16);
  return k;
}

// ---------------------------------------------------------------------------
// UDS wire: request = op(1) + id(16) + arg(8) = 25 bytes;
//           reply   = rc(4) + a(8) + b(8)    = 20 bytes.
// On connect the server first sends capacity(8) with the memfd attached
// via SCM_RIGHTS.
// ---------------------------------------------------------------------------

enum Op : uint8_t {
  OP_CREATE = 1,   // arg=size   -> a=offset
  OP_SEAL = 2,
  OP_GET = 3,      //            -> a=offset, b=size (pins)
  OP_UNPIN = 4,
  OP_DELETE = 5,
  OP_CONTAINS = 6, //            -> rc 1/0
  OP_STATS = 7,    //            -> a=used, b=count
};

constexpr size_t kReqLen = 25;
constexpr size_t kRepLen = 20;

bool ReadExact(int fd, void* buf, size_t n) {
  uint8_t* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool WriteExact(int fd, const void* buf, size_t n) {
  const uint8_t* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool SendWithFd(int sock, const void* buf, size_t n, int fd) {
  struct msghdr msg = {};
  struct iovec iov = {const_cast<void*>(buf), n};
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  char ctrl[CMSG_SPACE(sizeof(int))] = {};
  msg.msg_control = ctrl;
  msg.msg_controllen = sizeof(ctrl);
  struct cmsghdr* cm = CMSG_FIRSTHDR(&msg);
  cm->cmsg_level = SOL_SOCKET;
  cm->cmsg_type = SCM_RIGHTS;
  cm->cmsg_len = CMSG_LEN(sizeof(int));
  std::memcpy(CMSG_DATA(cm), &fd, sizeof(int));
  return sendmsg(sock, &msg, 0) == static_cast<ssize_t>(n);
}

bool RecvWithFd(int sock, void* buf, size_t n, int* out_fd) {
  struct msghdr msg = {};
  struct iovec iov = {buf, n};
  msg.msg_iov = &iov;
  msg.msg_iovlen = 1;
  char ctrl[CMSG_SPACE(sizeof(int))] = {};
  msg.msg_control = ctrl;
  msg.msg_controllen = sizeof(ctrl);
  ssize_t r = recvmsg(sock, &msg, 0);
  if (r != static_cast<ssize_t>(n)) return false;
  *out_fd = -1;
  for (struct cmsghdr* cm = CMSG_FIRSTHDR(&msg); cm != nullptr;
       cm = CMSG_NXTHDR(&msg, cm)) {
    if (cm->cmsg_level == SOL_SOCKET && cm->cmsg_type == SCM_RIGHTS) {
      std::memcpy(out_fd, CMSG_DATA(cm), sizeof(int));
      break;
    }
  }
  return true;
}

class StoreServer {
 public:
  StoreServer(Store* store, const char* path) : store_(store) {
    listen_fd_ = socket(AF_UNIX, SOCK_STREAM, 0);
    if (listen_fd_ < 0) return;
    struct sockaddr_un addr = {};
    addr.sun_family = AF_UNIX;
    std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
    unlink(path);
    // Same-user only from the first instant: the arena socket hands out
    // the memfd mapping ALL host object memory, so the socket must never
    // be world-connectable, not even between bind() and a later chmod().
    mode_t prev_umask = umask(0077);
    int rc = bind(listen_fd_, reinterpret_cast<struct sockaddr*>(&addr),
                  sizeof(addr));
    umask(prev_umask);
    if (rc != 0 || listen(listen_fd_, 64) != 0) {
      close(listen_fd_);
      listen_fd_ = -1;
      return;
    }
    chmod(path, 0600);  // belt-and-braces on filesystems ignoring umask
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  bool ok() const { return listen_fd_ >= 0; }

  ~StoreServer() {
    stopping_ = true;
    if (listen_fd_ >= 0) {
      shutdown(listen_fd_, SHUT_RDWR);
      close(listen_fd_);
    }
    if (accept_thread_.joinable()) accept_thread_.join();
    // Kick every parked connection thread out of its blocking read, then
    // wait for the (detached) threads to drain. The wait is UNBOUNDED on
    // purpose: returning early would free this server (and soon the
    // Store) under a thread that still dereferences both — the fds are
    // shut down, so every blocking read/write fails immediately and the
    // only remaining work is mutex-bounded Store cleanup.
    {
      std::unique_lock<std::mutex> g(conns_mu_);
      for (int fd : conn_fds_) shutdown(fd, SHUT_RDWR);
      conns_cv_.wait(g, [this] { return conn_fds_.empty(); });
    }
  }

 private:
  void AcceptLoop() {
    while (!stopping_) {
      int fd = accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) {
        if (stopping_) return;
        continue;
      }
      {
        std::lock_guard<std::mutex> g(conns_mu_);
        conn_fds_.insert(fd);
      }
      // detached: finished connections self-reap (no per-connection
      // std::thread object accumulating for the server's lifetime). The
      // fd is closed here, under conns_mu_, so the destructor's
      // shutdown() can never hit a recycled descriptor.
      std::thread([this, fd] {
        Serve(fd);
        std::lock_guard<std::mutex> g(conns_mu_);
        close(fd);
        conn_fds_.erase(fd);
        conns_cv_.notify_all();
      }).detach();
    }
  }

  void Serve(int fd) {
    // handshake: capacity + the arena fd
    uint64_t cap, used, count;
    store_->Stats(&used, &cap, &count);
    if (!SendWithFd(fd, &cap, sizeof(cap), store_->Fd())) {
      return;  // wrapper closure closes the fd
    }
    // per-connection bookkeeping for crash rollback
    std::unordered_map<IdKey, int64_t, IdHash> pins;
    std::unordered_map<IdKey, bool, IdHash> unsealed;
    uint8_t req[kReqLen];
    while (!stopping_ && ReadExact(fd, req, kReqLen)) {
      uint8_t op = req[0];
      IdKey id = MakeKey(req + 1);
      uint64_t arg;
      std::memcpy(&arg, req + 17, 8);
      int32_t rc = -1;
      uint64_t a = 0, b = 0;
      switch (op) {
        case OP_CREATE: {
          uint8_t* ptr = nullptr;
          rc = store_->CreateObject(id, arg, &ptr);
          if (rc == 0) {
            a = static_cast<uint64_t>(ptr - store_->Base());
            unsealed[id] = true;
          }
          break;
        }
        case OP_SEAL:
          rc = store_->Seal(id);
          if (rc == 0) unsealed.erase(id);
          break;
        case OP_GET: {
          uint8_t* ptr = nullptr;
          rc = store_->Get(id, &ptr, &b, 1);
          if (rc == 0) {
            a = static_cast<uint64_t>(ptr - store_->Base());
            pins[id] += 1;
          }
          break;
        }
        case OP_UNPIN:
          rc = store_->Unpin(id);
          if (rc == 0 && pins.count(id) && --pins[id] <= 0) pins.erase(id);
          break;
        case OP_DELETE:
          rc = store_->Delete(id);
          break;
        case OP_CONTAINS:
          rc = store_->Contains(id);
          break;
        case OP_STATS: {
          uint64_t cap2;
          store_->Stats(&a, &cap2, &b);
          rc = 0;
          break;
        }
        default:
          rc = -100;
      }
      uint8_t rep[kRepLen];
      std::memcpy(rep, &rc, 4);
      std::memcpy(rep + 4, &a, 8);
      std::memcpy(rep + 12, &b, 8);
      if (!WriteExact(fd, rep, kRepLen)) break;
    }
    // rollback: release this connection's pins, abort half-created objects
    for (auto& kv : pins)
      for (int64_t i = 0; i < kv.second; ++i) store_->Unpin(kv.first);
    for (auto& kv : unsealed) store_->Abort(kv.first);
  }

  Store* store_;
  int listen_fd_ = -1;
  std::atomic<bool> stopping_{false};
  std::thread accept_thread_;
  std::mutex conns_mu_;
  std::condition_variable conns_cv_;
  std::set<int> conn_fds_;
};

std::mutex g_servers_mu;
std::unordered_map<void*, StoreServer*> g_servers;

// -- client ----------------------------------------------------------------

struct StoreClient {
  int sock = -1;
  int arena_fd = -1;
  uint8_t* base = nullptr;
  uint64_t capacity = 0;
  std::mutex mu;  // one outstanding request per connection
};

}  // namespace

extern "C" {

void* nps_create(uint64_t capacity) {
  Store* s = new Store(capacity);
  if (!s->ok()) {
    delete s;
    return nullptr;
  }
  return s;
}

void nps_destroy(void* s) {
  {
    std::lock_guard<std::mutex> g(g_servers_mu);
    auto it = g_servers.find(s);
    if (it != g_servers.end()) {
      delete it->second;
      g_servers.erase(it);
    }
  }
  delete static_cast<Store*>(s);
}

// Serve this store's arena over a Unix domain socket (idempotent per
// store). Clients receive the memfd via SCM_RIGHTS and map the same pages.
int nps_serve(void* s, const char* path) {
  std::lock_guard<std::mutex> g(g_servers_mu);
  if (g_servers.count(s)) return 0;
  if (!static_cast<Store*>(s)->SharedBacked()) return -2;  // private fallback
  StoreServer* srv = new StoreServer(static_cast<Store*>(s), path);
  if (!srv->ok()) {
    delete srv;
    return -1;
  }
  g_servers[s] = srv;
  return 0;
}

int nps_create_object(void* s, const uint8_t* id, uint64_t size,
                      uint8_t** out) {
  return static_cast<Store*>(s)->CreateObject(MakeKey(id), size, out);
}

int nps_seal(void* s, const uint8_t* id) {
  return static_cast<Store*>(s)->Seal(MakeKey(id));
}

int nps_get(void* s, const uint8_t* id, uint8_t** out, uint64_t* out_size,
            int pin) {
  return static_cast<Store*>(s)->Get(MakeKey(id), out, out_size, pin);
}

int nps_unpin(void* s, const uint8_t* id) {
  return static_cast<Store*>(s)->Unpin(MakeKey(id));
}

int nps_delete(void* s, const uint8_t* id) {
  return static_cast<Store*>(s)->Delete(MakeKey(id));
}

int nps_contains(void* s, const uint8_t* id) {
  return static_cast<Store*>(s)->Contains(MakeKey(id));
}

uint64_t nps_evict_candidates(void* s, uint64_t nbytes, uint8_t* out_ids,
                              uint64_t max) {
  return static_cast<Store*>(s)->EvictCandidates(nbytes, out_ids, max);
}

void nps_stats(void* s, uint64_t* used, uint64_t* capacity, uint64_t* count) {
  static_cast<Store*>(s)->Stats(used, capacity, count);
}

int nps_fd(void* s) { return static_cast<Store*>(s)->Fd(); }

// -- client side (same-host peer processes) --------------------------------

void* npc_connect(const char* path) {
  int sock = socket(AF_UNIX, SOCK_STREAM, 0);
  if (sock < 0) return nullptr;
  struct sockaddr_un addr = {};
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
  if (connect(sock, reinterpret_cast<struct sockaddr*>(&addr),
              sizeof(addr)) != 0) {
    close(sock);
    return nullptr;
  }
  uint64_t capacity = 0;
  int fd = -1;
  if (!RecvWithFd(sock, &capacity, sizeof(capacity), &fd) || fd < 0) {
    close(sock);
    return nullptr;
  }
  uint8_t* base = static_cast<uint8_t*>(
      mmap(nullptr, capacity, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
  if (base == MAP_FAILED) {
    close(fd);
    close(sock);
    return nullptr;
  }
  StoreClient* c = new StoreClient();
  c->sock = sock;
  c->arena_fd = fd;
  c->base = base;
  c->capacity = capacity;
  return c;
}

void npc_close(void* h) {
  StoreClient* c = static_cast<StoreClient*>(h);
  if (c == nullptr) return;
  if (c->base != nullptr) munmap(c->base, c->capacity);
  if (c->arena_fd >= 0) close(c->arena_fd);
  if (c->sock >= 0) close(c->sock);
  delete c;
}

// Close the connection + fd but KEEP the mapping: zero-copy values handed
// out earlier reference these pages; unmapping under them would turn a
// post-shutdown read into a SIGSEGV. The pages are reclaimed at process
// exit (or when the last memfd reference drops).
void npc_detach(void* h) {
  StoreClient* c = static_cast<StoreClient*>(h);
  if (c == nullptr) return;
  if (c->arena_fd >= 0) close(c->arena_fd);
  if (c->sock >= 0) close(c->sock);
  delete c;
}

uint64_t npc_capacity(void* h) {
  return static_cast<StoreClient*>(h)->capacity;
}

namespace {
int ClientCall(StoreClient* c, uint8_t op, const uint8_t* id, uint64_t arg,
               uint64_t* a, uint64_t* b) {
  std::lock_guard<std::mutex> g(c->mu);
  uint8_t req[kReqLen];
  req[0] = op;
  std::memcpy(req + 1, id, 16);
  std::memcpy(req + 17, &arg, 8);
  if (!WriteExact(c->sock, req, kReqLen)) return -101;
  uint8_t rep[kRepLen];
  if (!ReadExact(c->sock, rep, kRepLen)) return -101;
  int32_t rc;
  std::memcpy(&rc, rep, 4);
  if (a != nullptr) std::memcpy(a, rep + 4, 8);
  if (b != nullptr) std::memcpy(b, rep + 12, 8);
  return rc;
}
}  // namespace

// CREATE: on success *out points into the SHARED mapping — write payload
// bytes there, then npc_seal.
int npc_create_object(void* h, const uint8_t* id, uint64_t size,
                      uint8_t** out) {
  StoreClient* c = static_cast<StoreClient*>(h);
  uint64_t off = 0;
  int rc = ClientCall(c, OP_CREATE, id, size, &off, nullptr);
  if (rc == 0) *out = c->base + off;
  return rc;
}

int npc_seal(void* h, const uint8_t* id) {
  return ClientCall(static_cast<StoreClient*>(h), OP_SEAL, id, 0, nullptr,
                    nullptr);
}

int npc_get(void* h, const uint8_t* id, uint8_t** out, uint64_t* out_size,
            int pin) {
  (void)pin;  // server GET always pins; npc_unpin releases
  StoreClient* c = static_cast<StoreClient*>(h);
  uint64_t off = 0, size = 0;
  int rc = ClientCall(c, OP_GET, id, 0, &off, &size);
  if (rc == 0) {
    *out = c->base + off;
    *out_size = size;
  }
  return rc;
}

int npc_unpin(void* h, const uint8_t* id) {
  return ClientCall(static_cast<StoreClient*>(h), OP_UNPIN, id, 0, nullptr,
                    nullptr);
}

int npc_delete(void* h, const uint8_t* id) {
  return ClientCall(static_cast<StoreClient*>(h), OP_DELETE, id, 0, nullptr,
                    nullptr);
}

int npc_contains(void* h, const uint8_t* id) {
  return ClientCall(static_cast<StoreClient*>(h), OP_CONTAINS, id, 0,
                    nullptr, nullptr);
}

void npc_stats(void* h, uint64_t* used, uint64_t* capacity,
               uint64_t* count) {
  StoreClient* c = static_cast<StoreClient*>(h);
  ClientCall(c, OP_STATS, reinterpret_cast<const uint8_t*>(
                              "\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0\0"),
             0, used, count);
  *capacity = c->capacity;
}

}  // extern "C"
