// C++ worker/driver API for the ray_tpu cluster.
//
// The role of the reference's C++ worker API (src/ray/core_worker C++
// bindings + cpp/ frontend), shaped for this runtime's cross-language
// contract: a C++ program joins an existing cluster as a DRIVER — it
// discovers daemons through the state service, submits tasks that invoke
// Python functions registered by name (register_named_function), passes
// arguments as JSON, and receives JSON results inline in the task reply
// (reply-as-completion, so no C++ unpickler is needed anywhere).
//
// Speaks the native wire protocol: 4-byte big-endian frame length +
// raytpu.Envelope, with the AUTH first-frame handshake. The messages go
// through pbwire.h, a proto3 codec written by hand for the few messages
// used here, so g++ alone builds this file: no protoc, no libprotobuf (see
// build.py build_cpp_worker_demo).
//
// The library surface (RayTpuClient) is header-free on purpose: this file
// compiles either into the demo binary (RAYTPU_CPP_DEMO_MAIN) or can be
// #included / linked into a user's C++ program.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <chrono>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <random>
#include <stdexcept>
#include <string>
#include <vector>

#include "pbwire.h"

namespace raytpu_cpp {

class Connection {
 public:
  Connection(const std::string& host, int port, const std::string& token) {
    // getaddrinfo: cluster addresses are routinely hostnames, not
    // numeric IPs (e.g. the autoscaler's --address=head:6379)
    struct addrinfo hints = {};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    struct addrinfo* res = nullptr;
    std::string port_s = std::to_string(port);
    if (getaddrinfo(host.c_str(), port_s.c_str(), &hints, &res) != 0 ||
        res == nullptr)
      throw std::runtime_error("cannot resolve " + host);
    int err = -1;
    for (struct addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
      fd_ = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd_ < 0) continue;
      if (connect(fd_, ai->ai_addr, ai->ai_addrlen) == 0) {
        err = 0;
        break;
      }
      close(fd_);
      fd_ = -1;
    }
    freeaddrinfo(res);
    if (err != 0 || fd_ < 0)
      throw std::runtime_error("connect to " + host + " failed");
    int one = 1;
    setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    if (!token.empty()) {
      pbwire::Envelope auth;
      auth.seq = 0;
      auth.method = pbwire::AUTH;
      auth.body = token;
      SendEnvelope(auth);
    }
  }

  ~Connection() {
    if (fd_ >= 0) close(fd_);
  }

  pbwire::Envelope Call(pbwire::Method method, const std::string& body) {
    pbwire::Envelope req;
    req.seq = ++seq_;
    req.method = method;
    req.body = body;
    SendEnvelope(req);
    // replies can interleave with pushes on this protocol; a plain driver
    // connection sees only its own replies (no subscriptions) — read
    // frames until our seq answers
    while (true) {
      pbwire::Envelope rep = ReadEnvelope();
      if (rep.seq == req.seq) {
        if (!rep.error.empty())
          throw std::runtime_error("rpc error: " + rep.error);
        return rep;
      }
    }
  }

 private:
  void SendEnvelope(const pbwire::Envelope& env) {
    std::string payload = env.Serialize();
    uint32_t len = htonl(static_cast<uint32_t>(payload.size()));
    std::string frame(reinterpret_cast<char*>(&len), 4);
    frame += payload;
    WriteExact(frame.data(), frame.size());
  }

  // Matches rpc.py MAX_FRAME: reject oversized declared lengths BEFORE
  // allocating, so a corrupt/malicious peer cannot drive huge allocations.
  static constexpr uint32_t kMaxFrame = 1u << 31;

  pbwire::Envelope ReadEnvelope() {
    uint8_t hdr[4];
    ReadExact(hdr, 4);
    uint32_t len = (uint32_t(hdr[0]) << 24) | (uint32_t(hdr[1]) << 16) |
                   (uint32_t(hdr[2]) << 8) | uint32_t(hdr[3]);
    if (len > kMaxFrame)
      throw std::runtime_error("frame exceeds MAX_FRAME");
    std::string buf(len, '\0');
    ReadExact(buf.data(), len);
    try {
      return pbwire::Envelope::Parse(buf);
    } catch (const pbwire::ParseError& e) {
      throw std::runtime_error(std::string("bad envelope frame: ") +
                               e.what());
    }
  }

  void WriteExact(const void* data, size_t n) {
    const char* p = static_cast<const char*>(data);
    while (n > 0) {
      ssize_t r = write(fd_, p, n);
      if (r <= 0) throw std::runtime_error("connection write failed");
      p += r;
      n -= static_cast<size_t>(r);
    }
  }

  void ReadExact(void* data, size_t n) {
    char* p = static_cast<char*>(data);
    while (n > 0) {
      ssize_t r = read(fd_, p, n);
      if (r <= 0) throw std::runtime_error("connection closed");
      p += r;
      n -= static_cast<size_t>(r);
    }
  }

  int fd_ = -1;
  uint64_t seq_ = 0;
};

struct HostPort {
  std::string host;
  int port;
};

inline HostPort SplitAddr(const std::string& addr) {
  auto pos = addr.rfind(':');
  if (pos == std::string::npos)
    throw std::runtime_error("address must be host:port: " + addr);
  return {addr.substr(0, pos), std::stoi(addr.substr(pos + 1))};
}

class TaskCaller;
class ActorCreator;

class RayTpuClient {
 public:
  RayTpuClient(const std::string& state_addr, const std::string& token)
      : token_(token), rng_(std::random_device{}()) {
    auto hp = SplitAddr(state_addr);
    state_ = std::make_unique<Connection>(hp.host, hp.port, token_);
    job_id_ = RandomBytes(4);
  }

  // Typed API entry points (defined after TaskCaller/ActorCreator).
  TaskCaller Task(const std::string& function_name);
  ActorCreator Actor(const std::string& registered_class);

  std::string RandomHex(size_t n) {
    static const char* hex = "0123456789abcdef";
    std::lock_guard<std::mutex> g(rng_mu_);
    std::string out;
    std::uniform_int_distribution<int> d(0, 15);
    for (size_t i = 0; i < n; ++i) out += hex[d(rng_)];
    return out;
  }

  // -- cluster introspection ------------------------------------------
  std::vector<pbwire::NodeInfo> ListNodes() {
    pbwire::Envelope rep = StateCall(pbwire::LIST_NODES, "");
    return pbwire::ListNodesReply::Parse(rep.body).nodes;
  }

  // -- KV (cross-language shared state) -------------------------------
  bool KvPut(const std::string& key, const std::string& value) {
    pbwire::KvPutRequest req;
    req.key = key;
    req.value = value;
    req.overwrite = true;
    return pbwire::KvPutReply::Parse(
               StateCall(pbwire::KV_PUT, req.Serialize()).body)
        .added;
  }

  std::string KvGet(const std::string& key) {
    pbwire::KvGetRequest req;
    req.key = key;
    auto kg = pbwire::KvGetReply::Parse(
        StateCall(pbwire::KV_GET, req.Serialize()).body);
    return kg.found ? kg.value : "";
  }

  // -- cross-language task submission ---------------------------------
  // Invoke a Python function registered via register_named_function with
  // JSON positional args; returns the JSON-encoded result. Throws on task
  // error (message from the daemon's language-neutral error_message).
  std::string SubmitTask(const std::string& function_name,
                         const std::string& args_json) {
    // One node-list fetch; prefer non-head daemons, fall back to any.
    // "spillback" is a routine scheduling reply (the daemon's resources
    // are momentarily busy), not a failure: rotate through candidate
    // daemons like the Python client does.
    auto nodes = ListNodes();
    std::vector<std::string> candidates;
    for (const auto& n : nodes)
      if (n.alive && !n.address.empty() && !n.is_head)
        candidates.push_back(n.address);
    for (const auto& n : nodes)
      if (n.alive && !n.address.empty() && n.is_head)
        candidates.push_back(n.address);
    if (candidates.empty())
      throw std::runtime_error("no alive daemons in the cluster");

    pbwire::TaskSpecMsg spec;
    std::string task_id = RandomBytes(16);
    spec.task_id = task_id;
    spec.job_id = job_id_;
    spec.function_name = function_name;
    spec.named_function = function_name;
    spec.args_json = args_json;
    spec.json_results = true;
    spec.num_returns = 1;
    // return id: task_id(16) + little-endian index 0 (ids.py ObjectID)
    std::string rid = task_id + std::string(4, '\0');
    spec.return_ids.push_back(rid);
    spec.resources.amounts["CPU"] = 1.0;
    spec.has_resources = true;
    std::string body = spec.Serialize();

    // time-based budget: rotate immediately within a round, sleep 100ms
    // after each fruitless full round, give up after ~10s wall clock
    // regardless of the candidate count
    const auto deadline =
        std::chrono::steady_clock::now() + std::chrono::seconds(10);
    for (size_t attempt = 0;
         std::chrono::steady_clock::now() < deadline; ++attempt) {
      const std::string& daemon_addr =
          candidates[attempt % candidates.size()];
      auto hp = SplitAddr(daemon_addr);
      Connection daemon(hp.host, hp.port, token_);
      pbwire::Envelope rep = daemon.Call(pbwire::PUSH_TASK, body);
      auto out = pbwire::PushTaskReply::Parse(rep.body);
      if (out.status == "spillback") {
        if ((attempt + 1) % candidates.size() == 0) usleep(100 * 1000);
        continue;
      }
      if (out.status != "ok")
        throw std::runtime_error("task not admitted: " + out.status);
      if (!out.error_message.empty())
        throw std::runtime_error("task failed: " + out.error_message);
      if (!out.inline_results.empty() && !out.inline_.empty() &&
          out.inline_[0])
        return out.inline_results[0];
      throw std::runtime_error("no inline result (json_results expected)");
    }
    throw std::runtime_error("cluster busy: task spilled back "
                             "repeatedly");
  }

 private:
  // The state connection is shared by every thread of the typed API
  // (ObjectRef futures submit concurrently): one call at a time.
  pbwire::Envelope StateCall(pbwire::Method m, const std::string& body) {
    std::lock_guard<std::mutex> g(state_mu_);
    return state_->Call(m, body);
  }

  std::string RandomBytes(size_t n) {
    std::lock_guard<std::mutex> g(rng_mu_);
    std::string out(n, '\0');
    std::uniform_int_distribution<int> d(0, 255);
    for (size_t i = 0; i < n; ++i)
      out[i] = static_cast<char>(d(rng_));
    return out;
  }

  std::string token_;
  std::string job_id_;
  std::unique_ptr<Connection> state_;
  std::mutex state_mu_;
  std::mutex rng_mu_;
  std::mt19937_64 rng_;
};

}  // namespace raytpu_cpp

// ---------------------------------------------------------------------------
// Typed task/actor API — the surface of the reference's C++ frontend
// (cpp/include/ray/api/task_caller.h:1, actor_creator.h:1,
// object_ref.h:1), on this runtime's cross-language contract:
//
//   raytpu_cpp::RayTpuClient client(addr, token);
//   auto ref = client.Task("py_fn").Remote<int64_t>(2, 3);   // non-blocking
//   int64_t five = ref.Get();                                // typed wait
//   auto counter = client.Actor("Counter").Remote(10);       // named class
//   int64_t v = counter.Call<int64_t>("add", 5).Get();
//   counter.Kill();
//
// Arguments are serialized with typed JSON encoders (no stringly-typed
// payload assembly in user code); results decode into the ObjectRef's
// type parameter. Execution stays on the Python daemons — the typed
// layer is the driver-side contract, matching the runtime's
// "Python defines, any language drives" model (worker.py
// register_named_actor_class).
// ---------------------------------------------------------------------------

#include <cmath>
#include <cstdio>
#include <future>
#include <limits>
#include <sstream>

namespace raytpu_cpp {

// ---- typed JSON encode ----------------------------------------------------
inline void JsonEncode(std::ostringstream& o, int64_t v) { o << v; }
inline void JsonEncode(std::ostringstream& o, int v) { o << v; }
inline void JsonEncode(std::ostringstream& o, double v) {
  if (!std::isfinite(v))
    throw std::runtime_error("JSON cannot carry inf/nan arguments");
  o.precision(std::numeric_limits<double>::max_digits10);
  o << v;
}
inline void JsonEncode(std::ostringstream& o, bool v) {
  o << (v ? "true" : "false");
}
inline void JsonEncode(std::ostringstream& o, const std::string& v) {
  o << '"';
  for (char c : v) {
    unsigned char u = static_cast<unsigned char>(c);
    switch (c) {
      case '"': o << "\\\""; break;
      case '\\': o << "\\\\"; break;
      case '\n': o << "\\n"; break;
      case '\t': o << "\\t"; break;
      case '\r': o << "\\r"; break;
      case '\b': o << "\\b"; break;
      case '\f': o << "\\f"; break;
      default:
        if (u < 0x20) {  // remaining C0 controls: strict JSON requires \u
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", u);
          o << buf;
        } else {
          o << c;  // UTF-8 bytes pass through verbatim
        }
    }
  }
  o << '"';
}
inline void JsonEncode(std::ostringstream& o, const char* v) {
  JsonEncode(o, std::string(v));
}
template <typename T>
inline void JsonEncode(std::ostringstream& o, const std::vector<T>& v) {
  o << '[';
  for (size_t i = 0; i < v.size(); ++i) {
    if (i) o << ", ";
    JsonEncode(o, v[i]);
  }
  o << ']';
}

inline void EncodeArgsInto(std::ostringstream&) {}
template <typename A, typename... Rest>
inline void EncodeArgsInto(std::ostringstream& o, A&& a, Rest&&... rest) {
  JsonEncode(o, std::forward<A>(a));
  if (sizeof...(rest)) o << ", ";
  EncodeArgsInto(o, std::forward<Rest>(rest)...);
}
template <typename... Args>
inline std::string EncodeArgs(Args&&... args) {
  std::ostringstream o;
  o << '[';
  EncodeArgsInto(o, std::forward<Args>(args)...);
  o << ']';
  return o.str();
}

// ---- typed JSON decode (scalars + flat arrays — the named-function
// result contract; nested structures stay strings for the caller) ---------
inline std::string JsonTrim(const std::string& s) {
  size_t a = s.find_first_not_of(" \t\n\r");
  size_t b = s.find_last_not_of(" \t\n\r");
  return a == std::string::npos ? "" : s.substr(a, b - a + 1);
}

template <typename T>
T JsonDecode(const std::string& json);

template <>
inline int64_t JsonDecode<int64_t>(const std::string& json) {
  return std::stoll(JsonTrim(json));
}
template <>
inline double JsonDecode<double>(const std::string& json) {
  return std::stod(JsonTrim(json));
}
template <>
inline bool JsonDecode<bool>(const std::string& json) {
  std::string t = JsonTrim(json);
  if (t == "true") return true;
  if (t == "false") return false;
  throw std::runtime_error("not a JSON bool: " + t);
}
template <>
inline std::string JsonDecode<std::string>(const std::string& json) {
  std::string t = JsonTrim(json);
  if (t.size() < 2 || t.front() != '"' || t.back() != '"')
    throw std::runtime_error("not a JSON string: " + t);
  std::string out;
  for (size_t i = 1; i + 1 < t.size(); ++i) {
    if (t[i] != '\\' || i + 2 >= t.size()) {
      out += t[i];
      continue;
    }
    char n = t[++i];
    switch (n) {
      case 'n': out += '\n'; break;
      case 't': out += '\t'; break;
      case 'r': out += '\r'; break;
      case 'b': out += '\b'; break;
      case 'f': out += '\f'; break;
      case '"': out += '"'; break;
      case '\\': out += '\\'; break;
      case '/': out += '/'; break;
      case 'u': {
        // \uXXXX (Python json.dumps default ensure_ascii escapes all
        // non-ASCII this way) -> UTF-8. Surrogate pairs for astral
        // planes are combined when both halves are present.
        if (i + 4 >= t.size())
          throw std::runtime_error("truncated \\u escape");
        unsigned cp = std::stoul(t.substr(i + 1, 4), nullptr, 16);
        i += 4;
        if (cp >= 0xD800 && cp <= 0xDBFF && i + 6 < t.size() &&
            t[i + 1] == '\\' && t[i + 2] == 'u') {
          unsigned lo = std::stoul(t.substr(i + 3, 4), nullptr, 16);
          if (lo >= 0xDC00 && lo <= 0xDFFF) {
            cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            i += 6;
          }
        }
        if (cp < 0x80) {
          out += static_cast<char>(cp);
        } else if (cp < 0x800) {
          out += static_cast<char>(0xC0 | (cp >> 6));
          out += static_cast<char>(0x80 | (cp & 0x3F));
        } else if (cp < 0x10000) {
          out += static_cast<char>(0xE0 | (cp >> 12));
          out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
          out += static_cast<char>(0x80 | (cp & 0x3F));
        } else {
          out += static_cast<char>(0xF0 | (cp >> 18));
          out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
          out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
          out += static_cast<char>(0x80 | (cp & 0x3F));
        }
        break;
      }
      default: out += n;
    }
  }
  return out;
}
template <>
inline std::vector<int64_t> JsonDecode<std::vector<int64_t>>(
    const std::string& json) {
  std::string t = JsonTrim(json);
  if (t.size() < 2 || t.front() != '[' || t.back() != ']')
    throw std::runtime_error("not a JSON array: " + t);
  std::vector<int64_t> out;
  std::stringstream ss(t.substr(1, t.size() - 2));
  std::string item;
  while (std::getline(ss, item, ','))
    if (!JsonTrim(item).empty()) out.push_back(std::stoll(JsonTrim(item)));
  return out;
}

// ---- ObjectRef<T> (object_ref.h role) ------------------------------------
template <typename T>
class ObjectRef {
 public:
  explicit ObjectRef(std::shared_future<std::string> json)
      : json_(std::move(json)) {}
  // Blocks for the task reply, decodes into T. Task errors rethrow here
  // (the future carries the submission thread's exception).
  T Get() const { return JsonDecode<T>(json_.get()); }
  // Raw JSON, for nested results the scalar decoders don't cover.
  std::string GetJson() const { return json_.get(); }

 private:
  std::shared_future<std::string> json_;
};

// ---- TaskCaller (task_caller.h role) -------------------------------------
class RayTpuClient;  // fwd

class TaskCaller {
 public:
  TaskCaller(RayTpuClient* client, std::string fn)
      : client_(client), fn_(std::move(fn)) {}
  // Non-blocking: submission runs on its own thread; the ObjectRef's
  // future resolves with the task's JSON result.
  template <typename R, typename... Args>
  ObjectRef<R> Remote(Args&&... args);

 private:
  RayTpuClient* client_;
  std::string fn_;
};

// ---- actors (actor_creator.h / actor_handle.h roles) ---------------------
class ActorHandle {
 public:
  ActorHandle(RayTpuClient* client, std::string name)
      : client_(client), name_(std::move(name)) {}
  const std::string& Name() const { return name_; }
  template <typename R, typename... Args>
  ObjectRef<R> Call(const std::string& method, Args&&... args);
  void Kill();

 private:
  RayTpuClient* client_;
  std::string name_;
};

class ActorCreator {
 public:
  ActorCreator(RayTpuClient* client, std::string cls)
      : client_(client), cls_(std::move(cls)) {}
  // Creates a NAMED actor from the Python-registered class; the handle
  // routes calls by that name from any connection.
  template <typename... Args>
  ActorHandle Remote(Args&&... args);

 private:
  RayTpuClient* client_;
  std::string cls_;
};

// ---- definitions (RayTpuClient is complete here) --------------------------
inline TaskCaller RayTpuClient::Task(const std::string& function_name) {
  return TaskCaller(this, function_name);
}
inline ActorCreator RayTpuClient::Actor(const std::string& cls) {
  return ActorCreator(this, cls);
}

template <typename R, typename... Args>
ObjectRef<R> TaskCaller::Remote(Args&&... args) {
  std::string args_json = EncodeArgs(std::forward<Args>(args)...);
  RayTpuClient* c = client_;
  std::string fn = fn_;
  return ObjectRef<R>(std::async(std::launch::async, [c, fn, args_json] {
                        return c->SubmitTask(fn, args_json);
                      }).share());
}

template <typename... Args>
ActorHandle ActorCreator::Remote(Args&&... args) {
  // Creation blocks until the daemon's reply: the returned handle must
  // be immediately callable (the name is registered at creation time).
  std::string name = cls_ + "-" + client_->RandomHex(12);
  client_->SubmitTask("__actor_new__::" + cls_,
                      EncodeArgs(name, std::forward<Args>(args)...));
  return ActorHandle(client_, name);
}

template <typename R, typename... Args>
ObjectRef<R> ActorHandle::Call(const std::string& method, Args&&... args) {
  std::string args_json =
      EncodeArgs(name_, method, std::forward<Args>(args)...);
  RayTpuClient* c = client_;
  return ObjectRef<R>(std::async(std::launch::async, [c, args_json] {
                        return c->SubmitTask("__actor_call__", args_json);
                      }).share());
}

inline void ActorHandle::Kill() {
  client_->SubmitTask("__actor_kill__", EncodeArgs(name_));
}

}  // namespace raytpu_cpp

#ifdef RAYTPU_CPP_DEMO_MAIN
// Demo driver: raytpu_cpp_demo <state_addr> [token]
//   - lists nodes
//   - round-trips the KV
//   - calls the Python-registered named function "cpp_add" with [2, 3]
//
// Typed mode: raytpu_cpp_demo <state_addr> --typed [token]
//   - Task("cpp_add").Remote<int64_t>(2, 3) -> ObjectRef<int64_t>
//   - Actor("Counter").Remote(10) -> typed method calls -> Kill()
int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <state_addr> [--typed] [token]\n", argv[0]);
    return 2;
  }
  bool typed = argc > 2 && std::string(argv[2]) == "--typed";
  std::string token = typed ? (argc > 3 ? argv[3] : "")
                            : (argc > 2 ? argv[2] : "");
  try {
    raytpu_cpp::RayTpuClient client(argv[1], token);
    if (typed) {
      auto sum = client.Task("cpp_add").Remote<int64_t>(2, 3);
      printf("typed_add=%lld\n", static_cast<long long>(sum.Get()));
      auto counter = client.Actor("Counter").Remote(int64_t{10});
      printf("actor_name=%s\n", counter.Name().c_str());
      auto a = counter.Call<int64_t>("add", int64_t{5});
      printf("counter_add=%lld\n", static_cast<long long>(a.Get()));
      auto b = counter.Call<int64_t>("add", int64_t{7});
      printf("counter_add2=%lld\n", static_cast<long long>(b.Get()));
      auto t = counter.Call<int64_t>("total");
      printf("counter_total=%lld\n", static_cast<long long>(t.Get()));
      counter.Kill();
      printf("typed-ok\n");
      return 0;
    }
    auto nodes = client.ListNodes();
    printf("nodes=%zu\n", nodes.size());
    client.KvPut("cpp-kv-key", "from-cpp");
    printf("kv=%s\n", client.KvGet("cpp-kv-key").c_str());
    std::string result = client.SubmitTask("cpp_add", "[2, 3]");
    printf("cpp_add(2,3)=%s\n", result.c_str());
    return 0;
  } catch (const std::exception& e) {
    fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
}
#endif
