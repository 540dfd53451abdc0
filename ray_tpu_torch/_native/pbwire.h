// A hand-written proto3 wire codec for the messages of raytpu.proto that
// the C++ worker API speaks (cpp_worker.cc), so that it builds with g++
// alone: no protoc, no libprotobuf.
//
// Each message is a plain struct whose fields carry the names, numbers and
// types of ray_tpu_torch/protocol/raytpu.proto. One static Fields(msg, v)
// per message lists them once; three visitors walk that list: the writer
// (Serialize), the reader (Parse) and the table (FieldTable, which a test
// holds against the Python descriptor).
//
// Serialize follows proto3: fields in number order, default values left
// out (a double by its bits, so -0.0 is written), varints, double as
// little-endian fixed64, negative int32 as 10-byte varints, repeated bool
// packed, each map entry a message with key = 1 and value = 2, a
// submessage written when it is present. Parse accepts repeated bool
// packed and unpacked, keeps every field it does not know (wire types 0,
// 1, 2 and 5, a group, or a known number on another wire type) and writes
// it back after the known ones, and throws ParseError on a truncated or
// malformed buffer without reading past it.

#ifndef RAYTPU_TORCH_PBWIRE_H_
#define RAYTPU_TORCH_PBWIRE_H_

#include <cstdint>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

namespace pbwire {

class ParseError : public std::runtime_error {
 public:
  using std::runtime_error::runtime_error;
};

enum WireType : int {
  kVarint = 0,
  kFixed64 = 1,
  kLen = 2,
  kStartGroup = 3,  // proto2 groups: skipped as unknown fields only
  kEndGroup = 4,
  kFixed32 = 5,
};

// raytpu.Method values this codec's users send.
enum Method : uint32_t {
  METHOD_UNSPECIFIED = 0,
  LIST_NODES = 3,
  KV_PUT = 10,
  KV_GET = 11,
  PUSH_TASK = 100,
  AUTH = 117,
};

struct MethodEntry {
  const char* name;
  uint32_t number;
};

inline const std::vector<MethodEntry>& MethodTable() {
  static const std::vector<MethodEntry> table = {
      {"LIST_NODES", LIST_NODES}, {"KV_PUT", KV_PUT}, {"KV_GET", KV_GET},
      {"PUSH_TASK", PUSH_TASK},   {"AUTH", AUTH}};
  return table;
}

namespace detail {

class Writer {
 public:
  std::string out;

  void Varint(uint64_t v) {
    while (v >= 0x80) {
      out += static_cast<char>(v | 0x80);
      v >>= 7;
    }
    out += static_cast<char>(v);
  }
  void Tag(int number, int wire_type) {
    Varint((static_cast<uint64_t>(number) << 3) | wire_type);
  }
  void Fixed64(uint64_t bits) {
    for (int i = 0; i < 8; ++i) out += static_cast<char>(bits >> (8 * i));
  }
  void Delimited(int number, const std::string& body) {
    Tag(number, kLen);
    Varint(body.size());
    out += body;
  }
  static uint64_t Bits(double v) {
    uint64_t bits;
    std::memcpy(&bits, &v, sizeof(bits));
    return bits;
  }

  // -- the field visitor --------------------------------------------------
  void Uint64(const char*, int n, uint64_t v) {
    if (v) {
      Tag(n, kVarint);
      Varint(v);
    }
  }
  void Uint32(const char* f, int n, uint32_t v) { Uint64(f, n, v); }
  void Int32(const char*, int n, int32_t v) {
    if (v) {
      Tag(n, kVarint);
      Varint(static_cast<uint64_t>(static_cast<int64_t>(v)));
    }
  }
  void Bool(const char*, int n, bool v) {
    if (v) {
      Tag(n, kVarint);
      Varint(1);
    }
  }
  void Double(const char*, int n, double v) {
    if (Bits(v)) {
      Tag(n, kFixed64);
      Fixed64(Bits(v));
    }
  }
  void String(const char*, int n, const std::string& v) {
    if (!v.empty()) Delimited(n, v);
  }
  void Bytes(const char* f, int n, const std::string& v) { String(f, n, v); }
  template <typename M>
  void Message(const char*, int n, const M& m, bool present);
  template <typename M>
  void RepeatedMessage(const char*, int n, const std::vector<M>& v);
  void RepeatedBytes(const char*, int n, const std::vector<std::string>& v) {
    for (const auto& s : v) Delimited(n, s);
  }
  void RepeatedBool(const char*, int n, const std::vector<bool>& v) {
    if (v.empty()) return;
    Tag(n, kLen);
    Varint(v.size());
    for (bool b : v) out += static_cast<char>(b ? 1 : 0);
  }
  void MapStringDouble(const char*, int n,
                       const std::map<std::string, double>& m) {
    for (const auto& kv : m) {
      Writer e;
      e.Delimited(1, kv.first);
      e.Tag(2, kFixed64);
      e.Fixed64(Bits(kv.second));
      Delimited(n, e.out);
    }
  }
  void MapStringString(const char*, int n,
                       const std::map<std::string, std::string>& m) {
    for (const auto& kv : m) {
      Writer e;
      e.Delimited(1, kv.first);
      e.Delimited(2, kv.second);
      Delimited(n, e.out);
    }
  }
};

template <typename M>
std::string SerializeMessage(const M& m) {
  Writer w;
  M::Fields(m, w);
  w.out += m.unknown_fields;
  return w.out;
}

template <typename M>
void Writer::Message(const char*, int n, const M& m, bool present) {
  if (present) Delimited(n, SerializeMessage(m));
}

template <typename M>
void Writer::RepeatedMessage(const char*, int n, const std::vector<M>& v) {
  for (const auto& m : v) Delimited(n, SerializeMessage(m));
}

// Reads one buffer; every read checks the bytes left first.
class Reader {
 public:
  static constexpr int kMaxDepth = 100;
  Reader(const char* begin, const char* end) : p_(begin), end_(end) {}

  bool Done() const { return p_ == end_; }
  const char* Pos() const { return p_; }

  uint64_t Varint() {
    uint64_t v = 0;
    for (int i = 0; i < 10; ++i) {
      if (p_ == end_) throw ParseError("truncated varint");
      uint8_t b = static_cast<uint8_t>(*p_++);
      if (7 * i < 64) v |= static_cast<uint64_t>(b & 0x7f) << (7 * i);
      if (!(b & 0x80)) return v;
    }
    throw ParseError("varint longer than 10 bytes");
  }
  uint64_t Fixed(int n) {
    Need(n);
    uint64_t v = 0;
    for (int i = 0; i < n; ++i)
      v |= static_cast<uint64_t>(static_cast<uint8_t>(p_[i])) << (8 * i);
    p_ += n;
    return v;
  }
  // The body of a length-delimited field, as a reader of its own.
  Reader Sub() {
    uint64_t n = Varint();
    Need(n);
    Reader sub(p_, p_ + n);
    p_ += n;
    return sub;
  }
  std::string Len() {
    Reader sub = Sub();
    return std::string(sub.p_, sub.end_);
  }
  // (field number, wire type) of the next field.
  std::pair<int, int> Tag() {
    uint64_t key = Varint();
    uint64_t number = key >> 3;
    if (number == 0 || number > 0x1fffffff)
      throw ParseError("invalid field number");
    return {static_cast<int>(number), static_cast<int>(key & 7)};
  }
  // Skips field `number`'s value; a group (wire type 3) up to its
  // matching end tag, nested at most kMaxDepth deep.
  void Skip(int wire_type, int number, int depth = 0) {
    switch (wire_type) {
      case kVarint: Varint(); break;
      case kFixed64: Fixed(8); break;
      case kLen: Sub(); break;
      case kFixed32: Fixed(4); break;
      case kStartGroup:
        if (depth >= kMaxDepth) throw ParseError("groups nested too deep");
        for (;;) {
          auto tag = Tag();
          if (tag.second == kEndGroup) {
            if (tag.first != number) throw ParseError("mismatched group");
            break;
          }
          Skip(tag.second, tag.first, depth + 1);
        }
        break;
      default: throw ParseError("unexpected wire type");
    }
  }

 private:
  void Need(uint64_t n) const {
    if (n > static_cast<uint64_t>(end_ - p_))
      throw ParseError("truncated field");
  }
  const char* p_;
  const char* end_;
};

template <typename M>
void MergeMessage(M& m, Reader& r);

// The reader's visitor: parses the current field into the member whose
// number and wire type match it, and says whether one did.
class Dispatch {
 public:
  Dispatch(Reader& r, int number, int wire_type)
      : r_(r), n_(number), wt_(wire_type) {}
  bool matched = false;

  void Uint64(const char*, int n, uint64_t& v) {
    if (Is(n, kVarint)) v = r_.Varint();
  }
  void Uint32(const char*, int n, uint32_t& v) {
    if (Is(n, kVarint)) v = static_cast<uint32_t>(r_.Varint());
  }
  void Int32(const char*, int n, int32_t& v) {
    if (Is(n, kVarint))
      v = static_cast<int32_t>(static_cast<uint32_t>(r_.Varint()));
  }
  void Bool(const char*, int n, bool& v) {
    if (Is(n, kVarint)) v = r_.Varint() != 0;
  }
  void Double(const char*, int n, double& v) {
    if (Is(n, kFixed64)) {
      uint64_t bits = r_.Fixed(8);
      std::memcpy(&v, &bits, sizeof(v));
    }
  }
  void String(const char*, int n, std::string& v) {
    if (Is(n, kLen)) v = r_.Len();
  }
  void Bytes(const char* f, int n, std::string& v) { String(f, n, v); }
  template <typename M>
  void Message(const char*, int n, M& m, bool& present) {
    if (!Is(n, kLen)) return;
    Reader sub = r_.Sub();
    MergeMessage(m, sub);
    present = true;
  }
  template <typename M>
  void RepeatedMessage(const char*, int n, std::vector<M>& v) {
    if (!Is(n, kLen)) return;
    Reader sub = r_.Sub();
    v.emplace_back();
    MergeMessage(v.back(), sub);
  }
  void RepeatedBytes(const char*, int n, std::vector<std::string>& v) {
    if (Is(n, kLen)) v.push_back(r_.Len());
  }
  void RepeatedBool(const char*, int n, std::vector<bool>& v) {
    if (Is(n, kVarint)) {
      v.push_back(r_.Varint() != 0);
    } else if (Is(n, kLen)) {  // packed
      Reader packed = r_.Sub();
      while (!packed.Done()) v.push_back(packed.Varint() != 0);
    }
  }
  void MapStringDouble(const char*, int n, std::map<std::string, double>& m) {
    if (!Is(n, kLen)) return;
    Reader e = r_.Sub();
    std::string key;
    double value = 0.0;
    while (!e.Done()) {
      auto tag = e.Tag();
      if (tag.first == 1 && tag.second == kLen) {
        key = e.Len();
      } else if (tag.first == 2 && tag.second == kFixed64) {
        uint64_t bits = e.Fixed(8);
        std::memcpy(&value, &bits, sizeof(value));
      } else {
        e.Skip(tag.second, tag.first);
      }
    }
    m[key] = value;
  }
  void MapStringString(const char*, int n,
                       std::map<std::string, std::string>& m) {
    if (!Is(n, kLen)) return;
    Reader e = r_.Sub();
    std::string key, value;
    while (!e.Done()) {
      auto tag = e.Tag();
      if (tag.first == 1 && tag.second == kLen) {
        key = e.Len();
      } else if (tag.first == 2 && tag.second == kLen) {
        value = e.Len();
      } else {
        e.Skip(tag.second, tag.first);
      }
    }
    m[key] = value;
  }

 private:
  // True (once) when the current field is member n on wire type wt.
  bool Is(int n, int wt) {
    if (matched || n != n_ || wt != wt_) return false;
    matched = true;
    return true;
  }
  Reader& r_;
  int n_;
  int wt_;
};

template <typename M>
void MergeMessage(M& m, Reader& r) {
  while (!r.Done()) {
    const char* start = r.Pos();
    auto tag = r.Tag();
    Dispatch d(r, tag.first, tag.second);
    M::Fields(m, d);
    if (!d.matched) {
      r.Skip(tag.second, tag.first);
      m.unknown_fields.append(start, r.Pos() - start);
    }
  }
}

template <typename M>
M ParseMessage(const std::string& bytes) {
  M m;
  Reader r(bytes.data(), bytes.data() + bytes.size());
  MergeMessage(m, r);
  return m;
}

}  // namespace detail

// One row of the field table: what the codec writes for a field.
struct FieldEntry {
  std::string message;
  std::string field;
  int number;
  int wire_type;
  std::string type;  // as raytpu.proto spells it
};

namespace detail {

class Table {
 public:
  Table(const char* message, std::vector<FieldEntry>& out)
      : message_(message), out_(out) {}
  template <typename T>
  void Uint64(const char* f, int n, T&) { Add(f, n, kVarint, "uint64"); }
  template <typename T>
  void Uint32(const char* f, int n, T&) { Add(f, n, kVarint, "uint32"); }
  template <typename T>
  void Int32(const char* f, int n, T&) { Add(f, n, kVarint, "int32"); }
  template <typename T>
  void Bool(const char* f, int n, T&) { Add(f, n, kVarint, "bool"); }
  template <typename T>
  void Double(const char* f, int n, T&) { Add(f, n, kFixed64, "double"); }
  template <typename T>
  void String(const char* f, int n, T&) { Add(f, n, kLen, "string"); }
  template <typename T>
  void Bytes(const char* f, int n, T&) { Add(f, n, kLen, "bytes"); }
  template <typename M, typename P>
  void Message(const char* f, int n, M&, P&) { Add(f, n, kLen, M::kName); }
  template <typename V>
  void RepeatedMessage(const char* f, int n, V&) {
    Add(f, n, kLen, std::string("repeated ") + V::value_type::kName);
  }
  template <typename T>
  void RepeatedBytes(const char* f, int n, T&) {
    Add(f, n, kLen, "repeated bytes");
  }
  template <typename T>
  void RepeatedBool(const char* f, int n, T&) {
    Add(f, n, kLen, "repeated bool");  // packed
  }
  template <typename T>
  void MapStringDouble(const char* f, int n, T&) {
    Add(f, n, kLen, "map<string, double>");
  }
  template <typename T>
  void MapStringString(const char* f, int n, T&) {
    Add(f, n, kLen, "map<string, string>");
  }

 private:
  void Add(const char* f, int n, int wt, const std::string& type) {
    out_.push_back({message_, f, n, wt, type});
  }
  const char* message_;
  std::vector<FieldEntry>& out_;
};

}  // namespace detail

// Each message: its fields, Serialize() and Parse(bytes); unknown_fields
// holds what Parse did not recognise, written back by Serialize.
#define PBWIRE_MESSAGE_METHODS(Name)                                  \
  static constexpr const char* kName = #Name;                         \
  std::string unknown_fields;                                         \
  std::string Serialize() const { return detail::SerializeMessage(*this); } \
  static Name Parse(const std::string& bytes) {                       \
    return detail::ParseMessage<Name>(bytes);                         \
  }

struct Envelope {
  uint64_t seq = 0;
  uint32_t method = 0;  // a Method value
  bool reply = false;
  std::string error;
  std::string body;
  uint64_t raw_len = 0;
  std::string trace;
  PBWIRE_MESSAGE_METHODS(Envelope)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Uint64("seq", 1, m.seq);
    v.Uint32("method", 2, m.method);
    v.Bool("reply", 3, m.reply);
    v.String("error", 4, m.error);
    v.Bytes("body", 5, m.body);
    v.Uint64("raw_len", 6, m.raw_len);
    v.String("trace", 7, m.trace);
  }
};

struct Resources {
  std::map<std::string, double> amounts;
  PBWIRE_MESSAGE_METHODS(Resources)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.MapStringDouble("amounts", 1, m.amounts);
  }
};

struct NodeInfo {
  std::string node_id;
  std::string address;
  Resources total;
  bool has_total = false;
  Resources available;
  bool has_available = false;
  std::map<std::string, std::string> labels;
  bool alive = false;
  double last_heartbeat_ms = 0.0;
  bool is_head = false;
  std::string death_reason;
  std::string state;
  double drain_deadline_ms = 0.0;
  std::string drain_reason;
  PBWIRE_MESSAGE_METHODS(NodeInfo)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Bytes("node_id", 1, m.node_id);
    v.String("address", 2, m.address);
    v.Message("total", 3, m.total, m.has_total);
    v.Message("available", 4, m.available, m.has_available);
    v.MapStringString("labels", 5, m.labels);
    v.Bool("alive", 6, m.alive);
    v.Double("last_heartbeat_ms", 7, m.last_heartbeat_ms);
    v.Bool("is_head", 8, m.is_head);
    v.String("death_reason", 9, m.death_reason);
    v.String("state", 10, m.state);
    v.Double("drain_deadline_ms", 11, m.drain_deadline_ms);
    v.String("drain_reason", 12, m.drain_reason);
  }
};

struct ListNodesReply {
  std::vector<NodeInfo> nodes;
  PBWIRE_MESSAGE_METHODS(ListNodesReply)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.RepeatedMessage("nodes", 1, m.nodes);
  }
};

struct KvPutRequest {
  std::string ns;
  std::string key;
  std::string value;
  bool overwrite = false;
  PBWIRE_MESSAGE_METHODS(KvPutRequest)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Bytes("ns", 1, m.ns);
    v.Bytes("key", 2, m.key);
    v.Bytes("value", 3, m.value);
    v.Bool("overwrite", 4, m.overwrite);
  }
};

struct KvPutReply {
  bool added = false;
  PBWIRE_MESSAGE_METHODS(KvPutReply)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Bool("added", 1, m.added);
  }
};

struct KvGetRequest {
  std::string ns;
  std::string key;
  PBWIRE_MESSAGE_METHODS(KvGetRequest)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Bytes("ns", 1, m.ns);
    v.Bytes("key", 2, m.key);
  }
};

struct KvGetReply {
  bool found = false;
  std::string value;
  PBWIRE_MESSAGE_METHODS(KvGetReply)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Bool("found", 1, m.found);
    v.Bytes("value", 2, m.value);
  }
};

struct TaskSpecMsg {
  std::string task_id;
  std::string job_id;
  std::string function_name;
  std::string fn_hash;
  std::string args_pickle;
  uint32_t num_returns = 0;
  Resources resources;
  bool has_resources = false;
  std::vector<std::string> return_ids;
  uint32_t attempt = 0;
  uint32_t max_retries = 0;
  std::string actor_id;
  std::string method_name;
  std::string runtime_env_json;
  std::string caller_address;
  std::string pg_id;
  int32_t pg_bundle_index = 0;
  std::string retry_exceptions_pickle;
  std::string name;
  std::string named_function;
  std::string args_json;
  bool json_results = false;
  std::string trace_id;
  std::string parent_span_id;
  double perf_submit_s = 0.0;
  PBWIRE_MESSAGE_METHODS(TaskSpecMsg)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.Bytes("task_id", 1, m.task_id);
    v.Bytes("job_id", 2, m.job_id);
    v.String("function_name", 3, m.function_name);
    v.Bytes("fn_hash", 4, m.fn_hash);
    v.Bytes("args_pickle", 5, m.args_pickle);
    v.Uint32("num_returns", 6, m.num_returns);
    v.Message("resources", 7, m.resources, m.has_resources);
    v.RepeatedBytes("return_ids", 8, m.return_ids);
    v.Uint32("attempt", 9, m.attempt);
    v.Uint32("max_retries", 10, m.max_retries);
    v.Bytes("actor_id", 11, m.actor_id);
    v.String("method_name", 12, m.method_name);
    v.Bytes("runtime_env_json", 13, m.runtime_env_json);
    v.String("caller_address", 14, m.caller_address);
    v.Bytes("pg_id", 15, m.pg_id);
    v.Int32("pg_bundle_index", 16, m.pg_bundle_index);
    v.Bytes("retry_exceptions_pickle", 17, m.retry_exceptions_pickle);
    v.String("name", 18, m.name);
    v.String("named_function", 19, m.named_function);
    v.Bytes("args_json", 20, m.args_json);
    v.Bool("json_results", 21, m.json_results);
    v.String("trace_id", 22, m.trace_id);
    v.String("parent_span_id", 23, m.parent_span_id);
    v.Double("perf_submit_s", 24, m.perf_submit_s);
  }
};

struct PushTaskReply {
  std::string status;
  Resources available;
  bool has_available = false;
  std::vector<std::string> inline_results;
  std::vector<bool> inline_;  // the proto's `inline`
  std::string error_pickle;
  std::string error_message;
  PBWIRE_MESSAGE_METHODS(PushTaskReply)
  template <typename S, typename V>
  static void Fields(S& m, V& v) {
    v.String("status", 1, m.status);
    v.Message("available", 2, m.available, m.has_available);
    v.RepeatedBytes("inline_results", 3, m.inline_results);
    v.RepeatedBool("inline", 4, m.inline_);
    v.Bytes("error_pickle", 5, m.error_pickle);
    v.String("error_message", 6, m.error_message);
  }
};

#undef PBWIRE_MESSAGE_METHODS

// Every field of every message above: (message, field, number, wire type,
// type).
inline const std::vector<FieldEntry>& FieldTable() {
  static const std::vector<FieldEntry> table = [] {
    std::vector<FieldEntry> out;
    auto add = [&out](auto m) {
      detail::Table t(decltype(m)::kName, out);
      decltype(m)::Fields(m, t);
    };
    add(Envelope{});
    add(Resources{});
    add(NodeInfo{});
    add(ListNodesReply{});
    add(KvPutRequest{});
    add(KvPutReply{});
    add(KvGetRequest{});
    add(KvGetReply{});
    add(TaskSpecMsg{});
    add(PushTaskReply{});
    return out;
  }();
  return table;
}

}  // namespace pbwire

#endif  // RAYTPU_TORCH_PBWIRE_H_
