// A C++ user program on the C++ worker API: it serves a language model
// that Python defines, from a named actor in a daemon of a running
// cluster. Not part of the library: it #includes cpp_worker.cc without
// RAYTPU_CPP_DEMO_MAIN, as a user's program would, and chip_smoke.py's
// phase 27 builds it with build.build_cpp_program and drives the flagship
// transformer through it on the card.
//
//   cpp_serve_lm <state_addr> <requests_file> [token]
//
// The Python side registers (register_named_actor_class / _function):
//   "ServingLM": __init__() builds the model; answer(tokens) -> the argmax
//                of the request's last-token logits; launches() -> the
//                flash forward launches in its process; info() -> a JSON
//                string naming its process, node and device;
//   "cpp_add" and "Counter": the demo driver's checks.
//
// requests_file holds one JSON array of token ids a line. The program
// creates the actor, asks each request one at a time, then all at once
// as ObjectRef futures in flight, runs the demo driver's own checks
// against the same cluster, kills the actor, and prints key=value lines.
// Exit code 1 on any error.

#include "cpp_worker.cc"

#include <fstream>

namespace {

double Since(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

std::string Join(const std::vector<int64_t>& v) {
  std::string out;
  for (size_t i = 0; i < v.size(); ++i)
    out += (i ? "," : "") + std::to_string(v[i]);
  return out;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: %s <state_addr> <requests_file> [token]\n",
            argv[0]);
    return 2;
  }
  try {
    std::vector<std::vector<int64_t>> requests;
    std::ifstream in(argv[2]);
    for (std::string line; std::getline(in, line);)
      if (!raytpu_cpp::JsonTrim(line).empty())
        requests.push_back(
            raytpu_cpp::JsonDecode<std::vector<int64_t>>(line));
    if (requests.empty()) throw std::runtime_error("no requests");
    raytpu_cpp::RayTpuClient client(argv[1], argc > 3 ? argv[3] : "");

    auto t0 = std::chrono::steady_clock::now();
    auto lm = client.Actor("ServingLM").Remote();
    printf("actor_info=%s\n", lm.Call<std::string>("info").Get().c_str());
    printf("ready_s=%.6f\n", Since(t0));
    int64_t launches0 = lm.Call<int64_t>("launches").Get();
    lm.Call<int64_t>("answer", requests[0]).Get();  // warm-up
    int64_t launches1 = lm.Call<int64_t>("launches").Get();

    // one request at a time
    std::vector<int64_t> one;
    size_t request_bytes = 0, answer_bytes = 0;
    t0 = std::chrono::steady_clock::now();
    for (const auto& r : requests) {
      auto ref = lm.Call<int64_t>("answer", r);
      answer_bytes += ref.GetJson().size();
      one.push_back(ref.Get());
    }
    double one_s = Since(t0);
    int64_t launches2 = lm.Call<int64_t>("launches").Get();
    for (const auto& r : requests)  // what __actor_call__ carries
      request_bytes +=
          raytpu_cpp::EncodeArgs(lm.Name(), std::string("answer"), r).size();

    // every request in flight at once
    t0 = std::chrono::steady_clock::now();
    std::vector<raytpu_cpp::ObjectRef<int64_t>> refs;
    for (const auto& r : requests)
      refs.push_back(lm.Call<int64_t>("answer", r));
    std::vector<int64_t> in_flight;
    for (const auto& ref : refs) in_flight.push_back(ref.Get());
    double in_flight_s = Since(t0);
    int64_t launches3 = lm.Call<int64_t>("launches").Get();

    printf("requests=%zu\n", requests.size());
    printf("answers_one=%s\n", Join(one).c_str());
    printf("answers_in_flight=%s\n", Join(in_flight).c_str());
    printf("one_s=%.6f\n", one_s);
    printf("in_flight_s=%.6f\n", in_flight_s);
    printf("launches=%s\n",
           Join({launches0, launches1, launches2, launches3}).c_str());
    printf("request_json_bytes_mean=%.2f\n",
           static_cast<double>(request_bytes) / requests.size());
    printf("answer_json_bytes_mean=%.2f\n",
           static_cast<double>(answer_bytes) / requests.size());

    // the demo driver's checks, on the same cluster
    printf("nodes=%zu\n", client.ListNodes().size());
    client.KvPut("cpp-kv-key", "from-cpp");
    printf("kv=%s\n", client.KvGet("cpp-kv-key").c_str());
    printf("cpp_add(2,3)=%s\n", client.SubmitTask("cpp_add", "[2, 3]").c_str());
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

    lm.Kill();
    printf("lm_actor=%s\n", lm.Name().c_str());
    return 0;
  } catch (const std::exception& e) {
    fprintf(stderr, "error: %s\n", e.what());
    return 1;
  }
}
