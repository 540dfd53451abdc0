// Native scheduling policy kernels.
//
// The C++ half of the scheduler (reference: src/ray/raylet/scheduling/
// policy/hybrid_scheduling_policy.h:48 pack-then-spread with top-k
// randomization, spread_scheduling_policy.h:27, fixed_point.h resource
// arithmetic). The Python policy layer flattens node snapshots into
// dense matrices and calls these kernels; semantics are kept identical
// to the Python fallback so the two paths are interchangeable.
//
// C ABI only — bound via ctypes (no pybind11 in the image).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

inline bool Fits(const double* avail_row, const double* request,
                 int64_t n_res) {
  for (int64_t r = 0; r < n_res; ++r) {
    if (request[r] > 0 && avail_row[r] < request[r] - 1e-9) return false;
  }
  return true;
}

inline double Utilization(const double* avail_row, const double* total_row,
                          int64_t n_res) {
  // Max utilization across resource dimensions (resources.py:142).
  double best = 0.0;
  for (int64_t r = 0; r < n_res; ++r) {
    double tot = total_row[r];
    if (tot <= 0) continue;
    double used = tot - avail_row[r];
    double u = used / tot;
    if (u > best) best = u;
  }
  return best;
}

struct Scored {
  double score;
  int not_preferred;
  int64_t index;
};

}  // namespace

extern "C" {

// Hybrid pack-then-spread: returns the selected node index, or -1 when no
// alive node fits. rng_draw in [0, 2^63) supplies the top-k randomness so
// the caller's seeded generator stays the source of determinism.
int64_t sched_hybrid_select(const double* available, const double* total,
                            const uint8_t* alive, const double* request,
                            int64_t n_nodes, int64_t n_res,
                            int64_t preferred_idx, double spread_threshold,
                            double top_k_fraction, int64_t rng_draw) {
  std::vector<Scored> scored;
  scored.reserve(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) {
    if (!alive[i]) continue;
    const double* avail_row = available + i * n_res;
    if (!Fits(avail_row, request, n_res)) continue;
    double util = Utilization(avail_row, total + i * n_res, n_res);
    double score = util < spread_threshold ? 0.0 : util;
    scored.push_back({score, i == preferred_idx ? 0 : 1, i});
  }
  if (scored.empty()) return -1;
  std::sort(scored.begin(), scored.end(),
            [](const Scored& a, const Scored& b) {
              if (a.score != b.score) return a.score < b.score;
              if (a.not_preferred != b.not_preferred)
                return a.not_preferred < b.not_preferred;
              return a.index < b.index;
            });
  int64_t k = static_cast<int64_t>(scored.size() * top_k_fraction);
  if (k < 1) k = 1;
  return scored[rng_draw % k].index;
}

// Round-robin spread: returns the selected node index advancing from
// *cursor, or -1. The caller owns the cursor (SpreadPolicy state).
int64_t sched_spread_select(const double* available, const uint8_t* alive,
                            const double* request, int64_t n_nodes,
                            int64_t n_res, int64_t cursor) {
  std::vector<int64_t> feasible;
  feasible.reserve(n_nodes);
  for (int64_t i = 0; i < n_nodes; ++i) {
    if (!alive[i]) continue;
    if (Fits(available + i * n_res, request, n_res)) feasible.push_back(i);
  }
  if (feasible.empty()) return -1;
  return feasible[cursor % static_cast<int64_t>(feasible.size())];
}

}  // extern "C"
