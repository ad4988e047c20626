// Native host-side setup kernels for mgtpu.
//
// The device owns the solve path (JAX/XLA); what remains host-bound is
// the one-time hierarchy SETUP, whose inner loops are inherently sequential
// greedy graph algorithms: SA neighborhood aggregation (reference
// src/Multigrid/SA-AMG.jl:119-211) and Ruge-Stueben C/F coloring (reference
// src/Multigrid/coloring.jl:13-122).  These are the mgtpu counterpart of the
// reference's deps/ native tier, applied where native code actually helps an
// accelerator framework: the host runtime around the device compute.
//
// All functions operate on CSR arrays with int64 indices, extern "C" for
// ctypes binding (no pybind11 in this image).  Semantics mirror the numpy
// implementations in mgtpu/setup exactly (tested for equality).
//
// Build: g++ -O3 -march=native -fPIC -shared setup_kernels.cpp -o libmgtpu_setup.so

#include <cstdint>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SA neighborhood aggregation (3 passes + hub deferral + affinity adoption).
// aggr[i] = root node id of i's aggregate.
// ---------------------------------------------------------------------------
void mgtpu_aggregate(int64_t n, const int64_t* indptr, const int64_t* indices,
                     const double* data, double tau, int64_t* aggr) {
  if (n == 0) return;
  double avg = double(indptr[n]) / double(n);
  std::vector<char> hub(n);
  std::vector<int64_t> agg_size(n, 0);
  for (int64_t i = 0; i < n; ++i) {
    hub[i] = (double(indptr[i + 1] - indptr[i]) > tau * avg) ? 1 : 0;
    aggr[i] = -1;
  }
  // pass 1: seed aggregates at non-hub nodes with fully-free neighborhoods
  for (int64_t k = 0; k < n; ++k) {
    if (hub[k]) continue;
    bool touched = false;
    for (int64_t g = indptr[k]; g < indptr[k + 1]; ++g)
      if (aggr[indices[g]] >= 0) { touched = true; break; }
    if (touched) continue;
    for (int64_t g = indptr[k]; g < indptr[k + 1]; ++g) {
      int64_t nb = indices[g];
      if (!hub[nb]) { aggr[nb] = k; ++agg_size[k]; }
    }
  }
  // pass 2: hubs with untouched neighborhoods seed their own aggregates
  for (int64_t k = 0; k < n; ++k) {
    if (!hub[k]) continue;
    bool touched = false;
    for (int64_t g = indptr[k]; g < indptr[k + 1]; ++g)
      if (aggr[indices[g]] >= 0) { touched = true; break; }
    if (touched) continue;
    for (int64_t g = indptr[k]; g < indptr[k + 1]; ++g) {
      aggr[indices[g]] = k; ++agg_size[k];
    }
  }
  // pass 3: leftovers adopt the neighboring aggregate with the best mean
  // affinity (sum of strength values into the aggregate / aggregate size)
  std::vector<double> aux(n, 0.0);
  std::vector<char> seen(n, 0);
  std::vector<int64_t> touched_roots;
  for (int64_t k = 0; k < n; ++k) {
    if (aggr[k] >= 0) continue;
    touched_roots.clear();
    for (int64_t g = indptr[k]; g < indptr[k + 1]; ++g) {
      int64_t r = aggr[indices[g]];
      if (r < 0) continue;
      if (!seen[r]) { seen[r] = 1; touched_roots.push_back(r); }
      aux[r] += data[g];
    }
    if (touched_roots.empty()) {
      aggr[k] = k;  // isolated singleton
      ++agg_size[k];
      continue;
    }
    int64_t best = touched_roots[0];
    double best_score = -1.0;
    for (int64_t r : touched_roots) {
      double sz = agg_size[r] > 0 ? double(agg_size[r]) : 1.0;
      double score = aux[r] / sz;
      if (score > best_score) { best_score = score; best = r; }
      aux[r] = 0.0;
      seen[r] = 0;
    }
    aggr[k] = best;  // adopted; does not grow the seed neighborhood
  }
}

// ---------------------------------------------------------------------------
// C/F coloring pass 1: greedy max-influence independent set (lazy max-heap).
// coloring[i]: 1 = coarse, 0 = fine.
// ---------------------------------------------------------------------------
void mgtpu_cf_color_first(int64_t n, const int64_t* indptr,
                          const int64_t* indices, int8_t* coloring) {
  std::vector<int64_t> lam(n);
  std::vector<char> decided(n, 0);
  // (lam, -node): max-heap picks largest influence, smallest id on ties —
  // matching the python heapq (-lam, node) min-heap tie-breaking exactly
  using QE = std::pair<int64_t, int64_t>;
  std::priority_queue<QE> heap;
  for (int64_t i = 0; i < n; ++i) {
    lam[i] = indptr[i + 1] - indptr[i];
    coloring[i] = 0;
    if (lam[i] <= 1) decided[i] = 1;  // only a diagonal: stays fine
    else heap.push({lam[i], -i});
  }
  while (!heap.empty()) {
    auto [l, negcur] = heap.top();
    int64_t cur = -negcur;
    heap.pop();
    if (decided[cur] || l != lam[cur]) continue;  // stale entry
    coloring[cur] = 1;
    decided[cur] = 1;
    for (int64_t g = indptr[cur]; g < indptr[cur + 1]; ++g) {
      int64_t j = indices[g];
      if (decided[j]) continue;
      decided[j] = 1;  // strong neighbor of a C point -> F
      coloring[j] = 0;
      for (int64_t h = indptr[j]; h < indptr[j + 1]; ++h) {
        int64_t k = indices[h];
        if (!decided[k]) {
          ++lam[k];
          heap.push({lam[k], -k});
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// C/F coloring pass 2: every strong F-F pair must share a strong C neighbor;
// otherwise promote i to C.  indices within each row must be sorted (CSR
// canonical form).
// ---------------------------------------------------------------------------
static bool has_common_c(int64_t i, int64_t j, const int64_t* indptr,
                         const int64_t* indices, const int8_t* coloring) {
  // two-pointer intersection of sorted rows i and j, looking for a C node
  int64_t a = indptr[i], ae = indptr[i + 1];
  int64_t b = indptr[j], be = indptr[j + 1];
  while (a < ae && b < be) {
    int64_t va = indices[a], vb = indices[b];
    if (va == vb) {
      if (va != i && va != j && coloring[va] == 1) return true;
      ++a; ++b;
    } else if (va < vb) ++a;
    else ++b;
  }
  return false;
}

void mgtpu_cf_color_second(int64_t n, const int64_t* indptr,
                           const int64_t* indices, int8_t* coloring) {
  for (int64_t i = 0; i < n; ++i) {
    if (coloring[i] == 1) continue;
    for (int64_t g = indptr[i]; g < indptr[i + 1]; ++g) {
      int64_t j = indices[g];
      if (j == i || coloring[j] == 1) continue;
      if (!has_common_c(i, j, indptr, indices, coloring)) {
        coloring[i] = 1;
        break;
      }
    }
  }
}

}  // extern "C"
