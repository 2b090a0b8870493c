// Native adaptive voxelization engine (the PyTorch port's own copy).
//
// Counterpart: balm_tpu/native/voxelize_native.cpp, kept byte-for-byte in
// its logic so both packages associate scans into the same planes.
// C++ re-implementation of the association layer (the reference's
// cut_voxel/recut octree, src/benchmark/bavoxel.hpp:626-776, 1170-1223;
// numpy reference implementation: balm_tpu_torch/voxel/grid.py).  The
// device hot path (factor evaluation, LM solve) is PyTorch + CUDA; this is
// the host-side runtime component that feeds it: one parallel radix sort
// at the root level, per-run counting splits for the octree levels,
// closed-form 3x3 eigenvalue planarity tests, and a single accumulation
// pass for the per-(leaf, scan) body moments.
//
// Exposed via a C ABI for ctypes.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread voxelize_native.cpp
//        -o libvoxelize_native.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kOffset = int64_t(1) << 20;

int num_threads() {
  unsigned hw = std::thread::hardware_concurrency();
  return hw == 0 ? 4 : static_cast<int>(std::min(hw, 16u));
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  int T = num_threads();
  if (n < (1 << 14) || T == 1) {
    fn(int64_t(0), n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + T - 1) / T;
  for (int t = 0; t < T; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : ts) th.join();
}

// Parallel LSD radix argsort of uint64 keys, 8 passes of 8 bits.
void radix_argsort(const uint64_t* keys, int64_t n, int64_t* order) {
  std::vector<int64_t> tmp(n);
  int64_t* src = order;
  int64_t* dst = tmp.data();
  for (int64_t i = 0; i < n; ++i) order[i] = i;

  const int T = num_threads();
  const int64_t chunk = (n + T - 1) / T;

  for (int pass = 0; pass < 8; ++pass) {
    int shift = pass * 8;
    // per-thread histograms
    std::vector<std::vector<int64_t>> hist(T, std::vector<int64_t>(256, 0));
    {
      std::vector<std::thread> ts;
      for (int t = 0; t < T; ++t) {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back([&, t, lo, hi] {
          auto& h = hist[t];
          for (int64_t i = lo; i < hi; ++i)
            ++h[(keys[src[i]] >> shift) & 0xff];
        });
      }
      for (auto& th : ts) th.join();
    }
    // exclusive prefix over (bucket, thread)
    int64_t sum = 0;
    std::vector<std::vector<int64_t>> base(T, std::vector<int64_t>(256));
    for (int b = 0; b < 256; ++b)
      for (int t = 0; t < T; ++t) {
        base[t][b] = sum;
        sum += hist[t][b];
      }
    // scatter
    {
      std::vector<std::thread> ts;
      for (int t = 0; t < T; ++t) {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back([&, t, lo, hi] {
          auto pos = base[t];
          for (int64_t i = lo; i < hi; ++i) {
            int b = (keys[src[i]] >> shift) & 0xff;
            dst[pos[b]++] = src[i];
          }
        });
      }
      for (auto& th : ts) th.join();
    }
    std::swap(src, dst);
  }
  if (src != order) std::memcpy(order, src, sizeof(int64_t) * n);
}

// Smallest two eigenvalues of a symmetric 3x3 (trigonometric formula).
void eig3_low2(const double a[6], double* l0, double* l1) {
  // a = (xx, xy, xz, yy, yz, zz)
  double q = (a[0] + a[3] + a[5]) / 3.0;
  double b00 = a[0] - q, b11 = a[3] - q, b22 = a[5] - q;
  double p2 = (b00 * b00 + b11 * b11 + b22 * b22 +
               2.0 * (a[1] * a[1] + a[2] * a[2] + a[4] * a[4])) / 6.0;
  if (p2 < 1e-300) {
    *l0 = q;
    *l1 = q;
    return;
  }
  double pr = std::sqrt(p2);
  double inv = 1.0 / pr;
  double c00 = b00 * inv, c11 = b11 * inv, c22 = b22 * inv;
  double c01 = a[1] * inv, c02 = a[2] * inv, c12 = a[4] * inv;
  double det = c00 * (c11 * c22 - c12 * c12) - c01 * (c01 * c22 - c12 * c02) +
               c02 * (c01 * c12 - c11 * c02);
  double r = det * 0.5;
  r = std::max(-1.0, std::min(1.0, r));
  double phi = std::acos(r) / 3.0;
  double e2 = q + 2.0 * pr * std::cos(phi);
  double e0 = q + 2.0 * pr * std::cos(phi + 2.0 * M_PI / 3.0);
  double e1 = 3.0 * q - e0 - e2;
  *l0 = e0;
  *l1 = e1;
}

struct Cell {
  int64_t start;   // range in ord[]
  int64_t count;
  double center[3];
};

}  // namespace

extern "C" {

// Fused scan concatenation + per-scan rigid transform.
//   scans:   array of n_scans pointers to (lens[i], 3) f64 body points
//   R (n_scans, 3, 3) row-major, p (n_scans, 3)
// Outputs (caller-allocated, N = sum(lens)):
//   body (N, 3), world (N, 3) = R[s] @ body + p[s], scan_id (N,)
// Replaces the numpy concatenate + per-scan matmul prologue (~3.8 s of
// page-faulting python-side copies at 13.4M points -> one parallel pass).
void prepare_points(
    const double* const* scans, const int64_t* lens, int64_t n_scans,
    const double* R, const double* p,
    double* body, double* world, int64_t* scan_id) {
  std::vector<int64_t> ofs(n_scans + 1, 0);
  for (int64_t s = 0; s < n_scans; ++s) ofs[s + 1] = ofs[s] + lens[s];
  std::atomic<int64_t> next{0};
  int T = num_threads();
  std::vector<std::thread> ts;
  for (int t = 0; t < T; ++t) {
    ts.emplace_back([&] {
      for (;;) {
        int64_t s = next.fetch_add(1);
        if (s >= n_scans) return;
        const double* src = scans[s];
        const double* Rs = R + 9 * s;
        const double* ps = p + 3 * s;
        double* b = body + 3 * ofs[s];
        double* w = world + 3 * ofs[s];
        int64_t* id = scan_id + ofs[s];
        int64_t m = lens[s];
        std::memcpy(b, src, sizeof(double) * 3 * m);
        for (int64_t i = 0; i < m; ++i) {
          double x = src[3 * i], y = src[3 * i + 1], z = src[3 * i + 2];
          w[3 * i + 0] = Rs[0] * x + Rs[1] * y + Rs[2] * z + ps[0];
          w[3 * i + 1] = Rs[3] * x + Rs[4] * y + Rs[5] * z + ps[1];
          w[3 * i + 2] = Rs[6] * x + Rs[7] * y + Rs[8] * z + ps[2];
          id[i] = s;
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

// Adaptive voxelization.  Inputs:
//   world  (n, 3) points under initial poses
//   body   (n, 3) body-frame points
//   scan   (n,) scan index per point, in [0, n_scans), ascending within
//          any equal-key run (guaranteed: input is scan-concatenated and
//          the radix sort is stable), used for the min_observers gate
// Parameters mirror VoxelConfig (grid.py / bavoxel.hpp:8-19).
// Outputs (caller-allocated):
//   point_leaf (n,)  ADMITTED leaf id or -1
//   moments (max_leaves, n_scans, 16): 4x4 symmetric homogeneous moment
//     blocks [[xx xy xz x],[. yy yz y],[. . zz z],[. . . count]] — the
//     PlaneFactors.C layout, emitted directly so the caller pads in
//     place with zero further copies
//   coe (max_leaves,): factor weights (point_count or unit,
//     bavoxel.hpp:41-45)
//   leaf_center (max_leaves, 3), leaf_layer (max_leaves),
//   leaf_decision (max_leaves)
// The min_observers admission gate (bavoxel.hpp:33-37) is applied at
// emission: rejected plane cells never consume a leaf id.
// Returns number of admitted leaves, or -(needed) if max_leaves is too
// small.
int64_t voxelize_factors(
    const double* world, const double* body, const int64_t* scan,
    int64_t n, int64_t n_scans,
    double voxel_size, int64_t layer_limit,
    const double* eigen_ratio, int64_t n_ratio,
    int64_t min_points, int64_t min_observers, int64_t unit_coe,
    int64_t* point_leaf,
    double* moments, double* coe, int64_t max_leaves,
    double* leaf_center, int64_t* leaf_layer, double* leaf_decision) {
  std::vector<int64_t> ord(n);
  std::vector<uint64_t> keys(n);

  const double inv_vs = 1.0 / voxel_size;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t x = (int64_t)std::floor(world[3 * i + 0] * inv_vs) + kOffset;
      int64_t y = (int64_t)std::floor(world[3 * i + 1] * inv_vs) + kOffset;
      int64_t z = (int64_t)std::floor(world[3 * i + 2] * inv_vs) + kOffset;
      keys[i] = (uint64_t(x) << 42) | (uint64_t(y) << 21) | uint64_t(z);
      point_leaf[i] = -1;
    }
  });

  radix_argsort(keys.data(), n, ord.data());

  // root cells from sorted runs
  std::vector<Cell> cells;
  cells.reserve(1 << 16);
  {
    int64_t i = 0;
    while (i < n) {
      uint64_t k = keys[ord[i]];
      int64_t j = i + 1;
      while (j < n && keys[ord[j]] == k) ++j;
      Cell c;
      c.start = i;
      c.count = j - i;
      c.center[0] = ((double)((int64_t)(k >> 42) - kOffset) + 0.5) * voxel_size;
      c.center[1] =
          ((double)((int64_t)((k >> 21) & 0x1fffff) - kOffset) + 0.5) *
          voxel_size;
      c.center[2] =
          ((double)((int64_t)(k & 0x1fffff) - kOffset) + 0.5) * voxel_size;
      cells.push_back(c);
      i = j;
    }
  }

  int64_t n_leaves = 0;
  std::atomic<int64_t> overflow{0};
  double half = voxel_size * 0.5;

  std::vector<Cell> next_cells;
  std::vector<int64_t> ord2(n);

  for (int64_t layer = 0;; ++layer) {
    double ratio =
        eigen_ratio[layer < n_ratio ? layer : n_ratio - 1];
    int64_t n_cells = (int64_t)cells.size();

    // classify cells in parallel; record decision per cell
    std::vector<int8_t> cls(n_cells);  // 0 drop, 1 plane, 2 split
    std::vector<double> dec(n_cells);
    std::vector<double> cent(3 * n_cells);
    parallel_for(n_cells, [&](int64_t lo, int64_t hi) {
      for (int64_t c = lo; c < hi; ++c) {
        const Cell& cell = cells[c];
        if (cell.count <= min_points) {
          cls[c] = 0;
          continue;
        }
        double m[6] = {0, 0, 0, 0, 0, 0}, v[3] = {0, 0, 0};
        for (int64_t t = cell.start; t < cell.start + cell.count; ++t) {
          const double* pw = world + 3 * ord[t];
          m[0] += pw[0] * pw[0];
          m[1] += pw[0] * pw[1];
          m[2] += pw[0] * pw[2];
          m[3] += pw[1] * pw[1];
          m[4] += pw[1] * pw[2];
          m[5] += pw[2] * pw[2];
          v[0] += pw[0];
          v[1] += pw[1];
          v[2] += pw[2];
        }
        double N = (double)cell.count;
        double vb[3] = {v[0] / N, v[1] / N, v[2] / N};
        double cov[6] = {m[0] / N - vb[0] * vb[0], m[1] / N - vb[0] * vb[1],
                         m[2] / N - vb[0] * vb[2], m[3] / N - vb[1] * vb[1],
                         m[4] / N - vb[1] * vb[2], m[5] / N - vb[2] * vb[2]};
        double l0, l1;
        eig3_low2(cov, &l0, &l1);
        double d = l0 / std::max(l1, 1e-30);
        dec[c] = d;
        cent[3 * c + 0] = vb[0];
        cent[3 * c + 1] = vb[1];
        cent[3 * c + 2] = vb[2];
        if (d < ratio) {
          // min_observers admission at classify time: scan ids are
          // ascending within a run (stable sort over scan-concatenated
          // input), so distinct scans = transitions + 1
          int64_t obs = 1;
          int64_t prev = scan[ord[cell.start]];
          for (int64_t t = cell.start + 1; t < cell.start + cell.count; ++t) {
            int64_t s = scan[ord[t]];
            if (s != prev) {
              ++obs;
              prev = s;
            }
          }
          cls[c] = obs >= min_observers ? 1 : 0;
        } else if (layer < layer_limit) {
          cls[c] = 2;
        } else {
          cls[c] = 0;
        }
      }
    });

    // emit plane leaves (sequential id assignment, parallel fill)
    std::vector<int64_t> leaf_of_cell(n_cells, -1);
    for (int64_t c = 0; c < n_cells; ++c) {
      if (cls[c] != 1) continue;
      if (n_leaves >= max_leaves) {
        ++overflow;
        cls[c] = 0;
        continue;
      }
      leaf_of_cell[c] = n_leaves;
      leaf_center[3 * n_leaves + 0] = cent[3 * c + 0];
      leaf_center[3 * n_leaves + 1] = cent[3 * c + 1];
      leaf_center[3 * n_leaves + 2] = cent[3 * c + 2];
      leaf_layer[n_leaves] = layer;
      leaf_decision[n_leaves] = dec[c];
      ++n_leaves;
    }
    parallel_for(n_cells, [&](int64_t lo, int64_t hi) {
      for (int64_t c = lo; c < hi; ++c) {
        int64_t lid = leaf_of_cell[c];
        if (lid < 0) continue;
        const Cell& cell = cells[c];
        double* mom = moments + lid * n_scans * 16;
        std::memset(mom, 0, sizeof(double) * n_scans * 16);
        for (int64_t t = cell.start; t < cell.start + cell.count; ++t) {
          int64_t pi = ord[t];
          point_leaf[pi] = lid;
          const double* pb = body + 3 * pi;
          double x = pb[0], y = pb[1], z = pb[2];
          double* m = mom + scan[pi] * 16;   // 4x4 row-major
          m[0] += x * x;
          m[1] += x * y;
          m[2] += x * z;
          m[3] += x;
          m[5] += y * y;
          m[6] += y * z;
          m[7] += y;
          m[10] += z * z;
          m[11] += z;
          m[15] += 1.0;
        }
        // mirror the symmetric lower triangle
        for (int64_t s = 0; s < n_scans; ++s) {
          double* m = mom + s * 16;
          if (m[15] == 0.0) continue;
          m[4] = m[1];
          m[8] = m[2];
          m[9] = m[6];
          m[12] = m[3];
          m[13] = m[7];
          m[14] = m[11];
        }
        coe[lid] = unit_coe ? 1.0 : (double)cell.count;
      }
    });

    // subdivision: counting-split each splitting cell into its 8 octants
    if (layer >= layer_limit) break;
    std::vector<int64_t> split_ids;
    for (int64_t c = 0; c < n_cells; ++c)
      if (cls[c] == 2) split_ids.push_back(c);
    if (split_ids.empty()) break;

    // new compacted ord: assign output ranges per split cell
    std::vector<int64_t> out_start(split_ids.size() + 1, 0);
    for (size_t s = 0; s < split_ids.size(); ++s)
      out_start[s + 1] = out_start[s] + cells[split_ids[s]].count;
    int64_t n_active = out_start.back();

    next_cells.clear();
    std::vector<std::vector<Cell>> cell_parts(split_ids.size());
    parallel_for((int64_t)split_ids.size(), [&](int64_t lo, int64_t hi) {
      for (int64_t s = lo; s < hi; ++s) {
        const Cell& cell = cells[split_ids[s]];
        int64_t cnt[8] = {0};
        int64_t base = out_start[s];
        // count octants
        for (int64_t t = cell.start; t < cell.start + cell.count; ++t) {
          const double* pw = world + 3 * ord[t];
          int o = 4 * (pw[0] > cell.center[0]) + 2 * (pw[1] > cell.center[1]) +
                  (pw[2] > cell.center[2]);
          ++cnt[o];
        }
        int64_t pos[8];
        int64_t acc = base;
        for (int o = 0; o < 8; ++o) {
          pos[o] = acc;
          acc += cnt[o];
        }
        int64_t start_of[8];
        std::memcpy(start_of, pos, sizeof(pos));
        for (int64_t t = cell.start; t < cell.start + cell.count; ++t) {
          const double* pw = world + 3 * ord[t];
          int o = 4 * (pw[0] > cell.center[0]) + 2 * (pw[1] > cell.center[1]) +
                  (pw[2] > cell.center[2]);
          ord2[pos[o]++] = ord[t];
        }
        double q = half * 0.5;
        for (int o = 0; o < 8; ++o) {
          if (cnt[o] == 0) continue;
          Cell nc;
          nc.start = start_of[o];
          nc.count = cnt[o];
          nc.center[0] = cell.center[0] + ((o >> 2) & 1 ? q : -q);
          nc.center[1] = cell.center[1] + ((o >> 1) & 1 ? q : -q);
          nc.center[2] = cell.center[2] + (o & 1 ? q : -q);
          cell_parts[s].push_back(nc);
        }
      }
    });
    for (auto& part : cell_parts)
      next_cells.insert(next_cells.end(), part.begin(), part.end());

    cells.swap(next_cells);
    std::swap(ord, ord2);
    (void)n_active;
    half *= 0.5;
  }

  if (overflow.load() > 0) return -(n_leaves + overflow.load());
  return n_leaves;
}

}  // extern "C"
