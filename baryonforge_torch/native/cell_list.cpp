// Periodic cell-list fixed-radius neighbour search in 3D (host code).
//
// The port's counterpart of the cell list of
// baryonforge_tpu/native/kernels.cpp:87-164 (build_cells, pdist2,
// cell_query). A particle is a neighbour of query q when its minimum-image
// distance to the query's centre, taken as there (one wrap per axis, then
// d^2 <= r_q^2), is at most r_q; the sets found are the same. What differs:
//
//  * Each cell is visited once. The JAX package walks the offsets -reach ..
//    reach on each axis and takes them mod ncell (kernels.cpp:147-153); when
//    2 reach + 1 > ncell (there ncell = floor(L / rmax) = 2 once rmax > L /
//    3) two offsets land on one cell, and its particles are counted, and
//    displaced, twice or more. Here an axis whose window covers the box
//    walks every cell of it once.
//  * The cells are sized by the median radius, not the largest, and each
//    query walks only the cells its own radius reaches; the particles are
//    stored cell by cell (a counting sort), so a cell is one contiguous run.
//    The JAX list sizes every cell and every walk by the catalog's largest
//    radius and chases a linked list through the positions.
//  * One pass, with the queries split over threads in contiguous ranges:
//    the neighbours are handed out grouped by query (CSR), in query order,
//    instead of a counting pass and a second, padded pass.
//
// Built with g++ at first use and bound with ctypes (native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct CellList {
  std::vector<int64_t> start;  // ncell^3 + 1: the run of each cell
  std::vector<double> pos;     // (n, 3) positions, cell by cell
  std::vector<int32_t> orig;   // (n,) their indices in the input
  int64_t ncell;
  double L, cell;
};

inline int64_t cell_of(double x, const CellList& cl) {
  int64_t c = (int64_t)(x / cl.cell) % cl.ncell;
  return c < 0 ? c + cl.ncell : c;
}

CellList build_cells(const double* pos, int64_t n, double L, double size) {
  CellList cl;
  cl.L = L;
  // at most 256 cells an axis, and at most ~8 per particle
  const int64_t cap = std::min<int64_t>(
      256, (int64_t)std::cbrt(8.0 * (double)std::max<int64_t>(n, 1)) + 1);
  cl.ncell = std::max<int64_t>(1, (int64_t)std::floor(L / size));
  cl.ncell = std::min<int64_t>(cl.ncell, cap);
  cl.cell = L / (double)cl.ncell;
  const int64_t nc = cl.ncell * cl.ncell * cl.ncell;
  std::vector<int64_t> cid(n);
  cl.start.assign(nc + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    cid[i] = (cell_of(pos[3 * i], cl) * cl.ncell + cell_of(pos[3 * i + 1], cl))
                 * cl.ncell + cell_of(pos[3 * i + 2], cl);
    ++cl.start[cid[i] + 1];
  }
  for (int64_t c = 0; c < nc; ++c) cl.start[c + 1] += cl.start[c];
  std::vector<int64_t> fill(cl.start.begin(), cl.start.end() - 1);
  cl.pos.resize(3 * n);
  cl.orig.resize(n);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t k = fill[cid[i]]++;
    for (int d = 0; d < 3; ++d) cl.pos[3 * k + d] = pos[3 * i + d];
    cl.orig[k] = (int32_t)i;
  }
  return cl;
}

inline double pdist2(const double* a, const double* b, double L) {
  double d2 = 0;
  for (int k = 0; k < 3; ++k) {
    double d = a[k] - b[k];
    if (d > L / 2) d -= L;
    if (d < -L / 2) d += L;
    d2 += d * d;
  }
  return d2;
}

// the distinct cells of one axis within `reach` of cell c: every cell of
// the axis, each once, when the window wraps onto itself
int axis_cells(int64_t c, int64_t reach, int64_t ncell, int64_t* out) {
  if (2 * reach + 1 >= ncell) {
    for (int64_t g = 0; g < ncell; ++g) out[g] = g;
    return (int)ncell;
  }
  int k = 0;
  for (int64_t d = -reach; d <= reach; ++d)
    out[k++] = ((c + d) % ncell + ncell) % ncell;
  return k;
}

// queries [q0, q1) into counts and idx
void query_range(const CellList& cl, const double* centers,
                 const double* radii, int64_t q0, int64_t q1, int64_t* counts,
                 std::vector<int32_t>* idx) {
  std::vector<int64_t> gx(cl.ncell + 1), gy(cl.ncell + 1), gz(cl.ncell + 1);
  for (int64_t q = q0; q < q1; ++q) {
    const double* c = &centers[3 * q];
    const double r2 = radii[q] * radii[q];
    // floor(r / cell) + 1 >= ceil(r / cell): the cells a point within r of
    // c can lie in
    const int64_t reach = (int64_t)(radii[q] / cl.cell) + 1;
    const int nx = axis_cells((int64_t)(std::fmod(c[0], cl.L) / cl.cell),
                              std::min(reach, cl.ncell), cl.ncell, gx.data());
    const int ny = axis_cells((int64_t)(std::fmod(c[1], cl.L) / cl.cell),
                              std::min(reach, cl.ncell), cl.ncell, gy.data());
    const int nz = axis_cells((int64_t)(std::fmod(c[2], cl.L) / cl.cell),
                              std::min(reach, cl.ncell), cl.ncell, gz.data());
    int64_t cnt = 0;
    for (int a = 0; a < nx; ++a)
      for (int b = 0; b < ny; ++b)
        for (int e = 0; e < nz; ++e) {
          const int64_t cell = (gx[a] * cl.ncell + gy[b]) * cl.ncell + gz[e];
          for (int64_t k = cl.start[cell]; k < cl.start[cell + 1]; ++k) {
            if (pdist2(&cl.pos[3 * k], c, cl.L) <= r2) {
              idx->push_back(cl.orig[k]);
              ++cnt;
            }
          }
        }
    counts[q] = cnt;
  }
}

struct Neighbours {
  std::vector<std::vector<int32_t>> parts;  // one per thread, query order
};

}  // namespace

extern "C" {

// Neighbours within radii[q] of centers[q] (positions and centres in [0,
// L)) for every query q, on `threads` threads, with cells of about `size`
// a side: fills counts (nq) and returns a handle holding the particle
// indices of query 0, then of query 1, ...; copy them out with
// bf_cell_query_fetch and release the handle with bf_cell_query_free.
void* bf_cell_query(const double* pos, int64_t n, double L,
                    const double* centers, const double* radii, int64_t nq,
                    double size, int threads, int64_t* counts) {
  const CellList cl = build_cells(pos, n, L, size);
  const int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, nq));
  Neighbours* nb = new Neighbours();
  nb->parts.resize(nt);
  std::vector<std::thread> pool;
  for (int t = 0; t < nt; ++t) {
    const int64_t q0 = nq * t / nt, q1 = nq * (t + 1) / nt;
    pool.emplace_back(query_range, std::cref(cl), centers, radii, q0, q1,
                      counts, &nb->parts[t]);
  }
  for (auto& th : pool) th.join();
  return nb;
}

void bf_cell_query_fetch(void* handle, int32_t* out) {
  const Neighbours* nb = static_cast<const Neighbours*>(handle);
  for (const auto& part : nb->parts)
    out = std::copy(part.begin(), part.end(), out);
}

void bf_cell_query_free(void* handle) {
  delete static_cast<Neighbours*>(handle);
}

}  // extern "C"
