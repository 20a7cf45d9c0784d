// Host-side mesh kernels, with a plain C interface for ctypes.
//
//   ptm_distance       — exact point-to-triangle-mesh squared distances in
//                        double precision: the oracle the port's float32
//                        point_to_mesh_distance is held against (kaolin
//                        0.9.1's metric, reference ico_utils.py:26-44)
//   self_intersections — triangle-triangle self-intersection pairs via a
//                        uniform spatial hash + Moller '97 interval test
//                        (the explorer's "selfintersection" coloring;
//                        replaces PyMesh detect_self_intersection, reference
//                        visualizer_utils.py:50-58)
//
// Pairs sharing any vertex index are excluded (mesh-adjacent triangles
// always touch along shared simplices).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

static inline double dot3(const double* a, const double* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---------------------------------------------------------------------------
// point -> mesh distance (exact, double precision)
// ---------------------------------------------------------------------------

static double point_tri_sq(const double* p, const double* a, const double* b,
                           const double* c) {
  // Ericson, Real-Time Collision Detection §5.1.5 (closest point on triangle)
  double ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  double ac[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  double ap[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
  double d1 = dot3(ab, ap), d2 = dot3(ac, ap);
  if (d1 <= 0.0 && d2 <= 0.0) {
    return dot3(ap, ap);
  }
  double bp[3] = {p[0] - b[0], p[1] - b[1], p[2] - b[2]};
  double d3 = dot3(ab, bp), d4 = dot3(ac, bp);
  if (d3 >= 0.0 && d4 <= d3) {
    return dot3(bp, bp);
  }
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0.0 && d1 >= 0.0 && d3 <= 0.0) {
    double t = d1 / (d1 - d3);
    double q[3] = {a[0] + t * ab[0] - p[0], a[1] + t * ab[1] - p[1],
                   a[2] + t * ab[2] - p[2]};
    return dot3(q, q);
  }
  double cp[3] = {p[0] - c[0], p[1] - c[1], p[2] - c[2]};
  double d5 = dot3(ab, cp), d6 = dot3(ac, cp);
  if (d6 >= 0.0 && d5 <= d6) {
    return dot3(cp, cp);
  }
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0.0 && d2 >= 0.0 && d6 <= 0.0) {
    double t = d2 / (d2 - d6);
    double q[3] = {a[0] + t * ac[0] - p[0], a[1] + t * ac[1] - p[1],
                   a[2] + t * ac[2] - p[2]};
    return dot3(q, q);
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0.0 && (d4 - d3) >= 0.0 && (d5 - d6) >= 0.0) {
    double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    double q[3] = {b[0] + t * (c[0] - b[0]) - p[0], b[1] + t * (c[1] - b[1]) - p[1],
                   b[2] + t * (c[2] - b[2]) - p[2]};
    return dot3(q, q);
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  double q[3] = {a[0] + ab[0] * v + ac[0] * w - p[0],
                 a[1] + ab[1] * v + ac[1] * w - p[1],
                 a[2] + ab[2] * v + ac[2] * w - p[2]};
  return dot3(q, q);
}

void ptm_distance(const float* points, int n_points, const float* verts,
                  int n_verts, const int* faces, int n_faces, float* out_sq) {
  (void)n_verts;
  std::vector<double> tri(n_faces * 9);
  for (int f = 0; f < n_faces; ++f) {
    for (int k = 0; k < 3; ++k) {
      const float* v = verts + 3 * faces[3 * f + k];
      tri[9 * f + 3 * k + 0] = v[0];
      tri[9 * f + 3 * k + 1] = v[1];
      tri[9 * f + 3 * k + 2] = v[2];
    }
  }
  for (int i = 0; i < n_points; ++i) {
    double p[3] = {points[3 * i], points[3 * i + 1], points[3 * i + 2]};
    double best = 1e300;
    for (int f = 0; f < n_faces; ++f) {
      const double* t = tri.data() + 9 * f;
      double d = point_tri_sq(p, t, t + 3, t + 6);
      if (d < best) best = d;
    }
    out_sq[i] = static_cast<float>(best);
  }
}

// ---------------------------------------------------------------------------
// self intersection: Möller '97 triangle-triangle test
// ---------------------------------------------------------------------------

static inline void cross3(const double* a, const double* b, double* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

static inline void sub3(const double* a, const double* b, double* o) {
  o[0] = a[0] - b[0];
  o[1] = a[1] - b[1];
  o[2] = a[2] - b[2];
}

// interval of triangle (v0,v1,v2) with signed dists (d0,d1,d2) projected on
// axis p (projections p0,p1,p2). Requires not all d same sign (pre-checked).
static bool tri_interval(double p0, double p1, double p2, double d0, double d1,
                         double d2, double* t1, double* t2) {
  // arrange so v0, v1 on one side, v2 on the other (or v2 on plane)
  double pp0 = p0, pp1 = p1, pp2 = p2, dd0 = d0, dd1 = d1, dd2 = d2;
  if (d0 * d1 > 0.0) {
    // 2 on same side: v2 alone
  } else if (d0 * d2 > 0.0) {
    std::swap(pp1, pp2);
    std::swap(dd1, dd2);
  } else if (d1 * d2 > 0.0 || d0 != 0.0) {
    std::swap(pp0, pp2);
    std::swap(dd0, dd2);
  } else if (d1 != 0.0) {
    std::swap(pp1, pp2);
    std::swap(dd1, dd2);
  }
  // now dd2 is the lone side (or the only nonzero)
  double denom0 = dd0 - dd2, denom1 = dd1 - dd2;
  *t1 = (std::abs(denom0) > 1e-300) ? pp0 + (pp2 - pp0) * dd0 / denom0 : pp0;
  *t2 = (std::abs(denom1) > 1e-300) ? pp1 + (pp2 - pp1) * dd1 / denom1 : pp1;
  if (*t1 > *t2) std::swap(*t1, *t2);
  return true;
}

static bool coplanar_tri_tri(const double* n, const double* t0,
                             const double* t1) {
  // project onto the dominant axis plane and do 2D tri-tri overlap
  int i0, i1;
  double an[3] = {std::abs(n[0]), std::abs(n[1]), std::abs(n[2])};
  if (an[0] > an[1] && an[0] > an[2]) {
    i0 = 1; i1 = 2;
  } else if (an[1] > an[2]) {
    i0 = 0; i1 = 2;
  } else {
    i0 = 0; i1 = 1;
  }
  auto edge_edge = [&](const double* a, const double* b, const double* c,
                       const double* d) {
    double ax = b[i0] - a[i0], ay = b[i1] - a[i1];
    double bx = c[i0] - d[i0], by = c[i1] - d[i1];
    double cx = a[i0] - c[i0], cy = a[i1] - c[i1];
    double f = ay * bx - ax * by;
    double dd = by * cx - bx * cy;
    if ((f > 0 && dd >= 0 && dd <= f) || (f < 0 && dd <= 0 && dd >= f)) {
      double e = ax * cy - ay * cx;
      if (f > 0) return e >= 0 && e <= f;
      return e <= 0 && e >= f;
    }
    return false;
  };
  auto point_in_tri = [&](const double* p, const double* a, const double* b,
                          const double* c) {
    double s0 = (b[i0] - a[i0]) * (p[i1] - a[i1]) - (b[i1] - a[i1]) * (p[i0] - a[i0]);
    double s1 = (c[i0] - b[i0]) * (p[i1] - b[i1]) - (c[i1] - b[i1]) * (p[i0] - b[i0]);
    double s2 = (a[i0] - c[i0]) * (p[i1] - c[i1]) - (a[i1] - c[i1]) * (p[i0] - c[i0]);
    return (s0 >= 0 && s1 >= 0 && s2 >= 0) || (s0 <= 0 && s1 <= 0 && s2 <= 0);
  };
  const double* e0[3] = {t0, t0 + 3, t0 + 6};
  const double* e1[3] = {t1, t1 + 3, t1 + 6};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      if (edge_edge(e0[i], e0[(i + 1) % 3], e1[j], e1[(j + 1) % 3])) return true;
  return point_in_tri(t0, t1, t1 + 3, t1 + 6) ||
         point_in_tri(t1, t0, t0 + 3, t0 + 6);
}

static bool tri_tri_intersect(const double* t0, const double* t1) {
  const double EPS = 1e-12;
  double e1[3], e2[3], n1[3];
  sub3(t0 + 3, t0, e1);
  sub3(t0 + 6, t0, e2);
  cross3(e1, e2, n1);
  double d1 = -dot3(n1, t0);
  double du0 = dot3(n1, t1) + d1;
  double du1 = dot3(n1, t1 + 3) + d1;
  double du2 = dot3(n1, t1 + 6) + d1;
  if (std::abs(du0) < EPS) du0 = 0.0;
  if (std::abs(du1) < EPS) du1 = 0.0;
  if (std::abs(du2) < EPS) du2 = 0.0;
  if (du0 * du1 > 0.0 && du0 * du2 > 0.0) return false;

  double f1[3], f2[3], n2[3];
  sub3(t1 + 3, t1, f1);
  sub3(t1 + 6, t1, f2);
  cross3(f1, f2, n2);
  double d2 = -dot3(n2, t1);
  double dv0 = dot3(n2, t0) + d2;
  double dv1 = dot3(n2, t0 + 3) + d2;
  double dv2 = dot3(n2, t0 + 6) + d2;
  if (std::abs(dv0) < EPS) dv0 = 0.0;
  if (std::abs(dv1) < EPS) dv1 = 0.0;
  if (std::abs(dv2) < EPS) dv2 = 0.0;
  if (dv0 * dv1 > 0.0 && dv0 * dv2 > 0.0) return false;

  double dir[3];
  cross3(n1, n2, dir);
  double ad[3] = {std::abs(dir[0]), std::abs(dir[1]), std::abs(dir[2])};
  int axis = 0;
  if (ad[1] > ad[0]) axis = 1;
  if (ad[2] > ad[axis]) axis = 2;
  double mx = ad[axis];
  if (mx < EPS) {
    // coplanar
    return coplanar_tri_tri(n1, t0, t1);
  }
  double vp0 = t0[axis], vp1 = t0[3 + axis], vp2 = t0[6 + axis];
  double up0 = t1[axis], up1 = t1[3 + axis], up2 = t1[6 + axis];
  double isect1[2], isect2[2];
  tri_interval(vp0, vp1, vp2, dv0, dv1, dv2, &isect1[0], &isect1[1]);
  tri_interval(up0, up1, up2, du0, du1, du2, &isect2[0], &isect2[1]);
  return !(isect1[1] < isect2[0] || isect2[1] < isect1[0]);
}

// Returns number of intersecting pairs found (clamped to max_pairs written).
int self_intersections(const float* verts, int n_verts, const int* faces,
                       int n_faces, int* out_pairs, int max_pairs) {
  (void)n_verts;
  // triangle AABBs + uniform grid binning
  std::vector<double> tri(n_faces * 9);
  std::vector<double> lo(n_faces * 3), hi(n_faces * 3);
  double gmin[3] = {1e300, 1e300, 1e300}, gmax[3] = {-1e300, -1e300, -1e300};
  for (int f = 0; f < n_faces; ++f) {
    for (int k = 0; k < 3; ++k) {
      const float* v = verts + 3 * faces[3 * f + k];
      for (int c = 0; c < 3; ++c) tri[9 * f + 3 * k + c] = v[c];
    }
    for (int c = 0; c < 3; ++c) {
      double a = tri[9 * f + c], b = tri[9 * f + 3 + c], d = tri[9 * f + 6 + c];
      lo[3 * f + c] = std::min(a, std::min(b, d));
      hi[3 * f + c] = std::max(a, std::max(b, d));
      gmin[c] = std::min(gmin[c], lo[3 * f + c]);
      gmax[c] = std::max(gmax[c], hi[3 * f + c]);
    }
  }
  // grid resolution ~ cbrt(n_faces)
  int res = std::max(1, (int)std::cbrt((double)n_faces));
  double cell[3], inv[3];
  for (int c = 0; c < 3; ++c) {
    double span = std::max(gmax[c] - gmin[c], 1e-12);
    cell[c] = span / res;
    inv[c] = 1.0 / cell[c];
  }
  auto clampi = [&](int x) { return std::max(0, std::min(res - 1, x)); };
  std::unordered_map<int64_t, std::vector<int>> bins;
  auto key = [&](int x, int y, int z) {
    return ((int64_t)x << 40) | ((int64_t)y << 20) | (int64_t)z;
  };
  for (int f = 0; f < n_faces; ++f) {
    int x0 = clampi((int)((lo[3 * f] - gmin[0]) * inv[0]));
    int x1 = clampi((int)((hi[3 * f] - gmin[0]) * inv[0]));
    int y0 = clampi((int)((lo[3 * f + 1] - gmin[1]) * inv[1]));
    int y1 = clampi((int)((hi[3 * f + 1] - gmin[1]) * inv[1]));
    int z0 = clampi((int)((lo[3 * f + 2] - gmin[2]) * inv[2]));
    int z1 = clampi((int)((hi[3 * f + 2] - gmin[2]) * inv[2]));
    for (int x = x0; x <= x1; ++x)
      for (int y = y0; y <= y1; ++y)
        for (int z = z0; z <= z1; ++z) bins[key(x, y, z)].push_back(f);
  }
  auto share_vertex = [&](int f, int g) {
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        if (faces[3 * f + i] == faces[3 * g + j]) return true;
    return false;
  };
  auto aabb_overlap = [&](int f, int g) {
    for (int c = 0; c < 3; ++c)
      if (hi[3 * f + c] < lo[3 * g + c] || hi[3 * g + c] < lo[3 * f + c])
        return false;
    return true;
  };
  std::vector<std::pair<int, int>> found;
  std::unordered_map<int64_t, bool> seen;
  for (auto& kv : bins) {
    auto& v = kv.second;
    for (size_t i = 0; i < v.size(); ++i) {
      for (size_t j = i + 1; j < v.size(); ++j) {
        int f = std::min(v[i], v[j]), g = std::max(v[i], v[j]);
        if (f == g) continue;
        int64_t pk = ((int64_t)f << 32) | g;
        if (seen.count(pk)) continue;
        seen[pk] = true;
        if (share_vertex(f, g) || !aabb_overlap(f, g)) continue;
        if (tri_tri_intersect(tri.data() + 9 * f, tri.data() + 9 * g)) {
          found.emplace_back(f, g);
        }
      }
    }
  }
  std::sort(found.begin(), found.end());
  int n = (int)found.size();
  int nw = std::min(n, max_pairs);
  for (int i = 0; i < nw; ++i) {
    out_pairs[2 * i] = found[i].first;
    out_pairs[2 * i + 1] = found[i].second;
  }
  return n;
}

}  // extern "C"
