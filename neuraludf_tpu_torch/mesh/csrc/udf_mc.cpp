// udf_mc.cpp — native marching-cubes engine for unsigned distance fields.
//
// TPU-native framework's host-side mesh extractor. Re-designed (not ported)
// from the reference's Cython MeshUDF implementation
// (ref: custom_mc/_marching_cubes_lewiner_cy.pyx:1115-1773):
//
//   * pseudo-sign assignment: BFS over "active" cubes (avg corner UDF <
//     1.05*voxel and max < 1.74*voxel), per-corner 6-direction neighbor
//     voting weighted by gradient agreement (edge votes), anchor-gradient
//     fallback, an "unsure" low-confidence queue (|vote|/n < 0.707) whose
//     cubes are re-visited after their neighbors, and a deferred queue for
//     topologically ambiguous sign configurations;
//   * a connectivity gate for BFS cubes: faces are only emitted when the
//     cube's surface patch shares >= 2 vertices with already-built surface
//     (the reference gates on check_the_big_switch >= 2, which counts
//     face-layer vertex reuse);
//   * triangulation selectable at call time (`algorithm` parameter):
//       0 = marching tetrahedra (6-tet cube split sharing the main
//           diagonal): unambiguous by construction, no lookup tables,
//           same inverse-|value| edge interpolation as the reference Cell
//           (ref: _marching_cubes_lewiner_cy.pyx:640-661);
//       1 = Lewiner tables (lewiner.cpp): the reference's topology engine
//           — full 15-case dispatch with face/interior saddle tests
//           (ref: _marching_cubes_lewiner_cy.pyx:1847-2569), including
//           the interpolated center vertex (ref: .pyx:806-851).
//
// Exposed as a plain C ABI for ctypes.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 udf_mc.cpp lewiner.cpp -o libudf_mc.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <deque>
#include <unordered_map>
#include <vector>

#include "lewiner.h"

namespace {

struct MeshBuilder {
  std::vector<float> verts;           // xyz triplets, grid-index units
  std::vector<int32_t> faces;         // vertex-index triplets
  std::unordered_map<uint64_t, int32_t> edge_vertex;  // global edge -> vertex

  int32_t vertex_on_edge(uint64_t gid_a, uint64_t gid_b,
                         const float* pa, const float* pb,
                         float va, float vb) {
    uint64_t key = gid_a < gid_b ? (gid_a << 32) | gid_b : (gid_b << 32) | gid_a;
    auto it = edge_vertex.find(key);
    if (it != edge_vertex.end()) return it->second;
    // inverse-|value| weighting == linear zero crossing
    float wa = 1.0f / (1e-12f + std::fabs(va));
    float wb = 1.0f / (1e-12f + std::fabs(vb));
    float s = wa + wb;
    int32_t idx = (int32_t)(verts.size() / 3);
    verts.push_back((pa[0] * wa + pb[0] * wb) / s);
    verts.push_back((pa[1] * wa + pb[1] * wb) / s);
    verts.push_back((pa[2] * wa + pb[2] * wb) / s);
    edge_vertex.emplace(key, idx);
    return idx;
  }

  bool edge_vertex_exists(uint64_t gid_a, uint64_t gid_b) const {
    uint64_t key = gid_a < gid_b ? (gid_a << 32) | gid_b : (gid_b << 32) | gid_a;
    return edge_vertex.count(key) != 0;
  }

  void add_tri(int32_t a, int32_t b, int32_t c, const float* dir) {
    // orient so the face normal points along `dir` (toward the positive side)
    const float* pa = &verts[3 * a];
    const float* pb = &verts[3 * b];
    const float* pc = &verts[3 * c];
    float u[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
    float v[3] = {pc[0] - pa[0], pc[1] - pa[1], pc[2] - pa[2]};
    float n[3] = {u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2],
                  u[0] * v[1] - u[1] * v[0]};
    float d = n[0] * dir[0] + n[1] * dir[1] + n[2] * dir[2];
    if (d < 0) {
      faces.push_back(a); faces.push_back(c); faces.push_back(b);
    } else {
      faces.push_back(a); faces.push_back(b); faces.push_back(c);
    }
  }
};

// cube corner offsets, index order used throughout
// 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0) 4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
static const int CUBE[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// 6 tetrahedra sharing the main diagonal 0-6 (translation-invariant split,
// so shared face diagonals are consistent between neighboring cubes)
static const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

struct Grid {
  const float* im;
  const float* grads;  // [N0,N1,N2,3] or nullptr
  int64_t n0, n1, n2;
  inline int64_t gid(int64_t a, int64_t b, int64_t c) const {
    return (a * n1 + b) * n2 + c;
  }
  inline float v(int64_t a, int64_t b, int64_t c) const { return im[gid(a, b, c)]; }
  inline const float* g(int64_t a, int64_t b, int64_t c) const {
    return grads + 3 * gid(a, b, c);
  }
};

// Emit marching-tetrahedra triangles for one cube given signed corner values.
// `gate_min_shared` >= 0 activates the connectivity gate: the cube is only
// triangulated when >= gate_min_shared of its would-be vertices already
// exist. Returns true if triangles were emitted (or would be, for dry runs).
static bool triangulate_cube(MeshBuilder& mb, const Grid& G,
                             int64_t a, int64_t b, int64_t c,
                             const float sv[8], int gate_min_shared) {
  float corner_pos[8][3];
  uint64_t corner_gid[8];
  for (int i = 0; i < 8; i++) {
    corner_pos[i][0] = (float)(a + CUBE[i][0]);
    corner_pos[i][1] = (float)(b + CUBE[i][1]);
    corner_pos[i][2] = (float)(c + CUBE[i][2]);
    corner_gid[i] = (uint64_t)G.gid(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]);
  }

  if (gate_min_shared > 0) {
    // count DISTINCT already-existing surface vertices this cube would
    // reuse (the reference's check_triangles dedups face-layer vertices)
    int shared = 0;
    uint64_t seen[24];  // 12 cube edges + 6 face diagonals + main diagonal
    int n_seen = 0;
    for (int t = 0; t < 6 && shared < gate_min_shared; t++) {
      const int* T = TETS[t];
      for (int e = 0; e < 6; e++) {
        static const int TE[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
        int i = T[TE[e][0]], j = T[TE[e][1]];
        bool pi = sv[i] >= 0, pj = sv[j] >= 0;
        if (pi == pj) continue;
        uint64_t a = corner_gid[i], b = corner_gid[j];
        uint64_t key = a < b ? (a << 32) | b : (b << 32) | a;
        bool dup = false;
        for (int s = 0; s < n_seen; s++)
          if (seen[s] == key) { dup = true; break; }
        if (dup) continue;
        if (n_seen < 24) seen[n_seen++] = key;
        if (mb.edge_vertex_exists(a, b)) shared++;
      }
    }
    if (shared < gate_min_shared) return false;
  }

  bool emitted = false;
  for (int t = 0; t < 6; t++) {
    const int* T = TETS[t];
    int pos[4], neg[4], np = 0, nn = 0;
    for (int k = 0; k < 4; k++) {
      if (sv[T[k]] >= 0) pos[np++] = T[k];
      else neg[nn++] = T[k];
    }
    if (np == 0 || np == 4) continue;

    // direction from negative centroid toward positive centroid: the
    // signed field increases along it; faces oriented to match
    float dir[3] = {0, 0, 0};
    for (int k = 0; k < np; k++)
      for (int d = 0; d < 3; d++) dir[d] += corner_pos[pos[k]][d] / np;
    for (int k = 0; k < nn; k++)
      for (int d = 0; d < 3; d++) dir[d] -= corner_pos[neg[k]][d] / nn;

    auto V = [&](int i, int j) {
      return mb.vertex_on_edge(corner_gid[i], corner_gid[j],
                               corner_pos[i], corner_pos[j], sv[i], sv[j]);
    };

    if (np == 1) {  // one positive apex: single triangle
      int32_t v0 = V(pos[0], neg[0]);
      int32_t v1 = V(pos[0], neg[1]);
      int32_t v2 = V(pos[0], neg[2]);
      mb.add_tri(v0, v1, v2, dir);
      emitted = true;
    } else if (nn == 1) {  // one negative apex
      int32_t v0 = V(pos[0], neg[0]);
      int32_t v1 = V(pos[1], neg[0]);
      int32_t v2 = V(pos[2], neg[0]);
      mb.add_tri(v0, v1, v2, dir);
      emitted = true;
    } else {  // 2-2 split: quad as two triangles
      int32_t v00 = V(pos[0], neg[0]);
      int32_t v01 = V(pos[0], neg[1]);
      int32_t v10 = V(pos[1], neg[0]);
      int32_t v11 = V(pos[1], neg[1]);
      mb.add_tri(v00, v01, v11, dir);
      mb.add_tri(v00, v11, v10, dir);
      emitted = true;
    }
  }
  return emitted;
}

// Lewiner-table triangulation of one cube (algorithm=1). Same gate and
// vertex-dedup machinery as the tets path; the tiling (including ambiguous
// configs and the interpolated center vertex, vi==12) comes from
// lewiner_engine::tile_cube. Triangles are oriented per-triangle along the
// trilinear field gradient at the triangle centroid (normals toward the
// positive side), making the two backends' conventions identical.
static bool triangulate_cube_lewiner(MeshBuilder& mb, const Grid& G,
                                     int64_t a, int64_t b, int64_t c,
                                     const float sv[8], int gate_min_shared) {
  double svd[8];
  for (int i = 0; i < 8; i++) svd[i] = sv[i];
  int8_t tris[36];
  int nt = lewiner_engine::tile_cube(svd, tris);
  if (nt == 0) return false;

  float corner_pos[8][3];
  uint64_t corner_gid[8];
  for (int i = 0; i < 8; i++) {
    corner_pos[i][0] = (float)(a + CUBE[i][0]);
    corner_pos[i][1] = (float)(b + CUBE[i][1]);
    corner_pos[i][2] = (float)(c + CUBE[i][2]);
    corner_gid[i] = (uint64_t)G.gid(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]);
  }

  if (gate_min_shared > 0) {
    int shared = 0;
    uint64_t seen[13];
    int n_seen = 0;
    for (int k = 0; k < 3 * nt && shared < gate_min_shared; k++) {
      int vi = tris[k];
      if (vi == 12) continue;  // center vertex is cube-local, never shared
      uint64_t ga = corner_gid[lewiner_engine::EDGE_CORNERS[vi][0]];
      uint64_t gb = corner_gid[lewiner_engine::EDGE_CORNERS[vi][1]];
      uint64_t key = ga < gb ? (ga << 32) | gb : (gb << 32) | ga;
      bool dup = false;
      for (int s = 0; s < n_seen; s++)
        if (seen[s] == key) { dup = true; break; }
      if (dup) continue;
      if (n_seen < 13) seen[n_seen++] = key;
      if (mb.edge_vertex_exists(ga, gb)) shared++;
    }
    if (shared < gate_min_shared) return false;
  }

  // cube-local center vertex: inverse-|value| centroid of the 8 corners
  // (ref: _marching_cubes_lewiner_cy.pyx:806-838)
  int32_t center_idx = -1;
  auto center_vertex = [&]() -> int32_t {
    if (center_idx >= 0) return center_idx;
    float fx = 0, fy = 0, fz = 0, ff = 0;
    for (int i = 0; i < 8; i++) {
      float w = 1.0f / (1e-12f + std::fabs(sv[i]));
      fx += CUBE[i][0] * w;
      fy += CUBE[i][1] * w;
      fz += CUBE[i][2] * w;
      ff += w;
    }
    center_idx = (int32_t)(mb.verts.size() / 3);
    mb.verts.push_back((float)a + fx / ff);
    mb.verts.push_back((float)b + fy / ff);
    mb.verts.push_back((float)c + fz / ff);
    return center_idx;
  };

  auto get_vertex = [&](int vi) -> int32_t {
    if (vi == 12) return center_vertex();
    int i = lewiner_engine::EDGE_CORNERS[vi][0];
    int j = lewiner_engine::EDGE_CORNERS[vi][1];
    return mb.vertex_on_edge(corner_gid[i], corner_gid[j],
                             corner_pos[i], corner_pos[j], sv[i], sv[j]);
  };

  // gradient of the trilinear interpolant of sv at local point (x, y, z)
  auto trilinear_grad = [&](float x, float y, float z, float g[3]) {
    g[0] = g[1] = g[2] = 0.0f;
    for (int i = 0; i < 8; i++) {
      float bx = CUBE[i][0] ? x : 1.0f - x;
      float by = CUBE[i][1] ? y : 1.0f - y;
      float bz = CUBE[i][2] ? z : 1.0f - z;
      float sx = CUBE[i][0] ? 1.0f : -1.0f;
      float sy = CUBE[i][1] ? 1.0f : -1.0f;
      float sz = CUBE[i][2] ? 1.0f : -1.0f;
      g[0] += sv[i] * sx * by * bz;
      g[1] += sv[i] * bx * sy * bz;
      g[2] += sv[i] * bx * by * sz;
    }
  };

  for (int t = 0; t < nt; t++) {
    int32_t v0 = get_vertex(tris[3 * t + 0]);
    int32_t v1 = get_vertex(tris[3 * t + 1]);
    int32_t v2 = get_vertex(tris[3 * t + 2]);
    if (v0 == v1 || v1 == v2 || v0 == v2) continue;  // degenerate tile edge
    float cx = (mb.verts[3 * v0] + mb.verts[3 * v1] + mb.verts[3 * v2]) / 3.0f - (float)a;
    float cy = (mb.verts[3 * v0 + 1] + mb.verts[3 * v1 + 1] + mb.verts[3 * v2 + 1]) / 3.0f - (float)b;
    float cz = (mb.verts[3 * v0 + 2] + mb.verts[3 * v1 + 2] + mb.verts[3 * v2 + 2]) / 3.0f - (float)c;
    float dir[3];
    trilinear_grad(cx, cy, cz, dir);
    mb.add_tri(v0, v1, v2, dir);
  }
  return true;
}

// algorithm: 0 = marching tetrahedra, 1 = Lewiner tables
static bool triangulate_dispatch(int algorithm, MeshBuilder& mb, const Grid& G,
                                 int64_t a, int64_t b, int64_t c,
                                 const float sv[8], int gate_min_shared) {
  if (algorithm == 1)
    return triangulate_cube_lewiner(mb, G, a, b, c, sv, gate_min_shared);
  return triangulate_cube(mb, G, a, b, c, sv, gate_min_shared);
}

static inline float my_sign(float x) { return x > 0 ? 1.0f : (x < 0 ? -1.0f : 0.0f); }

static inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

static inline bool non_zero_norm(const float* g) {
  return std::fabs(g[0]) + std::fabs(g[1]) + std::fabs(g[2]) > 0.0f;
}

// Edge vote between vertex gradients along a walk direction
// (ref: _marching_cubes_lewiner_cy.pyx:1776-1806): opposing gradient
// components across the surface vote "same sign region boundary crossed".
static float edge_vote(const float* g1, const float* g2, int axis, int dir) {
  float p1 = g1[axis], p2 = g2[axis];
  if (dir > 0) {
    if (p2 > 0 && p1 < 0) return 1.0f;
  } else {
    if (p2 < 0 && p1 > 0) return 1.0f;
  }
  return dot3(g1, g2);
}

struct Coord { int64_t a, b, c; };

struct UdfMcState {
  Grid G;
  float voxel;
  int algo = 0;  // 0 = marching tets, 1 = Lewiner tables
  float avg_thresh, max_thresh;
  float unsure_thresh = 0.707f;
  std::vector<float> signed_im;
  std::vector<uint8_t> signed_mask;
  std::vector<uint8_t> visited;
  std::deque<Coord> q, uq, nq;
  MeshBuilder mb;

  bool active_cube(int64_t a, int64_t b, int64_t c) const {
    float s = 0, m = -1e30f;
    for (int i = 0; i < 8; i++) {
      float v = G.v(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]);
      s += v;
      if (v > m) m = v;
    }
    return (s * 0.125f < avg_thresh) && (m <= max_thresh);
  }

  void push_neighbors(int64_t a, int64_t b, int64_t c) {
    if (c + 1 < G.n2 - 1) q.push_back({a, b, c + 1});
    if (b + 1 < G.n1 - 1) q.push_back({a, b + 1, c});
    if (c - 1 >= 0) q.push_back({a, b, c - 1});
    if (b - 1 >= 0) q.push_back({a, b - 1, c});
    if (a - 1 >= 0) q.push_back({a - 1, b, c});
    if (a + 1 < G.n0 - 1) q.push_back({a + 1, b, c});
  }

  // Vote-based pseudo-sign assignment for the 8 cube corners.
  // Returns false when the cube should be requeued as "unsure"
  // (only meaningful when allow_unsure). Writes signs into signed_im.
  bool assign_signs(int64_t a, int64_t b, int64_t c, bool allow_unsure,
                    float sv[8], int n_votes[8]) {
    static const int AX_DIR[6][2] = {{0, 1}, {0, -1}, {1, 1}, {1, -1}, {2, 1}, {2, -1}};
    int64_t ci[8][3];
    for (int i = 0; i < 8; i++) {
      ci[i][0] = a + CUBE[i][0];
      ci[i][1] = b + CUBE[i][1];
      ci[i][2] = c + CUBE[i][2];
    }
    for (int i = 0; i < 8; i++) {
      int64_t va = ci[i][0], vb = ci[i][1], vc = ci[i][2];
      int64_t id = G.gid(va, vb, vc);
      n_votes[i] = 0;
      sv[i] = 0.0f;
      if (signed_mask[id]) {
        n_votes[i] = 1;
        sv[i] = signed_im[id];
        continue;
      }
      if (G.im[id] == 0.0f) {
        n_votes[i] = 1;  // counted as visited with sign 0, like the reference
        continue;
      }
      for (int d = 0; d < 6; d++) {
        int axis = AX_DIR[d][0], dir = AX_DIR[d][1];
        int max_dist = 1;
        for (int step = 1; step <= max_dist; step++) {
          int64_t na = va + (axis == 0 ? (int64_t)dir * step : 0);
          int64_t nb = vb + (axis == 1 ? (int64_t)dir * step : 0);
          int64_t nc = vc + (axis == 2 ? (int64_t)dir * step : 0);
          // bounds follow the reference: the walk stays within cube-origin
          // range [0, N-2] (ref: .pyx:1283-1285)
          if (na > G.n0 - 2 || na < 0 || nb > G.n1 - 2 || nb < 0 ||
              nc > G.n2 - 2 || nc < 0)
            break;
          int64_t nid = G.gid(na, nb, nc);
          if (G.im[nid] == 0.0f) { max_dist++; continue; }  // look further
          if (signed_im[nid] == 0.0f) continue;             // not computed yet
          n_votes[i] += 1;
          sv[i] += signed_im[nid] * edge_vote(G.g(va, vb, vc), G.g(na, nb, nc), axis, dir);
        }
      }
      if (allow_unsure && n_votes[i] >= 1 &&
          std::fabs(sv[i]) / n_votes[i] < unsure_thresh && !q.empty()) {
        return false;  // unsure — requeue cube
      }
      signed_im[id] = my_sign(sv[i]);
    }
    return true;
  }

  // Anchor-gradient fallback for corners with no votes
  // (ref: .pyx:1310-1374). Returns false to requeue as unsure (BFS phase).
  bool anchor_fallback(int64_t a, int64_t b, int64_t c, bool gate_unsure,
                       const int n_votes[8]) {
    bool all_voted = true;
    for (int i = 0; i < 8; i++)
      if (n_votes[i] < 1) all_voted = false;
    if (all_voted) return true;

    // reference visiting order of corners for the anchor search
    static const int ORDER[8] = {0, 1, 3, 2, 4, 5, 7, 6};
    float base[3] = {0, 0, 0};
    float anchor_sign = 1.0f;
    bool found = false;
    for (int pass = 0; pass < 2 && !found; pass++) {
      for (int oi = 0; oi < 8 && !found; oi++) {
        int i = ORDER[oi];
        int64_t id = G.gid(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]);
        const float* g = G.grads + 3 * id;
        bool masked = signed_mask[id];
        if (pass == 0 && masked && non_zero_norm(g)) {
          anchor_sign = my_sign(signed_im[id]);
          base[0] = g[0]; base[1] = g[1]; base[2] = g[2];
          found = true;
        } else if (pass == 1 && non_zero_norm(g)) {
          base[0] = g[0]; base[1] = g[1]; base[2] = g[2];
          found = true;
        }
      }
    }
    if (!found) return true;  // all-zero gradients; leave signs as-is
    base[0] *= anchor_sign; base[1] *= anchor_sign; base[2] *= anchor_sign;

    for (int i = 0; i < 8; i++) {
      if (n_votes[i] != 0) continue;
      int64_t id = G.gid(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]);
      float s = dot3(base, G.grads + 3 * id);
      if (gate_unsure && std::fabs(s) < unsure_thresh && !q.empty()) return false;
      signed_im[id] = my_sign(s);
    }
    return true;
  }

  void finalize_cube_signs(int64_t a, int64_t b, int64_t c, float sv_out[8]) {
    for (int i = 0; i < 8; i++) {
      int64_t id = G.gid(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]);
      sv_out[i] = signed_im[id] * G.im[id];
      signed_mask[id] = 1;
    }
  }

  bool has_crossing(const float sv[8]) const {
    bool any_neg = false, any_nonneg = false;
    for (int i = 0; i < 8; i++) {
      if (sv[i] < 0) any_neg = true; else any_nonneg = true;
    }
    return any_neg && any_nonneg;
  }

  // ambiguous sign configuration: the minority-sign corners are not a
  // connected subgraph of the cube — the analogue of the reference's
  // non-trivial Lewiner cases (case not in {1,2,5,8,9}, ref: .pyx:1747)
  bool nontrivial_config(const float sv[8]) const {
    static const int ADJ[8][3] = {{1, 3, 4}, {0, 2, 5}, {1, 3, 6}, {0, 2, 7},
                                  {0, 5, 7}, {1, 4, 6}, {2, 5, 7}, {3, 4, 6}};
    bool neg[8];
    int n_neg = 0;
    for (int i = 0; i < 8; i++) {
      neg[i] = sv[i] < 0;
      if (neg[i]) n_neg++;
    }
    bool minority_val = n_neg <= 4;  // true = analyse the negative set
    if (n_neg == 4) minority_val = true;
    int count = 0, start = -1;
    for (int i = 0; i < 8; i++)
      if (neg[i] == minority_val) { count++; if (start < 0) start = i; }
    if (count == 0) return false;
    // BFS over the cube graph within the minority set
    bool seen[8] = {false};
    int stack[8], sp = 0;
    stack[sp++] = start;
    seen[start] = true;
    int reached = 1;
    while (sp) {
      int u = stack[--sp];
      for (int k = 0; k < 3; k++) {
        int w = ADJ[u][k];
        if (!seen[w] && neg[w] == minority_val) {
          seen[w] = true;
          stack[sp++] = w;
          reached++;
        }
      }
    }
    return reached != count;
  }

  void run() {
    const int64_t A = G.n0 - 1, B = G.n1 - 1, C = G.n2 - 1;
    for (int64_t a0 = 0; a0 < A; a0++)
      for (int64_t b0 = 0; b0 < B; b0++)
        for (int64_t c0 = 0; c0 < C; c0++) {
          if (visited[(a0 * B + b0) * C + c0]) continue;
          if (!active_cube(a0, b0, c0)) continue;

          // seed cube: no unsure gating (ref: .pyx:1213-1423)
          float sv[8];
          int nv[8];
          assign_signs(a0, b0, c0, /*allow_unsure=*/false, sv, nv);
          anchor_fallback(a0, b0, c0, /*gate_unsure=*/false, nv);
          float svv[8];
          finalize_cube_signs(a0, b0, c0, svv);
          visited[(a0 * B + b0) * C + c0] = 1;
          if (has_crossing(svv)) {
            triangulate_dispatch(algo, mb, G, a0, b0, c0, svv, /*gate=*/0);
            push_neighbors(a0, b0, c0);
          } else {
            continue;
          }

          // breadth-first exploration (ref: .pyx:1430-1771)
          bool ucvn = true;  // unsure_cases_visit_neighbours
          while (!q.empty() || !uq.empty() || !nq.empty()) {
            Coord cur;
            if (q.empty()) {
              if (uq.empty()) {
                cur = nq.front();
                nq.pop_front();
              } else {
                cur = uq.front();
                if (ucvn) {
                  if (visited[(cur.a * B + cur.b) * C + cur.c]) {
                    uq.pop_front();
                    continue;
                  }
                  push_neighbors(cur.a, cur.b, cur.c);
                  ucvn = false;
                  continue;
                } else {
                  uq.pop_front();
                  ucvn = true;
                }
              }
            } else {
              cur = q.front();
              q.pop_front();
            }

            int64_t a = cur.a, b = cur.b, c = cur.c;
            if (visited[(a * B + b) * C + c]) continue;
            if (!active_cube(a, b, c)) continue;

            if (!assign_signs(a, b, c, /*allow_unsure=*/true, sv, nv)) {
              if (ucvn) uq.push_back(cur);
              continue;  // change_cube
            }
            if (!anchor_fallback(a, b, c, /*gate_unsure=*/ucvn, nv)) {
              uq.push_back(cur);
              continue;
            }

            if (!ucvn) continue;  // reliability-only visit: signs written, no faces

            finalize_cube_signs(a, b, c, svv);
            if (has_crossing(svv)) {
              if (nontrivial_config(svv) && (!q.empty() || !uq.empty())) {
                nq.push_back(cur);
                continue;
              }
              // connectivity gate (reference: check_the_big_switch >= 2)
              if (triangulate_dispatch(algo, mb, G, a, b, c, svv, /*gate=*/2)) {
                visited[(a * B + b) * C + c] = 1;
                push_neighbors(a, b, c);
              }
            } else {
              visited[(a * B + b) * C + c] = 1;
            }
          }
        }
  }
};

}  // namespace

extern "C" {

// UDF marching cubes with gradient-aware pseudo-signs.
// im: [n0*n1*n2] UDF values; grads: [n0*n1*n2*3] (-normalized gradients).
// algorithm: 0 = marching tetrahedra, 1 = Lewiner tables.
// Outputs malloc'd arrays (caller frees with mesh_free).
int udf_mc(const float* im, const float* grads, int64_t n0, int64_t n1,
           int64_t n2, float voxel_size, int32_t algorithm,
           float** out_verts, int64_t* out_nverts,
           int32_t** out_faces, int64_t* out_nfaces) {
  UdfMcState st;
  st.G = Grid{im, grads, n0, n1, n2};
  st.voxel = voxel_size;
  st.algo = (int)algorithm;
  st.avg_thresh = 1.05f * voxel_size;
  st.max_thresh = 1.74f * voxel_size;
  st.signed_im.assign((size_t)(n0 * n1 * n2), 0.0f);
  st.signed_mask.assign((size_t)(n0 * n1 * n2), 0);
  st.visited.assign((size_t)((n0 - 1) * (n1 - 1) * (n2 - 1)), 0);
  st.run();

  *out_nverts = (int64_t)(st.mb.verts.size() / 3);
  *out_nfaces = (int64_t)(st.mb.faces.size() / 3);
  *out_verts = (float*)std::malloc(st.mb.verts.size() * sizeof(float));
  *out_faces = (int32_t*)std::malloc(st.mb.faces.size() * sizeof(int32_t));
  std::memcpy(*out_verts, st.mb.verts.data(), st.mb.verts.size() * sizeof(float));
  std::memcpy(*out_faces, st.mb.faces.data(), st.mb.faces.size() * sizeof(int32_t));
  return 0;
}

// Classic iso-surface extraction (marching tetrahedra) on a scalar grid —
// used by the vanilla validate_mesh path (reference uses PyMCubes,
// ref: udf_renderer_blending.py:52-63). "Inside" is value < isovalue.
int classic_mc(const float* im, int64_t n0, int64_t n1, int64_t n2,
               float isovalue, int32_t algorithm,
               float** out_verts, int64_t* out_nverts,
               int32_t** out_faces, int64_t* out_nfaces) {
  Grid G{im, nullptr, n0, n1, n2};
  MeshBuilder mb;
  float sv[8];
  for (int64_t a = 0; a < n0 - 1; a++)
    for (int64_t b = 0; b < n1 - 1; b++)
      for (int64_t c = 0; c < n2 - 1; c++) {
        bool any_in = false, any_out = false;
        for (int i = 0; i < 8; i++) {
          // signed convention: positive outside, negative inside
          sv[i] = G.v(a + CUBE[i][0], b + CUBE[i][1], c + CUBE[i][2]) - isovalue;
          (sv[i] < 0 ? any_in : any_out) = true;
        }
        if (any_in && any_out)
          triangulate_dispatch((int)algorithm, mb, G, a, b, c, sv, 0);
      }
  *out_nverts = (int64_t)(mb.verts.size() / 3);
  *out_nfaces = (int64_t)(mb.faces.size() / 3);
  *out_verts = (float*)std::malloc(mb.verts.size() * sizeof(float));
  *out_faces = (int32_t*)std::malloc(mb.faces.size() * sizeof(int32_t));
  std::memcpy(*out_verts, mb.verts.data(), mb.verts.size() * sizeof(float));
  std::memcpy(*out_faces, mb.faces.data(), mb.faces.size() * sizeof(int32_t));
  return 0;
}

void mesh_free(float* verts, int32_t* faces) {
  std::free(verts);
  std::free(faces);
}

}  // extern "C"
