// Lewiner cube tiling — see lewiner.h. Implements the published case
// dispatch: 15 equivalence classes, face-saddle tests (test_face) for the
// ambiguous-face cases and the interior test (test_interior) for cases
// 4/6/7/10/12/13, selecting among the TILING* tables of lewiner_luts.h.

#include "lewiner.h"
#include "lewiner_luts.h"

#include <cmath>
#include <cstring>

namespace lewiner_engine {

namespace {

constexpr double EPS = 1e-7;  // FLT_EPSILON-scale guard, like the paper's impl

struct CubeValues {
  double v[8];
};

// Face corner quads (faces 1..6), paper convention.
static const int FACE_CORNERS[7][4] = {
    {0, 0, 0, 0},          // unused (faces are 1-based, sign = orientation)
    {0, 4, 5, 1},          // face 1
    {1, 5, 6, 2},          // face 2
    {2, 6, 7, 3},          // face 3
    {3, 7, 4, 0},          // face 4
    {0, 3, 2, 1},          // face 5
    {4, 7, 6, 5},          // face 6
};

// Face ambiguity resolution: the sign of A*C - B*D at the face saddle
// decides whether the surface separates the diagonal corners.
bool test_face(const CubeValues& c, int face) {
  int af = face < 0 ? -face : face;
  const int* q = FACE_CORNERS[af];
  double A = c.v[q[0]], B = c.v[q[1]], C = c.v[q[2]], D = c.v[q[3]];
  double ac_bd = A * C - B * D;
  if (ac_bd > -EPS && ac_bd < EPS) return face >= 0;
  return face * A * ac_bd >= 0;  // face and A invert signs
}

// Interior test: track the iso-contour on the plane swept along the
// cube's interior (parametrized by t) and count which corners of the
// swept quad are positive at the extremum.
bool test_interior(const CubeValues& c, int mc_case, int config, int subconfig, int s) {
  double At = 0, Bt = 0, Ct = 0, Dt = 0;
  double t, a, b;
  int edge = -1;

  if (mc_case == 4 || mc_case == 10) {
    a = (c.v[4] - c.v[0]) * (c.v[6] - c.v[2]) - (c.v[7] - c.v[3]) * (c.v[5] - c.v[1]);
    b = c.v[2] * (c.v[4] - c.v[0]) + c.v[0] * (c.v[6] - c.v[2]) -
        c.v[1] * (c.v[7] - c.v[3]) - c.v[3] * (c.v[5] - c.v[1]);
    t = -b / (2 * a + EPS);
    if (t < 0 || t > 1) return s > 0;
    At = c.v[0] + (c.v[4] - c.v[0]) * t;
    Bt = c.v[3] + (c.v[7] - c.v[3]) * t;
    Ct = c.v[2] + (c.v[6] - c.v[2]) * t;
    Dt = c.v[1] + (c.v[5] - c.v[1]) * t;
  } else {  // cases 6, 7, 12, 13: reference edge from the tables
    if (mc_case == 6) edge = lewiner::TEST6[config][2];
    else if (mc_case == 7) edge = lewiner::TEST7[config][4];
    else if (mc_case == 12) edge = lewiner::TEST12[config][3];
    else if (mc_case == 13) edge = lewiner::TILING13_5_1[config][subconfig][0];
    else return s < 0;

    // For each reference edge: t is the crossing along it; A..D are the
    // swept-quad values. (Paper's table, all 12 edges.)
    switch (edge) {
      case 0:
        t = c.v[0] / (c.v[0] - c.v[1] + EPS);
        At = 0;
        Bt = c.v[3] + (c.v[2] - c.v[3]) * t;
        Ct = c.v[7] + (c.v[6] - c.v[7]) * t;
        Dt = c.v[4] + (c.v[5] - c.v[4]) * t;
        break;
      case 1:
        t = c.v[1] / (c.v[1] - c.v[2] + EPS);
        At = 0;
        Bt = c.v[0] + (c.v[3] - c.v[0]) * t;
        Ct = c.v[4] + (c.v[7] - c.v[4]) * t;
        Dt = c.v[5] + (c.v[6] - c.v[5]) * t;
        break;
      case 2:
        t = c.v[2] / (c.v[2] - c.v[3] + EPS);
        At = 0;
        Bt = c.v[1] + (c.v[0] - c.v[1]) * t;
        Ct = c.v[5] + (c.v[4] - c.v[5]) * t;
        Dt = c.v[6] + (c.v[7] - c.v[6]) * t;
        break;
      case 3:
        t = c.v[3] / (c.v[3] - c.v[0] + EPS);
        At = 0;
        Bt = c.v[2] + (c.v[1] - c.v[2]) * t;
        Ct = c.v[6] + (c.v[5] - c.v[6]) * t;
        Dt = c.v[7] + (c.v[4] - c.v[7]) * t;
        break;
      case 4:
        t = c.v[4] / (c.v[4] - c.v[5] + EPS);
        At = 0;
        Bt = c.v[7] + (c.v[6] - c.v[7]) * t;
        Ct = c.v[3] + (c.v[2] - c.v[3]) * t;
        Dt = c.v[0] + (c.v[1] - c.v[0]) * t;
        break;
      case 5:
        t = c.v[5] / (c.v[5] - c.v[6] + EPS);
        At = 0;
        Bt = c.v[4] + (c.v[7] - c.v[4]) * t;
        Ct = c.v[0] + (c.v[3] - c.v[0]) * t;
        Dt = c.v[1] + (c.v[2] - c.v[1]) * t;
        break;
      case 6:
        t = c.v[6] / (c.v[6] - c.v[7] + EPS);
        At = 0;
        Bt = c.v[5] + (c.v[4] - c.v[5]) * t;
        Ct = c.v[1] + (c.v[0] - c.v[1]) * t;
        Dt = c.v[2] + (c.v[3] - c.v[2]) * t;
        break;
      case 7:
        t = c.v[7] / (c.v[7] - c.v[4] + EPS);
        At = 0;
        Bt = c.v[6] + (c.v[5] - c.v[6]) * t;
        Ct = c.v[2] + (c.v[1] - c.v[2]) * t;
        Dt = c.v[3] + (c.v[0] - c.v[3]) * t;
        break;
      case 8:
        t = c.v[0] / (c.v[0] - c.v[4] + EPS);
        At = 0;
        Bt = c.v[3] + (c.v[7] - c.v[3]) * t;
        Ct = c.v[2] + (c.v[6] - c.v[2]) * t;
        Dt = c.v[1] + (c.v[5] - c.v[1]) * t;
        break;
      case 9:
        t = c.v[1] / (c.v[1] - c.v[5] + EPS);
        At = 0;
        Bt = c.v[0] + (c.v[4] - c.v[0]) * t;
        Ct = c.v[3] + (c.v[7] - c.v[3]) * t;
        Dt = c.v[2] + (c.v[6] - c.v[2]) * t;
        break;
      case 10:
        t = c.v[2] / (c.v[2] - c.v[6] + EPS);
        At = 0;
        Bt = c.v[1] + (c.v[5] - c.v[1]) * t;
        Ct = c.v[0] + (c.v[4] - c.v[0]) * t;
        Dt = c.v[3] + (c.v[7] - c.v[3]) * t;
        break;
      case 11:
        t = c.v[3] / (c.v[3] - c.v[7] + EPS);
        At = 0;
        Bt = c.v[2] + (c.v[6] - c.v[2]) * t;
        Ct = c.v[1] + (c.v[5] - c.v[1]) * t;
        Dt = c.v[0] + (c.v[4] - c.v[0]) * t;
        break;
      default:
        return s < 0;
    }
  }

  int test = 0;
  if (At >= 0) test += 1;
  if (Bt >= 0) test += 2;
  if (Ct >= 0) test += 4;
  if (Dt >= 0) test += 8;

  switch (test) {
    case 0: case 1: case 2: case 3: case 4: case 6:
    case 8: case 9: case 12:
      return s > 0;
    case 5:
      if (At * Ct - Bt * Dt < EPS) return s > 0;
      return s < 0;
    case 10:
      if (At * Ct - Bt * Dt >= EPS) return s > 0;
      return s < 0;
    case 7: case 11: case 13: case 14: case 15:
    default:
      return s < 0;
  }
}

struct Emitter {
  int8_t* out;
  int n = 0;
  void add(const int8_t* tiling, int nt) {
    std::memcpy(out + 3 * n, tiling, 3 * nt);
    n += nt;
  }
};

}  // namespace

int tile_cube(const double sv[8], int8_t tris_out[36]) {
  using namespace lewiner;
  CubeValues c;
  for (int i = 0; i < 8; i++) c.v[i] = sv[i];

  int index = 0;
  for (int i = 0; i < 8; i++)
    if (c.v[i] > 0.0) index |= (1 << i);

  const int mc_case = CASES[index][0];
  const int config = CASES[index][1];
  int subconfig = 0;
  Emitter em{tris_out};

  switch (mc_case) {
    case 0:
      break;
    case 1:
      em.add(TILING1[config], 1);
      break;
    case 2:
      em.add(TILING2[config], 2);
      break;
    case 3:
      if (test_face(c, TEST3[config])) em.add(TILING3_2[config], 4);
      else em.add(TILING3_1[config], 2);
      break;
    case 4:
      if (test_interior(c, 4, config, subconfig, TEST4[config]))
        em.add(TILING4_1[config], 2);
      else
        em.add(TILING4_2[config], 6);
      break;
    case 5:
      em.add(TILING5[config], 3);
      break;
    case 6:
      if (test_face(c, TEST6[config][0])) em.add(TILING6_2[config], 5);
      else if (test_interior(c, 6, config, subconfig, TEST6[config][1]))
        em.add(TILING6_1_1[config], 3);
      else
        em.add(TILING6_1_2[config], 9);  // uses the center vertex
      break;
    case 7:
      if (test_face(c, TEST7[config][0])) subconfig += 1;
      if (test_face(c, TEST7[config][1])) subconfig += 2;
      if (test_face(c, TEST7[config][2])) subconfig += 4;
      switch (subconfig) {
        case 0: em.add(TILING7_1[config], 3); break;
        case 1: em.add(TILING7_2[config][0], 5); break;
        case 2: em.add(TILING7_2[config][1], 5); break;
        case 3: em.add(TILING7_3[config][0], 9); break;
        case 4: em.add(TILING7_2[config][2], 5); break;
        case 5: em.add(TILING7_3[config][1], 9); break;
        case 6: em.add(TILING7_3[config][2], 9); break;
        case 7:
          if (test_interior(c, 7, config, subconfig, TEST7[config][3]))
            em.add(TILING7_4_2[config], 9);
          else
            em.add(TILING7_4_1[config], 5);
          break;
      }
      break;
    case 8:
      em.add(TILING8[config], 2);
      break;
    case 9:
      em.add(TILING9[config], 4);
      break;
    case 10:
      if (test_face(c, TEST10[config][0])) {
        if (test_face(c, TEST10[config][1])) em.add(TILING10_1_1_[config], 4);
        else em.add(TILING10_2[config], 8);
      } else {
        if (test_face(c, TEST10[config][1])) em.add(TILING10_2_[config], 8);
        else if (test_interior(c, 10, config, subconfig, TEST10[config][2]))
          em.add(TILING10_1_1[config], 4);
        else
          em.add(TILING10_1_2[config], 8);
      }
      break;
    case 11:
      em.add(TILING11[config], 4);
      break;
    case 12:
      if (test_face(c, TEST12[config][0])) {
        if (test_face(c, TEST12[config][1])) em.add(TILING12_1_1_[config], 4);
        else em.add(TILING12_2[config], 8);
      } else {
        if (test_face(c, TEST12[config][1])) em.add(TILING12_2_[config], 8);
        else if (test_interior(c, 12, config, subconfig, TEST12[config][2]))
          em.add(TILING12_1_1[config], 4);
        else
          em.add(TILING12_1_2[config], 8);
      }
      break;
    case 13: {
      if (test_face(c, TEST13[config][0])) subconfig += 1;
      if (test_face(c, TEST13[config][1])) subconfig += 2;
      if (test_face(c, TEST13[config][2])) subconfig += 4;
      if (test_face(c, TEST13[config][3])) subconfig += 8;
      if (test_face(c, TEST13[config][4])) subconfig += 16;
      if (test_face(c, TEST13[config][5])) subconfig += 32;
      int sc = SUBCONFIG13[subconfig];
      if (sc == 0) em.add(TILING13_1[config], 4);
      else if (sc >= 1 && sc <= 6) em.add(TILING13_2[config][sc - 1], 6);
      else if (sc >= 7 && sc <= 18) em.add(TILING13_3[config][sc - 7], 10);
      else if (sc >= 19 && sc <= 22) em.add(TILING13_4[config][sc - 19], 12);
      else if (sc >= 23 && sc <= 26) {
        int k = sc - 23;
        if (test_interior(c, 13, config, k, TEST13[config][6]))
          em.add(TILING13_5_1[config][k], 6);
        else
          em.add(TILING13_5_2[config][k], 10);
      } else if (sc >= 27 && sc <= 38) em.add(TILING13_3_[config][sc - 27], 10);
      else if (sc >= 39 && sc <= 44) em.add(TILING13_2_[config][sc - 39], 6);
      else if (sc == 45) em.add(TILING13_1_[config], 4);
      break;
    }
    case 14:
      em.add(TILING14[config], 4);
      break;
  }
  return em.n;
}

}  // namespace lewiner_engine
