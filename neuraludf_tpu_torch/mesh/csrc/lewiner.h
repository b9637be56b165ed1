// Lewiner topologically-consistent cube tiling (Lewiner, Lopes, Vieira,
// Tavares: "Efficient implementation of Marching Cubes cases with
// topological guarantees", Journal of Graphics Tools 2003).
//
// Fresh C++ implementation of the published algorithm for the TPU-native
// framework's mesh extractor; the case dispatch + face/interior saddle
// tests follow the paper's reference implementation (the same algorithm
// behind scikit-image and the NeuralUDF reference Cython extractor,
// ref: custom_mc/_marching_cubes_lewiner_cy.pyx:1847-2569). Tables in
// lewiner_luts.h.
//
// The entry point is a PURE function: given the 8 signed corner values of
// one cube, emit the tiling as triangles of edge indices (0..11 = cube
// edges, 12 = the interpolated center vertex). Callers own vertex
// placement/deduplication.

#pragma once
#include <cstdint>

namespace lewiner_engine {

// cube edge -> its two corners, standard MC numbering
// corners: 0:(0,0,0) 1:(1,0,0) 2:(1,1,0) 3:(0,1,0)
//          4:(0,0,1) 5:(1,0,1) 6:(1,1,1) 7:(0,1,1)
static const int EDGE_CORNERS[12][2] = {
    {0, 1}, {1, 2}, {2, 3}, {3, 0},
    {4, 5}, {5, 6}, {6, 7}, {7, 4},
    {0, 4}, {1, 5}, {2, 6}, {3, 7},
};

// Tile one cube. sv: signed corner values (inside > 0). tris_out receives
// up to 12 triangles as edge-index triplets (vi 0..12; 12 = center
// vertex). Returns the triangle count (0 when the cube has no crossing).
int tile_cube(const double sv[8], int8_t tris_out[36]);

}  // namespace lewiner_engine
