// The tile of the per-band adjoints, K6 in the banded, fused and
// cldf-odcld modes and compact's d/dT (rtrn_bwd_g.cu) and K6 maxrand
// (rtrn_bwd_mr.cu): a
// block holds 32 columns (a lane each) and one of NGRP = 5 groups of whole
// bands (g-points 0-21, 22-51, 52-75, 76-107, 108-139), taken from a
// ticket drawn as the block starts; warp y takes the group's g-points y,
// y + 8, ... (at most GPT).  A step's rows are staged by bulk tensor
// copies of GX x GH boxes into a ring of G_RING slots (rtrn.cuh), or
// element by element where a row is not 16-byte aligned.
#pragma once

#include "rtrn.cuh"

namespace {

using namespace rrtm::rt;

constexpr int GX = 32;                  // columns per block
constexpr int GY = 8;                   // g-lanes (warps) per block
constexpr int GT = GX * GY;             // threads per block
constexpr int NGRP = 5;                 // band groups: a column tile's blocks
constexpr int GR = 32;                  // g-points of the largest group
constexpr int GPT = (GR + GY - 1) / GY;  // g-points per thread, at most
constexpr int GH = 8;                   // rows of a copy's box
constexpr int GBOX = (GR + GH - 1) / GH;  // boxes of a group's g-points
constexpr int GNB = GH;                 // bands of a group, at most
constexpr int G_BLOCKS_PER_SM = 2;
constexpr int G_RING = 2;               // slots in the ring
constexpr int RB = GX * 4;              // bytes of a tile row
static_assert(GX == 32 && GT % 32 == 0, "a lane per column");
static_assert(GY > GNB - 1, "a warp per band of a group, and one more");
// a copy's box row is 128 bytes, an L2 line
constexpr CUtensorMapL2promotion G_L2 = CU_TENSOR_MAP_L2_PROMOTION_L2_128B;

// the first band of each group: g-points 0-21, 22-51, 52-75, 76-107,
// 108-139 (22, 30, 24, 32, 32; whole bands, contiguous)
__constant__ int GFIRST[NGRP + 1] = {0, 2, 4, 6, 9, KNB};

// The scratch of a launch (the wrapper's allocations): the counter the
// tickets are drawn from, then one a column tile (zeroed); the groups'
// shares of the sums over all 140 g-points (K6 banded past L = 381: the
// cloud fraction's; compact's d/dT past L = 153: cw's; K6 maxrand: the
// overlap rows'), where the kernel keeps them in device memory, else
// null; and K6-g's per-g modes' input of the cloudy-layer words K1 wrote
// ((tiles, L), else null).
struct GScratch {
    const unsigned* words;
    int* count;
    float* part;
};

}  // namespace
