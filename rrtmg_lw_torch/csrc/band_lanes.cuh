// The tile of the per-band adjoints, K6 maxrand (rtrn_bwd_mr.cu) and K6 in
// the banded, fused and cldf-odcld modes (rtrn_bwd_g.cu): a block holds 32
// columns x 8 g-lanes (256 threads), and g-lane y takes two whole bands,
// PAIR[y] (16-20 of the 140 g-points), so that every per-band sum stays in
// one thread, in ascending g.
#pragma once

namespace {

constexpr int MX = 32;                  // columns per block
constexpr int MY = 8;                   // g-lanes per column
constexpr int MT = MX * MY;             // threads per block
// the two bands of each g-lane
__constant__ int PAIR[MY][2] = {{2, 13}, {4, 14}, {3, 15}, {1, 12},
                                {6, 9},  {8, 5},  {0, 7},  {10, 11}};

}  // namespace
