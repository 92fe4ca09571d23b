// The ragged FFN's 96- and 128-row tiles (ragged_ffn.cu's ragged_ffn_tc),
// a translation unit of the ragged_ffn library of its own: the persistent
// passes of the wide tiles take the longest to compile, and build.py runs
// one nvcc a unit, all at once.
#include "grouped_ffn_sm90.cuh"

namespace grouped_ffn_sm90 {
template GROUPED_FFN_SM90_RAGGED_TILES(96);
template GROUPED_FFN_SM90_RAGGED_TILES(128);
}  // namespace grouped_ffn_sm90
