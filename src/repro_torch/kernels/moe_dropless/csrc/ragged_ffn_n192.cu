// The ragged FFN's 192-row tiles (ragged_ffn.cu's ragged_ffn_tc), a
// translation unit of the ragged_ffn library of its own (see
// ragged_ffn_n128.cu).
#include "grouped_ffn_sm90.cuh"

namespace grouped_ffn_sm90 {
template GROUPED_FFN_SM90_RAGGED_TILES(192);
}  // namespace grouped_ffn_sm90
