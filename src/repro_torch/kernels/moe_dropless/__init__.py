from repro_torch.kernels.moe_dropless.ops import (  # noqa: F401
    padded_rows,
    pick_block_rows,
    ragged_ffn,
)
from repro_torch.kernels.moe_dropless.ref import ragged_ffn_ref  # noqa: F401
