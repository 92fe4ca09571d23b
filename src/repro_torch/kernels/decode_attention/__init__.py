from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    paged_decode_attention,
    paged_update_attention,
)
from repro_torch.kernels.decode_attention.ref import paged_decode_attention_ref  # noqa: F401
