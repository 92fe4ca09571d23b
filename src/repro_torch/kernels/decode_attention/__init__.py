from repro_torch.kernels.decode_attention.ops import (  # noqa: F401
    decode_attention,
    paged_decode_attention,
    paged_update_attention,
    quantized_paged_decode_attention,
    quantized_paged_update_attention,
    sharded_paged_update_attention,
    sharded_quantized_paged_update_attention,
)
from repro_torch.kernels.decode_attention.ref import (  # noqa: F401
    decode_attention_ref,
    paged_decode_attention_ref,
    quantized_paged_decode_attention_ref,
)
