from repro_torch.kernels.moe_ffn.ops import moe_ffn  # noqa: F401
from repro_torch.kernels.moe_ffn.ref import moe_ffn_ref  # noqa: F401
