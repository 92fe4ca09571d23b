"""Quantized KV cache (``repro.quant``): the int8/fp8 policies and the
scale-maintaining pool write (``policy``), and the quantized paged caches
(``kv_cache``) that ``repro_torch.serving.kv_cache.make_kv_cache`` selects
from ``ServeConfig.kv_quant``."""
from repro_torch.quant.policy import (  # noqa: F401
    KVQuantPolicy,
    check_quant_roundtrip,
    get_kv_quant,
    quant_write_kv,
    register_kv_quant,
)
