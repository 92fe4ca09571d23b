"""The assigned input-shape cells (LM transformer shapes, seq x batch),
``repro.configs.shapes``."""
from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]}

# long_500k needs sub-quadratic sequence mixing: only the SSM / hybrid
# families run it.  Every other family: train, prefill and decode.
SUBQUADRATIC_FAMILIES = ("xlstm", "zamba")


def shapes_for(cfg) -> list:
    out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if cfg.family in SUBQUADRATIC_FAMILIES:
        out.append(LONG_500K)
    return out
