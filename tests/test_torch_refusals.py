"""The port's refusals that no other test names, each beside the
reference's: the paged engine under a logit softcap, and a copy-on-write
detach on a detached per-shard prefix cache (a guard: only speculative
rollback reaches it, and the engine refuses speculation on a mesh).  Each
raises ``NotImplementedError`` with the reference's message.  The other
refusals are named where their paths are tested (``test_torch_mesh.py``,
``test_torch_xlstm.py``, ``test_torch_zamba.py``, ``test_torch_encdec.py``,
``test_torch_moe_attention.py``, ``test_torch_serving.py``,
``test_torch_speculative.py``, ``test_torch_arch.py``)."""
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ServeConfig as JServeConfig
from repro.serving import prefix_cache as jpc
from repro.serving.continuous import ContinuousEngine as JEngine
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.serving import prefix_cache as tpc
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from torch_threads import one_torch_thread  # noqa: F401


def test_paged_engine_refuses_a_softcap():
    jcfg = jm6.smoke().replace(attn_logit_softcap=5.0)
    tcfg = tm6.smoke().replace(attn_logit_softcap=5.0)
    with pytest.raises(NotImplementedError, match="softcap") as jerr:
        JEngine(jcfg, None, JServeConfig(max_len=32))
    with pytest.raises(NotImplementedError, match="softcap") as terr:
        TEngine(tcfg, {"embed": {"table": torch.zeros(1)}}, TServeConfig(max_len=32),
                device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_detached_prefix_cache_refuses_a_copy_on_write():
    """Truncating into a block another slot binds needs a copy of the block
    on the device; a detached cache (host accounting only, the sharded
    cache's per-shard sub-cache) has no pools to copy."""
    kw = dict(name="t", family="decoder_lm", num_layers=1, d_model=32, num_heads=2,
              num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32")
    serve = dict(max_slots=4, kv_block_size=4, max_len=64, num_blocks=16, prefix_cache=True)
    jc = jpc.PrefixCachingKVCache(JModelConfig(**kw), JServeConfig(**serve))
    jc.k_pool = jc.v_pool = None        # as ShardedPagedKVCache leaves its sub-caches
    tc = tpc.PrefixCachingKVCache(TModelConfig(**kw), TServeConfig(**serve), device=None)
    assert tc.k_pool is None
    prompt = np.arange(12, dtype=np.int32)
    errs = []
    for c in (jc, tc):
        c.allocate_slot(0, 16, prompt=prompt)
        c.ensure_capacity(0, 12)
        c.commit(0, prompt)
        assert c.allocate_slot(1, 16, prompt=prompt) == 8      # binds blocks 0..1
        with pytest.raises(NotImplementedError, match="copy-on-write") as err:
            c.truncate_slot(0, 5)                               # COW edge: block 1
        errs.append(str(err.value))
    assert errs[0] == errs[1]
