"""The model drafter's forwards as a static form
(``serving.speculative.model.ModelDrafter.form``) on the CPU.

On the card the form is captured once as a CUDA graph on the continuous
engine's pool and replayed a proposal; here it runs eagerly over the same
input buffer.  So: (a) proposals through the form's buffer equal the eager
forwards' on the same contexts and the reference's ``ModelDrafter.
propose`` (contexts of mixed lengths, an idle row, a context longer than
``max_len``, budgets below ``gamma``, and a second proposal over the
first's buffer); (b) the body on ``meta`` reads no host value, takes no
host tensor and makes no tensor of host data; (c) the engine's census of compiled variants with the model
drafter is the reference's (its step forms only), with no recompile.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import m6 as jm6
from repro.configs.base import ServeConfig as JServeConfig
from repro.configs.base import SpecConfig as JSpecConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.serving.request import Request as JRequest
from repro.serving.speculative.base import DraftItem as JDraftItem
from repro.serving.speculative.model import ModelDrafter as JModelDrafter
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import SpecConfig as TSpecConfig
from repro_torch.nn import abstract, from_jax_params
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.serving.request import Request as TRequest
from repro_torch.serving.speculative.base import DraftItem as TDraftItem
from repro_torch.serving.speculative.model import ModelDrafter as TModelDrafter
from test_torch_compiled_step import _census
from test_torch_train_graph import no_host_values
from torch_threads import one_torch_thread  # noqa: F401

GAMMA, SLOTS, MAX_LEN = 3, 4, 24


@pytest.fixture(scope="module")
def models():
    """(jcfg, tcfg, jparams, tparams): m6's smoke widths, dropless (the
    ragged FFN and the combine in every MoE layer of every forward)."""
    jcfg = jm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    tcfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    jp = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))
    return jcfg, tcfg, jp, from_jax_params(jax.device_get(jp), tcfg, device="cpu")


def _contexts(vocab, seed):
    """Three slots' (context, budget) of lengths 5, 17 and 31 (longer than
    MAX_LEN: its last MAX_LEN tokens are the context), budgets 3, 1 and 2;
    the fourth slot idle."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), budget)
            for n, budget in ((5, GAMMA), (17, 1), (31, 2))]


def _items(cls, contexts):
    return [cls(slot=i, context=c, max_tokens=m) for i, (c, m) in enumerate(contexts)]


def test_proposals_through_the_form(models):
    jcfg, tcfg, jp, tp = models
    spec = dict(drafter="model", gamma=GAMMA)
    serve = dict(max_slots=SLOTS, max_len=MAX_LEN)
    tdraft = TModelDrafter(TSpecConfig(**spec), tcfg, TServeConfig(**serve),
                           draft_model=(tcfg, tp), device="cpu")
    jdraft = JModelDrafter(JSpecConfig(**spec), jcfg, JServeConfig(**serve),
                           draft_model=(jcfg, jp))
    assert tdraft.form.inputs.shape == (SLOTS, MAX_LEN + 1)
    # long contexts first, then short ones over the same buffer
    for seed, contexts in ((3, _contexts(jcfg.vocab_size, 3)[::-1]),
                           (4, _contexts(jcfg.vocab_size, 4))):
        got = tdraft.propose(_items(TDraftItem, contexts))
        want = jdraft.propose(_items(JDraftItem, contexts))
        assert [g.tolist() for g in got] == [w.tolist() for w in want], seed
        assert [g.size for g in got] == [m for _, m in contexts]
        assert all(g.dtype == np.int32 for g in got)
        # the eager forwards on the buffer the form just read
        buf = tdraft.form.inputs
        eager = tdraft._draft(buf[:, :MAX_LEN], buf[:, MAX_LEN]).numpy()
        assert eager.shape == (SLOTS, GAMMA) and eager.dtype == np.int32
        assert [eager[i, :m].tolist() for i, (_, m) in enumerate(contexts)] == \
            [g.tolist() for g in got]
        lens = buf[:, MAX_LEN].tolist()
        assert lens == [min(c.size, MAX_LEN) for c, _ in contexts] + [0]   # the idle row
        assert not buf[len(contexts):].any()
    assert tdraft.form.graph is None and tdraft.graph_bytes == 0          # the CPU: eager


def test_body_reads_no_host_value():
    cfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    draft = TModelDrafter(TSpecConfig(drafter="model", gamma=GAMMA), cfg,
                          TServeConfig(max_slots=SLOTS, max_len=MAX_LEN),
                          draft_model=(cfg, abstract(cfg)), device="meta")
    assert draft.form.inputs.device.type == "meta"
    with no_host_values():
        out = draft.form.body()
    assert out.device.type == "meta" and out.shape == (SLOTS, GAMMA)
    assert out.dtype == torch.int32


def _requests(cls, vocab, gens=(9, 7, 10), seed=2):
    rng = np.random.default_rng(seed)
    return [cls(uid=uid, prompt=rng.integers(0, vocab, 7 + uid).astype(np.int32),
                max_new_tokens=gen) for uid, gen in enumerate(gens)]


def test_census_unchanged_by_the_drafter(models):
    """The drafter's form is not a variant of the engine's: the census is
    the reference's (of the 3 forms it expects, those the trace ran), with
    no recompile, and the tokens and speculation counters are the
    reference's."""
    jcfg, tcfg, jp, tp = models
    serve = dict(max_slots=2, kv_block_size=4, prefill_chunk=8, max_len=32)
    spec = dict(drafter="model", gamma=GAMMA)
    jeng = JEngine(jcfg, jp, JServeConfig(**serve, spec=JSpecConfig(**spec)),
                   draft_model=(jcfg, jp))
    teng = TEngine(tcfg, tp, TServeConfig(**serve, spec=TSpecConfig(**spec)),
                   draft_model=(tcfg, tp), device="cpu")
    jout, _ = jeng.run(_requests(JRequest, jcfg.vocab_size))
    tout, _ = teng.run(_requests(TRequest, tcfg.vocab_size))
    assert tout == jout
    assert teng.spec_stats == jeng.spec_stats and teng.spec_stats["verify_steps"] > 0
    # this trace never decodes without a draft: mixed and verify steps only
    assert teng.compiled_variants() == jeng.compiled_variants() == 2
    assert _census(teng) == _census(jeng) == (2, 0)
    assert teng._expected_variants == jeng._expected_variants == 3
    assert teng.graph_pool_bytes == 0
