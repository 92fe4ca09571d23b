"""The port's sampling at temperature > 0 against the JAX reference, on the
CPU.

The reference draws ``categorical(fold_in(fold_in(key, slot), position),
logits / T)``; JAX's PRNG bits cannot be reproduced in PyTorch, so parity
is distributional: the port's Gumbel-max draws and the reference's pass
the same 20 000-key frequency test on the same logits (atol 0.015, the
bound of the reference's own rejection-sampling test).  The port's keys
come from an integer hash that must equal its plain-Python statement bit
for bit, so every device draws the same integers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.continuous import _sample_rows as jsample_rows
from repro_torch.core.routers.hashed import _mix32, _mul32
from repro_torch.serving.continuous import _row_uniforms, _sample_rows
from torch_threads import one_torch_thread  # noqa: F401

M32 = 0xFFFFFFFF


def _softmax(logits, T):
    z = logits.astype(np.float64) / T
    p = np.exp(z - z.max())
    return p / p.sum()


def _mix32_reference(x: int) -> int:
    """lowbias32 over Python integers, wrapping at 32 bits."""
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def test_hash_is_exact_in_int64():
    rng = np.random.default_rng(0)
    xs = np.concatenate([rng.integers(0, 2 ** 32, 2000, dtype=np.int64),
                         np.array([0, 1, 2 ** 16 - 1, 2 ** 16, 2 ** 31, M32], np.int64)])
    t = torch.from_numpy(xs)
    for c in (0x7FEB352D, 0x846CA68B, M32, 1):
        np.testing.assert_array_equal(_mul32(t, c).numpy(),
                                      [(int(x) * c) & M32 for x in xs])
        # the largest intermediate, x * (c >> 16) and x * (c & 0xFFFF), stays below 2**49
        assert int(xs.max()) * max(c >> 16, c & 0xFFFF) < 2 ** 49
    np.testing.assert_array_equal(_mix32(t).numpy(), [_mix32_reference(int(x)) for x in xs])
    assert all(_mix32(int(x)) == _mix32_reference(int(x)) for x in xs[:50])
    # a bijection: no two of 2**16 consecutive inputs collide
    assert torch.unique(_mix32(torch.arange(2 ** 16, dtype=torch.int64))).numel() == 2 ** 16


def test_uniforms_in_open_interval_and_keyed():
    u = _row_uniforms(3, [0, 1, 0], [5, 5, 6], 4096, "cpu")
    assert u.dtype == torch.float64 and u.shape == (3, 4096)
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.01
    # each (slot, position) row its own stream; another seed, other streams
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert not torch.equal(u, _row_uniforms(4, [0, 1, 0], [5, 5, 6], 4096, "cpu"))
    torch.testing.assert_close(u, _row_uniforms(3, [0, 1, 0], [5, 5, 6], 4096, "cpu"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("T", [0.8, 1.3])
def test_frequencies_match_softmax_like_the_reference(T):
    """20 000 distinct (slot, position) keys over one logits row: the port's
    draws and the reference's ``_sample_rows`` both within 0.015 of
    softmax(logits / T)."""
    V, n = 6, 20_000
    logits = (np.random.default_rng(0).standard_normal((1, V)) * 2.0).astype(np.float32)
    p = _softmax(logits[0], T)
    keys = np.arange(n)
    slots, positions = keys % 8, keys // 8
    rows = np.repeat(logits, n, axis=0)
    port = _sample_rows(torch.from_numpy(rows), slots, positions, T, seed=11).numpy()
    ref = np.asarray(jsample_rows(jnp.asarray(rows), jnp.asarray(slots), jnp.asarray(positions),
                                  temperature=T, key=jax.random.PRNGKey(11)))
    for draws in (port, ref):
        assert draws.dtype == np.int32
        np.testing.assert_allclose(np.bincount(draws, minlength=V) / n, p, atol=0.015)


def test_draws_independent_across_slots_and_reproducible_under_reuse():
    """Per slot the draws follow the softmax on their own, two slots' draws
    at the same positions agree no more than chance, and a row's draw
    depends on its (slot, position) alone, not on the rows beside it."""
    V, n, T = 4, 8000, 1.0
    logits = np.zeros((n, V), np.float32)                 # uniform: agreement 1 / V
    pos = np.arange(n)
    a = _sample_rows(torch.from_numpy(logits), np.zeros(n, int), pos, T, seed=2).numpy()
    b = _sample_rows(torch.from_numpy(logits), np.ones(n, int), pos, T, seed=2).numpy()
    for d in (a, b):
        np.testing.assert_allclose(np.bincount(d, minlength=V) / n, 0.25, atol=0.015)
    assert abs(float((a == b).mean()) - 1 / V) < 0.02
    # any subset, in any order, draws what it drew inside the whole batch
    idx = np.random.default_rng(1).permutation(n)[:100]
    sub = _sample_rows(torch.from_numpy(logits[idx]), np.zeros(100, int), pos[idx], T,
                       seed=2).numpy()
    np.testing.assert_array_equal(sub, a[idx])


def test_greedy_is_the_first_maximum_and_padding_is_unreachable():
    rng = np.random.default_rng(3)
    logits = rng.integers(0, 3, (64, 10)).astype(np.float32)   # many ties
    got = _sample_rows(torch.from_numpy(logits), None, None, 0.0, 0).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.argmax(jnp.asarray(logits), -1)))
    # padded vocab columns hold finfo.min, as the unembed writes them
    pad = np.full((4096, 8), np.finfo(np.float32).min, np.float32)
    lg = np.concatenate([np.zeros((4096, 3), np.float32), pad], axis=1)
    for T in (0.8, 2.0):
        d = _sample_rows(torch.from_numpy(lg), np.arange(4096) % 8, np.arange(4096), T,
                         seed=1).numpy()
        assert d.max() < 3 and set(d.tolist()) == {0, 1, 2}


def test_engine_sampling_reproducible_under_slot_reuse():
    """One slot, two requests: the second reuses slot 0 and samples exactly
    what it samples alone on a fresh engine (same slot, same positions)."""
    import dataclasses

    from repro_torch.configs.base import ModelConfig, ServeConfig
    from repro_torch.nn import init_params
    from repro_torch.serving.continuous import ContinuousEngine
    from repro_torch.serving.request import Request

    cfg = ModelConfig(name="t", family="decoder_lm", num_layers=1, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, max_seq_len=64,
                      dtype="float32", initializer_range=1.0)
    params = init_params(cfg, seed=0, device="cpu")
    serve = ServeConfig(max_slots=1, kv_block_size=4, prefill_chunk=8, max_len=24)
    rng = np.random.default_rng(5)
    a = Request(uid=0, prompt=rng.integers(0, 64, 7).astype(np.int32), max_new_tokens=6)
    b = Request(uid=1, prompt=rng.integers(0, 64, 7).astype(np.int32), max_new_tokens=8)

    def run(reqs):
        eng = ContinuousEngine(cfg, params, serve, temperature=0.9, seed=4, device="cpu",
                               check_invariants=True)
        return eng.run([dataclasses.replace(r) for r in reqs])[0]

    both, alone = run([a, b]), run([b])
    assert both[1] == alone[1]
    assert len(set(alone[1])) > 1                       # sampled, not a greedy loop
    assert run([a, b]) == both
