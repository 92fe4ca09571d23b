"""``repro_torch.nn.initializers`` (the reference's ``repro.nn.initializers``
as ``(generator, shape, dtype, device)`` functions): moments and
truncation of each, and ``init_params``' draws through
``truncated_normal_init`` bit-equal to the draw it made before the module
existed, for a seed (every seeded weight in the tests and on the card
depends on it)."""
import math

import numpy as np
import pytest
import torch

from repro.nn import initializers as jinit
from repro_torch.configs.registry import get_smoke_config
from repro_torch.configs.base import torch_dtype
from repro_torch.nn import abstract, flat_params, init_params, model_shapes
from repro_torch.nn import initializers as I
from torch_threads import one_torch_thread  # noqa: F401

N = (400, 500)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_constant_initializers():
    for dt in (torch.float32, torch.bfloat16):
        z = I.zeros_init(_gen(), (3, 4), dt)
        o = I.ones_init(_gen(), (3, 4), dt, "cpu")
        assert z.dtype == dt and o.dtype == dt and z.shape == (3, 4)
        assert (z == 0).all() and (o == 1).all()
    assert I.zeros_init(None, (2,), torch.float32, "meta").device.type == "meta"


def test_normal_init_moments():
    x = I.normal_init(0.02)(_gen(), N, torch.float32).double()
    assert abs(x.mean().item()) < 0.02 * 5 / math.sqrt(x.numel())
    assert x.std().item() == pytest.approx(0.02, rel=0.01)


@pytest.mark.parametrize("stddev", [0.02, 0.002])
def test_truncated_normal_moments_and_truncation(stddev):
    """Truncated at +-2 sigma; the std of a standard normal truncated there
    is 0.8796 (the reference's draws: the same)."""
    x = I.truncated_normal_init(stddev)(_gen(1), N, torch.float32).double()
    assert x.abs().max().item() <= 2 * stddev * (1 + 1e-6)
    assert x.abs().max().item() > 1.9 * stddev
    assert abs(x.mean().item()) < stddev * 5 / math.sqrt(x.numel())
    assert x.std().item() == pytest.approx(0.8796 * stddev, rel=0.01)
    import jax

    j = np.asarray(jinit.truncated_normal_init(stddev)(jax.random.PRNGKey(0), N, np.float32),
                   np.float64)
    assert x.std().item() == pytest.approx(j.std(), rel=0.01)
    assert np.abs(j).max() <= 2 * stddev * (1 + 1e-6)


def test_truncated_draws_in_f32_then_casts():
    a = I.truncated_normal_init(0.02)(_gen(2), (64, 64), torch.bfloat16)
    b = I.truncated_normal_init(0.02)(_gen(2), (64, 64), torch.float32)
    assert a.dtype == torch.bfloat16 and torch.equal(a, b.to(torch.bfloat16))


def test_scaled_normal_init():
    x = I.scaled_normal_init((-2,), scale=2.0)(_gen(3), (256, 300), torch.float32).double()
    sd = 2.0 / math.sqrt(256)
    assert x.abs().max().item() <= 2 * sd * (1 + 1e-6)
    assert x.std().item() == pytest.approx(0.8796 * sd, rel=0.02)


@pytest.mark.parametrize("arch", ["m6-base", "qwen3-8b", "zamba2-7b"])
@pytest.mark.parametrize("train", [False, True])
def test_init_params_bit_equal_to_its_former_draw(arch, train):
    """``init_params`` draws each leaf, in tree order, from one generator as
    ``trunc_normal_(t, 0, 1, -2, 2) * initializer_range`` cast to the
    leaf's dtype (ones and zeros for the norms): the draw before
    ``nn.initializers`` existed, bit for bit."""
    cfg = get_smoke_config(arch)
    got = init_params(cfg, seed=7, device="cpu", train=train)
    gen = _gen(7)
    want = {}

    def walk(tree, path=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}{k}/")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}{i}/")
        else:
            dt = torch_dtype(tree.dtype)
            if tree.init == "ones":
                t = torch.ones(tree.shape, dtype=dt)
            elif tree.init == "zeros":
                t = torch.zeros(tree.shape, dtype=dt)
            else:
                t = torch.empty(tree.shape, dtype=torch.float32)
                torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
                t = t.mul_(cfg.initializer_range).to(dt)
            want[path[:-1]] = t

    walk(model_shapes(cfg, train))
    got = flat_params(got)
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k


def test_abstract_is_meta_of_the_tree():
    cfg = get_smoke_config("m6-base")
    for train in (False, True):
        a = flat_params(abstract(cfg, train))
        p = flat_params(init_params(cfg, device="cpu", train=train))
        assert set(a) == set(p)
        for k, t in a.items():
            assert t.device.type == "meta" and t.shape == p[k].shape and t.dtype == p[k].dtype
