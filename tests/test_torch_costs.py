"""The analysis tooling's models against the reference's, on the CPU:
``repro_torch.distributed.costs`` (the analytic FLOP and HBM-byte models),
its ``counted_flops`` over a ``meta`` trace, ``distributed.roofline`` (the
H100's three-term roofline and ``kernel_bound``), ``distributed.meta_trace``
(the dry run's memory tracker and op histogram) and the kernel wrappers'
``meta`` route."""
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs.registry import ALL_IDS as J_ALL_IDS
from repro.configs.registry import get_config as jget_config
from repro.configs.shapes import shapes_for as jshapes_for
from repro.distributed import costs as jcosts
from repro.models.registry import get_family as jget_family
from repro.nn import count_params as jcount_params
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ALL_IDS, get_config, get_smoke_config
from repro_torch.configs.shapes import SHAPES, SUBQUADRATIC_FAMILIES, shapes_for
from repro_torch.distributed import costs, roofline
from repro_torch.distributed.meta_trace import MetaTrace
from repro_torch.models.registry import get_family
from repro_torch.nn import abstract, count_params, flat_params
from repro_torch.train.losses import total_loss
from torch_threads import one_torch_thread  # noqa: F401

IMPLS = ("einsum", "gather", "pallas", "dropless")


def _variants(cfg):
    """(label, cfg) for each impl x remat the test covers (dense configs:
    remat only, their FFN has no dispatcher)."""
    out = []
    for remat in (True, False):
        c = cfg.replace(remat=remat)
        if not cfg.moe.num_experts:
            out.append((f"dense remat={remat}", c))
            continue
        for impl in IMPLS:
            kw = {"impl": impl}
            if impl == "dropless":
                kw["capacity_factor"] = None
            out.append((f"{impl} remat={remat}", c.replace_moe(**kw)))
    return out


def test_registries_and_shapes_match():
    assert sorted(ALL_IDS) == sorted(J_ALL_IDS)
    from repro.configs import shapes as jshapes

    assert {k: (s.seq_len, s.global_batch, s.kind, s.tokens) for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind, s.tokens) for k, s in jshapes.SHAPES.items()}
    assert SUBQUADRATIC_FAMILIES == jshapes.SUBQUADRATIC_FAMILIES


@pytest.mark.parametrize("arch", ALL_IDS)
def test_flops_bytes_rows_equal_reference(arch):
    """flops_for, bytes_for and moe_rows_per_token equal the reference's
    (rel 1e-12) on every shape of the arch, every MoE backend and remat on
    and off; the parameter counts are equal."""
    tcfg, jcfg = get_config(arch), jget_config(arch)
    n = count_params(tcfg)
    assert n == jcount_params(jget_family(jcfg).specs(jcfg))
    assert [s.name for s in shapes_for(tcfg)] == [s.name for s in jshapes_for(jcfg)]
    for (label, t), (_, j) in zip(_variants(tcfg), _variants(jcfg)):
        for shape, jshape in zip(shapes_for(t), jshapes_for(j)):
            for opt in ("adamw", "adafactor"):
                got = costs.bytes_for(t, shape, n, optimizer=opt)
                want = jcosts.bytes_for(j, jshape, n, optimizer=opt)
                assert math.isclose(got, want, rel_tol=1e-12), (label, shape.name, opt)
            got, want = costs.flops_for(t, shape), jcosts.flops_for(j, jshape)
            assert math.isclose(got, want, rel_tol=1e-12), (label, shape.name, got, want)
        if t.moe.num_experts:
            for tpg in (1, 7, t.moe.group_size, 4096):
                got = costs.moe_rows_per_token(t.moe, tpg)
                want = jcosts.moe_rows_per_token(j.moe, tpg)
                assert math.isclose(got, want, rel_tol=1e-12), (label, tpg)


def _train_flops(cfg, shape):
    """counted_flops of a forward + backward of the family's loss over a
    ``meta`` batch of ``shape`` (the reference probe's ``jax.grad``)."""
    fam = get_family(cfg)
    params = abstract(cfg, train=True)
    for p in flat_params(params).values():
        p.requires_grad_(True)
    batch = fam.input_specs(cfg, shape)

    def step():
        logits, aux = fam.forward(params, batch, cfg)
        loss, _ = total_loss(logits, batch["labels"], aux)
        torch.autograd.grad(loss, list(flat_params(params).values()), allow_unused=True)

    return costs.counted_flops(step)


@pytest.mark.parametrize("arch", ["qwen3-8b", "olmoe-1b-7b", "zamba2-7b",
                                  "seamless-m4t-large-v2", "xlstm-125m"])
def test_counted_flops_within_band_of_analytic(arch):
    """The analytic FLOPs agree with the FLOPs a ``meta`` trace of one
    forward and backward counts, within the reference's band for its
    probes against XLA (``test_distributed.py:143-167``: 0.6-1.7), on the
    same smoke configs at 4 x 128, unrolled and without remat."""
    cfg = get_smoke_config(arch).replace(scan_layers=False, remat=False)
    shape = ShapeConfig("probe", seq_len=128, global_batch=4, kind="train")
    ratio = costs.flops_for(cfg, shape) / _train_flops(cfg, shape)
    assert 0.6 < ratio < 1.7, (arch, ratio)


def test_roofline_properties_on_hand_numbers():
    r = roofline.Roofline(flops=989e12 * 8, bytes_accessed=3.35e12 * 2,
                          collective_bytes=50e9 * 8 * 3, chips=8, model_flops=989e12 * 4)
    assert r.t_compute == pytest.approx(1.0)
    assert r.t_memory == pytest.approx(0.25)
    assert r.t_collective == pytest.approx(3.0)
    assert r.dominant == "collective" and r.bound_time == pytest.approx(3.0)
    assert r.useful_flops_ratio == pytest.approx(0.5)
    assert r.mfu_bound == pytest.approx(4.0 / (8 * 3.0))
    d = r.to_dict()
    assert d["dominant"] == "collective" and d["t_compute"] == pytest.approx(1.0)
    fast = roofline.Roofline(1.0, 0.0, 0.0, 1, collective_bw=roofline.NVLINK_BW)
    assert fast.dominant == "compute" and fast.useful_flops_ratio is None
    assert fast.mfu_bound is None
    assert roofline.model_flops_train(1e9, 1e3) == 6e12
    assert roofline.model_flops_forward(1e9, 1e3) == 2e12


def test_collective_bandwidth_by_axis():
    single = (("data", 16), ("model", 16))
    assert roofline.axis_bandwidth(single, "model") == roofline.NETWORK_BW
    assert roofline.axis_bandwidth((("data", 2), ("model", 4)), "model") == roofline.NVLINK_BW
    assert roofline.axis_bandwidth((("data", 2), ("model", 4)), "data") == roofline.NVLINK_BW
    assert roofline.axis_bandwidth((("data", 4), ("model", 4)), "data") == roofline.NETWORK_BW
    bw = {"a": 1.0, "b": 4.0}
    assert roofline.effective_bandwidth({"a": 2.0, "b": 8.0}, bw) == pytest.approx(10.0 / 4.0)
    assert roofline.effective_bandwidth({}, bw) == roofline.NETWORK_BW


def test_peaks_and_kernel_bound_are_chip_smokes():
    """The card's peaks are the values ``chip_smoke.py`` bounded every
    kernel with (it imports them, and ``kernel_bound``, from here), and
    ``kernel_bound`` is its former ``roofline``."""
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    src = (Path(__file__).resolve().parents[1] / "chip_smoke.py").read_text()
    assert "from repro_torch.distributed.roofline import" in src
    assert "HBM_BYTES_PER_S =" not in src and "BF16_FLOPS_PER_S =" not in src
    for nbytes, flops in ((1e6, 1e9), (1e9, 1e9), (3.35e12, 989e12 * 2)):
        t_bytes, t_ops = nbytes / 3.35e12, flops / 989e12
        ms, by = roofline.kernel_bound(nbytes, flops)
        assert ms == max(t_bytes, t_ops) * 1e3
        assert by == ("bytes" if t_bytes >= t_ops else "operations")


def test_meta_trace_peak_and_ops_by_hand():
    """A trace counted by hand: a 1000 x 1000 f32 weight (4 MB) and a
    10 x 1000 input live before it; relu(x @ w), summed, backward."""
    w = torch.empty(1000, 1000, device="meta", requires_grad=True)
    x = torch.empty(10, 1000, device="meta")
    tr = MetaTrace()
    with tr:
        tr.track((w, x))
        assert tr.live == 4_000_000 + 40_000
        y = (x @ w).relu()            # mm 40 000, relu 40 000
        y.sum().backward()            # 4 (sum) + 4 (ones) + 40 000 (relu grad) + 4 MB (w.grad)
        del y
    # the peak is at the backward's last op: w and w.grad, x, relu's output
    # (saved for its backward; the mm output it replaced is gone), relu's
    # input gradient, and the two scalars
    assert tr.peak == 4_000_000 * 2 + 40_000 * 3 + 8
    assert tr.live == 4_000_000 * 2 + 40_000
    assert tr.op_histogram()["mm"] == 2 and tr.op_histogram()["relu"] == 1


def test_kernel_wrappers_on_meta_allocate_what_cuda_does():
    """On ``meta`` tensors each kernel wrapper makes the CUDA route's output
    (and the grouped FFNs their h workspace, freed at return) and launches
    nothing: its launch counter stays."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.moe_dropless import ops as mdo
    from repro_torch.kernels.moe_ffn import ops as mfo
    from repro_torch.quant.policy import get_kv_quant

    bf = torch.bfloat16

    def m(*shape, dtype=bf):
        return torch.empty(shape, dtype=dtype, device="meta")

    tr = MetaTrace()
    with tr:
        y = mfo.moe_ffn(m(4, 16, 64), m(4, 64, 128), None, m(4, 128, 64), "gelu")
    assert y.shape == (4, 16, 64) and y.device.type == "meta"
    # x's save, y, and the tensor-core route's (2, E*X, I) bf16 h
    assert tr.peak >= 2 * 4 * 16 * 128 * 2 + 4 * 16 * 64 * 2
    y = mdo.ragged_ffn(m(64, 64), m(2, dtype=torch.int32), m(4, 64, 128), None,
                       m(4, 128, 64), "gelu", block_x=32)
    assert y.shape == (64, 64)
    with torch.no_grad():
        assert fa.flash_attention(m(1, 16, 4, 64), m(1, 16, 2, 64), m(1, 16, 2, 64)).shape == (
            1, 16, 4, 64)
    lens = m(2, dtype=torch.int32)
    assert da.decode_attention(m(2, 4, 64), m(2, 32, 2, 64), m(2, 32, 2, 64), lens).shape == (
        2, 4, 64)
    tbl = m(2, 3, dtype=torch.int32)
    assert da.paged_decode_attention(m(2, 4, 64), m(8, 2, 16, 64), m(8, 2, 16, 64), tbl,
                                     lens).shape == (2, 4, 64)
    codes = m(8, 2, 16, 64, dtype=torch.int8)
    sc = m(8, 2, dtype=torch.float32)
    assert da.quantized_paged_decode_attention(m(2, 4, 64), codes, codes, sc, sc, tbl, lens,
                                               policy=get_kv_quant("int8")).shape == (2, 4, 64)
    for fn in (mfo.moe_ffn, mdo.ragged_ffn, fa.flash_attention, da.decode_attention,
               da.paged_decode_attention, da.quantized_paged_decode_attention):
        assert fn.launches == 0
