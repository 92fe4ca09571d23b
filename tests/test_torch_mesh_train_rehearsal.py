"""A CPU rehearsal of ``chip_smoke.py`` phase 17 (b): its four runs on a
(data 2, model 2) mesh of four gloo ranks, at m6-base's smoke size (a
batch of 8 x 32: 8 groups of 32, two a model rank), then Fig. 4's MoE
attention, top-1 at 8 x 32 (four groups a data rank) and 2 top-1 at 8 x 36
(9 groups, straddling the data ranks), then the FSDP run, against the
single-device port on the same batch.  ``mesh_train_ranks`` raises where
a gate of the card's run fails (every rank's loss equal at every step;
loss, gradient norm and every leaf's gradient cosine against the
single-device step; all_to_all a step; half the AdamW state a rank; a
rank's parameter bytes its placement's; the MoE-attention layers'
collectives a step as predicted); the kernels' launch gates are the
card's alone (the CPU runs their plain versions)."""
import os
import sys

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMOKE = ["--arch", "m6-base", "--smoke", "--batch", "8", "--seq", "32", "--log-every", "1"]


def _chip_smoke():
    """``chip_smoke`` as ``sys.modules`` holds it now (another test file may
    have loaded it under that name): the spawned ranks import it by name,
    so the rank body must be that module's."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    if "chip_smoke" not in sys.modules:
        import chip_smoke  # noqa: F401
    return sys.modules["chip_smoke"]


def test_phase17_runs_on_the_cpu(tmp_path):
    import torch

    chip_smoke = _chip_smoke()
    runs = tuple((label, flags, 2, steps) for label, flags, _, steps in chip_smoke.MESH_TRAIN_RUNS)
    fig4 = tuple((label, ["--moe-impl", "pallas"] + ([] if edit == "top-1" else ["--seq", "36"]),
                  layers, steps, edit)
                 for label, _, layers, steps, edit in chip_smoke.MESH_TRAIN_FIG4)
    report, launches = chip_smoke.mesh_train_ranks(torch, str(tmp_path), "cpu", SMOKE, runs, fig4)
    assert launches == {"moe_ffn": 0, "ragged_ffn": 0}
    for label, _, layers, steps, *edit in runs + fig4:
        r = report[label]
        assert len(r["losses"]) == steps and len(r["ranks"]) == 4
        assert r["min_grad_cosine"] >= 0.99 and not r["routing_flips"]
        assert r["losses"][0] == pytest.approx(r["single_device_loss"], abs=1e-5)
        assert r["straddling"] == (edit == ["2 top-1"])
        assert bool(r["moe_attention_collectives_a_step"]) == bool(edit)
    assert report["fsdp"]["fsdp_leaves"] > 0
