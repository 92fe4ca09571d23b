"""The port's checkpoints and restarts against the JAX reference, on the CPU.

The reference's ``Checkpointer`` and the port's read and write one format
(``<dir>/step_<n>/manifest.json`` + one ``.npy`` a leaf): a checkpoint
either writes restores in the other with every leaf bit-equal, bf16 leaves
included, and the port's files are byte for byte the reference's.  Then
the reference's own checkpoint and fault-tolerance tests
(``test_training.py``, ``test_system.py``, ``test_serving.py``,
``test_properties.py``), mirrored on the port, and both CLIs with
``--ckpt-dir``.
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.configs import m6 as jm6
from repro.configs.base import ServeConfig as JServeConfig
from repro.models.registry import get_family
from repro.nn import init as jinit
from repro.optim.adamw import adamw as jadamw
from repro.serving.continuous import ContinuousEngine as JEngine
from repro.train.state import init_train_state as j_init_train_state
from repro_torch.checkpoint import Checkpointer, jax_key, port_path
from repro_torch.configs import m6 as tm6
from repro_torch.configs.base import ServeConfig as TServeConfig
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import make_pipeline
from repro_torch.distributed.fault import Heartbeat, StepWatchdog, run_with_restarts
from repro_torch.nn import flat_params, init_params, lm_shapes
from repro_torch.optim import make_optimizer, warmup_constant
from repro_torch.optim.adamw import adamw as tadamw
from repro_torch.serving.continuous import ContinuousEngine as TEngine
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.trainer import make_train_step
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.join(os.path.dirname(__file__), "..")
CLI = ["--arch", "m6-base", "--smoke", "--moe-impl", "pallas", "--batch", "4", "--seq", "36",
       "--device", "cpu", "--log-every", "1"]


def _cfgs():
    jcfg = jm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    tcfg = tm6.smoke().replace_moe(impl="dropless", capacity_factor=None)
    return jcfg, tcfg


def _bits(a) -> np.ndarray:
    """The bit patterns of an array or tensor (bf16 and f32 alike), so that
    equality is bit-equality."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy().view(
            {2: np.int16, 4: np.int32, 8: np.int64}[a.element_size()])
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 8: np.int64}[a.dtype.itemsize])


def _ref_leaves(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_train_state(jcfg, seed=0):
    """A reference TrainState: params, an AdamW state with random moments
    (as after some steps) and step 3."""
    params = jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(seed))
    state = j_init_train_state(params, jadamw(lambda s: 1e-3))
    keys = iter(jax.random.split(jax.random.PRNGKey(seed + 1), 64))
    rand = lambda x: jax.random.normal(next(keys), x.shape, x.dtype)   # noqa: E731
    opt = {"mu": jax.tree_util.tree_map(rand, state.opt_state["mu"]),
           "nu": jax.tree_util.tree_map(lambda x: jnp.abs(rand(x)), state.opt_state["nu"])}
    return state._replace(opt_state=opt, step=jnp.asarray(3, jnp.int32))


def _port_train_state(tcfg):
    params = init_params(tcfg, seed=5, device="cpu", train=True)
    return init_train_state(params, tadamw(lambda s: 1e-3))


def _port_leaves(state: TrainState) -> dict:
    out = {}
    for path, t in flat_params(state.params).items():
        out[".params" + jax_key(path)] = t
        for m in ("mu", "nu"):
            out[f".opt_state['{m}']" + jax_key(path)] = state.opt_state[m][path]
    return out


def _same_files(d1, d2):
    """Every file of two checkpoint directories byte for byte."""
    names = sorted(os.listdir(d1))
    assert names == sorted(os.listdir(d2))
    for n in names:
        with open(os.path.join(d1, n), "rb") as f1, open(os.path.join(d2, n), "rb") as f2:
            assert f1.read() == f2.read(), n


def test_keys_follow_the_param_tree_mapping():
    """``jax_key`` of every port path is the reference's keystr of the same
    leaf (the path ``from_jax_params`` walks); ``port_path`` inverts it and
    refuses keys that are not a param path."""
    jcfg, tcfg = _cfgs()
    for train in (False, True):
        ref = {jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(
            jax.eval_shape(lambda: jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(0))))[0]}
        paths = list(flat_params(lm_shapes(tcfg, train)))
        assert {jax_key(p) for p in paths} == ref
        assert [port_path(jax_key(p)) for p in paths] == paths
    for bad in (".step", ".params['embed']['table']", "[0]", "['a'][0]"):
        with pytest.raises(ValueError):
            port_path(bad)


def test_reference_train_checkpoint_round_trips_both_ways(tmp_path):
    """The reference saves a TrainState (m6 smoke params, AdamW moments,
    step 3); the port restores every leaf bit-equal.  The port saves that
    state; the reference restores it bit-equal, and every file of the two
    checkpoints, manifest included, is the same bytes."""
    jcfg, tcfg = _cfgs()
    jstate = _ref_train_state(jcfg)
    JCheckpointer(str(tmp_path / "ref")).save(3, jstate)
    want = _ref_leaves(jstate)

    state = Checkpointer(str(tmp_path / "ref")).restore(3, _port_train_state(tcfg))
    assert state.step == 3 and isinstance(state.step, int)
    got = _port_leaves(state)
    assert set(got) | {".step"} == set(want)
    for key, t in got.items():
        np.testing.assert_array_equal(_bits(t), _bits(want[key]), err_msg=key)

    Checkpointer(str(tmp_path / "port")).save(3, state)
    back = JCheckpointer(str(tmp_path / "port")).restore(3, jax.eval_shape(lambda: jstate))
    for key, arr in _ref_leaves(back).items():
        np.testing.assert_array_equal(_bits(arr), _bits(want[key]), err_msg=key)
        assert arr.dtype == want[key].dtype
    manifests = [json.load(open(tmp_path / d / "step_3" / "manifest.json"))
                 for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    _same_files(tmp_path / "ref" / "step_3", tmp_path / "port" / "step_3")


def _bf16_trees(jcfg, tcfg):
    """A bf16 params tree in each package (every leaf bf16)."""
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16),
                                jinit(get_family(jcfg).specs(jcfg), jax.random.PRNGKey(2)))
    tp = {}
    for path in flat_params(lm_shapes(tcfg)):
        node = tp
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        shape = lm_shapes(tcfg)
        for k in parts:
            shape = shape[k]
        node[parts[-1]] = torch.zeros(shape.shape, dtype=torch.bfloat16)
    return jp, tp


def test_bf16_params_checkpoint_round_trips_both_ways(tmp_path):
    """A bf16 params-only checkpoint: the reference writes its leaves as raw
    2-byte void with dtype "bfloat16"; the port reads them bit-equal and
    writes the same bytes, which the reference reads back through
    ml_dtypes."""
    jcfg, tcfg = _cfgs()
    jp, tp = _bf16_trees(jcfg, tcfg)
    JCheckpointer(str(tmp_path / "ref")).save(1, jp)
    entry = json.load(open(tmp_path / "ref" / "step_1" / "manifest.json"))["leaves"][0]
    assert entry["dtype"] == "bfloat16"
    assert np.load(tmp_path / "ref" / "step_1" / entry["file"]).dtype == np.dtype("V2")
    want = _ref_leaves(jp)

    restored, step = Checkpointer(str(tmp_path / "ref")).restore_latest(tp)
    assert step == 1
    for path, t in flat_params(restored).items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(t), _bits(want[jax_key(path)]), err_msg=path)

    Checkpointer(str(tmp_path / "port")).save(1, restored)
    back = JCheckpointer(str(tmp_path / "port")).restore(1, jax.eval_shape(lambda: jp))
    for key, arr in _ref_leaves(back).items():
        assert arr.dtype == jnp.bfloat16
        np.testing.assert_array_equal(_bits(arr), _bits(want[key]), err_msg=key)
    _same_files(tmp_path / "ref" / "step_1", tmp_path / "port" / "step_1")


def test_bf16_checkpoint_restores_without_jax_or_ml_dtypes(tmp_path):
    """The port reads the reference's bf16 checkpoint in a process where
    ``jax`` and ``ml_dtypes`` cannot be imported."""
    jcfg, tcfg = _cfgs()
    jp, tp = _bf16_trees(jcfg, tcfg)
    JCheckpointer(str(tmp_path)).save(7, jp)
    want = sum(int(_bits(a).astype(np.int64).sum()) for a in _ref_leaves(jp).values())
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import torch\n"
        "from repro_torch.checkpoint import Checkpointer\n"
        "from repro_torch.configs import m6\n"
        "from repro_torch.nn import flat_params, init_params\n"
        "cfg = m6.smoke()\n"
        "tmpl = init_params(cfg, device='cpu')\n"
        "for t in flat_params(tmpl).values():\n"
        "    t.data = t.data.to(torch.bfloat16)\n"
        f"tree, step = Checkpointer({str(tmp_path)!r}).restore_params_latest(tmpl)\n"
        "assert 'ml_dtypes' not in [k for k, v in sys.modules.items() if v is not None]\n"
        "print(step, sum(int(t.view(torch.int16).long().sum()) "
        "for t in flat_params(tree).values()))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split() == ["7", str(want)]


def test_restore_params_of_a_train_checkpoint_serves_reference_tokens(tmp_path):
    """``restore_params`` of the reference's train checkpoint into the
    port's serving tree serves m6 smoke greedy tokens identical to the JAX
    engine's over the same params, on the same prompts."""
    jcfg, tcfg = _cfgs()
    jstate = _ref_train_state(jcfg, seed=3)
    JCheckpointer(str(tmp_path)).save(3, jstate)
    params, step = Checkpointer(str(tmp_path)).restore_params_latest(
        init_params(tcfg, seed=9, device="cpu"))
    assert step == 3
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (5, 13)).astype(np.int32)
    kw = dict(max_slots=3, kv_block_size=8, prefill_chunk=5, max_len=32)
    jtoks, _ = JEngine(jcfg, jstate.params, JServeConfig(**kw)).generate(prompts, 7)
    ttoks, _ = TEngine(tcfg, params, TServeConfig(**kw), device="cpu").generate(prompts, 7)
    jax.effects_barrier()
    np.testing.assert_array_equal(np.asarray(jtoks), ttoks)


# -- the reference's own tests, mirrored ---------------------------------------


def _trainer(tcfg, lr=1e-3):
    tc = TrainConfig(optimizer="adamw", learning_rate=lr, warmup_steps=2)
    opt = make_optimizer(tc, warmup_constant(tc.learning_rate, tc.warmup_steps))
    return opt, make_train_step(tcfg, tc, opt)


def _fresh(tcfg, opt, seed=0):
    return init_train_state(init_params(tcfg, seed=seed, device="cpu", train=True), opt)


def _batches(tcfg, n, batch=4, seq=36):
    pipe = make_pipeline(tcfg, batch, seq, seed=2)
    return [{k: torch.from_numpy(v) for k, v in pipe.batch_at(i).items()} for i in range(n)]


def _params_bits(state) -> dict:
    return {k: _bits(v) for k, v in flat_params(state.params).items()}


def _assert_same_params(a, b):
    pa, pb = _params_bits(a), _params_bits(b)
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_checkpoint_restart_exact_resume(tmp_path):
    """(``test_training.py:82``) Train 6 steps straight == train 3,
    checkpoint, restore into a fresh state, train 3; bit-equal here."""
    tcfg = tm6.smoke().replace_moe(impl="pallas")
    opt, step = _trainer(tcfg)
    batches = _batches(tcfg, 6)
    s = _fresh(tcfg, opt)
    for b in batches:
        s, _ = step(s, b)
    straight = s

    ck = Checkpointer(str(tmp_path))
    s = _fresh(tcfg, opt)
    for b in batches[:3]:
        s, _ = step(s, b)
    ck.save(3, s)
    restored = ck.restore(3, _fresh(tcfg, opt, seed=1))
    assert restored.step == 3
    for b in batches[3:]:
        restored, _ = step(restored, b)
    _assert_same_params(straight, restored)


def test_checkpoint_async_and_keep_last(tmp_path):
    """(``test_training.py:117``)"""
    ck = Checkpointer(str(tmp_path), keep=2)
    for s_i in [1, 2, 3, 4]:
        ck.save_async(s_i, {"x": torch.full((4,), float(s_i))})
    ck.wait()
    assert ck.all_steps() == [3, 4]
    got = ck.restore(4, {"x": torch.zeros(4)})
    np.testing.assert_array_equal(got["x"].numpy(), 4.0)


def test_save_async_snapshots_before_returning(tmp_path):
    """The train step updates tensors in place: what ``save_async`` writes
    is their value when it was called, not after."""
    ck = Checkpointer(str(tmp_path))
    x = torch.arange(1 << 16, dtype=torch.float32)
    ck.save_async(1, {"x": x})
    x.add_(1.0)
    ck.wait()
    np.testing.assert_array_equal(ck.restore(1, {"x": torch.zeros(1 << 16)})["x"].numpy(),
                                  np.arange(1 << 16, dtype=np.float32))


def test_run_with_restarts_resumes_after_failure():
    """(``test_training.py:131``)"""
    attempts = []

    def resume():
        return len(attempts)

    def loop(start):
        attempts.append(start)
        if len(attempts) < 3:
            raise RuntimeError("simulated worker failure")
        return 99

    assert run_with_restarts(loop, resume, max_restarts=5) == 99
    assert attempts == [0, 1, 2]
    attempts.clear()
    with pytest.raises(RuntimeError, match="simulated"):
        run_with_restarts(loop, resume, max_restarts=1)


def test_watchdog_flags_stragglers():
    """(``test_training.py:140``)"""
    wd = StepWatchdog(threshold=2.0, warmup=2)
    for _ in range(10):
        wd.observe(1.0)
    assert wd.observe(5.0) is True
    assert wd.straggler_events == 1
    assert wd.observe(1.0) is False


def test_heartbeat_writes_liveness_file(tmp_path):
    path = tmp_path / "beat"
    hb = Heartbeat(str(path), interval=0.01).start()
    try:
        for _ in range(500):
            if path.exists() and path.read_text():
                break
            time.sleep(0.01)
        assert float(path.read_text()) > 0
    finally:
        hb.stop()


def test_train_checkpoint_restart_serve(tmp_path):
    """(``test_system.py:21``) Train m6 smoke (4 top-1 prototyping),
    checkpoint asynchronously, restore from it as after a failure and replay
    the same data: the params equal the uninterrupted run's; the loss falls;
    the trained params serve through the continuous engine."""
    tcfg = tm6.smoke().replace_moe(routing="prototype", num_prototypes=2, impl="pallas")
    opt, step = _trainer(tcfg, lr=3e-3)
    batches = _batches(tcfg, 8, batch=8)
    state = _fresh(tcfg, opt)
    losses = []
    ck = Checkpointer(str(tmp_path))
    for i, b in enumerate(batches):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        if i == 5:
            ck.save_async(i + 1, state)
    ck.wait()
    restored = ck.restore(6, _fresh(tcfg, opt, seed=1))
    for b in batches[6:]:
        restored, _ = step(restored, b)
    _assert_same_params(state, restored)
    assert losses[-1] < losses[0]

    serve = TServeConfig(max_slots=2, kv_block_size=8, prefill_chunk=8, max_len=32)
    params = Checkpointer(str(tmp_path)).restore_params(6, init_params(tcfg, device="cpu"))
    toks, stats = TEngine(tcfg, params, serve, device="cpu").generate(
        batches[0]["tokens"][:2, :8].numpy(), 8)
    assert toks.shape == (2, 8)
    assert stats["generated_tokens"] == 16


@pytest.mark.parametrize("layout", ["train", "bare"])
def test_checkpointer_params_only_restore(tmp_path, layout):
    """(``test_serving.py:308``) Params-only restore from a train checkpoint
    (the ``.params`` leaves) and from a bare-params one."""
    tcfg = tm6.smoke()
    opt, _ = _trainer(tcfg)
    state = _fresh(tcfg, opt, seed=7)
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state if layout == "train" else state.params)
    restored, step = ck.restore_params_latest(init_params(tcfg, seed=8, device="cpu"))
    assert step == 3
    _assert_same_params(state, TrainState(restored, None, 0))


@given(st.integers(0, 2**16))
@settings(max_examples=10, deadline=None)
def test_checkpoint_roundtrip_property(seed):
    """(``test_properties.py:79``)"""
    import tempfile

    g = torch.Generator().manual_seed(seed)
    tree = {"a": torch.randn((3, 5), generator=g),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "c": torch.randn((2,), generator=g).to(torch.bfloat16)}}
    with tempfile.TemporaryDirectory() as d:
        ck = Checkpointer(d)
        ck.save(1, tree)
        restored = ck.restore(1, {"a": torch.zeros(3, 5), "nested": {
            "b": torch.zeros(7, dtype=torch.int32), "c": torch.zeros(2, dtype=torch.bfloat16)}})
        for path, t in flat_params(tree).items():
            np.testing.assert_array_equal(_bits(flat_params(restored)[path]), _bits(t))


@pytest.mark.parametrize("case", ["tmp", "incomplete"])
def test_unfinished_checkpoints_are_ignored_or_refused(tmp_path, case):
    """A ``step_<n>.tmp`` directory (a save that did not finish) is no step,
    in either package; a manifest not marked complete is refused on
    restore: the reference asserts, the port raises ValueError."""
    tree = {"x": torch.ones(3)}
    Checkpointer(str(tmp_path)).save(1, tree)
    if case == "tmp":
        os.rename(tmp_path / "step_1", tmp_path / "step_2.tmp")
        Checkpointer(str(tmp_path)).save(1, tree)
        assert Checkpointer(str(tmp_path)).all_steps() == [1]
        assert JCheckpointer(str(tmp_path)).all_steps() == [1]
        return
    path = tmp_path / "step_1" / "manifest.json"
    manifest = json.loads(path.read_text())
    path.write_text(json.dumps(dict(manifest, complete=False)))
    with pytest.raises(ValueError, match="incomplete"):
        Checkpointer(str(tmp_path)).restore(1, {"x": torch.zeros(3)})
    with pytest.raises(AssertionError, match="incomplete"):
        JCheckpointer(str(tmp_path)).restore(1, {"x": jax.ShapeDtypeStruct((3,), jnp.float32)})


def test_restore_refuses_missing_leaves_and_wrong_shapes(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"x": torch.ones(3)})
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(1, {"y": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(1, {"x": torch.zeros(4)})


# -- the CLIs -------------------------------------------------------------------


def _final_params(argv, on_step=None):
    from repro_torch.launch.train import build_parser, run

    logs, state = run(build_parser().parse_args(argv), on_step=on_step)
    return logs, state


def test_train_cli_resumes_after_injected_failure(tmp_path):
    """``--ckpt-every 2`` with a failure at step 3: ``run_with_restarts``
    resumes from the checkpoint of step 2 and the final params equal a
    straight run's; the last checkpoint holds step 4 and restores into
    them."""
    _, straight = _final_params(CLI + ["--steps", "4"])
    failed = []

    def fail_once(step, state):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("injected failure")

    logs, resumed = _final_params(CLI + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                                         "--ckpt-every", "2", "--max-restarts", "1"],
                                  on_step=fail_once)
    assert failed == [3]
    assert [m["step"] for m in logs] == [0, 1, 2, 2, 3]        # step 2 again after the restart
    assert resumed.step == 4
    _assert_same_params(straight, resumed)
    ck = Checkpointer(str(tmp_path))
    assert ck.all_steps() == [2, 4]
    opt, _ = _trainer(tm6.smoke())
    _assert_same_params(straight, ck.restore(4, _fresh(tm6.smoke().replace_moe(impl="pallas"),
                                                       opt, seed=3)))


def test_train_cli_restart_waits_for_the_checkpoint_being_written(tmp_path, monkeypatch):
    """A failure while ``save_async``'s files are still being written (a
    large checkpoint) resumes from that checkpoint, not from an older one:
    the restart lets the write finish first."""
    write = Checkpointer._write

    def slow_write(self, step, host):
        time.sleep(1.0)
        return write(self, step, host)

    monkeypatch.setattr(Checkpointer, "_write", slow_write)

    def fail_once(step, state, failed=[]):
        if step == 3 and not failed:
            failed.append(step)
            raise RuntimeError("injected failure")

    logs, _ = _final_params(CLI + ["--steps", "4", "--ckpt-dir", str(tmp_path),
                                   "--ckpt-every", "2", "--max-restarts", "1"],
                            on_step=fail_once)
    assert [m["step"] for m in logs] == [0, 1, 2, 2, 3]


def test_train_cli_resumes_from_an_earlier_run(tmp_path):
    """A run that dies at step 3 with no restarts left, then the same command
    again: it starts from the checkpoint of step 2 and ends where a straight
    run ends."""
    argv = CLI + ["--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                  "--max-restarts", "0"]

    def die(step, state):
        if step == 3:
            raise RuntimeError("worker lost")

    with pytest.raises(RuntimeError, match="worker lost"):
        _final_params(argv, on_step=die)
    assert Checkpointer(str(tmp_path)).all_steps() == [2]
    logs, resumed = _final_params(argv)
    assert [m["step"] for m in logs] == [2, 3]
    _, straight = _final_params(CLI + ["--steps", "4"])
    _assert_same_params(straight, resumed)


def test_serve_cli_restores_params_from_a_train_checkpoint(tmp_path, capsys):
    """``serve --ckpt-dir`` serves the latest checkpoint's params (printing
    the reference's line); its greedy tokens equal an engine's built
    in-process from the trained params."""
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    train_main(CLI + ["--steps", "2", "--ckpt-dir", str(tmp_path)])
    argv = ["--arch", "m6-base", "--smoke", "--engine", "continuous", "--moe-impl",
            "dropless", "--capacity-factor", "none", "--batch", "3", "--prompt-len", "9",
            "--gen", "5", "--max-slots", "2", "--max-len", "32", "--device", "cpu"]
    capsys.readouterr()
    serve_main(argv + ["--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "restored params-only from checkpoint step 2" in out

    _, tcfg = _cfgs()
    params, _ = Checkpointer(str(tmp_path)).restore_params_latest(
        init_params(tcfg, device="cpu"))
    prompts = np.random.default_rng(1).integers(0, tcfg.vocab_size, (3, 9)).astype(np.int32)
    serve = TServeConfig(max_slots=2, max_len=32)
    toks, _ = TEngine(tcfg, params, serve, device="cpu").generate(prompts, 5)
    assert f"generated: {toks[:, :16]}" in out


def test_chip_smoke_checkpoint_phase_runs_on_cpu(tmp_path, capsys):
    """chip_smoke's phase 8, rehearsed at smoke size on the CPU: the
    restart, the bit-equal restores, serving from the checkpoint and the
    save timings, with its temporary directory removed at the end."""
    import importlib.util

    from repro_torch.serving.trace import synthetic_trace

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    argv = [a for a in CLI if a not in ("--device", "cpu")]
    requests = synthetic_trace(6, tm6.smoke().vocab_size, seed=0, prompt_lens=(4, 12),
                               gen_lens=(3, 6))
    out = chip_smoke.checkpoint_phase(torch, argv, device="cpu", requests=requests,
                                      max_len=32, root=tmp_path)
    assert out["straight_runs_max_diff"] == 0.0 and out["resumed_max_diff"] == 0.0
    assert out["served_requests"] == 6 and out["save_s"] > 0
    assert os.listdir(tmp_path) == []
    assert "restored params-only from checkpoint step 4" in capsys.readouterr().out
