"""A mesh rank's teardown (``repro_torch.launch.mesh.teardown``, what every
spawned rank runs when its body returns) joins every thread its gloo
groups started, before the interpreter's own teardown.

``destroy_process_group`` alone leaves them running: the collectives'
byte counters name the mesh's groups (``collectives.name_group``) and so
hold them, and a group destroyed during the interpreter's teardown with a
joinable thread aborts its process (``terminate called without an active
exception``), which failed the spawned mesh tests now and then.  Each case
runs in a fresh process, whose threads are counted from
``/proc/self/task``.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]

RANK = r"""
import gc, os, sys, tempfile
import torch
import torch.distributed as dist
from repro_torch.distributed import collectives
from repro_torch.launch import mesh as M

def threads():
    return len(os.listdir("/proc/self/task"))

torch.set_num_threads(1)
before = threads()
init = os.path.join(tempfile.mkdtemp(dir=sys.argv[1]), "init")
dist.init_process_group("gloo", init_method="file://" + init, world_size=1, rank=0,
                        timeout=M.TIMEOUT)
mesh = M.make_serve_mesh((("data", 1), ("expert", 1)), "cpu")
x = torch.arange(8, dtype=torch.float32)
for axis in ("data", "expert"):
    collectives.all_gather(x, mesh.group(axis), dim=0)
collectives.all_gather(x, mesh.world, dim=0)
del mesh
running = threads()
if sys.argv[2] == "teardown":
    M.teardown()
else:
    dist.barrier()
    dist.destroy_process_group()
    gc.collect()
print(before, running, threads(), len(collectives._GROUP_NAMES))
"""


def _counts(tmp_path, how):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", RANK, str(tmp_path), how], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return [int(n) for n in out.stdout.split()]


@pytest.mark.parametrize("how", ["teardown", "destroy only"])
def test_teardown_joins_the_groups_threads(tmp_path, how):
    """After ``teardown`` the process runs the threads it ran before it
    joined the group, and no group is named; after
    ``destroy_process_group`` alone the named groups and their threads are
    still there (what ``teardown`` repairs)."""
    before, running, after, named = _counts(tmp_path, how)
    assert running > before
    if how == "teardown":
        assert after == before and named == 0
    else:
        assert after > before and named > 0
