"""One intra-op thread for the port's CPU tests.

The port's tests run many small torch ops.  With torch's default of a
thread for every core, each op's OpenMP workers contend for the cores the
other pytest workers are using, and a test that takes seconds alone takes
minutes in a loaded run.  A test module that imports ``one_torch_thread``
runs its tests with one torch thread (and ``OMP_NUM_THREADS=1`` for the
processes it starts), and puts the thread count back after the module.
What the tests compute and check is the same at any thread count.
"""
import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads, env = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    torch.set_num_threads(threads)
    if env is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = env
