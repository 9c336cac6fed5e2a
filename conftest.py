"""How the test suite in ``tests/`` runs: each process's share of the
cores, one XLA compile cache per run, the longest files first, and a time
limit per test.  pytest loads this file before ``tests/conftest.py``, so the
thread settings are in place before a torch or XLA backend starts.

Each process gets an equal share of the cores it may run on for torch's
intra-op pool and OpenMP/MKL: under ``pytest -n N`` a worker takes
``cores // N`` threads, at least one; without xdist the one process takes
them all.  XLA's Eigen pool can only be held to one thread, so it is held
when the share is one.  Unbounded, six workers ran ~50 threads each on
eight cores and starved one another's compiles.  Subprocesses a test starts
(gloo ranks, examples) inherit the count through the environment.
"""

import os
import shutil
import signal
import sys
from pathlib import Path

import pytest
import torch

N_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
THREADS = max(1, len(os.sched_getaffinity(0)) // N_WORKERS)
os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = str(THREADS)
torch.set_num_threads(THREADS)

# XLA has no Eigen thread-count flag that keeps tests/conftest.py's 8 CPU
# devices (an ``intra_op_parallelism_threads`` token made jax ignore the
# device count), so one thread is the only budget it can be held to.
flags = os.environ.get("XLA_FLAGS", "")
if THREADS == 1 and "xla_cpu_multi_thread_eigen" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_cpu_multi_thread_eigen=false").strip()

SUITE = Path(__file__).with_name("tests")


def _xla_cache_dir(config):
    """One persistent XLA compile cache per run, shared by its workers:
    tests of a file build the same cascades again and again, and half of
    such a test is compiling.  xdist gives each worker a base temp
    directory inside the controller's, so the workers' parent is the run's
    own directory."""
    base = config._tmp_path_factory.getbasetemp()
    return (base.parent if hasattr(config, "workerinput") else base) / "xla-cache"


# The files whose wall is a large share of the run, in seconds under the
# tier-1 command (`pytest tests/ -m 'not slow' -n 6 --dist loadfile` on 8
# cores, with the settings in this file): the sum of each file's test times
# in the run's junit XML.  xdist's loadfile hands files out in collection
# order (see pytest_configure), so these start first, longest first, and the
# rest follow in collection order.  A new file that runs over ~100 s joins
# the list.
FILE_WALLS = {
    "test_nsharded": 690, "test_trainer_nsharded": 664, "test_parallel": 248,
    "test_torch_parallel": 236, "test_kron_nsharded": 181,
}


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: -FILE_WALLS.get(item.path.stem, 0))


@pytest.hookimpl(trylast=True)  # after the tmp_path plugin has set up
def pytest_configure(config):
    config.option.loadscopereorder = False  # xdist: files in collection order
    jax = sys.modules.get("jax")  # the JAX tests' conftest has imported it
    if jax is not None:
        jax.config.update("jax_compilation_cache_dir", str(_xla_cache_dir(config)))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


def pytest_unconfigure(config):
    # The controller (or the lone process) ends after its workers: the
    # cache goes with the run, so no other tree's entries can be read.
    if not hasattr(config, "workerinput"):
        shutil.rmtree(_xla_cache_dir(config), ignore_errors=True)


# Twice the slowest test's wall under the tier-1 command with the above in
# place, at most 300 s.  The slowest, test_nsharded.py::test_nsharded_trains,
# took 266-276 s there (192-208 s alone), so the cap holds and leaves it only
# ~1.1x: a load far above the usual shows first as that test failing here.
# A test in tests/ past the limit fails on its own instead of the run being
# cut by the command's clock.  The signal is handled between Python
# bytecodes, so a test hung inside one native call (an XLA compile, a
# collective) is not cut.
TEST_TIME_LIMIT = 300


def _kill_children():
    """SIGKILL every child process of this one (gloo ranks started from a
    fixture's thread, examples), so none outlives the test that started it."""
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children") as f:
                pids = [int(pid) for pid in f.read().split()]
        except FileNotFoundError:  # the thread has ended
            continue
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass


def _past_time_limit(signum, frame):
    _kill_children()
    pytest.fail(f"test ran past the per-test time limit of {TEST_TIME_LIMIT} s")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    if not item.path.is_relative_to(SUITE):
        yield
        return
    previous = signal.signal(signal.SIGALRM, _past_time_limit)
    signal.setitimer(signal.ITIMER_REAL, TEST_TIME_LIMIT)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)
