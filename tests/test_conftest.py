"""The suite's harness in the repository's root `conftest.py`: the per-test
time limit and each process's share of the compute threads."""

import os
from pathlib import Path

import jax
import torch

pytest_plugins = ["pytester"]

CONFTEST = Path(__file__).parents[1] / "conftest.py"


def test_time_limit_fails_a_slow_test_and_kills_its_children(pytester):
    """With the limit patched to 1 s, a test that sleeps 3 s fails with the
    limit in its message, the subprocess it started is killed, and a fast
    test passes."""
    pytester.makeconftest(f"""
import importlib.util
from pathlib import Path

spec = importlib.util.spec_from_file_location("suite_conftest", {str(CONFTEST)!r})
suite = importlib.util.module_from_spec(spec)
spec.loader.exec_module(suite)
suite.TEST_TIME_LIMIT = 1
suite.SUITE = Path(__file__).parent
pytest_runtest_call = suite.pytest_runtest_call
""")
    pytester.makepyfile("""
import subprocess
import time

started = []


def test_slow():
    started.append(subprocess.Popen(["sleep", "60"]))
    time.sleep(3)


def test_fast():
    assert started[0].wait(timeout=10) == -9
""")
    result = pytester.runpytest_subprocess("-p", "no:cacheprovider")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines(["*test_slow*", "*per-test time limit of 1 s*"])


def test_worker_takes_its_share_of_the_cores():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    assert torch.get_num_threads() == max(1, len(os.sched_getaffinity(0)) // workers)
    assert len(jax.devices("cpu")) == 8
