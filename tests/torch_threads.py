"""Cap torch's intra-op threads in the port's test processes.

The tier-1 command runs the tests in several pytest-xdist workers on one
machine. Each worker running torch at its default thread count (one a core)
oversubscribes OpenMP, and small products then slow down by up to two
orders of magnitude. Every ``tests/test_torch_*.py`` imports this module:
it gives each worker its share of the cores, and exports the same cap as
``OMP_NUM_THREADS`` to any child process a test starts.
"""
import os

import torch

THREADS = max(1, (os.cpu_count() or 1)
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
os.environ["OMP_NUM_THREADS"] = str(THREADS)
