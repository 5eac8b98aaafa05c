"""Run one cell of the benchmark once.

    python3 cdbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The last line of standard output is the
result (one JSON object); the numbers compared for ``correct`` are the last
lines of standard error. Exits 2 without a CUDA device, or with fewer than
the cell asks for.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the program's kernel caches stay at fixed paths inside the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path = [ROOT, os.path.join(ROOT, "src")] + [
    p for p in sys.path if os.path.abspath(p or ".") != HERE]

from cdbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
