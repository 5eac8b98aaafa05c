"""The benchmark's tests run from the root of the checkout:
``python -m pytest cdbench/tests``. The checkout's root (for ``cdbench``)
and ``src`` (for the program) go on the path; tests that need the card
carry the ``gpu`` marker and skip without one through ``cuda`` below."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (os.path.join(ROOT, "src"), ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

#: A world small enough for the CPU; the cells' other sizes stay.
TINY = {"n_sources": 160, "n_items": 1000, "n_cliques": 6}
#: The serve mix at a size the CPU holds.
TINY_SERVE = {"clients": 4, "max_batch_requests": 2}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
