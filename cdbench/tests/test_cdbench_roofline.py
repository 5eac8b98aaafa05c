"""B1's bound from its shapes, at the card's published peaks."""
import pytest

from cdbench import roofline

# one group of the full S = 16384 pass (chip_smoke.py phase 6): 2080 live
# tiles of 256 × 256, one chunk of 4096 entries, slab (16384, 1, 4096)
PHASE6 = dict(s_pad=16384, gc=1, w=4096, tile=256, launches=1,
              chunk_tiles_run=2080)


def test_one_launch_at_phase_6_shapes_is_5_52_gb_by_bytes():
    nbytes, i8, f32 = roofline.b1_bound(**PHASE6)
    assert nbytes == 5_519_704_064
    assert i8 == 2080 * 2 * 256 * 256 * 4096
    assert f32 == 2080 * 256 * 256 * 37
    seconds, by = roofline.least_seconds(nbytes, i8, f32)
    assert by == "bytes"
    assert seconds * 1e3 == pytest.approx(1.6477, abs=1e-4)


def test_a_pass_sums_its_launches():
    # three groups of one chunk: 2080, 1000 and 7 live tiles
    lives = [2080, 1000, 7]
    n_blocks = 64
    stats = {"tile": 256, "chunk_group": 1, "chunk_width": 4096,
             "tiles_total": n_blocks * (n_blocks + 1) // 2,
             "chunk_tiles_run": sum(lives), "kernel_launches": len(lives)}
    got = roofline.b1_pass(stats)
    want = [sum(x) for x in zip(*(roofline.b1_bound(16384, 1, 4096, 256, 1, n)
                                  for n in lives))]
    assert list(got) == want


def test_operations_bound_when_the_slab_is_small():
    seconds, by = roofline.least_seconds(1.0, 1.979e15, 0.0)
    assert by == "operations" and seconds == pytest.approx(1.0)
