"""`levels.upsample_kernel_pct` on hand-made events: the share of the
`upsample.fields` ranges inside `refine` that hold the upsample kernel."""

from types import SimpleNamespace

import pytest

from benchmark import harness

KERNEL = "void (anonymous namespace)::upsample_fields_kernel<true>(...)"
# two jobs, one boundary each; a third range outside any `refine` range
HOST = [(0.0, 10.0, "job"), (1.0, 10.0, "refine"), (4.0, 5.0, "upsample[g1]"), (4.2, 4.8, "upsample.fields"),
        (10.0, 20.0, "job"), (11.0, 20.0, "refine"), (14.0, 15.0, "upsample[g1]"), (14.1, 14.9, "upsample.fields"),
        (20.5, 21.0, "upsample.fields")]
OTHER = [(0.5, 3.0, "rows_vec_kernel"), (14.3, 14.4, "Memcpy HtoD (Pageable -> Device)")]


def read(device, host=HOST):
    return harness.load_metric("levels.upsample_kernel_pct").read(
        SimpleNamespace(device=device, host=host, jobs=[1, 2]))


def test_every_range_holds_the_kernel():
    assert read(OTHER + [(4.5, 4.5001, KERNEL), (14.5, 14.5002, KERNEL), (20.6, 20.7, KERNEL)]) == 100.0


def test_one_range_of_two_holds_it():
    # the kernel of the range outside `refine`, and one outside every range, count for nothing
    assert read(OTHER + [(4.5, 4.5001, KERNEL), (20.6, 20.7, KERNEL), (16.0, 16.1, KERNEL)]) == pytest.approx(50.0)
    assert read(OTHER) == 0.0


def test_nothing_to_read():
    assert read(OTHER, host=[h for h in HOST if h[2] != "upsample.fields"]) is None
    assert read(OTHER, host=HOST[:3] + HOST[4:7]) is None
    assert read([]) is None
