"""Golden parity of the port: the slice's reference workloads
(tests/workloads.py) run through pythtb_tpu_torch and are compared with
the numbers PythTB 1.8.0 itself produced, by the golden harness's own
comparison (rtol 1e-8, phases modulo 2 pi, Wilson phases as sets)."""

import io
from contextlib import redirect_stdout

import pytest

import pythtb_tpu_torch

from . import workloads
from .test_golden_parity import _compare

SLICE = [
    "bands_graphene",
    "bands_checkerboard",
    "bands_trestle",
    "molecule_levels",
    "bands_buckled",
    "haldane_bp",
    "cone",
    "kane_mele_flow",
    # hand-filled and rank-3/4 grids through the same wf_array methods
    "three_site_pump",
    "berry_3d",
    "berry_4d",
    "berry_4d_grid",
]


@pytest.mark.parametrize("name", SLICE)
def test_port_matches_reference(name, golden):
    gold = golden(name)
    with redirect_stdout(io.StringIO()):
        result = workloads.ALL[name](pythtb_tpu_torch)
    _compare(result, gold)
