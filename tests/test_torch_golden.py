"""Golden parity of the port: every reference workload of
tests/workloads.py, and the two Wannier90 workloads, run through
pythtb_tpu_torch and are compared with the numbers PythTB 1.8.0 itself
produced, by the golden harness's own comparison (rtol 1e-8, phases
modulo 2 pi, Wilson phases as sets)."""

import io
from contextlib import redirect_stdout

import pytest

import pythtb_tpu_torch

from . import workloads
from .test_golden_parity import _compare
from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)

FAMILIES = dict(workloads.ALL)
FAMILIES["w90_synthetic"] = workloads.w90_synthetic
FAMILIES["w90_silicon"] = lambda mod: workloads.w90_silicon(mod, workloads.W90_DATA_DIR)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_port_matches_reference(name, golden):
    gold = golden(name)
    with redirect_stdout(io.StringIO()):
        result = FAMILIES[name](pythtb_tpu_torch)
    _compare(result, gold)
