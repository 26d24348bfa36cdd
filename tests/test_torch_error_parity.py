"""Misuse parity of the port: each of the misuse patterns of
tests/test_error_parity.py must be refused (or accepted) by
pythtb_tpu_torch exactly as pythtb_tpu refuses (or accepts) it."""

import pytest

import pythtb_tpu
import pythtb_tpu_torch

from .test_error_parity import CASES, _outcome
from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_refuses_like_jax(name):
    fn = CASES[name]
    assert _outcome(pythtb_tpu_torch, fn) == _outcome(pythtb_tpu, fn) == "raise"
