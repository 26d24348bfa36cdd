"""Misuse parity of the port: each of the misuse patterns of
tests/test_error_parity.py must be refused (or accepted) by
pythtb_tpu_torch exactly as pythtb_tpu refuses (or accepts) it."""

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu_torch

from .test_error_parity import CASES, _outcome
from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_refuses_like_jax(name):
    fn = CASES[name]
    assert _outcome(pythtb_tpu_torch, fn) == _outcome(pythtb_tpu, fn) == "raise"


def _ribbon(M):
    return M.models.graphene().cut_piece(3, 1, glue_edgs=False)


def _one_lead(M):
    Hd, leads, _ = M.negf.hall_bar(M.models.qwz(), (2, 2))
    return M.negf.multi_terminal(Hd, leads[:1], [0.0])


# misuse of the Green's-function and disorder modules: each must raise in
# both packages
GREEN_CASES = {
    "negf_lead_blocks_2d": lambda M: M.negf.lead_blocks(M.models.graphene()),
    "negf_landauer_2d": lambda M: M.negf.landauer_transmission(M.models.graphene(), [0.0]),
    "negf_landauer_bad_layer": lambda M: M.negf.landauer_transmission(_ribbon(M), [0.0], device=np.eye(2)),
    "negf_landauer_spin_spinless": lambda M: M.negf.landauer_transmission(_ribbon(M), [0.0], spin_resolved=True),
    "negf_thermo_zero_t": lambda M: M.negf.thermoelectrics(_ribbon(M), 0.0, 0.0),
    "negf_mode_count_2d": lambda M: M.negf.mode_count(M.models.graphene(), [0.0]),
    "negf_multi_one_lead": lambda M: _one_lead(M),
    "negf_buttiker_same_terminal": lambda M: M.negf.buttiker(np.zeros((3, 3)), 1, 1),
    "negf_hall_bar_small": lambda M: M.negf.hall_bar(M.models.qwz(), (1, 3)),
    "loc_lyapunov_2d": lambda M: M.localization.lyapunov_spectrum(M.models.graphene(), [0.0], 10),
    "loc_lyapunov_negative_w": lambda M: M.localization.lyapunov_spectrum(M.models.chain(), [0.0], 10, disorder=-1.0),
    "loc_lyapunov_zero_length": lambda M: M.localization.lyapunov_spectrum(M.models.chain(), [0.0], 0),
    "loc_pr_q1": lambda M: M.localization.participation_ratio(np.ones(3), q=1.0),
    "imp_g0_finite": lambda M: M.impurity.host_greens_function(M.models.chain().cut_piece(3, 0), [0.0], [0]),
    "imp_g0_orbital_range": lambda M: M.impurity.host_greens_function(M.models.bn(), [0.0], [7], nk=(4, 4)),
    "imp_t_not_hermitian": lambda M: M.impurity.t_matrix(M.models.bn(), [[0.0, 1.0], [0.0, 0.0]], [0.0], [0, 1],
                                                         nk=(4, 4)),
    "imp_bound_window": lambda M: M.impurity.bound_states(M.models.bn(), [[1.0]], [0], (1.0, -1.0), nk=(4, 4)),
    "dis_cpa_finite": lambda M: M.disorder.cpa(M.models.chain().cut_piece(3, 0), [0.0], 4, ("lorentzian", 0.1)),
    "dis_cpa_probs": lambda M: M.disorder.cpa(M.models.chain(), [0.0], 4, ("binary", [0.6, 0.6], [1.0, -1.0])),
    "dis_cpa_kind": lambda M: M.disorder.cpa(M.models.chain(), [0.0], 4, ("gaussian", 0.1)),
    "dis_ensemble_periodic": lambda M: M.disorder.ensemble_realization(M.models.chain(), ("lorentzian", 0.1)),
}


@pytest.mark.parametrize("name", sorted(GREEN_CASES))
def test_port_refuses_green_function_misuse_like_jax(name):
    fn = GREEN_CASES[name]
    assert _outcome(pythtb_tpu_torch, fn) == _outcome(pythtb_tpu, fn) == "raise"
