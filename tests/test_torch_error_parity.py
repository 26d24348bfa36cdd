"""Misuse parity of the port: each of the misuse patterns of
tests/test_error_parity.py must be refused (or accepted) by
pythtb_tpu_torch exactly as pythtb_tpu refuses (or accepts) it."""

import warnings

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu.continuation  # noqa: F401  (not imported by the package itself)
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


def _finite(M):
    return M.models.chain().cut_piece(4, 0)


# misuse of the seventh slice's calls (flows, magnetic, family): each must
# raise in both packages
SLICE7_CASES = {
    "dos_finite": lambda M: M.flows.density_of_states(_finite(M), (4,)),
    "dos_mesh_length": lambda M: M.flows.density_of_states(M.models.haldane(), (4,)),
    "pdos_mesh_length": lambda M: M.flows.projected_dos(M.models.haldane(), (4, 4, 4)),
    "velocities_finite": lambda M: M.flows.band_velocities(_finite(M), [[0.0]]),
    "spin_texture_spinless": lambda M: M.flows.spin_texture(M.models.haldane(), [0], [[0.0, 0.0]]),
    "spin_texture_k_shape": lambda M: M.flows.spin_texture(M.models.kane_mele(), [0], [[0.0, 0.0, 0.0]]),
    "quadrupole_3d": lambda M: M.flows.quadrupole(M.models.fu_kane_mele()),
    "quadrupole_occ_range": lambda M: M.flows.quadrupole(M.models.bbh(), occ=(0, 9), nk=(5, 5)),
    "sector_not_hermitian": lambda M: M.flows.sector_chern(M.models.bhz(), (0, 1), np.eye(4, k=1)),
    "sector_split": lambda M: M.flows.sector_chern(M.models.bhz(), (0, 1), [1.0, -1.0, 1.0, -1.0], split=3),
    "spin_chern_spinless": lambda M: M.flows.spin_chern(M.models.haldane()),
    "spin_chern_odd_occ": lambda M: M.flows.spin_chern(M.models.kane_mele(), (0,)),
    "valley_points_shape": lambda M: M.flows.valley_chern(M.models.bn(), [0], [[0.5]], nk=(5, 5)),
    "valley_occ_range": lambda M: M.flows.valley_chern(M.models.bn(), [5], [[0.3, 0.6]], nk=(5, 5)),
    "parity_z2_spinless": lambda M: M.flows.parity_z2(M.models.haldane(), (0,)),
    "parity_polarization_2d": lambda M: M.flows.parity_polarization(M.models.haldane(), [0]),
    "find_nodes_band": lambda M: M.flows.find_nodes(M.models.haldane(), band=5),
    "find_nodes_finite": lambda M: M.flows.find_nodes(_finite(M)),
    "node_chirality_2d": lambda M: M.flows.node_chirality(M.models.haldane(), [0.3, 0.6]),
    "second_chern_slices": lambda M: M.flows.second_chern([M.models.fu_kane_mele()] * 3, (0, 1)),
    "second_chern_2d": lambda M: M.flows.second_chern([M.models.haldane()] * 5, (0,), nk=(3, 3, 3)),
    "axion_theta_slices": lambda M: M.flows.axion_theta([M.models.fu_kane_mele()] * 4, (0, 1)),
    "hofstadter_finite_dir": lambda M: M.magnetic.hofstadter_fn(M.models.haldane().cut_piece(3, 0), 3),
    "hofstadter_q_zero": lambda M: M.magnetic.hofstadter_fn(M.models.haldane(), 0),
    "streda_irrational": lambda M: M.magnetic.streda_labels(M.models.haldane(), 0.5, 3, nk=5),
    "family_empty": lambda M: M.family([]),
    "family_mixed_dims": lambda M: M.family([M.models.haldane(), M.models.chain()]),
    "family_nocc": lambda M: M.family([M.models.haldane()]).chern(nocc=[3], nk=(5, 5)),
}


@pytest.mark.parametrize("name", sorted(SLICE7_CASES))
def test_port_refuses_slice_seven_misuse_like_jax(name):
    fn = SLICE7_CASES[name]
    assert _outcome(pythtb_tpu_torch, fn) == _outcome(pythtb_tpu, fn) == "raise"


def _loop(M, nk=5):
    wf = M.wf_array(M.models.haldane(), [nk, nk])
    wf.solve_on_grid([0.0, 0.0])
    return wf


# misuse of the eighth slice's calls (transport, Wannier functions,
# unfolding, entanglement, symmetry, checkpoints): each must raise in both
# packages
SLICE8_CASES = {
    "smooth_gauge_dir": lambda M: _loop(M).smooth_gauge([0], dir=2),
    "smooth_gauge_occ_range": lambda M: _loop(M).smooth_gauge([5], dir=0),
    "adiabatic_dir": lambda M: _loop(M).adiabatic_evolve([0], dir=-1),
    "adiabatic_occ_2d": lambda M: _loop(M).adiabatic_evolve([[0]], dir=0),
    "family_count": lambda M: M.wf_array(M.models.three_site_chain(0.0), [3, 4]).solve_on_grid_models(
        [M.models.three_site_chain(0.0)] * 2),
    "family_param_dir": lambda M: M.wf_array(M.models.three_site_chain(0.0), [3, 4]).solve_on_grid_models(
        [M.models.three_site_chain(0.0)] * 3, param_dir=2),
    "family_dim": lambda M: M.wf_array(M.models.haldane(), [3, 4]).solve_on_grid_models([M.models.haldane()] * 3),
    "wannier_finite": lambda M: M.wannier.interpolator(M.models.molecule_nh3(), [0], nk=4),
    "wannier_occ_range": lambda M: M.wannier.interpolator(M.models.bn(), [7], nk=4),
    "wannier_nk_dim": lambda M: M.wannier.interpolator(M.models.bn(), [0], nk=(4, 4, 4)),
    "wannier_no_bands": lambda M: M.wannier.interpolator(M.models.bn(), [], nk=4),
    "wannier_bands_dim": lambda M: M.wannier.interpolator(M.models.bn(), [0], nk=4).bands([[0.1, 0.2, 0.3]]),
    "disentangle_nw": lambda M: M.wannier.disentangled_interpolator(M.models.bn(), 5, 4, (-9, 9)),
    "disentangle_frozen_outside": lambda M: M.wannier.disentangled_interpolator(M.models.bn(), 1, 4, (-1, 1),
                                                                                frozen=(-2, 0)),
    "disentangle_window_empty": lambda M: M.wannier.disentangled_interpolator(M.models.bn(), 1, 4, (10, 11)),
    "unfold_singular": lambda M: M.unfold.unfold_bands(M.models.graphene(), np.zeros((2, 2)), [[0.0, 0.0]]),
    "unfold_k_dim": lambda M: M.unfold.unfold_bands(M.models.graphene().make_supercell(np.diag([2, 2])),
                                                    np.diag([2, 2]), [[0.0, 0.0, 0.0]]),
    "corr_periodic": lambda M: M.entanglement.correlation_spectrum(M.models.haldane(), 1, [0]),
    "corr_sites": lambda M: M.entanglement.correlation_spectrum(M.models.molecule_nh3(), 1, [0, 0]),
    "ent_flow_1d": lambda M: M.entanglement.entanglement_flow(M.models.chain(), [0], 0),
    "ent_flow_la": lambda M: M.entanglement.entanglement_flow(M.models.haldane(), [0], 0, L=4, LA=0),
    "sym_finite": lambda M: M.symmetry.find_symmetries(M.models.molecule_nh3()),
    "sym_indicator_spinful": lambda M: M.symmetry.chern_indicator(M.models.kane_mele(), occ=[0, 1]),
    "wf_load_missing": lambda M: M.wf_array.load("no-such-checkpoint.npz"),
}


@pytest.mark.parametrize("name", sorted(SLICE8_CASES))
def test_port_refuses_slice_eight_misuse_like_jax(name):
    fn = SLICE8_CASES[name]
    assert _outcome(pythtb_tpu_torch, fn) == _outcome(pythtb_tpu, fn) == "raise"


def _ring(M, L=4):
    return M.models.chain().cut_piece(L, 0, glue_edgs=True)


# misuse of the ninth slice's calls (ed, dmft, meanfield, bdg,
# continuation): each must raise in both packages
SLICE9_CASES = {
    "ed_basis_nelec": lambda M: M.ed.sector_basis(3, 4),
    "ed_basis_modes": lambda M: M.ed.sector_basis(64, 1),
    "ed_build_not_hermitian": lambda M: M.ed.build_sector(np.triu(np.ones((3, 3))), M.ed.sector_basis(3, 1)),
    "ed_build_vmat_diag": lambda M: M.ed.build_sector(np.eye(3), M.ed.sector_basis(3, 1), np.eye(3)),
    "ed_dense_h_periodic": lambda M: M.ed.dense_h(M.models.chain()),
    "ed_hubbard_spinful": lambda M: M.ed.hubbard(M.models.kane_mele().cut_piece(1, 0).cut_piece(1, 1), 1.0, 1, 1),
    "ed_hubbard_u_shape": lambda M: M.ed.hubbard(_ring(M), [1.0, 2.0], 1, 1),
    "ed_lowest_zero": lambda M: M.ed.hubbard(_ring(M), 1.0, 2, 2, lowest=0),
    "ed_lowest_too_large": lambda M: M.ed.hubbard(_ring(M), 1.0, 2, 2, lowest=30),
    "ed_solve_onsite_interaction": lambda M: M.ed.solve(_ring(M), 2, interactions=[(1.0, 2, 2)]),
    "ed_ground_state_interactions": lambda M: M.ed.ground_state(_ring(M), 2, interactions=[(1.0, 0, 1)]),
    "ed_chern_1d": lambda M: M.ed.many_body_chern(M.models.ssh(), (2,), 2),
    "ed_chern_supercell": lambda M: M.ed.many_body_chern(M.models.haldane(), (2, 0), 2),
    "ed_twist_finite": lambda M: M.ed.twist_berry_phase(_ring(M), (2,), 2),
    "ed_resta_u_spinless": lambda M: M.ed.resta_polarization(M.models.ssh(), (2,), 2, u=1.0, spinful=False,
                                                             interactions=[(1.0, 0, 0, (0,))]),
    "dmft_beta": lambda M: M.dmft.matsubara(0.0, 4),
    "dmft_spinful": lambda M: M.dmft.solve(M.models.kane_mele(), 1.0, nk=[4, 4]),
    "dmft_finite": lambda M: M.dmft.solve(_ring(M), 1.0),
    "dmft_orb": lambda M: M.dmft.solve(M.models.square(), 1.0, orb=3, nk=[4, 4]),
    "dmft_nk": lambda M: M.dmft.solve(M.models.square(), 1.0, nk=[4, 4, 4]),
    "dmft_band_spectral_bethe": lambda M: M.dmft.band_spectral(
        M.dmft.bethe(1.0, n_matsubara=8, n_bath=1, max_iter=1), [[0.0]], [0.0]),
    "mf_hf_n_elec": lambda M: M.meanfield.hartree_fock(M.models.square(), 1.0, 3.0, nk=(4, 4)),
    "mf_hf_nk_missing": lambda M: M.meanfield.hartree_fock(M.models.square(), 1.0, 1.0),
    "mf_hf_init_shape": lambda M: M.meanfield.hartree_fock(M.models.square(), 1.0, 1.0, nk=(4, 4), init=[0.5]),
    "mf_bcs_repulsive": lambda M: M.meanfield.bcs_gap(M.models.square(), 0.0, 0.0, nk=(4, 4)),
    "mf_bcs_spinful": lambda M: M.meanfield.bcs_gap(M.models.kane_mele(), 1.0, 0.0, nk=(4, 4)),
    "bdg_spinful": lambda M: M.bdg.bdg_model(M.models.kane_mele()),
    "bdg_pairing": lambda M: M.bdg.bdg_model(M.models.square(), pairing="p"),
    "bdg_onsite_triplet": lambda M: M.bdg.bdg_model(M.models.square(), delta=[(0.3, 0, 0, [0, 0])]),
    "bdg_majorana_2d": lambda M: M.bdg.majorana_number(M.bdg.bdg_model(M.models.square())),
    "bdg_pfaffian_odd": lambda M: M.bdg.pfaffian(np.zeros((3, 3))),
    "pade_one_point": lambda M: M.continuation.pade([1.0], [1.0], [0.0]),
    "pade_negative_wn": lambda M: M.continuation.pade([-1.0, 1.0], [1.0, 1.0], [0.0]),
    "pade_n_points": lambda M: M.continuation.pade([1.0, 2.0], [1.0, 1.0], [0.0], n_points=5),
    "ed_chern_multiplet_zero": lambda M: M.ed.many_body_chern(M.models.haldane(), (1, 1), 1, multiplet=0),
    "ed_chern_multiplet_exceeds_sector": lambda M: M.ed.many_body_chern(M.models.haldane(), (1, 1), 1, u=1.0,
                                                                       multiplet=4),
    "ed_twist_sector_dim": lambda M: M.ed.twist_berry_phase(M.models.ssh(), (1,), 2),
    "ed_resta_self_interaction": lambda M: M.ed.resta_polarization(M.models.ssh(), (2,), 2,
                                                                   interactions=[(1.0, 0, 0, (0,))]),
    "dmft_filling_bracket": lambda M: M.dmft.solve(M.models.square(), 1.0, nk=[4, 4], n_matsubara=8, n_bath=1,
                                                   filling=3.0),
    "dmft_sigma0_shape": lambda M: M.dmft.solve(M.models.square(), 1.0, nk=[4, 4], n_matsubara=8,
                                                sigma0=np.zeros(3)),
    "mf_hf_nk_small": lambda M: M.meanfield.hartree_fock(M.models.square(), 1.0, 1.0, nk=(1, 4)),
    "mf_hf_temperature": lambda M: M.meanfield.hartree_fock(M.models.square(), 1.0, 1.0, nk=(4, 4),
                                                            temperature=-1.0),
    "mf_hf_matrix_init_shape": lambda M: M.meanfield.hartree_fock(M.models.kane_mele(), 1.0, 2.0, nk=(4, 4),
                                                                  init=np.ones((3, 2, 2))),
    "mf_hf_matrix_init_hermitian": lambda M: M.meanfield.hartree_fock(M.models.kane_mele(), 1.0, 2.0, nk=(4, 4),
                                                                      init=np.triu(np.ones((2, 2, 2)))),
    "bdg_mu_shape": lambda M: M.bdg.bdg_model(M.models.square(), mu=[0.0, 1.0]),
    "bdg_pfaffian_symmetric": lambda M: M.bdg.pfaffian(np.eye(4)),
}


def _refusal(module, fn):
    with pytest.raises(Exception) as info:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn(module)
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize("name", sorted(SLICE9_CASES))
def test_port_refuses_slice_nine_misuse_like_jax(name):
    """The same exception class and message in both packages."""
    fn = SLICE9_CASES[name]
    want = _refusal(pythtb_tpu, fn)
    assert want[0] == "PythtbError"
    assert _refusal(pythtb_tpu_torch, fn) == want


def _square_1d(M):
    return M.models.chain()


# misuse of the tenth slice's calls (fermisurface, response, the k.p
# models and magnetotransport): each must raise in both packages
SLICE10_CASES = {
    "fs_surface_1d": lambda M: M.fermisurface.fermi_surface(_square_1d(M), 0.0),
    "fs_surface_band_range": lambda M: M.fermisurface.fermi_surface(M.models.square(), 0.0, nk=11, bands=[3]),
    "fs_dos_finite": lambda M: M.fermisurface.dos_linear(M.models.square().cut_piece(3, 0), [0.0]),
    "fs_velocity_columns": lambda M: M.fermisurface.fermi_velocity(M.models.square(), [[0.1, 0.2, 0.3]]),
    "fs_cyclotron_no_orbit": lambda M: M.fermisurface.cyclotron_mass(M.models.square(), -9.0, 0, nk=33),
    "fs_extremal_2d": lambda M: M.fermisurface.extremal_orbits(M.models.square(), 0.0, 0),
    "fs_extremal_oblique": lambda M: M.fermisurface.extremal_orbits(_oblique3(M), 0.0, 0, n_slices=4, nk=9),
    "fs_extremal_band_range": lambda M: M.fermisurface.extremal_orbits(_cube(M), 0.0, 2, n_slices=4, nk=9),
    "resp_no_mode": lambda M: M.response.lindhard(M.models.square(), [[0.1, 0.0]], [0.0], nk=4),
    "resp_both_modes": lambda M: M.response.lindhard(M.models.square(), [[0.1, 0.0]], [0.0], nk=4, nocc=1, mu=0.0,
                                                     temperature=0.1),
    "resp_mu_no_temperature": lambda M: M.response.lindhard(M.models.square(), [[0.1, 0.0]], [0.0], nk=4, mu=0.0),
    "resp_q_columns": lambda M: M.response.lindhard(M.models.square(), [[0.1]], [0.0], nk=4, nocc=1),
    "resp_nk_entries": lambda M: M.response.lindhard(M.models.square(), [[0.1, 0.0]], [0.0], nk=[4], nocc=1),
    "resp_finite": lambda M: M.response.lindhard(M.models.chain().cut_piece(3, 0), [[0.1]], [0.0], nk=4, nocc=1),
    "resp_ops_shape": lambda M: M.response.lindhard(M.models.graphene(), [[0.1, 0.0]], [0.0], nk=4, nocc=1,
                                                    ops=np.ones((2, 3))),
    "resp_nocc_range": lambda M: M.response.lindhard(M.models.graphene(), [[0.1, 0.0]], [0.0], nk=4, nocc=3),
    "resp_rpa_spinful": lambda M: M.response.rpa_susceptibility(M.models.kane_mele(), [[0.0, 0.0]], [0.0], 4, 1.0,
                                                                nocc=2),
    "resp_rpa_channel": lambda M: M.response.rpa_susceptibility(M.models.graphene(), [[0.0, 0.0]], [0.0], 4, 1.0,
                                                                channel="orbital", nocc=1),
    "kp_mass_band_range": lambda M: M.geometry.effective_mass(M.models.haldane(), [0.1, 0.1], 5),
    "kp_mass_degenerate": lambda M: M.geometry.effective_mass(M.models.graphene(), [1 / 3, 2 / 3], 0),
    "kp_mass_k0_length": lambda M: M.geometry.effective_mass(M.models.haldane(), [0.1], 0),
    "kp_mass_finite": lambda M: M.geometry.effective_mass(M.models.haldane().cut_piece(3, 0), [0.1], 0),
    "kp_model_repeated": lambda M: M.geometry.kp_model(M.models.haldane(), [0.1, 0.1], [0, 0]),
    "kp_model_degenerate_complement": lambda M: M.geometry.kp_model(M.models.graphene(), [1 / 3, 2 / 3], [0]),
    "mt_zero_field": lambda M: M.boltzmann.magnetotransport(M.models.square(), -3.6, [0.0], nk=21),
    "mt_tau": lambda M: M.boltzmann.magnetotransport(M.models.square(), -3.6, [0.5], tau=-1.0, nk=21),
    "mt_1d": lambda M: M.boltzmann.magnetotransport(M.models.chain(), 0.0, [0.5]),
}


def _cube(M):
    m = M.tb_model(3, 3, np.eye(3).tolist(), [[0.0, 0.0, 0.0]])
    for R in ([1, 0, 0], [0, 1, 0], [0, 0, 1]):
        m.set_hop(-1.0, 0, 0, R)
    return m


def _oblique3(M):
    m = M.tb_model(3, 3, [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.3, 0.0, 1.0]], [[0.0, 0.0, 0.0]])
    for R in ([1, 0, 0], [0, 1, 0], [0, 0, 1]):
        m.set_hop(-1.0, 0, 0, R)
    return m


@pytest.mark.parametrize("name", sorted(SLICE10_CASES))
def test_port_refuses_slice_ten_misuse_like_jax(name):
    """The same exception class and message in both packages."""
    fn = SLICE10_CASES[name]
    want = _refusal(pythtb_tpu, fn)
    assert want[0] == "PythtbError"
    assert _refusal(pythtb_tpu_torch, fn) == want


_CIRC = {"A": [0.5, 0.5], "phase": [0.0, np.pi / 2]}
_K = np.zeros((1, 2))

# misuse of the eleventh slice's calls (harmonic_spectrum, superfluid_weight
# and the floquet module): each must raise in both packages
SLICE11_CASES = {
    "hhg_finite": lambda M: M.optical.harmonic_spectrum(M.models.bn().cut_piece(3, 0, glue_edgs=False), 0.5, 1e-3,
                                                        occ=[0]),
    "hhg_nk_entries": lambda M: M.optical.harmonic_spectrum(M.models.bn(), 0.5, 1e-3, occ=[0], nk=(4,)),
    "hhg_occ_repeated": lambda M: M.optical.harmonic_spectrum(M.models.bn(), 0.5, 1e-3, occ=[0, 0]),
    "hhg_occ_range": lambda M: M.optical.harmonic_spectrum(M.models.bn(), 0.5, 1e-3, occ=[2]),
    "hhg_occ_empty": lambda M: M.optical.harmonic_spectrum(M.models.bn(), 0.5, 1e-3, occ=[]),
    "hhg_pol_length": lambda M: M.optical.harmonic_spectrum(M.models.bn(), 0.5, 1e-3, occ=[0], pol=[1.0, 0.0, 0.0]),
    "hhg_cycles": lambda M: M.optical.harmonic_spectrum(M.models.bn(), 0.5, 1e-3, occ=[0], cycles=9, ramp_cycles=8),
    "sfw_spinful": lambda M: M.geometry.superfluid_weight(M.models.kane_mele(), 0.0, 0.3, nk=(4, 4)),
    "sfw_delta": lambda M: M.geometry.superfluid_weight(M.models.lieb(), 0.0, 0.0, nk=(4, 4)),
    "sfw_nk": lambda M: M.geometry.superfluid_weight(M.models.lieb(), 0.0, 0.3, nk=(4, 1)),
    "sfw_nk_entries": lambda M: M.geometry.superfluid_weight(M.models.lieb(), 0.0, 0.3, nk=(4,)),
    "sfw_temperature": lambda M: M.geometry.superfluid_weight(M.models.lieb(), 0.0, 0.3, nk=(4, 4), temperature=0.0),
    "sfw_method": lambda M: M.geometry.superfluid_weight(M.models.lieb(), 0.0, 0.3, nk=(4, 4), method="twist"),
    "sfw_finite": lambda M: M.geometry.superfluid_weight(M.models.lieb().cut_piece(2, 0), 0.0, 0.3),
    "flq_omega": lambda M: M.floquet.quasienergies(M.models.graphene(), -1.0, _CIRC, _K),
    "flq_k_missing": lambda M: M.floquet.quasienergies(M.models.graphene(), 2.0, _CIRC),
    "flq_k_columns": lambda M: M.floquet.quasienergies(M.models.graphene(), 2.0, _CIRC, np.zeros((2, 3))),
    "flq_nharm": lambda M: M.floquet.quasienergies(M.models.graphene(), 2.0, _CIRC, _K, nharm=0),
    "flq_nt_aliased": lambda M: M.floquet.quasienergies(M.models.graphene(), 2.0, _CIRC, _K, nharm=2, nt=8),
    "flq_drive_keys": lambda M: M.floquet.quasienergies(M.models.graphene(), 2.0, {"B": [1.0, 0.0]}, _K),
    "flq_drive_length": lambda M: M.floquet.propagator(M.models.graphene(), 2.0, {"A": [1.0]}, _K, nt=8),
    "flq_drive_callable": lambda M: M.floquet.propagator(M.models.graphene(), 2.0, lambda t: np.zeros(3), _K, nt=8),
    "flq_hop_factors": lambda M: M.floquet.propagator(M.models.graphene(), 2.0, {"hop_factors": lambda t: np.ones(2)},
                                                      _K, nt=8),
    "flq_onsite": lambda M: M.floquet.propagator(M.models.graphene(), 2.0, {"onsite": lambda t: np.ones(3)}, _K,
                                                 nt=8),
    "flq_prop_nt": lambda M: M.floquet.propagator(M.models.graphene(), 2.0, _CIRC, _K, nt=3),
    "flq_chern_1d": lambda M: M.floquet.chern(M.models.chain(), 2.0, {"A": [1.0]}, band=0),
    "flq_chern_band": lambda M: M.floquet.chern(M.models.graphene(), 2.0, _CIRC, band=2, nk=(5, 5), nt=8),
    "flq_winding_1d": lambda M: M.floquet.winding_number(M.models.chain(), 2.0, {"A": [1.0]}, 0.0),
    "flq_winding_nk": lambda M: M.floquet.winding_number(M.models.graphene(), 2.0, _CIRC, 0.0, nk=(2, 5), nt=8),
    "flq_effective_omega": lambda M: M.floquet.effective_model(M.models.graphene(), 0.0, _CIRC),
    "flq_effective_nt": lambda M: M.floquet.effective_model(M.models.graphene(), 2.0, _CIRC, nharm=3, nt=10),
}


@pytest.mark.parametrize("name", sorted(SLICE11_CASES))
def test_port_refuses_slice_eleven_misuse_like_jax(name):
    """The same exception class and message in both packages."""
    fn = SLICE11_CASES[name]
    want = _refusal(pythtb_tpu, fn)
    assert want[0] == "PythtbError"
    assert _refusal(pythtb_tpu_torch, fn) == want


def _chain_fc(M, k=0.9, masses=1.3):
    fc = M.phonon.force_model([[1.0]], [[0.0]], masses=masses)
    fc.set_spring(k, 0, 0, [1])
    return fc


def _chain_tb(M, orb=0.0):
    m = M.tb_model(1, 1, [[1.0]], [[orb]])
    m.set_hop(-1.0, 0, 0, [1])
    return m


def _unstable_fc(M):
    fc = M.phonon.force_model([[1.0]], [[0.0], [0.5]], masses=[1.0, 2.0])
    fc.set_spring(1.0, 0, 1, [0])
    fc.set_spring(-1.5, 1, 0, [1])
    return fc


def _non_pd_magnet(M):
    """An AFM coupling about FM moments: not a classical minimum."""
    sm = M.magnon.spin_model([[2.0]], [[0.0], [0.5]], spin=0.5)
    sm.set_coupling(1.0, 0, 1, [0])
    sm.set_coupling(1.0, 1, 0, [1])
    return sm


def _slab_tb(M):
    m = M.tb_model(1, 2, np.eye(2), [[0.0, 0.0]])
    m.set_hop(-1.0, 0, 0, [1, 0])
    return m


def _slab_fc(M):
    fc = M.phonon.force_model(np.eye(2), [[0.0, 0.0]], dim_k=1)
    fc.set_spring(1.0, 0, 0, [1, 0])
    return fc


def _onsite_only(M):
    m = M.tb_model(1, 1, [[1.0]], [[0.0], [0.0]])
    m.set_hop(-1.0, 0, 1, [0])
    return m


def _pair_fc(M):
    fc = M.phonon.force_model([[1.0]], [[0.0], [0.0]])
    fc.set_spring(1.0, 0, 1, [1])
    return fc


# misuse of the twelfth slice's calls (phonon, eph, magnon): each must
# raise in both packages, with the same class and message
SLICE12_CASES = {
    "ph_unstable_bands": lambda M: M.phonon.bands(_unstable_fc(M), [[0.25]]),
    "ph_unstable_heat_capacity": lambda M: M.phonon.heat_capacity(_unstable_fc(M), [0.5], 8),
    "ph_bad_masses": lambda M: M.phonon.force_model([[1.0]], [[0.0]], masses=-1.0),
    "ph_onsite_block": lambda M: _chain_fc(M).set_fc(1.0, 0, 0),
    "ph_fc_shape": lambda M: _chain_fc(M).set_fc(np.eye(2), 0, 0, [1]),
    "ph_k_columns": lambda M: M.phonon.bands(_chain_fc(M), [[0.1, 0.2]]),
    "ph_kappa_slab": lambda M: M.phonon.thermal_conductivity(_slab_fc(M), [0.5], 8),
    "ph_kappa_temperature": lambda M: M.phonon.thermal_conductivity(_chain_fc(M), [0.0], 8),
    "ph_cluster_masses": lambda M: M.phonon.dynamical_cluster(_chain_fc(M), 3, masses=[1.0, 1.0]),
    "mag_colpa_not_pd": lambda M: M.magnon.bands(_non_pd_magnet(M), [[0.25]], shift=0.0),
    "mag_colpa_not_pd_vectors": lambda M: M.magnon.structure_factor(_non_pd_magnet(M), [[0.25]], shift=0.0),
    "mag_same_site": lambda M: M.magnon.spin_model([[1.0]], [[0.0]]).set_coupling(1.0, 0, 0),
    "mag_zero_moment": lambda M: M.magnon.spin_model([[1.0]], [[0.0]]).set_moments([[0.0, 0.0, 0.0]]),
    "mag_chern_1d": lambda M: M.magnon.chern(_non_pd_magnet(M), 0),
    "mag_sf_columns": lambda M: M.magnon.structure_factor(_non_pd_magnet(M), [[0.1, 0.2]]),
    "eph_spinful": lambda M: M.eph.coupling(M.models.kane_mele(), _chain_fc(M), 1.0, [0.1, 0.1], [0.2, 0.0]),
    "eph_not_periodic": lambda M: M.eph.coupling(_slab_tb(M), _slab_fc(M), 1.0, [0.1], [0.2]),
    "eph_bad_atom_of": lambda M: M.eph.coupling(_chain_tb(M), _chain_fc(M), 1.0, [0.1], [0.2], atom_of=[3]),
    "eph_orbital_off_atom": lambda M: M.eph.coupling(_chain_tb(M, 0.5), _chain_fc(M), 1.0, [0.1], [0.2]),
    "eph_orbital_lattice_vector": lambda M: M.eph.coupling(_chain_tb(M, 1.0), _chain_fc(M), 1.0, [0.1], [0.2]),
    "eph_no_finite_bond": lambda M: M.eph.coupling(_onsite_only(M), _pair_fc(M), 1.0, [0.1], [0.2]),
    "eph_atom_count": lambda M: M.eph.coupling(_onsite_only(M), _chain_fc(M), 1.0, [0.1], [0.2]),
    "eph_linewidth_temperature": lambda M: M.eph.linewidths(_chain_tb(M), _chain_fc(M), 1.0, [[0.1]], 0.0, 0.0,
                                                            nkq=(4,)),
    "eph_nkq_entries": lambda M: M.eph.linewidths(_chain_tb(M), _chain_fc(M), 1.0, [[0.1]], 0.0, 0.1, nkq=(4, 4)),
    "eph_eliashberg_no_states": lambda M: M.eph.eliashberg(_chain_tb(M), _chain_fc(M), 1.0, 9.0, nk=(4,), nkq=(4,)),
}


@pytest.mark.parametrize("name", sorted(SLICE12_CASES))
def test_port_refuses_slice_twelve_misuse_like_jax(name):
    """The same exception class and message in both packages."""
    fn = SLICE12_CASES[name]
    want = _refusal(pythtb_tpu, fn)
    assert want[0] == "PythtbError"
    assert _refusal(pythtb_tpu_torch, fn) == want


def _bn_ex(M):
    m = M.tb_model(2, 2, [[1.0, 0.0], [0.5, np.sqrt(3.0) / 2.0]], [[1 / 3, 1 / 3], [2 / 3, 2 / 3]])
    m.set_onsite([-0.7, 0.7])
    m.set_hop(-1.0, 0, 1, [0, 0])
    m.set_hop(-1.0, 1, 0, [1, 0])
    return m


def _chain_ex(M):
    m = M.tb_model(1, 1, [[1.0]], [[0.0], [0.4]])
    m.set_onsite([0.0, 4.0])
    m.set_hop(0.5, 1, 1, [1])
    return m


_EX_V = [(1.0, 0, 1, (0, 0))]

# misuse of the thirteenth slice's calls (exciton, chern_fn): each must
# raise in both packages, with the same class and message
SLICE13_CASES = {
    "ex_spinful": lambda M: M.exciton.bse(M.models.kane_mele(), None, [0, 1], (4, 4)),
    "ex_finite": lambda M: M.exciton.bse(_chain_ex(M).cut_piece(3, 0), None, [0], ()),
    "ex_spin_channel": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4, 4), spin="quartet"),
    "ex_qp": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4, 4), qp="gw"),
    "ex_nk_entries": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4,)),
    "ex_nk_zero": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4, 0)),
    "ex_occ_repeated": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0, 0], (4, 4)),
    "ex_occ_range": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [2], (4, 4)),
    "ex_no_conduction": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0, 1], (4, 4)),
    "ex_vbands_empty": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4, 4), vbands=[1]),
    "ex_cbands_occupied": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4, 4), cbands=[0, 1]),
    "ex_term_length": lambda M: M.exciton.bse(_bn_ex(M), [(1.0, 0, 1)], [0], (4, 4)),
    "ex_term_cell": lambda M: M.exciton.bse(_bn_ex(M), [(1.0, 0, 1, (0,))], [0], (4, 4)),
    "ex_term_orbital": lambda M: M.exciton.bse(_bn_ex(M), [(1.0, 0, 5, (0, 0))], [0], (4, 4)),
    "ex_term_onsite": lambda M: M.exciton.bse(_bn_ex(M), [(1.0, 1, 1, (0, 0))], [0], (4, 4)),
    "ex_q_entries": lambda M: M.exciton.bse(_bn_ex(M), _EX_V, [0], (4, 4), Q=[0.1]),
    "ex_rcut": lambda M: M.exciton.radial_interaction(_bn_ex(M), lambda r: 1.0 / r, 0.0),
    "ex_dispersion_qlist": lambda M: M.exciton.dispersion(_chain_ex(M), None, [0], (4,), [0.1, 0.2]),
    "ex_absorption_1d": lambda M: M.exciton.absorption(_chain_ex(M), None, [0.5], [0], (4,)),
    "ex_absorption_q": lambda M: M.exciton.absorption(_bn_ex(M), _EX_V, [0.5], [0], (4, 4), Q=[0.1, 0.0]),
}


@pytest.mark.parametrize("name", sorted(SLICE13_CASES))
def test_port_refuses_slice_thirteen_misuse_like_jax(name):
    """The same exception class and message in both packages."""
    fn = SLICE13_CASES[name]
    want = _refusal(pythtb_tpu, fn)
    assert want[0] == "PythtbError"
    assert _refusal(pythtb_tpu_torch, fn) == want


def _flows(M):
    import importlib

    return importlib.import_module(M.__name__ + ".flows")


FLOW_FN_CASES = {
    "chern_fn_1d": lambda M: _flows(M).chern_fn(M.models.ssh(), [0]),
    "chern_fn_occ_range": lambda M: _flows(M).chern_fn(M.models.haldane(), [2]),
}


@pytest.mark.parametrize("name", sorted(FLOW_FN_CASES))
def test_port_refuses_chern_fn_misuse_like_jax(name):
    fn = FLOW_FN_CASES[name]
    want = _refusal(pythtb_tpu, fn)
    assert want[0] in ("ValueError", "IndexError")
    assert _refusal(pythtb_tpu_torch, fn) == want
