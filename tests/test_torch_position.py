"""Position operators and hybrid Wannier functions in the port against
pythtb_tpu's, on the CPU in float64.

Both packages get the same eigenvectors (solved once by pythtb_tpu, and
carried into a port wf_array with convert.wf_array_from_numpy), since
separate solves differ in gauge.  Position matrices and expectations
agree to 1e-12, hybrid Wannier centres to 1e-12, and hybrid Wannier
functions -- whose phases eigh leaves free -- as projectors onto each
set of equal centres, to 1e-10.
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu_torch import convert
from pythtb_tpu_torch.ops import position

from . import zoo
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

ATOL = 1e-12
PROJ_TOL = 1e-10


def _ribbon(nspin):
    jm = zoo.haldane(pythtb_tpu) if nspin == 1 else zoo.kane_mele(pythtb_tpu, "odd")
    with redirect_stdout(io.StringIO()):
        return jm.cut_piece(4, 1)


def _projectors(centres, v):
    """Per state h, the projector onto the span of the states whose
    centres equal h's (to 1e-6): sum_g |v_g><v_g|.  Unique where single
    states are not (Kramers pairs at nspin 2)."""
    same = np.abs(centres[..., :, None] - centres[..., None, :]) < 1e-6
    P = np.einsum("...hf,...hg->...hfg", v, v.conj())
    return np.einsum("...hg,...gfe->...hfe", same.astype(float), P)


def _flat(v, nspin):
    return v.reshape(v.shape[:-2] + (-1,)) if nspin == 2 else v


@pytest.mark.parametrize("nspin", [1, 2])
def test_model_position_methods(nspin):
    jm = _ribbon(nspin)
    pm = carry(jm)
    k = np.linspace(0.0, 1.0, 5)[:, None]
    _, evecs = jm.solve_all(k, eig_vectors=True)  # (nsta, nk, norb[, 2])
    nocc = jm._nsta // 2
    ev = evecs[:nocc, 2]
    np.testing.assert_allclose(pm.position_matrix(ev, 1), jm.position_matrix(ev, 1), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.position_expectation(evecs[:, 2], 1),
                               jm.position_expectation(evecs[:, 2], 1), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pm.position_hwf(ev, 1), jm.position_hwf(ev, 1), rtol=0, atol=ATOL)
    for basis in ("orbital", "wavefunction", "bloch"):
        pc, pf = pm.position_hwf(ev, 1, hwf_evec=True, basis=basis)
        jc, jf = jm.position_hwf(ev, 1, hwf_evec=True, basis=basis)
        np.testing.assert_allclose(pc, jc, rtol=0, atol=ATOL)
        assert pf.shape == jf.shape
        f = (lambda v: _flat(v, nspin)) if basis == "orbital" else (lambda v: v)
        np.testing.assert_allclose(_projectors(jc, f(pf)), _projectors(jc, f(jf)), rtol=0, atol=PROJ_TOL)
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        pm.position_hwf(ev, 1, hwf_evec=True, basis="plane")
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        pm.position_matrix(ev, 0)  # periodic direction
    # batched leading axes: one call over all k-points
    evk = np.moveaxis(evecs[:nocc], 0, 1)  # (nk, nocc, norb[, 2])
    np.testing.assert_allclose(pm.position_hwf(evk, 1), jm.position_hwf(evk, 1), rtol=0, atol=ATOL)


def _slab(mod, nl=4):
    """The cubic slab of the slab_hwf workload, cut to ``nl`` layers."""
    model = mod.tb_model(3, 3, np.eye(3), [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    model.set_onsite([-1.0, 1.0])
    for lvec in ([-1, 0, 0], [0, 0, -1], [-1, -1, 0], [0, -1, -1]):
        model.set_hop(0.4, 0, 1, lvec)
    for lvec in ([0, 0, 0], [0, -1, 0], [-1, -1, -1], [-1, 0, -1]):
        model.set_hop(0.7, 0, 1, lvec)
    return model.cut_piece(nl, 2).remove_orb(2 * nl - 1)


@pytest.mark.parametrize("nspin", [1, 2])
def test_wf_array_position_on_the_grid(nspin):
    """position_*_all over the whole grid and the per-point wrappers, on
    the same states in both packages."""
    if nspin == 1:
        jm, d, nocc = _slab(pythtb_tpu), 2, 4
    else:
        jm, d, nocc = _ribbon(2), 1, 4
    pm = carry(jm)
    mesh = [5, 4] if jm._dim_k == 2 else [6]
    jw = pythtb_tpu.wf_array(jm, mesh)
    jw.solve_on_grid([0.0] * jm._dim_k)
    pw = convert.wf_array_from_numpy(pm, jw._host_ro(), jw.energies)
    occ = list(range(nocc))
    np.testing.assert_allclose(pw.position_expectation_all(occ, d),
                               jw.position_expectation_all(occ, d), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pw.position_hwf_all(occ, d), jw.position_hwf_all(occ, d), rtol=0, atol=ATOL)
    for basis in ("wavefunction", "orbital"):
        pc, pf = pw.position_hwf_all(occ, d, hwf_evec=True, basis=basis)
        jc, jf = jw.position_hwf_all(occ, d, hwf_evec=True, basis=basis)
        np.testing.assert_allclose(pc, jc, rtol=0, atol=ATOL)
        assert pf.shape == jf.shape
        f = (lambda v: _flat(v, nspin)) if basis == "orbital" else (lambda v: v)
        np.testing.assert_allclose(_projectors(jc, f(pf)), _projectors(jc, f(jf)), rtol=0, atol=PROJ_TOL)
    key = (1, 2) if len(mesh) == 2 else 3
    np.testing.assert_allclose(pw.position_matrix(key, occ, d), jw.position_matrix(key, occ, d), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pw.position_expectation(key, occ, d),
                               jw.position_expectation(key, occ, d), rtol=0, atol=ATOL)
    np.testing.assert_allclose(pw.position_hwf(key, occ, d), jw.position_hwf(key, occ, d), rtol=0, atol=ATOL)


def test_choose_states_and_empty_like():
    jm = zoo.kane_mele(pythtb_tpu, "even")
    pm = carry(jm)
    jw, pw = pythtb_tpu.wf_array(jm, [5, 5]), pythtb_tpu_torch.wf_array(pm, [5, 5])
    jw.solve_on_grid([0.0, 0.0])
    pw.solve_on_grid([0.0, 0.0])
    jc, pc = jw.choose_states([0, 1]), pw.choose_states([0, 1])
    assert pc._nsta_arr == 2 and pc._host_ro().shape == jc._host_ro().shape
    np.testing.assert_allclose(pc.energies, jc.energies, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pc.berry_phase([0, 1], 0), jc.berry_phase([0, 1], 0), rtol=0, atol=1e-10)
    pe = pw.empty_like(nsta_arr=3)
    assert pe._host_ro().shape == (5, 5, 3, 2, 2) and np.isnan(pe.energies).all()
    assert pw.empty_like()._host_ro().shape == pw._host_ro().shape
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        pw.choose_states([[0, 1]])


def test_xmat_modes_match_the_plain_einsum():
    """Selection through the index array and the diagonal mode, on CPU
    tensors (the kernel's plain versions), against a direct einsum."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=(7, 6, 5)) + 1j * rng.normal(size=(7, 6, 5))
    pos = rng.normal(size=5)
    occ = np.array([4, 0, 2])
    want = np.einsum("bnf,f,bmf->bnm", w[:, occ].conj(), pos, w[:, occ])
    wt, pt_, ot = torch.as_tensor(w), torch.as_tensor(pos), torch.as_tensor(occ)
    np.testing.assert_allclose(position.xmat(wt, pt_, ot).numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(position.xmat(wt, pt_, ot, diagonal=True).numpy(),
                               np.einsum("bnn->bn", want).real, rtol=0, atol=ATOL)


def test_flake_position_matrix_matches_jax():
    """position_matrix / position_hwf of every state of a 200-orbital
    Haldane flake (S = F = 200, kernel 6's tiled shape on the card)."""
    with redirect_stdout(io.StringIO()):
        jm = zoo.haldane(pythtb_tpu).cut_piece(10, 0).cut_piece(10, 1)
    pm = carry(jm)
    _, evecs = jm.solve_all(eig_vectors=True)
    assert evecs.shape == (200, 200)
    for d in (0, 1):
        np.testing.assert_allclose(pm.position_matrix(evecs, d), jm.position_matrix(evecs, d), rtol=0, atol=1e-10)
        np.testing.assert_allclose(pm.position_hwf(evecs, d), jm.position_hwf(evecs, d), rtol=0, atol=1e-10)


def test_position_path_dispatch():
    """Kernel 6's design for X by S: a thread an element below 16 states,
    tiles from 16; a CPU tensor runs the plain einsum whatever path is
    asked, and an unknown path is refused."""
    assert [position._position_path(S) for S in (1, 8, 15, 16, 20, 800)] == [
        "threads", "threads", "threads", "tiles", "tiles", "tiles"]
    rng = np.random.default_rng(8)
    w = torch.as_tensor(rng.normal(size=(2, 5, 4)) + 1j * rng.normal(size=(2, 5, 4)))
    pos = torch.as_tensor(rng.normal(size=4))
    assert torch.equal(position.xmat(w, pos), position._xmat_plain(w, pos))
    for path in (None, "threads", "tiles"):
        assert torch.equal(position._xmat(w, pos, None, False, path), position._xmat_plain(w, pos))
    with pytest.raises(ValueError, match="no 'blocks' path"):
        position._xmat(w, pos, None, False, "blocks")
