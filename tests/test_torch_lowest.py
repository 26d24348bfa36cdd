"""The port's matrix-free lowest eigenpairs (``flows.solve_lowest``, a
complex block LOBPCG on kernel 8's plain version here) against the dense
spectrum and pythtb_tpu's LOBPCG on a real embedding, on the CPU in
float64.

The two packages draw their start blocks from different generators
(``jax.random`` and ``torch.Generator``), so only seed-free results are
compared: eigenvalues to 1e-8, and the projector onto the returned
subspace where the cut falls in a gap.
"""

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu import ed as jed
from pythtb_tpu import flows as jflows
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import flows
from pythtb_tpu_torch.ops import lobpcg

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

CASES = {
    "haldane flake (spinless)": lambda: jzoo.haldane().cut_piece(8, 0).cut_piece(8, 1),
    "kane_mele flake (spinful)": lambda: jzoo.kane_mele().cut_piece(4, 0).cut_piece(4, 1),
    "peierls flake (magnetic, complex hops)": lambda: pythtb_tpu.magnetic.peierls_model(
        jzoo.square().cut_piece(9, 0), 1.0 / 7.0, dirs=(0, 1)).cut_piece(8, 1),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solve_lowest_matches_dense_and_jax(name):
    jm = CASES[name]()
    pm = carry(jm)
    k = 4
    H = jed.dense_h(jm)
    ev = np.linalg.eigvalsh(H)
    w, vecs = flows.solve_lowest(pm, k, eig_vectors=True, max_iters=600, seed=3)
    np.testing.assert_allclose(w, ev[:k], rtol=0, atol=1e-8)
    np.testing.assert_allclose(w, jflows.solve_lowest(jm, k, max_iters=600), rtol=0, atol=1e-8)
    # layout: solve_all's (k, norb) or (k, norb, 2); the states span the
    # dense lowest subspace where the cut at k falls in a gap
    assert vecs.shape == ((k, pm._norb, 2) if pm._nspin == 2 else (k, pm._norb))
    v = vecs.reshape(k, -1)
    np.testing.assert_allclose(v.conj() @ v.T, np.eye(k), atol=1e-10)
    np.testing.assert_allclose(H @ v.T, v.T * w[None, :], atol=1e-6)
    if ev[k] - ev[k - 1] > 1e-3:
        V = np.linalg.eigh(H)[1][:, :k]
        np.testing.assert_allclose(v.T @ v.conj(), V @ V.conj().T, atol=1e-6)


def test_solve_lowest_seed_free():
    pm = carry(CASES["haldane flake (spinless)"]())
    a = flows.solve_lowest(pm, 3, max_iters=600, seed=0)
    b = flows.solve_lowest(pm, 3, max_iters=600, seed=7)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-10)


def test_lobpcg_pieces():
    """The complex Householder extension gives an orthonormal [X, P]; the
    projection leaves a block orthogonal to the basis."""
    rng = np.random.default_rng(0)
    import torch

    X = lobpcg._orthonormalize(torch.as_tensor(rng.normal(size=(40, 3)) + 1j * rng.normal(size=(40, 3))))
    P = lobpcg._extend_basis(X, 3)
    XP = torch.cat([X, P], dim=1)
    np.testing.assert_allclose((XP.conj().T @ XP).numpy(), np.eye(6), atol=1e-13)
    R = lobpcg._project_out(XP, torch.as_tensor(rng.normal(size=(40, 3)) + 0j))
    assert float((XP.conj().T @ R).abs().max()) < 1e-13
    with pytest.raises(ValueError):
        lobpcg.lobpcg_standard(lambda v: v, X[:10], m=3)  # 5 k >= n


def test_solve_lowest_validation():
    pm = carry(jzoo.haldane().cut_piece(3, 0).cut_piece(3, 1))  # 18 states
    with pytest.raises(ValueError):
        flows.solve_lowest(pm, 0)
    with pytest.raises(ValueError):
        flows.solve_lowest(pm, 2)  # 10 k >= 18
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        flows.solve_lowest(carry(jzoo.haldane()), 1)  # periodic model
