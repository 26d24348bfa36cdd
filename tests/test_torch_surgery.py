"""Model surgery in the port against pythtb_tpu's, on the CPU in float64.

Each model is built in pythtb_tpu (tests/zoo.py), carried across with
pythtb_tpu_torch.convert, and then cut, reduced, enlarged, re-framed or
thinned by the same call in both packages.  The results must have the
same orbitals, lattice, on-site terms and hopping table (sorted by
(i, j, R)) to 1e-12, and the same bands to 1e-12, for nspin 1 (Haldane)
and nspin 2 (Kane-Mele).
"""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu_torch

from . import zoo
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

ATOL = 1e-12

OPS = {
    "cut_open": lambda m: m.cut_piece(3, 0),
    "cut_glued": lambda m: m.cut_piece(3, 1, glue_edgs=True),
    "cut_trimmed": lambda m: m.cut_piece(3, 1, trim_first=[0], trim_last=1),
    "flake": lambda m: m.cut_piece(3, 0).cut_piece(2, 1),
    "reduce_dim": lambda m: m.reduce_dim(0, 0.25),
    "supercell": lambda m: m.make_supercell([[2, 1], [-1, 2]]),
    "supercell_snapshot": lambda m: m.make_supercell(
        [[2, 0], [0, 1]], to_home_suppress_warning=False, to_home_compat="snapshot"
    ),
    "remove_orb": lambda m: m.make_supercell([[2, 0], [0, 1]]).remove_orb([1, 2]),
    "change_nonperiodic_vector": lambda m: m.cut_piece(2, 1).change_nonperiodic_vector(
        1, to_home_suppress_warning=True
    ),
}

MODELS = {1: lambda: zoo.haldane(pythtb_tpu), 2: lambda: zoo.kane_mele(pythtb_tpu, "odd")}


def _hop_table(m):
    hops = sorted(
        m._hoppings,
        key=lambda h: (h[1], h[2]) + (tuple(np.asarray(h[3], float)) if m._dim_k else ()),
    )
    amps = np.array([np.asarray(h[0], dtype=complex) for h in hops])
    ij = np.array([[h[1], h[2]] for h in hops], dtype=int)
    R = np.array([np.asarray(h[3], float) for h in hops]) if m._dim_k else None
    return amps, ij, R


def _bands(m):
    if m._dim_k == 0:
        return m.solve_all()
    k = np.random.default_rng(m._dim_k).uniform(-0.5, 0.5, (5, m._dim_k))
    return m.solve_all(k)


@pytest.mark.parametrize("nspin", [1, 2])
@pytest.mark.parametrize("op", sorted(OPS))
def test_surgery_matches_jax(op, nspin):
    jm = MODELS[nspin]()
    with redirect_stdout(io.StringIO()):
        jr = OPS[op](jm)
        pr = OPS[op](carry(jm))
    assert isinstance(pr, pythtb_tpu_torch.tb_model)
    for attr in ("_dim_k", "_dim_r", "_per", "_nspin", "_norb", "_nsta",
                 "_assume_position_operator_diagonal"):
        assert getattr(pr, attr) == getattr(jr, attr), attr
    np.testing.assert_allclose(pr._lat, jr._lat, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pr._orb, jr._orb, rtol=0, atol=ATOL)
    np.testing.assert_allclose(pr._site_energies, jr._site_energies, rtol=0, atol=ATOL)
    (pa, pij, pR), (ja, jij, jR) = _hop_table(pr), _hop_table(jr)
    np.testing.assert_array_equal(pij, jij)
    np.testing.assert_allclose(pa, ja, rtol=0, atol=ATOL)
    if jR is not None:
        np.testing.assert_allclose(pR, jR, rtol=0, atol=ATOL)
    np.testing.assert_allclose(_bands(pr), _bands(jr), rtol=0, atol=ATOL)


def test_supercell_vectors_and_validate():
    jm = zoo.haldane(pythtb_tpu)
    with redirect_stdout(io.StringIO()):
        _, jv = jm.make_supercell([[2, 1], [-1, 2]], return_sc_vectors=True)
        pr, pv = carry(jm).make_supercell([[2, 1], [-1, 2]], return_sc_vectors=True)
    np.testing.assert_array_equal(np.array(pv), np.array(jv))
    assert pr.validate() is pr
    pr._hoppings[0][0] = np.nan
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        pr.validate()
