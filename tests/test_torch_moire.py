"""The port's moire constructors (``models.tbg``, ``tbg_angle``,
``sk_graphene``) against pythtb_tpu's, on the CPU: the same host NumPy
code, so hop lists, positions and on-site energies agree to 1e-12; and
the decoupled folding oracle of tests/test_moire.py on the port's
solver.
"""

import numpy as np
import pytest

import pythtb_tpu_torch
from pythtb_tpu import PythtbError as JaxPythtbError
from pythtb_tpu.models import moire as jmoire
from pythtb_tpu_torch import PythtbError
from pythtb_tpu_torch.models import moire

from .test_moire import _folded_kset
from .test_torch_ops import on_cpu, state_of  # noqa: F401  (autouse: the port on the CPU)


def _same_model(pm, jm, tol=1e-12):
    a, b = state_of(pm), state_of(jm)
    for key in ("dim_k", "dim_r", "per", "nspin"):
        assert a[key] == b[key], key
    for key in ("lat", "orb", "site_energies", "amps", "R"):
        np.testing.assert_allclose(np.asarray(a[key]), np.asarray(b[key]), rtol=0, atol=tol, err_msg=key)
    for key in ("i", "j"):
        np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("kwargs", [dict(m=1), dict(m=2), dict(m=2, interlayer=False),
                                    dict(m=3, cutoff=3.0, vpp_sigma=0.3)])
def test_tbg_matches_jax(kwargs):
    _same_model(moire.tbg(**kwargs), jmoire.tbg(**kwargs))


def test_sk_graphene_and_angles_match_jax():
    _same_model(moire.sk_graphene(), jmoire.sk_graphene())
    _same_model(moire.sk_graphene(cutoff=3.0, r0=0.5), jmoire.sk_graphene(cutoff=3.0, r0=0.5))
    for m in (1, 2, 8, 30):
        assert moire.tbg_angle(m) == jmoire.tbg_angle(m)
    assert abs(moire.tbg_angle(30) - 1.0845) < 1e-3
    with pytest.raises(PythtbError):
        moire.tbg_angle(0)
    with pytest.raises(PythtbError):
        moire.tbg(2, cutoff=1.0)
    with pytest.raises(JaxPythtbError):
        jmoire.tbg(2, cutoff=1.0)
    assert pythtb_tpu_torch.models.tbg is moire.tbg


@pytest.mark.parametrize("K", [[0.0, 0.0], [0.2, 0.37], [1 / 3.0, 1 / 3.0]])
def test_decoupled_folding_oracle(K):
    """Interlayer hops off: the moire spectrum at any supercell k is the
    band-folded union of the same Slater-Koster monolayer's."""
    m = 2
    ev = np.sort(moire.tbg(m, interlayer=False).solve_all(np.array([K]))[:, 0])
    g = moire.sk_graphene()
    M1 = np.array([[m, m + 1], [-(m + 1), 2 * m + 1]])
    M2 = np.array([[m + 1, m], [-m, 2 * m + 1]])
    ref = np.sort(np.concatenate([g.solve_all(_folded_kset(M, K)).ravel() for M in (M1, M2)]))
    assert ev.shape == ref.shape
    np.testing.assert_allclose(ev, ref, rtol=0, atol=1e-10)
