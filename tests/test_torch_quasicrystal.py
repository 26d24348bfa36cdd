"""The port's quasicrystal and quasiperiodic constructors against
pythtb_tpu's, on the CPU: the same host NumPy code, so tilings, hop
lists, positions and on-site energies agree to 1e-12, and the finite
models' spectra (through the port's solver) to 1e-12.
"""

import numpy as np
import pytest

from pythtb_tpu.models import quasicrystal as jqc
from pythtb_tpu_torch import PythtbError
from pythtb_tpu_torch.models import quasicrystal as qc

from .test_torch_moire import _same_model
from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)

CONSTRUCTORS = {
    "penrose r4": lambda mod: mod.penrose(4.0),
    "penrose r3 seed 2 t=-0.5": lambda mod: mod.penrose(3.0, t=-0.5, seed=2),
    "ammann_beenker r3": lambda mod: mod.ammann_beenker(3.0),
    "aubry_andre 21 lam 1.5": lambda mod: mod.aubry_andre(21, 1.5),
    "aubry_andre 30 open, phi": lambda mod: mod.aubry_andre(30, 2.5, t=0.7, phi=0.3, pbc=False),
    "aubry_andre irrational beta": lambda mod: mod.aubry_andre(17, 1.0, beta=(np.sqrt(5) - 1) / 2),
    "fibonacci_chain 6": lambda mod: mod.fibonacci_chain(6),
    "fibonacci_chain 5 pbc": lambda mod: mod.fibonacci_chain(5, ta=-0.8, tb=-0.3, pbc=True),
}


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_matches_jax(name):
    pm, jm = CONSTRUCTORS[name](qc), CONSTRUCTORS[name](jqc)
    _same_model(pm, jm)
    np.testing.assert_allclose(pm.solve_all(), np.asarray(jm.solve_all()), rtol=0, atol=1e-12)


@pytest.mark.parametrize("ngrid,radius", [(5, 4.0), (4, 3.0), (7, 2.5)])
def test_tiling_and_areas_match_jax(ngrid, radius):
    pt, jt = qc.multigrid_tiling(ngrid, radius), jqc.multigrid_tiling(ngrid, radius)
    for key in ("edges", "tiles", "index"):
        np.testing.assert_array_equal(pt[key], jt[key])
    for key in ("verts", "star"):
        np.testing.assert_allclose(pt[key], jt[key], rtol=0, atol=1e-12)
    np.testing.assert_allclose(qc.vertex_areas(pt), jqc.vertex_areas(jt), rtol=0, atol=1e-12)
    # every edge has unit length
    e = pt["edges"]
    np.testing.assert_allclose(np.linalg.norm(pt["verts"][e[:, 0]] - pt["verts"][e[:, 1]], axis=1), 1.0,
                               atol=1e-12)


def test_words_and_errors():
    for n in range(7):
        assert qc.fibonacci_word(n) == jqc.fibonacci_word(n)
    m, til = qc.penrose(3.0, return_tiling=True)
    assert m._norb == len(til["verts"])
    with pytest.raises(PythtbError):
        qc.multigrid_tiling(3, 2.0)
    with pytest.raises(PythtbError):
        qc.multigrid_tiling(5, 2.0, offsets=[0.1, 0.2])
    with pytest.raises(PythtbError):
        qc.aubry_andre(2, 1.0)
