"""The port's ``geometry.superfluid_weight`` against pythtb_tpu's, on the
CPU in float64, where kernel 23 runs its plain versions: the analytic
Daleckii-Krein Hessian at the default and at an explicit temperature to
1e-12 relative (Lieb, square, a random three-orbital model, 1-D and
3-D); the finite-difference route to 1e-8 relative with the same
under-resolution warning.  The fd stencil divides O(1) free energies'
rounding by step^2, so two correct implementations part at ~1e-8
relative at the default step 1e-3 on the Lieb lattice: the value
comparisons run at step 1e-2 (and the under-resolved square lattice at
the default step).  The JAX results are built once per module; sizes stay
at nk <= (6, 6).
"""

import warnings

import numpy as np
import pytest
import torch

from pythtb_tpu import geometry as jgeometry
from pythtb_tpu import models as jmodels
from pythtb_tpu_torch import geometry

from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)


def _cubic():
    import pythtb_tpu

    m = pythtb_tpu.tb_model(3, 3, np.eye(3).tolist(), [[0.0, 0.0, 0.0], [0.5, 0.5, 0.5]])
    m.set_onsite([0.2, -0.2])
    for R in ([0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]):
        m.set_hop(-0.7, 0, 1, R)
    return m


CASES = {
    "lieb analytic": (jmodels.lieb, (0.0, 0.3), dict(nk=(6, 6))),
    "lieb analytic kT 0.05": (jmodels.lieb, (0.0, 0.3), dict(nk=(5, 6), temperature=0.05)),
    "square analytic": (jmodels.square, (-1.0, 0.4), dict(nk=(6, 5))),
    "random 3 orbitals": (lambda: random_model(71, 2, 1, norb=3, nhop=6), (0.1, 0.5), dict(nk=(5, 5))),
    "chain 1-D": (jmodels.chain, (0.3, 0.2), dict(nk=(16,), temperature=0.02)),
    "cubic 3-D": (_cubic, (0.1, 0.3), dict(nk=(3, 3, 4))),
    "lieb fd": (jmodels.lieb, (0.0, 0.3), dict(nk=(6, 5), method="fd", step=1e-2)),
    "square fd": (jmodels.square, (-1.0, 0.4), dict(nk=(6, 5), method="fd", step=1e-2)),
    "square fd under-resolved": (jmodels.square, (-1.0, 0.002), dict(nk=(4, 4), method="fd")),
}


def _run(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [(w.category, str(w.message)) for w in caught]


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for name, (build, args, kw) in CASES.items():
        m = build()
        out[name] = (m, _run(jgeometry.superfluid_weight, m, *args, **kw))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_superfluid_weight_matches_jax(jax_results, name):
    m, (want, want_warn) = jax_results[name]
    _, args, kw = CASES[name]
    got, got_warn = _run(geometry.superfluid_weight, carry(m), *args, **kw)
    tol = 1e-8 if kw.get("method") == "fd" else 1e-12
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert got_warn == want_warn
    assert bool(want_warn) == name.endswith("under-resolved")


def test_degeneracy_tolerance_is_batch_global(jax_results, monkeypatch):
    """The divided differences switch to f' below 256 eps max(max |lam|, 1)
    taken over the whole k-batch (pythtb_tpu/geometry.py:443-444), not
    per k."""
    seen = {}
    real = geometry.bdg_hessian

    def spy(lam, *args):
        seen["lam"], seen["tol"] = lam, args[-1]
        return real(lam, *args)

    monkeypatch.setattr(geometry, "bdg_hessian", spy)
    m, _ = jax_results["lieb analytic"]
    geometry.superfluid_weight(carry(m), 0.0, 0.3, nk=(6, 6))
    lam = seen["lam"]
    assert seen["tol"] == 256.0 * torch.finfo(torch.float64).eps * max(float(lam.abs().max()), 1.0)
    assert float(lam.abs().amax(dim=1).min()) < float(lam.abs().max())  # a per-k tolerance would differ
