"""The port's semi-infinite surface spectra (``surface.spectral_function``,
kernel 12's and kernel 1's one-sided plain versions here) against
pythtb_tpu's, on the CPU in float64: 1e-10 relative to the largest
weight, for both sides, with the bulk and the resolved weights, plus the
escalation of ``iters``, the non-convergence warning and the errors.
"""

import warnings

import numpy as np
import pytest
import torch

from pythtb_tpu import surface as jsurface
from pythtb_tpu import tb_model as jtb_model
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, surface
from pythtb_tpu_torch.ops import hamiltonian

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)


def _second_neighbour():
    # R_surf = 2 hops force a 2-cell principal layer (the m > 1 path)
    m = jtb_model(2, 2, lat=[[1.0, 0.0], [0.0, 1.0]], orb=[[0.0, 0.0]])
    m.set_hop(1.0, 0, 0, [1, 0])
    m.set_hop(1.0, 0, 0, [0, 1])
    m.set_hop(0.35 + 0.2j, 0, 0, [0, 2])
    return m


CASES = {
    "chain": (lambda: jzoo.chain(t=-1.0), 0, None, np.linspace(-3.0, 3.0, 31), 0.02),
    "haldane": (jzoo.haldane, 1, np.array([[0.15], [0.35], [0.6]]), np.array([-1.2, -0.3, 0.4, 1.5]), 0.08),
    "graphene zigzag": (jzoo.graphene, 1, np.linspace(0.0, 1.0, 9)[:, None], np.array([0.0, 0.8]), 0.02),
    "kane_mele spinful": (lambda: jzoo.kane_mele(esite=1.0), 1, np.linspace(0.0, 1.0, 7)[:, None],
                          np.array([-0.2, 0.1]), 0.03),
    "weyl arc": (jzoo.weyl, 0, np.stack([np.linspace(-0.2, 0.2, 5), np.full(5, 0.5)], -1), np.array([0.0]),
                 0.03),
    "second neighbour layer": (_second_neighbour, 1, np.array([[0.1], [0.45]]), np.array([-2.0, 0.0, 1.3]),
                               0.08),
}


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("side", ["bottom", "top"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_spectral_function_matches_jax(name, side):
    build, d, kpar, E, eta = CASES[name]
    jm = build()
    pm = carry(jm)
    kw = dict(k_par=kpar, energies=E, eta=eta, side=side)
    As, Ab = surface.spectral_function(pm, d, return_bulk=True, resolved=True, **kw)
    Js, Jb = jsurface.spectral_function(jm, d, return_bulk=True, resolved=True, **kw)
    _close(As, np.asarray(Js))
    _close(Ab, np.asarray(Jb))
    _close(surface.spectral_function(pm, d, **kw), np.asarray(jsurface.spectral_function(jm, d, **kw)))


def test_default_energies_and_escalation():
    """The default energy grid, and a broadening small enough that the
    residual forces the escalation of iters (5 -> 35 -> 65)."""
    jm = jzoo.haldane()
    kpar = np.array([[0.2], [0.5]])
    _close(surface.spectral_function(carry(jm), 1, k_par=kpar, eta=0.1),
           np.asarray(jsurface.spectral_function(jm, 1, k_par=kpar, eta=0.1)))
    kw = dict(k_par=kpar, energies=np.array([0.0, 0.5]), eta=0.005, iters=5, max_iters=65)
    _close(surface.spectral_function(carry(jm), 1, **kw), np.asarray(jsurface.spectral_function(jm, 1, **kw)))


def test_non_convergence_warning():
    jm = jzoo.chain()
    kw = dict(energies=np.array([0.0, 1.0]), eta=1e-9, iters=5, max_iters=5)
    with pytest.warns(UserWarning, match="not converged"):
        got = surface.spectral_function(carry(jm), 0, **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = np.asarray(jsurface.spectral_function(jm, 0, **kw))
    _close(got, want)
    # the blow-up regime: a residual of inf or NaN warns too, and stops
    # escalating at once
    with pytest.warns(UserWarning, match="not converged"):
        surface.spectral_function(carry(jm), 0, energies=np.array([0.0]), eta=0.0, iters=400, max_iters=460)


def test_one_sided_plain_is_direct_scatter():
    """Kernel 1's one-sided mode: direct terms only, no partner, no
    diagonal (the scatter of surface._one_sided)."""
    pm = carry(jzoo.kane_mele())
    data = pm._get_finalized()
    k = torch.as_tensor(np.random.default_rng(0).uniform(-1, 1, (5, 2)))
    H1 = hamiltonian.assemble_one_sided(data, k)
    H = hamiltonian.assemble(data, k)
    herm = H1 + H1.conj().transpose(-1, -2) + data.diag[None]
    np.testing.assert_allclose(herm.numpy(), H.numpy(), rtol=0, atol=1e-13)


def test_validation():
    with pytest.raises(PythtbError):
        surface.spectral_function(carry(jzoo.molecule_nh3()), 0)
    with pytest.raises(PythtbError):
        surface.spectral_function(carry(jzoo.graphene()), 0)  # k_par required
    with pytest.raises(PythtbError):
        surface.spectral_function(carry(jzoo.graphene()), 0, k_par=np.zeros((3, 2)), energies=np.zeros(3))
    with pytest.raises(PythtbError):
        surface.spectral_function(carry(jzoo.chain()), 0, energies=np.zeros(3), side="left")
    m = jtb_model(2, 2, lat=[[1.0, 0.0], [0.0, 1.0]], orb=[[0.0, 0.0], [0.5, 0.5]])
    m.set_hop(1.0, 0, 1, [1, 0])
    m.set_hop(0.3, 0, 1, [0, 0.5])  # fractional R: no layer decomposition
    with pytest.raises(PythtbError):
        surface.spectral_function(carry(m), 1, k_par=np.zeros((1, 1)), energies=np.zeros(2))
