"""The port's mean-field fixed points (``meanfield``) against pythtb_tpu's,
on the CPU in float64, where kernels 1 and 2 run their plain versions.

Gauge-invariant outputs with the iteration counts: HF densities (or the
2x2 spin density matrices), energies, gaps and BCS gaps at 1e-10, the
iteration count and the convergence flag exactly (the chunked device loop
freezes each iterate under the reference's stopping rule).  mu is held
only where it is defined: inside a gap at T ~ 0 every mu gives the same
filling to rounding, and two bisections may stop anywhere in it; on a
metallic spectrum the round-based bisection meets the JAX package's
fixed-length one at 1e-12.
"""

import warnings

import numpy as np
import pytest
import torch

import pythtb_tpu as jpt
from pythtb_tpu import meanfield as jmf
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import meanfield

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

TOL = 1e-10


def _ring(L):
    ch = jpt.tb_model(1, 1, [[1.0]], [[0.0]])
    ch.set_hop(-1.0, 0, 0, [1])
    return ch.cut_piece(L, 0, glue_edgs=True)


def _both(fn_j, fn_p, jm, *args, **kwargs):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn_j(jm, *args, **kwargs), fn_p(carry(jm), *args, **kwargs)


@pytest.mark.parametrize("case", ["ring 6 finite", "graphene 4x4", "ring 6, 5 iterations"])
def test_hartree_fock_collinear_matches_jax(case):
    jm, args, kw = {
        "ring 6 finite": (_ring(6), (4.0, 6.0), dict(temperature=2e-3, stagger=0.4, seed=1, max_iters=4000)),
        "graphene 4x4": (jzoo.graphene(t=-1.0), (3.0, 2.0), dict(nk=(4, 4), seed=3)),
        "ring 6, 5 iterations": (_ring(6), (4.0, 6.0), dict(temperature=2e-3, stagger=0.4, seed=1, max_iters=5)),
    }[case]
    a, b = _both(jmf.hartree_fock, meanfield.hartree_fock, jm, *args, **kw)
    assert (b["iters"], b["converged"]) == (a["iters"], a["converged"])
    for key in ("n_up", "n_dn", "magnetization"):
        assert np.abs(b[key] - a[key]).max() <= TOL
    assert abs(b["energy"] - a["energy"]) <= TOL and abs(b["gap"] - a["gap"]) <= TOL
    assert np.allclose(b["model_up"]._site_energies, a["model_up"]._site_energies, rtol=0, atol=TOL)


def test_hartree_fock_matrix_matches_jax():
    a, b = _both(jmf.hartree_fock, meanfield.hartree_fock, jzoo.kane_mele(), 3.0, 2.0, nk=(3, 3), seed=1)
    assert (b["iters"], b["converged"]) == (a["iters"], a["converged"])
    for key in ("rho", "magnetization", "density"):
        assert np.abs(b[key] - a[key]).max() <= TOL
    assert abs(b["energy"] - a["energy"]) <= TOL and abs(b["gap"] - a["gap"]) <= TOL
    assert np.abs(np.asarray(b["model_mf"]._site_energies) - np.asarray(a["model_mf"]._site_energies)).max() <= TOL


@pytest.mark.parametrize("g,max_iters", [(1.5, 4000), (2.5, 4000), (2.5, 7), (2.5, 0)])
def test_bcs_gap_matches_jax(g, max_iters):
    a, b = _both(jmf.bcs_gap, meanfield.bcs_gap, jzoo.square(t=-1.0), g, -0.4, nk=(8, 8), temperature=0.01,
                 max_iters=max_iters)
    assert (b["iters"], b["converged"]) == (a["iters"], a["converged"])
    assert np.abs(b["delta"] - a["delta"]).max() <= TOL and abs(b["qp_gap"] - a["qp_gap"]) <= TOL


def test_bisect_mu_matches_jax_on_a_metallic_spectrum():
    w = np.sort(np.random.default_rng(0).uniform(-2.0, 2.0, (2, 25, 3)), axis=-1)
    for n_target, kt in ((1.4, 0.05), (2.9, 0.2)):
        want = float(jmf._bisect_mu(w, kt, n_target, 25))
        got = float(meanfield._bisect_mu(torch.as_tensor(w), kt, n_target, 25))
        assert abs(got - want) <= 1e-12
