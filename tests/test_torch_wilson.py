"""Wilson loops, Wilson flows, the Z2 invariant and polarization in the
port against pythtb_tpu, on the CPU in float64.

The loop products run on the same states in both packages: products and
smallest singular values agree to 1e-12 (a product of unitaries, so its
entries are O(1)).  Flows from each package's own solve agree as phase
sets to 1e-10 (modulo 2 pi), the Z2 invariant exactly, and the
polarization to 1e-10 modulo 1.
"""

import io
import warnings
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pythtb_tpu
from pythtb_tpu import flows as jflows
from pythtb_tpu.ops import berry as jberry
from pythtb_tpu.utils.xfer import host_pack, host_unpack
from pythtb_tpu_torch import flows
from pythtb_tpu_torch.ops import berry

from . import zoo
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

ATOL = 1e-12
PHASE_TOL = 1e-10


def _sets_close(a, b, tol):
    """Max distance between rows of phases matched as sets on the circle."""
    a2, b2 = np.reshape(a, (-1, np.shape(a)[-1])), np.reshape(b, (-1, np.shape(b)[-1]))
    worst = 0.0
    for ra, rb in zip(a2, b2):
        left = list(ra)
        for x in rb:
            d = [abs(np.angle(np.exp(1j * (y - x)))) for y in left]
            worst = max(worst, min(d))
            left.pop(int(np.argmin(d)))
    assert worst < tol, worst


def _unit_states(seed, shape):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return z / np.linalg.norm(z, axis=-1, keepdims=True)


def _grid_states(topo="odd", n=9):
    """Kane-Mele states on an n x n grid (nspin 2), solved by pythtb_tpu."""
    jw = pythtb_tpu.wf_array(zoo.kane_mele(pythtb_tpu, topo), [n, n])
    jw.solve_on_grid([-0.5, -0.5])
    return jw._host_ro()


CASES = [
    # (states, occ, nspin, dim_arr)
    ("km_grid", lambda: (_grid_states(), [0, 1], 2, 2)),
    ("random_S1_3d", lambda: (_unit_states(1, (4, 3, 5, 2, 3)), [1], 1, 3)),
    ("random_S2", lambda: (_unit_states(2, (5, 4, 3, 6)), [0, 2], 1, 2)),
    ("random_S3_3d", lambda: (_unit_states(3, (3, 4, 3, 4, 7)), [3, 0, 1], 1, 3)),
    ("random_S9_1d", lambda: (_unit_states(4, (6, 10, 12)), list(range(9)), 1, 1)),
    ("random_S16", lambda: (_unit_states(5, (5, 7, 20, 24)), list(range(16)), 1, 2)),
    # the slab's shape: 20 of 39 states of 39 orbitals on 41-point strings
    ("S20_F39", lambda: (_unit_states(6, (41, 3, 39, 39)), list(range(20)), 1, 2)),
]


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_loop_products_match_jax(case):
    wfs, occ, nspin, dim_arr = dict(CASES)[case]()
    wt = torch.as_tensor(wfs)
    for d in range(dim_arr):
        want, want_s = jberry.berry_loop_products(host_pack(wfs), occ, d, nspin, dim_arr)
        got, got_s = berry.berry_loop_products(wt, occ, d, nspin, dim_arr)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
        assert abs(got_s - want_s) < ATOL
        # the plain Wilson-loop function (kernel 5's oracle) against the JAX
        # program itself: per-string products and smallest singular values
        prd, msv = jberry._berry_products_jit(host_pack(wfs), tuple(occ), d, nspin, dim_arr)
        prod, smin = berry._wilson_loop_plain(berry.prep_states(wt, occ, nspin, dim_arr), d)
        np.testing.assert_allclose(prod.numpy(), host_unpack(prd), rtol=0, atol=ATOL)
        assert abs(float(smin.amin()) - float(msv)) < ATOL
        assert smin.shape == want.shape[:-2]
        # eigenphases of the products, as wf_array.berry_phase(berry_evals=True)
        got_ev, _ = berry.berry_evals(wt, occ, d, nspin, dim_arr)
        want_ev, _ = jberry.berry_evals(host_pack(wfs), occ, d, nspin, dim_arr)
        _sets_close(got_ev, want_ev, PHASE_TOL)


def test_wilson_path_dispatch():
    """Kernel 5's design by S: a warp a link to S 28, a block a link to
    64; a CPU tensor runs the plain version whatever design is asked, and
    an unknown design is refused."""
    assert [berry._wilson_path(S) for S in (1, 2, 8, 9, 28, 29, 32, 64)] == [
        "warp", "warp", "warp", "warp", "warp", "block", "block", "block"]
    assert berry._WILSON_MODES["warp"][1] == 32 and berry._WILSON_MODES["block"][1] == 64
    w = torch.as_tensor(_unit_states(7, (4, 3, 5, 6)))
    want = berry._wilson_loop_plain(w, 0)
    for got in [berry.wilson_loop(w, 0)] + [berry._wilson_loop(w, 0, path) for path in (None, "warp", "block")]:
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="no 'registers' path"):
        berry._wilson_loop(w, 0, "registers")


@pytest.mark.parametrize("S", [3, 5])
def test_unitary_eigenphases_match_jax(S):
    rng = np.random.default_rng(S)
    z = rng.normal(size=(6, S, S)) + 1j * rng.normal(size=(6, S, S))
    U = np.linalg.qr(z)[0]
    U[0] = np.diag(np.exp(1j * np.array([0.3, -0.3] + [np.pi] * (S - 2))))  # +-theta pair, pi cluster
    got = berry.unitary_eigenphases(torch.as_tensor(U)).numpy()
    _sets_close(got, np.asarray(jberry.unitary_eigenphases(jnp.asarray(U))), PHASE_TOL)
    _sets_close(got, np.angle(np.linalg.eigvals(U)), PHASE_TOL)


@pytest.mark.parametrize("loop_dir", [0, 1])
@pytest.mark.parametrize("topo", ["odd", "even"])
def test_wilson_flow_matches_jax(topo, loop_dir):
    jm = zoo.kane_mele(pythtb_tpu, topo)
    got_ev, got_tr = flows.wilson_flow(carry(jm), [0, 1], nk=(13, 11), loop_dir=loop_dir)
    want_ev, want_tr = jflows.wilson_flow(jm, [0, 1], nk=(13, 11), loop_dir=loop_dir)
    assert got_ev.shape == want_ev.shape and got_tr.shape == want_tr.shape
    _sets_close(got_ev, want_ev, PHASE_TOL)
    assert np.abs(np.angle(np.exp(1j * (got_tr - want_tr)))).max() < PHASE_TOL


def test_wilson_flow_equals_the_wf_array_route():
    pm = carry(zoo.kane_mele(pythtb_tpu, "odd"))
    ev, _ = flows.wilson_flow(pm, [0, 1], nk=(11, 11), loop_dir=1)
    wf = pythtb_tpu.wf_array(zoo.kane_mele(pythtb_tpu, "odd"), [11, 11])
    wf.solve_on_grid([-0.5, -0.5])
    _sets_close(ev, wf.berry_phase([0, 1], dir=1, contin=False, berry_evals=True), PHASE_TOL)


@pytest.mark.parametrize("check", [False, True])
def test_z2_invariant_matches_jax(check):
    for topo, z2 in (("odd", 1.0), ("even", 0.0)):
        jm = zoo.kane_mele(pythtb_tpu, topo)
        with warnings.catch_warnings():
            warnings.simplefilter("error")  # both grids must agree: no warning
            got = flows.z2_invariant(carry(jm), nk=(11, 11), check=check)
            want = jflows.z2_invariant(jm, nk=(11, 11), check=check)
        assert got == want == z2


def test_z2_fn_is_a_function_of_the_parameter_tensors():
    pm = carry(zoo.kane_mele(pythtb_tpu, "odd"))
    fn, p0 = flows.z2_fn(pm, nk=(11, 11))
    assert set(p0) == {"amps", "diag"} and all(isinstance(v, torch.Tensor) for v in p0.values())
    assert float(fn(p0)) == 1.0
    # a large staggered on-site term makes the insulator trivial
    big = {"amps": p0["amps"], "diag": p0["diag"] * 2.5}
    assert float(fn(big)) == 0.0
    with pytest.raises(ValueError):
        flows.z2_fn(pm, occ=(0,))
    with pytest.raises(ValueError):
        flows.z2_fn(pm, nk=(11, 10))


@pytest.mark.parametrize("name,occ,d", [("haldane", [0], 0), ("haldane", [0], 1),
                                         ("kane_mele", [0, 1], 0)])
def test_polarization_matches_jax(name, occ, d):
    jm = zoo.haldane(pythtb_tpu) if name == "haldane" else zoo.kane_mele(pythtb_tpu, "even")
    with redirect_stdout(io.StringIO()):
        got = flows.polarization(carry(jm), occ, dir=d, nk=9)
        want = jflows.polarization(jm, occ, dir=d, nk=9)
    assert abs(np.angle(np.exp(2j * np.pi * (got - want)))) / (2 * np.pi) < PHASE_TOL
