"""The port's velocity operators and Berry-curvature response against
pythtb_tpu, on the CPU in float64 (the plain versions of kernels 15 and
17 here): assemble_dk / assemble_d2k to 1e-12 at nspin 1 and 2 and
dim_k 1, 2, 3, and against central finite differences of assemble; the
dilogarithm against scipy; the anomalous Hall (with its degeneracy
warning), Nernst and thermal Hall sweeps, orbital magnetization, Berry
dipole and spin Hall conductivity to 1e-10 relative.  Only gauge-invariant
outputs are compared.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

import pythtb_tpu
from pythtb_tpu import flows as jflows
from pythtb_tpu.models import library as jzoo
from pythtb_tpu.ops import hamiltonian as jham
from pythtb_tpu_torch import flows
from pythtb_tpu_torch.ops import fermi_sweep, hamiltonian

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _spinful_chain():
    m = pythtb_tpu.tb_model(1, 1, lat=[[1.0]], orb=[[0.0], [0.4]], nspin=2)
    m.set_onsite([[0.3, 0.0, 0.2, -0.1], [-0.4, 0.1, 0.0, 0.3]])
    m.set_hop([0.9, 0.1, 0.0, 0.2], 0, 1, [0])
    m.set_hop(0.5 + 0.3j, 1, 0, [1])
    m.set_hop([0.2, 0.0, 0.15, 0.0], 0, 0, [1])
    return m


DERIV_MODELS = {
    "ssh dim1": lambda: jzoo.ssh(delta=0.3),
    "haldane dim2": jzoo.haldane,
    "cscl dim3": jzoo.cscl,
    "spinful chain dim1 nspin2": _spinful_chain,
    "kane_mele dim2 nspin2": jzoo.kane_mele,
    "fu_kane_mele dim3 nspin2": lambda: jzoo.fu_kane_mele(beta=0.4),
}


@pytest.mark.parametrize("name", list(DERIV_MODELS))
def test_assemble_derivatives_match_jax(name):
    jm = DERIV_MODELS[name]()
    static, data = jm._get_finalized()
    tdata = carry(jm)._get_finalized()
    k = np.random.default_rng(3).uniform(-1.0, 1.0, (5, static.dim_k))
    for jfn, tfn in ((jham.assemble_dk, hamiltonian.assemble_dk), (jham.assemble_d2k, hamiltonian.assemble_d2k)):
        want = np.asarray(jfn(static, data, jnp.asarray(k)))
        got = tfn(tdata, torch.as_tensor(k)).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() < 1e-12 * max(1.0, np.abs(want).max()), jfn.__name__


@pytest.mark.parametrize("name", list(DERIV_MODELS))
def test_assemble_derivatives_match_finite_differences(name):
    """dH/dk_a against the central difference of assemble (step 1e-5),
    d2H/dk_a dk_b against the central difference of dH/dk_b."""
    data = carry(DERIV_MODELS[name]())._get_finalized()
    k = torch.as_tensor(np.random.default_rng(4).uniform(-1.0, 1.0, (4, data.dim_k)))
    h = 1e-5
    dH, d2H = hamiltonian.assemble_dk(data, k), hamiltonian.assemble_d2k(data, k)
    for a in range(data.dim_k):
        step = torch.zeros_like(k)
        step[:, a] = h
        fd = (hamiltonian.assemble(data, k + step) - hamiltonian.assemble(data, k - step)) / (2 * h)
        assert (dH[:, a] - fd).abs().max() < 1e-7
        fd2 = (hamiltonian.assemble_dk(data, k + step) - hamiltonian.assemble_dk(data, k - step)) / (2 * h)
        assert (d2H[:, a] - fd2).abs().max() < 1e-7 * max(1.0, float(d2H.abs().max()))


def test_assemble_derivatives_without_hops_or_periodic_directions():
    """Zeros when the model has no hoppings, and for a molecule (dim_k 0),
    unlike assemble, where a molecule still has its hoppings."""
    bare = pythtb_tpu.tb_model(2, 2, lat=[[1.0, 0.0], [0.0, 1.0]], orb=[[0.0, 0.0], [0.5, 0.5]])
    bare.set_onsite([0.3, -0.3])
    data = carry(bare)._get_finalized()
    k = torch.zeros((3, 2), dtype=torch.float64)
    assert hamiltonian.assemble_dk(data, k).shape == (3, 2, 2, 2)
    assert hamiltonian.assemble_d2k(data, k).abs().max() == 0
    mol = carry(jzoo.molecule_nh3())._get_finalized()
    k0 = torch.zeros((1, 0), dtype=torch.float64)
    assert hamiltonian.assemble_dk(mol, k0).shape == (1, 0, mol.nsta, mol.nsta)
    assert hamiltonian.assemble_d2k(mol, k0).shape == (1, 0, 0, mol.nsta, mol.nsta)


def test_spence_matches_scipy():
    x = np.concatenate([[0.0, 0.5, 1.0, 1.5, 2.0], np.linspace(1e-6, 6.0, 601),
                        1.0 + np.exp(-np.linspace(0.0, 30.0, 301))])
    got = fermi_sweep.spence(torch.as_tensor(x)).numpy()
    want = scipy.special.spence(x)
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    assert torch.isnan(fermi_sweep.spence(torch.tensor([-0.5], dtype=torch.float64))).all()


def test_c2_weight_matches_jax():
    x = np.concatenate([np.linspace(-40.0, 40.0, 801), [0.0, 30.0, -30.0]])
    got = fermi_sweep.c2_weight(torch.as_tensor(x)).numpy()
    want = np.asarray(jflows._c2_weight(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_anomalous_hall_matches_jax():
    jm = jzoo.haldane()
    tm = carry(jm)
    efs = np.linspace(-3.5, 3.5, 9)
    for kt in (0.0, 0.2):
        _close(flows.anomalous_hall(tm, efs, nk=(21, 21), temperature=kt),
               jflows.anomalous_hall(jm, efs, nk=(21, 21), temperature=kt))
    got = flows.anomalous_hall(tm, 0.0, nk=(21, 21))
    assert isinstance(got, float) and abs(got + 1.0) < 1e-6


def test_anomalous_hall_degeneracy_warning():
    """E_F at graphene's Dirac point, K on the grid: both packages warn
    and agree."""
    jg = jzoo.graphene()
    with pytest.warns(UserWarning, match="band degeneracy"):
        want = jflows.anomalous_hall(jg, [0.0, 1.0], nk=(13, 13), start_k=(0.0, 0.0))
    with pytest.warns(UserWarning, match=r"E_F = \[0.0\] passes through a band degeneracy"):
        got = flows.anomalous_hall(carry(jg), [0.0, 1.0], nk=(13, 13), start_k=(0.0, 0.0))
    assert np.abs(got - want).max() < 1e-12
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        flows.anomalous_hall(carry(jg), [0.0], nk=(13, 13), start_k=(0.0, 0.0), temperature=0.1)


def test_nernst_and_thermal_hall_match_jax():
    jm = jzoo.haldane()
    tm = carry(jm)
    mus = np.linspace(-3.0, 3.0, 7)
    _close(flows.anomalous_nernst(tm, mus, 0.3, nk=(21, 21)), jflows.anomalous_nernst(jm, mus, 0.3, nk=(21, 21)))
    _close(flows.thermal_hall(tm, mus, 0.15, nk=(21, 21)), jflows.thermal_hall(jm, mus, 0.15, nk=(21, 21)))
    with pytest.raises(ValueError, match="requires temperature > 0"):
        flows.thermal_hall(tm, 0.0, 0.0)
    with pytest.raises(ValueError, match="requires temperature > 0"):
        flows.anomalous_nernst(tm, 0.0, -1.0)


def _zeeman_kane_mele():
    """Kane-Mele with a Zeeman field: time reversal broken, so M != 0."""
    m = jzoo.kane_mele(rashba=0.1)
    m.set_onsite([[0.0, 0.0, 0.0, 0.2], [0.0, 0.0, 0.0, 0.2]], mode="add")
    return m


def test_orbital_magnetization_matches_jax():
    for jm, occ, nk, mus in ((jzoo.haldane(t2=0.15 * np.exp(0.7j)), [0], (15, 15), (None, -0.1)),
                             (_zeeman_kane_mele(), [0, 1], (9, 9), (None,))):
        tm = carry(jm)
        for mu in mus:
            _close(flows.orbital_magnetization(tm, occ, nk=nk, mu=mu),
                   jflows.orbital_magnetization(jm, occ, nk=nk, mu=mu))
    with pytest.warns(UserWarning, match="not inside the band gap"):
        flows.orbital_magnetization(carry(jzoo.haldane()), [0], nk=(9, 9), mu=5.0)
    with pytest.raises(ValueError, match="at least one empty band"):
        flows.orbital_magnetization(carry(jzoo.haldane()), [0, 1])


def _tilted_bn(t2=0.4):
    """BN with a real second-neighbour hop along one direction: C3 broken,
    time reversal kept -- a nonzero Berry dipole."""
    m = jzoo.bn(delta=0.7)
    m.set_hop(t2, 0, 0, [1, 0])
    m.set_hop(t2, 1, 1, [1, 0])
    return m


def test_berry_dipole_and_spin_hall_match_jax():
    jm = _tilted_bn()
    mus = np.array([-1.3, -1.05, 1.2])
    _close(flows.berry_dipole(carry(jm), mus, 0.1, nk=(21, 21)), jflows.berry_dipole(jm, mus, 0.1, nk=(21, 21)))
    assert flows.berry_dipole(carry(jm), -1.05, 0.1, nk=(21, 21)).shape == (2,)
    jk = jzoo.kane_mele(rashba=0.1)
    _close(flows.spin_hall_conductivity(carry(jk), [0, 1], nk=(15, 15)),
           jflows.spin_hall_conductivity(jk, [0, 1], nk=(15, 15)))
    with pytest.raises(ValueError, match="requires a spinful model"):
        flows.spin_hall_conductivity(carry(jm), [0])
    with pytest.raises(ValueError, match="requires temperature > 0"):
        flows.berry_dipole(carry(jm), 0.0, 0.0)


# kernel 17's launch layout on the H100's 132 SMs: (T, M, powers) at T 1,
# M 1, P 1 and P 16, the Boltzmann row's 512^2 sweep (2-D: L0, L1, L2 and
# the Hall columns), a 3-D Boltzmann layout (P 54, more than one slot
# group) and the anomalous Hall step sweep
SWEEP_LAYOUTS = {
    "T1 M1 P1": (1, 1, [0]),
    "T1 M1 P16": (1, 1, [0] * 4 + [1] * 4 + [2] * 4 + [0] * 4),
    "boltzmann 512^2": (524288, 201, [0] * 4 + [1] * 4 + [2] * 4 + [0] * 4),
    "boltzmann 3-D": (20000, 201, [0] * 9 + [1] * 9 + [2] * 9 + [0] * 27),
    "ahc 101^2": (20402, 81, [0]),
    "odd runs, M 300": (5000, 300, [2, 0, 1, 0, 2, 2, 1]),
}


@pytest.mark.parametrize("case", list(SWEEP_LAYOUTS))
def test_sweep_layout_covers_every_term_and_column_once(case):
    """Kernel 17's launch layout: the chunks of t cover [0, T) once, the mu
    blocks every mu once, the slots every column of G once, each run of
    four slots one power; a block's slots, threads and terms within the
    kernel's limits; at the Boltzmann row about four blocks an SM."""
    T, M, jpow = SWEEP_LAYOUTS[case]
    slots, rpow, cols, threads, chunk = fermi_sweep._sweep_layout(T, M, jpow, 132)
    assert sorted(s for s in slots if s >= 0) == list(range(len(jpow)))
    assert cols in (4, 8, 16) and len(slots) % cols == 0 and len(rpow) * 4 == len(slots)
    for r, j in enumerate(rpow):
        assert all(jpow[s] == j for s in slots[4 * r:4 * r + 4] if s >= 0)
    assert chunk % 128 == 0 and chunk >= 128
    chunks = -(-T // chunk)
    assert (chunks - 1) * chunk < T <= chunks * chunk
    assert threads % 32 == 0 and 32 <= threads <= 256
    mu_blocks = -(-M // threads)
    assert (mu_blocks - 1) * threads < M <= mu_blocks * threads
    if case == "boltzmann 512^2":
        assert (cols, threads, chunk, chunks) == (16, 224, 1024, 512)
    if case == "T1 M1 P1":
        assert (slots, rpow, cols, threads, chunk) == ([0, -1, -1, -1], [0], 4, 32, 128)


def _sweep_in_the_kernels_order(E, G, mus, kt, kind, jpow):
    """Kernel 17's sums in plain PyTorch, in the layout's order: G's rows in
    slots, each chunk's (mu, slot) sums, the chunks added in order, the
    slots put back in column order."""
    T = E.shape[0]
    slots, rpow, cols, threads, chunk = fermi_sweep._sweep_layout(T, mus.shape[0], jpow, 132)
    Gs = torch.stack([G[s] if s >= 0 else torch.zeros_like(E) for s in slots])
    pw = torch.as_tensor(np.repeat(rpow, 4))
    out = torch.zeros((mus.shape[0], len(slots)), dtype=torch.float64)
    for t0 in range(0, T, chunk):
        d = E[None, t0:t0 + chunk] - mus[:, None]
        w = fermi_sweep._weight(kind, d, kt)
        out += torch.stack([(w * d ** int(j)) @ Gs[s, t0:t0 + chunk] for s, j in enumerate(pw)], dim=1)
    return out[:, [slots.index(p) for p in range(G.shape[0])]]


@pytest.mark.parametrize("kind", ["step", "dfde", "c2"])
def test_sweep_in_the_kernels_order_matches_the_plain_sweep(kind):
    """The layout's slots, runs and chunks compute the plain sweep to 1e-12
    relative (powers out of order, odd runs, T off the tile)."""
    rng = np.random.default_rng(17)
    T, jpow = 3001, [2, 0, 1, 0, 2, 2, 1]
    E = torch.as_tensor(rng.uniform(-4.0, 4.0, T))
    G = torch.as_tensor(rng.normal(size=(len(jpow), T)))
    mus = torch.as_tensor(np.linspace(-3.0, 3.0, 11))
    want = fermi_sweep._fermi_sweep_plain(E, G, mus, 0.3, kind, jpow)
    got = _sweep_in_the_kernels_order(E, G, mus, 0.3, kind, jpow)
    assert float((got - want).abs().max()) <= 1e-12 * float(want.abs().max())
