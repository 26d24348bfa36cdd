"""The port's ``eph`` module against pythtb_tpu's, on the CPU in float64,
where kernels 1, 2 and 26 run their plain versions.

``coupling`` (|g|^2 in the band basis, |dH| in the orbital basis, the
frequencies) to 1e-12; the batched |g|^2 of one k against
``_gsq_qbatch_jit`` to 1e-12 of its largest entry, off degenerate phonon
modes (|g_mn|^2 of one mode of a degenerate pair depends on the basis
that each package's eigensolver picks; the electron states of the chosen
k and k + q are not degenerate); a chunk of k-points against the per-k
call; ``linewidths`` and ``eliashberg`` (a2F, lambda, N(mu)) to 1e-10
relative, which sum each degenerate group whole; the acoustic sum rule
at small q.  The phonon mode vectors of the two packages differ by a
phase each, which |g|^2 does not see.  Sizes: nkq <= 6^2, eliashberg
nk <= 4^2.
"""

import numpy as np
import pytest

import pythtb_tpu as ptt
from pythtb_tpu import eph as jeph
from pythtb_tpu import phonon as jphonon
from pythtb_tpu_torch import eph

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)
from .test_torch_phonon import carry_fm

LAT = [[1.0, 0.0], [0.5, np.sqrt(3) / 2.0]]
ORB = [[1 / 3.0, 1 / 3.0], [2 / 3.0, 2 / 3.0]]
BETA = 3.0


def _chain():
    m = ptt.tb_model(1, 1, [[1.0]], [[0.0], [0.5]])
    m.set_onsite([0.3, -0.2])
    m.set_hop(-1.0, 0, 1, [0])
    m.set_hop(-0.8, 1, 0, [1])
    fc = jphonon.force_model([[1.0]], [[0.0], [0.5]], masses=[1.0, 1.7])
    fc.set_spring(0.9, 0, 1, [0])
    fc.set_spring(1.2, 1, 0, [1])
    return m, fc


def _graphene():
    m = ptt.tb_model(2, 2, LAT, ORB)
    m.set_onsite([0.1, -0.1])
    m.set_hop(-1.0, 0, 1, [0, 0])
    m.set_hop(-1.0, 1, 0, [1, 0])
    m.set_hop(-1.0, 1, 0, [0, 1])
    m.set_hop(0.1j, 0, 0, [1, 0])
    fc = jphonon.force_model(LAT, ORB, masses=[1.0, 1.4])
    fc.set_spring(1.0, 0, 1, [0, 0], kt=0.3)
    fc.set_spring(1.0, 1, 0, [1, 0], kt=0.3)
    fc.set_spring(1.0, 1, 0, [0, 1], kt=0.3)
    return m, fc


BUILDS = {"chain": _chain, "graphene": _graphene}
KQ = {"chain": ([0.17], [0.31]), "graphene": ([0.21, 0.08], [0.13, 0.37])}
NKQ = {"chain": (6,), "graphene": (4, 4)}


def _port(build):
    m, fc = build()
    return (m, fc), (carry(m), carry_fm(fc))


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_coupling_matches_jax(name):
    (m, fc), (pm, pfc) = _port(BUILDS[name])
    k, q = KQ[name]
    want = jeph.coupling(m, fc, BETA, k, q)
    got = eph.coupling(pm, pfc, BETA, k, q)
    assert np.abs(got["omega"] - want["omega"]).max() <= 1e-12
    assert np.abs(np.abs(got["g"]) ** 2 - np.abs(want["g"]) ** 2).max() <= 1e-12
    want = jeph.coupling(m, fc, BETA, k, q, band_basis=False)
    got = eph.coupling(pm, pfc, BETA, k, q, band_basis=False)
    assert np.abs(np.abs(got["g"]) - np.abs(want["g"])).max() <= 1e-12


def _isolated_modes(w, tol=1e-6):
    """(Q, nmode) mask of the phonon modes whose frequency is apart from
    the others' at the same q."""
    ok = np.ones(w.shape, dtype=bool)
    for a in range(w.shape[1]):
        for b in range(w.shape[1]):
            if a != b:
                ok[:, a] &= np.abs(w[:, a] - w[:, b]) > tol
    return ok


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_gsq_table_of_one_k_matches_jax(name):
    (m, fc), (pm, pfc) = _port(BUILDS[name])
    k = KQ[name][0]
    geom, nkq, qg, ph_w, dev = jeph._qgrid_setup(m, fc, BETA, None, NKQ[name])
    static, data = m._get_finalized()
    want = jeph._gsq_at_k(static, data, k, nkq, dev)
    pgeom, pnkq, pqg, pph_w, grid = eph._qgrid_setup(pm, pfc, BETA, None, NKQ[name])
    got = eph._gsq_at_k(pm._get_finalized(), k, grid)
    assert np.abs(pqg - qg).max() == 0.0 and np.abs(pph_w - ph_w).max() <= 1e-12
    assert np.abs(got[1] - want[1]).max() <= 1e-12 and np.abs(got[2] - want[2]).max() <= 1e-12
    ok = _isolated_modes(ph_w)
    assert ok.sum() >= ok.size // 2
    err = np.abs(got[0] - want[0])[ok]
    assert err.max() <= 1e-12 * np.abs(want[0]).max()
    # a degenerate pair still carries the same total
    tot = np.abs(got[0].sum(axis=1) - want[0].sum(axis=1)).max()
    assert tot <= 1e-12 * np.abs(want[0]).max() * got[0].shape[1]


def test_a_chunk_of_k_matches_the_per_k_call():
    _, (pm, pfc) = _port(_graphene)
    _, _, _, _, grid = eph._qgrid_setup(pm, pfc, BETA, None, (3, 3))
    ks = np.array([[0.21, 0.08], [0.4, 0.2], [0.05, 0.33]])
    import torch

    gsq, ek, ekq = eph._gsq_chunk(pm._get_finalized(), torch.as_tensor(ks), grid)
    for i, k in enumerate(ks):
        one = eph._gsq_at_k(pm._get_finalized(), k, grid)
        assert np.abs(gsq[i].numpy() - one[0]).max() <= 1e-14 * max(1.0, np.abs(one[0]).max())
        assert np.abs(ek[i].numpy() - one[1]).max() <= 1e-14 and np.abs(ekq[i].numpy() - one[2]).max() <= 1e-14


@pytest.mark.parametrize("name,mu,T", [("graphene", -0.8, 0.08), ("graphene", 0.3, 0.02), ("chain", -0.5, 0.1)])
def test_linewidths_match_jax(name, mu, T):
    (m, fc), (pm, pfc) = _port(BUILDS[name])
    ks = np.array([KQ[name][0], KQ[name][1]])
    nkq = (6,) * len(NKQ[name])
    want = jeph.linewidths(m, fc, BETA, ks, mu=mu, temperature=T, nkq=nkq, sigma=0.08)
    got = eph.linewidths(pm, pfc, BETA, ks, mu=mu, temperature=T, nkq=nkq, sigma=0.08)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("name,nk,nkq,mu", [("graphene", (4, 4), (4, 4), -0.8), ("chain", (8,), (6,), -0.5)])
def test_eliashberg_matches_jax(name, nk, nkq, mu):
    (m, fc), (pm, pfc) = _port(BUILDS[name])
    want = jeph.eliashberg(m, fc, BETA, mu, nk=nk, nkq=nkq, sigma_e=0.2)
    got = eph.eliashberg(pm, pfc, BETA, mu, nk=nk, nkq=nkq, sigma_e=0.2)
    assert np.abs(got["omega"] - want["omega"]).max() == 0.0
    assert np.abs(got["a2f"] - want["a2f"]).max() <= 1e-10 * np.abs(want["a2f"]).max()
    for key in ("lambda", "dos_ef"):
        assert abs(got[key] - want[key]) <= 1e-10 * abs(want[key])


def test_acoustic_sum_rule_at_small_q():
    """A uniform (acoustic, q -> 0) displacement moves no bond: the
    acoustic vertex vanishes linearly in q, in both packages alike.  The
    two are held to 1e-6 relative here, not 1e-12: at |q| ~ 1e-4 the
    acoustic w^2 ~ 1e-9 carry ~1e-16 of rounding in either package, which
    the amplitudes 1/sqrt(2 omega) and the nearly degenerate pair's mode
    vectors turn into ~1e-7 of |g|^2."""
    (m, fc), (pm, pfc) = _port(_graphene)
    k = [0.21, 0.08]
    acoustic = []
    for q in ([0.0, 1e-4], [0.0, 1e-3]):
        got = eph.coupling(pm, pfc, BETA, k, q)
        want = jeph.coupling(m, fc, BETA, k, q)
        assert np.abs(np.abs(got["g"]) ** 2 - np.abs(want["g"]) ** 2).max() <= 1e-6 * (np.abs(want["g"]) ** 2).max()
        acoustic.append(np.abs(got["g"][:2]).max())
    # the bare vertex ~ q times the zero-point amplitude ~ q^-1/2
    assert abs(acoustic[0] / acoustic[1] - np.sqrt(0.1)) < 0.05
