"""The port's NEGF transport (``negf``) against pythtb_tpu's, on the CPU in
float64, where kernel 12's Green's-function mode and kernel 1 run their
plain versions: lead blocks to 1e-14; transmissions (the pristine
staircase, a disordered four-layer device, the spin-resolved split),
the thermoelectric coefficients and the multi-terminal matrix of a
disordered 4 x 4 QWZ Hall bar with its Buttiker potentials to 1e-10
relative to the largest entry; mode counts and the Hall-bar arrays
exactly; warnings and errors with the same messages.
"""

import warnings

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import negf as jnegf
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, negf

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _ribbon():
    return jzoo.graphene(t=-1.0).cut_piece(5, 1, glue_edgs=False)


def _qwz():
    """The QWZ model of the hall_bar_qwz_4terminal_41E bench row."""
    m = pythtb_tpu.tb_model(2, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.0, 0.0]])
    m.set_onsite([-1.0, 1.0])
    for amp, i, j, R in [(0.5, 0, 0, [1, 0]), (-0.5, 1, 1, [1, 0]), (0.5, 0, 0, [0, 1]), (-0.5, 1, 1, [0, 1]),
                         (0.5j, 0, 1, [1, 0]), (0.5j, 1, 0, [1, 0]), (0.5, 0, 1, [0, 1]), (-0.5, 1, 0, [0, 1])]:
        m.set_hop(amp, i, j, R)
    return m


def _second_neighbour_lead():
    # an R = 2 hop along the wire forces a two-cell principal layer
    m = pythtb_tpu.tb_model(1, 2, [[1.0, 0.0], [0.0, 1.0]], [[0.0, 0.0], [0.0, 0.5]], per=[0])
    m.set_onsite([0.2, -0.1])
    m.set_hop(-1.0, 0, 0, [1, 0])
    m.set_hop(-0.8, 1, 1, [1, 0])
    m.set_hop(0.3, 0, 1, [0, 0])
    m.set_hop(0.25 + 0.1j, 0, 1, [2, 0])
    return m


@pytest.mark.parametrize("build", [_ribbon, lambda: jzoo.kane_mele(esite=1.0).cut_piece(3, 1, glue_edgs=False),
                                   _second_neighbour_lead], ids=["graphene", "kane_mele spinful", "second neighbour"])
def test_lead_blocks_match_jax(build):
    jm = build()
    for got, want in zip(negf.lead_blocks(carry(jm)), jnegf.lead_blocks(jm)):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-14


def test_transmission_matches_jax_and_mode_count():
    """The pristine staircase equals the mode count where the counter is
    stable; it and a disordered four-layer device match JAX."""
    jm = _ribbon()
    pm = carry(jm)
    Es = np.linspace(-2.6, 2.6, 27)
    T = negf.landauer_transmission(pm, Es)
    _close(T, jnegf.landauer_transmission(jm, Es))
    # the crossing counter depends on the last bit of a band energy that
    # sits exactly at E (its documented caveat; the ribbon has band values
    # at E = +-1 exactly), so both packages count on a grid beside it
    Ec = Es + 0.01
    M = negf.mode_count(pm, Ec, stability_h=0.005)
    assert np.array_equal(M, jnegf.mode_count(jm, Ec, stability_h=0.005))
    assert np.array_equal(negf.mode_count(pm, Ec), jnegf.mode_count(jm, Ec))
    Tc = negf.landauer_transmission(pm, Ec)
    stable = M > 0
    assert stable.sum() >= 10
    assert np.abs(Tc[stable] - M[stable]).max() < 1e-4
    H00, _ = negf.lead_blocks(pm)
    rng = np.random.default_rng(0)
    dev = [H00 + np.diag(rng.uniform(-1.0, 1.0, len(H00))) for _ in range(4)]
    _close(negf.landauer_transmission(pm, Es, device=dev), jnegf.landauer_transmission(jm, Es, device=dev))


def test_spin_resolved_matches_jax():
    jm = jzoo.kane_mele(esite=1.0, rashba=0.0).cut_piece(3, 1, glue_edgs=False)
    Es = np.array([-0.4, 0.2, 0.9])
    got = negf.landauer_transmission(carry(jm), Es, eta=1e-7, spin_resolved=True)
    assert got.shape == (3, 2)
    _close(got, jnegf.landauer_transmission(jm, Es, eta=1e-7, spin_resolved=True))


def test_thermoelectrics_matches_jax():
    jm = _ribbon()
    kw = dict(n_energies=101)
    got = negf.thermoelectrics(carry(jm), [0.5, 1.2], 0.05, **kw)
    want = jnegf.thermoelectrics(jm, [0.5, 1.2], 0.05, **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])
    assert isinstance(negf.thermoelectrics(carry(jm), 0.5, 0.05, **kw)["G"], float)


def test_hall_bar_multi_terminal_buttiker_match_jax():
    """A disordered 4 x 4 QWZ Hall bar: identical device and lead arrays
    (the disorder drawn from numpy's default_rng, draw for draw), then
    T_pq at five energies and the Buttiker potentials."""
    jm = _qwz()
    Hd, leads, info = negf.hall_bar(carry(jm), (4, 4), disorder=0.5, seed=3)
    Jd, jleads, jinfo = jnegf.hall_bar(jm, (4, 4), disorder=0.5, seed=3)
    assert np.array_equal(Hd, Jd)
    for lead, jlead in zip(leads, jleads):
        for got, want in zip(lead, jlead):
            assert np.array_equal(got, want)
    assert info["order"] == jinfo["order"] and info["site"](1, 2, 1) == jinfo["site"](1, 2, 1)
    Es = np.linspace(-0.8, 0.8, 5)
    T = negf.multi_terminal(Hd, leads, Es)
    JT = jnegf.multi_terminal(Jd, jleads, Es)
    _close(T, JT)
    # unitarity sum rule, up to the broadening eta = 1e-6 leaks (~1e-7 here)
    np.testing.assert_allclose(T.sum(axis=1), T.sum(axis=2), atol=1e-5)
    _close(negf.buttiker(T[2], 0, 1), jnegf.buttiker(JT[2], 0, 1))


def _messages(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        fn(*args, **kwargs)
    return [str(w.message) for w in rec]


def test_warnings_match_jax():
    jm = _ribbon()
    kw = dict(eta=1e-9, iters=3)
    assert _messages(negf.landauer_transmission, carry(jm), [0.3], **kw) == \
        _messages(jnegf.landauer_transmission, jm, [0.3], **kw)
    T = np.array([[0.0, 1.0], [0.2, 0.0]])
    assert _messages(negf.buttiker, T, 0, 1) == _messages(jnegf.buttiker, T, 0, 1)
    # mu in the ribbon's gap: G below the floor, NaN ratios with a warning
    assert _messages(negf.thermoelectrics, carry(jm), [0.0], 0.02, n_energies=51) == \
        _messages(jnegf.thermoelectrics, jm, [0.0], 0.02, n_energies=51)


def test_errors_match_jax():
    g, rib = jzoo.graphene(), _ribbon()
    H00, _ = jnegf.lead_blocks(rib)
    bad = H00.copy()
    bad[0, 1] += 1.0
    Hd, leads, _ = jnegf.hall_bar(_qwz(), (2, 2))
    cases = [
        ("lead_blocks", (g,), {}),
        ("landauer_transmission", (g, [0.0]), {}),
        ("landauer_transmission", (rib, [0.0]), dict(device=np.eye(3))),
        ("landauer_transmission", (rib, [0.0]), dict(device=bad)),
        ("landauer_transmission", (rib, [0.0]), dict(device=[])),
        ("landauer_transmission", (rib, [0.0]), dict(spin_resolved=True)),
        ("mode_count", (g, [0.0]), {}),
        ("thermoelectrics", (rib, 0.0, 0.0), {}),
        ("multi_terminal", (Hd + np.triu(np.ones_like(Hd), 1), leads, [0.0]), {}),
        ("multi_terminal", (Hd, leads[:1], [0.0]), {}),
        ("multi_terminal", (Hd, [(leads[0][0], leads[0][1], leads[0][2][:, :3])] + leads[1:], [0.0]), {}),
        ("buttiker", (np.zeros((3, 2)), 0, 1), {}),
        ("buttiker", (np.zeros((3, 3)), 1, 1), {}),
        ("hall_bar", (rib, (4, 4)), {}),
        ("hall_bar", (_qwz(), (1, 4)), {}),
        ("hall_bar", (_qwz(), (4, 4)), dict(lead_width=5)),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(JPythtbError) as want:
            getattr(jnegf, name)(*args, **kwargs)
        pargs = tuple(carry(a) if isinstance(a, pythtb_tpu.tb_model) else a for a in args)
        with pytest.raises(PythtbError) as got:
            getattr(negf, name)(*pargs, **kwargs)
        assert str(got.value) == str(want.value)
