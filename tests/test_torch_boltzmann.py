"""The port's Boltzmann transport (``transport_coefficients``,
``transport_distribution``, ``edelstein``) against pythtb_tpu's, on the
CPU in float64, where kernels 15 and 17 run their plain versions: every
returned array to 1e-10 relative to its largest entry (NaN where JAX has
NaN), plus the errors with the same messages.
"""

import warnings

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import boltzmann as jboltzmann
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, boltzmann

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    if ok.any():
        assert np.abs(got - want)[ok].max() <= rel * np.abs(want[ok]).max()


def _rashba():
    """The square-lattice Rashba model of the Edelstein bench row."""
    sy = np.array([[0, -1j], [1j, 0]]) / 2
    sx = np.array([[0, 1], [1, 0]], dtype=complex) / 2
    m = pythtb_tpu.tb_model(2, 2, np.eye(2), [[0.0, 0.0]], nspin=2)
    m.set_hop(-1.0 * np.eye(2) - 1j * 0.6 * sy, 0, 0, [1, 0])
    m.set_hop(-1.0 * np.eye(2) + 1j * 0.6 * sx, 0, 0, [0, 1])
    return m


@pytest.mark.parametrize("case", ["haldane 2-D with gapped mu", "chain 1-D", "cscl 3-D"])
def test_transport_coefficients_match_jax(case):
    jm, mus, nk = {
        "haldane 2-D with gapped mu": (jzoo.haldane(), np.array([-7.0, -2.0, -0.9, 0.0, 1.5]), 16),
        "chain 1-D": (jzoo.chain(), np.array([-1.0, 0.3]), 64),
        "cscl 3-D": (jzoo.cscl(), np.array([-0.8, 0.5]), (5, 4, 6)),
    }[case]
    got, got_warned = _run(boltzmann.transport_coefficients, carry(jm), mus, 0.1, nk, tau=2.0)
    want, want_warned = _run(jboltzmann.transport_coefficients, jm, mus, 0.1, nk, tau=2.0)
    assert got_warned == want_warned and bool(got_warned) == ("gapped" in case)
    assert sorted(got) == sorted(want)
    # the ratios (Seebeck, kappa_e, Lorenz, R_H) divide by L0 (R_H by its
    # square), so where trace L0 is small they amplify the rounding of the
    # sums, and the port's stable -df/de rounds otherwise than the
    # reference's f (1 - f) / kT (mid-gap in the Haldane case, trace L0 6e-4
    # of its peak, where R_H and the Seebeck tensor are 0 up to that
    # rounding): they are held where trace L0 >= 1e-2 of its peak
    tr = np.trace(want["sigma"], axis1=1, axis2=2)
    cond = tr >= 1e-2 * tr.max()
    for key in want:
        ratio = key in ("seebeck", "kappa_e", "lorenz", "hall_coefficient")
        _close(got[key][cond] if ratio else got[key], want[key][cond] if ratio else want[key])


def _run(fn, *args, **kwargs):
    """fn's result and the messages of the warnings it raised."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in rec]


def test_transport_distribution_and_edelstein_match_jax():
    jm = jzoo.haldane()
    energies = np.linspace(-3.5, 3.5, 15)
    _close(boltzmann.transport_distribution(carry(jm), energies, 16, smearing=0.2),
           jboltzmann.transport_distribution(jm, energies, 16, smearing=0.2))
    # Kramers pairs at the TRIMs (E = -4, 0, 4) make <n|s|n> v_n basis-
    # dependent there; these mu keep them 1.5 (30 kT) outside the window
    jr = _rashba()
    mus = np.array([-2.5, -2.0, -1.5, 1.5, 2.0, 2.5])
    _close(boltzmann.edelstein(carry(jr), mus, 0.05, 16, tau=1.5), jboltzmann.edelstein(jr, mus, 0.05, 16, tau=1.5))


def test_transport_errors_match_jax():
    hal, rashba = jzoo.haldane(), _rashba()
    slab = jzoo.haldane().cut_piece(3, 1)
    cases = [
        ("transport_coefficients", (hal, [0.0], 0.1, (4,)), {}),
        ("transport_coefficients", (hal, [0.0], 0.0, 8), {}),
        ("transport_coefficients", (slab, [0.0], 0.1, 8), {}),
        ("transport_coefficients", (hal, [0.0], 0.1, 1), {}),
        ("transport_distribution", (hal, [0.0], 8), dict(smearing=0.0)),
        ("transport_distribution", (hal, [0.0], (8, 8, 8)), {}),
        ("edelstein", (hal, [0.0], 0.1, 8), {}),
        ("edelstein", (rashba, [0.0], -0.1, 8), {}),
        ("edelstein", (rashba, [0.0], 0.1, (8,)), {}),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(JPythtbError) as want:
            getattr(jboltzmann, name)(*args, **kwargs)
        with pytest.raises(PythtbError) as got:
            getattr(boltzmann, name)(carry(args[0]), *args[1:], **kwargs)
        assert str(got.value) == str(want.value)


def _square2(tx=-1.0, ty=-1.0):
    m = pythtb_tpu.tb_model(2, 2, np.eye(2).tolist(), [[0.0, 0.0]])
    m.set_hop(tx, 0, 0, [1, 0])
    m.set_hop(ty, 0, 0, [0, 1])
    return m


def _min_segment_x(model, ef, nk, Bs, tau):
    """The smallest x = dt / tau over the orbits that magnetotransport
    integrates (the repaired branch is x < 1e-4)."""
    from pythtb_tpu_torch import fermisurface

    xs = []
    for b, lines in fermisurface.fermi_surface(model, ef, nk=nk).items():
        for pts, _ in lines:
            v = np.linalg.norm(fermisurface.fermi_velocity(model, pts % 1.0, bands=[b])[:, :, 0], axis=1)
            dl = np.linalg.norm(np.diff(pts @ (2 * np.pi * np.eye(2)), axis=0), axis=1)
            dl = dl[dl > 1e-10]
            xs.append((dl / v[: len(dl)]).min() / (np.abs(Bs).max() * tau))
    return min(xs)


@pytest.mark.parametrize("case", ["closed pocket", "open sheets", "hole pocket, both field signs"])
def test_magnetotransport_matches_jax(case):
    """sigma(B) on the models of tests/test_magnetotransport.py, at 1e-10
    relative, where every segment has x = dt / tau > 1e-4 (away from the
    branch the port repairs)."""
    jm, ef, Bs, tau, nk = {
        "closed pocket": (_square2(), -3.6, np.array([0.02, 0.1, 0.3, 1.0]) / 7.0, 7.0, 61),
        "open sheets": (_square2(ty=-0.05), 0.0, np.array([0.01, 8.0]), 4.0, 41),
        "hole pocket, both field signs": (_square2(), 3.3, np.array([-0.4, 0.05, 0.4]), 2.0, 51),
    }[case]
    m = carry(jm)
    assert _min_segment_x(m, ef, nk, Bs, tau) > 1e-4
    got = boltzmann.magnetotransport(m, ef, Bs, tau=tau, nk=nk)
    want = jboltzmann.magnetotransport(jm, ef, Bs, tau=tau, nk=nk)
    assert got["orbits"] == want["orbits"] and got["tau"] == want["tau"]
    np.testing.assert_array_equal(got["Bs"], want["Bs"])
    _close(got["sigma"], want["sigma"])


def test_magnetotransport_errors_and_warnings_match_jax():
    jm = _square2()
    for args, kwargs in (((jm, -3.6, [0.0]), {}), ((jm, -3.6, [0.5]), dict(tau=0.0)),
                         ((jzoo.chain(), 0.0, [0.5]), {})):
        with pytest.raises(JPythtbError) as want:
            jboltzmann.magnetotransport(*args, **kwargs)
        with pytest.raises(PythtbError) as got:
            boltzmann.magnetotransport(carry(args[0]), *args[1:], **kwargs)
        assert str(got.value) == str(want.value)
    got, got_w = _run(boltzmann.magnetotransport, carry(jm), -9.0, [0.5], nk=21)
    want, want_w = _run(jboltzmann.magnetotransport, jm, -9.0, [0.5], nk=21)
    assert got_w == want_w and got_w
    np.testing.assert_array_equal(got["sigma"], want["sigma"])
