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
