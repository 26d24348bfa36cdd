"""The port's optical responses (``optical_conductivity``,
``shift_current``, ``injection_current``, ``joint_dos``) against
pythtb_tpu's, on the CPU in float64, where kernels 15 and 16 run their
plain versions: 1e-10 relative to the largest entry, plus the error
messages.
"""

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import optical as joptical
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, optical

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10
OMEGAS = np.linspace(0.0, 6.0, 13)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _rice_mele():
    m = pythtb_tpu.tb_model(1, 1, lat=[[1.0]], orb=[[0.0], [0.5]])
    m.set_onsite([0.4, -0.4])
    m.set_hop(1.3, 0, 1, [0])
    m.set_hop(0.7, 1, 0, [1])
    return m


@pytest.mark.parametrize("case", ["insulator occ", "metal fermi T>0 (Drude)", "cubic 3-D occ"])
def test_optical_conductivity_matches_jax(case):
    jm, kwargs = {
        "insulator occ": (jzoo.haldane(), dict(occ=[0], nk=(15, 15), eta=0.1)),
        "metal fermi T>0 (Drude)": (jzoo.haldane(), dict(fermi=0.9, temperature=0.2, nk=(15, 15), eta=0.1)),
        "cubic 3-D occ": (jzoo.cscl(), dict(occ=[0], nk=(5, 5, 5), eta=0.1)),
    }[case]
    _close(optical.optical_conductivity(carry(jm), OMEGAS, **kwargs),
           joptical.optical_conductivity(jm, OMEGAS, **kwargs))


@pytest.mark.parametrize("case", ["bn 2-D", "rice_mele 1-D", "kane_mele nspin 2"])
def test_shift_current_matches_jax(case):
    jm, occ, nk = {
        "bn 2-D": (jzoo.bn(), [0], (15, 15)),
        "rice_mele 1-D": (_rice_mele(), [0], (41,)),
        "kane_mele nspin 2": (jzoo.kane_mele(rashba=0.3), [0, 1], (9, 9)),
    }[case]
    w = np.linspace(0.5, 4.0, 15)
    _close(optical.shift_current(carry(jm), w, occ, nk=nk, sigma=0.1),
           joptical.shift_current(jm, w, occ, nk=nk, sigma=0.1))


def _skewed_haldane():
    """Haldane with an extra complex second-neighbour hop on one sublattice
    and a stronger bond: no symmetry left to cancel the injection current."""
    m = jzoo.haldane()
    m.set_hop(0.3j, 0, 0, [1, 0], mode="add")
    m.set_hop(0.2, 0, 1, [0, 0], mode="add")
    return m


def test_injection_current_and_joint_dos_match_jax():
    jm = _skewed_haldane()
    w = np.linspace(0.5, 5.0, 15)
    _close(optical.injection_current(carry(jm), w, [0], nk=(15, 15), sigma=0.1),
           joptical.injection_current(jm, w, [0], nk=(15, 15), sigma=0.1))
    for m, nk in ((jm, (15, 15)), (_rice_mele(), (41,))):
        _close(optical.joint_dos(carry(m), w, [0], nk=nk, sigma=0.1), joptical.joint_dos(m, w, [0], nk=nk, sigma=0.1))


def test_optical_errors_match_jax():
    hal = carry(jzoo.haldane())
    cases = [
        (optical.optical_conductivity, (carry(jzoo.ssh()), OMEGAS), dict(occ=[0]), "fully periodic 2-D or 3-D"),
        (optical.optical_conductivity, (hal, OMEGAS), {}, "exactly one of occ / fermi"),
        (optical.optical_conductivity, (hal, OMEGAS), dict(occ=[0], nk=(5,)), "one grid size per k-direction"),
        (optical.optical_conductivity, (hal, OMEGAS), dict(occ=[0, 0]), "distinct state indices"),
        (optical.shift_current, (hal, OMEGAS, [0, 1]), {}, "no interband transitions"),
        (optical.shift_current, (hal, OMEGAS, [2]), {}, "distinct state indices"),
        (optical.injection_current, (hal, OMEGAS, [0]), dict(nk=(3, 3, 3)), "one grid size per k-direction"),
        (optical.joint_dos, (carry(jzoo.molecule_nh3()), OMEGAS, [0]), {}, "requires a periodic model"),
        (optical.spectral_sum, (None, None, None, 0.1, "cauchy"), {}, "mode must be"),
    ]
    for fn, args, kwargs, msg in cases:
        with pytest.raises((PythtbError, ValueError), match=msg):
            fn(*args, **kwargs)
