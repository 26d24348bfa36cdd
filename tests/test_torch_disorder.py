"""The port's CPA and ensemble tools (``disorder``) against pythtb_tpu's,
on the CPU in float64, where kernel 13 and kernel 1 run their plain
versions: the self-energies, local Green's functions and DOS at 1e-10
relative to the largest entry, with the same iteration count and
convergence flag (binary alloys on all or some orbitals, spinful hosts,
the Lorentzian model), the realizations of ``ensemble_realization``
identical draw for draw, and the warnings and errors with the same
messages.
"""

import warnings

import numpy as np
import pytest

from pythtb_tpu import disorder as jdis
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, disorder

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10
OMEGAS = np.linspace(-5.0, 5.0, 24)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("case", ["kagome binary", "kagome binary on orbital 1", "kane_mele binary",
                                  "kagome lorentzian", "chain three species"])
def test_cpa_matches_jax(case):
    jm, nk, dis = {
        "kagome binary": (jzoo.kagome(t=-1.0), 8, ("binary", [0.3, 0.7], [1.2, -0.3])),
        "kagome binary on orbital 1": (jzoo.kagome(t=-1.0), 8, ("binary", [0.5, 0.5], [1.0, -1.0], [1])),
        "kane_mele binary": (jzoo.kane_mele(), (6, 5), ("binary", [0.2, 0.8], [0.9, -0.2])),
        "kagome lorentzian": (jzoo.kagome(t=-1.0), 8, ("lorentzian", 0.3)),
        "chain three species": (jzoo.chain(), 64, ("binary", [0.2, 0.3, 0.5], [1.5, 0.0, -0.7])),
    }[case]
    got = disorder.cpa(carry(jm), OMEGAS, nk, dis, eta=0.05)
    want = jdis.cpa(jm, OMEGAS, nk, dis, eta=0.05)
    assert got["iters"] == want["iters"] and got["converged"] == want["converged"] is True
    for key in ("sigma", "gloc", "dos", "omegas"):
        _close(got[key], want[key])
    _close(disorder.cpa_dos(carry(jm), OMEGAS, nk, dis, eta=0.05), want["dos"])


def test_ensemble_realization_matches_jax():
    for jm, dis in ((jzoo.kagome(t=-1.0).cut_piece(3, 0).cut_piece(3, 1), ("binary", [0.3, 0.7], [1.2, -0.3])),
                    (jzoo.chain().cut_piece(12, 0), ("lorentzian", 0.4, [0, 3, 5])),
                    (jzoo.kane_mele().cut_piece(2, 0).cut_piece(2, 1), ("binary", [0.5, 0.5], [1.0, -1.0]))):
        for seed in (0, 7):
            got = disorder.ensemble_realization(carry(jm), dis, seed=seed)
            want = jdis.ensemble_realization(jm, dis, seed=seed)
            assert np.array_equal(np.asarray(got._site_energies), np.asarray(want._site_energies))


def _messages(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in rec]


def test_warnings_and_errors_match_jax():
    kg = jzoo.kagome(t=-1.0)
    kw = dict(eta=0.05, max_iters=3)
    got, gmsg = _messages(disorder.cpa, carry(kg), OMEGAS, 6, ("binary", [0.3, 0.7], [1.2, -0.3]), **kw)
    want, wmsg = _messages(jdis.cpa, kg, OMEGAS, 6, ("binary", [0.3, 0.7], [1.2, -0.3]), **kw)
    assert gmsg == wmsg and len(gmsg) == 1 and got["iters"] == want["iters"] == 3 and not got["converged"]
    _close(got["sigma"], want["sigma"])
    cases = [
        ("cpa", (kg.cut_piece(3, 0).cut_piece(3, 1), OMEGAS, 4, ("binary", [1.0], [0.0])), {}),
        ("cpa", (kg, OMEGAS, 4, ("binary", [0.5, 0.6], [0.0, 1.0])), {}),
        ("cpa", (kg, OMEGAS, 4, ("binary", [0.5], [0.0, 1.0])), {}),
        ("cpa", (kg, OMEGAS, 4, ("lorentzian", -0.1)), {}),
        ("cpa", (kg, OMEGAS, 4, ("gaussian", 0.1)), {}),
        ("ensemble_realization", (kg, ("binary", [1.0], [0.0])), {}),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(JPythtbError) as want:
            getattr(jdis, name)(*args, **kwargs)
        with pytest.raises(PythtbError) as got:
            getattr(disorder, name)(carry(args[0]), *args[1:], **kwargs)
        assert str(got.value) == str(want.value)
