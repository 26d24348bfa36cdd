"""The port's impurity embedding (``impurity``) against pythtb_tpu's, on
the CPU in float64, where kernels 1, 2 and kernel 16's Lorentzian mode
run their plain versions: G0, the embedded G and T at 1e-10 relative to
the largest entry (spinless and spinful hosts, clusters over several
cells), bound-state energies at 1e-10, and the errors with the same
messages.
"""

import numpy as np
import pytest

from pythtb_tpu import impurity as jimp
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, impurity

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10
ENERGIES = np.linspace(-3.6, 3.6, 41)


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("case", ["bn three-site cluster", "kane_mele spinful"])
def test_greens_function_and_t_matrix_match_jax(case):
    jm, cluster, V, nk = {
        "bn three-site cluster": (jzoo.bn(delta=1.0), [0, ([1, 0], 1), ([0, 1], 0)],
                                  np.diag([4.0, 0.0, -2.0]), (24, 24)),
        "kane_mele spinful": (jzoo.kane_mele(), [0, ([0, 1], 1)],
                              np.diag([1.5, 1.5, 0.0, 0.0]) + 0.3 * np.eye(4, k=1) + 0.3 * np.eye(4, k=-1),
                              (12, 12)),
    }[case]
    pm = carry(jm)
    G0 = impurity.host_greens_function(pm, ENERGIES, cluster, nk=nk, eta=0.04)
    _close(G0, jimp.host_greens_function(jm, ENERGIES, cluster, nk=nk, eta=0.04))
    G, T = impurity.t_matrix(pm, V, ENERGIES, cluster, nk=nk, eta=0.04)
    JG, JT = jimp.t_matrix(jm, V, ENERGIES, cluster, nk=nk, eta=0.04)
    _close(G, JG)
    _close(T, JT)


def test_bound_states_match_jax():
    """Gapped BN (gap +-1.008): one level for a single-site U, the pair of a
    two-site cluster, and the singular-V branch."""
    jm = jzoo.bn(delta=1.0)
    pm = carry(jm)
    for V, cluster in ((np.array([[4.0]]), [0]),
                       (np.diag([3.0, -2.5]), [0, ([1, 0], 1)]),
                       (np.diag([3.0, 0.0]), [0, 1])):
        got = impurity.bound_states(pm, V, cluster, (-0.99, 0.99), nk=(24, 24))
        want = jimp.bound_states(jm, V, cluster, (-0.99, 0.99), nk=(24, 24))
        assert got.shape == want.shape and got.size >= 1
        assert np.abs(got - want).max() <= REL


def test_errors_match_jax():
    bn = jzoo.bn()
    cases = [
        ("host_greens_function", (bn.cut_piece(3, 0).cut_piece(3, 1), [0.0], [0]), {}),
        ("host_greens_function", (bn, [0.0], [0]), dict(nk=(8,))),
        ("host_greens_function", (bn, [0.0], [5]), dict(nk=(8, 8))),
        ("host_greens_function", (bn, [0.0], [([1, 0, 0], 0)]), dict(nk=(8, 8))),
        ("host_greens_function", (bn.cut_piece(3, 1), [0.0], [([0, 1], 0)]), dict(nk=(8,))),
        ("t_matrix", (bn, np.eye(2), [0.0], [0]), dict(nk=(8, 8))),
        ("t_matrix", (bn, np.array([[1.0, 1.0], [0.0, 1.0]]), [0.0], [0, 1]), dict(nk=(8, 8))),
        ("bound_states", (bn, np.eye(1), [0], (0.5, -0.5)), dict(nk=(8, 8))),
        ("bound_states", (bn, np.eye(2), [0], (-0.5, 0.5)), dict(nk=(8, 8))),
        ("bound_states", (bn, np.array([[1.0, 1.0], [0.0, 1.0]]), [0, 1], (-0.5, 0.5)), dict(nk=(8, 8))),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(JPythtbError) as want:
            getattr(jimp, name)(*args, **kwargs)
        with pytest.raises(PythtbError) as got:
            getattr(impurity, name)(carry(args[0]), *args[1:], **kwargs)
        assert str(got.value) == str(want.value)
