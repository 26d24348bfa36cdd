"""The port's quantum-geometry family (``quantum_geometric_tensor`` with
``occ`` and ``bands``, ``quantum_metric``, ``berry_curvature``,
``integrated_metric``, ``drude_weight``) against pythtb_tpu's, on the
CPU in float64, where kernels 15 and 17 run their plain versions: 1e-10
relative to the largest entry, the warnings and the errors.  The QGT of
an occupied group is gauge invariant; the per-band QGT is compared on
models whose bands do not touch.
"""

import numpy as np
import pytest

from pythtb_tpu import geometry as jgeometry
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, geometry

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("case", ["haldane occ", "kane_mele occ pair", "cscl 3-D bands", "haldane bands list"])
def test_qgt_metric_curvature_match_jax(case):
    jm, kwargs = {
        "haldane occ": (jzoo.haldane(), dict(occ=[0])),
        "kane_mele occ pair": (jzoo.kane_mele(rashba=0.1), dict(occ=[0, 1])),
        "cscl 3-D bands": (jzoo.cscl(), dict(bands="all")),
        "haldane bands list": (jzoo.haldane(), dict(bands=[1])),
    }[case]
    k = np.random.default_rng(7).uniform(-0.5, 0.5, (6, jm._dim_k))
    tm = carry(jm)
    for fn in ("quantum_geometric_tensor", "quantum_metric", "berry_curvature"):
        _close(getattr(geometry, fn)(tm, k, **kwargs), getattr(jgeometry, fn)(jm, k, **kwargs))


def test_integrated_metric_and_drude_weight_match_jax():
    jm = jzoo.haldane()
    got = geometry.integrated_metric(carry(jm), [0], nk=(12, 12))
    want = jgeometry.integrated_metric(jm, [0], nk=(12, 12))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])
    for jm, mu, nk in ((jzoo.square(t=-1.0), -1.1, (16, 16)), (jzoo.haldane(), 1.2, (12, 12)),
                       (jzoo.kane_mele(rashba=0.1), 1.4, (8, 8))):
        _close(geometry.drude_weight(carry(jm), mu, nk=nk, temperature=0.05),
               jgeometry.drude_weight(jm, mu, nk=nk, temperature=0.05))


def test_geometry_warnings_and_errors_match_jax():
    g = jzoo.graphene()
    with pytest.warns(UserWarning, match="within .* of degeneracy"):
        geometry.quantum_geometric_tensor(carry(g), [[1 / 3, 2 / 3]], occ=[0])
    with pytest.warns(UserWarning, match="Omega_I diverges"):
        geometry.integrated_metric(carry(g), [0], nk=(6, 6))
    hal = jzoo.haldane()
    cases = [
        ("quantum_geometric_tensor", (hal, [[0.0, 0.0]]), {}),
        ("quantum_geometric_tensor", (hal, [[0.0, 0.0]]), dict(occ=[0], bands="all")),
        ("quantum_geometric_tensor", (hal, [0.0, 0.0]), dict(occ=[0])),
        ("quantum_geometric_tensor", (hal, [[0.0, 0.0]]), dict(occ=[0, 1])),
        ("quantum_geometric_tensor", (hal, [[0.0, 0.0]]), dict(occ=[2])),
        ("quantum_geometric_tensor", (hal, [[0.0, 0.0]]), dict(bands="some")),
        ("quantum_geometric_tensor", (hal, [[0.0, 0.0]]), dict(bands=[3])),
        ("integrated_metric", (hal, [0]), dict(nk=(1, 4))),
        ("integrated_metric", (jzoo.haldane().cut_piece(3, 0), [0]), {}),
        ("drude_weight", (hal, 0.0), dict(nk=(4,))),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(JPythtbError) as want:
            getattr(jgeometry, name)(*args, **kwargs)
        with pytest.raises(PythtbError) as got:
            getattr(geometry, name)(carry(args[0]), *args[1:], **kwargs)
        assert str(got.value) == str(want.value)
