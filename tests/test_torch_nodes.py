"""The port's node finder and node charges (``flows.find_nodes``,
``flows.node_chirality``) against pythtb_tpu's, on the CPU in float64,
where kernels 1, 2, 15 and 3-4 run their plain versions.

The gap scan and the Hellmann-Feynman descent are the JAX package's step
for step.  Near a node the gap is a cone, so the normalized gradient
flips at its tip and rounding picks the last steps' directions: the
refined points of the two packages agree to the descent's resolution,
not to rounding (graphene: 7e-7 and 6e-8 from the Dirac point).  So the
node sets are matched nearest to nearest and held to 5e-6 in reduced
coordinates, gaps and energies to 5e-6, the counts and the charges
exactly.  Cases follow tests/test_find_nodes.py.
"""

import warnings

import numpy as np
import pytest

from pythtb_tpu import flows as jflows
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import flows

from .test_find_nodes import _graphene, _min_image
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)


@pytest.mark.parametrize("case,nk", [("graphene", 17), ("gapped graphene", 12), ("weyl", 12),
                                     ("ssh critical", 16), ("ssh gapped", 16)])
def test_find_nodes_matches_jax(case, nk):
    jm = {"graphene": _graphene(), "gapped graphene": _graphene(delta=0.3), "weyl": jzoo.weyl(),
          "ssh critical": jzoo.ssh(delta=0.0), "ssh gapped": jzoo.ssh(delta=0.25)}[case]
    k, g, e = flows.find_nodes(carry(jm), band=0, nk=nk, gap_tol=1e-4, return_energies=True)
    jk, jg, je = jflows.find_nodes(jm, band=0, nk=nk, gap_tol=1e-4, return_energies=True)
    assert k.shape == jk.shape and g.shape == jg.shape == e.shape
    for i, a in enumerate(k):
        j = int(np.argmin([_min_image(a, b) for b in jk]))
        assert _min_image(a, jk[j]) <= 5e-6
        assert abs(g[i] - jg[j]) <= 5e-6 and abs(e[i] - je[j]) <= 5e-6
    if case == "graphene":
        targets = [[1.0 / 3.0, 2.0 / 3.0], [2.0 / 3.0, 1.0 / 3.0]]
        assert sorted(min(_min_image(x, t) for t in targets) for x in k)[-1] < 2e-6
    if case == "weyl":
        assert k.shape == (2, 3)


def test_node_chirality_matches_jax_and_gauss_law():
    jm = jzoo.weyl()
    pm = carry(jm)
    k, _ = flows.find_nodes(pm, band=0, nk=12, gap_tol=1e-4)
    chis = [flows.node_chirality(pm, x, band=0) for x in k]
    assert chis == [jflows.node_chirality(jm, x, band=0) for x in k]
    assert sorted(chis) == [-1, 1]
    assert flows.node_chirality(pm, [0.0, 0.0, 0.25], band=0) == -1
    assert flows.node_chirality(pm, [0.0, 0.0, 0.75], band=0, nf=8) == 1


def test_node_guards_and_warnings():
    pm = carry(jzoo.weyl())
    with pytest.warns(UserWarning):
        flows.node_chirality(pm, [0.0, 0.0, 0.25], band=0, radius=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        flows.node_chirality(pm, [0.0, 0.0, 0.25], band=0)
    with pytest.raises(ValueError, match="3-D"):
        flows.node_chirality(carry(_graphene()), [1.0 / 3.0, 2.0 / 3.0], band=0)
    with pytest.raises(ValueError, match="band"):
        flows.find_nodes(carry(_graphene()), band=5)
    with pytest.raises(ValueError, match="nk"):
        flows.find_nodes(carry(_graphene()), nk=2)
