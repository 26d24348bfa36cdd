"""The port's host API (``tb_model.display``, ``hamiltonian_string``,
``visualize``, ``save``/``load`` and ``wf_array.save``/``load``) against
pythtb_tpu's, on the CPU.

Text reports and Hamiltonian strings are identical to pythtb_tpu's; the
figures carry the same artists (tests/test_viz_output.py's comparison);
``.npz`` files written by either package load in the other with equal
models (spectra within 1e-12) and states and energies bit for bit.
"""

import io
from contextlib import redirect_stdout

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

import pythtb_tpu as ptt  # noqa: E402
from pythtb_tpu.models import library as jzoo  # noqa: E402
from pythtb_tpu_torch import models, tb_model, wf_array  # noqa: E402

from .test_ham_string import _eval_hs  # noqa: E402
from .test_torch_ops import carry, on_cpu  # noqa: E402, F401  (autouse: the port on the CPU)
from .test_viz_output import _assert_same_figure  # noqa: E402

MODELS = {
    "haldane": (jzoo.haldane, [0.13, -0.27]),
    "graphene": (lambda: jzoo.graphene(delta=0.3), [0.41, 0.09]),
    "kane_mele": (jzoo.kane_mele, [0.21, 0.37]),
    "trestle": (jzoo.trestle, [0.3]),
    "cscl": (jzoo.cscl, [0.1, 0.2, 0.3]),
    "molecule": (jzoo.molecule_nh3, None),
}


def _text(fn):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn()
    return buf.getvalue()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_display_and_hamiltonian_string_identical(name):
    """display() prints, and hamiltonian_string() returns, the same text
    as pythtb_tpu's; the string evaluates back to gen_ham."""
    jm = MODELS[name][0]()
    m = carry(jm)
    assert _text(m.display) == _text(jm.display)
    for prec in (4, 15):
        assert m.hamiltonian_string(precision=prec) == jm.hamiltonian_string(precision=prec)
    k = MODELS[name][1]
    want = np.asarray(m.gen_ham() if k is None else m.gen_ham([k])[0]).reshape(m._nsta, m._nsta)
    np.testing.assert_allclose(_eval_hs(m, k), want, atol=1e-10)


@pytest.mark.parametrize("case", ["bulk", "ribbon", "eig_wheel", "nohop", "chain"])
def test_visualize_matches_jax_figure(case):
    """The port's figure carries pythtb_tpu's artists (positions,
    polylines, eigenstate markers, limits)."""
    jm = jzoo.graphene()
    if case == "ribbon":
        jm = jm.cut_piece(3, 0, glue_edgs=False)
    if case == "chain":
        jm = ptt.tb_model(1, 1, [[1.0]], [[0.0], [0.5]])
        jm.set_hop(1.0, 0, 1, [0])
        jm.set_hop(0.4, 1, 0, [1])
    m = carry(jm)
    kw = {}
    if case == "eig_wheel":
        kw = dict(eig_dr=jm.solve_one([0.1, 0.2], eig_vectors=True)[1][0], ph_color="wheel")
    if case == "nohop":
        kw = dict(draw_hoppings=False)
    args = (0,) if case == "chain" else (0, 1)
    fig_j, _ = jm.visualize(*args, **kw)
    fig_t, _ = m.visualize(*args, **kw)
    try:
        _assert_same_figure(fig_j, fig_t, case.startswith("eig"))
    finally:
        plt.close(fig_j)
        plt.close(fig_t)


def test_visualize_labels_and_errors():
    m = models.haldane()
    fig, ax = m.visualize(0, 1, annotate_hoppings=True)
    texts = [t.get_text() for t in ax.texts]
    assert len(texts) == len(m._hoppings) and "-1" in texts and "0.15j" in texts
    plt.close(fig)
    with pytest.raises(Exception):
        m.visualize(0)
    with pytest.raises(Exception):
        m.visualize(0, 1, ph_color="rainbow")


def _same_model(a, b, k):
    assert a._dim_k == b._dim_k and a._nspin == b._nspin and a._per == b._per
    np.testing.assert_array_equal(a._orb, b._orb)
    assert a._assume_position_operator_diagonal == b._assume_position_operator_diagonal
    if k is None:
        np.testing.assert_allclose(a.solve_all(), b.solve_all(), atol=1e-12)
    else:
        np.testing.assert_allclose(a.solve_all([k]), b.solve_all([k]), atol=1e-12)


@pytest.mark.parametrize("name", ["haldane", "kane_mele", "molecule"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_model_files_cross_load(tmp_path, name, writer):
    """A model saved by either package loads in both, with equal spectra."""
    jm = MODELS[name][0]()
    jm._assume_position_operator_diagonal = name != "haldane"
    m = carry(jm)
    m._assume_position_operator_diagonal = jm._assume_position_operator_diagonal
    path = str(tmp_path / "m")
    (m if writer == "port" else jm).save(path)
    k = MODELS[name][1]
    _same_model(tb_model.load(path), jm, k)
    _same_model(ptt.tb_model.load(path), jm, k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wf_array_files_cross_load(tmp_path, writer):
    """A solved wf_array (with energies) or a state subset saved by either
    package loads in both: states and energies bit for bit."""
    jw = ptt.wf_array(jzoo.kane_mele(), [5, 4])
    jw.solve_on_grid([0.0, 0.0])
    sub = jw.choose_states([0, 1])
    for src in (jw, sub):
        st, en = np.array(src._wfs), np.array(src.energies)
        if writer == "port":
            from pythtb_tpu_torch import convert

            w = convert.wf_array_from_numpy(carry(jzoo.kane_mele()), st, en)
        else:
            w = src
        path = str(tmp_path / ("w%d" % src._nsta_arr))
        w.save(path)
        for back in (wf_array.load(path), ptt.wf_array.load(path)):
            np.testing.assert_array_equal(np.asarray(back._wfs), st)
            np.testing.assert_array_equal(back.energies, en)
    with pytest.raises(ValueError, match="wf_array"):
        tb_model.load(path)
    carry(jzoo.haldane()).save(str(tmp_path / "model"))
    with pytest.raises(ValueError, match="wf_array"):
        wf_array.load(str(tmp_path / "model"))
