"""The port's Wannier90 reader and writer against pythtb_tpu.w90, on the
CPU in float64: the same files give the same cell, centres, H(R),
diagnostics, hopping tables and bands, to 1e-12."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

import pythtb_tpu
import pythtb_tpu_torch
from pythtb_tpu_torch.w90 import write_w90

from . import workloads
from .test_torch_ops import on_cpu  # noqa: F401  (autouse: the port on the CPU)
from .test_w90_synthetic import _synthetic_set, _write_tb, _write_w90

ATOL = 1e-12

FILESETS = {
    "silicon": (workloads.W90_DATA_DIR, "silicon", {"min_hopping_norm": 0.01}),
    "synth": (workloads.W90_SYNTH_DIR, "synth", {
        "zero_energy": 0.05, "min_hopping_norm": 0.02, "max_distance": 5.0,
        "ignorable_imaginary_part": 2e-5,
    }),
}


def _hops(m):
    return (np.array([complex(h[0]) for h in m._hoppings]),
            np.array([[h[1], h[2]] for h in m._hoppings]),
            np.array([np.asarray(h[3]) for h in m._hoppings]))


@pytest.mark.parametrize("name", sorted(FILESETS))
def test_w90_matches_jax(name):
    path, prefix, filters = FILESETS[name]
    jw, pw = pythtb_tpu.w90(path, prefix), pythtb_tpu_torch.w90(path, prefix)
    np.testing.assert_array_equal(pw.lat, jw.lat)
    np.testing.assert_array_equal(pw.red_cen, jw.red_cen)
    assert list(pw.ham_r) == list(jw.ham_r)
    for R in jw.ham_r:
        np.testing.assert_array_equal(pw.ham_r[R]["h"], jw.ham_r[R]["h"])
        assert pw.ham_r[R]["deg"] == jw.ham_r[R]["deg"]
    for a, b in zip(pw.dist_hop(), jw.dist_hop()):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(pw.shells(), jw.shells())
    kpts, ene = pw.w90_bands_consistency()
    np.testing.assert_array_equal(ene, jw.w90_bands_consistency()[1])
    for kw in ({}, filters):
        pm, jm = pw.model(**kw), jw.model(**kw)
        assert pm._assume_position_operator_diagonal is False
        for a, b in zip(_hops(pm), _hops(jm)):
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
        np.testing.assert_allclose(pm.solve_all(kpts[::7]), jm.solve_all(kpts[::7]), rtol=0, atol=ATOL)


def test_w90_model_guards_berry_quantities():
    path, prefix, _ = FILESETS["synth"]
    m = pythtb_tpu_torch.w90(path, prefix).model()
    wf = pythtb_tpu_torch.wf_array(m, [3, 3, 3])
    wf.solve_on_grid([0.0, 0.0, 0.0])
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        wf.berry_phase([0], 0)
    m.ignore_position_operator_offdiagonal()
    wf = pythtb_tpu_torch.wf_array(m, [3, 3, 3])
    wf.solve_on_grid([0.0, 0.0, 0.0])
    assert np.isfinite(wf.berry_phase([0], 0)).all()


def test_write_w90_round_trip(tmp_path):
    """A model exported by the port's writer reads back, through both
    packages' readers, to the same bands."""
    path, prefix, _ = FILESETS["synth"]
    m = pythtb_tpu_torch.w90(path, prefix).model()
    write_w90(m, str(tmp_path), "rt")
    k = np.random.default_rng(0).uniform(-0.5, 0.5, (6, 3))
    want = m.solve_all(k)
    for mod in (pythtb_tpu_torch, pythtb_tpu):
        with redirect_stdout(io.StringIO()):
            back = mod.w90(str(tmp_path), "rt").model()
        np.testing.assert_allclose(back.solve_all(k), want, rtol=0, atol=ATOL)
    with pytest.raises(pythtb_tpu_torch.PythtbError):
        write_w90(m.cut_piece(2, 0), str(tmp_path), "bad")


@pytest.mark.parametrize("fmt", ["ang", "bohr", "none", "tb"])
def test_synthetic_filesets_match_jax(tmp_path, fmt):
    """Unit conventions of the .win file, and Wannier90's _tb.dat (with
    its position matrices), read alike by both packages."""
    lat, centers, ham_r, degs = _synthetic_set(3)
    if fmt == "tb":
        _write_tb(str(tmp_path), "syn", lat, centers, ham_r, degs)
    else:
        _write_w90(str(tmp_path), "syn", lat, centers, ham_r, degs, fmt)
    jw, pw = pythtb_tpu.w90(str(tmp_path), "syn"), pythtb_tpu_torch.w90(str(tmp_path), "syn")
    np.testing.assert_array_equal(pw.lat, jw.lat)
    np.testing.assert_array_equal(pw.xyz_cen, jw.xyz_cen)
    assert (pw.pos_r is None) == (jw.pos_r is None) == (fmt != "tb")
    if fmt == "tb":
        for R in jw.pos_r:
            np.testing.assert_array_equal(pw.pos_r[R], jw.pos_r[R])
    k = np.random.default_rng(1).uniform(0.0, 1.0, (6, 3))
    kw = {"min_hopping_norm": 0.15, "max_distance": 2.5}
    np.testing.assert_allclose(pw.model(**kw).solve_all(k), jw.model(**kw).solve_all(k),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("fault", ["missing_minus_R", "truncated_tb"])
def test_malformed_filesets_are_refused_like_jax(tmp_path, fault):
    lat, centers, ham_r, degs = _synthetic_set(5)
    if fault == "missing_minus_R":
        ham_r = dict(ham_r)
        ham_r.pop((-1, 0, 0))
        _write_w90(str(tmp_path), "bad", lat, centers, ham_r, degs[:-1])
    else:
        _write_tb(str(tmp_path), "bad", lat, centers, ham_r, degs)
        path = tmp_path / "bad_tb.dat"
        lines = path.read_text().splitlines(keepends=True)
        path.write_text("".join(lines[: len(lines) // 2]))
    msgs = []
    for mod in (pythtb_tpu, pythtb_tpu_torch):
        with pytest.raises(mod.PythtbError) as err:
            mod.w90(str(tmp_path), "bad")
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
