"""Faults of the port repaired against the reference, each with its own
check (on the CPU, float64):

* the ``mesh=`` argument of the JAX package's public calls is accepted as
  None (same answer as without it) and refused otherwise;
* the plain -df/de of the Boltzmann sums is the stable form: off the
  bands the sums agree with an ``np.longdouble`` evaluation to 1e-12
  relative (the reference's f (1 - f) / kT does not, so it is not the
  oracle there);
* the Edelstein sum does not depend on the basis chosen inside a Kramers
  pair: rotating the pair by a random 2 x 2 unitary leaves it unchanged to
  1e-12;
* the assembly module's docstring no longer calls kernel 15 unported;
* the Chambers integrator of ``boltzmann.magnetotransport``: its segment
  weight C = tau (1 - (1 - e^{-x}) / x) and one orbit's tensor meet an
  ``np.longdouble`` evaluation to 1e-14 relative for x = dt / tau in
  1e-9 - 1 (the reference's closed form loses eps / x), and meet the
  JAX package's integrator at 1e-10 where x > 1e-4;
* the public names: an ``ast`` diff of every ``pythtb_tpu/**/*.py``
  (top-level public names and ``__all__``) against ``pythtb_tpu_torch/``
  finds only the gaps listed in ``ALLOWED_GAPS``, each with its reason,
  and every listed gap is still open; ``PYTHTB_COMPAT_VERSION`` and
  ``ops.berry.berry_evals_device`` are there.
"""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import boltzmann, flows
from pythtb_tpu_torch.ops import hamiltonian, solver
from pythtb_tpu_torch.optical import _velocity_tensors

from .test_torch_boltzmann import _rashba
from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

ROOT = Path(__file__).resolve().parent.parent


def test_assembly_docstring_is_current():
    assert "not ported" not in hamiltonian.__doc__
    assert "kernel 15" in hamiltonian.__doc__


def _public_args(pkg):
    """{(module, function): argument names} of a package's public functions."""
    out = {}
    for path in (ROOT / pkg).rglob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
                out[(str(path.relative_to(ROOT / pkg)), node.name)] = [
                    a.arg for a in node.args.args + node.args.kwonlyargs]
    return out


def test_every_public_mesh_argument_is_kept():
    jax_args, port_args = _public_args("pythtb_tpu"), _public_args("pythtb_tpu_torch")
    shared = [k for k in jax_args if k in port_args and "mesh" in jax_args[k]]
    assert len(shared) >= 5
    assert [k for k in shared if "mesh" not in port_args[k]] == []


def test_mesh_none_gives_the_same_answer_and_a_mesh_raises():
    m = carry(jzoo.haldane())
    data = m._get_finalized()
    kl = np.array([[0.1, 0.2], [0.3, -0.4]])
    same = [
        (lambda **kw: flows.chern_number(m, [0], nk=(9, 9), **kw)),
        (lambda **kw: flows.berry_flux_grid(m, [0], nk=(9, 9), **kw)),
        (lambda **kw: solver.hamiltonian_kpts(data, kl, **kw)),
        (lambda **kw: solver.solve_kpts(data, kl, True, **kw)[1]),
        (lambda **kw: solver.solve_grid_device(data, (5, 5), (0.0, 0.0), m._orb, m._per, 1, **kw)[2]),
    ]
    for fn in same:
        a, b = np.asarray(fn()), np.asarray(fn(mesh=None))
        assert np.array_equal(a, b)
        with pytest.raises(NotImplementedError, match="queue 1 item 10"):
            fn(mesh=object())


def _longdouble_sums(E, G, jpow, mus, kt):
    """The Boltzmann sums sum_t G[p, t] (-df/de)(E_t - mu) (E_t - mu)^j_p in
    np.longdouble, -df/de in its stable form, and the same sums of the
    terms' absolute values (the scale a float64 sum is accurate to)."""
    E = np.asarray(E, dtype=np.longdouble)
    G = np.asarray(G, dtype=np.longdouble)
    out = np.zeros((len(mus), G.shape[0]), dtype=np.longdouble)
    scale = np.zeros_like(out)
    for i, mu in enumerate(mus):
        d = E - np.longdouble(mu)
        e = np.exp(-np.abs(d / np.longdouble(kt)))
        w = e / ((1 + e) ** 2 * np.longdouble(kt))
        for p in range(G.shape[0]):
            terms = G[p] * w * d ** jpow[p]
            out[i, p] = np.sum(terms)
            scale[i, p] = np.sum(np.abs(terms))
    return out, scale


def test_off_band_boltzmann_sums_match_longdouble():
    """Haldane 24^2, kT 0.05: at the chemical potentials whose trace L0 is
    below 1e-4 of its peak (outside the bands and in the gap) every plain
    sum (L0, L1, L2, Hall) is within 1e-12 of the np.longdouble one,
    relative to the sum of its terms' absolute values; the reference's
    f (1 - f) / kT is not, outside the bands."""
    m = carry(jzoo.haldane())
    data = m._get_finalized()
    lat = np.asarray(m._lat, dtype=np.float64)
    kpts = solver.device_uniform_grid((24, 24), (0.0, 0.0), data.device)
    E, G, jpow, _ = boltzmann._bt_columns(data, kpts, lat)
    mus = np.linspace(-4.5, 4.5, 37)
    kt = 0.05
    got = boltzmann.fermi_sweep(E, G, torch.as_tensor(mus), kt, "dfde", jpow).numpy()
    want, scale = _longdouble_sums(E.numpy(), G.numpy(), jpow, mus, kt)
    tr = got[:, 0] + got[:, 3]  # trace of L0 (2 x 2, row-major)
    off = tr < 1e-4 * tr.max()
    assert off.sum() >= 8
    assert float((np.abs(got - want)[off] / scale[off]).max()) <= 1e-12
    # the reference's weight above the bands (x <= -30), where 1 - f cancels
    d = E - mus[-1]
    f = torch.sigmoid(-d / kt)
    old = (f * (1.0 - f) / kt * G[0]).sum().item()
    assert abs(old - float(want[-1, 0])) > 1e-6 * float(scale[-1, 0])


def test_edelstein_invariant_under_kramers_pair_rotation():
    """The Rashba model at its TRIMs (Kramers pairs at E -4, 0, 4): each
    pair's Edelstein factors summed over the pair are the same, to 1e-12,
    after the pair's states are rotated by a random 2 x 2 unitary; and the
    whole tensor of a grid through those points is unchanged."""
    m = carry(_rashba())
    data = m._get_finalized()
    lat = np.eye(2)
    kpts = torch.tensor([[0.0, 0.0], [0.5, 0.0], [0.0, 0.5], [0.5, 0.5], [0.1, 0.3]], dtype=torch.float64)
    evals, vecs, V, _ = _velocity_tensors(data, kpts, lat, need_d2=False)
    base = boltzmann._spin_velocity(evals, vecs, V)
    rng = np.random.default_rng(7)
    z = rng.normal(size=(4, 2, 2)) + 1j * rng.normal(size=(4, 2, 2))
    U = torch.as_tensor(np.linalg.qr(z)[0])
    rot = vecs.clone()
    rot[:4] = U @ vecs[:4]  # the TRIMs' pair: rows are states
    dHc = torch.einsum("ra,brij->baij", torch.as_tensor(lat, dtype=torch.complex128),
                       hamiltonian.assemble_dk(data, kpts)) / (2.0 * math.pi)
    Vr = torch.einsum("bns,bast,bmt->banm", rot.conj(), dHc, rot)
    turned = boltzmann._spin_velocity(evals, rot, Vr)
    assert (evals[:4, 1] - evals[:4, 0]).abs().max() < 1e-12
    assert float((turned.sum(-1) - base.sum(-1)).abs().max()) <= 1e-12
    assert float((turned[4] - base[4]).abs().max()) <= 1e-12
    # the band-by-band sum of the reference does change under the rotation
    def diag_sum(vv, VV):
        sig = torch.tensor([[[0, 1], [1, 0]], [[0, -1j], [1j, 0]], [[1, 0], [0, -1]]], dtype=torch.complex128) / 2
        sd = torch.einsum("bnr,xrs,bns->bxn", vv.conj(), sig, vv).real
        return torch.einsum("bxn,bcn->bxc", sd, torch.diagonal(VV, dim1=-2, dim2=-1).real)

    assert float((diag_sum(rot[:4], Vr[:4]) - diag_sum(vecs[:4], V[:4])).abs().max()) > 1e-6


# -- the Chambers integrator's short-segment weights (boltzmann._chambers_orbit) --


def _decay_weight_ld(x):
    """1 - (1 - e^{-x}) / x in np.longdouble: its series below 1e-3 (where
    the closed form would lose eps_ld / x), the closed form above."""
    x = np.longdouble(x)
    if x < np.longdouble("1e-3"):
        term, acc = x / np.longdouble(2), np.longdouble(0)
        for n in range(1, 12):
            acc += term
            term *= -x / np.longdouble(n + 2)
        return acc
    return np.longdouble(1) + np.expm1(-x) / x


def _chambers_ld(v, dt, tau):
    """The Chambers orbit tensor of boltzmann._chambers_orbit evaluated in
    np.longdouble: the same exact exponential integrator, 1 - P as
    -expm1(-sum x)."""
    v = v.astype(np.longdouble)
    dt = dt.astype(np.longdouble)
    tau = np.longdouble(tau)
    m = v.shape[0]
    x = dt / tau
    one_m_E = -np.expm1(-x)
    E = np.longdouble(1) - one_m_E
    C = tau * np.array([_decay_weight_ld(xi) for xi in x], dtype=np.longdouble)
    A = tau * one_m_E - C
    vn = np.roll(v, -1, axis=0)
    b = np.zeros(2, dtype=np.longdouble)
    for i in range(m):
        b = E[i] * b + A[i] * v[i] + C[i] * vn[i]
    J = b / -np.expm1(-np.sum(x))
    out = np.zeros((2, 2), dtype=np.longdouble)
    for i in range(m):
        Jn = E[i] * J + A[i] * v[i] + C[i] * vn[i]
        out += np.longdouble("0.5") * dt[i] * (np.outer(v[i], J) + np.outer(vn[i], Jn))
        J = Jn
    return out


def _open_orbit(x, tau=1.7, m=16):
    """An open orbit's velocities (non-zero mean v_x, so sigma_xx stays
    finite as x -> 0) and segment times of about x tau."""
    th = 2.0 * np.pi * np.arange(m) / m
    v = np.stack([1.0 + 0.3 * np.cos(th), 0.5 * np.sin(th)], axis=1)
    return v, x * tau * (1.0 + 0.4 * np.sin(3.0 * th)), tau


XS = np.logspace(-9.0, 0.0, 19)


def test_chambers_segment_weight_meets_longdouble():
    """C = tau (1 - (1 - e^{-x}) / x), repaired: within 1e-14 relative of
    an np.longdouble evaluation for x in 1e-9 - 1 (the reference's
    tau - tau^2 (1 - e^{-x}) / dt loses eps / x there)."""
    got = boltzmann._one_minus_mean_decay(XS)
    want = np.array([_decay_weight_ld(x) for x in XS])
    rel = np.abs((got - want) / want).astype(np.float64)
    assert rel.max() <= 1e-14, rel
    # the reference's form is the fault being repaired: over 1e-4 off at x = 1e-13
    x = 1e-13
    ref = 1.0 - (-np.expm1(-x)) / x
    assert abs(ref - float(_decay_weight_ld(x))) > 1e-4 * float(_decay_weight_ld(x))


@pytest.mark.parametrize("x", XS)
def test_chambers_orbit_meets_longdouble(x):
    """sigma of one orbit from the port's integrator within 1e-14 (relative
    to its largest entry) of the np.longdouble evaluation."""
    v, dt, tau = _open_orbit(x)
    got = boltzmann._chambers_orbit(v, dt, tau)
    want = _chambers_ld(v, dt, tau)
    assert np.abs(got - want).max() <= 1e-14 * float(np.abs(want).max())


@pytest.mark.parametrize("x", XS[XS > 1e-4])
def test_chambers_orbit_matches_jax_off_the_repaired_branch(x):
    from pythtb_tpu import boltzmann as jboltzmann

    v, dt, tau = _open_orbit(x)
    want = jboltzmann._chambers_orbit(v, dt, tau)
    assert np.abs(boltzmann._chambers_orbit(v, dt, tau) - want).max() <= 1e-10 * np.abs(want).max()


# The public names of pythtb_tpu that the port does not have yet, with the
# reason: a queue-1 item of ROADMAP.md still to port, or a name that only
# the TPU runtime needed.  The list only shrinks: a closed gap must leave it.
ALLOWED_GAPS = {
    ("__init__.py", "parallel"): "queue 1 item 10",
    ("parallel/__init__.py", "<module>"): "queue 1 item 10",
    ("parallel/mesh.py", "<module>"): "queue 1 item 10",
    ("ops/solver.py", "shard_axis"): "queue 1 item 10",
    ("ops/solver.py", "shard_grid_axis0"): "queue 1 item 10",
    ("utils/xfer.py", "<module>"): "TPU-only: ri-packing",
    ("ops/position.py", "position_expectation_packed"): "TPU-only: ri-packing",
    ("ops/position.py", "position_hwf_packed"): "TPU-only: ri-packing",
    ("ops/position.py", "position_matrix_packed"): "TPU-only: ri-packing",
    ("family.py", "unpack_host"): "TPU-only: ri-packing",
    ("config.py", "PATTERN_MAX_ELEMS"): "TPU-only: dtype and backend policy",
    ("config.py", "complex_dtype"): "TPU-only: dtype and backend policy",
    ("config.py", "cpu_like_backend"): "TPU-only: dtype and backend policy",
    ("config.py", "float_dtype"): "TPU-only: dtype and backend policy",
    ("config.py", "int_dtype"): "TPU-only: dtype and backend policy",
    ("config.py", "is_x64"): "TPU-only: dtype and backend policy",
    ("core.py", "ModelStatic"): "TPU-only: the port's frozen BlochData carries its fields",
}


def _public_names(path):
    """Top-level public functions, classes and assignments of a module,
    with the entries of its ``__all__``."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    out |= set(ast.literal_eval(node.value))
                elif isinstance(t, ast.Name):
                    out.add(t.id)
    return {n for n in out if not n.startswith("_")}


def _name_gaps():
    gaps = set()
    for path in sorted((ROOT / "pythtb_tpu").rglob("*.py")):
        rel = path.relative_to(ROOT / "pythtb_tpu")
        twin = ROOT / "pythtb_tpu_torch" / rel
        if not twin.exists():
            gaps.add((rel.as_posix(), "<module>"))
            continue
        gaps |= {(rel.as_posix(), n) for n in _public_names(path) - _public_names(twin)}
    return gaps


def test_public_names_match_the_reference_but_for_the_listed_gaps():
    gaps = _name_gaps()
    assert sorted(gaps - set(ALLOWED_GAPS)) == []  # a new gap
    assert sorted(set(ALLOWED_GAPS) - gaps) == []  # a closed gap still listed
    assert all(r.startswith(("queue 1 item", "TPU-only")) for r in ALLOWED_GAPS.values())


def test_parity_names_repaired():
    import pythtb_tpu_torch
    from pythtb_tpu_torch.ops import berry

    assert pythtb_tpu_torch.PYTHTB_COMPAT_VERSION == "1.8.0"
    assert "PYTHTB_COMPAT_VERSION" in pythtb_tpu_torch.__all__
    assert berry.berry_evals_device is berry.berry_evals
    assert "berry_evals_device" in berry.__all__
