"""The port's localization toolkit (``localization``) against pythtb_tpu's,
on the CPU in float64, where kernel 18 and kernel 1 run their plain
versions.

Without random draws the exponents are held against JAX at 1e-10
relative to the largest: the clean strip's non-negative half at the
default stride (the half the localization length reads; the most
negative exponents of a non-normal transfer product carry rounding of
order eps * e^{stride (gamma_max - gamma_min)} in either package, 3e-8
here) and its whole spectrum at stride 1, and the Aubry-Andre chain's
whole spectrum.  The port's disorder draws come from numpy's
default_rng, not from jax.random, so with disorder it is held to the
oracles of tests/test_localization.py instead (the Thouless identity on
the very realization it drew, the sum rule of |det| = 1) and to its own
reproducibility: a seed gives the same exponents whatever the chunking.
Participation and level-spacing ratios match JAX to 1e-12.
"""

import numpy as np
import pytest

import pythtb_tpu
from pythtb_tpu import localization as jloc
from pythtb_tpu.model import PythtbError as JPythtbError
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import PythtbError, localization

from .test_torch_ops import carry, on_cpu  # noqa: F401  (autouse: the port on the CPU)

REL = 1e-10


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _chain():
    m = pythtb_tpu.tb_model(1, 1, [[1.0]], [[0.0]])
    m.set_hop(-1.0, 0, 0, [1])
    return m


def _strip(width=4):
    sq = pythtb_tpu.tb_model(2, 2, np.eye(2), [[0.0, 0.0]])
    sq.set_hop(-1.0, 0, 0, [1, 0])
    sq.set_hop(-1.0, 0, 0, [0, 1])
    return sq.cut_piece(width, 1)


def test_clean_strip_matches_jax():
    jm = _strip()
    pm = carry(jm)
    Es = np.linspace(-3.5, 3.5, 7)
    got, want = localization.lyapunov_spectrum(pm, Es, 400), jloc.lyapunov_spectrum(jm, Es, 400)
    assert got.shape == (1, 7, 8)
    _close(got[..., :4], want[..., :4])
    _close(localization.lyapunov_spectrum(pm, Es, 96, stride=1), jloc.lyapunov_spectrum(jm, Es, 96, stride=1))
    xi, jxi = localization.localization_length(pm, Es, 400), jloc.localization_length(jm, Es, 400)
    assert np.array_equal(np.isinf(xi), np.isinf(jxi))
    fin = np.isfinite(jxi)
    assert np.all(np.abs(xi[fin] - jxi[fin]) <= REL * jxi[fin])
    # channel decoupling outside the band: every positive exponent is a
    # shifted chain's arccosh
    eps_c = np.linalg.eigvalsh(-np.eye(4, k=1) - np.eye(4, k=-1))
    exact = np.sort(np.arccosh(np.abs(4.6 - eps_c) / 2.0))[::-1]
    assert np.abs(localization.lyapunov_spectrum(pm, [4.6], 4000)[0, 0, :4] - exact).max() < 1e-3


def test_aubry_andre_matches_jax():
    """A quasiperiodic potential lam cos(2 pi beta l) with lam > 2t:
    gamma >= ln(lam / 2) at every E (equality in the spectrum)."""
    jm = _chain()
    L, lam = 610, 2.5
    pot = lam * np.cos(2.0 * np.pi * (np.sqrt(5.0) - 1.0) / 2.0 * np.arange(L))
    got = localization.lyapunov_spectrum(carry(jm), [-1.0, 0.3], L, potential=pot)
    _close(got, jloc.lyapunov_spectrum(jm, [-1.0, 0.3], L, potential=pot))
    assert got[0, :, 0].min() > np.log(lam / 2.0) - 2e-2


def test_disordered_chain_thouless_identity():
    """gamma_max = (1/L) sum_j ln|E - eps_j| - ln|t| on the realization the
    port drew (rebuilt from the same default_rng stream); at S 1 the pair
    sums to 0 (|det| = 1)."""
    L, W, E, seed = 2048, 2.0, 0.8, 11
    got = localization.lyapunov_spectrum(carry(_chain()), [E, -0.3], L, disorder=W, seed=seed)
    w = W * (np.random.default_rng(seed).uniform(size=(L, 1, 1)) - 0.5)[:, 0, 0]
    eps = np.linalg.eigvalsh(np.diag(w) - np.eye(L, k=1) - np.eye(L, k=-1))
    thouless = float(np.log(np.abs(E - eps)).sum() / L)
    assert abs(float(got[0, 0, 0]) - thouless) < 5e-3
    assert np.abs(got[..., 0] + got[..., 1]).max() < 1e-12


def test_disorder_is_reproducible_across_chunks(monkeypatch):
    """A seed gives bit-identical exponents whatever the chunk size of the
    draws (they are drawn step-major from one default_rng stream), and a
    strip's exponents sum to 0 (|det| of every transfer matrix is 1), up
    to the rounding the most negative ones carry (1.6e-9 here)."""
    pm = carry(_strip(3))
    Es = [-2.5, 0.1, 1.7]
    kw = dict(disorder=1.5, realizations=2, seed=4)
    first = localization.lyapunov_spectrum(pm, Es, 160, **kw)
    monkeypatch.setattr(localization, "_CHUNK_VALUES", 48)  # 8 steps of 2 x 3 values a chunk
    again = localization.lyapunov_spectrum(pm, Es, 160, **kw)
    assert np.array_equal(first, again)
    assert not np.array_equal(first[0], first[1])
    assert np.abs(first.sum(axis=-1)).max() < 1e-7
    assert np.array_equal(localization.localization_length(pm, Es, 160, **kw),
                          np.where(first[..., 2].mean(0) > 0, 1.0 / first[..., 2].mean(0), np.inf))


def test_participation_and_level_spacing_match_jax():
    rng = np.random.default_rng(2)
    states = rng.normal(size=(5, 12)) + 1j * rng.normal(size=(5, 12))
    spinful = rng.normal(size=(3, 6, 2))
    for q in (2, 3.5):
        np.testing.assert_allclose(localization.participation_ratio(states, q),
                                   jloc.participation_ratio(states, q), rtol=1e-12)
    np.testing.assert_allclose(localization.participation_ratio(spinful, spinful=True),
                               jloc.participation_ratio(spinful, spinful=True), rtol=1e-12)
    ev = rng.normal(size=(4, 50))
    assert localization.level_spacing_ratio(ev) == pytest.approx(jloc.level_spacing_ratio(ev), rel=1e-12)
    np.testing.assert_allclose(localization.level_spacing_ratio(ev, mean=False),
                               jloc.level_spacing_ratio(ev, mean=False), rtol=1e-12)


def test_errors_match_jax():
    ch = _chain()
    m2 = pythtb_tpu.tb_model(1, 1, [[1.0]], [[0.0], [0.5]])
    m2.set_hop(-1.0, 0, 0, [1])
    m2.set_hop(-0.7, 0, 1, [0])
    cases = [
        ("lyapunov_spectrum", (jzoo.graphene(), [0.0], 100), {}),
        ("lyapunov_spectrum", (ch, [[0.0]], 100), {}),
        ("lyapunov_spectrum", (ch, [0.0], 100), dict(disorder=-1.0)),
        ("lyapunov_spectrum", (ch, [0.0], 0), {}),
        ("lyapunov_spectrum", (ch, [0.0], 100), dict(potential=np.zeros((3, 7)))),
        ("lyapunov_spectrum", (_strip(3), [0.0], 100), dict(potential=np.zeros(5))),
        ("lyapunov_spectrum", (m2, [0.0], 100), {}),
        ("localization_length", (jzoo.graphene(), [0.0], 100), {}),
        ("participation_ratio", (np.ones(4),), dict(q=1.0)),
        ("participation_ratio", (np.ones((4, 3)),), dict(spinful=True)),
    ]
    for name, args, kwargs in cases:
        with pytest.raises(JPythtbError) as want:
            getattr(jloc, name)(*args, **kwargs)
        pargs = tuple(carry(a) if isinstance(a, pythtb_tpu.tb_model) else a for a in args)
        with pytest.raises(PythtbError) as got:
            getattr(localization, name)(*pargs, **kwargs)
        assert str(got.value) == str(want.value)


def _csrc_constant(name, source):
    """An ``int`` constexpr of a CUDA source of the port."""
    import pathlib
    import re

    text = (pathlib.Path(localization.__file__).resolve().parent / "csrc" / source).read_text()
    return int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))


@pytest.mark.parametrize("S,nE,ndis,sms,want", [
    (8, 512, 1, 132, "warp"),   # the Lyapunov row
    (1, 512, 1, 132, "warp"),
    (3, 5, 2, 132, "warp"),
    (8, 1, 1, 132, "warp"),     # the clean strip's one chain
    (8, 4096, 4, 8, "warp"),
    (9, 512, 1, 132, "block"),  # past the warp design's 2S = 16 columns
    (16, 1, 1, 132, "block"),
    (40, 64, 2, 132, "block"),
])
def test_lyapunov_design_line(S, nE, ndis, sms, want):
    """Kernel 18's design as a function of (S, nE, ndis, SM count): a warp a
    chain to 8 states a layer, a block above."""
    assert localization._lyapunov_design(S, nE, ndis, sms) == want
    code, most = localization._LYAPUNOV_DESIGNS[want]
    assert S <= most


def test_lyapunov_designs_match_the_kernel_source():
    """The wrapper's limits are csrc/lyapunov.cu's: the warp design to
    kWarpMaxS states, the block design to kMaxS (LYAPUNOV_MAX_S)."""
    assert localization._LYAPUNOV_DESIGNS["warp"][1] == _csrc_constant("kWarpMaxS", "lyapunov.cu")
    assert localization._LYAPUNOV_DESIGNS["block"][1] == _csrc_constant("kMaxS", "lyapunov.cu")
    assert localization.LYAPUNOV_MAX_S == _csrc_constant("kMaxS", "lyapunov.cu")
