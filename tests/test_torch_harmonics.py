"""The port's ``optical.harmonic_spectrum`` against pythtb_tpu's, on the CPU
in float64, where kernel 22's state mode runs its plain version: the
current to 1e-12 of its largest |j| (a scalar drive frequency, a batch
of two, a y polarization, 2-D and 1-D, three and four states), the
harmonic amplitudes to 1e-12 of the largest |C_n|, and sigma1 / sigma2
(fields E0 >= 1e-2) to 1e-8 relative.  The current is a sum of O(1)
velocity matrix elements that cancel to ~E0: its rounding floor is
~1e-15 absolute in either package, so the fields are large enough
(0.02-0.2) that 1e-12 of the largest |j| lies above that floor.  The JAX results are built once
per module.  Sizes stay small: nk <= (6, 6) in 2-D, 16 in 1-D, 5 cycles
with a 1-cycle ramp at 16 steps a cycle.
"""

import numpy as np
import pytest

from pythtb_tpu import models as jmodels
from pythtb_tpu import optical as joptical
from pythtb_tpu_torch import optical

from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)

KW = dict(cycles=5, ramp_cycles=1, steps_per_cycle=16, n_harmonics=3)
CASES = {
    "bn scalar": (lambda: jmodels.bn(delta=1.0), 0.6, 0.1, dict(occ=[0], nk=(6, 6))),
    "bn batch of 2": (lambda: jmodels.bn(delta=1.0), np.array([0.5, 0.8]), 0.2, dict(occ=[0], nk=(5, 6))),
    "bn y polarization": (lambda: jmodels.bn(delta=1.0), 0.7, 0.2, dict(occ=[0], nk=(6, 5), pol=[0.0, 1.0])),
    "ssh 1-D": (lambda: jmodels.ssh(delta=0.4), 0.5, 0.02, dict(occ=[0], nk=(16,))),
    "random 3 states": (lambda: random_model(61, 2, 1, norb=3, nhop=6), 0.9, 0.05, dict(occ=[0], nk=(4, 5))),
    "random spinful": (lambda: random_model(62, 2, 2, norb=2, nhop=5), 0.8, 0.05, dict(occ=[0, 1], nk=(4, 4))),
}


@pytest.fixture(scope="module")
def jax_results():
    """Each case through pythtb_tpu once: (the model, its result)."""
    out = {}
    for name, (build, w, E0, kw) in CASES.items():
        m = build()
        out[name] = (m, joptical.harmonic_spectrum(m, w, E0, **kw, **KW))
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_harmonic_spectrum_matches_jax(jax_results, name):
    m, want = jax_results[name]
    _, w, E0, kw = CASES[name]
    got = optical.harmonic_spectrum(carry(m), w, E0, **kw, **KW)
    assert sorted(got) == sorted(want)
    j, jw = got["current"], want["current"]
    assert j.shape == jw.shape
    assert np.abs(j - jw).max() <= 1e-12 * np.abs(jw).max()
    C, Cw = got["harmonics"], want["harmonics"]
    assert np.abs(C - Cw).max() <= 1e-12 * np.abs(Cw).max()
    for key in ("sigma1", "sigma2"):
        assert np.abs(got[key] - want[key]).max() <= 1e-8 * np.abs(want[key]).max()
    np.testing.assert_array_equal(got["dt"], want["dt"])


def test_omega_batch_equals_scalar_runs(jax_results):
    """Rows of a frequency batch evolve independently: each equals its
    scalar run (the same arithmetic, the rows stacked)."""
    m, _ = jax_results["bn batch of 2"]
    _, ws, E0, kw = CASES["bn batch of 2"]
    batch = optical.harmonic_spectrum(carry(m), ws, E0, **kw, **KW)
    for i, w in enumerate(ws):
        one = optical.harmonic_spectrum(carry(m), float(w), E0, **kw, **KW)
        assert np.abs(batch["current"][i] - one["current"]).max() <= 1e-13 * np.abs(one["current"]).max()


def test_steps_split_into_chunks_give_the_same_current(jax_results, monkeypatch):
    """A budget that forces one step a chunk gives the same current as one
    chunk of all steps (the state carries over between chunks)."""
    from pythtb_tpu_torch.ops import propagate

    m, _ = jax_results["bn scalar"]
    _, w, E0, kw = CASES["bn scalar"]
    whole = optical.harmonic_spectrum(carry(m), w, E0, **kw, **KW)["current"]
    monkeypatch.setattr(propagate, "CHUNK_BYTES", 1)
    chunks = []

    def counted(*args):
        chunks.append(args[0].shape[0])
        return propagate.propagate_state(*args)

    monkeypatch.setattr(optical, "propagate_state", counted)
    split = optical.harmonic_spectrum(carry(m), w, E0, **kw, **KW)["current"]
    assert chunks == [1] * (KW["cycles"] * KW["steps_per_cycle"])
    assert np.abs(split - whole).max() <= 1e-13 * np.abs(whole).max()
