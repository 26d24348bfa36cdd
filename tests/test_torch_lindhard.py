"""The port's Lindhard / RPA response (``lindhard``, ``rpa_susceptibility``,
``stoner_analysis``) against pythtb_tpu's, on the CPU in float64, where
kernel 16's q-batch mode runs its plain version: chi0 in both the
``nocc`` and the ``mu`` mode, with and without ``ops``, to 1e-12 of the
largest |chi0|; RPA and the Stoner analysis to 1e-10; the warnings as in
the JAX package.  Sizes stay small (at most 8 q).
"""

import warnings

import numpy as np
import pytest
import torch

import pythtb_tpu
from pythtb_tpu import response as jresponse
from pythtb_tpu.models import library as jzoo
from pythtb_tpu_torch import response
from pythtb_tpu_torch.optical import _spectral_sum_plain, spectral_sum_qbatch

from .test_torch_ops import carry, on_cpu, random_model  # noqa: F401  (autouse: the port on the CPU)


def _embedded_chain():
    m = pythtb_tpu.tb_model(1, 1, [[1.0]], [[0.0], [0.5]])
    m.set_onsite([0.3, -0.3])
    m.set_hop(-1.0, 0, 1, [0])
    m.set_hop(-0.7, 1, 0, [1])
    return m


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def _quiet(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    return out, [str(w.message) for w in caught]


CASES = {
    "chain nocc": (_embedded_chain, [[0.0], [0.25], [1 / 3], [0.5]], np.linspace(-3.0, 3.0, 7), 6,
                   dict(nocc=1, eta=0.05)),
    "chain mu": (_embedded_chain, [[0.125], [0.4]], np.array([0.0, 1.1]), 8,
                 dict(mu=0.05, temperature=0.3, eta=0.04)),
    "graphene mu, 8 q": (lambda: jzoo.graphene(), [[i / 8, (i % 3) / 5] for i in range(8)], np.array([0.0, 0.7, 2.0]),
                         (6, 5), dict(mu=0.2, temperature=0.05, eta=0.03)),
    "haldane nocc, ops": (jzoo.haldane, [[0.1, 0.3], [0.5, 0.0]], np.array([0.5, 3.0]), 5,
                          dict(nocc=1, eta=0.1, ops=[[1.0, -1.0], [0.5, 2.0], [1.0, 1.0]])),
    "spinful nocc": (lambda: random_model(51, 2, 2, norb=2, nhop=6), [[0.2, 0.1], [0.0, 0.5]], np.array([0.0, 1.5]),
                     4, dict(nocc=2, eta=0.08)),
    "3-D mu": (lambda: random_model(52, 3, 1, norb=2, nhop=6), [[0.1, 0.2, 0.3]], np.array([-0.5, 0.5]), 3,
               dict(mu=0.0, temperature=0.2, eta=0.05)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lindhard_matches_jax(case):
    make, q, om, nk, kw = CASES[case]
    jm = make()
    got, got_w = _quiet(response.lindhard, carry(jm), q, om, nk, **kw)
    want, want_w = _quiet(jresponse.lindhard, jm, q, om, nk, **kw)
    assert got_w == want_w
    assert got.dtype == np.complex128
    _close(got, want, 1e-12)


def test_metallic_filling_warns_as_in_jax():
    with pytest.warns(UserWarning, match="metallic"):
        response.lindhard(carry(jzoo.graphene()), [[0.0, 0.0]], [0.0], nk=6, nocc=1, eta=0.05)


@pytest.mark.parametrize("channel", ["spin", "charge"])
def test_rpa_susceptibility_matches_jax(channel):
    jm = _embedded_chain()
    kw = dict(U=[1.2, 0.8], channel=channel, nocc=1, eta=0.03)
    got = response.rpa_susceptibility(carry(jm), [[0.2], [0.5]], [0.0, 0.6], 8, **kw)
    want = jresponse.rpa_susceptibility(jm, [[0.2], [0.5]], [0.0, 0.6], 8, **kw)
    for a, b in zip(got, want):
        _close(a, b, 1e-10)


def test_stoner_analysis_matches_jax():
    jm = jzoo.graphene()
    q = [[0.0, 0.0], [0.5, 0.0], [1 / 3, 1 / 3]]
    got = response.stoner_analysis(carry(jm), q, nk=9, U=2.0, mu=0.0, temperature=0.02)
    want = jresponse.stoner_analysis(jm, q, nk=9, U=2.0, mu=0.0, temperature=0.02)
    assert sorted(got) == sorted(want)
    _close(got["lambda"], want["lambda"], 1e-10)
    _close(got["U_c"], want["U_c"], 1e-10)
    np.testing.assert_array_equal(got["q_best"], want["q_best"])
    assert abs(got["U_c_min"] - want["U_c_min"]) <= 1e-10 * abs(want["U_c_min"])
    # the critical vectors up to their phase
    ov = np.abs(np.einsum("qa,qa->q", got["vector"].conj(), want["vector"]))
    np.testing.assert_allclose(ov, 1.0, atol=1e-10)


def test_qbatch_plain_is_the_single_sum_per_q():
    rng = np.random.default_rng(3)
    Q, P, T = 3, 4, 50
    W = torch.as_tensor(rng.normal(size=(Q, P, T)) + 1j * rng.normal(size=(Q, P, T)))
    de = torch.as_tensor(rng.normal(size=(Q, T)))
    om = torch.as_tensor(np.linspace(-2.0, 2.0, 9))
    got = spectral_sum_qbatch(W, de, om, 0.07)
    assert got.shape == (Q, P, 9)
    for q in range(Q):
        want = (W[q][:, :, None] / (om[None, None, :] - de[q][None, :, None] + 0.07j)).sum(dim=1)
        np.testing.assert_allclose(got[q].numpy(), want.numpy(), rtol=0, atol=1e-12 * float(want.abs().max()))
        np.testing.assert_array_equal(got[q].numpy(), _spectral_sum_plain(W[q], de[q], om, 0.07, "lorentz").numpy())
