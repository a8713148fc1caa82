"""The parallel branch-code rule of the envelope backwards
(csrc/env_bwd.cuh, modelled by ops/env_units.free_codes and
peak_envelope_codes_free) against the serial codes that
peak_envelope_bwd_plain replays (ops/env_units.peak_envelope_codes):
exact equality, on seeded levels, states, taus, thresholds and holds.
CPU only; the kernels themselves are held against the plain backward on
the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from lsp_dsp_units_tpu_torch.ops import dynamics as tdyn
from lsp_dsp_units_tpu_torch.ops import env_units as eu


def _case(seed, c, t, free_start=False, ta=0.05, tr=0.01):
    """Seeded swell levels [c, t] and a random incoming state (holds up
    to 24 left), or a free one (peak == envelope, no hold)."""
    rng = np.random.default_rng(seed)
    swell = np.sin(np.linspace(0.0, np.pi, t)) + 0.1
    x = (np.abs(rng.standard_normal((c, t))) * 0.6 * swell).astype(np.float32)
    e0 = rng.random(c).astype(np.float32)
    p0 = e0.copy() if free_start else rng.random(c).astype(np.float32)
    h0 = (np.zeros(c) if free_start else rng.integers(0, 25, c)).astype(
        np.int32)
    st = tdyn.EnvState(torch.from_numpy(e0), torch.from_numpy(p0),
                       torch.from_numpy(h0))
    return torch.from_numpy(x), st


def _forward_env(x, st, ta, tr, rt):
    return eu.peak_envelope_plain(st, x, ta, tr, 0, rt)[1]


@pytest.mark.parametrize("batch", [1, 4, 32])
@pytest.mark.parametrize("t", [1, 31, 32, 33, 65, 300])
@pytest.mark.parametrize("rt", [None, 0.2])
def test_free_route_codes_equal_serial(t, rt, batch):
    """From a random state (a serial prefix until the envelope is free)
    with the forward's own envelope: the route's codes are the serial
    ones, at any batch size the free state is checked at."""
    x, st = _case(t + (rt is not None), 5, t)
    env = _forward_env(x, st, 0.05, 0.01, rt)
    want = eu.peak_envelope_codes(x, env, *st, 0, rt)
    got = eu.peak_envelope_codes_free(x, env, *st, rt, batch=batch)
    assert torch.equal(got, want)


@pytest.mark.parametrize("t", [1, 33, 300])
@pytest.mark.parametrize("rt", [None, 0.2])
def test_free_start_is_free_throughout(t, rt):
    """A state already at peak == envelope with no hold, the taus that
    allow free_step (tau_release <= tau_attack, both >= 0): no break,
    every code is free_codes's."""
    x, st = _case(7 * t, 4, t, free_start=True)
    env = _forward_env(x, st, 0.05, 0.01, rt)
    want = eu.peak_envelope_codes(x, env, *st, 0, rt)
    assert torch.equal(eu.free_codes(x, env, st.envelope, rt), want)
    assert not torch.any(want == eu._RISE)


@pytest.mark.parametrize("seed", range(4))
def test_random_coefficients_and_thresholds(seed):
    """Seeded taus (release faster or slower than attack, a negative
    attack tau), thresholds and T: the route's codes are the serial
    ones."""
    rng = np.random.default_rng(100 + seed)
    t = int(rng.integers(1, 200))
    ta, tr = (float(v) for v in rng.uniform(-0.2, 0.9, 2))
    rt = None if seed % 2 else float(rng.uniform(0.0, 0.8))
    x, st = _case(seed, 6, t)
    env = _forward_env(x, st, ta, tr, rt)
    want = eu.peak_envelope_codes(x, env, *st, 0, rt)
    assert torch.equal(eu.peak_envelope_codes_free(x, env, *st, rt), want)


@pytest.mark.parametrize("seed", range(3))
def test_breaks_in_an_envelope_from_elsewhere(seed):
    """An envelope that is no forward run's (random), so that rises below
    the envelope before them (breaks) occur throughout: each break runs
    the recurrence until free again, and the codes are still the serial
    ones."""
    rng = np.random.default_rng(200 + seed)
    c, t = 5, 150
    x, st = _case(seed, c, t)
    env = torch.from_numpy(rng.random((c, t)).astype(np.float32))
    rt = 0.3 if seed % 2 else None
    want = eu.peak_envelope_codes(x, env, *st, 0, rt)
    free = eu.free_codes(x, env, st.envelope, rt)
    assert torch.any(free == eu._RISE)
    assert torch.equal(eu.peak_envelope_codes_free(x, env, *st, rt), want)


@pytest.mark.parametrize("bad", ["inf", "nan", "-inf"])
def test_non_finite_levels(bad):
    """A level of inf, NaN or -inf in the row, the envelope the forward's:
    the route's codes are the serial ones."""
    x, st = _case(len(bad), 4, 100)
    x[:, 40] = float(bad)
    x[1, 70:73] = float(bad)
    env = _forward_env(x, st, 0.05, 0.01, 0.2)
    want = eu.peak_envelope_codes(x, env, *st, 0, 0.2)
    assert torch.equal(eu.peak_envelope_codes_free(x, env, *st, 0.2), want)


def test_leading_shape():
    """Rows [2, 3, T] as the wrappers take them."""
    x, st = _case(11, 6, 70)
    env = _forward_env(x, st, 0.05, 0.01, 0.2)
    want = eu.peak_envelope_codes(x, env, *st, 0, 0.2)
    got = eu.peak_envelope_codes_free(
        x.reshape(2, 3, 70), env.reshape(2, 3, 70),
        *(v.reshape(2, 3) for v in st), 0.2)
    assert torch.equal(got.reshape(6, 70), want)
