"""The port's signal sources against the JAX package's, on the CPU: the
randomizer, the noise cores (MLS, LCG, Velvet) and the NoiseGenerator,
the quickmath/LFO/sigmoid functions, the ADSR envelope and the
Oscillator.  Inputs are float32 from numpy seeds (the repository's
conftest turns on JAX's x64, so every reference input is cast
explicitly).

Bars:

* Exact: the randomizer, MLS, LCG and Velvet (every distribution, core
  and type), white noise from each core; the quickmath functions; the
  LFO shapes and sigmoids that are polynomials or square roots (the JAX
  functions called op by op round each product and sum alone, as torch
  does; torch's vectorised CPU sqrt can miss by an ulp, so the port takes
  a correctly rounded one); the LFO's ``quick=True`` shapes.
* Transcendental (sin, log, exp, atan inside): within 1e-6 absolute
  (torch's and XLA's float32 functions differ by an ulp or two).
* ADSR: within 1e-6 (its EXP curve calls exp).
* Oscillator, all 14 functions over two calls with the phase carried:
  naive >= 120 dB and band-limited >= 110 dB from the JAX output, the
  phase word equal.
* Colored noise >= 110 dB over two calls (the SpectralTilt cascade).
* ``lcg_device`` and ``dither_device`` draw from a torch.Generator, not
  the JAX package's keys: the same seed gives the same output; values
  stay in the distribution's range; mean and variance within 4 standard
  errors of their analytic values at 2^18 draws.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import sosfilt

from lsp_dsp_units_tpu.models.misc import lfo as JL
from lsp_dsp_units_tpu.models.misc import quickmath as JQ
from lsp_dsp_units_tpu.models.misc import sigmoid as JS
from lsp_dsp_units_tpu.models.noise import generator as JG
from lsp_dsp_units_tpu.models.noise import lcg as JLCG
from lsp_dsp_units_tpu.models.noise import mls as JM
from lsp_dsp_units_tpu.models.noise import velvet as JV
from lsp_dsp_units_tpu.models.util import adsr as JA
from lsp_dsp_units_tpu.models.util import oscillator as JO
from lsp_dsp_units_tpu.models.util import randomizer as JR

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch.models.misc import lfo as TL
from lsp_dsp_units_tpu_torch.models.misc import quickmath as TQ
from lsp_dsp_units_tpu_torch.models.misc import sigmoid as TS
from lsp_dsp_units_tpu_torch.models.noise import generator as TG
from lsp_dsp_units_tpu_torch.models.noise import lcg as TLCG
from lsp_dsp_units_tpu_torch.models.noise import mls as TM
from lsp_dsp_units_tpu_torch.models.noise import velvet as TV
from lsp_dsp_units_tpu_torch.models.util import adsr as TA
from lsp_dsp_units_tpu_torch.models.util import dither as TD
from lsp_dsp_units_tpu_torch.models.util import oscillator as TO
from lsp_dsp_units_tpu_torch.models.util import randomizer as TR
from lsp_dsp_units_tpu_torch.ops import sliding

SR = 48000
SEEDS = [0, 1, 12345, 0xDEADBEEF]


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _eq(want, got):
    want = np.asarray(want)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype


# ---------------------------------------------------------------- numpy cores


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("func", list(JR.RandomFunction),
                         ids=lambda f: f.name)
def test_randomizer_is_exact(func, seed):
    j, t = JR.Randomizer(seed), TR.Randomizer(seed)
    for count in (1, 7, 1000, 3):
        _eq(j.random(func, count),
            t.random(TR.RandomFunction[func.name], count))
    _eq(j.last, t.last)
    assert j.buf_id == t.buf_id


@pytest.mark.parametrize("n_bits,state", [(1, 0), (5, 3), (16, 0),
                                          (23, 12345), (64, 99)])
def test_mls_is_exact(n_bits, state):
    j = JM.MLS(n_bits=n_bits, state=state, amplitude=0.7, offset=0.1)
    t = TM.MLS(n_bits=n_bits, state=state, amplitude=0.7, offset=0.1)
    for count in (1, 500, 33):
        _eq(j.process(count), t.process(count))
    assert j.state == t.state
    assert [j.process_single() for _ in range(5)] == [
        t.process_single() for _ in range(5)]
    if n_bits <= 16:
        # the cached raw period, reused with another amplitude (<= 0)
        _eq(j.full_period(), t.full_period())
        j.amplitude = t.amplitude = -1.0
        _eq(j.full_period(), t.full_period())


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("dist", list(JLCG.LCGDistribution),
                         ids=lambda d: d.name)
def test_lcg_is_exact(dist, seed):
    j = JLCG.LCG(dist, amplitude=0.8, offset=0.05, seed=seed)
    t = TLCG.LCG(TLCG.LCGDistribution[dist.name], amplitude=0.8,
                 offset=0.05, seed=seed)
    for count in (1, 999, 64):
        _eq(j.process(count), t.process(count))


@pytest.mark.parametrize("crush", [False, True])
@pytest.mark.parametrize("core", list(JV.VelvetCore), ids=lambda c: c.name)
@pytest.mark.parametrize("vtype", list(JV.VelvetType), ids=lambda v: v.name)
def test_velvet_is_exact(vtype, core, crush):
    kw = dict(window_width=7.0, arn_delta=0.3, crush=crush, crush_prob=0.4,
              amplitude=0.9, offset=0.02, seed=77)
    j = JV.Velvet(vtype, JV.VelvetCore[core.name], **kw)
    t = TV.Velvet(TV.VelvetType[vtype.name], TV.VelvetCore[core.name], **kw)
    for count in (500, 123):
        _eq(j.generate(count), t.generate(count))


# ---------------------------------------------------------- noise generator


@pytest.mark.parametrize("core", list(JG.NoiseCore), ids=lambda c: c.name)
def test_white_noise_is_exact(core):
    kw = dict(amplitude=0.5, offset=0.01, mls_bits=17, mls_seed=5,
              lcg_seed=9)
    j = JG.NoiseGenerator(SR, JG.NoiseCore[core.name], **kw)
    t = TG.NoiseGenerator(SR, TG.NoiseCore[core.name], device="cpu", **kw)
    js, ts = j.init_state(), t.init_state()
    for count in (700, 301):
        js, jy = j.process(js, count)
        ts, ty = t.process(ts, count)
        _eq(np.asarray(jy), ty)


@pytest.mark.parametrize("color,slope", [
    ("PINK", 0.0), ("RED", 0.0), ("BLUE", 0.0), ("VIOLET", 0.0),
    ("ARBITRARY", -4.5)])
def test_colored_noise_matches_jax(color, slope):
    """The SpectralTilt's sequential cascade (order 16, 10 Hz to 0.9 x
    Nyquist) over the LCG core, two calls with the state carried.  The
    cascade's coefficients and its input are exact, the JAX state carries
    across exactly; the output is held against the float64 cascade on the
    same input: the port no more than 10 dB further from it than the JAX
    package.  Neither float32 cascade comes near 110 dB of the other on
    the falling slopes: poles within ~1e-3 of the unit circle amplify
    each rounding (the JAX package sits 40-56 dB from float64 on pink and
    red, its oracle test documents ~33 dB for the reference's own), and
    the port rounds each product on its own (``biquad_seq``'s pinned
    order) where XLA contracts the scan's products into FMAs."""
    kw = dict(slope_db_oct=slope, coloring_order=16, amplitude=0.5,
              lcg_seed=3)
    j = JG.NoiseGenerator(SR, JG.NoiseCore.LCG, JG.NoiseColor[color], **kw)
    t = TG.NoiseGenerator(SR, TG.NoiseCore.LCG, TG.NoiseColor[color],
                          device="cpu", **kw)
    coeffs = t.tilt.coefficients(device="cpu")
    _eq(np.asarray(j.tilt.coefficients()), coeffs)
    raw = np.asarray(TG.LCG(seed=3).process(2 * 2048)).astype(
        np.float32) * np.float32(0.5)
    c = np.asarray(coeffs, np.float64)
    ref = sosfilt(np.concatenate([c[:, :3], np.ones((len(c), 1)),
                                  -c[:, 3:]], 1), raw.astype(np.float64))
    js, ts = j.init_state(), t.init_state()
    ys = []
    for _ in range(2):
        js, jy = j.process(js, 2048)
        ts, ty = t.process(ts, 2048)
        ys.append((np.asarray(jy), ty.numpy()))
    want = np.concatenate([y[0] for y in ys])
    got = np.concatenate([y[1] for y in ys])
    assert got.dtype == np.float32
    assert _snr(ref, got) >= _snr(ref, want) - 10.0, color
    _eq(np.asarray(js), convert.biquad_state_from_jax(np.asarray(js),
                                                      device="cpu"))


# --------------------------------------------------- device noise and dither


def _moments_ok(v: torch.Tensor, mean: float, var: float):
    """Mean and variance within 4 standard errors of the analytic values
    (the variance's error from the sample's fourth central moment)."""
    n = v.numel()
    v = v.double()
    m4 = float(((v - v.mean()) ** 4).mean())
    assert abs(float(v.mean()) - mean) <= 4 * np.sqrt(var / n)
    assert abs(float(v.var()) - var) <= 4 * np.sqrt((m4 - var * var) / n)


_LAM = JR.RAND_LAMBDA
_EXP_M2 = ((np.exp(2 * _LAM) - 1) / (2 * _LAM) - 2 * np.expm1(_LAM) / _LAM
           + 1) / np.expm1(_LAM) ** 2
# LCG distributions at amplitude a, offset o: (low, high, mean, variance)
_LCG_MOMENTS = {
    "UNIFORM": lambda a, o: (o - a, o + a, o, a * a / 3.0),
    "EXPONENTIAL": lambda a, o: (o - a, o + a, o, a * a * _EXP_M2),
    # 2 a T - 0.5 + o with T triangular on [0, 1], mode 0.5
    "TRIANGULAR": lambda a, o: (o - 0.5, o - 0.5 + 2 * a, a - 0.5 + o,
                                4 * a * a / 24.0),
    "GAUSSIAN": lambda a, o: (-np.inf, np.inf, o, a * a),
}


@pytest.mark.parametrize("dist", list(TLCG.LCGDistribution),
                         ids=lambda d: d.name)
def test_lcg_device_distribution(dist):
    a, o = 0.7, 0.1

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return TLCG.lcg_device(g, (1 << 18,), dist, a, o, device="cpu")

    v = draw(5)
    assert v.dtype == torch.float32 and torch.equal(v, draw(5))
    assert not torch.equal(v, draw(6))
    lo, hi, mean, var = _LCG_MOMENTS[dist.name](a, o)
    assert float(v.min()) >= lo - 1e-6 and float(v.max()) <= hi + 1e-6
    _moments_ok(v, mean, var)


_DRAW = ("import hashlib, torch\n"
         "from lsp_dsp_units_tpu_torch.models.noise import lcg\n"
         "g = torch.Generator().manual_seed(5)\n"
         "v = lcg.lcg_device(g, (1 << 18,), lcg.LCGDistribution.{}, 0.7, "
         "0.1, device='cpu')\n"
         "print(hashlib.sha256(v.numpy().tobytes()).hexdigest())\n")


@pytest.mark.parametrize("dist", list(TLCG.LCGDistribution),
                         ids=lambda d: d.name)
def test_lcg_device_draw_reproducible_in_fresh_processes(dist):
    """A draw is the same in every process: each of six fresh processes
    makes the draw above as its first work (where PyTorch's first
    multi-threaded transcendental call could round one thread's share
    ~1.5e-4 off), and each gets this process's bytes."""
    import hashlib
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _DRAW.format(dist.name)],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300)[0].strip() for p in procs]
    g = torch.Generator().manual_seed(5)
    want = hashlib.sha256(TLCG.lcg_device(
        g, (1 << 18,), dist, 0.7, 0.1, device="cpu").numpy().tobytes()
    ).hexdigest()
    assert all(p.returncode == 0 for p in procs)
    assert outs == [want] * 6, outs


@pytest.mark.parametrize("bits", [8, 16, 24])
def test_dither_device_distribution(bits):
    """TPDF: (u1 + u2 - 1) * delta / 2 with delta = 2^(1 - bits), in
    [-delta / 2, delta / 2], mean 0, variance delta^2 / 24; on a zero
    input, so the sum adds no rounding of its own."""
    x = torch.zeros(1 << 18)

    def draw(seed):
        return TD.dither_device(torch.Generator().manual_seed(seed), x, bits)

    d = draw(11)
    assert d.dtype == torch.float32 and torch.equal(d, draw(11))
    delta = 1.0 / (1 << (bits - 1))
    assert float(d.abs().max()) <= 0.5 * delta
    _moments_ok(d, 0.0, delta * delta / 24.0)
    assert TD.dither_device(torch.Generator(), x, 0) is x


# ----------------------------------------------------- quickmath, LFO, sigmoid

_RNG = np.random.default_rng(0)
_X = np.concatenate([_RNG.uniform(-2.0, 2.0, 20000),
                     np.linspace(-1.6, 1.6, 4001)]).astype(np.float32)
_PHASE = np.concatenate([_RNG.uniform(0.0, 1.0, 20000),
                         np.linspace(0.0, 1.0, 4097)[:-1]]).astype(np.float32)
_SIG_X = np.concatenate([_RNG.uniform(-10.0, 10.0, 20000),
                         _RNG.standard_normal(20000)]).astype(np.float32)


@pytest.mark.parametrize("name,lo,hi", [
    ("quick_sinf", -2.0, 2.0), ("quick_cosf", -2.0, 2.0),
    ("quick_logf", 1e-6, 1e4), ("quick_log2f", 1e-6, 1e4),
    ("quick_expf", -20.0, 20.0)])
def test_quickmath_is_exact(name, lo, hi):
    x = np.random.default_rng(1).uniform(lo, hi, 50000).astype(np.float32)
    _eq(np.asarray(getattr(JQ, name)(jnp.asarray(x))),
        getattr(TQ, name)(torch.from_numpy(x)))


_LFO_TRANSCENDENTAL = ("sine", "step_sine", "logarithmic", "rev_logarithmic")


@pytest.mark.parametrize("name", list(JL.FUNCTIONS))
def test_lfo_shapes(name):
    ph = torch.from_numpy(_PHASE)
    want = np.asarray(JL.FUNCTIONS[name](jnp.asarray(_PHASE)))
    got = TL.FUNCTIONS[name](ph)
    if name in _LFO_TRANSCENDENTAL:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
        _eq(np.asarray(JL.FUNCTIONS[name](jnp.asarray(_PHASE), quick=True)),
            TL.FUNCTIONS[name](ph, quick=True))
    else:
        _eq(want, got)


_SIG_EXACT = ("hard_clip", "quadratic", "hyperbolic", "smoothstep",
              "smootherstep", "circle")


@pytest.mark.parametrize("name", list(JS.FUNCTIONS))
def test_sigmoids(name):
    want = np.asarray(JS.FUNCTIONS[name](jnp.asarray(_SIG_X)))
    got = TS.FUNCTIONS[name](torch.from_numpy(_SIG_X))
    if name in _SIG_EXACT:
        _eq(want, got)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_sqrt_rn_is_correctly_rounded():
    x = _RNG.uniform(0.0, 4.0, 100000).astype(np.float32)
    _eq(np.sqrt(x), TQ.sqrt_rn(torch.from_numpy(x)))


@pytest.mark.parametrize("n", [1, 16, 17, 128, 1000, 5000])
def test_xla_cumsum_is_jnp_cumsum(n):
    """XLA on the CPU sums jnp.cumsum in chunks of 16 (its reduce-window
    rewrite); xla_cumsum repeats that order bit for bit."""
    x = np.random.default_rng(n).standard_normal((3, n)).astype(np.float32)
    _eq(np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1)),
        sliding.xla_cumsum(torch.from_numpy(x)))


# ------------------------------------------------------------------ ADSR


@pytest.mark.parametrize("curve", [0.1, 0.5, 0.85])
@pytest.mark.parametrize("shape", ["adsr", "ahdbssr"])
@pytest.mark.parametrize("func", list(JA.ADSRFunction), ids=lambda f: f.name)
def test_adsr_matches_jax(func, shape, curve):
    kw = dict(curve=curve, attack_func=func, decay_func=func,
              slope_func=func, release_func=func)
    if shape == "ahdbssr":
        kw.update(hold=0.2, break_level=0.7, slope=0.6)
    j = JA.ADSREnvelope(**kw)
    t = TA.ADSREnvelope(**{k: (TA.ADSRFunction[v.name]
                               if isinstance(v, JA.ADSRFunction) else v)
                           for k, v in kw.items()})
    tt = np.concatenate([np.linspace(-0.1, 1.1, 3001),
                         _PHASE[:3000]]).astype(np.float32)
    want = np.asarray(j.process(jnp.asarray(tt)))
    got = t.process(torch.from_numpy(tt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    x = _X[:tt.size]
    np.testing.assert_allclose(
        t.process_mul(torch.from_numpy(tt), torch.from_numpy(x)).numpy(),
        np.asarray(j.process_mul(jnp.asarray(tt), jnp.asarray(x))),
        rtol=0, atol=1e-6)


# ------------------------------------------------------------- Oscillator

# the JAX oracle test's settings (tests/test_reference_oracle_wave3.py)
_OSC = dict(frequency=441.7, amplitude=0.8, dc_offset=0.1, initial_phase=0.7,
            duty_ratio=0.3, width=0.65, raise_ratio=0.2, fall_ratio=0.35,
            pos_width_ratio=0.3, neg_width_ratio=0.45, parabolic_width=0.6,
            oversampling=8, quality="16bit")


def _osc_pair(fg: str, dc_ref: str = "WAVEDC"):
    return (JO.Oscillator(SR, JO.FunctionGenerator[fg],
                          dc_reference=JO.DCReference[dc_ref], **_OSC),
            TO.Oscillator(SR, TO.FunctionGenerator[fg],
                          dc_reference=TO.DCReference[dc_ref],
                          device="cpu", **_OSC))


@pytest.mark.parametrize("fg,dc_ref", [
    *((f.name, "WAVEDC") for f in JO.FunctionGenerator),
    *((f, "ZERO") for f in ("SQUARED_SINE", "RECTANGULAR", "PULSETRAIN",
                            "PARABOLIC"))])
def test_oscillator_matches_jax(fg, dc_ref):
    """Two calls of 1024 (the band-limited ones decimate 8 x 1024)."""
    j, t = _osc_pair(fg, dc_ref)
    js, ts = j.init_state(), t.init_state()
    assert int(ts.phase) == int(np.asarray(js.phase))
    ys = []
    for count in (1024, 1024):
        js, jy = j.process(js, count)
        ts, ty = t.process(ts, count)
        assert int(ts.phase) == int(np.asarray(js.phase))
        ys.append((np.asarray(jy), ty.numpy()))
    want = np.concatenate([y[0] for y in ys])
    got = np.concatenate([y[1] for y in ys])
    assert got.dtype == np.float32
    bar = 110.0 if fg.startswith("BL_") else 120.0
    assert _snr(want, got) >= bar, fg


@pytest.mark.parametrize("fg", ["SAWTOOTH", "BL_TRAPEZOID"])
def test_oscillator_state_from_jax(fg):
    """The JAX state carried across mid-stream (the uint32 phase word, the
    BL modes' Oversampler state), then one more call on each side."""
    j, t = _osc_pair(fg)
    js = j.init_state()
    for _ in range(3):
        js, _ = j.process(js, 1024)
    ts = convert.oscillator_state_from_jax(
        type(js)(np.asarray(js.phase),
                 js.ovs if js.ovs == () else type(js.ovs)(
                     *(np.asarray(v) for v in js.ovs))), device="cpu")
    js, jy = j.process(js, 1024)
    ts, ty = t.process(ts, 1024)
    assert int(ts.phase) == int(np.asarray(js.phase))
    assert _snr(np.asarray(jy), ty.numpy()) >= 110.0
