"""The port's sampler against the JAX package: the plain batched slice
(ops/slicedma.py) against ``batched_slice`` in interpret mode, the device
mixdown (models/sampling/device_mix.py) against the JAX package's and
against the host SamplePlayer, the host modules (Sample, SamplePlayer,
InSampleStream, wavio, fade, resample) against the JAX package's, and
JAX voice tables carried across (convert.voices_from_jax).

Bars: the slice and the host modules are exact (the same copy or the
same numpy arithmetic); ``mix_block_dma`` is exact against ``mix_block``
(the same values through the same routing product); the mixdown against
the JAX package and against the host player within atol 2e-6, the JAX
package's own bar (its routing product sums in another order);
``resample.upsample`` within 1e-6.  The CUDA kernel against its plain
version: tests/test_torch_cuda.py."""

import dataclasses
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from lsp_dsp_units_tpu.models.misc import fade as jfade
from lsp_dsp_units_tpu.models.sampling import device_mix as jdm
from lsp_dsp_units_tpu.models.sampling import player as jplayer
from lsp_dsp_units_tpu.models.sampling import sample as jsample
from lsp_dsp_units_tpu.models.sampling import stream as jstream
from lsp_dsp_units_tpu.ops import resample as jrs
from lsp_dsp_units_tpu.ops.slicedma import batched_slice as jbatched_slice
from lsp_dsp_units_tpu.utils import wavio as jwavio

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch.models import sampling as tsampling
from lsp_dsp_units_tpu_torch.models.misc import fade as tfade
from lsp_dsp_units_tpu_torch.models.sampling import device_mix as tdm
from lsp_dsp_units_tpu_torch.ops import resample as trs
from lsp_dsp_units_tpu_torch.ops.slicedma import (batched_slice,
                                                  batched_slice_plain)
from lsp_dsp_units_tpu_torch.utils import wavio as twavio


def _noise(rng, n, scale=0.25):
    return (rng.normal(size=n) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# kernel #8: the batched slice
# ---------------------------------------------------------------------------


def test_batched_slice_plain_matches_jax():
    """V = 13 (not a multiple of 8); starts at the edges of the JAX
    kernel's 128-lane rows and 1024-sample tiles, at the clamp limit, and
    beyond both ends (clamped)."""
    rng = np.random.default_rng(3)
    n, size = 8192, 256
    lim = n - size - 1024
    bank = _noise(rng, n)
    starts = np.array([0, 1, 127, 128, 1023, 1024, lim, lim - 1, 4097,
                       -5, lim + 300, 77, 2049], np.int32)
    want = np.asarray(jbatched_slice(jnp.asarray(bank), jnp.asarray(starts),
                                     size, interpret=True))
    got = batched_slice(torch.from_numpy(bank), torch.from_numpy(starts),
                        size)
    assert got.shape == (13, size)
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(got[0].numpy(), bank[:size])
    np.testing.assert_array_equal(got[9].numpy(), bank[:size])     # < 0
    np.testing.assert_array_equal(got[10].numpy(), bank[lim:lim + size])


@pytest.mark.parametrize("n,size,match", [(8192, 100, "multiples"),
                                          (8000, 256, "multiples"),
                                          (1024, 256, "at least")])
def test_batched_slice_contract(n, size, match):
    with pytest.raises(ValueError, match=match):
        batched_slice_plain(torch.zeros(n), torch.zeros(3, dtype=torch.int32),
                            size)


# ---------------------------------------------------------------------------
# the device mixdown
# ---------------------------------------------------------------------------


def _dma_case():
    """tests/test_sampling.py::test_device_mix_dma_matches_gather's
    configuration: 16 voices, 3 channels, 2 samples."""
    rng = np.random.default_rng(7)
    d0, d1 = _noise(rng, 40000), _noise(rng, 30000)
    specs = [dict(sample_id=v % 2, channel=v % 3,
                  volume=0.05 + 0.01 * v, delay=(v * 211) % 3000,
                  loop=(v % 3 == 0), loop_start=500, loop_end=20000)
             for v in range(16)]
    return [d0, d1], specs, 3, [40000, 30000], 512


def test_mix_block_dma_matches_gather():
    samples, specs, ch, lens, block = _dma_case()
    bank, bank_len = tdm.build_bank(samples, device="cpu")
    bank_p, bank_len2, pad = tdm.build_bank_padded(samples, block,
                                                   device="cpu")
    assert bank_len == bank_len2 and pad == block
    assert bank_p.shape[0] % 128 == 0
    voices, st_a = tdm.build_voices(specs, ch, lens, device="cpu")
    assert voices.min_loop_span == 19500
    st_b = st_a
    for b in range(60):
        st_a, ya = tdm.mix_block(bank, bank_len, voices, st_a, block)
        st_b, yb = tdm.mix_block_dma(bank_p, bank_len, pad, voices, st_b,
                                     block)
        assert torch.equal(ya, yb), b
        assert torch.equal(st_a.pos, st_b.pos), b
    assert ya.shape == (ch, block) and bool(ya.abs().max() > 0)


def test_mix_block_dma_scope_checked_at_build():
    _, specs, ch, lens, block = _dma_case()
    specs[3] = dict(specs[3], loop=True, loop_start=500, loop_end=900)
    voices, st = tdm.build_voices(specs, ch, lens, device="cpu")
    assert voices.min_loop_span == 400
    bank_p, bank_len, pad = tdm.build_bank_padded(
        [np.zeros(40000, np.float32)] * 2, block, device="cpu")
    with pytest.raises(ValueError, match="span"):
        tdm.mix_block_dma(bank_p, bank_len, pad, voices, st, block)
    with pytest.raises(ValueError, match="pad"):
        tdm.mix_block_dma(bank_p, bank_len, block // 2, voices, st, block)


@pytest.mark.parametrize("path", ["gather", "dma"])
def test_mix_block_matches_jax(path):
    samples, specs, ch, lens, block = _dma_case()
    jbank, jlen = jdm.build_bank(samples)
    jvoices, jst = jdm.build_voices(specs, ch, lens)
    if path == "gather":
        bank, _ = tdm.build_bank(samples, device="cpu")
    else:
        bank, _, pad = tdm.build_bank_padded(samples, block, device="cpu")
    voices, st = tdm.build_voices(specs, ch, lens, device="cpu")
    for b in range(24):
        jst, jy = jdm.mix_block(jbank, jlen, jvoices, jst, block)
        if path == "gather":
            st, y = tdm.mix_block(bank, jlen, voices, st, block)
        else:
            st, y = tdm.mix_block_dma(bank, jlen, pad, voices, st, block)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-6)
        np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))


def _player_case(pkg_sample, pkg_player):
    """tests/test_sampling.py::test_device_mix_matches_host_player's
    configuration: 24 mono voices over 2 samples."""
    rng = np.random.default_rng(11)
    n0, n1 = 3000, 2200
    s0 = pkg_sample.Sample(1, 48000, n0)
    s0.data = rng.normal(size=(1, n0)).astype(np.float32) * 0.25
    s1 = pkg_sample.Sample(1, 48000, n1)
    s1.data = rng.normal(size=(1, n1)).astype(np.float32) * 0.25
    specs = [dict(sample_id=v % 2, channel=0, volume=0.05 + 0.01 * v,
                  delay=(v * 37) % 900, loop=v % 3 == 0, loop_start=250,
                  loop_end=1800) for v in range(24)]
    player = pkg_player.SamplePlayer(max_samples=2, max_playbacks=64)
    player.bind(0, s0)
    player.bind(1, s1)
    for s in specs:
        player.play(pkg_player.PlaySettings(
            sample_id=s["sample_id"], channel=s["channel"],
            volume=s["volume"], delay=s["delay"],
            loop_mode=(pkg_player.LoopMode.DIRECT if s["loop"]
                       else pkg_player.LoopMode.NONE),
            loop_start=s["loop_start"], loop_end=s["loop_end"],
            xfade_length=0))
    return [s0.data[0], s1.data[0]], specs, [n0, n1], player


def test_mix_block_matches_host_player():
    samples, specs, lens, player = _player_case(tsampling, tsampling)
    bank, bank_len = tdm.build_bank(samples, device="cpu")
    voices, st = tdm.build_voices(specs, 1, lens, device="cpu")
    block = 512
    for b in range(8):
        host = player.process(block)
        st, y = tdm.mix_block(bank, bank_len, voices, st, block)
        np.testing.assert_allclose(y[0].numpy(), host, atol=2e-6)


def test_voices_from_jax_mid_stream():
    """Both packages run on from a JAX voice table and playheads taken
    after 10 blocks."""
    samples, specs, ch, lens, block = _dma_case()
    jbank, jlen = jdm.build_bank(samples)
    jvoices, jst = jdm.build_voices(specs, ch, lens)
    for _ in range(10):
        jst, _ = jdm.mix_block(jbank, jlen, jvoices, jst, block)
    voices, st = convert.voices_from_jax(
        jdm.DeviceVoices(*(np.asarray(v) for v in jvoices)),
        jdm.DeviceMixState(np.asarray(jst.pos)), device="cpu")
    assert voices.min_loop_span == 19500
    bank_p, _, pad = tdm.build_bank_padded(samples, block, device="cpu")
    for b in range(10):
        jst, jy = jdm.mix_block(jbank, jlen, jvoices, jst, block)
        st, y = tdm.mix_block_dma(bank_p, jlen, pad, voices, st, block)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=2e-6)
    np.testing.assert_array_equal(st.pos.numpy(), np.asarray(jst.pos))


def test_route_mix_ignores_tf32():
    rng = np.random.default_rng(2)
    route = torch.from_numpy((rng.random((3, 40)) > 0.5).astype(np.float32))
    vals = torch.from_numpy(_noise(rng, (40, 64)))
    want = (route.double() @ vals.double()).float()
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        assert torch.equal(tdm.route_mix(route, vals), want)
    finally:
        torch.set_float32_matmul_precision(prev)


# ---------------------------------------------------------------------------
# host modules: the same numpy arithmetic as the JAX package's
# ---------------------------------------------------------------------------


def _both_samples(data, sr=48000):
    out = []
    for pkg in (jsample, tsampling):
        s = pkg.Sample(data.shape[0], data.shape[1], sr)
        s.data = data.copy()
        out.append(s)
    return out


_EDITS = [
    ("resize_grow", lambda s, m: s.resize(700)),
    ("resize_cut", lambda s, m: s.resize(300)),
    ("append", lambda s, m: s.append(np.ones((2, 20), np.float32))),
    ("prepend", lambda s, m: s.prepend(13)),
    ("insert", lambda s, m: s.insert(100, 7)),
    ("cut", lambda s, m: s.cut(50, 90)),
    ("set_channels", lambda s, m: s.set_channels(3)),
    ("gain", lambda s, m: s.apply_gain(0.37, 10, 200)),
    ("reverse", lambda s, m: s.reverse()),
    ("reverse_ch", lambda s, m: s.reverse(1)),
    ("fade_in", lambda s, m: s.fade_in(111)),
    ("fade_out", lambda s, m: s.fade_out(97)),
    ("fade_after_reverse", lambda s, m: s.reverse().fade_in(50)),
    ("normalize", lambda s, m: s.normalize(0.5)),
    ("normalize_above", lambda s, m: s.normalize(
        0.5, m.SampleNormalize.ABOVE)),
    ("normalize_below", lambda s, m: s.normalize(
        5.0, m.SampleNormalize.BELOW)),
    ("stretch_linear", lambda s, m: s.stretch(
        900, fade_type=m.SampleCrossfade.LINEAR)),
    ("stretch_const_power", lambda s, m: s.stretch(380, start=20, end=500)),
    ("stretch_two_chunks", lambda s, m: s.stretch(560, chunk_size=300)),
    ("stretch_resample", lambda s, m: s.stretch_resample(800, 10, 400)),
    ("resample_up", lambda s, m: s.resample(96000)),
    ("resample_up_fraction", lambda s, m: s.resample(44100 * 2)),
    ("resample_down_integer", lambda s, m: s.resample(24000)),
    ("resample_down_fraction", lambda s, m: s.resample(44100)),
]


@pytest.mark.parametrize("name,edit", _EDITS, ids=[e[0] for e in _EDITS])
def test_sample_edits_match_jax(name, edit):
    rng = np.random.default_rng(sum(map(ord, name)))
    data = (rng.normal(size=(2, 600)) * 0.3).astype(np.float32)
    js, ts = _both_samples(data)
    edit(js, jsample)
    edit(ts, tsampling)
    assert ts.sample_rate == js.sample_rate
    assert ts.data.dtype == np.float32
    np.testing.assert_array_equal(ts.data, js.data)


def test_sample_save_load_and_stream_match_jax(tmp_path):
    rng = np.random.default_rng(8)
    data = (rng.normal(size=(2, 1000)) * 0.3).astype(np.float32)
    js, ts = _both_samples(data, 44100)
    tpath = str(tmp_path / "t.wav")
    ts.save(tpath)
    back = jsample.Sample.load(tpath)
    np.testing.assert_array_equal(back.data, data)
    assert back.sample_rate == 44100
    assert ts.save_range(str(tmp_path / "r.wav"), 100, 300) == 300
    np.testing.assert_array_equal(
        tsampling.Sample.load(str(tmp_path / "r.wav")).data,
        data[:, 100:400])
    jin = jstream.InSampleStream(js)
    tin = tsampling.InSampleStream(ts, delete_on_close=True)
    assert (tin.sample_rate, tin.channels, tin.length) == (44100, 2, 1000)
    for op in (lambda s: s.read(333), lambda s: s.seek(900),
               lambda s: s.read(333), lambda s: s.seek(-4),
               lambda s: s.read(10)):
        np.testing.assert_array_equal(op(tin), op(jin))
        assert tin.position == jin.position and tin.eof() == jin.eof()
    tin.seek(1000)
    assert tin.eof()
    tin.close()


@pytest.mark.parametrize("float32", [True, False])
def test_wavio_matches_jax(tmp_path, float32):
    rng = np.random.default_rng(9)
    data = np.clip(rng.normal(size=(3, 500)) * 0.4, -1, 1).astype(np.float32)
    for writer, reader in ((twavio, jwavio), (jwavio, twavio)):
        p = str(tmp_path / f"{writer.__name__.split('.')[0]}.wav")
        writer.write_wav(p, data, 48000, float32=float32)
        got, sr = reader.read_wav(p)
        want, _ = jwavio.read_wav(p)
        assert sr == 48000
        np.testing.assert_array_equal(got, want)
    mono = str(tmp_path / "mono.wav")
    twavio.write_audio(mono, data[0], 22050)
    got, sr = twavio.read_audio(mono)
    assert sr == 22050 and got.shape == (1, 500)
    with open(mono, "rb") as f:
        raw = f.read()
    with open(mono, "wb") as f:
        f.write(b"JUNK" + raw[4:])
    with pytest.raises(ValueError, match="RIFF"):
        twavio.read_wav(mono)
    assert twavio.have_soundfile() == jwavio.have_soundfile()


def _player_scenario(pkg_sample, pkg_player):
    """Every loop mode, crossfades of both laws, reverse playback, stop
    and cancel, the passthrough source and the bank limit."""
    rng = np.random.default_rng(17)
    s0 = pkg_sample.Sample(2, 4000, 48000)
    s0.data = (rng.normal(size=(2, 4000)) * 0.3).astype(np.float32)
    s1 = pkg_sample.Sample(1, 2500, 48000)
    s1.data = (rng.normal(size=(1, 2500)) * 0.3).astype(np.float32)
    player = pkg_player.SamplePlayer(max_samples=2, max_playbacks=32)
    player.bind(0, s0)
    player.bind(1, s1)
    player.set_gain(0.8)
    pbs = []
    for i, mode in enumerate(pkg_player.LoopMode):
        for rev in (False, True):
            pbs.append(player.play(pkg_player.PlaySettings(
                sample_id=i % 2, channel=i % 2, volume=0.1 + 0.02 * i,
                delay=(i * 53) % 300, start=(i * 97) % 600,
                loop_start=700 + 10 * i, loop_end=1900 - 20 * i,
                loop_mode=mode, reverse=rev,
                xfade_type=(pkg_player.XFadeType.CONST_POWER if i % 2
                            else pkg_player.XFadeType.LINEAR),
                xfade_length=40 * (i % 3))))
    src = (rng.normal(size=256) * 0.1).astype(np.float32)
    outs = []
    for b in range(40):
        if b == 8:
            pbs[2].stop()
            pbs[5].stop(100)
        if b == 12:
            pbs[7].cancel(fadeout=200, delay=30)
            pbs[9].cancel()
        outs.append(player.process(256, src if b % 5 == 0 else None))
    outs.append(np.array([len(player.playbacks), player.stop()]))
    with pytest.raises(ValueError, match="bank full"):
        player.bind(5, s1)
    return outs, [dataclasses.astuple(pb.settings)[:7] for pb in pbs]


def test_sample_player_matches_jax():
    jouts, jset = _player_scenario(jsample, jplayer)
    touts, tset = _player_scenario(tsampling, tsampling)
    assert tset == jset
    assert len(touts) == len(jouts)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_array_equal(t, j, err_msg=str(k))
    assert any(np.abs(o).max() > 0 for o in touts[:-1])


@pytest.mark.parametrize("n", [0, 1, 64, 500])
def test_fade_matches_jax(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=(2, 300))).astype(np.float32)
    for jf, tf in ((jfade.fade_in, tfade.fade_in),
                   (jfade.fade_out, tfade.fade_out)):
        np.testing.assert_array_equal(
            tf(torch.from_numpy(x), n).numpy(), np.asarray(jf(x, n)))


@pytest.mark.parametrize("ratio,lobes", [(2, 2), (3, 3), (4, 10), (8, 4)])
def test_upsample_matches_jax(ratio, lobes):
    rng = np.random.default_rng(ratio * 100 + lobes)
    jh = jrs.upsample_history(lobes, (2,))
    th = trs.upsample_history(lobes, (2,), device="cpu")
    assert th.shape == jh.shape
    np.testing.assert_array_equal(trs.lanczos_kernel(ratio, lobes),
                                  jrs.lanczos_kernel(ratio, lobes))
    for k in range(3):
        x = (rng.normal(size=(2, 96)) * 0.5).astype(np.float32)
        jh, jy = jrs.upsample(jh, jnp.asarray(x), ratio, lobes)
        th, ty = trs.upsample(th, torch.from_numpy(x), ratio, lobes)
        assert ty.shape == (2, 96 * ratio)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-6)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(
        trs.downsample(torch.from_numpy(x), ratio).numpy(),
        np.asarray(jrs.downsample(jnp.asarray(x), ratio)))
    assert trs.oversample_rates() == jrs.oversample_rates()
    assert trs.QUALITY_LOBES == jrs.QUALITY_LOBES


@pytest.mark.parametrize("rates", [(48000, 44100), (44100, 48000),
                                   (48000, 48000)])
def test_resample_fractional_matches_jax(rates):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 400))
    np.testing.assert_array_equal(trs.resample_fractional(x, *rates),
                                  jrs.resample_fractional(x, *rates))


def test_sampling_exports():
    names = {"Sample", "SampleNormalize", "SampleCrossfade", "SamplePlayer",
             "PlaySettings", "Playback", "LoopMode", "XFadeType",
             "InSampleStream"}
    assert names <= set(dir(tsampling))
    assert os.path.basename(tsampling.__file__) == "__init__.py"
