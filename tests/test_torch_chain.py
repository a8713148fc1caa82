"""The ported slice as a whole: ``FilterConvChain.step_ring`` of the
port against the JAX package's on the same params and state (carried
across by lsp_dsp_units_tpu_torch.convert), both against the float64
ideal of benchmarks/chain_golden64.py; int16 delivery; the port's
isolation from JAX; and the kernel build's refusal to fall back."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks.chain_golden64 import golden_chain_f64
from lsp_dsp_units_tpu import pipeline as jpipe
from lsp_dsp_units_tpu.utils import delivery as jdel

from lsp_dsp_units_tpu_torch import convert
from lsp_dsp_units_tpu_torch import pipeline as tpipe
from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops import fft_packed as tfft
from lsp_dsp_units_tpu_torch.utils import delivery as tdel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _snr(ref, out):
    ref = np.asarray(ref, np.float64)
    err = np.asarray(out, np.float64) - ref
    return 10 * np.log10(max(np.sum(ref ** 2), 1e-30)
                         / max(np.sum(err ** 2), 1e-30))


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.mark.parametrize("rank", [9, 10])
def test_step_ring_matches_jax(rank):
    c, warm, n_blocks = 4, 2, 12
    jchain = jpipe.FilterConvChain(48000, c, rank=rank, ir_seconds=0.05)
    tchain = tpipe.FilterConvChain(48000, c, rank=rank, ir_seconds=0.05,
                                   device="cpu")
    np.testing.assert_array_equal(jchain.ir, tchain.ir)
    jp = jchain.build()
    tp = convert.params_from_jax(_np_tree(jp), device="cpu")
    # the port's own build agrees with the carried-over params
    own = tchain.build()
    for f in own.eq_block._fields:
        np.testing.assert_array_equal(getattr(own.eq_block, f).numpy(),
                                      getattr(tp.eq_block, f).numpy())
    assert _snr(tp.h_spectra.re, own.h_spectra.re) >= 120.0
    assert own.comp == tp.comp

    rng = np.random.default_rng(rank)
    xs = [(rng.standard_normal((c, jchain.block)) * 0.25).astype(np.float32)
          * (1.0 + (k % 3)) for k in range(warm + n_blocks)]
    jst = jchain.init_ring_state(jp)
    for x in xs[:warm]:
        jst, _ = jchain.step_ring(jp, jst, jnp.asarray(x))
    tst = convert.ring_state_from_jax(_np_tree(jst), device="cpu")

    gold = golden_chain_f64(tchain, tp, xs)
    for k, x in enumerate(xs[warm:]):
        jst, jy = jchain.step_ring(jp, jst, jnp.asarray(x))
        tst, ty = tchain.step_ring(tp, tst, torch.from_numpy(x))
        assert _snr(jy, ty) >= 100.0, k
        g = gold[warm + k]
        assert _snr(g, ty) >= _snr(g, jy) - 1.0, k
    assert tst.fdl.pos == int(jst.fdl.pos)
    ring = convert.ring_from_natural(np.asarray(jst.fdl.spec_re),
                                     np.asarray(jst.fdl.spec_im),
                                     device="cpu")
    assert _snr(ring[0], tst.fdl.spec_re) >= 100.0
    np.testing.assert_allclose(tst.env.envelope.numpy(),
                               np.asarray(jst.env.envelope), rtol=1e-4)


def test_delivery_exact():
    c, t = 3, 256
    jt = np.asarray(jdel.tpdf_i16_table(c, t))
    tt = tdel.tpdf_i16_table(c, t, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), jt)
    rng = np.random.default_rng(8)
    for k in (0, 5, 70000):
        y = (rng.standard_normal((c, t)) * 0.6).astype(np.float32)
        jq = np.asarray(jdel.quantize_i16(jnp.asarray(y), jnp.asarray(jt),
                                          jnp.uint32(k)))
        tq = tdel.quantize_i16(torch.from_numpy(y), tt, k)
        assert tq.dtype == torch.int16
        np.testing.assert_array_equal(tq.numpy(), jq)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import lsp_dsp_units_tpu_torch.pipeline\n"
            "import lsp_dsp_units_tpu_torch.convert\n"
            "import lsp_dsp_units_tpu_torch.entry\n"
            "import lsp_dsp_units_tpu_torch.models.dynamics.gate\n"
            "import lsp_dsp_units_tpu_torch.models.dynamics.expander\n"
            "import lsp_dsp_units_tpu_torch.models.sampling\n"
            "import lsp_dsp_units_tpu_torch.models.sampling.device_mix\n"
            "import lsp_dsp_units_tpu_torch.models.util\n"
            "import lsp_dsp_units_tpu_torch.ops.resample\n"
            "import lsp_dsp_units_tpu_torch.utils.blocks\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'lsp_dsp_units_tpu')]\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    pkg = os.path.join(ROOT, "lsp_dsp_units_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, n) for n in files if n.endswith(".py")]
    for name in paths:
        with open(name) as f:
            src = f.read()
        assert "import jax" not in src and "from jax" not in src, name
        assert "import lsp_dsp_units_tpu\n" not in src, name
        assert "from lsp_dsp_units_tpu." not in src, name


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    with pytest.raises(RuntimeError, match="no fallback"):
        _build.build("fft_packed")
    assert not (tmp_path / "build").exists()


def test_kernel_sources_cover_wrappers():
    """Every C entry point a wrapper declares exists in csrc/."""
    from lsp_dsp_units_tpu_torch.ops import (env, env_units, fdl_fused,
                                             ring_mac, slicedma)
    src = ""
    for name in os.listdir(_build.CSRC_DIR):
        with open(os.path.join(_build.CSRC_DIR, name)) as f:
            src += f.read()
    for sigs in (tfft._SIGS, fdl_fused._SIGS, env._SIGS, env_units._SIGS,
                 ring_mac._SIGS, slicedma._SIGS):
        for fn in sigs:
            assert f"int {fn}(" in src, fn
