"""Fused dynamics tail: the port of ops/pallas_env.py::chain_dyn_pallas.

Sidechain sliding RMS over a carried window of squared detector samples
-> compressor peak-hold envelope (with release threshold) -> two-knee
gain -> ``y = x * gain``, on [C, T] blocks.  :func:`chain_dyn` runs
:func:`chain_dyn_plain` (the staged plain ops: sliding_sum ->
peak_envelope_plain -> compressor_x2_gain) for CPU tensors and the CUDA
kernel (``csrc/env.cu``) for CUDA tensors, counting launches in
``chain_dyn.launches``.

Tolerance between the two: the kernel forms the rolling sum in float64,
as the window's sum plus a scan of per-sample (new - old) squares carried
from chunk to chunk, the plain version as a difference of two-level
float32 prefix sums.  That is a rounding difference in the level; the
envelope step itself is the plain version's, bit for bit (both round
``e + tau * d`` once).  The output agrees to >= 110 dB and the carried
window, envelope and peak to ~1e-5 relative; hold counts are exact.

Gradients: under autograd (grad mode on, and the window, the envelope
state, x, a tau, the release threshold or a knee field a tensor that
requires grad) :func:`chain_dyn` runs as a ``torch.autograd.Function``
whose forward is the route above and whose backward is
:func:`chain_dyn_bwd`: the adjoints of the gain and the apply, of the
envelope (ops/env_units.peak_envelope_bwd_plain's recurrence) and of
the sliding RMS (sliding_rms_bwd_plain's), in that order.  The release
threshold and the hold only steer branches (zero gradient); the
sidechain gain is a constant.  The forward saves its level and
envelope for the backward (on the card ``chain_dyn_save_kernel``: kernel
#3 writing both besides).  For CPU tensors the plain backward
(:func:`chain_dyn_bwd_plain`, the gain's adjoint by autograd over
compressor_x2_gain); for CUDA tensors the kernel ``chain_dyn_bwd`` of
``csrc/env.cu`` from the saved level and envelope (branch codes, the
gain's adjoint, the reverse pass, the RMS's adjoint).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.dynamics import (
    CompKnee, EnvState, compressor_x2_gain, peak_envelope_plain)
from lsp_dsp_units_tpu_torch.ops.env_units import (peak_envelope_bwd_plain,
                                                   sliding_rms_bwd_plain)
from lsp_dsp_units_tpu_torch.ops.sliding import sliding_sum


class _Knee(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in CompKnee._fields]


class _DynParams(ctypes.Structure):
    _fields_ = [("g", ctypes.c_float), ("ta", ctypes.c_float),
                ("tr", ctypes.c_float), ("rt", ctypes.c_float),
                ("inv_n", ctypes.c_float), ("nh", ctypes.c_int),
                ("k0", _Knee), ("k1", _Knee)]


_SIGS = {"lsp_chain_dyn": [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
         + [_DynParams, ctypes.c_void_p],
         "lsp_chain_dyn_save": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3
         + [_DynParams, ctypes.c_void_p],
         "lsp_chain_dyn_bwd": [ctypes.c_void_p] * 21 + [ctypes.c_int] * 3
         + [_DynParams, ctypes.c_void_p]}

# the knee fields' gradients: 2 knees x 8 fields (start and end only steer
# branches: zero)
N_KNEE = 2 * len(CompKnee._fields)


def _chain_dyn_plain(window, env_state: EnvState, x, n_win: int, sc_gain,
                     tau_attack, tau_release, release_thresh, hold_samples,
                     knees: Tuple[CompKnee, CompKnee]):
    """:func:`chain_dyn_plain` and its level and envelope [C, T]."""
    v = torch.abs(x) * sc_gain
    frame = torch.cat([window, v * v], dim=-1)
    rsum = sliding_sum(frame, n_win, x.shape[-1])
    level = torch.sqrt(torch.clamp(rsum / n_win, min=0.0))
    env_st, env = peak_envelope_plain(env_state, level, tau_attack,
                                      tau_release, hold_samples,
                                      release_thresh)
    y = x * compressor_x2_gain(knees, env)
    return frame[..., -n_win:].contiguous(), env_st, y, level, env


def chain_dyn_plain(window, env_state: EnvState, x, n_win: int, sc_gain,
                    tau_attack, tau_release, release_thresh, hold_samples,
                    knees: Tuple[CompKnee, CompKnee]):
    """Plain PyTorch version of :func:`chain_dyn` (same contract)."""
    return _chain_dyn_plain(window, env_state, x, n_win, sc_gain,
                            tau_attack, tau_release, release_thresh,
                            hold_samples, knees)[:3]


def _params(n_win, sc_gain, tau_attack, tau_release, release_thresh,
            hold_samples, knees) -> _DynParams:
    return _DynParams(g=float(sc_gain), ta=float(tau_attack),
                      tr=float(tau_release), rt=float(release_thresh),
                      inv_n=1.0 / int(n_win), nh=int(hold_samples),
                      k0=_Knee(*map(float, knees[0])),
                      k1=_Knee(*map(float, knees[1])))


def chain_dyn(window, env_state: EnvState, x, n_win: int, sc_gain,
              tau_attack, tau_release, release_thresh, hold_samples,
              knees: Tuple[CompKnee, CompKnee]):
    """Dynamics tail of one block.  ``window`` [C, N] carried squared
    detector samples, ``x`` [C, T] (T >= N), scalars as host numbers (or
    0-d tensors).
    Returns (window' [C, N], EnvState', y [C, T]).  Differentiable in the
    window, the envelope and peak, x, the taus and the knee fields; the
    release threshold and the hold get zero gradient."""
    e, p, h = env_state
    if _build.needs_grad(window, e, p, x, tau_attack, tau_release,
                         release_thresh, knees):
        _build.no_grad_route("chain_dyn's sidechain gain", sc_gain)
        win, e2, p2, h2, y = _ChainDyn.apply(
            window, e, p, h, x, n_win, sc_gain, tau_attack, tau_release,
            release_thresh, hold_samples, *knees[0], *knees[1])
        return win, env_state._make((e2, p2, h2)), y
    return _chain_dyn(window, env_state, x, n_win, sc_gain, tau_attack,
                      tau_release, release_thresh, hold_samples, knees)


def _check_dyn(window, env_state, x, n_win):
    """Shapes, types and layout of the kernels' arguments."""
    c, t = x.shape
    n = int(n_win)
    if window.shape != (c, n) or t < n:
        raise ValueError(f"window must be [{c}, {n}] with T={t} >= {n}, "
                         f"got {tuple(window.shape)}")
    if env_state.envelope.shape != (c,) or env_state.peak.shape != (c,) \
            or env_state.hold.shape != (c,):
        raise ValueError("envelope state must be [C] per field")
    if env_state.hold.dtype != torch.int32:
        raise ValueError(f"hold must be int32, got {env_state.hold.dtype}")
    _build.check_cuda_f32(window=window, envelope=env_state.envelope,
                          peak=env_state.peak, x=x)
    if not env_state.hold.is_contiguous():
        raise ValueError("hold must be contiguous")


def _chain_dyn(window, env_state: EnvState, x, n_win: int, sc_gain,
               tau_attack, tau_release, release_thresh, hold_samples,
               knees: Tuple[CompKnee, CompKnee], save: bool = False):
    """:func:`chain_dyn` outside autograd: the plain version for CPU
    tensors, the kernel for CUDA tensors.  ``save``: the level and the
    envelope [C, T] come after the outputs (for the backward; on the card
    ``chain_dyn_save_kernel``, counted as kernel #3)."""
    tensors = (window, env_state.envelope, env_state.peak, x)
    if _build.is_cpu(*tensors, env_state.hold):
        out = _chain_dyn_plain(window, env_state, x, n_win, sc_gain,
                               tau_attack, tau_release, release_thresh,
                               hold_samples, knees)
        return out if save else out[:3]
    _check_dyn(window, env_state, x, n_win)
    c, t = x.shape
    n = int(n_win)
    y = torch.empty_like(x)
    win_out = torch.empty_like(window)
    e_out = torch.empty_like(env_state.envelope)
    p_out = torch.empty_like(env_state.peak)
    h_out = torch.empty_like(env_state.hold)
    prm = _params(n, sc_gain, tau_attack, tau_release, release_thresh,
                  hold_samples, knees)
    lib = _build.load("env", _SIGS)
    args = [_build.ptr(v) for v in (
        x, window, env_state.envelope, env_state.peak, env_state.hold, y,
        win_out, e_out, p_out, h_out)]
    if save:
        level, env = torch.empty_like(x), torch.empty_like(x)
        _build.check(lib.lsp_chain_dyn_save(
            *args, _build.ptr(level), _build.ptr(env), c, t, n, prm,
            _build.stream_of(x)), "chain_dyn_save kernel")
    else:
        _build.check(lib.lsp_chain_dyn(*args, c, t, n, prm,
                                       _build.stream_of(x)),
                     "chain_dyn kernel")
    chain_dyn.launches += 1
    out = win_out, EnvState(e_out, p_out, h_out), y
    return out + (level, env) if save else out


chain_dyn.launches = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------


def _knee_leaves(knees, x):
    """The 16 knee fields as 0-d leaves of x's type that require grad
    (host numbers as they are, tensors detached)."""
    return [(v.detach().to(dtype=x.dtype, device=x.device).reshape(())
             if torch.is_tensor(v) else
             torch.tensor(float(v), dtype=x.dtype, device=x.device)
             ).requires_grad_(True) for k in knees for v in k]


def chain_dyn_bwd_plain(window, env_state: EnvState, x, g_win, g_e, g_p,
                        g_y, n_win: int, sc_gain, tau_attack, tau_release,
                        release_thresh, hold_samples, knees, saved=None):
    """Plain PyTorch version of :func:`chain_dyn_bwd`.  ``saved`` is the
    forward's (level, envelope), recomputed by the plain forward when
    None.  The gain's adjoint is autograd's over compressor_x2_gain; the
    envelope's and the RMS's are the plain backwards of
    ops/env_units.py."""
    e0, p0, h0 = env_state
    if saved is None:
        with torch.no_grad():
            saved = _chain_dyn_plain(window, env_state, x, n_win, sc_gain,
                                     tau_attack, tau_release, release_thresh,
                                     hold_samples, knees)[3:]
    level, env = saved
    gain, g_env, g_knee = gain_adjoint_plain(env, x, g_y, knees)
    g_level, g_e0, g_p0, g_tau = peak_envelope_bwd_plain(
        level, env, e0, p0, h0, g_env, g_e, g_p, tau_attack, tau_release,
        int(hold_samples), release_thresh)
    g_window, g_x = sliding_rms_bwd_plain(window, x, level, g_level, g_win,
                                          n_win, sc_gain)
    return g_window, g_e0, g_p0, g_y * gain + g_x, g_tau, g_knee


def gain_adjoint_plain(env, x, g_y, knees):
    """The gain and the apply's adjoint, ``y = x * compressor_x2_gain(
    knees, env)``, by autograd: (gain, the envelope's cotangent, the 16
    knee fields' gradients)."""
    with torch.enable_grad():
        e_d = env.detach().requires_grad_(True)
        kl = _knee_leaves(knees, x)
        gain = compressor_x2_gain((CompKnee(*kl[:8]), CompKnee(*kl[8:])),
                                  e_d)
        grads = torch.autograd.grad(gain, [e_d] + kl, g_y * x,
                                    allow_unused=True)
    g_knee = torch.stack([torch.zeros((), dtype=x.dtype, device=x.device)
                          if g is None else g for g in grads[1:]])
    return gain.detach(), grads[0], g_knee


def chain_dyn_bwd(window, env_state: EnvState, x, g_win, g_e, g_p, g_y,
                  n_win: int, sc_gain, tau_attack, tau_release,
                  release_thresh, hold_samples, knees, saved=None,
                  replay: bool = False):
    """Backward of :func:`chain_dyn`: its inputs, and the cotangents of
    window', envelope', peak' and y.  Returns (g_window [C, N], g_envelope
    [C], g_peak [C], g_x [C, T], g_tau [2]: attack, release, g_knee [16]:
    the knee fields in CompKnee order, knee 0 then knee 1).  The plain
    version for CPU tensors (``saved``: the forward's level and
    envelope, else recomputed); for CUDA tensors the kernel
    ``chain_dyn_bwd`` (one block a channel, from ``saved``, else from the
    level and envelope of kernel #3's saving form launched here: each
    step's branch code, the gain's adjoint, the envelope's reverse pass on
    one thread, the RMS's adjoint as a float64 sliding sum), then a kernel
    that sums the per-channel tau and knee partials in channel order:
    one call, counted in ``chain_dyn_bwd.launches``.  With ``replay`` the
    level and envelope it started from and what the kernel derived from
    them come after the gradients, as (level, envelope, the envelope's
    cotangent, the level's cotangent, y), to hold them against kernel #3
    and the plain adjoints."""
    tensors = (window, env_state.envelope, env_state.peak, x, g_win, g_e,
               g_p, g_y)
    if _build.is_cpu(*tensors, env_state.hold):
        if replay:
            raise ValueError("replay is the kernel's")
        return chain_dyn_bwd_plain(window, env_state, x, g_win, g_e, g_p,
                                   g_y, n_win, sc_gain, tau_attack,
                                   tau_release, release_thresh, hold_samples,
                                   knees, saved)
    _check_dyn(window, env_state, x, n_win)
    g_win, g_e, g_p, g_y = (v.contiguous() for v in (g_win, g_e, g_p, g_y))
    _build.check_cuda_f32(g_win=g_win, g_e=g_e, g_p=g_p, g_y=g_y)
    if g_win.shape != window.shape or g_y.shape != x.shape \
            or g_e.shape != env_state.envelope.shape \
            or g_p.shape != env_state.peak.shape:
        raise ValueError("chain_dyn_bwd: each cotangent must be shaped as "
                         "its output")
    c, t = x.shape
    n = int(n_win)
    dev = x.device
    if saved is None:
        saved = _chain_dyn(window, env_state, x, n_win, sc_gain, tau_attack,
                           tau_release, release_thresh, hold_samples, knees,
                           save=True)[3:]
    level, env = (v.contiguous() for v in saved)
    _build.check_cuda_f32(level=level, env=env)
    if level.shape != x.shape or env.shape != x.shape:
        raise ValueError("chain_dyn_bwd: the saved level and envelope must "
                         "be shaped as x")
    g_x, g_window = torch.empty_like(x), torch.empty_like(window)
    ge, gp = torch.empty(c, device=dev), torch.empty(c, device=dev)
    tau_part = torch.empty(2 * c, device=dev)
    knee_part = torch.empty(N_KNEE * c, dtype=torch.float64, device=dev)
    g_tau, g_knee = torch.empty(2, device=dev), torch.empty(N_KNEE,
                                                            device=dev)
    extra = [torch.empty_like(x) for _ in range(3)] if replay else []
    ptrs = [_build.ptr(v) for v in extra] or [None] * 3
    prm = _params(n, sc_gain, tau_attack, tau_release, release_thresh,
                  hold_samples, knees)
    lib = _build.load("env", _SIGS)
    _build.check(lib.lsp_chain_dyn_bwd(
        *(_build.ptr(v) for v in (x, env_state.envelope, env_state.peak,
                                  env_state.hold, level, env, g_y, g_win,
                                  g_e, g_p, g_x, g_window, ge, gp, tau_part,
                                  knee_part, g_tau, g_knee)),
        *ptrs, c, t, n, prm, _build.stream_of(x)), "chain_dyn_bwd kernel")
    chain_dyn_bwd.launches += 1
    out = (g_window, ge, gp, g_x, g_tau, g_knee)
    return out + (level, env, *extra) if replay else out


chain_dyn_bwd.launches = 0


class _ChainDyn(torch.autograd.Function):
    """:func:`chain_dyn` under autograd: forward :func:`_chain_dyn`,
    backward :func:`chain_dyn_bwd`.  The knee fields come as 16
    arguments, so that tensors among them are the graph's inputs."""

    @staticmethod
    def forward(ctx, window, e, p, h, x, n_win, sc_gain, ta, tr, rt, hold,
                *kf):
        knees = (CompKnee(*kf[:8]), CompKnee(*kf[8:]))
        args = (n_win, sc_gain, ta, tr, rt, hold, knees)
        win, env_st, y, level, env = _chain_dyn(
            window, EnvState(e, p, h), x, *args, save=True)
        ctx.save_for_backward(window, e, p, h, x, level, env)
        ctx.mark_non_differentiable(env_st.hold)
        ctx.args = args
        return win, env_st.envelope, env_st.peak, env_st.hold, y

    @staticmethod
    @once_differentiable
    def backward(ctx, g_win, g_e, g_p, _g_hold, g_y):
        window, e, p, h, x, level, env = ctx.saved_tensors
        g_window, ge, gp, gx, g_tau, g_knee = chain_dyn_bwd(
            window, EnvState(e, p, h), x, g_win, g_e, g_p, g_y, *ctx.args,
            saved=(level, env))
        n_win, sc_gain, ta, tr, rt, hold, knees = ctx.args

        def scalar(i, v, g):
            if not ctx.needs_input_grad[i]:
                return None
            return g.to(dtype=v.dtype, device=v.device).reshape(v.shape)
        g_rt = (torch.zeros_like(rt) if ctx.needs_input_grad[9] else None)
        kf = [v for k in knees for v in k]
        return (g_window, ge, gp, None, gx, None, None,
                scalar(7, ta, g_tau[0]), scalar(8, tr, g_tau[1]), g_rt, None,
                *(scalar(11 + i, v, g_knee[i]) for i, v in enumerate(kf)))
