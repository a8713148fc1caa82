"""The lookahead limiter's gain computation: the port of the body of
models/dynamics/limiter.py ``Limiter.process`` (reference Limiter.cpp:
675-785).

Per row, over the gain buffer ``gbuf = [gcarry (5L) || ones (T)]`` and
the sidechain magnitude ``|sc|`` [T]:

1. ALR (optional): a peak follower ``e += tau * (s - e)`` over
   ``s = |sc| * gbuf[L + i]`` (attack tau where ``s > e``), whose knee gain
   multiplies ``gbuf[L + i]``;
2. peak patching: while the loudest ``|sc| * gbuf[L + i]`` exceeds the
   threshold (and fewer than 1024 passes ran), multiply the patch window
   centred on it by ``1 - k * patch`` with ``k = (s - (thr * knee -
   1e-6)) / s``, lowering the knee by 0.9886 every 32 passes;
3. the clamp: ``gbuf[L + i] *= min(1, thr / (|sc| * gbuf[L + i]))``.

The gain is ``gbuf[:T]`` and the carry ``gbuf[T:]``.

:func:`limiter` runs :func:`limiter_plain` for CPU tensors and launches
``csrc/limiter.cu`` for CUDA tensors (one block per row: the ALR's
follower on one thread, then the passes on one warp over the first-index
maxima of tiles of 32 levels and groups of 32 tiles kept in shared
memory, each pass rescanning only the tiles its patch touched), counting
launches in ``limiter.launches``.  Both round alike, so they agree bit
for bit, and both round as the JAX package does on the CPU, where XLA
contracts four expressions into one FMA each (found by holding each
rounding against the JAX package, tests/test_torch_dynamics2.py): the
ALR update ``e + tau * (s - e)``, its knee ``herm0 * e + herm1``, the
knee's threshold ``thr * knee - 1e-6`` and the patch factor ``1 - k *
patch`` (``_mul_add`` here, ``__fmaf_rn`` in the kernel).

The JAX package's loop runs all rows until none is active; the plain
version does the same, with one host sync a pass.  A row that is
inactive before a pass is multiplied by exactly 1.0 in it and stays
inactive, so each row runs ``min(n_row, 1024)`` passes whatever the other
rows do, which is what the kernel runs (the row's own loop).

``params`` is a ``models.dynamics.limiter.LimiterParams``: ``patch`` a
float32 tensor [P], ``middle`` an int, the rest float32-rounded floats
(``alr_herm`` three).
"""

from __future__ import annotations

import ctypes

import torch

from lsp_dsp_units_tpu_torch.ops import _build
from lsp_dsp_units_tpu_torch.ops.env_units import _mul_add

LIMITER_PEAKS_MAX = 32       # knee lowering period (reference Limiter.cpp)
GAIN_LOWERING = 0.9886       # reference Limiter.cpp:35
MAX_PATCH_ITERS = 1024       # bounded-loop cap (reference is unbounded)
KNEE_EPS = 1e-6              # k's margin below the knee's threshold

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGS = {
    "lsp_limiter": [_P] * 9 + [_I] * 5 + [_F] * 9 + [_I, _P],
    "lsp_limiter_smem_bytes": [_I, _I, _I, _I],
    "lsp_limiter_pass_chain_ops": [],
    "lsp_limiter_pass_bytes": [_I, _I],
}


def _lib():
    return _build.load("limiter", _SIGS)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(float(v), dtype=torch.float32, device=like.device)


def _alr_plain(params, gbuf, asc, alr_env, la: int):
    """The ALR pre-stage: a per-sample loop over T; multiplies its gain
    into ``gbuf[..., L:L+T]`` in place and returns the envelope'."""
    t = asc.shape[-1]
    lvl = asc * gbuf[..., la:la + t]
    ta, tr = _f32(params.alr_tau_att, asc), _f32(params.alr_tau_rel, asc)
    ks, ke = _f32(params.alr_ks, asc), _f32(params.alr_ke, asc)
    gain = _f32(params.alr_gain, asc)
    h0, h1, h2 = (_f32(v, asc) for v in params.alr_herm)
    e = alr_env
    env = torch.empty_like(lvl)
    for i in range(t):
        s = lvl[..., i]
        e = _mul_add(torch.where(s > e, ta, tr), s - e, e)
        env[..., i] = e
    m = torch.clamp(env, min=1e-12)
    herm = _mul_add(h0.expand_as(env), env, h1.expand_as(env)) + h2 / m
    g = torch.where(env >= ke, gain / m, torch.where(env > ks, herm, 1.0))
    gbuf[..., la:la + t] *= g
    return e


def limiter_plain(params, gcarry: torch.Tensor, alr_env: torch.Tensor,
                  sc: torch.Tensor, lookahead: int, alr: bool):
    """Plain PyTorch version of :func:`limiter`: the JAX package's loop,
    over every row at once."""
    la = int(lookahead)
    t = sc.shape[-1]
    lead = sc.shape[:-1]
    gbuf = torch.cat([gcarry, torch.ones(lead + (t,), dtype=torch.float32,
                                         device=sc.device)], dim=-1)
    asc = torch.abs(sc)
    if alr:
        alr_env = _alr_plain(params, gbuf, asc, alr_env, la)
    patch = params.patch
    p = patch.shape[0]
    thr = _f32(params.threshold, sc)
    arange_w = torch.arange(gbuf.shape[-1], device=sc.device)
    knee = torch.ones(lead, dtype=torch.float32, device=sc.device)
    iters = torch.zeros(lead, dtype=torch.int32, device=sc.device)
    one, eps = _f32(1.0, sc), _f32(-KNEE_EPS, sc)
    while True:
        lvl = asc * gbuf[..., la:la + t]
        peak = torch.argmax(lvl, dim=-1)
        s = torch.gather(lvl, -1, peak[..., None])[..., 0]
        active = s > thr
        go = torch.logical_and(active.any(),
                               iters.max() < MAX_PATCH_ITERS)
        if not bool(go.item()):
            break
        knee_thr = _mul_add(thr.expand_as(knee), knee, eps.expand_as(knee))
        k = torch.where(active, (s - knee_thr) / torch.clamp(s, min=1e-12),
                        0.0)
        rel = arange_w - (la + peak - params.middle)[..., None]
        inside = torch.logical_and(rel >= 0, rel < p)
        shape = torch.where(inside, patch[torch.clamp(rel, 0, p - 1)], 0.0)
        gbuf = gbuf * _mul_add(-k[..., None].expand_as(shape), shape,
                               one.expand_as(shape))
        iters = iters + active.to(torch.int32)
        knee = torch.where(
            torch.logical_and(active, iters % LIMITER_PEAKS_MAX == 0),
            knee * GAIN_LOWERING, knee)
    lvl = asc * gbuf[..., la:la + t]
    corr = torch.clamp(thr / torch.clamp(lvl, min=1e-12), max=1.0)
    gbuf[..., la:la + t] *= corr
    return (gbuf[..., t:].contiguous(), alr_env,
            gbuf[..., :t].contiguous(), iters)


def smem_bytes(t: int, lookahead: int, p: int, alr: bool) -> int:
    """Shared memory a block of the kernel takes on its fast path
    (0 where T is too long for it: the path through global memory)."""
    return int(_lib().lsp_limiter_smem_bytes(int(t), int(lookahead),
                                             int(p), int(alr)))


def pass_chain_ops() -> int:
    """The dependent operations on a pass's path in the kernel
    (``kPassChainOps`` in csrc/limiter.cu; builds the kernel)."""
    return int(_lib().lsp_limiter_pass_chain_ops())


def pass_bytes(t: int, p: int) -> int:
    """The shared-memory bytes one of the kernel's passes moves at a row
    of ``t`` levels and a patch of ``p`` (builds the kernel)."""
    return int(_lib().lsp_limiter_pass_bytes(int(t), int(p)))


def limiter(params, gcarry: torch.Tensor, alr_env: torch.Tensor,
            sc: torch.Tensor, lookahead: int, alr: bool):
    """Limiter gain over the sidechain ``sc`` [..., T] (T >= 1) from the
    carried gain buffer ``gcarry`` [..., 5L] and ALR envelope
    ``alr_env`` [...] (``sc`` is copied where it is not contiguous).
    Returns (gcarry' [..., 5L], alr_env' [...],
    gain [..., T], passes [...] int32: the patch passes each row ran).
    Rows whose buffers do not fit in shared memory (:func:`smem_bytes`)
    run from a scratch row in global memory."""
    _build.no_grad_route("limiter", params, gcarry, alr_env, sc)
    if _build.is_cpu(gcarry, alr_env, sc, params.patch):
        return limiter_plain(params, gcarry, alr_env, sc, lookahead, alr)
    sc = sc.contiguous()
    la = int(lookahead)
    t = sc.shape[-1]
    lead = sc.shape[:-1]
    if t < 1 or gcarry.shape != lead + (5 * la,) or alr_env.shape != lead:
        raise ValueError(f"sc [..., T>=1], gcarry [..., {5 * la}] and "
                         f"alr_env [...] must share their batch shape, got "
                         f"{tuple(sc.shape)}, {tuple(gcarry.shape)}, "
                         f"{tuple(alr_env.shape)}")
    patch = params.patch
    p = patch.shape[0]
    if p > 3 * la + 1 or not 0 <= int(params.middle) <= la:
        raise ValueError(f"a patch of {p} samples centred at "
                         f"{int(params.middle)} does not fit a lookahead of "
                         f"{la}")
    _build.check_cuda(torch.float32, sc.device, sc=sc, gcarry=gcarry,
                      alr_env=alr_env, patch=patch)
    scr, gr = sc.reshape(-1, t), gcarry.reshape(-1, 5 * la)
    rows = scr.shape[0]
    gain = torch.empty_like(scr)
    g_out = torch.empty_like(gr)
    e_out = torch.empty(rows, dtype=torch.float32, device=sc.device)
    passes = torch.empty(rows, dtype=torch.int32, device=sc.device)
    scratch = (None if smem_bytes(t, la, p, alr) > 0 else
               torch.empty(rows, 2 * t + 5 * la, dtype=torch.float32,
                           device=sc.device))
    h0, h1, h2 = params.alr_herm
    _build.check(_lib().lsp_limiter(
        _build.ptr(scr), _build.ptr(gr), _build.ptr(alr_env.reshape(-1)),
        _build.ptr(patch), _build.ptr(gain), _build.ptr(g_out),
        _build.ptr(e_out), _build.ptr(passes),
        None if scratch is None else _build.ptr(scratch),
        rows, t, la, p, int(params.middle),
        float(params.threshold), float(params.alr_ks), float(params.alr_ke),
        float(params.alr_gain), float(h0), float(h1), float(h2),
        float(params.alr_tau_att), float(params.alr_tau_rel), int(alr),
        _build.stream_of(sc)),
        "limiter kernel")
    limiter.launches += 1
    return (g_out.reshape(gcarry.shape), e_out.reshape(lead),
            gain.reshape(sc.shape), passes.reshape(lead))


limiter.launches = 0
