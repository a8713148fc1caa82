"""Block-FFT biquad cascade: the port of ops/biquad_block.py (fused part).

Exact per-block decomposition of a K-stage DF2T cascade (see the JAX
module for the derivation):

    y     = conv(x, h_total)[:B] + G @ s        (zero-state + zero-input)
    s_out = M @ s + W @ x                       (exact carry)

with ``h_total``, G, W and M computed on the host in float64, balanced,
and rounded once to float32.  :func:`cascade_block_fused` (the EQ of
``step``/``bulk_step``) runs the convolutions through the packed FFT
kernels for CUDA tensors (ops/fft_packed.py) and torch.fft for CPU
tensors; the G/M/W products are broadcast multiply-and-sums, so no
library matmul touches them.  ``step_ring`` runs the same EQ inside the
kernel of ops/fdl_fused.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from lsp_dsp_units_tpu_torch.ops import fft_packed as fp
from lsp_dsp_units_tpu_torch.ops.cplx import irfft_sc, rfft_sc, sc_mul


def _run_stage(x: np.ndarray, stage) -> np.ndarray:
    """One biquad stage over a float64 buffer (scipy lfilter when
    available, else a python loop)."""
    b0, b1, b2, a1, a2 = (float(v) for v in stage)
    try:
        from scipy.signal import lfilter
        return lfilter([b0, b1, b2], [1.0, -a1, -a2],
                       np.asarray(x, np.float64))
    except ImportError:
        out = np.empty(len(x))
        s1 = s2 = 0.0
        for n, xn in enumerate(np.asarray(x, np.float64)):
            y = b0 * xn + s1
            s1 = b1 * xn + a1 * y + s2
            s2 = b2 * xn + a2 * y
            out[n] = y
        return out


def init_state(num_stages: int, batch_shape: Tuple[int, ...] = (),
               device="cuda") -> torch.Tensor:
    """Zero cascade state ``batch_shape + (num_stages, 2)``."""
    return torch.zeros(batch_shape + (num_stages, 2), dtype=torch.float32,
                       device=device)


class FusedCascadeParams(NamedTuple):
    """Whole-cascade block kernels (balanced state basis), float32
    tensors on one device.  ``g_t`` is ``g_mat`` transposed and made
    contiguous once, the layout the CUDA kernel reads."""
    h_re: torch.Tensor     # [F] composite spectrum (natural order)
    h_im: torch.Tensor     # [F]
    g_mat: torch.Tensor    # [B, 2K] state -> output
    w_mat: torch.Tensor    # [2K, B] input -> state
    m_mat: torch.Tensor    # [2K, 2K] state -> state
    t_mat: torch.Tensor    # [2K, 2K] DF2T -> balanced basis
    t_inv: torch.Tensor    # [2K, 2K] balanced -> DF2T
    a1_mat: torch.Tensor   # [2K, 2K] one-sample composite state space
    b1_vec: torch.Tensor   # [2K]
    c1_vec: torch.Tensor   # [2K]
    d1: torch.Tensor       # []
    g_t: torch.Tensor      # [2K, B]


def _balance_f64(g: np.ndarray, w: np.ndarray, m: np.ndarray):
    """Balanced-realization similarity of the block system (f64).

    Returns (g_b, w_b, m_b, t, t_inv) with s_bal = t @ s_df2t.  Falls
    back to the identity transform when the system is not safely
    balanceable (unstable M, singular Gramian factors, no scipy)."""
    n = m.shape[0]
    ident = np.eye(n)
    try:
        import scipy.linalg as sla
        if n == 0 or np.max(np.abs(np.linalg.eigvals(m))) >= 1.0 - 1e-12:
            return g, w, m, ident, ident
        p = sla.solve_discrete_lyapunov(m, w @ w.T)
        q = sla.solve_discrete_lyapunov(m.T, g.T @ g)
        reg = 1e-12
        lp = np.linalg.cholesky(p + reg * (np.trace(p) / n) * ident)
        lq = np.linalg.cholesky(q + reg * (np.trace(q) / n) * ident)
        u, sv, vt = np.linalg.svd(lq.T @ lp)
        if sv[-1] <= 0 or not np.all(np.isfinite(sv)):
            return g, w, m, ident, ident
        s = sv ** -0.5
        t_inv = lp @ vt.T * s
        t = (s[:, None] * u.T) @ lq.T
        if np.abs(t @ t_inv - ident).max() > 1e-6:
            return g, w, m, ident, ident
        return g @ t_inv, t @ w, t @ m @ t_inv, t, t_inv
    except (ImportError, np.linalg.LinAlgError, ValueError):
        return g, w, m, ident, ident


def _fused_mats_f64(coeffs: np.ndarray, block: int):
    """Float64 (h_total, G, W, M) of the fused block decomposition."""
    coeffs = np.asarray(coeffs, np.float64)
    k = coeffs.shape[0]
    b = int(block)

    def run_cascade(x, stages):
        y = np.asarray(x, np.float64)
        for stage in stages:
            y = _run_stage(y, stage)
        return y

    delta = np.zeros(b)
    delta[0] = 1.0
    # prefix composite IRs: h_prefix[j] = IR of stages 0..j-1
    h_prefix = [delta.copy()]
    for j in range(k):
        h_prefix.append(run_cascade(h_prefix[-1], [coeffs[j]]))
    h_total = h_prefix[k]
    mid_cache = {}

    def h_mid(a, c):  # IR of stages a..c inclusive; a > c -> delta
        if a > c:
            return delta
        key = (a, c)
        if key not in mid_cache:
            mid_cache[key] = run_cascade(delta, list(coeffs[a:c + 1]))
        return mid_cache[key]

    # per-stage power tables
    p1 = np.zeros((k, b, 2))
    v_ker = np.zeros((k, b, 2))
    a_pow = np.zeros((k, 2, 2))
    for i, (b0, b1, b2, a1, a2) in enumerate(coeffs):
        A = np.array([[a1, 1.0], [a2, 0.0]])
        u = np.array([b1 + a1 * b0, b2 + a2 * b0])
        powers = np.zeros((b + 1, 2, 2))
        powers[0] = np.eye(2)
        for n in range(1, b + 1):
            powers[n] = A @ powers[n - 1]
        p1[i] = powers[:b, 0, :]
        v_ker[i] = np.einsum("nij,j->ni", powers[b - 1::-1], u)
        a_pow[i] = powers[b]

    def corr_with(v2, h):
        """[B,2] kernel correlated with IR h: out[:, n] = sum_m
        v2[m] * h[m - n]  -> [2, B]."""
        out = np.zeros((2, b))
        for c in range(2):
            out[c] = np.convolve(v2[:, c][::-1], h)[:b][::-1]
        return out

    # G: state of stage j -> output through stages j+1..K-1
    g_mat = np.zeros((b, 2 * k))
    for j in range(k):
        h_down = h_mid(j + 1, k - 1)
        for c in range(2):
            g_mat[:, 2 * j + c] = np.convolve(p1[j][:, c], h_down)[:b]
    # W: input -> state of stage i through stages 0..i-1
    w_mat = np.zeros((2 * k, b))
    for i in range(k):
        w_mat[2 * i: 2 * i + 2, :] = corr_with(v_ker[i], h_prefix[i])
    # M: state couplings
    m_mat = np.zeros((2 * k, 2 * k))
    for i in range(k):
        m_mat[2 * i: 2 * i + 2, 2 * i: 2 * i + 2] = a_pow[i]
        for j in range(i):
            # s_j,in -> y_zi_j -> through stages j+1..i-1 -> state i
            h_m = h_mid(j + 1, i - 1)
            for c in range(2):
                gj = np.convolve(p1[j][:, c], h_m)[:b]
                m_mat[2 * i: 2 * i + 2, 2 * j + c] = v_ker[i].T @ gj

    return h_total, g_mat, w_mat, m_mat


def _sample_ss_f64(coeffs: np.ndarray):
    """Composite ONE-sample state-space (A1, B1, C1, D1) of the DF2T
    cascade in f64, stage-major state layout [s1_0, s2_0, s1_1, ...]."""
    coeffs = np.asarray(coeffs, np.float64)
    k = coeffs.shape[0]
    a1m = np.zeros((2 * k, 2 * k))
    b1v = np.zeros(2 * k)
    c_pre = np.zeros(2 * k)
    d_pre = 1.0
    for i, (b0, b1, b2, a1, a2) in enumerate(coeffs):
        A = np.array([[a1, 1.0], [a2, 0.0]])
        B = np.array([b1 + a1 * b0, b2 + a2 * b0])
        sl = slice(2 * i, 2 * i + 2)
        a1m[sl, :] += np.outer(B, c_pre)
        a1m[sl, sl] += A
        b1v[sl] = B * d_pre
        c_new = b0 * c_pre
        c_new[2 * i] += 1.0
        c_pre, d_pre = c_new, b0 * d_pre
    return a1m, b1v, c_pre, d_pre


def precompute_fused(coeffs: np.ndarray, block: int, balance: bool = True,
                     device="cuda") -> FusedCascadeParams:
    b = int(block)
    h_total, g_mat, w_mat, m_mat = _fused_mats_f64(coeffs, b)
    a1m, b1v, c1v, d1 = _sample_ss_f64(coeffs)
    if balance:
        g_mat, w_mat, m_mat, t, t_inv = _balance_f64(g_mat, w_mat, m_mat)
    else:
        t = t_inv = np.eye(m_mat.shape[0])
    a1m = t @ a1m @ t_inv
    b1v = t @ b1v
    c1v = c1v @ t_inv
    hs = np.fft.rfft(h_total, 2 * b)

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return FusedCascadeParams(
        h_re=f32(hs.real), h_im=f32(hs.imag), g_mat=f32(g_mat),
        w_mat=f32(w_mat), m_mat=f32(m_mat), t_mat=f32(t),
        t_inv=f32(t_inv), a1_mat=f32(a1m), b1_vec=f32(b1v),
        c1_vec=f32(c1v), d1=f32(d1),
        g_t=f32(np.ascontiguousarray(np.asarray(g_mat, np.float32).T)))


def _matvec(mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``mat`` [R, K] applied to ``v`` [..., K] -> [..., R], as a
    broadcast multiply and a sum over K: no library matmul, so global
    TF32 or matmul-precision settings cannot change it (the JAX package
    pins these contractions at Precision.HIGH)."""
    return torch.sum(mat * v[..., None, :], dim=-1)


def state_to_fused(params: FusedCascadeParams,
                   state: torch.Tensor) -> torch.Tensor:
    """DF2T per-stage state [..., K, 2] -> fused (balanced) basis."""
    k2 = params.m_mat.shape[0]
    sv = state.reshape(state.shape[:-2] + (k2,))
    return _matvec(params.t_mat, sv).reshape(state.shape)


def state_from_fused(params: FusedCascadeParams,
                     state: torch.Tensor) -> torch.Tensor:
    """Fused (balanced) basis state [..., K, 2] -> DF2T per-stage."""
    k2 = params.m_mat.shape[0]
    sv = state.reshape(state.shape[:-2] + (k2,))
    return _matvec(params.t_inv, sv).reshape(state.shape)


def fused_block_size(params: FusedCascadeParams) -> int:
    return params.h_re.shape[-1] - 1


def cascade_seq_fused(params: FusedCascadeParams, state: torch.Tensor,
                      x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sample cascade in the balanced basis: x [..., T] (any T),
    state [..., K, 2] -> (y, state').  For remainder chunks shorter than
    the block: the carried state never leaves the one balanced basis.
    A Python loop over T."""
    k2 = params.m_mat.shape[0]
    sv = state.reshape(state.shape[:-2] + (k2,))
    ys = []
    for i in range(x.shape[-1]):
        xn = x[..., i]
        ys.append(torch.sum(params.c1_vec * sv, dim=-1) + params.d1 * xn)
        sv = _matvec(params.a1_mat, sv) + params.b1_vec * xn[..., None]
    y = torch.stack(ys, dim=-1) if ys else x.clone()
    return y.to(x.dtype), sv.reshape(state.shape)


def _zero_state_conv(params: FusedCascadeParams,
                     blocks: torch.Tensor) -> torch.Tensor:
    """First B samples of ``conv(block, h_total)`` for blocks [..., B].
    CUDA tensors at a size the packed FFT kernel takes run every row
    through the zero-pad forward, the packed product and the first-half
    inverse (the JAX package's bulk route); others natural rfft/irfft."""
    b = fused_block_size(params)
    if blocks.device.type == "cuda" and fp.supported(2 * b):
        rows = blocks.reshape(-1, b).contiguous()
        sr, si = fp.rfft_packed_zeropad(rows)
        hre, him = fp.pack_spectra(params.h_re, params.h_im, 2 * b)
        y = fp.irfft_packed(*fp.mul_packed(sr, si, hre, him), 2 * b,
                            half="first")
        return y.reshape(blocks.shape)
    spec = sc_mul(rfft_sc(blocks, 2 * b), (params.h_re, params.h_im))
    return irfft_sc(spec, 2 * b, half="first")


def cascade_block_fused(params: FusedCascadeParams, state: torch.Tensor,
                        x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused cascade execution: x [..., T] (T = M B), state [..., K, 2]
    -> (y, state').  All M blocks' zero-state convolutions run at once;
    the exact state carry ``y += G s``, ``s = M s + W x`` then walks the
    blocks in order."""
    b = fused_block_size(params)
    k2 = params.m_mat.shape[0]
    t = x.shape[-1]
    if t % b:
        raise ValueError(f"input length {t} is not a multiple of {b}")
    m = t // b
    sv = state.reshape(state.shape[:-2] + (k2,))
    blocks = torch.movedim(x.reshape(x.shape[:-1] + (m, b)), -2, 0)
    y_zs = _zero_state_conv(params, blocks)              # [M, ..., B]
    wx = _matvec(params.w_mat, blocks)                   # [M, ..., 2K]
    ys = []
    for i in range(m):
        ys.append(y_zs[i] + _matvec(params.g_mat, sv))
        sv = _matvec(params.m_mat, sv) + wx[i]
    y = torch.movedim(torch.stack(ys), 0, -2).reshape(x.shape)
    return y.to(x.dtype), sv.reshape(state.shape)
