// The lookahead limiter's gain: ops/limiter.py's limiter, per row
//
//   gbuf = [gcarry (5L) || ones (T)],  lvl[i] = |sc[i]| * gbuf[L + i]
//   1. ALR (optional): e = fma(s > e ? tau_att : tau_rel, s - e, e) over
//      s = lvl[i], and gbuf[L + i] *= knee gain of e;
//   2. while max lvl > thr (and fewer than 1024 passes ran): at the
//      first index of the maximum, peak, with s = lvl[peak]
//        k = (s - fma(thr, knee, -1e-6)) / max(s, 1e-12)
//        gbuf[L + peak - middle + j] *= fma(-k, patch[j], 1),  j < P
//      and knee *= 0.9886 every 32 passes;
//   3. gbuf[L + i] *= min(1, thr / max(lvl[i], 1e-12));
//   gain = gbuf[:T], gcarry' = gbuf[T:].
//
// Replaces the body of the JAX package's models/dynamics/limiter.py
// Limiter.process: the ALR lax.scan (:200-224), the lax.while_loop
// (:228-258) and the clamp and carry (:262-277).  It is no Pallas
// kernel: XLA compiles the scan and the loop.
//
// Rows are independent.  The JAX loop runs every row until no row is
// active (or the most passes any row ran reach 1024); a row inactive
// before a pass has k = 0 and is multiplied by exactly fma(-0, patch, 1)
// = 1 everywhere, so its buffer, and with it its inactivity, stays as it
// was: each row is active for a prefix of the passes, and runs exactly
// min(n_row, 1024) of them, where n_row is the count it needs alone.
// Here each row runs its own loop to that count
// (tests/test_torch_dynamics2.py holds batched rows against each row
// alone in both packages).
//
// What bounds it: the passes, a serial loop whose every pass depends on
// the one before (its peak, then its patch), and the ALR, where it runs,
// a serial chain of T steps.  The bytes (sc in, gain out) are far below
// both.  A pass changes the levels of the P <= 3L + 1 samples its patch
// touches and no others, so it needs no rescan of all T levels (the
// first design's, one block barrier and 8 bytes of shared memory a level
// a pass): the first-index maximum of each tile of 16 levels stays in
// shared memory, and that of each group of 32 tiles, with its index, in
// a lane of warp 0 (rows longer than 16384 levels take tiles of 16 << n,
// so there are at most 32 groups).  A pass runs on warp 0 alone, with no
// barrier but the warp's:
//
// - the loudest group (its first among equals) gives the peak: the first
//   index of the maximum, as argmax takes it;
// - a lane a tile of the ~2 + P / 16 that the patch window overlaps
//   multiplies its samples' gains by the patch (padded with a tile of
//   zeros either side, so a sample outside the window keeps its gain,
//   times exactly 1) and takes its tile's maximum from the products it
//   holds; then the groups of those tiles are reduced anew.
//
// Tile maxima compare as floats (fmaxf: NaN never the peak, as in a float
// compare), groups as ordered integers (a float's bits, the negatives'
// magnitudes flipped, NaN below all), so that __reduce_max_sync takes
// them.
//
// The ALR runs before the passes: the levels and the knee gains in
// parallel, the follower's chain alone on one thread (alr_stage).  A
// first design ran the whole ALR step on one thread: ~168 cycles a
// sample; this one ~20 (its compare and select on the chain).  Two other
// chains, the same bit for bit where both taus are positive and finite,
// ran slower in this kernel (the whole limiter 0.2126 ms with this one
// at [64, 16384], EXP_WIDE at 5 ms, NVIDIA H100 80GB HBM3 at 700 W,
// tools/ab_kernels.py against variant trees in one call): the larger of
// both taus' updates, max(fma(ta, d, e), fma(tr, d, e)), no compare on
// the chain, 0.2230; the same with the levels loaded a batch of 8
// ahead, 0.2512.
//
// Every product and sum rounds as the plain version rounds it
// (__fmul_rn, __fadd_rn, __fdiv_rn, and __fmaf_rn where XLA contracts in
// the JAX package), so the two agree bit for bit.

#include <cuda_runtime.h>

#include <climits>

#include "smem_attr.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxIters = 1024;       // MAX_PATCH_ITERS
constexpr int kPeaksMax = 32;         // LIMITER_PEAKS_MAX
constexpr float kGainLowering = 0.9886f;
constexpr float kKneeEps = 1e-6f;
constexpr float kTiny = 1e-12f;
constexpr size_t kMaxSmem = 232448;   // 227 KB a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileLog = 4;           // a tile: 16 levels (on most rows)
constexpr int kGroupLog = 5;          // a group: 32 tiles
constexpr int kMaxTiles = 1024;       // 32 groups; longer rows take longer tiles
// The dependent operations on a pass's path: the groups' reduction, the
// peak's group (compare, ballot, first bit) and index (a shuffle); the
// tile's address (2), its gain's load, the product with the patch
// factor, the level's product, the tile's maximum (a tree of 4), its
// first index (a compare and a tree of 4), the key (3) and its store;
// the warp's barrier; the group's load, reduction, compare, ballot, first
// bit, shuffle and the owner's select.
constexpr int kPassChainOps = 32;

struct Args {
  const float* sc;      // [rows, T]
  const float* g_in;    // [rows, 5L]
  const float* e_in;    // [rows]
  const float* patch;   // [P]
  float* gain;          // [rows, T]
  float* g_out;         // [rows, 5L]
  float* e_out;         // [rows]
  int* passes;          // [rows]
  float* scratch;       // [rows, 2T + 5L] (global_kernel only)
  int t_n, la, p_n, middle, alr;
  float thr, ks, ke, alr_gain, h0, h1, h2, tau_att, tau_rel;
};

// The tiles' log2 size beyond 16 levels for a row of t_n
int tile_shift(int t_n) {
  int sh = 0;
  while ((((long long)t_n - 1) >> (kTileLog + sh)) + 1 > kMaxTiles) ++sh;
  return sh;
}

// The tile arrays (a key and a first index a tile), the groups' first
// keys and indices, and the patch with a tile of zeros on either side.
size_t tile_words(int t_n, int p_n) {
  const int sh = tile_shift(t_n);
  const int n_t = (int)((((long long)t_n - 1) >> (kTileLog + sh)) + 1);
  return 2 * (size_t)n_t + 64 + (size_t)p_n
         + 2 * ((size_t)1 << (kTileLog + sh));
}

// The tile arrays, the padded patch, the gain buffer (T + 5L), |sc| (T)
// and, with ALR, the envelopes (T).
size_t smem_bytes(int t_n, int la, int p_n, int alr) {
  return sizeof(float) * (tile_words(t_n, p_n) + (alr ? 3 : 2) * (size_t)t_n
                          + 5 * (size_t)la);
}

// A level as an integer of the same order (NaN below every level)
__device__ __forceinline__ int level_key(float v) {
  const int b = __float_as_int(v);
  return v != v ? INT_MIN : b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_level(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// One thread's tile u of levels (16 << tsh of them, at u << tbits): with
// kPatch, the gains of its samples multiplied by 1 - k ppad[i - lo] (to
// fma's rounding; ppad is the patch with a tile of zeros either side, so
// a sample outside the window takes a factor of exactly 1 and keeps its
// gain); then its largest level and the first index holding it, as an
// ordered key.  Sixteen samples at a time, each lane from its own offset
// (c ^ rot: two lanes' tiles share a bank row), every load before any
// product or store.  kEdge: the first or last tile, whose samples may
// fall outside the row or the gain buffer.
template <bool kPatch, bool kEdge, class Asc>
__device__ __forceinline__ void patch_tile(const Args& a, float* g,
                                           const float* ppad, Asc asc, int u,
                                           int tbits, int lo, float k,
                                           int* tkey, int* tidx) {
  const int ts = 1 << tbits, base = u << tbits, rot = (threadIdx.x & 31) >> 1;
  const int t_n = a.t_n, la = a.la, w_n = t_n + 5 * la;
  float bm = -1.f / 0.f;
  int bi = INT_MAX;
  for (int j0 = 0; j0 < ts; j0 += 16) {
    int ix[16];
    float gv[16], pv[16], av[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      ix[c] = base + j0 + (c ^ rot);
      const bool in_w = !kEdge || (la + ix[c] >= 0 && la + ix[c] < w_n);
      const bool in_t = !kEdge || (ix[c] >= 0 && ix[c] < t_n);
      gv[c] = in_w ? g[la + ix[c]] : 0.f;
      pv[c] = kPatch && in_w ? ppad[ix[c] - lo] : 0.f;
      av[c] = in_t ? asc(ix[c]) : 0.f;
    }
    if (kPatch) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        gv[c] = __fmul_rn(gv[c], __fmaf_rn(-k, pv[c], 1.f));
      }
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        if (!kEdge || (la + ix[c] >= 0 && la + ix[c] < w_n)) {
          g[la + ix[c]] = gv[c];
        }
      }
    }
    float lv[16], m[8];
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const bool in_t = !kEdge || (ix[c] >= 0 && ix[c] < t_n);
      lv[c] = in_t ? __fmul_rn(av[c], gv[c]) : -1.f / 0.f;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) m[c] = fmaxf(lv[c], lv[c + 8]);
#pragma unroll
    for (int w = 4; w; w >>= 1) {
#pragma unroll
      for (int c = 0; c < w; ++c) m[c] = fmaxf(m[c], m[c + w]);
    }
    int mi[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      mi[c] = min(lv[c] == m[0] ? ix[c] : INT_MAX,
                  lv[c + 8] == m[0] ? ix[c + 8] : INT_MAX);
    }
#pragma unroll
    for (int w = 4; w; w >>= 1) {
#pragma unroll
      for (int c = 0; c < w; ++c) mi[c] = min(mi[c], mi[c + w]);
    }
    if (m[0] > bm || bi == INT_MAX) {   // the chunks run in index order
      bm = m[0];
      bi = mi[0];
    }
  }
  if (!kEdge || (base >= 0 && base < t_n)) {
    tkey[u] = level_key(bm);
    tidx[u] = bi;
  }
}

template <bool kPatch, class Asc>
__device__ __forceinline__ void tile_pass(const Args& a, float* g,
                                          const float* ppad, Asc asc, int u,
                                          int n_t, int tbits, int lo, float k,
                                          int* tkey, int* tidx) {
  if (u > 0 && u < n_t - 1) {
    patch_tile<kPatch, false>(a, g, ppad, asc, u, tbits, lo, k, tkey, tidx);
  } else {
    patch_tile<kPatch, true>(a, g, ppad, asc, u, tbits, lo, k, tkey, tidx);
  }
}

// Groups q0's and q1's keys and the first index of each one's first tile
// holding it, by a warp (every lane gets them; the two reductions
// overlap)
__device__ __forceinline__ void group_max(const int* tkey, const int* tidx,
                                          int q0, int q1, int n_t, int* key,
                                          int* idx) {
  const int lane = threadIdx.x & 31;
  const int u0 = (q0 << kGroupLog) + lane, u1 = (q1 << kGroupLog) + lane;
  const int tk0 = u0 < n_t ? tkey[u0] : INT_MIN;
  const int tk1 = u1 < n_t ? tkey[u1] : INT_MIN;
  const int ti0 = u0 < n_t ? tidx[u0] : INT_MAX;
  const int ti1 = u1 < n_t ? tidx[u1] : INT_MAX;
  key[0] = __reduce_max_sync(kFull, tk0);
  key[1] = __reduce_max_sync(kFull, tk1);
  const unsigned h0 = __ballot_sync(kFull, tk0 == key[0]);
  const unsigned h1 = __ballot_sync(kFull, tk1 == key[1]);
  idx[0] = __shfl_sync(kFull, ti0, __ffs(h0) - 1);
  idx[1] = __shfl_sync(kFull, ti1, __ffs(h1) - 1);
}

// The ALR pre-stage (reference Limiter.cpp:675-693), in three steps:
// every thread stores its levels s = |sc| x g into ebuf; one thread runs
// the peak follower over them in place (the chain alone); every thread
// turns its envelopes into the knee gain and multiplies it into g.
// Returns the envelope' (thread 0's).
template <class Asc>
__device__ float alr_stage(const Args& a, float* g, float* ebuf, Asc asc,
                           float e) {
  const int tid = threadIdx.x, t_n = a.t_n, la = a.la;
  for (int i = tid; i < t_n; i += kThreads) {
    ebuf[i] = __fmul_rn(asc(i), g[la + i]);
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll 8
    for (int i = 0; i < t_n; ++i) {
      const float s = ebuf[i];
      e = __fmaf_rn(s > e ? a.tau_att : a.tau_rel, __fsub_rn(s, e), e);
      ebuf[i] = e;
    }
  }
  __syncthreads();
  for (int i = tid; i < t_n; i += kThreads) {
    const float ei = ebuf[i];
    const float m = fmaxf(ei, kTiny);
    float gg = 1.f;
    if (ei >= a.ke) {
      gg = __fdiv_rn(a.alr_gain, m);
    } else if (ei > a.ks) {
      gg = __fadd_rn(__fmaf_rn(a.h0, ei, a.h1), __fdiv_rn(a.h2, m));
    }
    g[la + i] = __fmul_rn(g[la + i], gg);
  }
  __syncthreads();
  return e;
}

template <bool kSmem>
__global__ void __launch_bounds__(kThreads) limiter_kernel(Args a,
                                                           int tsh) {
  extern __shared__ __align__(16) int lim_base[];
  const int row = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int t_n = a.t_n, la = a.la, l5 = 5 * la, w_n = t_n + l5;
  const int tbits = kTileLog + tsh, ts = 1 << tbits;
  const int n_t = ((t_n - 1) >> tbits) + 1, n_g = ((n_t - 1) >> kGroupLog) + 1;
  int* tkey = lim_base;
  int* tidx = tkey + n_t;
  int* gkey = tidx + n_t;   // 32, then their 32 indices
  float* ppad = reinterpret_cast<float*>(gkey + 64);
  float* g = kSmem ? ppad + a.p_n + 2 * ts
                   : a.scratch + (size_t)row * (w_n + t_n);
  float* asc_s = g + w_n;   // kSmem only
  // the ALR's envelopes: after |sc| in shared memory, after the row's
  // buffer in the scratch row
  float* ebuf = kSmem ? asc_s + t_n : g + w_n;
  const float* sc = a.sc + (size_t)row * t_n;

  for (int j = tid; j < a.p_n + 2 * ts; j += kThreads) {
    ppad[j] = j >= ts && j < ts + a.p_n ? a.patch[j - ts] : 0.f;
  }
  for (int j = tid; j < l5; j += kThreads) g[j] = a.g_in[(size_t)row * l5 + j];
  for (int j = l5 + tid; j < w_n; j += kThreads) g[j] = 1.f;
  if (kSmem) {
    for (int j = tid; j < t_n; j += kThreads) asc_s[j] = fabsf(sc[j]);
  }
  __syncthreads();
  auto asc = [&](int i) { return kSmem ? asc_s[i] : fabsf(__ldg(sc + i)); };
  auto lvl = [&](int i) { return __fmul_rn(asc(i), g[la + i]); };

  const float e = a.alr ? alr_stage(a, g, ebuf, asc, a.e_in[row])
                        : a.e_in[row];
  if (tid == 0) a.e_out[row] = e;

  // every tile's maximum, a thread a tile, then every group's, a warp a
  // group
  for (int u = tid; u < n_t; u += kThreads) {
    tile_pass<false>(a, g, ppad, asc, u, n_t, tbits, 0, 0.f, tkey, tidx);
  }
  __syncthreads();
  for (int q = warp; q < n_g; q += kThreads / 32) {
    int key[2], idx[2];
    group_max(tkey, tidx, q, q, n_t, key, idx);
    if (lane == 0) {
      gkey[q] = key[0];
      gkey[32 + q] = idx[0];
    }
  }
  __syncthreads();

  if (warp == 0) {
    // lane q holds group q's key and peak index (n_g <= 32)
    int gk = lane < n_g ? gkey[lane] : INT_MIN;
    int gi = lane < n_g ? gkey[32 + lane] : INT_MAX;
    float knee = 1.f;
    int iters = 0;
    while (iters < kMaxIters) {
      // the loudest group (the first among equals) and its peak
      const int best = __reduce_max_sync(kFull, gk);
      const float s = key_level(best);
      if (!(s > a.thr)) break;   // the same s in every lane
      const int q = __ffs(__ballot_sync(kFull, gk == best)) - 1;
      const int peak = __shfl_sync(kFull, gi, q);
      const float k = __fdiv_rn(
          __fsub_rn(s, __fmaf_rn(a.thr, knee, -kKneeEps)), fmaxf(s, kTiny));
      // the patch and the rescan of the tiles it touches, a lane a tile
      // of level indices (those outside the row patch alone), then their
      // groups
      const int lo = peak - a.middle - ts;   // ppad's origin
      const int ua = (peak - a.middle) >> tbits;
      const int ub = (peak - a.middle + a.p_n - 1) >> tbits;
      for (int u = ua + lane; u <= ub; u += 32) {
        tile_pass<true>(a, g, ppad, asc, u, n_t, tbits, lo, k, tkey, tidx);
      }
      __syncwarp();
      const int q1 = min(ub, n_t - 1) >> kGroupLog;
      for (int gq = max(ua, 0) >> kGroupLog; gq <= q1; gq += 2) {
        int key[2], idx[2];
        group_max(tkey, tidx, gq, min(gq + 1, q1), n_t, key, idx);
        if (lane == gq) {
          gk = key[0];
          gi = idx[0];
        } else if (lane == gq + 1 && gq + 1 <= q1) {
          gk = key[1];
          gi = idx[1];
        }
      }
      ++iters;
      if (iters % kPeaksMax == 0) knee = __fmul_rn(knee, kGainLowering);
    }
    if (lane == 0) a.passes[row] = iters;
  }
  __syncthreads();

  // the clamp: a no-op unless the cap cut the loop short
  for (int i = tid; i < t_n; i += kThreads) {
    const float lv = lvl(i);
    const float corr = fminf(1.f, __fdiv_rn(a.thr, fmaxf(lv, kTiny)));
    g[la + i] = __fmul_rn(g[la + i], corr);
  }
  __syncthreads();
  float* gain = a.gain + (size_t)row * t_n;
  for (int i = tid; i < t_n; i += kThreads) gain[i] = g[i];
  for (int j = tid; j < l5; j += kThreads) {
    a.g_out[(size_t)row * l5 + j] = g[t_n + j];
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of smem_kernel for these sizes, or 0 where they
// do not fit (global_kernel then runs, from a scratch row).
int lsp_limiter_smem_bytes(int t_n, int la, int p_n, int alr) {
  const size_t b = smem_bytes(t_n, la, p_n, alr);
  return b <= kMaxSmem ? (int)b : 0;
}

// The dependent operations on a pass's path (kPassChainOps).
int lsp_limiter_pass_chain_ops() { return kPassChainOps; }

// The shared-memory bytes a pass moves: each tile the patch window
// overlaps (a gain, a patch value and |sc| read and a gain written a
// level, its key and index written), two groups' keys and indices read.
int lsp_limiter_pass_bytes(int t_n, int p_n) {
  const int ts = 1 << (kTileLog + tile_shift(t_n));
  const int tiles = (p_n + ts - 1) / ts + 1;
  return tiles * (16 * ts + 8) + 2 * 32 * 8;
}

// One block per row.  scratch == nullptr takes smem_kernel; otherwise
// scratch holds rows x (2T + 5L) floats.  Returns a cudaError_t.
int lsp_limiter(const float* sc, const float* g_in, const float* e_in,
                const float* patch, float* gain, float* g_out, float* e_out,
                int* passes, float* scratch, int rows, int t_n, int la,
                int p_n, int middle, float thr, float ks, float ke,
                float alr_gain, float h0, float h1, float h2, float tau_att,
                float tau_rel, int alr, void* stream) {
  Args a{sc, g_in, e_in, patch, gain, g_out, e_out, passes, scratch,
         t_n, la, p_n, middle, alr,
         thr, ks, ke, alr_gain, h0, h1, h2, tau_att, tau_rel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_n < 1) return (int)cudaErrorInvalidValue;
  const int tsh = tile_shift(t_n);
  if (scratch == nullptr) {
    const size_t b = smem_bytes(t_n, la, p_n, alr);
    if (b > kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem<limiter_kernel<true>>(b);
    if (err != cudaSuccess) return (int)err;
    limiter_kernel<true><<<rows, kThreads, b, s>>>(a, tsh);
  } else {
    const size_t b = sizeof(float) * tile_words(t_n, p_n);
    if (b > kMaxSmem) return (int)cudaErrorInvalidValue;
    const cudaError_t err = allow_smem<limiter_kernel<false>>(b);
    if (err != cudaSuccess) return (int)err;
    limiter_kernel<false><<<rows, kThreads, b, s>>>(a, tsh);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
