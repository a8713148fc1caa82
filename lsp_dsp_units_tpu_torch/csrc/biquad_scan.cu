// The time-parallel biquad cascade: ops/biquad.py's biquad_cascade on the
// card, bit for bit its plain version (biquad_cascade_plain).
//
// Each stage k of the cascade is the DF2T state recurrence
//
//   s[n] = A s[n-1] + u x[n],   A = [[a1, 1], [a2, 0]],
//   u = (b1 + a1 b0, b2 + a2 b0),  y[n] = b0 x[n] + s1[n-1],
//
// solved as an inclusive scan of the affine maps e[n] = (A, u x[n]) by
// jax.lax.associative_scan's odd/even recursion, which the plain version
// repeats: pair up neighbours (level L + 1 node i = node 2i then node
// 2i + 1 of level L; a level of n nodes has floor(n / 2) above it), recurse
// on the half, then give each even position 2m >= 2 the combine of the
// half's prefix m - 1 with its own node, each odd position its parent's
// prefix.  The maps then meet the incoming state: s[n] = P[n] s_in + V[n].
//
// Replaces the jax.lax.associative_scan of the JAX package's
// ops/biquad.py (biquad_cascade, :62-77 and :114-137), which XLA
// compiles; it is no Pallas kernel.
//
// A combine's matrix reads only the two matrices, and every node of
// level L has the same matrix M_L (the leaves' A combined with itself L
// times, as the recursion rounds it).  Its vector reads the later map's
// matrix, which on the way down is always a node's: combine_v(M_L, p, q)
// is 8 operations.  So a row's scan carries vectors alone, up and down;
// the prefix matrices P[n] enter only where the state is applied.  P[n]
// depends on n and the coefficients alone: unrolled, the recursion gives
// P[n] = M_top, then for each lower level L whose bit of n + 1 is set
// P <- M_L after P (top = the highest set bit of n + 1), the same
// products in the same order as the tree.
//
// Two routes, chosen by the coefficients' shape:
//
// * Shared by the rows (row_stride 0, every caller in the package):
//   table_kernel, one thread a (position, stage), writes each stage's M_L
//   (the levels the row pass reads), P00 and P01 at every position and
//   the whole P at T - 1; then shared_kernel runs the rows on vectors.
//   Two launches a call.
// * Per row (row_stride != 0): per_row_kernel, the same tree with each
//   row's own matrices carried through the down-sweep (Elem, six floats a
//   prefix).  One launch a call.
//
// The tree maps onto tiles of kTile = 2^kTileLog nodes: a node of level L
// covers the aligned range [i 2^L, (i + 1) 2^L), so a tile holds its own
// lowest kTileLog levels, and down the tree a tile's first position needs
// only the prefix that ends just before the tile (odd positions pass their
// parent's prefix down unrounded).  So the tree is a hierarchy of tiles:
// depth 0 tiles the samples, depth d + 1 tiles the roots of depth d's
// whole tiles (level 7 (d + 1) nodes), up to a depth of at most one tile.
// Per stage:
//
// 1. up, depth 0, 1, ...: each whole tile's up-sweep, its root kept;
// 2. down, from the top depth to 0: each tile's up-sweep again, its top
//    node replaced by its prefix one depth up (a partial last tile, which
//    has no root, and the top depth's one tile start from their own top
//    node combined with the prefix before them), the down-sweep; at depth
//    0 the state applied: s1, s2 and y.
//
// A warp runs a tile: kLeaves = 4 nodes a lane, levels 1 and 2 in the
// lane's registers, levels 3..7 across lanes by shuffles, up and down.
// shared_kernel splits a row over a cluster of up to kMaxCluster blocks
// (as many as keep rows x blocks within the SMs and every warp a tile),
// kWarps warps each taking the tiles of a depth in turn, a cluster
// barrier between depths; a thread reads in a stage exactly the samples
// it wrote in the stage before, so stages need no barrier of their own.
// The roots of each depth live in a scratch row in global memory (two
// floats a node, two copies by the stage's parity), M_L in shared memory
// (two copies by parity, the next stage's loaded after the first
// barrier).  per_row_kernel is one block a row, thread 0 computing M_L.
//
// What bounds it: operations.  With shared coefficients a stage-sample of
// a row needs two combines' vectors (8 operations each: one up the tree,
// one down), the leaf and the apply: ~24 operations against 8 bytes
// moved, the matrices (M_L and the prefix matrices, 12 a combine) once a
// stage for all rows (chip_smoke.py::scan_flops), which is what the two
// launches do.  The row pass is latency-bound: each tile a chain of
// shuffle levels, its up-sweep issued twice; at depth 0 each warp fetches
// its next tile's x (16-byte words where the rows allow), prefix matrices
// and prefixes one depth up while it runs this one.
//
// Every product and sum rounds once (__fmul_rn, __fadd_rn, no FMA
// contraction), in the plain version's order: (p + q) + v in the
// combine, (P00 s1 + P01 s2) + V0 for the state, b0 x + s1[n-1] for y.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLeaves = 4;              // nodes a lane
constexpr int kTileLog = 7;             // a tile holds 2^kTileLog nodes
constexpr int kTile = 1 << kTileLog;
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDepth = 8;            // kTile^8 samples
constexpr int kLevels = kTileLog * kMaxDepth + 1;
constexpr int kMaxCluster = 8;          // blocks a row (portable cluster)
constexpr int kTabThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

static_assert(kTile == 32 * kLeaves, "a tile is a warp's leaves");

struct Args {
  const float* x;      // [rows, T]
  const float* c;      // [K, 5] (row_stride 0) or [rows, K, 5]
  const float* s_in;   // [rows, K, 2]
  float* y;            // [rows, T]
  float* s_out;        // [rows, K, 2]
  int t_n, k_n, scratch_n;
  long long row_stride;   // in floats
};

// shared coefficients: what table_kernel writes for shared_kernel
struct Table {
  float* p;        // [K, T, 2]: P00, P01 at every position
  float* pend;     // [K, 4]: P at T - 1
  float* mats;     // [K, kLevels, 4]: M_L
  float* roots;    // [rows, 2, scratch_n, 2]: every depth's node vectors
  int cl;          // blocks a row
};

// an affine map s -> A s + v
struct Elem {
  float a00, a01, a10, a11, v0, v1;
};

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// q after p (p the earlier map), as _affine_combine(p, q) rounds it
__device__ __forceinline__ Elem combine(const Elem& p, const Elem& q) {
  Elem r;
  r.a00 = add(mul(q.a00, p.a00), mul(q.a01, p.a10));
  r.a01 = add(mul(q.a00, p.a01), mul(q.a01, p.a11));
  r.a10 = add(mul(q.a10, p.a00), mul(q.a11, p.a10));
  r.a11 = add(mul(q.a10, p.a01), mul(q.a11, p.a11));
  r.v0 = add(add(mul(q.a00, p.v0), mul(q.a01, p.v1)), q.v0);
  r.v1 = add(add(mul(q.a10, p.v0), mul(q.a11, p.v1)), q.v1);
  return r;
}

// s1 (row 0) or s2 (row 1) of the map applied to the state (s1, s2)
__device__ __forceinline__ float apply0(const Elem& e, float s1, float s2) {
  return add(add(mul(e.a00, s1), mul(e.a01, s2)), e.v0);
}
__device__ __forceinline__ float apply1(const Elem& e, float s1, float s2) {
  return add(add(mul(e.a10, s1), mul(e.a11, s2)), e.v1);
}

// a map's vector; its matrix, on the way up, is its level's M_L
struct Vec {
  float v0, v1;
};

__device__ __forceinline__ Elem with_matrix(const float (&m)[4], Vec v) {
  return Elem{m[0], m[1], m[2], m[3], v.v0, v.v1};
}

// The vector of combine(p, q) where q's matrix is mq (p's is not read)
__device__ __forceinline__ Vec combine_v(const float (&mq)[4], Vec p, Vec q) {
  return Vec{add(add(mul(mq[0], p.v0), mul(mq[1], p.v1)), q.v0),
             add(add(mul(mq[2], p.v0), mul(mq[3], p.v1)), q.v1)};
}

__device__ __forceinline__ Vec shfl_down(Vec v, int d) {
  return Vec{__shfl_down_sync(kFull, v.v0, d),
             __shfl_down_sync(kFull, v.v1, d)};
}

__device__ __forceinline__ Vec shfl_up(Vec v, int d) {
  return Vec{__shfl_up_sync(kFull, v.v0, d), __shfl_up_sync(kFull, v.v1, d)};
}

__device__ __forceinline__ Elem shfl_up(const Elem& e, int d) {
  return Elem{__shfl_up_sync(kFull, e.a00, d), __shfl_up_sync(kFull, e.a01, d),
              __shfl_up_sync(kFull, e.a10, d), __shfl_up_sync(kFull, e.a11, d),
              __shfl_up_sync(kFull, e.v0, d), __shfl_up_sync(kFull, e.v1, d)};
}

__device__ __forceinline__ Elem load_elem(const float* p) {
  return Elem{p[0], p[1], p[2], p[3], p[4], p[5]};
}

__device__ __forceinline__ void store_elem(float* p, const Elem& e) {
  p[0] = e.a00;
  p[1] = e.a01;
  p[2] = e.a10;
  p[3] = e.a11;
  p[4] = e.v0;
  p[5] = e.v1;
}

// M_0 = the leaves' [[a1, 1], [a2, 0]]; M_L = M_{L-1} after M_{L-1}, for
// L < levels (the vectors stay 0)
__device__ __forceinline__ void level_matrices(float a1, float a2, int levels,
                                               float (*m)[4]) {
  Elem mm{a1, 1.f, a2, 0.f, 0.f, 0.f};
  for (int lv = 0; lv < levels; ++lv) {
    if (lv > 0) mm = combine(mm, mm);
    m[lv][0] = mm.a00;
    m[lv][1] = mm.a01;
    m[lv][2] = mm.a10;
    m[lv][3] = mm.a11;
  }
}

// A warp's tile: lane l holds nodes 4l .. 4l + 3 of c (valid ones).
// Level L node i exists when (i + 1) 2^L <= c; at level L >= 2 it lives
// in lane i 2^(L-2).  Up the tree every node of tile level L has the
// same matrix, the global level b + L's M (m[b + L], b the tile's base
// level), so the tile keeps the vectors alone.
struct Tile {
  Vec e0[kLeaves];          // level 0
  Vec e1[2];                // level 1: nodes 2l, 2l + 1
  Vec r[kTileLog - 1];      // r[L - 2]: level L >= 2, where this lane holds one
};

__device__ __forceinline__ void tile_up(Tile& t, int c,
                                        const float (*m)[4]) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < 2; ++q)
    if ((2 * l + q + 1) * 2 <= c)
      t.e1[q] = combine_v(m[0], t.e0[2 * q], t.e0[2 * q + 1]);
  if ((l + 1) * 4 <= c) t.r[0] = combine_v(m[1], t.e1[0], t.e1[1]);
#pragma unroll
  for (int lv = 3; lv <= kTileLog; ++lv) {
    // node 2i + 1 of level lv - 1 sits 2^(lv-3) lanes on
    const Vec nb = shfl_down(t.r[lv - 3], 1 << (lv - 3));
    const int stride = 1 << (lv - 2);
    if ((l & (stride - 1)) == 0 && ((l / stride + 1) << lv) <= c)
      t.r[lv - 2] = combine_v(m[lv - 1], t.r[lv - 3], nb);
  }
}

// The prefix vectors of the lane's nodes (into out), every later map a
// node of the tree.  m: the tile's levels' matrices; pre: the prefix
// before the tile (has_pre); top: the prefix of a whole tile's top node
// (given).
__device__ __forceinline__ void tile_down_v(const Tile& t, int c,
                                            const float (*m)[4], bool has_pre,
                                            Vec pre, bool given, Vec top,
                                            Vec (&out)[kLeaves]) {
  const int l = threadIdx.x & 31;
  Vec s{};   // this lane's prefix at the level above
#pragma unroll
  for (int lv = kTileLog; lv >= 2; --lv) {
    const int stride = 1 << (lv - 2);
    Vec odd_src = s, even_src = s;
    if (stride < 32) {
      odd_src = shfl_up(s, stride);          // S_{lv+1}[(i - 1) / 2]
      even_src = shfl_up(s, 2 * stride);     // S_{lv+1}[i / 2 - 1]
    }
    const int i = l / stride;
    if ((l & (stride - 1)) == 0 && ((i + 1) << lv) <= c) {
      const Vec r = t.r[lv - 2];
      if (i == 0)
        s = (lv == kTileLog && given) ? top
                                      : (has_pre ? combine_v(m[lv], pre, r)
                                                 : r);
      else if (i & 1)
        s = odd_src;
      else
        s = combine_v(m[lv], even_src, r);
    }
  }
  // level 1: node 2l + 1 takes S_2[l]; node 2l (l > 0) S_2[l - 1] with its own
  const Vec prev2 = shfl_up(s, 1);
  Vec s1 = s;
  if ((2 * l + 1) * 2 <= c)
    s1 = l > 0 ? combine_v(m[1], prev2, t.e1[0])
               : (has_pre ? combine_v(m[1], pre, t.e1[0]) : t.e1[0]);
  // level 0: 4l + 1 and 4l + 3 pass S_1 down; 4l + 2 combines S_1[2l];
  // 4l (l > 0) combines S_1[2l - 1] = S_2[l - 1]
  out[1] = s1;
  out[3] = s;
  out[2] = combine_v(m[0], s1, t.e0[2]);
  out[0] = l > 0 ? combine_v(m[0], prev2, t.e0[0])
                 : (has_pre ? combine_v(m[0], pre, t.e0[0]) : t.e0[0]);
}

// The prefixes, matrices carried (per_row_kernel).
__device__ __forceinline__ void tile_down(const Tile& t, int c,
                                          const float (*m)[4], bool has_pre,
                                          const Elem& pre, bool given,
                                          const Elem& top,
                                          Elem (&out)[kLeaves]) {
  const int l = threadIdx.x & 31;
  Elem s{};   // this lane's prefix at the level above
#pragma unroll
  for (int lv = kTileLog; lv >= 2; --lv) {
    const int stride = 1 << (lv - 2);
    Elem odd_src = s, even_src = s;
    if (stride < 32) {
      odd_src = shfl_up(s, stride);          // S_{lv+1}[(i - 1) / 2]
      even_src = shfl_up(s, 2 * stride);     // S_{lv+1}[i / 2 - 1]
    }
    const int i = l / stride;
    if ((l & (stride - 1)) == 0 && ((i + 1) << lv) <= c) {
      const Elem r = with_matrix(m[lv], t.r[lv - 2]);
      if (i == 0)
        s = (lv == kTileLog && given) ? top : (has_pre ? combine(pre, r) : r);
      else if (i & 1)
        s = odd_src;
      else
        s = combine(even_src, r);
    }
  }
  const Elem prev2 = shfl_up(s, 1);
  const Elem n1 = with_matrix(m[1], t.e1[0]);
  Elem s1 = s;
  if ((2 * l + 1) * 2 <= c)
    s1 = l > 0 ? combine(prev2, n1) : (has_pre ? combine(pre, n1) : n1);
  const Elem n0 = with_matrix(m[0], t.e0[0]);
  out[1] = s1;
  out[3] = s;
  out[2] = combine(s1, with_matrix(m[0], t.e0[2]));
  out[0] = l > 0 ? combine(prev2, n0) : (has_pre ? combine(pre, n0) : n0);
}

// the nodes of each depth: n[0] = T, n[d + 1] = n[d] / kTile while
// n[d] > kTile; returns the top depth.  off[d]: depth d's first node in the
// scratch row (depth 0 is the samples).
__host__ __device__ __forceinline__ int depths(int t_n, int (&n)[kMaxDepth],
                                               int (&off)[kMaxDepth]) {
  int d = 0;
  n[0] = t_n;
  off[0] = 0;
  int at = 0;
  while (n[d] > kTile && d + 1 < kMaxDepth) {
    n[d + 1] = n[d] / kTile;
    off[d + 1] = at;
    at += n[d + 1];
    ++d;
  }
  return d;
}

// the levels whose M the tiles read: those of depths 0 .. top
__host__ __device__ __forceinline__ int tree_levels(int top_d) {
  return kTileLog * (top_d + 1) + 1;
}

// A tile's vectors into registers: depth 0 the leaves' u x of src (the
// warp's next tile, `ahead` tiles on, prefetched into L2), above it those
// stored one depth down (nodes, `width` floats a node, the vector last).
__device__ __forceinline__ void load_tile(Tile& t, const float* src,
                                          const float* nodes, int width,
                                          int j, int cnt, int ahead, int t_n,
                                          float u0, float u1,
                                          float (&xv)[kLeaves]) {
  const int l = threadIdx.x & 31;
  if (nodes == nullptr && (j + ahead) * kTile + 4 * l < t_n)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        src + (j + ahead) * kTile + 4 * l));
#pragma unroll
  for (int q = 0; q < kLeaves; ++q) {
    const int i = 4 * l + q;
    if (i < cnt) {
      if (nodes == nullptr) {
        xv[q] = src[j * kTile + i];
        t.e0[q] = Vec{mul(u0, xv[q]), mul(u1, xv[q])};
      } else {
        const float* p = nodes + (size_t)(j * kTile + i) * width + width - 2;
        t.e0[q] = Vec{p[0], p[1]};
      }
    }
  }
}

// ---- shared coefficients ----------------------------------------------

// Block (x, k): stage k's M_L (block 0 also stores them), then thread n's
// prefix matrix P[n] by the bits of n + 1.
__global__ void __launch_bounds__(kTabThreads) table_kernel(Args a,
                                                            Table tb) {
  __shared__ float m[kLevels][4];
  const int k = blockIdx.y;
  int n_d[kMaxDepth], off[kMaxDepth];
  const int levels = tree_levels(depths(a.t_n, n_d, off));
  if (threadIdx.x == 0) level_matrices(a.c[k * 5 + 3], a.c[k * 5 + 4],
                                       levels, m);
  __syncthreads();
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < levels * 4; i += kTabThreads)
      tb.mats[(size_t)k * kLevels * 4 + i] = m[i / 4][i % 4];
  const int n = blockIdx.x * kTabThreads + threadIdx.x;
  if (n >= a.t_n) return;
  const unsigned m1 = (unsigned)n + 1u;
  const int top = 31 - __clz(m1);
  float p00 = m[top][0], p01 = m[top][1], p10 = m[top][2], p11 = m[top][3];
  for (int lv = top - 1; lv >= 0; --lv) {
    if (!((m1 >> lv) & 1u)) continue;
    const float* q = m[lv];
    const float r00 = add(mul(q[0], p00), mul(q[1], p10));
    const float r01 = add(mul(q[0], p01), mul(q[1], p11));
    const float r10 = add(mul(q[2], p00), mul(q[3], p10));
    const float r11 = add(mul(q[2], p01), mul(q[3], p11));
    p00 = r00;
    p01 = r01;
    p10 = r10;
    p11 = r11;
  }
  float* pk = tb.p + ((size_t)k * a.t_n + n) * 2;
  pk[0] = p00;
  pk[1] = p01;
  if (n == a.t_n - 1) {
    float* e = tb.pend + k * 4;
    e[0] = p00;
    e[1] = p01;
    e[2] = p10;
    e[3] = p11;
  }
}

__device__ __forceinline__ void row_sync(int cl) {
  if (cl == 1) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// A depth-0 tile's inputs, fetched a tile ahead: x at the lane's four
// positions; going down, also P00 and P01 there, the prefix before the
// tile (with, on lane 0, P00 and P01 at its end) and the tile's top.
struct Leaves {
  float x[kLeaves];
  float2 p[kLeaves];
  float2 p_pre;
  Vec pre, top;
};

__device__ __forceinline__ void fetch_leaves(Leaves& f, const float* src,
                                             const float* pk,
                                             const float* above, int j,
                                             int cnt, bool down, bool given,
                                             bool vec) {
  const int l = threadIdx.x & 31;
  const size_t at = (size_t)j * kTile + 4 * l;
  if (vec && cnt == kTile) {
    const float4 v = *reinterpret_cast<const float4*>(src + at);
    f.x[0] = v.x;
    f.x[1] = v.y;
    f.x[2] = v.z;
    f.x[3] = v.w;
    if (down) {
      const float4 p0 = *reinterpret_cast<const float4*>(pk + at * 2);
      const float4 p1 = *reinterpret_cast<const float4*>(pk + at * 2 + 4);
      f.p[0] = make_float2(p0.x, p0.y);
      f.p[1] = make_float2(p0.z, p0.w);
      f.p[2] = make_float2(p1.x, p1.y);
      f.p[3] = make_float2(p1.z, p1.w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kLeaves; ++q)
      if (4 * l + q < cnt) {
        f.x[q] = src[at + q];
        if (down)
          f.p[q] = *reinterpret_cast<const float2*>(pk + (at + q) * 2);
      }
  }
  if (down && j > 0) {
    f.pre = Vec{above[(j - 1) * 2], above[(j - 1) * 2 + 1]};
    if (l == 0)
      f.p_pre = *reinterpret_cast<const float2*>(
          pk + ((size_t)j * kTile - 1) * 2);
  }
  if (down && given) f.top = Vec{above[j * 2], above[j * 2 + 1]};
}

__device__ __forceinline__ void leaves_of(Tile& t, const Leaves& f, int cnt,
                                          float u0, float u1) {
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < kLeaves; ++q)
    if (4 * l + q < cnt) t.e0[q] = Vec{mul(u0, f.x[q]), mul(u1, f.x[q])};
}

// blockIdx.x = cl * row + rank; the row's cl x kWarps warps take the
// tiles of each depth in turn.
__global__ void __launch_bounds__(kThreads) shared_kernel(Args a, Table tb) {
  const int cl = tb.cl;
  const int gw = (int)(blockIdx.x % cl) * kWarps + (threadIdx.x >> 5);
  const int nw = cl * kWarps;
  const int l = threadIdx.x & 31;
  const size_t r = blockIdx.x / cl;
  const float* src = a.x + r * a.t_n;
  float* y = a.y + r * a.t_n;
  __shared__ float m[2][kLevels][4];   // M_L by the stage's parity
  int n[kMaxDepth], off[kMaxDepth];
  const int top_d = depths(a.t_n, n, off);
  const int levels = tree_levels(top_d);
  const int tiles0 = (a.t_n + kTile - 1) / kTile, whole0 = a.t_n / kTile;
  auto load_m = [&](int k) {
    for (int i = threadIdx.x; i < levels * 4; i += kThreads)
      m[k & 1][i / 4][i % 4] = tb.mats[(size_t)k * kLevels * 4 + i];
  };
  load_m(0);
  row_sync(cl);

  for (int k = 0; k < a.k_n; ++k) {
    const float* c = a.c + k * 5;
    const float b0 = c[0], b1 = c[1], b2 = c[2], a1 = c[3], a2 = c[4];
    const float u0 = add(b1, mul(a1, b0)), u1 = add(b2, mul(a2, b0));
    const size_t s_at = (r * a.k_n + k) * 2;
    const float s1_in = a.s_in[s_at], s2_in = a.s_in[s_at + 1];
    const float(*mk)[4] = m[k & 1];
    float* roots = tb.roots + (r * 2 + (k & 1)) * (size_t)a.scratch_n * 2;
    const float* pk = tb.p + (size_t)k * a.t_n * 2;
    // whole tiles as float4 where the rows allow it
    const bool vec = a.t_n % 4 == 0 && ((size_t)src & 15) == 0 &&
                     ((size_t)y & 15) == 0;
    if (top_d == 0 && k > 0) {
      load_m(k);
      row_sync(cl);
    }

    // 1. up: each whole tile's root vector, one depth up
    for (int d = 0; d < top_d; ++d) {
      const int whole = n[d] / kTile;
      float* above = roots + off[d + 1] * 2;
      if (d == 0) {
        Leaves f{}, fn{};
        if (gw < whole)
          fetch_leaves(f, src, pk, nullptr, gw, kTile, false, false, vec);
        for (int j = gw; j < whole; j += nw) {
          if (j + nw < whole)
            fetch_leaves(fn, src, pk, nullptr, j + nw, kTile, false, false,
                         vec);
          Tile t{};
          leaves_of(t, f, kTile, u0, u1);
          tile_up(t, kTile, mk);
          if (l == 0) {
            above[j * 2] = t.r[kTileLog - 2].v0;
            above[j * 2 + 1] = t.r[kTileLog - 2].v1;
          }
          f = fn;
        }
      } else {
        const float* nodes = roots + off[d] * 2;
        for (int j = gw; j < whole; j += nw) {
          Tile t{};
          float xv[kLeaves];
          load_tile(t, src, nodes, 2, j, kTile, nw, a.t_n, u0, u1, xv);
          tile_up(t, kTile, mk + kTileLog * d);
          if (l == 0) {
            above[j * 2] = t.r[kTileLog - 2].v0;
            above[j * 2 + 1] = t.r[kTileLog - 2].v1;
          }
        }
      }
      row_sync(cl);
      // every warp is past the stage before: its M's copy is free
      if (d == 0 && k + 1 < a.k_n) load_m(k + 1);
    }
    // 2. down, above depth 0: each tile's prefix vectors, in place, from
    // its prefix one depth up
    for (int d = top_d; d > 0; --d) {
      const int nd = n[d];
      const int tiles = (nd + kTile - 1) / kTile;
      float* nodes = roots + off[d] * 2;
      const float* above = d < top_d ? roots + off[d + 1] * 2 : nullptr;
      for (int j = gw; j < tiles; j += nw) {
        const int cnt = min(kTile, nd - j * kTile);
        Tile t{};
        float xv[kLeaves];
        load_tile(t, src, nodes, 2, j, cnt, nw, a.t_n, u0, u1, xv);
        tile_up(t, cnt, mk + kTileLog * d);
        const bool has_pre = j > 0;
        const bool given = d < top_d && cnt == kTile;
        Vec pre{}, top{};
        if (has_pre) pre = Vec{above[(j - 1) * 2], above[(j - 1) * 2 + 1]};
        if (given) top = Vec{above[j * 2], above[j * 2 + 1]};
        Vec out[kLeaves];
        tile_down_v(t, cnt, mk + kTileLog * d, has_pre, pre, given, top, out);
#pragma unroll
        for (int q = 0; q < kLeaves; ++q)
          if (4 * l + q < cnt) {
            nodes[(j * kTile + 4 * l + q) * 2] = out[q].v0;
            nodes[(j * kTile + 4 * l + q) * 2 + 1] = out[q].v1;
          }
      }
      row_sync(cl);
    }
    // 3. depth 0: each tile's prefix vectors, the state through the
    // prefix matrices, y (each tile's inputs fetched a tile ahead)
    const float* above = top_d > 0 ? roots + off[1] * 2 : nullptr;
    Leaves f{}, fn{};
    if (gw < tiles0)
      fetch_leaves(f, src, pk, above, gw, min(kTile, a.t_n - gw * kTile),
                   true, gw < whole0 && top_d > 0, vec);
    for (int j = gw; j < tiles0; j += nw) {
      const int cnt = min(kTile, a.t_n - j * kTile);
      const int jn = j + nw;
      if (jn < tiles0)
        fetch_leaves(fn, src, pk, above, jn, min(kTile, a.t_n - jn * kTile),
                     true, jn < whole0 && top_d > 0, vec);
      Tile t{};
      leaves_of(t, f, cnt, u0, u1);
      tile_up(t, cnt, mk);
      const bool has_pre = j > 0;
      Vec out[kLeaves];
      tile_down_v(t, cnt, mk, has_pre, f.pre, top_d > 0 && cnt == kTile,
                  f.top, out);
      float s1[kLeaves] = {}, yv[kLeaves] = {};
#pragma unroll
      for (int q = 0; q < kLeaves; ++q)
        if (4 * l + q < cnt)
          s1[q] = add(add(mul(f.p[q].x, s1_in), mul(f.p[q].y, s2_in)),
                      out[q].v0);
      const float s1_left = __shfl_up_sync(kFull, s1[kLeaves - 1], 1);
      float s1_pre = s1_in;
      if (has_pre && l == 0)
        s1_pre = add(add(mul(f.p_pre.x, s1_in), mul(f.p_pre.y, s2_in)),
                     f.pre.v0);
#pragma unroll
      for (int q = 0; q < kLeaves; ++q) {
        const float prev = q > 0 ? s1[q - 1] : (l > 0 ? s1_left : s1_pre);
        yv[q] = add(mul(b0, f.x[q]), prev);
      }
      const size_t at = (size_t)j * kTile + 4 * l;
      if (vec && cnt == kTile) {
        *reinterpret_cast<float4*>(y + at) =
            make_float4(yv[0], yv[1], yv[2], yv[3]);
      } else {
#pragma unroll
        for (int q = 0; q < kLeaves; ++q)
          if (4 * l + q < cnt) y[at + q] = yv[q];
      }
#pragma unroll
      for (int q = 0; q < kLeaves; ++q)
        if (at + q == (size_t)a.t_n - 1) {
          const float* e = tb.pend + k * 4;
          a.s_out[s_at] = s1[q];
          a.s_out[s_at + 1] =
              add(add(mul(e[2], s1_in), mul(e[3], s2_in)), out[q].v1);
        }
      f = fn;
    }
    src = y;
  }
}

// ---- per-row coefficients ---------------------------------------------

__global__ void __launch_bounds__(kThreads) per_row_kernel(Args a,
                                                           float* roots_all) {
  const int warp = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  const size_t r = blockIdx.x;
  const float* src = a.x + r * a.t_n;
  float* y = a.y + r * a.t_n;
  float* roots = roots_all + r * (size_t)a.scratch_n * 6;
  __shared__ float m[kLevels][4];   // M_L: every node's matrix up the tree
  int n[kMaxDepth], off[kMaxDepth];
  const int top_d = depths(a.t_n, n, off);

  for (int k = 0; k < a.k_n; ++k) {
    const float* c = a.c + r * a.row_stride + k * 5;
    const float b0 = c[0], b1 = c[1], b2 = c[2], a1 = c[3], a2 = c[4];
    const float u0 = add(b1, mul(a1, b0)), u1 = add(b2, mul(a2, b0));
    const size_t s_at = (r * a.k_n + k) * 2;
    const float s1_in = a.s_in[s_at], s2_in = a.s_in[s_at + 1];
    if (threadIdx.x == 0) level_matrices(a1, a2, tree_levels(top_d), m);
    __syncthreads();

    // 1. up: each whole tile's root, one depth up
    for (int d = 0; d < top_d; ++d) {
      const int whole = n[d] / kTile;
      const float* nodes = d > 0 ? roots + off[d] * 6 : nullptr;
      float* above = roots + off[d + 1] * 6;
      for (int j = warp; j < whole; j += kWarps) {
        Tile t{};
        float xv[kLeaves];
        load_tile(t, src, nodes, 6, j, kTile, kWarps, a.t_n, u0, u1, xv);
        tile_up(t, kTile, m + kTileLog * d);
        if (l == 0)
          store_elem(above + j * 6, with_matrix(m[kTileLog * (d + 1)],
                                                t.r[kTileLog - 2]));
      }
      __syncthreads();
    }
    // 2. down: each tile's prefixes from its prefix one depth up
    for (int d = top_d; d >= 0; --d) {
      const int nd = n[d];
      const int tiles = (nd + kTile - 1) / kTile;
      float* nodes = d > 0 ? roots + off[d] * 6 : nullptr;
      const float* above = d < top_d ? roots + off[d + 1] * 6 : nullptr;
      for (int j = warp; j < tiles; j += kWarps) {
        const int cnt = min(kTile, nd - j * kTile);
        Tile t{};
        float xv[kLeaves] = {};
        load_tile(t, src, nodes, 6, j, cnt, kWarps, a.t_n, u0, u1, xv);
        tile_up(t, cnt, m + kTileLog * d);
        const bool has_pre = j > 0;
        const bool given = d < top_d && cnt == kTile;
        Elem pre{}, top{};
        if (has_pre) pre = load_elem(above + (j - 1) * 6);
        if (given) top = load_elem(above + j * 6);
        Elem out[kLeaves];
        tile_down(t, cnt, m + kTileLog * d, has_pre, pre, given, top, out);
        if (d > 0) {
#pragma unroll
          for (int q = 0; q < kLeaves; ++q)
            if (4 * l + q < cnt)
              store_elem(nodes + (j * kTile + 4 * l + q) * 6, out[q]);
          continue;
        }
        float s1[kLeaves];
#pragma unroll
        for (int q = 0; q < kLeaves; ++q) s1[q] = apply0(out[q], s1_in, s2_in);
        const float s1_left = __shfl_up_sync(kFull, s1[kLeaves - 1], 1);
        const float s1_pre = has_pre ? apply0(pre, s1_in, s2_in) : s1_in;
#pragma unroll
        for (int q = 0; q < kLeaves; ++q) {
          const int i = 4 * l + q;
          if (i < cnt) {
            const float prev = q > 0 ? s1[q - 1] : (l > 0 ? s1_left : s1_pre);
            y[j * kTile + i] = add(mul(b0, xv[q]), prev);
            if (j * kTile + i == a.t_n - 1) {
              a.s_out[s_at] = s1[q];
              a.s_out[s_at + 1] = apply1(out[q], s1_in, s2_in);
            }
          }
        }
      }
      __syncthreads();
    }
    src = y;
  }
}

int scratch_nodes(int t_n) {
  int n[kMaxDepth], off[kMaxDepth];
  const int top_d = depths(t_n, n, off);
  int at = 0;
  for (int d = 1; d <= top_d; ++d) at += n[d];
  return at;
}

// blocks a row: the most (a power of two up to kMaxCluster) that keep
// rows x blocks within the SMs and give every warp a depth-0 tile
int cluster_blocks(int rows, int t_n) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 1;
  const long long tiles = (t_n + kTile - 1) / kTile;
  int cl = 1;
  while (cl < kMaxCluster && (long long)rows * cl * 2 <= sms &&
         (long long)cl * 2 * kWarps <= tiles)
    cl *= 2;
  return cl;
}

// The table and the root scratch of a shared-coefficient call, in scratch.
Table table_of(float* scratch, int rows, int t_n, int k_n) {
  const size_t p_n = (size_t)k_n * t_n * 2;
  const size_t mats = p_n + (size_t)k_n * 4;
  return Table{scratch, scratch + p_n, scratch + mats,
               scratch + mats + (size_t)k_n * kLevels * 4,
               cluster_blocks(rows, t_n)};
}

}  // namespace

extern "C" {

// The floats of scratch a call needs, into *floats: with shared
// coefficients (row_stride 0) the table [K, T, 2], P at T - 1 [K, 4], M_L
// [K, kLevels, 4] and two copies of each row's root vectors; per row six
// floats a root.
int lsp_biquad_scan_scratch(int rows, int t_n, int k_n, long long row_stride,
                            long long* floats) {
  if (rows < 1 || t_n < 1 || k_n < 1) return (int)cudaErrorInvalidValue;
  const long long nodes = scratch_nodes(t_n);
  *floats = row_stride != 0
                ? (long long)rows * nodes * 6
                : (long long)k_n * t_n * 2 + (long long)k_n * 4 +
                      (long long)k_n * kLevels * 4 + (long long)rows * 4 * nodes;
  return (int)cudaSuccess;
}

// Shared coefficients c [K, 5]: the stages' M_L and prefix matrices into
// scratch, for lsp_biquad_scan.  One launch.  Returns a cudaError_t.
int lsp_biquad_scan_table(const float* c, float* scratch, int rows, int t_n,
                          int k_n, void* stream) {
  if (rows < 1 || t_n < 1 || k_n < 1) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, c, nullptr, nullptr, nullptr, t_n, k_n,
               scratch_nodes(t_n), 0};
  table_kernel<<<dim3((t_n + kTabThreads - 1) / kTabThreads, k_n),
                 kTabThreads, 0, (cudaStream_t)stream>>>(
      a, table_of(scratch, rows, t_n, k_n));
  return (int)cudaGetLastError();
}

// All K stages of the cascade over rows x T samples; scratch:
// lsp_biquad_scan_scratch floats, with shared coefficients (row_stride 0)
// after lsp_biquad_scan_table on the same scratch.  One launch.  Returns a
// cudaError_t.
int lsp_biquad_scan(const float* x, const float* c, const float* s_in,
                    float* y, float* s_out, float* scratch, int rows,
                    int t_n, int k_n, long long row_stride, void* stream) {
  if (rows < 1 || t_n < 1 || k_n < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Args a{x, c, s_in, y, s_out, t_n, k_n, scratch_nodes(t_n),
               row_stride};
  if (row_stride != 0) {
    per_row_kernel<<<rows, kThreads, 0, s>>>(a, scratch);
    return (int)cudaGetLastError();
  }
  const Table tb = table_of(scratch, rows, t_n, k_n);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows * tb.cl);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = tb.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, shared_kernel, a, tb);
}

}  // extern "C"
