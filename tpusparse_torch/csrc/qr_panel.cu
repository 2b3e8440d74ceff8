// Householder QR of one panel of columns, for a batch of fronts (H2):
// in place, columns [k0, k0 + pb) of each (m, C) front of M (P, m, C) f32
// become the panel's reflectors below the diagonal and R on and above it,
// taus[p][k0 + j] its coefficients, and the kernel also writes V (P,
// m - k0, pb), the panel's unit lower-trapezoidal reflectors from row k0
// on, and T (P, pb, pb), its compact-WY factor (Q_panel = I - V T V^T),
// which the trailing update of the rest of the front uses.
//
// Computes what the column loop of qr_factor_partial and blocked_qr in
// tpusparse/device/dense.py (:239-262, :115-141) and its _form_t (:167)
// compute; the JAX package has no Pallas kernel for it (XLA fuses the
// column loop).  The Householder rule is that code's and not LAPACK's
// larfg: a column whose part below the diagonal is zero but whose
// diagonal x0 is not is still reflected (tau = 2, R = -x0); only a zero
// column gets tau = 0.  For column j of the panel, over rows r >= j:
//   normx = ||M[j:, j]||, alpha = -(x0 >= 0 ? 1 : -1) normx,
//   safe = x0 - alpha (1 where that is 0), v = M[r, j] / safe below j,
//   v[j] = 1, tau = (normx == 0 ? 0 : (alpha - x0) / alpha),
//   w[k] = v . M[:, k],  M[:, k] -= (tau v) w[k]  for the panel's k >= j,
// and v is stored below the diagonal.  Rows above k0 are not touched: v
// is zero there.
//
// One reduction a column.  Each thread forms, in one pass over its own
// rows r > j, the pb raw sums s[k] = sum_r M[r, j] M[r, k] (k over the
// whole panel), and they are reduced once.  Every thread then derives the
// same scalars by itself: normx = sqrt(x0^2 + s[j]), alpha, safe, tau,
// and w[k] = M[j, k] + s[k] / safe, which is v . M[:, k] with v[j] = 1.
// For k < j, M[j, k] holds v_k's entry in row j, so w[k] = v_k . v_j is
// the column of V^T V that the compact-WY recurrence needs, and T costs no
// pass of its own: lane i < pb of one warp keeps row i of T in registers
// and adds T[i][j] = -tau T[i][:j] . w[:j] (tau at i = j) at each column.
// Row j's values M[j, :] come from the thread that holds row j (always
// slot 0 of thread j: every regime puts rows 0..31 on one warp, in order)
// and are written to a buffer of their own, never added, so a -0.0 keeps
// its sign.  Where the part below the diagonal is zero, every s[k] is
// exactly 0, normx = sqrt(x0^2) = |x0|, tau = 2 and R = x0 - 2 x0 = -x0,
// bit for bit, as the JAX rule has it.  The division is one reciprocal,
// 1 / safe, multiplied into v and w (within an ulp of dividing).
//
// Which regime takes a panel (mm = m - k0 rows; PB = 4, 8 or 16, the
// template width that holds pb):
// - a warp a front, four fronts a block, for mm <= 256 (PB <= 8) or 128
//   (PB = 16): a lane holds rows lane + 32 s, s < R (R = 1, 2, 4 or 8), all
//   PB columns, in registers.  The sums are all-reduced by a reduce-scatter
//   over halves (pb - 1 shuffles, then 5 - log2 pb to finish) and a
//   broadcast (pb shuffles): 17 shuffles at pb = 8 instead of 9 x 5.  Row j
//   goes through a small buffer of the warp's own.  No block barrier: one
//   __syncwarp a column.  The QR leg's buckets (8, 24) .. (256, 128) and
//   g=363's small ones, the 10,919 (32, 48) fronts of one batch among them.
// - a block a front for mm up to 2,048 (PB <= 8, 8 rows a thread) or 1,024
//   (PB = 16, 4 rows a thread), at most 256 threads: rows base + s nt in
//   registers, each loaded once, with 16-byte loads where C, k0 and pb are
//   multiples of 4.  Each warp reduce-scatters its sums and writes its pb
//   partials into a buffer double-buffered by column parity; after the one
//   __syncthreads of the column, every thread sums the nw partial vectors
//   itself (nw <= 64 / pb) or each warp reads them a vector a lane and
//   all-reduces them (the loops have fixed trip counts and predicates: a
//   loop with a runtime count unrolled into branches cost more than the
//   sums).  One barrier a column.  Every front of g=363 up to (1,760,
//   1,312).
// - a thread-block cluster of G = ceil(mm / 512) CTAs (2 <= G <= 8, the
//   portable size) for the taller panels, TpuQR's panels of 16 over 4,096
//   rows: CTA c holds a contiguous range of the rows as the block regime
//   does, and writes its partials (and CTA 0 row j) into every CTA's
//   buffer through distributed shared memory, so one barrier.cluster a
//   column (cooperative_groups' cluster.sync()) is the only barrier; each
//   CTA then reads the G nw partial vectors from its own shared memory.
//   Launched with cudaLaunchKernelEx and a cluster dimension; a refused
//   launch returns its error.
// - a panel taller than the largest cluster holds (16,384 rows at PB <= 8,
//   8,192 at PB = 16; TpuQR at m n = 2^22 with n <= 64) runs one block a
//   front on the panel in device memory: a block-wide sum for the norm and
//   one for the pb dot products, four barriers a column (a size rule, as
//   the shared-memory test of the first design was, not a fallback).
//
// What bounds it: about 4 mm pb^2 FLOP on 2 mm pb floats read and written
// plus V, a little over pb FLOP per byte, so neither the bytes nor the
// FLOP: a panel is a serial chain of pb columns.  In the warp regime a
// column is the local sums, the all-reduce, a square root and a
// reciprocal, and the update (tpt_qr_chain_probe times the middle of it).
// The block and cluster regimes add one barrier (cluster.sync() compiles
// to a barrier behind a GPU-wide memory fence, several times a
// __syncthreads) and the read of the partials; a CTA's rows cost R pb
// fused multiply-adds a thread a column twice.  Outside the chain, the
// rows come and go at the front's row stride: a warp's 16-byte access
// touches a line a lane (at PB = 8 lanes take rows in pairs, 16 lines an
// access), so the loads and stores of a tall front, and of the 10,919
// fronts of one batch, are bound by the load/store unit's lines a cycle
// rather than by the bytes.  The column loop is not unrolled (see
// rotate()), so a launch runs the same few hundred instructions pb times.
// The device-memory path is bound by its four barriers and its loads from
// L2 a column.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 4;             // fronts a block, warp regime
constexpr int kBlockThreads = 256;    // most threads a CTA, block regime
constexpr int kMaxCluster = 8;        // the portable cluster size
constexpr int kClusterRows = 512;     // rows a CTA aims at in a cluster
constexpr int kGmemWarps = 16;        // device-memory path: <= 512 threads

__host__ __device__ constexpr int log2c(int n) {
  return n <= 1 ? 0 : 1 + log2c(n / 2);
}

// Rows a lane holds at most in the warp regime, and a thread in the block
// and cluster regimes, at template width PB.
template <int PB>
constexpr int kRows = PB <= 8 ? 8 : 4;

// The regime of a panel of mm rows and pb columns: a warp a front (0), a
// block a front (1), a cluster of G >= 2 CTAs a front (G), or the
// device-memory path (-1).
int regime(int mm, int pb) {
  const int rows = pb <= 8 ? 8 : 4;
  const int cap = kBlockThreads * rows;         // rows one CTA holds
  if (mm <= 32 * rows) {
    return 0;
  }
  if (mm <= cap) {
    return 1;
  }
  if (mm > kMaxCluster * cap) {
    return -1;
  }
  const int G = (mm + kClusterRows - 1) / kClusterRows;
  return G < 2 ? 2 : (G > kMaxCluster ? kMaxCluster : G);
}

// The warp's sum of v[lane / (32 / N)]; v is clobbered.  Halving
// exchanges over lane bits 4, 3, ... (N - 1 shuffles), then a butterfly
// over the 32 / N lanes that hold the same value.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N], int lane) {
  constexpr int kSteps = log2c(N);
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int h = N >> (st + 1), o = 16 >> st;
    const bool up = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      if (i < h) {
        const float send = up ? v[i] : v[i + h];
        const float keep = up ? v[i + h] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, o);
      }
    }
  }
  float s = v[0];
#pragma unroll
  for (int st = 0; st < 5 - kSteps; ++st) {
    s += __shfl_xor_sync(kFull, s, (16 >> kSteps) >> st);
  }
  return s;
}

// s[k] = the warp's sum of value k, from reduce_scatter's result.
template <int N>
__device__ __forceinline__ void broadcast(float mine, float (&s)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    s[k] = __shfl_sync(kFull, mine, k * (32 / N));
  }
}

struct Reflector {
  float x0, tau, rinv;
};

// The JAX rule's scalars of a column from x0 = M[j, j] and sjj =
// sum_{r > j} M[r, j]^2; every thread computes the same bits.
__device__ __forceinline__ Reflector reflector(float x0, float sjj) {
  const float normx = sqrtf(fmaf(x0, x0, sjj));
  const float alpha = x0 >= 0.0f ? -normx : normx;
  const float denom = x0 - alpha;
  const float safe = denom == 0.0f ? 1.0f : denom;
  Reflector f;
  f.x0 = x0;
  f.tau = normx == 0.0f
      ? 0.0f : (alpha - x0) / (alpha == 0.0f ? 1.0f : alpha);
  f.rinv = 1.0f / safe;
  return f;
}

// The column loop is not unrolled: every column runs the same code, in
// which the current column is slot 0 of a row's registers.  After column
// j, rotate() moves slot 0 to slot PB - 1 and every other slot down one,
// so slots 1 .. PB-1-j hold the columns after j, in order, and slots
// PB-j .. PB-1 the finished columns 0 .. j-1; after PB rotations the
// order is the panel's again.

// Slot 0 to PB - 1, slot k to k - 1.
template <int PB>
__device__ __forceinline__ void rotate(float (&a)[PB]) {
  const float x = a[0];
#pragma unroll
  for (int k = 0; k < PB - 1; ++k) {
    a[k] = a[k + 1];
  }
  a[PB - 1] = x;
}

// acc[k] += M[r, j] M[r, k] for a row r below j (below false: nothing).
template <int PB>
__device__ __forceinline__ void accumulate(const float (&a)[PB], bool below,
                                           float (&acc)[PB]) {
  const float x = below ? a[0] : 0.0f;
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    acc[k] = fmaf(x, a[k], acc[k]);
  }
}

// A row after column j's reflection, then rotated: below (the row is
// below j) or at j (it is row j); rows above j only rotate.  wt is w on
// the columns after j and 0 on the finished ones, which keep.
template <int PB>
__device__ __forceinline__ void reflect_row(float (&a)[PB], bool below,
                                            bool at, const Reflector& f,
                                            float w0,
                                            const float (&wt)[PB]) {
  if (below || at) {
    const float v = below ? a[0] * f.rinv : 1.0f;
    const float tv = f.tau * v;
#pragma unroll
    for (int k = 1; k < PB; ++k) {
      a[k] = fmaf(-tv, wt[k], a[k]);
    }
    a[0] = below ? v : fmaf(-f.tau, w0, f.x0);
  }
  rotate(a);
}

// Row i = lane of T at column j, then rotated: tau_j on the diagonal,
// -tau_j T[i, :j] . (V^T V)[:j, j] above it (w on the finished slots is
// that column; T's slots of later columns are still 0), 0 below.
template <int PB>
__device__ __forceinline__ void t_column(float (&t)[PB], int lane, int j,
                                         float tau, const float (&w)[PB]) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 1; k < PB; ++k) {
    acc = fmaf(t[k], w[k], acc);
  }
  t[0] = lane < j ? -tau * acc : (lane == j ? tau : 0.0f);
  rotate(t);
}

// w on the columns after j (slots 1 .. PB-1-j), 0 on the finished ones.
template <int PB>
__device__ __forceinline__ void trailing(const float (&w)[PB], int j,
                                         float (&wt)[PB]) {
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    wt[k] = k < PB - j ? w[k] : 0.0f;
  }
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

// x of the neighbouring lane (lane ^ 1).
__device__ __forceinline__ float4 swap_pair(float4 x) {
  return make_float4(__shfl_xor_sync(kFull, x.x, 1),
                     __shfl_xor_sync(kFull, x.y, 1),
                     __shfl_xor_sync(kFull, x.z, 1),
                     __shfl_xor_sync(kFull, x.w, 1));
}

// Row r's pb values of the panel Mp (row stride C; zeros past pb and for a
// row past the front), 16 bytes at a time where vec & 1.  Rows lie at the
// front's stride, so a warp's 16-byte load touches one line a lane.  At
// PB = 8 (rows of 32 bytes, pb = 8 where vec) lanes l and l ^ 1, which
// hold rows r & ~1 and r | 1 in every regime, load both rows half each,
// so a load touches 16 lines, and one exchange gives each lane its row.
// Every lane of the warp calls it.
template <int PB>
__device__ __forceinline__ void load_row(float (&a)[PB], const float* Mp,
                                         int C, int r, int mm, int pb,
                                         int vec) {
  const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if constexpr (PB == 8) {
    if (vec & 1) {
      const int hi = r & 1, re = r & ~1, ro = r | 1;
      const float4 first =
          re < mm ? load4(Mp + static_cast<size_t>(re) * C + 4 * hi) : z;
      const float4 second =
          ro < mm ? load4(Mp + static_cast<size_t>(ro) * C + 4 * hi) : z;
      const float4 got = swap_pair(hi ? first : second);
      const float4 lo = hi ? got : first, up = hi ? second : got;
      a[0] = lo.x;
      a[1] = lo.y;
      a[2] = lo.z;
      a[3] = lo.w;
      a[4] = up.x;
      a[5] = up.y;
      a[6] = up.z;
      a[7] = up.w;
      return;
    }
  }
  const float* src = Mp + static_cast<size_t>(r) * C;
  const bool ok = r < mm;
  if (vec & 1) {
#pragma unroll
    for (int q = 0; q < PB / 4; ++q) {
      const float4 x = ok && 4 * q < pb ? load4(src + 4 * q) : z;
      a[4 * q] = x.x;
      a[4 * q + 1] = x.y;
      a[4 * q + 2] = x.z;
      a[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      a[k] = ok && k < pb ? src[k] : 0.0f;
    }
  }
}

// Row r's pb values back to the panel Mp (pairs of lanes as load_row
// reads them) and its row of V, Vp + r pb (v below the diagonal, 1 on
// it, 0 above; a warp's rows of V are contiguous).  Every lane of the
// warp calls it.
template <int PB>
__device__ __forceinline__ void store_row(const float (&a)[PB], float* Mp,
                                          int C, float* Vp, int r, int mm,
                                          int pb, int vec) {
  const bool ok = r < mm;
  float* dst = Mp + static_cast<size_t>(r) * C;
  float* vdst = Vp + static_cast<size_t>(r) * pb;
  float v[PB];
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    v[k] = r > k ? a[k] : (r == k ? 1.0f : 0.0f);
  }
  if constexpr (PB == 8) {
    if (vec & 1) {
      const int hi = r & 1, re = r & ~1, ro = r | 1;
      const float4 lo = make_float4(a[0], a[1], a[2], a[3]);
      const float4 up = make_float4(a[4], a[5], a[6], a[7]);
      const float4 got = swap_pair(hi ? lo : up);
      if (re < mm) {
        store4(Mp + static_cast<size_t>(re) * C + 4 * hi, hi ? got : lo);
      }
      if (ro < mm) {
        store4(Mp + static_cast<size_t>(ro) * C + 4 * hi, hi ? up : got);
      }
    }
  }
  if (!ok) {
    return;
  }
#pragma unroll
  for (int q = 0; q < PB / 4; ++q) {
    if (4 * q < pb) {
      if ((vec & 1) && PB != 8) {
        store4(dst + 4 * q, make_float4(a[4 * q], a[4 * q + 1],
                                        a[4 * q + 2], a[4 * q + 3]));
      }
      if (vec & 2) {
        store4(vdst + 4 * q, make_float4(v[4 * q], v[4 * q + 1],
                                         v[4 * q + 2], v[4 * q + 3]));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    if (k < pb) {
      if (!(vec & 1)) {
        dst[k] = a[k];
      }
      if (!(vec & 2)) {
        vdst[k] = v[k];
      }
    }
  }
}

// taus and row i = lane of T, from the lane that formed them.
template <int PB>
__device__ __forceinline__ void store_t(const float (&t)[PB], float tau,
                                        float* taus, float* Trow, int pb) {
  *taus = tau;
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    if (k < pb) {
      Trow[k] = t[k];
    }
  }
}

template <int PB>
__device__ __forceinline__ void put4(float* dst, const float (&a)[PB]) {
#pragma unroll
  for (int q = 0; q < PB / 4; ++q) {
    reinterpret_cast<float4*>(dst)[q] = make_float4(
        a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
  }
}

template <int PB>
__device__ __forceinline__ void get4(float (&a)[PB], const float* src) {
#pragma unroll
  for (int q = 0; q < PB / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(src)[q];
    a[4 * q] = x.x;
    a[4 * q + 1] = x.y;
    a[4 * q + 2] = x.z;
    a[4 * q + 3] = x.w;
  }
}

// The warp regime: front p = blockIdx.x * kWarps + warp, its rows in the
// lanes' registers (row lane + 32 s in slot s).
template <int PB, int R>
__global__ void __launch_bounds__(kWarps * 32)
qr_panel_warp_kernel(float* M, float* __restrict__ taus,
                     float* __restrict__ V, float* __restrict__ T, int P,
                     int m, int C, int k0, int pb, int vec) {
  __shared__ __align__(16) float rowj[kWarps][2][PB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * kWarps + warp;
  if (p >= P) {
    return;
  }
  const int mm = m - k0;
  float* Mp = M + static_cast<size_t>(p) * m * C
              + static_cast<size_t>(k0) * C + k0;
  float a[R][PB];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = lane + 32 * s;
    load_row(a[s], Mp, C, r, mm, pb, vec);
  }
  float t[PB];
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    t[k] = 0.0f;
  }
  float tau_mine = 0.0f;
#pragma unroll 1
  for (int j = 0; j < pb; ++j) {
    float* buf = rowj[warp][j & 1];
    float acc[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      acc[k] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      accumulate(a[s], s > 0 || lane > j, acc);
    }
    if (lane == j) {
      put4(buf, a[0]);
    }
    float sums[PB], row[PB], w[PB], wt[PB];
    broadcast<PB>(reduce_scatter<PB>(acc, lane), sums);
    __syncwarp();
    get4(row, buf);
    const Reflector f = reflector(row[0], sums[0]);
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      w[k] = fmaf(sums[k], f.rinv, row[k]);
    }
    trailing(w, j, wt);
    t_column(t, lane, j, f.tau, w);
    if (lane == j) {
      tau_mine = f.tau;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      reflect_row(a[s], s > 0 || lane > j, s == 0 && lane == j, f, w[0],
                  wt);
    }
  }
  for (int e = pb; e < PB; ++e) {       // back to the panel's order
#pragma unroll
    for (int s = 0; s < R; ++s) {
      rotate(a[s]);
    }
    rotate(t);
  }
  float* Vp = V + static_cast<size_t>(p) * mm * pb;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    store_row(a[s], Mp, C, Vp, lane + 32 * s, mm, pb, vec);
  }
  if (lane < pb) {
    store_t(t, tau_mine, taus + static_cast<size_t>(p) * C + k0 + lane,
            T + (static_cast<size_t>(p) * pb + lane) * pb, pb);
  }
}

// The block and cluster regimes: front p = blockIdx.x / G on the G CTAs of
// a cluster (G = 1: one block, no cluster); CTA c holds rows c nt R + tid +
// s nt, s < R.  Warp 0 of CTA 0 holds rows 0..31 in slot 0: row j, T and
// the taus come from it.
template <int PB, int R>
__global__ void __launch_bounds__(kBlockThreads)
qr_panel_block_kernel(float* M, float* __restrict__ taus,
                      float* __restrict__ V, float* __restrict__ T, int m,
                      int C, int k0, int pb, int G, int vec) {
  constexpr int kQ = kMaxCluster * kBlockThreads / 32;
  constexpr int kV = PB / 4;                  // float4s a row
  constexpr int kSpan = 32 / PB;              // lanes a reduced value
  constexpr int kDirect = 64 / PB;            // most vectors summed alone
  __shared__ __align__(16) float part[2][kQ][PB];
  __shared__ __align__(16) float rowj[2][PB];
  __shared__ __align__(16) float stage[PB];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int rank = blockIdx.x % G;
  const int p = blockIdx.x / G;
  const int Q = G * nw;                       // partial vectors a column
  const int mm = m - k0;
  const int base = rank * nt * R + tid;       // slot 0's row
  const bool lead = rank == 0 && warp == 0;
  cg::cluster_group cluster = cg::this_cluster();
  float* Mp = M + static_cast<size_t>(p) * m * C
              + static_cast<size_t>(k0) * C + k0;
  float a[R][PB];
#pragma unroll
  for (int s = 0; s < R; ++s) {
    const int r = base + s * nt;
    load_row(a[s], Mp, C, r, mm, pb, vec);
  }
  if (G > 1) {
    cluster.sync();       // every CTA runs before its buffers are written
  }
  float t[PB];
#pragma unroll
  for (int k = 0; k < PB; ++k) {
    t[k] = 0.0f;
  }
  float tau_mine = 0.0f;
#pragma unroll 1
  for (int j = 0; j < pb; ++j) {
    const int par = j & 1;
    float acc[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      acc[k] = 0.0f;
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      accumulate(a[s], s > 0 || base > j, acc);
    }
    if (lead) {
      if (lane == j) {
        put4(G > 1 ? stage : rowj[par], a[0]);
      }
      if (G > 1) {
        __syncwarp();
        if (lane < G * kV) {
          float4* dst = cluster.map_shared_rank(
              reinterpret_cast<float4*>(rowj[par]), lane / kV);
          dst[lane % kV] = reinterpret_cast<const float4*>(stage)[lane % kV];
        }
      }
    }
    const float mine = reduce_scatter<PB>(acc, lane);
    if (lane % kSpan == 0) {
      float* slot = &part[par][rank * nw + warp][lane / kSpan];
      if (G == 1) {
        *slot = mine;
      } else {
        for (int c = 0; c < G; ++c) {
          *cluster.map_shared_rank(slot, c) = mine;
        }
      }
    }
    if (G == 1) {
      __syncthreads();
    } else {
      cluster.sync();
    }
    float sums[PB], row[PB], w[PB], wt[PB];
    if (Q <= kDirect) {
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        sums[k] = 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kDirect; ++q) {
        if (q < Q) {
          get4(row, part[par][q]);
#pragma unroll
          for (int k = 0; k < PB; ++k) {
            sums[k] += row[k];
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < PB; ++k) {
        acc[k] = 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kQ / 32; ++i) {
        if (lane + 32 * i < Q) {
          get4(row, part[par][lane + 32 * i]);
#pragma unroll
          for (int k = 0; k < PB; ++k) {
            acc[k] += row[k];
          }
        }
      }
      broadcast<PB>(reduce_scatter<PB>(acc, lane), sums);
    }
    get4(row, rowj[par]);
    const Reflector f = reflector(row[0], sums[0]);
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      w[k] = fmaf(sums[k], f.rinv, row[k]);
    }
    trailing(w, j, wt);
    if (lead) {
      t_column(t, lane, j, f.tau, w);
      if (lane == j) {
        tau_mine = f.tau;
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      reflect_row(a[s], s > 0 || base > j, s == 0 && base == j, f, w[0],
                  wt);
    }
  }
  for (int e = pb; e < PB; ++e) {       // back to the panel's order
#pragma unroll
    for (int s = 0; s < R; ++s) {
      rotate(a[s]);
    }
    rotate(t);
  }
  float* Vp = V + static_cast<size_t>(p) * mm * pb;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    store_row(a[s], Mp, C, Vp, base + s * nt, mm, pb, vec);
  }
  if (lead && lane < pb) {
    store_t(t, tau_mine, taus + static_cast<size_t>(p) * C + k0 + lane,
            T + (static_cast<size_t>(p) * pb + lane) * pb, pb);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(kFull, v, o);
  }
  return v;
}

// The device-memory path, for a panel taller than the largest cluster
// holds: one block a front on the panel in place, a thread a row
// (strided), a block-wide sum for the norm and one for the pb dot
// products, four barriers a column; one warp then forms T.
template <int PBMAX>
__global__ void __launch_bounds__(kGmemWarps * 32)
qr_panel_gmem_kernel(float* M, float* __restrict__ taus,
                     float* __restrict__ V, float* __restrict__ T, int m,
                     int C, int k0, int pb) {
  __shared__ float red[kGmemWarps][PBMAX];
  __shared__ float red1[kGmemWarps];
  __shared__ float dsh[PBMAX];
  __shared__ float vtv[PBMAX][PBMAX];     // vtv[k][c] = v_k . v_c, k < c
  __shared__ float tau_s[PBMAX];
  __shared__ float Ts[PBMAX][PBMAX];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int mm = m - k0;
  float* S = M + static_cast<size_t>(blockIdx.x) * m * C
             + static_cast<size_t>(k0) * C + k0;
  const int ld = C;
  for (int j = 0; j < pb; ++j) {
    // the column's norm over rows >= j
    float part = 0.0f;
    for (int r = j + tid; r < mm; r += nt) {
      const float x = S[static_cast<size_t>(r) * ld + j];
      part += x * x;
    }
    part = warp_sum(part);
    if (lane == 0) {
      red1[warp] = part;
    }
    __syncthreads();
    float normsq = 0.0f;
    for (int w = 0; w < nw; ++w) {
      normsq += red1[w];
    }
    const float x0 = S[static_cast<size_t>(j) * ld + j];
    const float normx = sqrtf(normsq);
    const float alpha = (x0 >= 0.0f ? -1.0f : 1.0f) * normx;
    const float denom = x0 - alpha;
    const float safe = denom == 0.0f ? 1.0f : denom;
    const float tau = normx == 0.0f
        ? 0.0f : (alpha - x0) / (alpha == 0.0f ? 1.0f : alpha);
    // d[k] = v . S[:, k] for every k of the panel
    float acc[PBMAX];
#pragma unroll
    for (int k = 0; k < PBMAX; ++k) {
      acc[k] = 0.0f;
    }
    for (int r = j + tid; r < mm; r += nt) {
      const float* Sr = S + static_cast<size_t>(r) * ld;
      const float v = r == j ? 1.0f : Sr[j] / safe;
#pragma unroll
      for (int k = 0; k < PBMAX; ++k) {
        if (k < pb) {
          acc[k] += v * Sr[k];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < PBMAX; ++k) {
      acc[k] = warp_sum(acc[k]);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < PBMAX; ++k) {
        red[warp][k] = acc[k];
      }
    }
    __syncthreads();
    if (tid < pb) {
      float s = 0.0f;
      for (int w = 0; w < nw; ++w) {
        s += red[w][tid];
      }
      dsh[tid] = s;
      if (tid < j) {
        vtv[tid][j] = s;
      }
    }
    if (tid == 0) {
      tau_s[j] = tau;
    }
    __syncthreads();
    // the reflection of the panel's columns k >= j, then v below row j
    for (int r = j + tid; r < mm; r += nt) {
      float* Sr = S + static_cast<size_t>(r) * ld;
      const float v = r == j ? 1.0f : Sr[j] / safe;
      const float tv = tau * v;
      for (int k = j + 1; k < pb; ++k) {
        Sr[k] -= tv * dsh[k];
      }
      Sr[j] = r == j ? x0 - tv * dsh[j] : v;
    }
    __syncthreads();
  }
  // T: T[j][j] = tau_j, T[:j, j] = -tau_j T[:j, :j] (V^T V)[:j, j]
  if (warp == 0) {
    for (int j = 0; j < pb; ++j) {
      float t = 0.0f;
      if (lane < j) {
        for (int l = lane; l < j; ++l) {
          t += Ts[lane][l] * vtv[l][j];
        }
      }
      __syncwarp();
      if (lane < pb) {
        Ts[lane][j] = lane < j ? -tau_s[j] * t
                               : (lane == j ? tau_s[j] : 0.0f);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  const size_t p = blockIdx.x;
  if (tid < pb) {
    taus[p * C + k0 + tid] = tau_s[tid];
  }
  for (int i = tid; i < pb * pb; i += nt) {
    T[p * pb * pb + i] = Ts[i / pb][i % pb];
  }
  float* Vp = V + p * mm * pb;
  for (int i = tid; i < mm * pb; i += nt) {
    const int r = i / pb, c = i - r * pb;
    const float s = S[static_cast<size_t>(r) * ld + c];
    Vp[i] = r > c ? s : (r == c ? 1.0f : 0.0f);
  }
}

// One warp, `steps` dependent column steps of the warp regime's chain: a
// PB-value all-reduce (reduce-scatter and broadcast), the column's square
// root and reciprocal, and the next column's inputs from its scalars.
template <int PB>
__global__ void qr_chain_probe_kernel(float* out, int steps) {
  const int lane = threadIdx.x;
  const float c = (1.0f + 0.001f * lane) / (32 * PB);   // not a constant
  float x = 1.0f + 0.01f * lane, junk = 0.0f;
  for (int i = 0; i < steps; ++i) {
    float v[PB], sums[PB];
#pragma unroll
    for (int k = 0; k < PB; ++k) {
      v[k] = x * (c + 1e-6f * k);
    }
    broadcast<PB>(reduce_scatter<PB>(v, lane), sums);
    const Reflector f = reflector(x, sums[0]);
    x = fmaf(f.tau * sums[PB - 1], f.rinv, 0.5f);        // stays near 0.55
#pragma unroll
    for (int k = 1; k < PB - 1; ++k) {
      junk += sums[k];                                   // off the chain
    }
  }
  out[lane] = x + 1e-30f * junk;
}

template <int PB>
cudaError_t launch(float* M, float* taus, float* V, float* T, int P, int m,
                   int C, int k0, int pb, cudaStream_t stream) {
  constexpr int R = kRows<PB>;
  const int mm = m - k0;
  const int vec =
      (reinterpret_cast<uintptr_t>(M) % 16 == 0 && C % 4 == 0
       && k0 % 4 == 0 && pb % 4 == 0 ? 1 : 0)
      | (reinterpret_cast<uintptr_t>(V) % 16 == 0 && pb % 4 == 0 ? 2 : 0);
  const int G = regime(mm, pb);
  if (G == 0) {
    const int rows = (mm + 31) / 32;
    const dim3 grid((P + kWarps - 1) / kWarps), block(kWarps * 32);
    if (rows <= 1) {
      qr_panel_warp_kernel<PB, 1><<<grid, block, 0, stream>>>(
          M, taus, V, T, P, m, C, k0, pb, vec);
    } else if (rows <= 2) {
      qr_panel_warp_kernel<PB, 2><<<grid, block, 0, stream>>>(
          M, taus, V, T, P, m, C, k0, pb, vec);
    } else if (rows <= 4) {
      qr_panel_warp_kernel<PB, 4><<<grid, block, 0, stream>>>(
          M, taus, V, T, P, m, C, k0, pb, vec);
    } else {
      qr_panel_warp_kernel<PB, R><<<grid, block, 0, stream>>>(
          M, taus, V, T, P, m, C, k0, pb, vec);
    }
    return cudaGetLastError();
  }
  if (G < 0) {
    int nt = (mm + 31) / 32 * 32;
    nt = nt > kGmemWarps * 32 ? kGmemWarps * 32 : nt;
    qr_panel_gmem_kernel<PB <= 8 ? 8 : 16><<<P, nt, 0, stream>>>(
        M, taus, V, T, m, C, k0, pb);
    return cudaGetLastError();
  }
  const int per = (mm + G - 1) / G;           // rows a CTA
  const int nt = ((per + R - 1) / R + 31) / 32 * 32;
  if (G == 1) {
    qr_panel_block_kernel<PB, R><<<P, nt, 0, stream>>>(
        M, taus, V, T, m, C, k0, pb, 1, vec);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * G);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, qr_panel_block_kernel<PB, R>, M, taus, V, T, m, C, k0, pb, G,
      vec);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// M: (P, m, C) f32, taus: (P, C) f32, both updated in place; V: (P,
// m - k0, pb) and T: (P, pb, pb) f32 written; all contiguous on the
// current device; 0 <= k0 < m, 1 <= pb <= 16, k0 + pb <= C.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError() (or the
// cluster launch's own error).
extern "C" int tpt_qr_panel(float* M, float* taus, float* V, float* T,
                            int P, int m, int C, int k0, int pb,
                            void* stream) {
  if (P <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = pb <= 4
      ? launch<4>(M, taus, V, T, P, m, C, k0, pb, s)
      : (pb <= 8 ? launch<8>(M, taus, V, T, P, m, C, k0, pb, s)
                 : launch<16>(M, taus, V, T, P, m, C, k0, pb, s));
  return static_cast<int>(e);
}

// The regime tpt_qr_panel launches for a panel of mm rows and pb columns:
// 0 a warp a front, 1 a block a front, G >= 2 a cluster of G CTAs a front,
// -1 the device-memory path.
extern "C" int tpt_qr_panel_regime(int mm, int pb) {
  return regime(mm, pb);
}

// One warp runs `steps` dependent column steps of width kind (4, 8 or 16)
// and writes 32 floats to out: the chain floor of qr_panel's warp regime,
// timed by the caller.
extern "C" int tpt_qr_chain_probe(float* out, int steps, int kind,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind <= 4) {
    qr_chain_probe_kernel<4><<<1, 32, 0, s>>>(out, steps);
  } else if (kind <= 8) {
    qr_chain_probe_kernel<8><<<1, 32, 0, s>>>(out, steps);
  } else {
    qr_chain_probe_kernel<16><<<1, 32, 0, s>>>(out, steps);
  }
  return static_cast<int>(cudaGetLastError());
}
