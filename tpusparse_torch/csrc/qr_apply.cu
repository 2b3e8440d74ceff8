// Application of factored fronts' Householder reflectors to one vector
// per front (H3): for each p, with s = slots[p], F = pool[s] (Rh, C) the
// factored front (reflector k below the diagonal of column k, its unit
// diagonal implied), tau = taus[s] and z = z[s] (Rh,), in place,
//   Q^T z = H_{kelim-1} ... H_1 H_0 z   (forward: H_0 first), or
//   Q z   = H_0 H_1 ... H_{kelim-1} z   (reverse),
// H_k = I - tau_k v_k v_k^T, v_k zero above row k, 1 at row k.
//
// Computes what the compact-WY applications of tpusparse/device/dense.py
// compute (qr_qt_mul_batched :303, qr_q_mul_batched :319, the dense
// qr_apply_qt / qr_apply_q :183, :197), the same way: the reflectors go in
// panels of 8 (_panel_starts(kelim, 8): the last may be narrower; Q^T
// takes the panels in forward order, Q in reverse), and a panel is
// applied as I - V T V^T.  V (rows x 8) is the panel's columns masked to
// the unit lower trapezoid (_panel_v_batched :277); T (8 x 8, upper) comes
// from G = V^T V and the taus as _form_t_batched (:287) forms it,
//   T[j][j] = tau_j,  T[:j, j] = -tau_j T[:j, :j] G[:j, j],
// so that H_0 H_1 ... H_7 = I - V T V^T exactly; with w = V^T z,
//   Q_panel^T z = z - V (T^T w),   Q_panel z = z - V (T w).
// That is the product of the panel's 8 reflectors, so the result is the
// one-at-a-time result (qr_apply_ref) up to rounding: the sums are taken
// in another order.  The JAX package has no Pallas kernel for this (XLA
// fuses the einsums).
//
// A reflector with tau_j = 0 is the identity: its column of V is set to 0
// in registers by a select (not a multiply, so whatever the front holds
// below that diagonal, even values whose squares overflow, never enters a
// sum), which makes its row and column of G, its column of T and u_j
// exactly 0, as JAX's T has them, and leaves z exactly as it was.
// Columns past a narrow last panel's width count as tau = 0, and the
// reflectors after a front's last one with tau != 0 (a padded front's
// trailing columns) are not visited: every warp finds that one with a
// ballot over the taus, 32 at a time from the end, and the panels stop
// (Q^T) or start (Q) at its panel.  (Skipping a panel of 8 zero taus
// inside the loop measured slower on the H100 on the small fronts of the
// many-front batches: the branch cost more than the reductions it saved.)
//
// Design.  A front's rows are dealt to its threads in turn: thread t of
// CTA c owns rows c nt + t + i G nt (G CTAs of nt threads a front) and
// alone reads and writes them in z.  A panel is one pass over a thread's
// rows: for each row r >= k0 it loads the 8 contiguous values
// F[r, k0 .. k0+8) (one 32-byte sector), masks them to V's row and adds
// to its 36 partial sums: the 8 of w = V^T z and the 28 of G's strict
// upper part.  The 36 are reduced once for the front (front_totals: a
// warp's halving exchanges, then each warp's 36 into a buffer that
// alternates between two halves), which costs one __syncthreads a panel
// in one CTA (none for a one-warp front) and one wait on the CTA's own
// mbarrier in a cluster, not one barrier a reflector.  Every thread forms
// T and u in registers (about 150 fused multiply-adds) and takes
// z_r -= V[r, :] u for its rows, with V still in its registers.  The next
// panel's chunks and taus are loaded before the reduction, so their
// latency hides behind it.
//
// How a launch runs, decided on the host from what it sees (regime()):
// - a front of more than 256 rows, when the P fronts leave SMs idle
//   (P G <= the SM count), runs on a thread-block cluster of
//   G = min(ceil(Rh / 256), 8, SMs / P) CTAs (the root of a sparse QR: 7;
//   TpuQR's 4,096 x 1,024: 8), launched by cudaLaunchKernelEx; a refused
//   launch returns its error.  Each warp sends its 36 partials into every
//   CTA's buffer with st.async, which counts the bytes on that CTA's
//   mbarrier; a CTA waits for the G nw entries to arrive, on its own
//   mbarrier, and not for the other CTAs to reach a barrier (a cluster
//   barrier a panel measured slower on the H100);
// - otherwise one CTA a front (G = 1).
// A CTA has nt = 32 .. 128 threads, the least multiple of 32 that covers
// its share of the rows up to 128 (one warp for the 32-row fronts of a
// many-front batch); a thread keeps RV = 1, 2, 4 or 8 rows' chunks in
// registers, the least that covers its share, and a share past 8 rows (a
// front over 1,024 rows a CTA) is read from memory for those rows, twice a
// panel.  The chunk is two 16-byte loads where C % 4 == 0 and the pool is
// 16-byte aligned (then every row and every panel start k0 = 8 p is),
// else scalar loads of the same chunk.  z lives in shared memory, at
// i nt + t for a thread's row i, when a CTA's rows fit the opt-in limit
// beside the buffer, else it is updated in device memory in place.
//
// What bounds it: 4 (Rh - k) FLOP per reflector on (Rh - k) floats of V
// read once, 1 FLOP per byte, so device memory for the many-front batches;
// for a single large front, the chain of its panels, each a load pass over
// a CTA's rows, the reduction and its wait, and T (tpt_qr_apply_chain_probe
// times that step as the launch runs it).  The cluster spreads the load
// pass of a tall front (a 32-byte sector a row, the rows a line apart)
// over up to 8 SMs, and leaves the chain.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;                       // most threads a CTA
constexpr int kMaxCluster = 8;                      // the portable size
constexpr int kClusterRows = 256;                   // rows a CTA aims at
constexpr int kNb = 8;                              // reflectors a panel
constexpr int kSums = kNb + kNb * (kNb - 1) / 2;    // w, G strict upper: 36

// Slot of G[i][j] = v_i . v_j (i < j) among a panel's sums, after w's 8.
__host__ __device__ constexpr int gidx(int i, int j) {
  return kNb + j * (j - 1) / 2 + i;
}

// Threads of a CTA that takes `rows` rows of a front.
int threads(int rows) {
  const int nt = (rows + 31) / 32 * 32;
  return nt < 32 ? 32 : (nt > kThreads ? kThreads : nt);
}

// CTAs a front: one, or a cluster of up to 8 that share its rows, when a
// front has more than kClusterRows rows and the P fronts leave SMs idle.
int cluster_size(int P, int Rh, int sms) {
  int G = (Rh + kClusterRows - 1) / kClusterRows;
  G = G > kMaxCluster ? kMaxCluster : G;
  G = G * P > sms ? sms / P : G;
  return G < 1 ? 1 : G;
}

// F[r, k0 .. k0+8) of one row (row points at F[r, k0]): two 16-byte loads
// (vec) or pb scalar ones; the values past pb are never used (tau = 0).
__device__ __forceinline__ void load_chunk(float (&c)[kNb], const float* row,
                                           int pb, int vec) {
  if (vec) {
    const float4* q = reinterpret_cast<const float4*>(row);
    const float4 a = __ldg(q);
    const float4 b = pb > 4 ? __ldg(q + 1) : make_float4(0.f, 0.f, 0.f, 0.f);
    c[0] = a.x;
    c[1] = a.y;
    c[2] = a.z;
    c[3] = a.w;
    c[4] = b.x;
    c[5] = b.y;
    c[6] = b.z;
    c[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      c[j] = j < pb ? __ldg(row + j) : 0.0f;
    }
  }
}

// The rows a thread owns: base, base + stride, ... (stride = G nt: the
// rows of a front are dealt to the cluster's threads in turn, so every
// CTA keeps rows as the panels move down).
struct Rows {
  int base, stride, Rh;
  __device__ int r(int i) const { return base + i * stride; }
};

// The chunks of the panel at k0 of a thread's first RV rows; 0 for a row
// above k0 or past Rh.
template <int RV>
__device__ __forceinline__ void load_rows(float (&c)[RV][kNb], const float* F,
                                          int C, const Rows& rows, int k0,
                                          int pb, int vec) {
#pragma unroll
  for (int i = 0; i < RV; ++i) {
    const int r = rows.r(i);
    if (r >= k0 && r < rows.Rh) {
      load_chunk(c[i], F + static_cast<size_t>(r) * C + k0, pb, vec);
    } else {
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        c[i][j] = 0.0f;
      }
    }
  }
}

// One past the last of the front's first kelim reflectors whose tau is
// not 0 (0 if none is): the ones after it are the identity.  Every warp
// finds it for itself, 32 taus a step from the end.
__device__ __forceinline__ int live_kelim(const float* tp, int kelim,
                                          int lane) {
  for (int k = kelim; k > 0; k -= 32) {
    const int j = k - 32 + lane;
    const unsigned m = __ballot_sync(kFull, j >= 0 && __ldg(tp + j) != 0.0f);
    if (m != 0) {
      return k - __clz(m);
    }
  }
  return 0;
}

// taus[k0 .. k0 + pb) of the front, 0 past pb.
__device__ __forceinline__ void load_taus(float (&t)[kNb], const float* tp,
                                          int k0, int pb) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    t[j] = j < pb ? __ldg(tp + k0 + j) : 0.0f;
  }
}

// The chunks and taus of the q-th panel in the order of application.
template <bool FORWARD, int RV>
__device__ __forceinline__ void load_panel(float (&c)[RV][kNb],
                                           float (&t)[kNb], const float* F,
                                           const float* tp, int C,
                                           const Rows& rows, int kelim,
                                           int np, int q, int vec) {
  const int k0 = (FORWARD ? q : np - 1 - q) * kNb;
  const int pb = min(kNb, kelim - k0);
  load_rows<RV>(c, F, C, rows, k0, pb, vec);
  load_taus(t, tp, k0, pb);
}

// Row r of the panel's V from its chunk: 0 above row k0 + j, 1 at it; a
// column whose tau is 0 is 0 (a select).  A chunk of zeros (a row above
// k0 or past Rh) gives a row of zeros.
__device__ __forceinline__ void v_row(float (&v)[kNb], const float (&c)[kNb],
                                      int r, int k0, const float (&tau)[kNb]) {
  if (r >= k0 + kNb) {               // below the panel's diagonal block
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      v[j] = tau[j] != 0.0f ? c[j] : 0.0f;
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const int k = k0 + j;
    const float x = r > k ? c[j] : (r == k ? 1.0f : 0.0f);
    v[j] = tau[j] != 0.0f ? x : 0.0f;
  }
}

// One row's terms of w = V^T z and of G's strict upper part.
__device__ __forceinline__ void add_row(float (&s)[kSums],
                                        const float (&v)[kNb], float zr) {
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    s[j] = fmaf(v[j], zr, s[j]);
  }
#pragma unroll
  for (int j = 1; j < kNb; ++j) {
#pragma unroll
    for (int i = 0; i < j; ++i) {
      s[gidx(i, j)] = fmaf(v[i], v[j], s[gidx(i, j)]);
    }
  }
}

__device__ __forceinline__ float dot8(const float (&v)[kNb],
                                      const float (&u)[kNb]) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    acc = fmaf(v[j], u[j], acc);
  }
  return acc;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address of shared location a in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Stores v at a of another CTA (or this one) and adds its 4 bytes to the
// transaction count of the mbarrier at mbar of that CTA.
__device__ __forceinline__ void st_async(uint32_t a, float v, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 "
      "[%0], %1, [%2];" :: "r"(a), "r"(__float_as_uint(v)), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_u32(mbar)) : "memory");
}

__device__ __forceinline__ void expect_tx(uint32_t mbar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(mbar), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` of the mbarrier at mbar; a wait
// that never ends (a fault) traps instead of hanging the card.
__device__ __forceinline__ void wait_parity(uint32_t mbar, uint32_t parity) {
  for (int it = 0;; ++it) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
    if (done) {
      return;
    }
    if (it == (1 << 26)) {
      __trap();
    }
  }
}

// a = value `lane` summed over the E entries at e0 (kSums floats each), b
// = value 32 + lane % 4 summed over them (lane l sums every eighth entry
// from l / 4, then 3 shuffles); every lane sums in the same order.
__device__ __forceinline__ void combine(const float* e0, int E, int lane,
                                        float& a, float& b) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int e = 0;
  for (; e + 3 < E; e += 4) {
    a0 += e0[e * kSums + lane];
    a1 += e0[(e + 1) * kSums + lane];
    a2 += e0[(e + 2) * kSums + lane];
    a3 += e0[(e + 3) * kSums + lane];
  }
  for (; e < E; ++e) {
    a0 += e0[e * kSums + lane];
  }
  a = (a0 + a1) + (a2 + a3);
  b = 0.0f;
  for (e = lane >> 2; e < E; e += 8) {
    b += e0[e * kSums + 32 + (lane & 3)];
  }
#pragma unroll
  for (int o = 4; o <= 16; o <<= 1) {
    b += __shfl_xor_sync(kFull, b, o);
  }
}

// A panel's half of the reduction buffer (G nw entries of kSums floats)
// and, in a cluster, the mbarrier that counts the bytes arriving in it and
// the parity of the phase this panel waits for.
struct Exchange {
  float* red;
  uint32_t mbar, parity;
};

// The totals of the 36 sums over the front's threads, in every thread, in
// s.  Values 0..31 are reduce-scattered in each warp by halving exchanges
// over lane bits 4 .. 0 (31 shuffles; lane l ends with value l), values
// 32..35 over bits 1, 0 and then summed over bits 2 .. 4 (6 shuffles;
// lane l ends with 32 + l % 4).  Each warp then publishes its 36 as entry
// c nw + warp of the exchange's half of the buffer, in every CTA of the
// front, and every warp waits once and combines the E = G nw entries.  One
// CTA: plain stores, then __syncthreads (nothing at all for a one-warp
// CTA).  A cluster: st.async into each CTA's buffer (its own included),
// each store adding its bytes to that CTA's mbarrier for this half, which
// its thread 0 armed with the E * 144 bytes to expect; the wait is on
// this CTA's own mbarrier, so no CTA waits for another to arrive
// anywhere.  The halves alternate (exchange()), and a warp writes a half
// again only after its next wait, which no warp passes before every warp
// of the front has sent the data of the exchange in between, that is,
// before every warp has read this half.  Then 36 shuffles broadcast the
// totals.
__device__ __forceinline__ void front_totals(float (&s)[kSums],
                                             const Exchange& ex, int lane,
                                             int warp, int nw, int G, int c) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    const bool up = (lane & h) != 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      if (i < h) {
        const float send = up ? s[i] : s[i + h];
        const float keep = up ? s[i + h] : s[i];
        s[i] = keep + __shfl_xor_sync(kFull, send, h);
      }
    }
  }
  float a = s[0];
  {
    const bool up = (lane & 2) != 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float send = up ? s[32 + i] : s[34 + i];
      const float keep = up ? s[34 + i] : s[32 + i];
      s[32 + i] = keep + __shfl_xor_sync(kFull, send, 2);
    }
  }
  const bool odd = (lane & 1) != 0;
  float b = (odd ? s[33] : s[32])
      + __shfl_xor_sync(kFull, odd ? s[32] : s[33], 1);
#pragma unroll
  for (int o = 4; o <= 16; o <<= 1) {
    b += __shfl_xor_sync(kFull, b, o);
  }
  // the branches below are the same in every thread of the front
  float* mine = ex.red + (c * nw + warp) * kSums;
  if (G == 1) {
    if (nw > 1) {
      mine[lane] = a;
      if (lane < 4) {
        mine[32 + lane] = b;
      }
      __syncthreads();
      combine(ex.red, nw, lane, a, b);
    }
  } else {
    if (warp == 0 && lane == 0) {
      expect_tx(ex.mbar, G * nw * kSums * sizeof(float));
    }
    const uint32_t slot = smem_u32(mine + lane);
    for (int g = 0; g < G; ++g) {
      const uint32_t to = mapa(slot, g), mb = mapa(ex.mbar, g);
      st_async(to, a, mb);
      if (lane < 4) {
        st_async(to + 32 * sizeof(float), b, mb);
      }
    }
    wait_parity(ex.mbar, ex.parity);
    combine(ex.red, G * nw, lane, a, b);
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    s[k] = __shfl_sync(kFull, a, k);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s[32 + k] = __shfl_sync(kFull, b, k);
  }
}

// A cluster's mbarriers, one a buffer half, initialised and visible to
// every CTA before any of them stores into another; nothing for one CTA.
__device__ __forceinline__ void exchange_begin(uint64_t (&mbar)[2], int G) {
  if (G > 1) {
    if (threadIdx.x == 0) {
      mbar_init(&mbar[0]);
      mbar_init(&mbar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cg::this_cluster().sync();
  }
}

// Panel q's exchange: half q % 2 of the buffer, whose mbarrier then
// completes its phase q / 2.
__device__ __forceinline__ Exchange exchange(float* dyn, int half,
                                             uint64_t (&mbar)[2], int q) {
  return Exchange{dyn + (q & 1) * half, smem_u32(&mbar[q & 1]),
                  static_cast<uint32_t>((q >> 1) & 1)};
}

// u from the totals s (w = s[0..8), G's strict upper part at gidx) and the
// taus: T as _form_t_batched forms it, then u = T^T w (FORWARD, for Q^T:
// JAX contracts T's first index) or T w (for Q).
template <bool FORWARD>
__device__ __forceinline__ void panel_u(const float (&s)[kSums],
                                        const float (&tau)[kNb],
                                        float (&u)[kNb]) {
  float T[kNb][kNb];
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
#pragma unroll
    for (int i = 0; i < j; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int m = i; m < j; ++m) {
        acc = fmaf(T[i][m], s[gidx(m, j)], acc);
      }
      T[i][j] = -tau[j] * acc;
    }
    T[j][j] = tau[j];
  }
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    float acc = 0.0f;
    if (FORWARD) {
#pragma unroll
      for (int i = 0; i <= j; ++i) {
        acc = fmaf(T[i][j], s[i], acc);
      }
    } else {
#pragma unroll
      for (int i = j; i < kNb; ++i) {
        acc = fmaf(T[j][i], s[i], acc);
      }
    }
    u[j] = acc;
  }
}

// Front p = blockIdx.x / G of slots, on G CTAs (G = 1: one block, no
// cluster); RV: rows a thread keeps in registers (see the header).  z's
// row i of a thread is zs[i nt + tid] in shared memory (in_smem), else
// z[s][r] in place.
template <bool FORWARD, int RV>
__global__ void __launch_bounds__(kThreads, 1)
qr_apply_kernel(const float* __restrict__ pool,
                const float* __restrict__ taus,
                const int64_t* __restrict__ slots, float* z, int Rh, int C,
                int kelim, int G, int in_smem, int vec) {
  extern __shared__ float dyn[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int c = G > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  __shared__ uint64_t mbar[2];
  const int half = G * nw * kSums;   // floats of a panel's half of red
  float* zs = dyn + 2 * half;
  const int64_t s = __ldg(slots + blockIdx.x / G);
  const float* F = pool + s * Rh * C;
  const float* tp = taus + s * C;
  float* zg = z + s * Rh;
  const Rows rows{c * nt + tid, G * nt, Rh};
  // a thread's row i of z (r = rows.r(i))
  auto zp = [&](int i, int r) -> float* {
    return in_smem ? zs + i * nt + tid : zg + r;
  };
  kelim = live_kelim(tp, kelim, lane);
  const int np = (kelim + kNb - 1) / kNb;
  float ch[RV][kNb], tn[kNb];         // the panel's chunks and taus
  if (np > 0) {
    load_panel<FORWARD, RV>(ch, tn, F, tp, C, rows, kelim, np, 0, vec);
  }
  if (in_smem) {
    for (int i = 0, r = rows.base; r < Rh; ++i, r += rows.stride) {
      *zp(i, r) = zg[r];
    }
  }
  exchange_begin(mbar, G);
  for (int q = 0; q < np; ++q) {
    const int k0 = (FORWARD ? q : np - 1 - q) * kNb;
    const int pb = min(kNb, kelim - k0);
    float tau[kNb];
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      tau[j] = tn[j];
    }
    float v[RV][kNb], sums[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      sums[k] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < RV; ++i) {
      const int r = rows.r(i);
      v_row(v[i], ch[i], r, k0, tau);
      add_row(sums, v[i], r >= k0 && r < Rh ? *zp(i, r) : 0.0f);
    }
    for (int i = RV, r = rows.r(RV); r < Rh; ++i, r += rows.stride) {
      if (r >= k0) {                 // rows past RV: from memory
        float ct[kNb], vt[kNb];
        load_chunk(ct, F + static_cast<size_t>(r) * C + k0, pb, vec);
        v_row(vt, ct, r, k0, tau);
        add_row(sums, vt, *zp(i, r));
      }
    }
    if (q + 1 < np) {        // the next panel's, in flight across the wait
      load_panel<FORWARD, RV>(ch, tn, F, tp, C, rows, kelim, np, q + 1, vec);
    }
    front_totals(sums, exchange(dyn, half, mbar, q), lane, warp, nw, G, c);
    float u[kNb];
    panel_u<FORWARD>(sums, tau, u);
#pragma unroll
    for (int i = 0; i < RV; ++i) {
      const int r = rows.r(i);
      if (r >= k0 && r < Rh) {
        *zp(i, r) -= dot8(v[i], u);
      }
    }
    for (int i = RV, r = rows.r(RV); r < Rh; ++i, r += rows.stride) {
      if (r >= k0) {
        float ct[kNb], vt[kNb];
        load_chunk(ct, F + static_cast<size_t>(r) * C + k0, pb, vec);
        v_row(vt, ct, r, k0, tau);
        *zp(i, r) -= dot8(vt, u);
      }
    }
  }
  if (in_smem) {
    for (int i = 0, r = rows.base; r < Rh; ++i, r += rows.stride) {
      zg[r] = *zp(i, r);
    }
  }
  if (G > 1) {
    cg::this_cluster().sync();       // no CTA leaves while others may store
  }
}

// The CTAs of a front of `steps` dependent panel steps of qr_apply_kernel's
// chain (G CTAs of blockDim.x threads, a cluster when G > 1): the 36-value
// reduction with its barrier, then T and u, from which the next step's
// sums follow.
__global__ void __launch_bounds__(kThreads)
qr_apply_chain_probe_kernel(float* out, int steps, int G) {
  extern __shared__ float dyn[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int c = G > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  __shared__ uint64_t mbar[2];
  const int half = G * nw * kSums;
  exchange_begin(mbar, G);
  const float a = (1.0f + 0.001f * tid) / (kSums * nt * G);   // not a constant
  float tau[kNb];
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    tau[j] = 1.0f + 0.01f * j + a;
  }
  float x = 1.0f, junk = 0.0f;
  for (int i = 0; i < steps; ++i) {
    float s[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      s[k] = x * (a + 1e-7f * k);
    }
    front_totals(s, exchange(dyn, half, mbar, i), lane, warp, nw, G, c);
    float u[kNb];
    panel_u<true>(s, tau, u);
    x = fmaf(u[kNb - 1], 0.001f, 0.5f);                  // stays near 0.5
#pragma unroll
    for (int j = 0; j < kNb - 1; ++j) {
      junk += u[j];                                      // off the chain
    }
  }
  if (blockIdx.x == 0 && tid < 32) {
    out[tid] = x + 1e-30f * junk;
  }
  if (G > 1) {
    cg::this_cluster().sync();
  }
}

// Launches kernel on P G CTAs of nt threads, as clusters of G when G > 1
// (a refused launch returns its error).
template <typename... KArgs, typename... Args>
cudaError_t launch_on(void (*kernel)(KArgs...), int P, int G, int nt,
                      size_t dyn, cudaStream_t stream, Args... args) {
  if (G == 1) {
    kernel<<<P, nt, dyn, stream>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * G);
  cfg.blockDim = dim3(nt);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = G;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// How a launch of P fronts of Rh rows runs: G CTAs a front of nt threads,
// each thread holding up to `per` rows.
struct Regime {
  int G, nt, per;
};

cudaError_t regime(int P, int Rh, Regime* out) {
  static int sms = 0;                // set once
  if (sms == 0) {
    int dev, n;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    }
    if (e != cudaSuccess) {
      return e;
    }
    sms = n;
  }
  out->G = cluster_size(P, Rh, sms);
  out->nt = threads((Rh + out->G - 1) / out->G);
  out->per = (Rh + out->G * out->nt - 1) / (out->G * out->nt);
  return cudaSuccess;
}

template <bool FORWARD, int RV>
cudaError_t launch(const float* pool, const float* taus,
                   const int64_t* slots, float* z, int P, int Rh, int C,
                   int kelim, const Regime& g, int vec, cudaStream_t stream) {
  static int dyn_max = -1;           // set once an instance
  if (dyn_max < 0) {
    int dev, optin;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) {
      e = cudaFuncGetAttributes(&fa, qr_apply_kernel<FORWARD, RV>);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(qr_apply_kernel<FORWARD, RV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
    }
    if (e != cudaSuccess) {
      return e;
    }
    dyn_max = optin - static_cast<int>(fa.sharedSizeBytes);
  }
  // the reduction buffer, then z's rows of a CTA, `per` a thread
  const size_t red = 2 * g.G * (g.nt / 32) * kSums * sizeof(float);
  const size_t bytes = red + static_cast<size_t>(g.per) * g.nt * sizeof(float);
  const int in_smem = bytes <= static_cast<size_t>(dyn_max);
  return launch_on(qr_apply_kernel<FORWARD, RV>, P, g.G, g.nt,
                   in_smem ? bytes : red, stream, pool, taus, slots, z, Rh, C,
                   kelim, g.G, in_smem, vec);
}

template <bool FORWARD>
cudaError_t dispatch(const float* pool, const float* taus,
                     const int64_t* slots, float* z, int P, int Rh, int C,
                     int kelim, cudaStream_t stream) {
  Regime g;
  const cudaError_t e = regime(P, Rh, &g);
  if (e != cudaSuccess) {
    return e;
  }
  const int vec =
      C % 4 == 0 && reinterpret_cast<uintptr_t>(pool) % 16 == 0 ? 1 : 0;
  if (g.per <= 1) {
    return launch<FORWARD, 1>(pool, taus, slots, z, P, Rh, C, kelim, g, vec,
                              stream);
  }
  if (g.per <= 2) {
    return launch<FORWARD, 2>(pool, taus, slots, z, P, Rh, C, kelim, g, vec,
                              stream);
  }
  if (g.per <= 4) {
    return launch<FORWARD, 4>(pool, taus, slots, z, P, Rh, C, kelim, g, vec,
                              stream);
  }
  return launch<FORWARD, 8>(pool, taus, slots, z, P, Rh, C, kelim, g, vec,
                            stream);
}

}  // namespace

// pool: (S, Rh, C) f32, taus: (S, C) f32, slots: (P,) int64 (distinct
// rows of them), z: (S, Rh) f32 updated in place at rows slots; all
// contiguous on the current device; kelim <= min(Rh, C).  forward != 0
// applies Q^T, else Q.  Launches on `stream` and does not synchronise.
// Returns cudaGetLastError().
extern "C" int tpt_qr_apply(const float* pool, const float* taus,
                            const int64_t* slots, float* z, int P, int Rh,
                            int C, int kelim, int forward, void* stream) {
  if (P <= 0 || kelim <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = forward
      ? dispatch<true>(pool, taus, slots, z, P, Rh, C, kelim, s)
      : dispatch<false>(pool, taus, slots, z, P, Rh, C, kelim, s);
  return static_cast<int>(e);
}

// The regime tpt_qr_apply launches for P fronts of Rh rows, as
// G * 1024 + nt (G CTAs a front, a cluster when G > 1, of nt threads), or
// -1 if the device cannot be asked.
extern "C" int tpt_qr_apply_regime(int P, int Rh) {
  Regime g;
  return regime(P, Rh, &g) == cudaSuccess ? g.G * 1024 + g.nt : -1;
}

// The CTAs of one front as tpt_qr_apply launches them in the regime
// `kind` (tpt_qr_apply_regime's value) run `steps` dependent panel steps
// and write 32 floats to out: the chain floor of a panel of qr_apply, timed
// by the caller.
extern "C" int tpt_qr_apply_chain_probe(float* out, int steps, int kind,
                                        void* stream) {
  const int G = kind / 1024, nt = kind % 1024;
  const size_t red = 2 * G * (nt / 32) * kSums * sizeof(float);
  return static_cast<int>(launch_on(
      qr_apply_chain_probe_kernel, 1, G, nt, red,
      static_cast<cudaStream_t>(stream), out, steps, G));
}
