// Batched LU of W x W tiles with threshold partial pivoting inside each
// tile, W a multiple of 8 up to 128: the panel-LU phase of the superscan
// LU factorization.
//
// The JAX package has no Pallas kernel here: its panel LU is _lu_panel in
// tpusparse/device/superscan_lu.py (:104), a lax.fori_loop over the W
// columns that XLA fuses into the segment's one program, and _lu_nopiv
// (:68) for tol = 0.  Written as torch ops it would be some 15 launches a
// column; this kernel is one launch a panel-LU phase.
//
// What it computes, column k = 0 .. W-1 of each tile, as _lu_panel does:
//   1. the candidates are the rows at positions r >= k; maxv = max
//      |a[r][k]| and j the first position that reaches it (a NaN counts as
//      the largest value, and ties go to the lower position, as
//      torch.argmax has it);
//   2. if |a[k][k]| >= tol * maxv, j = k (the reference's preference for
//      the diagonal); tol = 0 keeps every diagonal, a non-finite column's
//      too, so P = I as in _lu_nopiv;
//   3. the rows at positions k and j swap, whole, and so do their entries
//      of the order;
//   4. a pivot with |d| < eps becomes -eps where d < 0, else +eps (a NaN
//      stays NaN);
//   5. l[r] = a[r][k] / d for r > k, then a[r][c] -= l[r] * a[k][c] for
//      r > k, c > k, with the product rounded before the subtraction
//      (no fused multiply-add), as the two torch ops of the plain version
//      round it.
// Outputs: F = L\U packed (L's unit diagonal implied) and the one-hot P,
// P[i][perm[i]] = 1, so that P D = L U.  Every entry gets its updates in
// column order, divided and rounded as lu_tiles_ref does on the card, so
// the two agree bit for bit on finite input and pick the same pivots.
//
// What bounds it: latency.  A tile is 4 W^2 bytes in and 8 W^2 out and
// (2/3) W^3 flops (64 KB, 128 KB and 1.4 MFLOP at W = 128), far under
// what one SM moves or computes in a microsecond.  The W dependent column
// steps are the time: search, pivot, division, and the update of the next
// column, each step waiting on the one before.  The design keeps that
// chain short:
//
// - The tile lives in registers from load to store.  Lanes hold rows
//   (row lane + 32 s in slot s), warps hold chunks of CW columns, and
//   every register index is a compile-time constant (the loops over a
//   chunk's columns are unrolled), so nothing spills.  W <= 32: one warp
//   a tile, all W columns, four tiles a block.  W >= 40: one block a tile,
//   W / 8 warps of 8 columns, ceil(W / 32) rows a lane (padding rows
//   masked).
// - Swaps are lazy.  A row never moves; each lane keeps the position of
//   each of its rows, and a swap exchanges two positions.  The search
//   orders candidates by position, so ties break as the reference's.  The
//   stores write each row at its final position, and P's row there is
//   one-hot at the row's own index.
// - The search is two warp reductions (redux.sync): the largest key, a
//   candidate's |value| as an unsigned integer (monotone in the value,
//   every NaN made one value above inf, 0 for a non-candidate), then the
//   smallest (position, row) among the lanes that hold it.  The row at
//   position k and its |value| come out of two more reductions that run
//   beside them.  The pivot row's entries in a warp's columns come to its
//   lanes through a small buffer of the warp's own in shared memory: the
//   owner lane stores them, a __syncwarp, every lane loads them (16 bytes
//   at a time), which takes far fewer instructions than a shuffle per
//   entry.
// - The warp that owns a chunk factors its 8 columns alone, right-looking
//   inside the chunk, and puts each column's pivot row and multipliers
//   (zero for rows not below the pivot) in shared memory.  Then one
//   barrier, and every warp to the right applies the chunk's 8 rank-1
//   updates, in column order, to its own columns; the owner of the next
//   chunk does so first and goes on to factor it while the others are
//   still updating (look-ahead).  So a block meets one barrier per 8
//   columns, the multipliers are double-buffered by chunk, and only pivot
//   rows and multipliers go through shared memory, never the tile.
// A NaN or a zero column cannot leave its tile: tiles share no memory.
//
// Tiles a warp: W <= 16 still takes one warp a tile, not 2 or 4 tiles on
// lane subsets.  The time of a launch is one tile's column chain, which
// packing leaves as it is (each lane still owns its row, and a reduction
// over 8 lanes costs what one over 32 does); what packing saves is warps,
// and the widest batch the LU plans give at these widths (1,080 slots at
// W = 8) is 270 blocks of 4 warps, resident on the 132 SMs at once.  At
// W = 8 a launch takes 4.2 us against a 2.1 us empty launch of the same
// grid and a 1.2 us chain (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py
// phase 14), so packing had at most some 1 us a launch to win.
//
// tpt_lu_tiles reads (nt, W, W) tiles and writes F and P beside them;
// tpt_lu_tiles_pool factors the tiles in place in a pool of rows of width
// ld (tile t is rows dbase[t] .. dbase[t] + W - 1, columns 0 .. W - 1 of
// the L pool), writes F there and P into the same rows of the U pool, and
// zeroes both pools' columns W .. ld - 1 of those rows, as the padded
// index_copy_ of superscan_lu.py's gather path does.  Slots that share a
// tile (the padded slots of a step, which all point at the pool's pad
// block) stand next to each other in dbase, and only the first slot of
// such a run stores: the others read the shared rows and drop what they
// compute.  So the one writer reads the block before anything is written
// to it, and the block becomes its own LU once, as in the gather path,
// whatever it holds.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kOneWarp = 32;        // the widest tile a warp factors alone
constexpr int kWarpTiles = 4;       // tiles (warps) a block at those widths
constexpr int kChunk = 8;           // columns a warp at wider tiles

// A launch for tiles of width W: tiles and threads a block.
constexpr int tiles_of(int W) { return W <= kOneWarp ? kWarpTiles : 1; }
constexpr int threads_of(int W) {
  return W <= kOneWarp ? kWarp * kWarpTiles : W / kChunk * kWarp;
}

template <int W>
struct Geo {
  static constexpr bool kSmall = W <= kOneWarp;
  static constexpr int RJ = (W + kWarp - 1) / kWarp;               // rows a lane
  static constexpr int CW = kSmall ? W : kChunk;                   // columns a warp
  static constexpr int NW = W / CW;                                // warps a tile
  static constexpr int kThreads = threads_of(W);
  static constexpr int kTiles = tiles_of(W);                       // tiles a block
};

// The search key of an entry: |v| as an unsigned integer, plus one, which
// orders as |v| does; every NaN is made the one value above inf.  0 is
// left for a row that is not a candidate.
__device__ __forceinline__ unsigned key_of(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return (b > 0x7f800000u ? 0x7fffffffu : b) + 1u;
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float(key - 1u);
}

// The candidate order: the larger key, and between equal keys the lower
// position (pw = position << 8 | row).
__device__ __forceinline__ void merge(unsigned& key, unsigned& pw,
                                      unsigned ok, unsigned opw) {
  if (ok > key || (ok == key && opw < pw)) {
    key = ok;
    pw = opw;
  }
}

// The pivot search across the warp.  In: this lane's best candidate (key,
// pw), and (dkey, rk) = (the key, the row + 1) of the row at position k if
// this lane holds it, else 0.  Out: the warp's best and the row at k.
template <bool kRedux>
__device__ __forceinline__ void warp_search(unsigned& key, unsigned& pw,
                                            unsigned& dkey, unsigned& rk) {
  if constexpr (kRedux) {
    dkey = __reduce_max_sync(kFull, dkey);
    rk = __reduce_max_sync(kFull, rk);
    const unsigned m = __reduce_max_sync(kFull, key);
    pw = __reduce_min_sync(kFull, key == m ? pw : 0xffffffffu);
    key = m;
  } else {                          // a butterfly of shuffles (the probe's
#pragma unroll                      // comparison only)
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      const unsigned ok = __shfl_xor_sync(kFull, key, off);
      const unsigned opw = __shfl_xor_sync(kFull, pw, off);
      dkey = max(dkey, __shfl_xor_sync(kFull, dkey, off));
      rk = max(rk, __shfl_xor_sync(kFull, rk, off));
      merge(key, pw, ok, opw);
    }
  }
}

// The pivot's rule: j = k where tol = 0 or |a[k][k]| >= tol * maxv, else
// the best candidate.  Returns the pivot's row and sets ppos to its
// position before the swap.
__device__ __forceinline__ int pick_pivot(unsigned key, unsigned pw,
                                          unsigned dkey, unsigned rk, int k,
                                          float tol, int& ppos) {
  const bool keep =
      tol == 0.0f || value_of(dkey) >= __fmul_rn(tol, value_of(key));
  ppos = keep ? k : static_cast<int>(pw >> 8);
  return keep ? static_cast<int>(rk) - 1 : static_cast<int>(pw & 0xffu);
}

// a / d rounded to nearest, bit for bit what div.rn.f32 (__fdiv_rn) and
// the plain version's torch division give, inline: div.rn.f32 compiles
// to a fast path and a call for the rare operands, and that call's
// convention spills registers at some widths.  In double: an approximate
// reciprocal (about 20 bits), one Newton step (about 40), the quotient
// and one correction by its exact remainder leave q within a unit of
// 2^-52 of a / d, and no quotient of two floats lies that close to a
// rounding boundary of float unless it is one (an exact subnormal
// midpoint, which q then holds exactly), so q's rounding to float is
// a / d's.  Zeros, infinities and NaNs take A times the reciprocal, which
// is what IEEE division gives for them.
// c ? x : y as one selp, after both x and y are computed: a C++ select
// whose arm is long may become a branch, and a branch per row slot that
// the lanes take apart runs the slots one after the other.
__device__ __forceinline__ float select(bool c, float x, float y) {
  float r;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.f32 %0, %1, %2, q;\n}"
      : "=f"(r) : "f"(x), "f"(y), "r"(static_cast<unsigned>(c)));
  return r;
}

__device__ __forceinline__ double select(bool c, double x, double y) {
  double r;
  asm("{\n.reg .pred q;\nsetp.ne.u32 q, %3, 0;\nselp.f64 %0, %1, %2, q;\n}"
      : "=d"(r) : "d"(x), "d"(y), "r"(static_cast<unsigned>(c)));
  return r;
}

__device__ __forceinline__ float div_rn(float a, float d) {
  const double A = a, D = d;
  double r0;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r0) : "d"(D));
  const double r = fma(r0, fma(-D, r0, 1.0), r0);
  double q = A * r;
  q = fma(fma(-D, q, A), r, q);
  const bool regular = isfinite(a) && isfinite(d) && a != 0.0f && d != 0.0f;
  return __double2float_rn(select(regular, q, A * r0));
}

__device__ __forceinline__ float perturb(float d, float eps) {
  return fabsf(d) < eps ? (d < 0.0f ? -eps : eps) : d;
}

// Row p of this warp's chunk, from the lane that holds it to every lane:
// the owner stores it in buf (CW floats of this warp's own, 16-byte
// aligned) and every lane reads it back after the warp's barrier.  The
// callers alternate between two such buffers, so that a store never
// meets a lane still reading the row before it.
template <int RJ, int CW>
__device__ __forceinline__ void share_row(const float (&a)[RJ][CW], int lane,
                                          int p, float* buf,
                                          float (&u)[CW]) {
  float4* b4 = reinterpret_cast<float4*>(buf);
#pragma unroll
  for (int s = 0; s < RJ; ++s) {
    if (lane + kWarp * s == p) {
#pragma unroll
      for (int q = 0; q < CW / 4; ++q) {
        b4[q] = make_float4(a[s][4 * q], a[s][4 * q + 1], a[s][4 * q + 2],
                            a[s][4 * q + 3]);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < CW / 4; ++q) {
    const float4 v = b4[q];
    u[4 * q] = v.x;
    u[4 * q + 1] = v.y;
    u[4 * q + 2] = v.z;
    u[4 * q + 3] = v.w;
  }
}

// a[r][c] -= l[r] * u for every row of this lane, the product rounded.
template <int RJ, int CW>
__device__ __forceinline__ void rank1(float (&a)[RJ][CW], int c,
                                      const float (&l)[RJ], float u) {
#pragma unroll
  for (int s = 0; s < RJ; ++s) {
    a[s][c] = __fsub_rn(a[s][c], __fmul_rn(l[s], u));
  }
}

// Factors this warp's chunk (its columns c0 .. c0 + CW - 1, every earlier
// column's update applied) and leaves each column's pivot row and
// multipliers in prow / lmul where the tile has more than one chunk.
template <int RJ, int CW>
__device__ __forceinline__ void factor_chunk(float (&a)[RJ][CW],
                                             int (&pos)[RJ], int lane,
                                             int c0, float eps, float tol,
                                             float* rowbuf, int* prow,
                                             float* lmul) {
#pragma unroll
  for (int kk = 0; kk < CW; ++kk) {
    const int k = c0 + kk;
    unsigned key = 0, pw = 0xffffffffu, dkey = 0, rk = 0;
#pragma unroll
    for (int s = 0; s < RJ; ++s) {
      const unsigned row = lane + kWarp * s;
      const unsigned kv = pos[s] >= k ? key_of(a[s][kk]) : 0u;
      merge(key, pw, kv, static_cast<unsigned>(pos[s]) << 8 | row);
      if (pos[s] == k) {
        dkey = kv;
        rk = row + 1;
      }
    }
    warp_search<true>(key, pw, dkey, rk);
    int ppos;
    const int p = pick_pivot(key, pw, dkey, rk, k, tol, ppos);
    const int rowk = static_cast<int>(rk) - 1;
    float u[CW];
    share_row(a, lane, p, rowbuf + (kk & 1) * CW, u);
    const float d = perturb(u[kk], eps);
    float l[RJ];
#pragma unroll
    for (int s = 0; s < RJ; ++s) {
      const int row = lane + kWarp * s;
      pos[s] = row == p ? k : (row == rowk ? ppos : pos[s]);
      const bool below = pos[s] > k;
      l[s] = select(below, div_rn(a[s][kk], d), 0.0f);
      a[s][kk] = below ? l[s] : (row == p ? d : a[s][kk]);
      if (lmul != nullptr) {
        lmul[kk * RJ * kWarp + row] = l[s];
      }
    }
    if (prow != nullptr && lane == 0) {
      prow[kk] = p;
    }
#pragma unroll
    for (int c = kk + 1; c < CW; ++c) {
      rank1(a, c, l, u[c]);
    }
  }
}

// Applies another chunk's CW rank-1 updates, in column order, to this
// warp's columns, from that chunk's pivot rows and multipliers.
template <int RJ, int CW>
__device__ __forceinline__ void apply_chunk(float (&a)[RJ][CW], int lane,
                                            float* rowbuf, const int* prow,
                                            const float* lmul) {
#pragma unroll
  for (int kk = 0; kk < kChunk; ++kk) {
    float l[RJ], u[CW];
#pragma unroll
    for (int s = 0; s < RJ; ++s) {
      l[s] = lmul[kk * RJ * kWarp + lane + kWarp * s];
    }
    share_row(a, lane, prow[kk], rowbuf + (kk & 1) * CW, u);
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      rank1(a, c, l, u[c]);
    }
  }
}

// One tile per warp (W <= 32) or per block (W >= 40); tile t starts at
// in + dbase[t] * ld, or at in + t * W * ld without dbase, rows ld floats
// apart.  F and P go to the same offsets of fout and pout, from the first
// slot of each run of equal dbase values only.  in may be fout: a storing
// slot loads its whole tile before its first barrier (W >= 40) or store
// (W <= 32), and no other slot stores to its rows.
template <int W>
__global__ void __launch_bounds__(Geo<W>::kThreads, 1)
lu_tile_kernel(const float* in, float* fout, float* pout,
               const long long* dbase, int nt, int ld, float eps,
               float tol) {
  using Gm = Geo<W>;
  constexpr int RJ = Gm::RJ, CW = Gm::CW, NW = Gm::NW;
  static_assert(W % 8 == 0 && W <= 4 * kWarp, "W a multiple of 8 <= 128");
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int tile = Gm::kSmall ? blockIdx.x * Gm::kTiles + warp : blockIdx.x;
  if (tile >= nt) {
    return;                         // a whole warp (W <= 32) leaves
  }
  const int w = Gm::kSmall ? 0 : warp;
  const int c0 = w * CW;
  const long long base =
      dbase != nullptr ? dbase[tile] * ld : static_cast<long long>(tile) * W * ld;
  // the first slot of a run of equal dbase values stores, the others not
  const bool store =
      dbase == nullptr || tile == 0 || dbase[tile] != dbase[tile - 1];

  float a[RJ][CW];
  int pos[RJ];
#pragma unroll
  for (int s = 0; s < RJ; ++s) {
    const int row = lane + kWarp * s;
    pos[s] = row < W ? row : -1;    // a padding row is never a candidate
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row < W) {
        v = *reinterpret_cast<const float4*>(in + base + row * ld + c0 + 4 * q);
      }
      a[s][4 * q] = v.x;
      a[s][4 * q + 1] = v.y;
      a[s][4 * q + 2] = v.z;
      a[s][4 * q + 3] = v.w;
    }
  }

  // each warp's two buffers for the pivot row (share_row)
  __shared__ __align__(16) float rowbufs[Gm::kTiles * NW][2 * CW];
  float* rowbuf = rowbufs[warp];
  if constexpr (NW == 1) {
    factor_chunk(a, pos, lane, 0, eps, tol, rowbuf, nullptr, nullptr);
  } else {
    __shared__ float lmul[2][kChunk * RJ * kWarp];   // by chunk parity
    __shared__ int prow[2][kChunk];
    __shared__ int posof[RJ * kWarp];  // each row's position after a chunk
    if (w == 0) {
      factor_chunk(a, pos, lane, 0, eps, tol, rowbuf, prow[0], lmul[0]);
#pragma unroll
      for (int s = 0; s < RJ; ++s) {
        posof[lane + kWarp * s] = pos[s];
      }
    }
#pragma unroll 1
    for (int kc = 0; kc < NW - 1; ++kc) {
      __syncthreads();              // chunk kc's pivots and multipliers
      if (w > kc) {
        apply_chunk(a, lane, rowbuf, prow[kc & 1], lmul[kc & 1]);
      }
      if (w == kc + 1) {            // the look-ahead: the next chunk
#pragma unroll
        for (int s = 0; s < RJ; ++s) {
          pos[s] = posof[lane + kWarp * s];
        }
        factor_chunk(a, pos, lane, c0, eps, tol, rowbuf, prow[(kc + 1) & 1],
                     lmul[(kc + 1) & 1]);
#pragma unroll
        for (int s = 0; s < RJ; ++s) {
          posof[lane + kWarp * s] = pos[s];
        }
      }
    }
    __syncthreads();                // the last chunk's positions
#pragma unroll
    for (int s = 0; s < RJ; ++s) {
      pos[s] = posof[lane + kWarp * s];
    }
  }

  if (!store) {
    return;                         // no barrier follows
  }
  // each row to its position: F's entries of this warp's columns, and P's
  // row there, one-hot at the row's own index
#pragma unroll
  for (int s = 0; s < RJ; ++s) {
    const int row = lane + kWarp * s;
    if (row >= W) {
      continue;
    }
    const long long at = base + static_cast<long long>(pos[s]) * ld;
#pragma unroll
    for (int q = 0; q < CW / 4; ++q) {
      const int c = c0 + 4 * q;
      *reinterpret_cast<float4*>(fout + at + c) =
          make_float4(a[s][4 * q], a[s][4 * q + 1], a[s][4 * q + 2],
                      a[s][4 * q + 3]);
      *reinterpret_cast<float4*>(pout + at + c) =
          make_float4(row == c ? 1.0f : 0.0f, row == c + 1 ? 1.0f : 0.0f,
                      row == c + 2 ? 1.0f : 0.0f, row == c + 3 ? 1.0f : 0.0f);
    }
    if (w == NW - 1) {              // a pool row's columns past the tile
      const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c = W; c < ld; c += 4) {
        *reinterpret_cast<float4*>(fout + at + c) = z;
        *reinterpret_cast<float4*>(pout + at + c) = z;
      }
    }
  }
}

template <int W>
cudaError_t launch(const float* in, float* f, float* p, const long long* dbase,
                   int nt, int ld, float eps, float tol, cudaStream_t stream) {
  using Gm = Geo<W>;
  lu_tile_kernel<W><<<(nt + Gm::kTiles - 1) / Gm::kTiles, Gm::kThreads, 0,
                      stream>>>(in, f, p, dbase, nt, ld, eps, tol);
  return cudaGetLastError();
}

cudaError_t dispatch(const float* in, float* f, float* p,
                     const long long* dbase, int nt, int W, int ld, float eps,
                     float tol, cudaStream_t s) {
  switch (W) {
    case 8: return launch<8>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 16: return launch<16>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 24: return launch<24>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 32: return launch<32>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 40: return launch<40>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 48: return launch<48>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 56: return launch<56>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 64: return launch<64>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 72: return launch<72>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 80: return launch<80>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 88: return launch<88>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 96: return launch<96>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 104: return launch<104>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 112: return launch<112>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 120: return launch<120>(in, f, p, dbase, nt, ld, eps, tol, s);
    case 128: return launch<128>(in, f, p, dbase, nt, ld, eps, tol, s);
  }
  return cudaErrorInvalidValue;
}

// One warp, `steps` dependent LU columns as factor_chunk chains them: the
// search (two reductions of redux.sync, or with kRedux false a five-round
// butterfly of shuffles), the pivot's rule, the pivot row through shared
// memory (share_row), its perturbation, one division and the
// product-then-difference that makes the next column's entry.
template <bool kRedux>
__global__ void lu_chain_probe_kernel(float* out, int steps, float tol) {
  __shared__ __align__(16) float buf[2][4];
  const unsigned lane = threadIdx.x;
  const float w = 0.5f + 0.001f * lane;       // not a constant
  float v = 1.0f + 0.01f * lane;
  for (int i = 0; i < steps; ++i) {
    const unsigned kv = key_of(v);
    unsigned key = kv, pw = lane << 8 | lane;
    unsigned dkey = lane == 0 ? kv : 0u, rk = lane == 0 ? 1u : 0u;
    warp_search<kRedux>(key, pw, dkey, rk);
    int ppos;
    const int p = pick_pivot(key, pw, dkey, rk, 0, tol, ppos);
    float row[1][4] = {{v, v, v, v}}, u[4];
    share_row(row, lane, p, buf[i & 1], u);
    const float d = perturb(u[0], 1e-30f);
    v = __fsub_rn(2.0f, __fmul_rn(div_rn(v, d), w));   // stays near 1.5
  }
  out[lane] = v;
}

__global__ void empty_kernel() {}

}  // namespace

// in, f, p: (nt, W, W) f32, contiguous, 16-byte aligned, on the current
// device; W a multiple of 8 in [8, 128].  Writes F (L\U packed) to f and
// the one-hot pivot matrix to p.  Launches on `stream` and does not
// synchronise.  Returns cudaGetLastError().
extern "C" int tpt_lu_tiles(const float* in, float* f, float* p, int nt,
                            int W, float eps, float tol, void* stream) {
  if (nt <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(dispatch(in, f, p, nullptr, nt, W, W, eps, tol,
                                   static_cast<cudaStream_t>(stream)));
}

// lpool, upool: (rows, ld) f32, contiguous, 16-byte aligned, ld a multiple
// of 4 and >= W; dbase: nt int64 first rows, slots with the same first row
// next to each other, tiles of different first rows disjoint.  Factors the
// W x W tile at rows dbase[t] .. dbase[t] + W - 1, columns 0 .. W - 1 of
// lpool in place: F into those rows of lpool, P into the same rows of
// upool, columns W .. ld - 1 of both zeroed.  Launches on `stream`, does
// not synchronise.
extern "C" int tpt_lu_tiles_pool(float* lpool, float* upool,
                                 const long long* dbase, int nt, int W,
                                 int ld, float eps, float tol, void* stream) {
  if (nt <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  return static_cast<int>(dispatch(lpool, lpool, upool, dbase, nt, W, ld,
                                   eps, tol,
                                   static_cast<cudaStream_t>(stream)));
}

// out: 32 floats on the current device.  kind 2: the LU column chain as
// lu_tiles runs it (redux.sync search); kind 3: the same with a butterfly
// of shuffles.  tol = 1, so the pivot's rule is evaluated, not skipped.
extern "C" int tpt_lu_chain_probe(float* out, int steps, int kind,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 2) {
    lu_chain_probe_kernel<true><<<1, kWarp, 0, s>>>(out, steps, 1.0f);
  } else {
    lu_chain_probe_kernel<false><<<1, kWarp, 0, s>>>(out, steps, 1.0f);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches an empty kernel on the grid that tpt_lu_tiles uses for nt
// tiles of width W (W a multiple of 8 in [8, 128]): the launch floor of
// that call, timed by the caller.
extern "C" int tpt_lu_empty(int nt, int W, void* stream) {
  empty_kernel<<<(nt + tiles_of(W) - 1) / tiles_of(W), threads_of(W), 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
