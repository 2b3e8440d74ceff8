// SELL-128 windowed-gather sparse matrix-vector product, one S class of
// 128-row blocks, over the compact pack of its slabs:
//   y[bids[b] * 128 + rows[b][r]] = sum over the entries e of sorted row r
//       of cvals[e] * x[win[b][cpos[e] >> 10] * 1024 + (cpos[e] & 1023)]
// for b < NB, r < 128 and rows < n.  win (NB, TW) i32 holds each block's
// x tiles of 1024 entries, TW <= 32, so a window-relative position
// cpos = slot * 1024 + (col mod 1024) fits 16 bits; bids (NB,) i32 the
// block ids; x and y have n entries.
//
// Replaces the Pallas kernels _kernel (v1, the default) and _kernel_v2
// in tpusparse/device/kernels/sell_spmv.py (entry build_sell_call), the
// general-pattern kernel of the device SpMV plan (mode "sell"), and the
// scatter `yb.at[bids].set(out)` that followed them in
// tpusparse/device/spmv.py.  Those kernels read (NB, S, 8, 128) slabs
// whose every block is padded to a power-of-two number of 8-entry
// sub-steps for 128-lane vector units, and split the gather into masked
// 128-lane gathers; at about 9 entries a row half of the slab is padding.
// Here the planner's slabs (either layout: both carry
// pos = slot * 1024 + (col mod 1024)) are packed once, at upload, by
// sell_pack in kernels/sell_spmv.py, and the kernel reads entries only.
//
// The pack, per block: the 128 rows are sorted by entry count, longest
// first (rows (NB, 128) u8 maps sorted position -> lane); at depth d the
// first cnt[d] sorted rows still have an entry, and those cnt[d] entries
// are stored side by side (jagged-diagonal order), depth after depth,
// from entry off[b] of cpos / cvals on.  start (NB, D + 1) i16 holds the
// running sums of cnt, so entry d of sorted row r is at
// off[b] + start[b][d] + r, for r < start[b][d + 1] - start[b][d].  A
// row's entries keep their slab order, so its sum runs in that order.
//
// Design: one 128-thread block per 128-row block, thread r for sorted row
// r.  At each depth the live threads read consecutive cpos / cvals, so the
// loads are coalesced and no padding is read; four depths are in flight
// per thread.  start is read as a broadcast, the block's window tiles sit
// in shared memory, x goes through the read-only path and stays in L2.
//
// What bounds it: 2 FLOP per 6 bytes of entry (a 4-byte value and a
// 2-byte position), so device memory: the entries once, 130 + 2 (D + 1)
// + 4 (TW + 2) bytes of block data per 128 rows, x once and y once.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;     // rows per block, one thread each
constexpr int kTile = 1024;    // x entries per window tile
constexpr int kDepths = 4;     // depths in flight per thread

__global__ void __launch_bounds__(kRows)
sell_spmv_kernel(const int* __restrict__ bids, const int* __restrict__ win,
                 const int* __restrict__ off, const short* __restrict__ start,
                 const unsigned char* __restrict__ rows,
                 const short* __restrict__ cpos,
                 const float* __restrict__ cvals, const float* __restrict__ x,
                 float* __restrict__ y, int D, int TW, int n) {
  extern __shared__ int sw[];  // the block's TW window tiles
  const int b = blockIdx.x;
  const int r = threadIdx.x;
  for (int t = r; t < TW; t += kRows) {
    sw[t] = __ldg(win + static_cast<size_t>(b) * TW + t);
  }
  __syncthreads();
  const short* st = start + static_cast<size_t>(b) * (D + 1);
  const size_t base = static_cast<size_t>(__ldg(off + b)) + r;
  const short* p0 = cpos + base;
  const float* v0 = cvals + base;
  float acc = 0.0f;
  int s0 = 0;
  for (int d = 0; d < D; d += kDepths) {   // D is a multiple of 8
    int s[kDepths + 1];
    s[0] = s0;
#pragma unroll
    for (int k = 0; k < kDepths; ++k) {
      s[k + 1] = __ldg(st + d + k + 1);
    }
    if (r >= s[1] - s[0]) {
      break;                   // cnt only falls with depth
    }
    bool live[kDepths];
    int p[kDepths];
    float v[kDepths];
#pragma unroll
    for (int k = 0; k < kDepths; ++k) {
      live[k] = r < s[k + 1] - s[k];
      p[k] = live[k] ? __ldg(p0 + s[k]) : 0;
      v[k] = live[k] ? __ldg(v0 + s[k]) : 0.0f;
    }
    float xv[kDepths];
#pragma unroll
    for (int k = 0; k < kDepths; ++k) {
      const int j = sw[p[k] >> 10] * kTile + (p[k] & (kTile - 1));
      xv[k] = live[k] && j < n ? __ldg(x + j) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kDepths; ++k) {
      acc = fmaf(v[k], xv[k], acc);
    }
    s0 = s[kDepths];
  }
  const int row = __ldg(bids + b) * kRows
                  + __ldg(rows + static_cast<size_t>(b) * kRows + r);
  if (row < n) {
    y[row] = acc;
  }
}

}  // namespace

// bids (NB,), win (NB, TW), off (NB + 1,) i32; start (NB, D + 1) i16;
// rows (NB, 128) u8; cpos i16 and cvals f32 (off[NB],); x and y (n,) f32;
// all contiguous, on the current device.  Writes only the rows of the NB
// blocks.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError().
extern "C" int tpt_sell_spmv(const int* bids, const int* win, const int* off,
                             const short* start, const unsigned char* rows,
                             const short* cpos, const float* cvals,
                             const float* x, float* y, int NB, int D, int TW,
                             int n, void* stream) {
  if (NB <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  sell_spmv_kernel<<<NB, kRows, TW * sizeof(int),
                     static_cast<cudaStream_t>(stream)>>>(
      bids, win, off, start, rows, cpos, cvals, x, y, D, TW, n);
  return static_cast<int>(cudaGetLastError());
}
