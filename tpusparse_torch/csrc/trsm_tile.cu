// Batched triangular solve with a lower factor, per slot or shared:
//   Y[i] = X[i] * L[i]^-T,  L (nt, W, W) lower    (tpt_trsm_tiles_batched)
//   Y[i] = X[i] * L^-T,     L (W, W) lower shared  (tpt_trsm_tiles)
// X and Y (nt, R, W), R and W multiples of 8 up to 128.
//
// Replaces the two Pallas kernels of tpusparse/device/kernels/trsm_tile.py
// (body _trsm_body): _trsm_kernel_b (entry trsm_tiles_batched), which
// serves the trsm phase of the superscan factorization, and _trsm_kernel
// (entry trsm_tiles), the panel trsm of the fixed-tile engine, where one
// diagonal tile's factor serves every off-diagonal tile of its panel.
// Those kernels unrolled 8-wide mini-panels with a masked matmul per
// panel because their compiler took static slices only; this one writes
// the substitution out directly.  Both entry points launch the one
// kernel below: the L batch stride is W * W for a per-slot L and 0 for a
// shared one (every block then reads the same 64 KB at W = 128, which
// stays in L2).
//
// Design: one thread block per slot.  The slot's W x W factor and its
// R x W right-hand rows sit in dynamic shared memory (L with row stride
// W, read as a broadcast; the rows with stride W + 1, so that the
// threads of a warp, one per row, hit different banks).  Thread r solves
// row r by forward substitution over the columns:
//   y_j = (x_j - sum_{k<j} y_k L[j][k]) / L[j][j].
// Only the lower triangle of L is read.
//
// What bounds it: a slot is at most 2 MFLOP with a W-long chain of
// dependent updates per row, and at R <= 128 a block has at most four
// busy warps, so the kernel is bound by latency and by the few threads
// a slot gives it, not by FLOPs or bytes.  The fixed-tile engine's
// panels give it at most 15 slots, so most of the card's 132 SMs idle.
// The simple design does nothing about that yet; splitting columns over
// warps and wgmma for the off-diagonal updates are for later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // one thread per row, R <= 128
constexpr int kMaxW = 128;

__global__ void __launch_bounds__(kThreads)
trsm_tile_kernel(const float* __restrict__ L, const float* __restrict__ X,
                 float* __restrict__ Y, int R, int W, size_t l_stride) {
  extern __shared__ float sm[];
  float* l = sm;            // W x W, row stride W
  float* y = sm + W * W;    // R x W, row stride W + 1
  const int ldy = W + 1;
  const size_t lb = static_cast<size_t>(blockIdx.x) * l_stride;
  const size_t xb = static_cast<size_t>(blockIdx.x) * R * W;

  for (int e = threadIdx.x; e < W * W; e += blockDim.x) {
    l[e] = L[lb + e];
  }
  for (int e = threadIdx.x; e < R * W; e += blockDim.x) {
    y[(e / W) * ldy + e % W] = X[xb + e];
  }
  __syncthreads();

  const int r = threadIdx.x;
  if (r < R) {
    float* yr = y + r * ldy;
    for (int j = 0; j < W; ++j) {
      const float* lj = l + j * W;
      float s = yr[j];
      for (int k = 0; k < j; ++k) {
        s -= yr[k] * lj[k];
      }
      yr[j] = s / lj[j];
    }
  }
  __syncthreads();

  for (int e = threadIdx.x; e < R * W; e += blockDim.x) {
    Y[xb + e] = y[(e / W) * ldy + e % W];
  }
}

int launch(const float* L, const float* X, float* Y, int nt, int R, int W,
           size_t l_stride, void* stream) {
  if (nt <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        trsm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kMaxW * kMaxW + kMaxW * (kMaxW + 1))
                         * sizeof(float)));
    if (e != cudaSuccess) {
      return static_cast<int>(e);
    }
    configured = true;
  }
  const size_t smem =
      (static_cast<size_t>(W) * W + static_cast<size_t>(R) * (W + 1))
      * sizeof(float);
  trsm_tile_kernel<<<nt, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(L, X, Y, R, W,
                                                          l_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// L: (nt, W, W), X, Y: (nt, R, W), f32, contiguous, on the current
// device.  Launches on `stream` and does not synchronise.  Returns
// cudaGetLastError().
extern "C" int tpt_trsm_tiles_batched(const float* L, const float* X,
                                      float* Y, int nt, int R, int W,
                                      void* stream) {
  return launch(L, X, Y, nt, R, W, static_cast<size_t>(W) * W, stream);
}

// L: (W, W), shared by every slot; X, Y: (nt, R, W); as above.
extern "C" int tpt_trsm_tiles(const float* L, const float* X, float* Y,
                              int nt, int R, int W, void* stream) {
  return launch(L, X, Y, nt, R, W, 0, stream);
}
