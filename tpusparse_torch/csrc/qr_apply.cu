// Application of factored fronts' Householder reflectors to one vector
// per front (H3): for each p, with s = slots[p], F = pool[s] (Rh, C) the
// factored front (reflector k below the diagonal of column k, its unit
// diagonal implied), tau = taus[s] and z = z[s] (Rh,), in place,
//   Q^T z = H_{kelim-1} ... H_1 H_0 z   (forward: H_0 first), or
//   Q z   = H_0 H_1 ... H_{kelim-1} z   (reverse),
// H_k = I - tau_k v_k v_k^T, v_k zero above row k, 1 at row k.  A
// reflector with tau_k = 0 is the identity and is skipped.
//
// Computes what the compact-WY applications of tpusparse/device/dense.py
// compute (qr_qt_mul_batched :303, qr_q_mul_batched :319, their scan
// forms :423, :441 and the dense qr_apply_qt / qr_apply_q :183, :197), up
// to rounding: those apply a panel of 8 reflectors at a time as
// I - V T V^T; the JAX package has no Pallas kernel for them (XLA fuses
// the einsums).  Here the reflectors go one at a time.
//
// Design: one block per front, z in shared memory (the sparse QR's fronts
// have at most a few thousand rows; a z too large for shared memory, as
// a tall dense TpuQR gives, is worked on in device memory in place).
// Thread t owns rows t, t + nt, ...: it alone reads and writes them, so
// a reflector costs one block-wide dot (warp sums, then one barrier; the
// warp sums go to one of two buffers in turn, so the next reflector
// needs no second barrier) and one axpy, and z needs no barrier at all.
// v_k is read down column k of the front, one float per row at the
// front's row stride; the reflectors k .. k+7 share each row's 32-byte
// sector, which the first of them brings into L1.
//
// What bounds it: 4 (Rh - k) FLOP per reflector on (Rh - k) floats of V
// read once, 1 FLOP per byte, so device memory, were the reflectors not
// a serial chain of kelim barriers; at the sparse QR's front sizes the
// chain sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;        // blocks of at most 512 threads

template <bool FORWARD>
__global__ void __launch_bounds__(kMaxWarps * 32)
qr_apply_kernel(const float* __restrict__ pool,
                const float* __restrict__ taus,
                const int64_t* __restrict__ slots, float* z, int Rh, int C,
                int kelim, int in_smem) {
  extern __shared__ float zs[];
  __shared__ float red[2][kMaxWarps];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int64_t s = __ldg(slots + blockIdx.x);
  const float* F = pool + s * Rh * C;
  const float* tp = taus + s * C;
  float* zg = z + s * Rh;
  float* zz = in_smem ? zs : zg;
  if (in_smem) {
    for (int r = tid; r < Rh; r += nt) {
      zz[r] = zg[r];
    }
  }
  int buf = 0;
  for (int i = 0; i < kelim; ++i) {
    const int k = FORWARD ? i : kelim - 1 - i;
    const float tau = __ldg(tp + k);
    if (tau == 0.0f) {
      continue;                      // the same branch in every thread
    }
    // the first row >= k that this thread owns
    const int r0 = tid >= k ? tid : tid + (k - tid + nt - 1) / nt * nt;
    float part = 0.0f;
    for (int r = r0; r < Rh; r += nt) {
      const float v = r == k ? 1.0f
          : __ldg(F + static_cast<size_t>(r) * C + k);
      part += v * zz[r];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      part += __shfl_xor_sync(0xffffffffu, part, o);
    }
    if (lane == 0) {
      red[buf][warp] = part;
    }
    __syncthreads();
    float dot = 0.0f;
    for (int w = 0; w < nw; ++w) {
      dot += red[buf][w];
    }
    buf ^= 1;
    const float td = tau * dot;
    for (int r = r0; r < Rh; r += nt) {
      const float v = r == k ? 1.0f
          : __ldg(F + static_cast<size_t>(r) * C + k);
      zz[r] -= td * v;
    }
  }
  if (in_smem) {
    for (int r = tid; r < Rh; r += nt) {
      zg[r] = zz[r];
    }
  }
}

template <bool FORWARD>
cudaError_t launch(const float* pool, const float* taus,
                   const int64_t* slots, float* z, int P, int Rh, int C,
                   int kelim, cudaStream_t stream) {
  static int dyn_max = -1;           // set once
  if (dyn_max < 0) {
    int dev, optin;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) {
      e = cudaFuncGetAttributes(&fa, qr_apply_kernel<FORWARD>);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(qr_apply_kernel<FORWARD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
    }
    if (e != cudaSuccess) {
      return e;
    }
    dyn_max = optin - static_cast<int>(fa.sharedSizeBytes);
  }
  const size_t bytes = static_cast<size_t>(Rh) * sizeof(float);
  const int in_smem = bytes <= static_cast<size_t>(dyn_max);
  int nt = (Rh + 31) / 32 * 32;
  nt = nt < 32 ? 32 : (nt > kMaxWarps * 32 ? kMaxWarps * 32 : nt);
  qr_apply_kernel<FORWARD><<<P, nt, in_smem ? bytes : 0, stream>>>(
      pool, taus, slots, z, Rh, C, kelim, in_smem);
  return cudaGetLastError();
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
  if (P <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = forward
      ? launch<true>(pool, taus, slots, z, P, Rh, C, kelim, s)
      : launch<false>(pool, taus, slots, z, P, Rh, C, kelim, s);
  return static_cast<int>(e);
}
