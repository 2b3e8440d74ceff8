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
// column gets tau = 0.  For column c of the panel, over rows r >= c:
//   normx = ||M[c:, c]||, sgn = (x0 >= 0 ? 1 : -1), alpha = -sgn normx,
//   v = M[r, c] / (x0 - alpha) below c (1 as the divisor when that is 0),
//   v[c] = 1, tau = (normx == 0 ? 0 : (alpha - x0) / alpha),
//   w[k] = v . M[:, k],  M[:, k] -= (tau v) w[k]  for the panel's k >= c,
// and v is stored below the diagonal.  Rows above k0 are not touched: v
// is zero there.
//
// Design: one block per front, the column loop serial, one thread per
// row (strided).  The panel's rows k0 .. m-1 sit in shared memory, the
// row stride odd so that the threads of a warp, on consecutive rows,
// hit distinct banks; where they do not fit (the dense TpuQR's tall
// panels: 4,096 rows x 16 columns are 256 KB), the block works on them
// in device memory (L2) through the same code.  A column takes a
// block-wide sum for its norm and one block-wide vector sum for the pb
// dot products w[k] = v . M[:, k]: for k < c these are v_k . v_c, the
// column of V^T V that the compact-WY recurrence needs, so T costs no
// extra pass over the rows.  Every thread keeps the rows it owns, so the
// only barriers are those of the two sums and one per column.  One warp
// then forms T (pb <= 16) from V^T V and the taus.
//
// What bounds it: about 4 (m - k0) pb^2 FLOP on 2 (m - k0) pb floats read
// and written plus V, a little over pb FLOP per byte; a panel is a
// serial chain of pb columns, each some four block barriers long, so at
// the panel sizes of the sparse QR (8 to 1,760 rows of 8 columns) the
// chain, not the bytes or the FLOP, sets its time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;        // blocks of at most 512 threads

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, o);
  }
  return v;
}

template <int PBMAX>
__global__ void __launch_bounds__(kMaxWarps * 32)
qr_panel_kernel(float* M, float* __restrict__ taus, float* __restrict__ V,
                float* __restrict__ T, int m, int C, int k0, int pb,
                int in_smem) {
  extern __shared__ float smem[];
  __shared__ float red[kMaxWarps][PBMAX];
  __shared__ float red1[kMaxWarps];
  __shared__ float dsh[PBMAX];
  __shared__ float vtv[PBMAX][PBMAX];     // vtv[k][c] = v_k . v_c, k < c
  __shared__ float tau_s[PBMAX];
  __shared__ float Ts[PBMAX][PBMAX];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int mm = m - k0;
  float* Mp = M + static_cast<size_t>(blockIdx.x) * m * C
              + static_cast<size_t>(k0) * C + k0;
  float* S = Mp;
  int ld = C;
  if (in_smem) {
    S = smem;
    ld = pb | 1;
    for (int i = tid; i < mm * pb; i += nt) {
      const int r = i / pb, c = i - r * pb;
      S[r * ld + c] = Mp[static_cast<size_t>(r) * C + c];
    }
    __syncthreads();
  }
  for (int j = 0; j < pb; ++j) {
    // the column's norm over rows >= j
    float part = 0.0f;
    for (int r = j + tid; r < mm; r += nt) {
      const float x = S[r * ld + j];
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
    const float x0 = S[j * ld + j];
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
      const float v = r == j ? 1.0f : S[r * ld + j] / safe;
#pragma unroll
      for (int k = 0; k < PBMAX; ++k) {
        if (k < pb) {
          acc[k] += v * S[r * ld + k];
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
      const float v = r == j ? 1.0f : S[r * ld + j] / safe;
      const float tv = tau * v;
      for (int k = j + 1; k < pb; ++k) {
        S[r * ld + k] -= tv * dsh[k];
      }
      S[r * ld + j] = r == j ? x0 - tv * dsh[j] : v;
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
    const float s = S[r * ld + c];
    Vp[i] = r > c ? s : (r == c ? 1.0f : 0.0f);
    if (in_smem) {
      Mp[static_cast<size_t>(r) * C + c] = s;
    }
  }
}

template <int PBMAX>
cudaError_t launch(float* M, float* taus, float* V, float* T, int P, int m,
                   int C, int k0, int pb, cudaStream_t stream) {
  // the largest dynamic shared memory a block may take, set once
  static int dyn_max = -1;
  if (dyn_max < 0) {
    int dev, optin;
    cudaFuncAttributes fa;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    }
    if (e == cudaSuccess) {
      e = cudaFuncGetAttributes(&fa, qr_panel_kernel<PBMAX>);
    }
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(qr_panel_kernel<PBMAX>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(fa.sharedSizeBytes));
    }
    if (e != cudaSuccess) {
      return e;
    }
    dyn_max = optin - static_cast<int>(fa.sharedSizeBytes);
  }
  const int mm = m - k0;
  const size_t bytes = static_cast<size_t>(mm) * (pb | 1) * sizeof(float);
  const int in_smem = bytes <= static_cast<size_t>(dyn_max);
  int nt = (mm + 31) / 32 * 32;
  nt = nt < 32 ? 32 : (nt > kMaxWarps * 32 ? kMaxWarps * 32 : nt);
  qr_panel_kernel<PBMAX><<<P, nt, in_smem ? bytes : 0, stream>>>(
      M, taus, V, T, m, C, k0, pb, in_smem);
  return cudaGetLastError();
}

}  // namespace

// M: (P, m, C) f32, taus: (P, C) f32, both updated in place; V: (P,
// m - k0, pb) and T: (P, pb, pb) f32 written; all contiguous on the
// current device; 0 <= k0 < m, 1 <= pb <= 16, k0 + pb <= C.  Launches on
// `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int tpt_qr_panel(float* M, float* taus, float* V, float* T,
                            int P, int m, int C, int k0, int pb,
                            void* stream) {
  if (P <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = pb <= 8
      ? launch<8>(M, taus, V, T, P, m, C, k0, pb, s)
      : launch<16>(M, taus, V, T, P, m, C, k0, pb, s);
  return static_cast<int>(e);
}
