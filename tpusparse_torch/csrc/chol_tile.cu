// Batched lower Cholesky of B x B tiles, B a multiple of 8 up to 128.
//
// Replaces the Pallas kernel _chol_tile_kernel in
// tpusparse/device/kernels/chol_tile.py (entry chol_tiles), which serves
// the chol phase of the superscan factorization and the panel factor of
// the fixed-tile engine.  That kernel unrolled 8-wide mini-panels with a
// masked matmul per panel because its compiler took static slices only;
// this one keeps the 8-wide panels and maps them to threads.
//
// Design: blocked right-looking, panel width 8, templated on B (the C
// entry dispatches on B, so every inner loop unrolls and all index
// arithmetic is by constants).  A group of G threads owns one tile, which
// sits in shared memory with a row stride of B + 4 floats: a thread that
// reads its own row as float4 then hits different banks from its
// neighbours.  Per panel:
//   (a, b) every thread loads the panel's 8 x 8 diagonal block from shared
//       memory (a broadcast) and factors it in registers, redundantly, so
//       that no shuffle and no barrier sits inside the panel.  It factors
//       it as L D L^T and scales by the square roots afterwards, so the
//       chain from one pivot to the next is a reciprocal, a multiply and a
//       fused multiply-add, and the square roots are off it.  With the
//       reciprocal pivots at hand, thread i solves row i of the panel (an
//       8-step chain in registers), writes it back and also writes it,
//       transposed, to a panel buffer;
//   (c) the trailing lower triangle takes the rank-8 update C -= P P^T in
//       4 x 4 register micro-tiles, P read from the transposed panel
//       buffer as float4 (one operand a broadcast, the other consecutive
//       across the warp), and only micro-tiles on or below the diagonal
//       are visited.
// That is two barriers per panel, 32 at B = 128.  B <= 32: G = 32, one
// warp per tile, four tiles per block, __syncwarp only, so a batch of
// small tiles spreads over the card and a tile never waits for another.
// B >= 40: G = 256, one block per tile, __syncthreads.
//
// Only the lower triangle of the input is read (whole 8 x 8 diagonal
// blocks are loaded, but their upper entries only ever reach upper
// entries), eight 16-byte loads in flight a thread; the output holds the
// factor on and below the diagonal and zeros above it.
//
// Failure contract: a pivot <= 0 makes its column non-finite (sqrtf of
// a negative; the reciprocal of 0), and the trailing updates carry that
// through every later panel of that tile.  The caller's finiteness
// check relies on that, so there is no guard.  Tiles never share shared
// memory, so a bad tile cannot reach its neighbours.
//
// What bounds it: latency, not FLOPs (0.7 MFLOP at B = 128) or bytes
// (128 KB).  The floor is the chain of B dependent pivots (reciprocal,
// multiply, fused multiply-add per column; tpt_chain_probe below measures
// one such step); the kernel takes several times that, because a panel's
// factor is some 350 instructions in one warp's issue order and the
// trailing update waits for it (no look-ahead yet).

#include <cuda_runtime.h>

namespace {

constexpr int kNb = 8;              // panel width
constexpr int kWarp = 32;
constexpr int kBlock = 256;         // threads of a block that owns one tile
constexpr int kWarpTiles = 4;       // tiles (warps) per block at B <= 32

template <int G>
__device__ __forceinline__ void group_sync() {
  if constexpr (G == kWarp) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int B>                    // the tile and its panel buffer
constexpr int kTileFloats = B * (B + 4) + kNb * B;

template <int B, int G>
__global__ void __launch_bounds__(G == kWarp ? kWarp * kWarpTiles : G)
chol_tile_kernel(const float* __restrict__ in, float* __restrict__ out,
                 int nt) {
  static_assert(B % kNb == 0 && B <= G, "one row per thread");
  constexpr int ld = B + 4;
  constexpr int Q = B / 4;          // float4s in a row
  extern __shared__ float4 smem4[];
  const int grp = threadIdx.x / G;
  const int tid = threadIdx.x % G;
  const int tile = blockIdx.x * (blockDim.x / G) + grp;
  if (tile >= nt) {
    return;                         // a whole group leaves together
  }
  float* a = reinterpret_cast<float*>(smem4) + grp * kTileFloats<B>;
  float* pt = a + B * ld;           // the panel, transposed: pt[c][row]
  const size_t base = static_cast<size_t>(tile) * B * B;
  const float4* in4 = reinterpret_cast<const float4*>(in + base);
  float4* out4 = reinterpret_cast<float4*>(out + base);

  // the lower triangle, by whole 8 x 8 blocks, in rounds of kLoads loads
  // a thread, all of a round in flight before the first is stored
  constexpr int kLoads = 8;
  for (int e0 = tid; e0 < B * Q; e0 += kLoads * G) {
    float4 v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * G;
      if (e < B * Q && e % Q < 2 * (e / Q / kNb + 1)) {
        v[i] = __ldg(in4 + e);
      }
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * G;
      if (e < B * Q && e % Q < 2 * (e / Q / kNb + 1)) {
        st4(a + (e / Q) * ld + 4 * (e % Q), v[i]);
      }
    }
  }

#pragma unroll 1
  for (int k0 = 0; k0 < B; k0 += kNb) {
    group_sync<G>();
    // (a) the diagonal block, factored in registers by every thread
    float D[kNb][kNb];
#pragma unroll
    for (int r = 0; r < kNb; ++r) {
      const float* dr = a + (k0 + r) * ld + k0;
      const float4 lo = ld4(dr);
      const float4 hi = ld4(dr + 4);
      D[r][0] = lo.x; D[r][1] = lo.y; D[r][2] = lo.z; D[r][3] = lo.w;
      D[r][4] = hi.x; D[r][5] = hi.y; D[r][6] = hi.z; D[r][7] = hi.w;
    }
    // as L D L^T, so that the chain from pivot to pivot is a reciprocal,
    // a multiply and a fused multiply-add; D keeps the unscaled columns
    // (l_ij p_j) and the pivots p_j.  The square roots are off the chain:
    // L_ij = (unscaled entry) * sc_j, sc_j = sqrt(p_j) / p_j, L_jj = dg_j.
    float rp[kNb], dg[kNb], sc[kNb];
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      rp[j] = 1.0f / D[j][j];
#pragma unroll
      for (int i = j + 1; i < kNb; ++i) {
        const float l = D[i][j] * rp[j];
#pragma unroll
        for (int c = j + 1; c <= i; ++c) {
          D[i][c] = fmaf(-l, D[c][j], D[i][c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kNb; ++j) {
      dg[j] = sqrtf(D[j][j]);
      sc[j] = dg[j] * rp[j];
    }
    // (b) row k0 + tid of the panel.  The first 8 are the block's own
    // rows: they are written back only after the barrier, when every
    // thread has read the block.
    float x[kNb];
    float* ar = a + (k0 + tid) * ld + k0;
    if (tid < B - k0) {
      const float4 lo = ld4(ar);
      const float4 hi = ld4(ar + 4);
      x[0] = lo.x; x[1] = lo.y; x[2] = lo.z; x[3] = lo.w;
      x[4] = hi.x; x[5] = hi.y; x[6] = hi.z; x[7] = hi.w;
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        const float l = x[j] * rp[j];
#pragma unroll
        for (int c = j + 1; c < kNb; ++c) {
          x[c] = fmaf(-l, D[c][j], x[c]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNb; ++j) {
        x[j] = tid == j ? dg[j] : x[j] * sc[j];
      }
      if (tid >= kNb) {
        st4(ar, make_float4(x[0], x[1], x[2], x[3]));
        st4(ar + 4, make_float4(x[4], x[5], x[6], x[7]));
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          pt[c * B + tid - kNb] = x[c];
        }
      }
    }
    group_sync<G>();
    if (tid < kNb) {
      st4(ar, make_float4(x[0], x[1], x[2], x[3]));
      st4(ar + 4, make_float4(x[4], x[5], x[6], x[7]));
    }
    // (c) trailing rows and columns k0 + 8 .. B - 1, 4 x 4 micro-tiles
    // t = ti (ti + 1) / 2 + tj, tj <= ti
    const int mt = (B - k0 - kNb) / 4;
    const int ntile = mt * (mt + 1) / 2;
    float* c0 = a + (k0 + kNb) * ld + k0 + kNb;
    for (int t = tid; t < ntile; t += G) {
      int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) {
        --ti;
      }
      while ((ti + 1) * (ti + 2) / 2 <= t) {
        ++ti;
      }
      const int tj = t - ti * (ti + 1) / 2;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 v = ld4(c0 + (4 * ti + r) * ld + 4 * tj);
        acc[r][0] = v.x; acc[r][1] = v.y; acc[r][2] = v.z; acc[r][3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < kNb; ++c) {
        const float4 pi = ld4(pt + c * B + 4 * ti);
        const float4 pj = ld4(pt + c * B + 4 * tj);
        const float vi[4] = {pi.x, pi.y, pi.z, pi.w};
        const float vj[4] = {pj.x, pj.y, pj.z, pj.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            acc[r][s] = fmaf(-vi[r], vj[s], acc[r][s]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        st4(c0 + (4 * ti + r) * ld + 4 * tj,
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
      }
    }
  }
  group_sync<G>();

#pragma unroll 4
  for (int e = tid; e < B * Q; e += G) {
    const int row = e / Q;
    const int c = 4 * (e % Q);
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (c <= row) {
      v = ld4(a + row * ld + c);
      v.y = c + 1 <= row ? v.y : 0.0f;
      v.z = c + 2 <= row ? v.z : 0.0f;
      v.w = c + 3 <= row ? v.w : 0.0f;
    }
    out4[e] = v;
  }
}

template <int B>
cudaError_t launch(const float* in, float* out, int nt, cudaStream_t stream) {
  constexpr int G = B <= kWarp ? kWarp : kBlock;
  constexpr int tiles = B <= kWarp ? kWarpTiles : 1;
  constexpr int smem = tiles * kTileFloats<B> * sizeof(float);
  if constexpr (smem > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        chol_tile_kernel<B, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (attr != cudaSuccess) {
      return attr;
    }
  }
  chol_tile_kernel<B, G><<<(nt + tiles - 1) / tiles, G * tiles, smem,
                           stream>>>(in, out, nt);
  return cudaGetLastError();
}

// One warp, `steps` dependent steps of the chain that bounds a tile
// kernel: kind 0, a Cholesky column as the kernel above chains them
// (pivot -> reciprocal -> scaled entry -> the next pivot by a fused
// multiply-add); kind 1, a substitution column (fused multiply-add,
// divide).
__global__ void chain_probe_kernel(float* out, int steps, int kind) {
  float p = 10.0f + 0.01f * threadIdx.x;
  if (kind == 0) {
    const float t = 3.0f + 0.001f * threadIdx.x;   // not a constant
    for (int i = 0; i < steps; ++i) {
      const float l = t * (1.0f / p);
      p = fmaf(-l, t, 11.0f);       // stays near 10.1
    }
  } else {
    const float d = 2.0f + 0.001f * threadIdx.x;   // not a constant
    for (int i = 0; i < steps; ++i) {
      p = fmaf(-0.5f, p, 1.0f) / d;
    }
  }
  out[threadIdx.x] = p;
}

}  // namespace

extern "C" const char* tpt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// in, out: (nt, B, B) f32, contiguous, 16-byte aligned, on the current
// device; B a multiple of 8 in [8, 128].  Launches on `stream` and does
// not synchronise.  Returns cudaGetLastError().
extern "C" int tpt_chol_tiles(const float* in, float* out, int nt, int B,
                              void* stream) {
  if (nt <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaErrorInvalidValue;
  switch (B) {
    case 8: e = launch<8>(in, out, nt, s); break;
    case 16: e = launch<16>(in, out, nt, s); break;
    case 24: e = launch<24>(in, out, nt, s); break;
    case 32: e = launch<32>(in, out, nt, s); break;
    case 40: e = launch<40>(in, out, nt, s); break;
    case 48: e = launch<48>(in, out, nt, s); break;
    case 56: e = launch<56>(in, out, nt, s); break;
    case 64: e = launch<64>(in, out, nt, s); break;
    case 72: e = launch<72>(in, out, nt, s); break;
    case 80: e = launch<80>(in, out, nt, s); break;
    case 88: e = launch<88>(in, out, nt, s); break;
    case 96: e = launch<96>(in, out, nt, s); break;
    case 104: e = launch<104>(in, out, nt, s); break;
    case 112: e = launch<112>(in, out, nt, s); break;
    case 120: e = launch<120>(in, out, nt, s); break;
    case 128: e = launch<128>(in, out, nt, s); break;
  }
  return static_cast<int>(e);
}

// out: 32 floats on the current device.  Runs the one-warp latency probe
// described at chain_probe_kernel; the caller times it with events.
extern "C" int tpt_chain_probe(float* out, int steps, int kind,
                               void* stream) {
  chain_probe_kernel<<<1, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      out, steps, kind);
  return static_cast<int>(cudaGetLastError());
}
