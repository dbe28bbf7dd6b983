// Blocked GEMM with an f32 accumulator, in two operand layouts:
//
//   NN  C = A @ B     A:(m, k)  B:(k, n)   replaces src/repro/kernels/matmul_nn.py:77
//   NT  C = A @ B^T   A:(m, k)  B:(n, k)   replaces src/repro/kernels/matmul_nt.py:81
//
// NN is stage 2 of the paper's TNN (after the transpose kernel); NT is the
// direct arm, which reads B in its stored (n, k) layout and turns each tile
// around in shared memory -- the structural NT cost matmul_nt.py exists to
// expose.  C is written in the input dtype.  Two kernels; the wrappers
// (kernels/common.py::f32_plans, matmul_nt.py, matmul_nn.py) pick one per
// call from dtype, shape and alignment, before the launch:
//
// gemm_f32 -- f32, k % 4 == 0, NN's n % 4 == 0, 16-byte aligned operands.
//   Exact FFMA: the port keeps TF32 off, as cuBLAS's f32 GEMM runs too, so
//   the bound is the card's 67 TFLOP/s of f32 FMA where the product is
//   large, and the bytes of the long operand where one side is short
//   (decode, the MoE routers).  One template, three tiles:
//     tiled        128 x 128, 256 threads, an 8 x 8 register micro-tile
//                  (m > 16 and n > 64);
//     skinny rows  16 x 128, 128 threads, 4 x 4 (m <= 16: B streamed once);
//     skinny cols  128 x 16, 128 threads, 4 x 4 (n <= 64: A streamed once).
//   16-deep k-steps: each thread carries its share of the next step's A
//   and B tiles in float4 registers while it runs this step's FFMAs, then
//   stores them into the other of two k-major shared tiles (A's rows, and
//   NT's B rows, turned around on the way; NN's B rows stored as they
//   are); the micro-tile reads them as float4, a thread's rows and columns
//   in two groups half a tile apart when it holds 8 (no bank conflict).
//   Where the tiles cannot fill the card, k splits over gridDim.z: each
//   split writes f32 partials into a workspace the wrapper allocates, and
//   repro::splitk_reduce adds them in split order, so two calls give the
//   same bits.  The wrapper's cost model (waves of blocks over the SMs,
//   plus the partials' bytes) picks the split.  nvcc -Xptxas -v (CUDA
//   12.8, sm_90a): the tiled instances take the 128 registers two blocks
//   an SM allow (NN spills 24 bytes, NT none); the skinny ones 89-101, no
//   spill.
//
// matmul_kernel -- FMA, the port's first GEMM kernel: unaligned or
//   ragged-width f32 operands, and bf16 operands the bf16 kernels do not
//   take.  One block of 256 threads per (BM x 64) output tile, a loop over
//   k in steps of 32 inside the block (the Pallas sequential k grid axis),
//   both operand tiles staged in shared memory as f32, and FMA
//   accumulation in f32 registers.  BM is 16 when m <= 16, otherwise 64.
//   Ragged edges load zeros and are masked on the store: no padded copies.
//   It is also the kernel gemm_f32 replaced (f32 within 1e-5*sqrt(k) of
//   the reference, as gemm_f32 is).
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16; thread (ty, tx)

template <typename T, int BM, bool kBStoredNK>
__global__ void __launch_bounds__(kThreads)
    matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ c, int m, int n, int k) {
  constexpr int kTM = BM / 16;   // output rows per thread
  constexpr int kTN = kBN / 16;  // output columns per thread
  // k-major tiles: the inner product loop reads one row of each.  The +1
  // column keeps the transposing stores free of bank conflicts.
  __shared__ float a_s[kBK][BM + 1];
  __shared__ float b_s[kBK][kBN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * kBN;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // A tile: a warp reads 32 consecutive k of one row (coalesced).
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int i = e / kBK, kk = e % kBK;
      const int gm = m0 + i, gk = k0 + kk;
      a_s[kk][i] = (gm < m && gk < k)
                       ? repro::to_float(a[static_cast<size_t>(gm) * k + gk])
                       : 0.f;
    }
    // B tile, stored (n, k) for NT: read along k, turned around in shared
    // memory; stored (k, n) for NN: read along n, stored as it is.
    for (int e = tid; e < kBN * kBK; e += kThreads) {
      int j, kk;
      if (kBStoredNK) {
        j = e / kBK;
        kk = e % kBK;
      } else {
        kk = e / kBN;
        j = e % kBN;
      }
      const int gn = n0 + j, gk = k0 + kk;
      float v = 0.f;
      if (gn < n && gk < k) {
        const size_t idx = kBStoredNK ? static_cast<size_t>(gn) * k + gk
                                      : static_cast<size_t>(gk) * n + gn;
        v = repro::to_float(b[idx]);
      }
      b_s[kk][j] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < m && gn < n) {
        c[static_cast<size_t>(gm) * n + gn] = repro::from_float<T>(acc[i][j]);
      }
    }
  }
}

// The 16-row tile for m <= 16, else the 64-row one, on the declared grid.
template <typename T, bool kBStoredNK>
void launch(const void* a, const void* b, void* c, int m, int n, int k, dim3 grid,
            cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (m <= 16) {
    matmul_kernel<T, 16, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  } else {
    matmul_kernel<T, 64, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  }
}

// -- gemm_f32: f32 register micro-tiles ---------------------------------------------

constexpr int kFBK = 16;  // k per step; also the unit of a split

// A (BM x BN) output tile of (BM / TM) x (BN / TN) threads, each a TM x TN
// micro-tile (TM, TN 4 or 8).
template <int BM, int BN, int TM, int TN>
struct F32Tile {
  static constexpr int kThreads = (BM / TM) * (BN / TN);
  static constexpr int kPitchA = BM + 4;  // floats per shared k-row: float4 aligned
  static constexpr int kPitchB = BN + 4;
  static constexpr int kAChunks = BM * kFBK / 4;  // float4 of a step's A tile
  static constexpr int kBChunks = BN * kFBK / 4;
  static constexpr int kAPer = (kAChunks + kThreads - 1) / kThreads;  // per thread
  static constexpr int kBPer = (kBChunks + kThreads - 1) / kThreads;
  static constexpr int kMinBlocks = kThreads == 256 ? 2 : 4;
};

// The offset in its tile of a thread's element i of T (4 or 8) along an
// extent of E, for the thread's place t: one group of 4 at 4 t, or two
// groups, 4 t and E / 2 + 4 t.
template <int T, int E>
__device__ __forceinline__ int micro_offset(int t, int i) {
  return (i / 4) * (E / (T / 4)) + 4 * t + i % 4;
}

// Block (x, y, z): n-tile x, m-tile y, split z.  ws == nullptr: write C;
// else this split's partials to ws[z] (m x n).  Split z walks k-steps
// [z per, z per + per).
template <int BM, int BN, int TM, int TN, bool kBStoredNK>
__global__ void __launch_bounds__(F32Tile<BM, BN, TM, TN>::kThreads,
                                  F32Tile<BM, BN, TM, TN>::kMinBlocks)
    gemm_f32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
             float* __restrict__ ws, int m, int n, int k, int per) {
  using Cfg = F32Tile<BM, BN, TM, TN>;
  constexpr int kThreads = Cfg::kThreads;
  __shared__ __align__(16) float a_s[2][kFBK][Cfg::kPitchA];
  __shared__ __align__(16) float b_s[2][kFBK][Cfg::kPitchB];

  const int tid = threadIdx.x;
  const int tn = tid % (BN / TN), tm = tid / (BN / TN);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nks = (k + kFBK - 1) / kFBK;
  const int ks0 = blockIdx.z * per;
  const int ks1 = min(nks, ks0 + per);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // A's rows (and NT's B rows) 4 k at a time, turned around into the
  // k-major tile; NN's B rows 4 columns at a time, stored as they are.
  // k % 4 == 0 and NN's n % 4 == 0: a float4 is all in or all out.
  float4 ra[Cfg::kAPer], rb[Cfg::kBPer];
  auto fetch = [&](int kt) {
    const int k0 = kt * kFBK;
#pragma unroll
    for (int i = 0; i < Cfg::kAPer; ++i) {
      const int ch = tid + kThreads * i;
      const int r = ch / 4, gk = k0 + (ch % 4) * 4;
      ra[i] = (ch < Cfg::kAChunks && m0 + r < m && gk < k)
                  ? __ldg(reinterpret_cast<const float4*>(a + static_cast<size_t>(m0 + r) * k + gk))
                  : zero;
    }
#pragma unroll
    for (int i = 0; i < Cfg::kBPer; ++i) {
      const int ch = tid + kThreads * i;
      if (kBStoredNK) {
        const int r = ch / 4, gk = k0 + (ch % 4) * 4;
        rb[i] = (ch < Cfg::kBChunks && n0 + r < n && gk < k)
                    ? __ldg(reinterpret_cast<const float4*>(b + static_cast<size_t>(n0 + r) * k + gk))
                    : zero;
      } else {
        const int kr = ch / (BN / 4), nc = (ch % (BN / 4)) * 4;
        rb[i] = (ch < Cfg::kBChunks && k0 + kr < k && n0 + nc < n)
                    ? __ldg(reinterpret_cast<const float4*>(b + static_cast<size_t>(k0 + kr) * n +
                                                            n0 + nc))
                    : zero;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < Cfg::kAPer; ++i) {
      const int ch = tid + kThreads * i;
      if (ch < Cfg::kAChunks) {
        const int r = ch / 4, kc = (ch % 4) * 4;
        a_s[buf][kc][r] = ra[i].x;
        a_s[buf][kc + 1][r] = ra[i].y;
        a_s[buf][kc + 2][r] = ra[i].z;
        a_s[buf][kc + 3][r] = ra[i].w;
      }
    }
#pragma unroll
    for (int i = 0; i < Cfg::kBPer; ++i) {
      const int ch = tid + kThreads * i;
      if (ch < Cfg::kBChunks) {
        if (kBStoredNK) {
          const int r = ch / 4, kc = (ch % 4) * 4;
          b_s[buf][kc][r] = rb[i].x;
          b_s[buf][kc + 1][r] = rb[i].y;
          b_s[buf][kc + 2][r] = rb[i].z;
          b_s[buf][kc + 3][r] = rb[i].w;
        } else {
          *reinterpret_cast<float4*>(&b_s[buf][ch / (BN / 4)][(ch % (BN / 4)) * 4]) = rb[i];
        }
      }
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  if (ks0 < ks1) {
    fetch(ks0);
    stash(0);
  }
  __syncthreads();
  for (int kt = ks0; kt < ks1; ++kt) {
    const int buf = (kt - ks0) & 1;
    if (kt + 1 < ks1) fetch(kt + 1);  // in flight during this step's FFMAs
#pragma unroll
    for (int kk = 0; kk < kFBK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(&a_s[buf][kk][micro_offset<TM, BM>(tm, 4 * q)]);
        av[4 * q] = x.x;
        av[4 * q + 1] = x.y;
        av[4 * q + 2] = x.z;
        av[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int q = 0; q < TN / 4; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(&b_s[buf][kk][micro_offset<TN, BN>(tn, 4 * q)]);
        bv[4 * q] = x.x;
        bv[4 * q + 1] = x.y;
        bv[4 * q + 2] = x.z;
        bv[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    // the other buffer was last read in the step before, behind its barrier
    if (kt + 1 < ks1) stash(buf ^ 1);
    __syncthreads();
  }

  float* out = ws != nullptr ? ws + static_cast<size_t>(blockIdx.z) * m * n : c;
  const bool vec = n % 4 == 0;  // then a group's 4 columns are all in or all out
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + micro_offset<TM, BM>(tm, i);
    if (row >= m) continue;
#pragma unroll
    for (int q = 0; q < TN / 4; ++q) {
      const int col = n0 + micro_offset<TN, BN>(tn, 4 * q);
      if (col >= n) continue;
      float* dst = out + static_cast<size_t>(row) * n + col;
      if (vec) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                                      acc[i][4 * q + 2], acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j < n) dst[j] = acc[i][4 * q + j];
        }
      }
    }
  }
}

template <int BM, int BN, int TM, int TN, bool kBStoredNK>
cudaError_t launch_f32(const float* a, const float* b, float* c, float* ws, int m, int n, int k,
                       int splits, int per, dim3 grid, int reduce_programs, cudaStream_t s) {
  gemm_f32<BM, BN, TM, TN, kBStoredNK><<<grid, F32Tile<BM, BN, TM, TN>::kThreads, 0, s>>>(
      a, b, c, splits > 1 ? ws : nullptr, m, n, k, per);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return repro::launch_splitk_reduce<float>(ws, c, static_cast<size_t>(m) * n, splits,
                                            reduce_programs, s);
}

template <bool kBStoredNK>
cudaError_t launch_f32_tile(const float* a, const float* b, float* c, float* ws, int m, int n,
                            int k, int bm, int bn, int splits, int per, dim3 grid,
                            int reduce_programs, cudaStream_t s) {
  if (bm == 128 && bn == 128) {
    return launch_f32<128, 128, 8, 8, kBStoredNK>(a, b, c, ws, m, n, k, splits, per, grid,
                                                  reduce_programs, s);
  }
  if (bm == 16 && bn == 128) {
    return launch_f32<16, 128, 4, 4, kBStoredNK>(a, b, c, ws, m, n, k, splits, per, grid,
                                                 reduce_programs, s);
  }
  if (bm == 128 && bn == 16) {
    return launch_f32<128, 16, 4, 4, kBStoredNK>(a, b, c, ws, m, n, k, splits, per, grid,
                                                 reduce_programs, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// b_stored_nk = 1: NT (B is (n, k)); 0: NN (B is (k, n)).  Grid (gx, gy,
// gz): the wrapper's spec (kernels/common.py::fma_grid_spec), block (x, y)
// at n-tile x, m-tile y.
REPRO_EXPORT int repro_matmul(const void* a, const void* b, void* c, int m,
                              int n, int k, int b_stored_nk, int dtype, int gx, int gy,
                              int gz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (!repro::declared_grid(gx, gy, gz, grid)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == repro::kF32) {
    if (b_stored_nk) {
      launch<float, true>(a, b, c, m, n, k, grid, s);
    } else {
      launch<float, false>(a, b, c, m, n, k, grid, s);
    }
  } else if (dtype == repro::kBF16) {
    if (b_stored_nk) {
      launch<__nv_bfloat16, true>(a, b, c, m, n, k, grid, s);
    } else {
      launch<__nv_bfloat16, false>(a, b, c, m, n, k, grid, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// f32, k % 4 == 0 (and n % 4 == 0 for NN), a, b, c and ws 16-byte aligned
// (the wrapper checks); (bm, bn) one of the three tiles; k-steps of 16 in
// `splits` runs of `per`, none empty; splits > 1: ws holds splits x m x n
// f32 (allocated by the caller) and a second kernel sums them into c.
// Grid (gx, gy, gz): the wrapper's spec (kernels/common.py::
// f32_grid_specs), block (x, y, z) at n-tile x, m-tile y, split z;
// reduce_programs: the blocks of the split's reduce.
REPRO_EXPORT int repro_matmul_f32(const void* a, const void* b, void* c, void* ws, int m, int n,
                                  int k, int b_stored_nk, int bm, int bn, int splits, int per,
                                  int gx, int gy, int gz, int reduce_programs, void* stream) {
  const int nks = (k + kFBK - 1) / kFBK;
  dim3 grid;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(ws)) % 16 != 0 ||
      m < 1 || n < 1 || k < 1 || bm < 1 || bn < 1 || k % 4 != 0 || (!b_stored_nk && n % 4 != 0) || splits < 1 ||
      per < 1 || splits > 65535 || static_cast<long long>(splits) * per < nks ||
      static_cast<long long>(splits - 1) * per >= nks || (splits > 1 && ws == nullptr) ||
      !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* cp = static_cast<float*>(c);
  auto* wp = static_cast<float*>(ws);
  return static_cast<int>(
      b_stored_nk ? launch_f32_tile<true>(ap, bp, cp, wp, m, n, k, bm, bn, splits, per, grid,
                                          reduce_programs, s)
                  : launch_f32_tile<false>(ap, bp, cp, wp, m, n, k, bm, bn, splits, per, grid,
                                           reduce_programs, s));
}
