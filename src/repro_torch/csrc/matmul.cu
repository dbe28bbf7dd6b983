// Blocked GEMM with an f32 accumulator, in two operand layouts:
//
//   NN  C = A @ B     A:(m, k)  B:(k, n)   replaces src/repro/kernels/matmul_nn.py:77
//   NT  C = A @ B^T   A:(m, k)  B:(n, k)   replaces src/repro/kernels/matmul_nt.py:81
//
// NN is stage 2 of the paper's TNN (after the transpose kernel); NT is the
// direct arm, which reads B in its stored (n, k) layout and turns each tile
// around in shared memory -- the structural NT cost matmul_nt.py exists to
// expose.  C is written in the input dtype.
//
// Bound on the H100: at the serving shapes (m = decode batch 1-8, or a short
// prompt; n up to 49152; k 576 or 1536) the kernel is bound by bytes: every
// element of B is read once and m is far below the ~295 flop/byte ridge.
// Design: one block of 256 threads per (BM x 64) output tile, a loop over k
// in steps of 32 inside the block (the Pallas sequential k grid axis), both
// operand tiles staged in shared memory as f32, and FMA accumulation in f32
// registers.  BM is 16 when m <= 16, so a decode step does not spend 48 of
// 64 tile rows on nothing; otherwise 64.  Ragged edges load zeros and are
// masked on the store: no padded copies.  This is the simple, exact version
// (f32 within 1e-5*sqrt(k) of the reference); tensor cores, wider loads and
// split-k for the many-column decode shapes are later work.
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

template <typename T, bool kBStoredNK>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (m <= 16) {
    const dim3 grid(repro::cdiv(n, kBN), repro::cdiv(m, 16));
    matmul_kernel<T, 16, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  } else {
    const dim3 grid(repro::cdiv(n, kBN), repro::cdiv(m, 64));
    matmul_kernel<T, 64, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// b_stored_nk = 1: NT (B is (n, k)); 0: NN (B is (k, n)).
REPRO_EXPORT int repro_matmul(const void* a, const void* b, void* c, int m,
                              int n, int k, int b_stored_nk, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    if (b_stored_nk) {
      launch<float, true>(a, b, c, m, n, k, s);
    } else {
      launch<float, false>(a, b, c, m, n, k, s);
    }
  } else if (dtype == repro::kBF16) {
    if (b_stored_nk) {
      launch<__nv_bfloat16, true>(a, b, c, m, n, k, s);
    } else {
      launch<__nv_bfloat16, false>(a, b, c, m, n, k, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
