// Batched GEMM with an f32 accumulator, in two operand layouts:
//
//   BNT  C_i = A_i @ B_i^T   A:(g, m, k)  B:(g, n, k)
//   BNN  C_i = A_i @ B_i     A:(g, m, k)  B:(g, k, n)
//
// Replaces src/repro/kernels/matmul_batched.py:124 (_matmul_batched, behind
// matmul_bnt :142 and matmul_bnn :154).  These are the attention
// contractions: the unfused plan's logits (BNT) and probs @ V (BNN), and the
// attention backward's recomputed logits, dP (BNT), dQ, dK and dV (BNN).
// C is written in the input dtype.
//
// The Pallas kernel grows one leading parallel batch axis over the unbatched
// (i, j, k) grid, k sequential; here blockIdx.z is the batch slice and the
// loop over k runs inside the block.  Within a slice the design is that of
// csrc/matmul.cu (kept byte-identical there): one block of 256 threads per
// (BM x 64) output tile, k in steps of 32, both operand tiles staged in
// shared memory as f32 (B stored (n, k) for BNT is read along k and turned
// around there, with a padding column against bank conflicts), FMA into f32
// registers.  BM is 16 when m <= 16 -- the unfused decode plan's slices have
// m = 3 query rows -- and 64 otherwise.  Ragged edges load zeros and are
// masked on the store.
//
// Bound on the H100: at the training shapes (g 24, m 768 or 256, n 256 or
// 64, k 64-768) operations at the f32 FMA rate for the backward's f32
// contractions; at decode (g 12, m 3, n 512, k 64) bytes.  Tensor cores for
// the bf16 instances are later work.
#include "common.cuh"

namespace {

constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;  // 16 x 16; thread (ty, tx)

template <typename T, int BM, bool kBStoredNK>
__global__ void __launch_bounds__(kThreads)
    batched_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   T* __restrict__ c, int m, int n, int k) {
  constexpr int kTM = BM / 16;   // output rows per thread
  constexpr int kTN = kBN / 16;  // output columns per thread
  __shared__ float a_s[kBK][BM + 1];
  __shared__ float b_s[kBK][kBN + 1];

  const size_t z = blockIdx.z;
  a += z * m * static_cast<size_t>(k);
  b += z * n * static_cast<size_t>(k);
  c += z * m * static_cast<size_t>(n);

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
    for (int e = tid; e < BM * kBK; e += kThreads) {
      const int i = e / kBK, kk = e % kBK;
      const int gm = m0 + i, gk = k0 + kk;
      a_s[kk][i] = (gm < m && gk < k)
                       ? repro::to_float(a[static_cast<size_t>(gm) * k + gk])
                       : 0.f;
    }
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
void launch(const void* a, const void* b, void* c, int g, int m, int n, int k,
            cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (m <= 16) {
    const dim3 grid(repro::cdiv(n, kBN), repro::cdiv(m, 16), g);
    batched_kernel<T, 16, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  } else {
    const dim3 grid(repro::cdiv(n, kBN), repro::cdiv(m, 64), g);
    batched_kernel<T, 64, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// b_stored_nk = 1: BNT (B_i is (n, k)); 0: BNN (B_i is (k, n)).
REPRO_EXPORT int repro_matmul_batched(const void* a, const void* b, void* c,
                                      int g, int m, int n, int k,
                                      int b_stored_nk, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    if (b_stored_nk) {
      launch<float, true>(a, b, c, g, m, n, k, s);
    } else {
      launch<float, false>(a, b, c, g, m, n, k, s);
    }
  } else if (dtype == repro::kBF16) {
    if (b_stored_nk) {
      launch<__nv_bfloat16, true>(a, b, c, g, m, n, k, s);
    } else {
      launch<__nv_bfloat16, false>(a, b, c, g, m, n, k, s);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
