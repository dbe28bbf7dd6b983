// Fused TNN GEMM: C = A @ B^T, A:(m, k), B:(n, k), C:(m, n) in the input
// dtype, f32 accumulation.  Replaces src/repro/kernels/matmul_tnn_fused.py:90.
//
// What the Pallas kernel does on the TPU: it issues the MXU dot with NT
// dimension numbers, so Mosaic stages B's stored (n, k) block into the
// matrix unit with no explicit re-orientation, and walks an n-major grid
// (j, i, k) so that one B strip stays resident while A streams.
//
// The Hopper counterpart, bf16: tensor cores through
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32.  The "col" B operand
// of that instruction is a (k x n) column-major fragment, which is exactly
// B's stored (n, k) row-major layout: both operand tiles are copied along k
// into shared memory and kept K-major, and ldmatrix (without .trans) loads
// the fragments of both from those rows.  Nothing turns B around, in shared
// memory or anywhere else; that is what separates this arm from the direct
// NT kernel (csrc/matmul.cu), which transposes each B tile in shared memory.
// f32: the same K-major tiles feed FMA (no TF32: the port's f32 bound of
// 1e-5*sqrt(k) needs full f32 products), with one padding column against
// bank conflicts.
//
// Block order: blockIdx.x walks the m-tiles and blockIdx.y the n-tiles, so
// consecutive blocks share one B strip, which stays in L2 while the A tiles
// stream past it -- the Pallas grid's (j, i, k) order.
//
// Bound on the H100: at the training shapes (m = 2048 tokens, n 192-49152,
// k 576 or 1536) operations (about 300-600 flop per byte, above the bf16
// ridge of ~295); at decode shapes (m <= 8) bytes.  This is the simple
// version: one 64x64 tile per block of 4 warps, each warp 32x32, loads and
// compute not overlapped.  cp.async pipelining, then wgmma with TMA, are
// later work.  Ragged edges load zeros and are masked on the store.
#include "common.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;  // bf16 row stride: 80 bytes, ldmatrix conflict-free
constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kFmaThreads = 256;  // 16 x 16, 4 x 4 outputs each

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

union Chunk {  // 8 bf16 = 16 bytes, one vector load; raw bits
  uint4 v;
  uint16_t h[8];
};

// Copy rows [r0, r0 + 64) x k-columns [k0, k0 + 32) of a row-major
// (rows, k) bf16 matrix into a K-major shared tile, zero-filling outside.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16 (*dst)[kLd],
                                               const __nv_bfloat16* src,
                                               int rows, int k, int r0, int k0,
                                               bool vec) {
  constexpr int kChunks = kBM * (kBK / 8);
  for (int c = threadIdx.x; c < kChunks; c += kMmaThreads) {
    const int r = c / (kBK / 8);
    const int kc = (c % (kBK / 8)) * 8;
    const int gr = r0 + r, gk = k0 + kc;
    Chunk ch;
    if (vec && gr < rows && gk < k) {  // k % 8 == 0: the whole chunk is in
      ch.v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(gr) * k + gk);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        ch.h[e] = (gr < rows && gk + e < k)
                      ? __bfloat16_as_ushort(src[static_cast<size_t>(gr) * k + gk + e])
                      : static_cast<uint16_t>(0);  // +0.0
      }
    }
    *reinterpret_cast<uint4*>(&dst[r][kc]) = ch.v;
  }
}

__global__ void __launch_bounds__(kMmaThreads)
    tnn_fused_bf16(const __nv_bfloat16* __restrict__ a,
                   const __nv_bfloat16* __restrict__ b,
                   __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  __shared__ __align__(16) __nv_bfloat16 a_s[kBM][kLd];
  __shared__ __align__(16) __nv_bfloat16 b_s[kBN][kLd];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;  // the warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const bool vec = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(b) % 16 == 0);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    load_tile_bf16(a_s, a, m, k, m0, k0, vec);
    load_tile_bf16(b_s, b, n, k, n0, k0, vec);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // A fragments, two m16 x k16 tiles: lanes 0-15 give rows 0-15 at k
      // 0-7, lanes 16-31 the same rows at k 8-15 (a0..a3 of the mma).
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldmatrix_x4(af[i], &a_s[wm + i * 16 + lane % 16][ks + (lane / 16) * 8]);
      }
      // B fragments straight from B's stored rows: one x4 covers two n8
      // tiles at k 0-7 and 8-15 (b0, b1 of each), no transpose.
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4(r, &b_s[wn + j * 16 + lane % 8 + (lane / 16) * 8]
                           [ks + ((lane / 8) % 2) * 8]);
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bf[j][0], bf[j][1]);
      }
    }
    __syncthreads();
  }

  // Accumulator layout of m16n8: (row lane/4, cols 2*(lane%4) + {0,1}) and
  // the same columns 8 rows further down.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = m0 + wm + i * 16 + lane / 4;
      const int col = n0 + wn + j * 8 + (lane % 4) * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + (e / 2) * 8, cc = col + e % 2;
        if (r < m && cc < n) {
          c[static_cast<size_t>(r) * n + cc] = __float2bfloat16(acc[i][j][e]);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kFmaThreads)
    tnn_fused_f32(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ c, int m, int n, int k) {
  // K-major tiles as B is stored; the +1 column keeps the reads of 16
  // different rows at one k in 16 different banks.
  __shared__ float a_s[kBM][kBK + 1];
  __shared__ float b_s[kBN][kBK + 1];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    // a warp reads 32 consecutive k of one row of each operand (coalesced)
    for (int e = tid; e < kBM * kBK; e += kFmaThreads) {
      const int r = e / kBK, kk = e % kBK;
      const int gk = k0 + kk;
      const int gm = m0 + r, gn = n0 + r;
      a_s[r][kk] = (gm < m && gk < k) ? a[static_cast<size_t>(gm) * k + gk] : 0.f;
      b_s[r][kk] = (gn < n && gk < k) ? b[static_cast<size_t>(gn) * k + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[ty + 16 * i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[tx + 16 * j][kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gm < m && gn < n) c[static_cast<size_t>(gm) * n + gn] = acc[i][j];
    }
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT int repro_matmul_tnn_fused(const void* a, const void* b, void* c,
                                        int m, int n, int k, int dtype,
                                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(repro::cdiv(m, kBM), repro::cdiv(n, kBN));
  if (dtype == repro::kBF16) {
    tnn_fused_bf16<<<grid, kMmaThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<__nv_bfloat16*>(c), m, n, k);
  } else if (dtype == repro::kF32) {
    tnn_fused_f32<<<grid, kFmaThreads, 0, s>>>(static_cast<const float*>(a),
                                               static_cast<const float*>(b),
                                               static_cast<float*>(c), m, n, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
