// Fused TNN GEMM: C = A @ B^T, A:(m, k), B:(n, k), C:(m, n) in the input
// dtype, f32 accumulation.  Replaces src/repro/kernels/matmul_tnn_fused.py:90.
//
// What the Pallas kernel does on the TPU: it issues the MXU dot with NT
// dimension numbers, so Mosaic stages B's stored (n, k) block into the
// matrix unit with no explicit re-orientation, and walks an n-major grid
// (j, i, k) so that one B strip stays resident while A streams.
//
// The regime: the training forward, m = 2048 tokens, n 192-49152, k 576 or
// 1536 -- bound by operations (300-600 flop per byte, above the bf16 ridge
// of ~295).  This is the wide arm of the two NT kernels; the direct NT
// kernel (csrc/matmul_nt.cu) is the skinny, streaming, split-k one.  On
// Hopper's tensor cores neither turns B around: B's stored rows are the
// K-major operand both instructions want.
//
// Four variants, picked by the wrapper (kernels/matmul_tnn_fused.py)
// before the launch, from dtype, shape and alignment:
//
//   wgmma (bf16, k % 8 == 0, A and B 16-byte aligned).  A persistent grid
//   of at most one CTA per SM walks the output tiles n-major (consecutive
//   tiles share one B strip, which stays in L2 while A streams).  CTA tile
//   128 x BN x 64, BN one of 64, 96, 192, 256: the wrapper picks the width
//   whose waves of tiles cost least.  A producer warpgroup's one thread issues TMA
//   loads (cp.async.bulk.tensor.2d, 128-byte swizzle, zero fill outside
//   the matrix) of both operands, K-major, into a 3-4 stage shared-memory
//   ring guarded by full/empty mbarriers; two consumer warpgroups, 64 rows
//   each, run wgmma.mma_async m64nBNk16 with both operands as
//   shared-memory descriptors and hand each stage back as soon as its
//   products are done (keeping one group of products in flight measured
//   no faster: the other warpgroup's products fill the gap).  The epilogue stages each warpgroup's 64 x BN tile
//   in padded shared memory and writes C with coalesced 16-byte stores,
//   masked at the ragged edges.  The tensor maps are encoded per call on
//   the host (the caching allocator reuses addresses) with
//   cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint.
//
//   mma.sync (bf16, any other shape or alignment): one 64x64 tile per
//   block of 4 warps, mma.sync.aligned.m16n8k16.row.col, whose "col" B
//   operand (k x n, column-major) is B's stored (n, k) rows; both tiles
//   are copied along k into shared memory and ldmatrix (no .trans) loads
//   the fragments.  Loads and compute are not overlapped; unaligned rows
//   take a zero-filling scalar path.
//
//   f32 (f32, k % 4 == 0, A and B 16-byte aligned): exact FFMA (no TF32:
//   the port keeps TF32 off and holds f32 to 1e-5*sqrt(k) of f64), so the
//   bound is the card's 67 TFLOP/s of f32 FMA where the product is large
//   and the bytes of the long operand where one side is short (the MoE
//   routers, decode).  Both operands are read as stored: 16-byte cp.async
//   copies of A's and B's K-contiguous rows go straight into K-major
//   shared tiles of 20-float rows (no register staging, no turned-around
//   tile; 80 bytes put 8 consecutive rows in 8 distinct 16-byte bank
//   groups), in a 3-stage ring of 16-deep k-steps, zero-filled past m, n
//   and k.  Each thread holds a TM x TN register micro-tile and reads
//   float4 runs along k of its TM A rows and, one at a time, of its TN B
//   rows; a warp's quarter reads one A row (a broadcast) and 8
//   consecutive B rows.  Three tiles (kernels/matmul_tnn_fused.py picks):
//     f32_tiled   128 x 128, 256 threads, 8 x 8 (the training forward);
//     f32_skinny  16 x 128 (m <= 16) or 128 x 16 (n <= 64), 128 threads,
//                 4 x 4 (decode, the routers: the long operand streamed once).
//   Where the tiles leave SMs idle, k splits over gridDim.z, as gemm_f32
//   does (csrc/matmul.cu, kernels/common.py::f32_split): f32 partials in a
//   workspace, summed in split order by repro::splitk_reduce, so two calls
//   give the same bits.  gemm_f32's NT instance reads the same operands
//   but turns both around in registers on the way into shared memory; it
//   measured as fast as this read as stored.  nvcc -Xptxas -v (CUDA 12.8,
//   sm_90a): 168 registers a thread for f32_tiled (one block an SM), 96
//   for f32_skinny, none spilling.
//
//   FMA (f32, unaligned or k % 4 != 0; the f32 kernel it replaced): the
//   same K-major tiles feed FMA with scalar loads, one padding column
//   against bank conflicts.
//
// The mma.sync and FMA blocks walk the m-tiles along blockIdx.x and the
// n-tiles along blockIdx.y, so consecutive blocks share one B strip; the
// f32 blocks walk the n-tiles along blockIdx.x, as gemm_f32's do.
#include "hopper.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLd = kBK + 8;  // bf16 row stride: 80 bytes, ldmatrix conflict-free
constexpr int kMmaThreads = 128;  // 4 warps, 2 x 2 over the tile
constexpr int kFmaThreads = 256;  // 16 x 16, 4 x 4 outputs each

using repro::encode_map;
using repro::fence_regs;
using repro::ldmatrix_x4;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_bf16;
using repro::named_bar;
using repro::smem_addr;
using repro::sw128_desc;
using repro::tma_load_2d;
using repro::wgmma_bf16;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_wait_all;

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

// -- the f32 variants: as-stored register micro-tiles -------------------------

constexpr int kFBK = 16;              // k per step; also the unit of a split
constexpr int kFStages = 3;           // the cp.async ring
constexpr int kFPitch = kFBK + 4;     // floats per shared row: 80 bytes

// A (BM x BN) output tile of (BM / TM) x (BN / TN) threads, each a TM x TN
// micro-tile whose rows are ty + TY i and columns tx + TX j.  A warp holds
// (32 / WX) x WX threads: the 8 lanes of a quarter-warp read at most two
// A rows (a broadcast) and WX consecutive B rows, which the 80-byte pitch
// puts in distinct 16-byte bank groups.
template <int BM, int BN, int TM, int TN>
struct TnnF32 {
  static constexpr int kTY = BM / TM, kTX = BN / TN;
  static constexpr int kThreads = kTY * kTX;
  static constexpr int kWX = kTX < 8 ? kTX : 8;
  static constexpr int kWarpsX = kTX / kWX;
  static constexpr int kStage = (BM + BN) * kFPitch;  // floats of a stage: A's rows, then B's
  static constexpr int kSmem = kFStages * kStage * 4;
  // The 128 x 128 tile holds 64 accumulators and 8 float4 of A a thread:
  // capped at 128 registers (two blocks an SM) it spilled and measured 4-6 %
  // slower than at one block an SM with 168 registers.
  static constexpr int kMinBlocks = kThreads == 256 ? 1 : 4;
  static_assert(kTY % (32 / kWX) == 0 && kTX % kWX == 0, "warp layout");
};

// Copy k-columns [k0, k0 + 16) of rows [r0, r0 + R) of a row-major (rows, k)
// f32 matrix, as stored, into R shared rows of kFPitch floats: one 16-byte
// cp.async a piece, zero-filled (never read) past `rows` and past k.
template <int R, int kThreads>
__device__ __forceinline__ void copy_rows_f32(uint32_t dst, const float* __restrict__ src,
                                              int rows, int k, int r0, int k0) {
  constexpr int kPieces = R * (kFBK / 4);
#pragma unroll
  for (int p = 0; p < (kPieces + kThreads - 1) / kThreads; ++p) {
    const int c = threadIdx.x + p * kThreads;
    if (kPieces % kThreads != 0 && c >= kPieces) break;
    const int r = c / (kFBK / 4), kc = (c % (kFBK / 4)) * 4;
    const bool in = r0 + r < rows && k0 + kc < k;  // k % 4 == 0: a piece is all in or all out
    repro::cp_async16(dst + (r * kFPitch + kc) * 4,
                      in ? src + static_cast<size_t>(r0 + r) * k + k0 + kc : src, in);
  }
}

// Block (x, y, z): n-tile x, m-tile y, split z.  ws == nullptr: write C;
// else this split's partials to ws[z] (m x n).  Split z walks k-steps
// [z per, z per + per).
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(TnnF32<BM, BN, TM, TN>::kThreads,
                                  TnnF32<BM, BN, TM, TN>::kMinBlocks)
    tnn_fused_f32_tiled(const float* __restrict__ a, const float* __restrict__ b,
                        float* __restrict__ c, float* __restrict__ ws, int m, int n, int k,
                        int per) {
  using Cfg = TnnF32<BM, BN, TM, TN>;
  extern __shared__ __align__(16) float f32_smem[];
  const uint32_t base = smem_addr(f32_smem);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = (warp % Cfg::kWarpsX) * Cfg::kWX + lane % Cfg::kWX;
  const int ty = (warp / Cfg::kWarpsX) * (32 / Cfg::kWX) + lane / Cfg::kWX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nks = (k + kFBK - 1) / kFBK;
  const int ks0 = blockIdx.z * per;
  const int ks1 = min(nks, ks0 + per);

  // Step kt into ring slot kt % kFStages; one commit group per step, empty
  // past the last, so that the wait below always counts the same groups.
  auto load_step = [&](int kt) {
    if (kt < ks1) {
      const uint32_t slot = base + (kt % kFStages) * Cfg::kStage * 4;
      copy_rows_f32<BM, Cfg::kThreads>(slot, a, m, k, m0, kt * kFBK);
      copy_rows_f32<BN, Cfg::kThreads>(slot + BM * kFPitch * 4, b, n, k, n0, kt * kFBK);
    }
    repro::cp_async_commit();
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kFStages - 1; ++s) load_step(ks0 + s);
  for (int kt = ks0; kt < ks1; ++kt) {
    repro::cp_async_wait<kFStages - 2>();  // step kt has landed (this thread's copies)
    __syncthreads();                       // everyone's; the slot of kt - 1 is free
    load_step(kt + kFStages - 1);
    const float* a_s = f32_smem + (kt % kFStages) * Cfg::kStage;
    const float* b_s = a_s + BM * kFPitch;
#pragma unroll
    for (int kk = 0; kk < kFBK; kk += 4) {
      // A's float4 runs along k for the TM rows; B's one at a time
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        av[i] = *reinterpret_cast<const float4*>(a_s + (ty + Cfg::kTY * i) * kFPitch + kk);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 bv =
            *reinterpret_cast<const float4*>(b_s + (tx + Cfg::kTX * j) * kFPitch + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          float s = acc[i][j];
          s = fmaf(av[i].x, bv.x, s);
          s = fmaf(av[i].y, bv.y, s);
          s = fmaf(av[i].z, bv.z, s);
          acc[i][j] = fmaf(av[i].w, bv.w, s);
        }
      }
    }
  }
  repro::cp_async_wait<0>();  // no copy outlives the block

  float* out = ws != nullptr ? ws + static_cast<size_t>(blockIdx.z) * m * n : c;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + Cfg::kTY * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + Cfg::kTX * j;
      if (col < n) out[static_cast<size_t>(row) * n + col] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
cudaError_t launch_f32(const float* a, const float* b, float* c, float* ws, int m, int n, int k,
                       int splits, int per, dim3 grid, int reduce_programs, cudaStream_t s) {
  using Cfg = TnnF32<BM, BN, TM, TN>;
  const cudaError_t e =
      repro::allow_dynamic_smem<tnn_fused_f32_tiled<BM, BN, TM, TN>>(Cfg::kSmem);
  if (e != cudaSuccess) return e;
  tnn_fused_f32_tiled<BM, BN, TM, TN><<<grid, Cfg::kThreads, Cfg::kSmem, s>>>(
      a, b, c, splits > 1 ? ws : nullptr, m, n, k, per);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || splits == 1) return e2;
  return repro::launch_splitk_reduce<float>(ws, c, static_cast<size_t>(m) * n, splits,
                                            reduce_programs, s);
}


// -- the wgmma variant ---------------------------------------------------------

constexpr int kWgBM = 128;        // two consumer warpgroups x 64 rows
constexpr int kWgBK = 64;         // 64 bf16 = 128 bytes, one 128-byte swizzle row
constexpr int kWgThreads = 384;   // warpgroups 0, 1 consume; warpgroup 2 loads

template <int BN>
struct WgCfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kABytes = kWgBM * kWgBK * 2;  // 16 KB
  static constexpr int kBBytes = BN * kWgBK * 2;
  static constexpr int kRing = kStages * (kABytes + kBBytes);
  // epilogue: 64 rows x BN per consumer warpgroup; 16 bytes of padding per
  // row put the 8 rows of one bf16x2 store in 8 different bank quads
  static constexpr int kEpiPitch = BN + 8;
  static constexpr int kEpiBytes = 2 * 64 * kEpiPitch * 2;
  // 1024 bytes of slack: the 128-byte swizzle wants 1024-byte aligned tiles
  static constexpr int kSmem = 1024 + kRing + kEpiBytes + 2 * kStages * 8;
};

template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    tnn_fused_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  using Cfg = WgCfg<BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;                         // S x 128 rows x 128 B
  const uint32_t b_ring = base + S * Cfg::kABytes;      // S x BN rows x 128 B
  __nv_bfloat16* epi =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw) + Cfg::kRing);
  const uint32_t full = base + Cfg::kRing + Cfg::kEpiBytes;  // S barriers of 8 B
  const uint32_t empty = full + S * 8;

  const int m_tiles = (m + kWgBM - 1) / kWgBM;
  const int tiles = m_tiles * ((n + BN - 1) / BN);
  const int nkb = (k + kWgBK - 1) / kWgBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);   // the producer's arrive + the TMA bytes
      mbar_init(empty + 8 * s, 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Tile t covers rows (t % m_tiles) * 128 and columns (t / m_tiles) * BN:
  // n-major, as the Pallas grid.  Producer and consumers walk the same list.
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = (t % m_tiles) * kWgBM, n0 = (t / m_tiles) * BN;
        for (int kb = 0; kb < nkb; ++kb) {
          mbar_wait(empty + 8 * s, phase ^ 1);  // the first pass finds it free
          mbar_expect_tx(full + 8 * s, Cfg::kABytes + Cfg::kBBytes);
          tma_load_2d(a_ring + s * Cfg::kABytes, &map_a, full + 8 * s, kb * kWgBK, m0);
          tma_load_2d(b_ring + s * Cfg::kBBytes, &map_b, full + 8 * s, kb * kWgBK, n0);
          if (++s == S) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    __nv_bfloat16* my_epi = epi + wg * 64 * Cfg::kEpiPitch;
    constexpr int kChunks = BN / 8;  // 16-byte chunks per epilogue row
    const bool vec_store = (n % 8 == 0);
    float acc[BN / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t % m_tiles) * kWgBM, n0 = (t / m_tiles) * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = 0; kb < nkb; ++kb) {
        mbar_wait(full + 8 * s, phase);
        fence_regs(acc);
        wgmma_fence();
        const uint32_t a_tile = a_ring + s * Cfg::kABytes + wg * 64 * 128;
        const uint32_t b_tile = b_ring + s * Cfg::kBBytes;
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          wgmma_bf16<0>(acc, sw128_desc(a_tile + kk * 32), sw128_desc(b_tile + kk * 32));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        if (tid == 0) mbar_arrive(empty + 8 * s);  // the slot is free for the next load
        if (++s == S) {
          s = 0;
          phase ^= 1;
        }
      }
      // epilogue: registers -> padded shared tile -> 16-byte stores
      named_bar(1 + wg);  // the previous tile's stores have read the buffer
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int row = warp * 16 + lane / 4, col = j * 8 + (lane % 4) * 2;
        *reinterpret_cast<__nv_bfloat162*>(&my_epi[row * Cfg::kEpiPitch + col]) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(&my_epi[(row + 8) * Cfg::kEpiPitch + col]) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
      named_bar(1 + wg);
      for (int idx = tid; idx < 64 * kChunks; idx += 128) {
        const int r = idx / kChunks, ch = idx % kChunks;
        const int gr = m0 + wg * 64 + r, gc = n0 + ch * 8;
        if (gr >= m || gc >= n) continue;
        const __nv_bfloat16* src = &my_epi[r * Cfg::kEpiPitch + ch * 8];
        __nv_bfloat16* dst = c + static_cast<size_t>(gr) * n + gc;
        if (vec_store) {  // n % 8 == 0: the chunk is inside and 16-byte aligned
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (gc + e < n) dst[e] = src[e];
          }
        }
      }
    }
  }
}

// `programs` persistent blocks walk the tiles: the wrapper's spec
// (kernels/matmul_tnn_fused.py::tnn_fused_grid_specs), min(tiles, SMs).
template <int BN>
cudaError_t launch_wgmma(const void* a, const void* b, void* c, int m, int n, int k,
                         int programs, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, a, m, k, kWgBM) || !encode_map(&map_b, b, n, k, BN)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t e = repro::allow_dynamic_smem<tnn_fused_wgmma<BN>>(WgCfg<BN>::kSmem);
  if (e != cudaSuccess) return e;
  tnn_fused_wgmma<BN><<<programs, kWgThreads, WgCfg<BN>::kSmem, s>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(c), m, n, k);
  return cudaGetLastError();
}
}  // namespace

REPRO_DEFINE_ERROR_STRING

// The mma.sync (bf16) and FMA (f32) variants.  Grid (gx, gy, gz): the
// wrapper's spec, block (x, y) at m-tile x, n-tile y.
REPRO_EXPORT int repro_matmul_tnn_fused(const void* a, const void* b, void* c,
                                        int m, int n, int k, int dtype, int gx, int gy,
                                        int gz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (!repro::declared_grid(gx, gy, gz, grid)) return static_cast<int>(cudaErrorInvalidValue);
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

// bf16 only; the wrapper calls it when k % 8 == 0 and A, B are 16-byte
// aligned (TMA's rule for addresses and row strides).  block_n: 64, 96, 192
// or 256; `programs` persistent blocks.
REPRO_EXPORT int repro_matmul_tnn_fused_wgmma(const void* a, const void* b, void* c, int m,
                                              int n, int k, int block_n, int programs,
                                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (!repro::declared_grid(programs, 1, 1, grid)) return static_cast<int>(cudaErrorInvalidValue);
  switch (block_n) {
    case 64: return static_cast<int>(launch_wgmma<64>(a, b, c, m, n, k, programs, s));
    case 96: return static_cast<int>(launch_wgmma<96>(a, b, c, m, n, k, programs, s));
    case 192: return static_cast<int>(launch_wgmma<192>(a, b, c, m, n, k, programs, s));
    case 256: return static_cast<int>(launch_wgmma<256>(a, b, c, m, n, k, programs, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// f32, k % 4 == 0, a, b, c and ws 16-byte aligned (the wrapper checks);
// (bm, bn) one of the three tiles; k-steps of 16 in `splits` runs of
// `per`, none empty; splits > 1: ws holds splits x m x n f32 (allocated by
// the caller) and a second kernel sums them into c in split order.  Grid
// (gx, gy, gz): the wrapper's spec, block (x, y, z) at n-tile x, m-tile y,
// split z; reduce_programs: the blocks of the split's reduce.
REPRO_EXPORT int repro_matmul_tnn_fused_f32(const void* a, const void* b, void* c, void* ws,
                                            int m, int n, int k, int bm, int bn, int splits,
                                            int per, int gx, int gy, int gz,
                                            int reduce_programs, void* stream) {
  const int nks = (k + kFBK - 1) / kFBK;
  dim3 grid;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(ws)) % 16 != 0 ||
      m < 1 || n < 1 || k < 1 || k % 4 != 0 || splits < 1 || per < 1 || splits > 65535 ||
      static_cast<long long>(splits) * per < nks ||
      static_cast<long long>(splits - 1) * per >= nks || (splits > 1 && ws == nullptr) ||
      bm < 1 || !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* cp = static_cast<float*>(c);
  auto* wp = static_cast<float*>(ws);
  if (bm == 128 && bn == 128) {
    return static_cast<int>(launch_f32<128, 128, 8, 8>(ap, bp, cp, wp, m, n, k, splits, per, grid,
                                                        reduce_programs, s));
  }
  if (bm == 16 && bn == 128) {
    return static_cast<int>(launch_f32<16, 128, 4, 4>(ap, bp, cp, wp, m, n, k, splits, per, grid,
                                                       reduce_programs, s));
  }
  if (bm == 128 && bn == 16) {
    return static_cast<int>(launch_f32<128, 16, 4, 4>(ap, bp, cp, wp, m, n, k, splits, per, grid,
                                                       reduce_programs, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
