// Batched GEMM with an f32 accumulator, in two operand layouts:
//
//   BNT  C_i = A_i @ B_i^T   A:(g, m, k)  B:(g, n, k)
//   BNN  C_i = A_i @ B_i     A:(g, m, k)  B:(g, k, n)
//
// Replaces src/repro/kernels/matmul_batched.py:124 (_matmul_batched, behind
// matmul_bnt :142 and matmul_bnn :154).  These are the attention
// contractions: the unfused plan's logits (BNT, f32) and probs @ V (BNN, in
// the model's dtype), and the attention backward's recomputed logits, dP
// (BNT), dQ, dK and dV (BNN), all in f32.  C is written in the input dtype.
//
// The Pallas kernel grows one leading parallel batch axis over the unbatched
// (i, j, k) grid, k sequential; here blockIdx.z is the batch slice (and the
// split of k) and the loop over k runs inside the block.  Three kernels,
// picked by the wrapper (kernels/matmul_batched.py::batched_plans) before
// the launch:
//
//   tiled (f32; k % 4 == 0, BNN's n % 4 == 0, 16-byte aligned operands).
//   The training backward at g 24 (batch 8 x 3 kv heads), m 256 or 768, n
//   64 or 256, k 64-768: bound by operations at the f32 FMA rate (the port
//   keeps TF32 off, so exact FFMA, as cuBLAS runs them too).  64 x 64 tiles
//   of 128 threads, each thread an 8 x 4 register micro-tile fed by float4
//   reads of k-major shared tiles (A's and BNT's B's rows are turned around
//   on the way in; BNN's B is stored k-major already); 16-deep k steps,
//   double-buffered through registers so the next step's global loads fly
//   during this step's FMAs.  n = 64 gives few tiles (dK, dV: 4 x 24 = 96
//   for 132 SMs), so k splits over gridDim.z up to three blocks per SM:
//   each split writes f32 partials into a workspace the wrapper allocates,
//   and splitk_reduce (csrc/common.cuh) adds them in split order
//   (deterministic).
//
//   mma (bf16; k % 8 == 0, BNN's n % 8 == 0, 16-byte aligned operands).
//   The unfused forward's probs @ V under the TNN policy.
//   mma.sync.m16n8k16 with f32 accumulation on 64 x 64 tiles of 4 warps
//   (32 x 32 each), operands through a 3-stage cp.async ring, 64 k a stage.
//   BNT's B (n, k) is the column-major mma operand as stored (ldmatrix);
//   BNN's B (k, n) is stored as it is and read with ldmatrix.trans.  The
//   epilogue stages the tile in shared memory and writes 16-byte chunks.
//
//   fma (any other dtype-shape-alignment, and the kernel the two replaced,
//   kept for comparison): one block of 256 threads per (BM x 64) output
//   tile, k in steps of 32, both operand tiles staged in shared memory as
//   f32, FMA into f32 registers; BM is 16 when m <= 16 and 64 otherwise.
//
// Ragged edges load zeros and are masked on the store in all three.
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

// The 16-row tile for m <= 16, else the 64-row one, on the declared grid.
template <typename T, bool kBStoredNK>
void launch(const void* a, const void* b, void* c, int m, int n, int k, dim3 grid,
            cudaStream_t s) {
  const T* ap = static_cast<const T*>(a);
  const T* bp = static_cast<const T*>(b);
  T* cp = static_cast<T*>(c);
  if (m <= 16) {
    batched_kernel<T, 16, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  } else {
    batched_kernel<T, 64, kBStoredNK><<<grid, kThreads, 0, s>>>(ap, bp, cp, m, n, k);
  }
}

// -- tiled: f32, register micro-tiles ------------------------------------------------

constexpr int kTBM = 64;
constexpr int kTBN = 64;
constexpr int kTBK = 16;             // k per step; also the unit of a split
constexpr int kTThreads = 128;       // 8 x 16; thread (ty, tx)
constexpr int kTPitch = kTBN + 4;    // floats per shared k-row: float4 aligned

// Block (x, y, z): n-tile x, m-tile y, slice z / splits, split z % splits.
// ws == nullptr: write C; else write this split's partials to
// ws[split][slice] (m x n each).
template <bool kBStoredNK>
__global__ void __launch_bounds__(kTThreads)
    bmm_f32(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ c,
            float* __restrict__ ws, int g, int m, int n, int k, int splits, int ks_per_split) {
  __shared__ __align__(16) float a_s[2][kTBK][kTPitch];
  __shared__ __align__(16) float b_s[2][kTBK][kTPitch];

  const int slice = blockIdx.z / splits, sp = blockIdx.z % splits;
  a += static_cast<size_t>(slice) * m * k;
  b += static_cast<size_t>(slice) * n * k;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // columns 4 tx .. 4 tx + 3
  const int ty = tid / 16;  // rows 8 ty .. 8 ty + 7
  const int m0 = blockIdx.y * kTBM;
  const int n0 = blockIdx.x * kTBN;
  const int nks = (k + kTBK - 1) / kTBK;
  const int ks0 = sp * ks_per_split;
  const int ks1 = min(nks, ks0 + ks_per_split);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  // Each thread carries two float4 of each operand from global memory to
  // shared: A's (and BNT's B's) rows 4 k at a time, turned around into the
  // k-major tile; BNN's B rows 4 columns at a time, stored as they are.
  float4 ra[2], rb[2];
  auto fetch = [&](int kt) {
    const int k0 = kt * kTBK;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = tid + kTThreads * i;
      const int r = ch / 4, kc = (ch % 4) * 4;
      const int gk = k0 + kc;  // k % 4 == 0: a float4 is all in or all out
      ra[i] = (m0 + r < m && gk < k)
                  ? *reinterpret_cast<const float4*>(a + static_cast<size_t>(m0 + r) * k + gk)
                  : zero;
      if (kBStoredNK) {
        rb[i] = (n0 + r < n && gk < k)
                    ? *reinterpret_cast<const float4*>(b + static_cast<size_t>(n0 + r) * k + gk)
                    : zero;
      } else {
        const int kr = ch / 16, nc = (ch % 16) * 4;  // n % 4 == 0
        const float* src = b + static_cast<size_t>(k0 + kr) * n + n0 + nc;
        rb[i] = (k0 + kr < k && n0 + nc < n) ? *reinterpret_cast<const float4*>(src) : zero;
      }
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ch = tid + kTThreads * i;
      const int r = ch / 4, kc = (ch % 4) * 4;
      a_s[buf][kc][r] = ra[i].x;
      a_s[buf][kc + 1][r] = ra[i].y;
      a_s[buf][kc + 2][r] = ra[i].z;
      a_s[buf][kc + 3][r] = ra[i].w;
      if (kBStoredNK) {
        b_s[buf][kc][r] = rb[i].x;
        b_s[buf][kc + 1][r] = rb[i].y;
        b_s[buf][kc + 2][r] = rb[i].z;
        b_s[buf][kc + 3][r] = rb[i].w;
      } else {
        *reinterpret_cast<float4*>(&b_s[buf][ch / 16][(ch % 16) * 4]) = rb[i];
      }
    }
  };

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  if (ks0 < ks1) {
    fetch(ks0);
    stash(0);
  }
  __syncthreads();
  for (int kt = ks0; kt < ks1; ++kt) {
    const int buf = (kt - ks0) & 1;
    if (kt + 1 < ks1) fetch(kt + 1);  // in flight during this step's FMAs
#pragma unroll
    for (int kk = 0; kk < kTBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[buf][kk][ty * 8 + 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][kk][tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    // the other buffer was last read in the step before, behind its barrier
    if (kt + 1 < ks1) stash(buf ^ 1);
    __syncthreads();
  }

  float* out = ws != nullptr
                   ? ws + (static_cast<size_t>(sp) * g + slice) * m * static_cast<size_t>(n)
                   : c + static_cast<size_t>(slice) * m * n;
  const bool vec = (n % 4 == 0);  // then a row's 4 columns are all in or all out
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    const int col = n0 + tx * 4;
    if (row >= m || col >= n) continue;
    float* dst = out + static_cast<size_t>(row) * n + col;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (col + j < n) dst[j] = acc[i][j];
      }
    }
  }
}

// -- mma: bf16 tensor cores ----------------------------------------------------------

constexpr int kMBM = 64;
constexpr int kMBN = 64;
constexpr int kMBK = 64;
constexpr int kMThreads = 128;    // 4 warps, 2 x 2 over the tile
constexpr int kMStages = 3;       // 54 KB: four blocks fit an SM
constexpr int kMLd = kMBK + 8;    // bf16 per K-major shared row: 144 bytes
constexpr int kMNLd = kMBN + 8;   // bf16 per shared k-row of BNN's B: 144 bytes

template <bool kBStoredNK>
struct MmaCfg {
  static constexpr int kAElems = kMBM * kMLd;
  static constexpr int kBElems = kBStoredNK ? kMBN * kMLd : kMBK * kMNLd;
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr int kSmem = kMStages * kStageElems * 2;
};

template <bool kBStoredNK>
__global__ void __launch_bounds__(kMThreads)
    bmm_bf16(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
             __nv_bfloat16* __restrict__ c, int m, int n, int k) {
  using Cfg = MmaCfg<kBStoredNK>;
  static_assert(kMBM * kMNLd <= kMStages * Cfg::kStageElems, "the epilogue tile fits the ring");
  extern __shared__ __align__(16) __nv_bfloat16 bmm_smem[];

  const size_t z = blockIdx.z;
  a += z * m * static_cast<size_t>(k);
  b += z * n * static_cast<size_t>(k);
  c += z * m * static_cast<size_t>(n);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;  // the warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;
  const int m0 = blockIdx.y * kMBM;
  const int n0 = blockIdx.x * kMBN;
  const int nkb = (k + kMBK - 1) / kMBK;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  // 16-byte chunks, zeros outside (k % 8 == 0 and BNN's n % 8 == 0: a
  // chunk is all in or all out)
  auto load_stage = [&](int slot, int kb) {
    __nv_bfloat16* as = bmm_smem + slot * Cfg::kStageElems;
    __nv_bfloat16* bs = as + Cfg::kAElems;
    const int k0 = kb * kMBK;
    for (int ch = threadIdx.x; ch < kMBM * (kMBK / 8); ch += kMThreads) {
      const int r = ch / (kMBK / 8), kc = (ch % (kMBK / 8)) * 8;
      const bool in = m0 + r < m && k0 + kc < k;
      repro::cp_async16(repro::smem_addr(as + r * kMLd + kc),
                        in ? a + static_cast<size_t>(m0 + r) * k + k0 + kc : a, in);
    }
    if (kBStoredNK) {
      for (int ch = threadIdx.x; ch < kMBN * (kMBK / 8); ch += kMThreads) {
        const int r = ch / (kMBK / 8), kc = (ch % (kMBK / 8)) * 8;
        const bool in = n0 + r < n && k0 + kc < k;
        repro::cp_async16(repro::smem_addr(bs + r * kMLd + kc),
                          in ? b + static_cast<size_t>(n0 + r) * k + k0 + kc : b, in);
      }
    } else {
      for (int ch = threadIdx.x; ch < kMBK * (kMBN / 8); ch += kMThreads) {
        const int r = ch / (kMBN / 8), nc = (ch % (kMBN / 8)) * 8;
        const bool in = k0 + r < k && n0 + nc < n;
        repro::cp_async16(repro::smem_addr(bs + r * kMNLd + nc),
                          in ? b + static_cast<size_t>(k0 + r) * n + n0 + nc : b, in);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < kMStages - 1; ++s) {
    if (s < nkb) load_stage(s, s);
    repro::cp_async_commit();
  }
  for (int i = 0; i < nkb; ++i) {
    repro::cp_async_wait<kMStages - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();                       // ... everyone's; and slot (i - 1) is free
    if (i + kMStages - 1 < nkb) load_stage((i + kMStages - 1) % kMStages, i + kMStages - 1);
    repro::cp_async_commit();
    const __nv_bfloat16* as = bmm_smem + (i % kMStages) * Cfg::kStageElems;
    const __nv_bfloat16* bs = as + Cfg::kAElems;
#pragma unroll
    for (int ks = 0; ks < kMBK; ks += 16) {
      // A fragments, two m16 x k16 tiles: lanes 0-15 give rows 0-15 at k
      // 0-7, lanes 16-31 the same rows at k 8-15.
      uint32_t af[2][4];
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
        repro::ldmatrix_x4(af[i2], as + (wm + i2 * 16 + lane % 16) * kMLd + ks + (lane / 16) * 8);
      }
      // B fragments, one x4 for two n8 tiles: matrix q = lane/8 holds
      // columns +8*(q/2) at k +8*(q%2), i.e. b0, b1 of tile 2j, then of 2j+1.
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        if (kBStoredNK) {  // B's stored rows: columns of the col-major operand
          repro::ldmatrix_x4(r, bs + (wn + j * 16 + lane % 8 + (lane / 16) * 8) * kMLd + ks +
                                    ((lane / 8) % 2) * 8);
        } else {  // B's k-rows, transposed on the way
          repro::ldmatrix_x4_trans(r, bs + (ks + ((lane / 8) % 2) * 8 + lane % 8) * kMNLd + wn +
                                          j * 16 + (lane / 16) * 8);
        }
        bf[2 * j][0] = r[0];
        bf[2 * j][1] = r[1];
        bf[2 * j + 1][0] = r[2];
        bf[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i2 = 0; i2 < 2; ++i2) {
#pragma unroll
        for (int j = 0; j < 4; ++j) repro::mma_bf16(acc[i2][j], af[i2], bf[j][0], bf[j][1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  // Epilogue through shared memory: the m16n8 accumulators (row lane/4,
  // columns 2*(lane%4) + {0, 1}, and the same columns 8 rows down) go in
  // as bf16 pairs into a 64 x 64 tile with rows padded to 144 bytes, then
  // out as 16-byte row chunks (scalar stores where n % 8 != 0).
  __syncthreads();  // every warp is done with the ring, which the tile reuses
  __nv_bfloat16* tile = bmm_smem;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm + i * 16 + lane / 4, col = wn + j * 8 + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(&tile[row * kMNLd + col]) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(&tile[(row + 8) * kMNLd + col]) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  }
  __syncthreads();
  const bool vec = (n % 8 == 0);  // then a chunk is all in or all out, and aligned
  for (int ch = threadIdx.x; ch < kMBM * (kMBN / 8); ch += kMThreads) {
    const int r = ch / (kMBN / 8), cc = (ch % (kMBN / 8)) * 8;
    const int gr = m0 + r, gc = n0 + cc;
    if (gr >= m || gc >= n) continue;
    const __nv_bfloat16* src = &tile[r * kMNLd + cc];
    __nv_bfloat16* dst = c + static_cast<size_t>(gr) * n + gc;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (gc + e < n) dst[e] = src[e];
      }
    }
  }
}

template <bool kBStoredNK>
cudaError_t launch_f32(const float* a, const float* b, float* c, float* ws, int g, int m, int n,
                       int k, int splits, int ks_per_split, dim3 grid, int reduce_programs,
                       cudaStream_t s) {
  bmm_f32<kBStoredNK><<<grid, kTThreads, 0, s>>>(a, b, c, splits > 1 ? ws : nullptr, g, m, n,
                                                  k, splits, ks_per_split);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return repro::launch_splitk_reduce(ws, c, static_cast<size_t>(g) * m * n, splits,
                                     reduce_programs, s);
}

template <bool kBStoredNK>
cudaError_t launch_bf16(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c, int m,
                        int n, int k, dim3 grid, cudaStream_t s) {
  const cudaError_t e =
      repro::allow_dynamic_smem<bmm_bf16<kBStoredNK>>(MmaCfg<kBStoredNK>::kSmem);
  if (e != cudaSuccess) return e;
  bmm_bf16<kBStoredNK><<<grid, kMThreads, MmaCfg<kBStoredNK>::kSmem, s>>>(a, b, c, m, n, k);
  return cudaGetLastError();
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// Every entry point: grid (gx, gy, gz) is the wrapper's spec
// (kernels/matmul_batched.py::batched_grid_specs), block (x, y, z) at
// n-tile x, m-tile y, slice z / splits, split z % splits.

// b_stored_nk = 1: BNT (B_i is (n, k)); 0: BNN (B_i is (k, n)).  The FMA
// kernel, for any operands of either dtype.
REPRO_EXPORT int repro_matmul_batched_fma(const void* a, const void* b, void* c,
                                      int g, int m, int n, int k,
                                      int b_stored_nk, int dtype, int gx, int gy, int gz,
                                      void* stream) {
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

// f32, k % 4 == 0, BNN's n % 4 == 0, A and B 16-byte aligned (the wrapper
// checks).  splits > 1: ws holds splits x g x m x n f32 (allocated by the
// caller) and a second kernel sums it into C; splits * ks_per_split must
// cover the cdiv(k, 16) k-steps with none empty, and g * splits <= 65535.
REPRO_EXPORT int repro_matmul_batched_f32(const void* a, const void* b, void* c, void* ws,
                                          int g, int m, int n, int k, int b_stored_nk,
                                          int splits, int ks_per_split, int gx, int gy, int gz,
                                          int reduce_programs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* cp = static_cast<float*>(c);
  auto* wp = static_cast<float*>(ws);
  dim3 grid;
  if (splits < 1 || ks_per_split < 1 || (splits > 1 && wp == nullptr) ||
      !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(
      b_stored_nk ? launch_f32<true>(ap, bp, cp, wp, g, m, n, k, splits, ks_per_split, grid,
                                     reduce_programs, s)
                  : launch_f32<false>(ap, bp, cp, wp, g, m, n, k, splits, ks_per_split, grid,
                                      reduce_programs, s));
}

// bf16, k % 8 == 0, BNN's n % 8 == 0, A and B 16-byte aligned (the wrapper
// checks).
REPRO_EXPORT int repro_matmul_batched_bf16(const void* a, const void* b, void* c, int g, int m,
                                           int n, int k, int b_stored_nk, int gx, int gy,
                                           int gz, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* cp = static_cast<__nv_bfloat16*>(c);
  dim3 grid;
  if (!repro::declared_grid(gx, gy, gz, grid)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(b_stored_nk ? launch_bf16<true>(ap, bp, cp, m, n, k, grid, s)
                                      : launch_bf16<false>(ap, bp, cp, m, n, k, grid, s));
}
