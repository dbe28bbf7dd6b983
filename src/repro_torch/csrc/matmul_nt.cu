// Direct NT GEMM, bf16: C = A @ B^T, A:(m, k), B:(n, k), C:(m, n) in bf16,
// f32 accumulation.  Replaces src/repro/kernels/matmul_nt.py:81 for bf16;
// the f32 instance stays in csrc/matmul.cu.
//
// The regime: serving.  m is a decode bucket (1-4 rows) or a short prompt
// (<= 64 rows), n is a projection's width (192-49152), k 576 or 1536.
// Every element of B is read once and m is far below the bf16 ridge of
// ~295 flop per byte, so the kernel is bound by the bytes of B: the job is
// to stream B at the card's memory rate.  This is the skinny arm of the two
// NT kernels; the fused TNN kernel (csrc/matmul_tnn_fused.cu) is the wide
// one (wgmma, persistent).  On Hopper's tensor cores neither turns B
// around: B's stored rows are the K-major operand.
//
// Operand swap: the kernel computes C^T = B . A^T.  B's rows are the
// row-major m16 operand of mma.sync.aligned.m16n8k16.row.col and A's rows
// (at most 64 per block, zero-padded to 8, 16, 32 or 64) the column-major
// n8 operand; both come from K-major shared tiles through ldmatrix without
// .trans, and each output fragment is stored transposed into C.  So a
// decode step of 4 rows wastes 4 of 8 columns of one n8 tile, not 12 of 16
// tile rows.
//
// Block layout: 8 warps own 128 rows of B (16 each) and stream them along k
// through a 4-stage cp.async ring of 16-byte copies; A's tile for the same
// k range rides in the same stage (<= 64 x 64 bf16 = 8 KB).  Rows are
// padded to 144 bytes, so the 8 row addresses of an ldmatrix fall in 8
// different bank quads.  gridDim.y walks 64-row tiles of A (right at every
// m, tuned for m <= 64).  gridDim.z splits k when there are too few blocks
// to fill the card: each split writes f32 partials into a workspace the
// wrapper allocates, and splitk_reduce (csrc/common.cuh) sums them in
// split order (deterministic) and casts to bf16.  The split count is the wrapper's pure function of
// (m, n, k, SM count).
//
// Unaligned operands (k % 8 != 0, or A or B not 16-byte aligned) take a
// zero-filling scalar load path inside the same kernel; ragged edges load
// zeros through cp.async's src-size and are masked on the store.
#include "common.cuh"

namespace {

constexpr int kRows = 128;       // B rows (output columns) per block: 8 warps x 16
constexpr int kMTile = 64;       // A rows (output rows) per block at most
constexpr int kBK = 64;          // k per stage
constexpr int kPitch = kBK + 8;  // bf16 per shared row: 144 bytes
constexpr int kStages = 4;
constexpr int kThreads = 256;

template <int MA>
struct NtCfg {
  static constexpr int kBElems = kRows * kPitch;
  static constexpr int kStageElems = kBElems + MA * kPitch;
  static constexpr int kSmem = kStages * kStageElems * 2;
};

// Rows [r0, r0 + R) x k-columns [k0, k0 + 64) of a row-major (rows, k) bf16
// matrix into a K-major shared tile of pitch kPitch, zeros outside.
template <int R>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int rows, int k, int r0, int k0, bool vec) {
  if (vec) {
    for (int c = threadIdx.x; c < R * (kBK / 8); c += kThreads) {
      const int r = c / (kBK / 8), kc = (c % (kBK / 8)) * 8;
      const int gr = r0 + r, gk = k0 + kc;
      const bool in = gr < rows && gk < k;  // k % 8 == 0: a chunk is all in or all out
      repro::cp_async16(repro::smem_addr(dst + r * kPitch + kc),
                 in ? src + static_cast<size_t>(gr) * k + gk : src, in);
    }
  } else {
    for (int c = threadIdx.x; c < R * kBK; c += kThreads) {
      const int r = c / kBK, kk = c % kBK;
      const int gr = r0 + r, gk = k0 + kk;
      dst[r * kPitch + kk] = (gr < rows && gk < k) ? src[static_cast<size_t>(gr) * k + gk]
                                                   : __float2bfloat16(0.f);
    }
  }
}

// MA: A rows per block tile (8, 16, 32 or 64).  ws == nullptr: write bf16
// C; else write this split's f32 partials to ws[blockIdx.z] (m x n each).
template <int MA>
__global__ void __launch_bounds__(kThreads)
    nt_bf16(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
            __nv_bfloat16* __restrict__ c, float* __restrict__ ws, int m, int n, int k,
            int kb_per_split) {
  using Cfg = NtCfg<MA>;
  constexpr int NA = MA / 8;  // n8 tiles of A rows
  extern __shared__ __align__(16) __nv_bfloat16 nt_smem[];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kRows;
  const int m0 = blockIdx.y * kMTile;
  const int nkb_all = (k + kBK - 1) / kBK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nkb = min(nkb_all, kb0 + kb_per_split) - kb0;
  const bool vec = (k % 8 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(b) % 16 == 0);

  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  auto load_stage = [&](int slot, int kb) {
    __nv_bfloat16* st = nt_smem + slot * Cfg::kStageElems;
    load_rows<kRows>(st, b, n, k, n0, kb * kBK, vec);
    load_rows<MA>(st + Cfg::kBElems, a, m, k, m0, kb * kBK, vec);
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkb) load_stage(s, kb0 + s);
    repro::cp_async_commit();
  }
  for (int i = 0; i < nkb; ++i) {
    repro::cp_async_wait<kStages - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();               // ... everyone's; and slot (i - 1) is free
    if (i + kStages - 1 < nkb) load_stage((i + kStages - 1) % kStages, kb0 + i + kStages - 1);
    repro::cp_async_commit();
    const __nv_bfloat16* bs = nt_smem + (i % kStages) * Cfg::kStageElems;
    const __nv_bfloat16* as = bs + Cfg::kBElems;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // B fragment, the mma's row-major A: lanes 0-15 give rows 0-15 at
      // k 0-7, lanes 16-31 the same rows at k 8-15.
      uint32_t bf[4];
      repro::ldmatrix_x4(bf, bs + (warp * 16 + lane % 16) * kPitch + ks + (lane / 16) * 8);
      // A fragments, the mma's column-major B, straight from A's stored
      // rows: one x4 covers two n8 tiles at k 0-7 and 8-15.
#pragma unroll
      for (int j = 0; j + 1 < NA; j += 2) {
        uint32_t r[4];
        repro::ldmatrix_x4(
            r, as + (j * 8 + lane % 8 + (lane / 16) * 8) * kPitch + ks + ((lane / 8) % 2) * 8);
        repro::mma_bf16(acc[j], bf, r[0], r[1]);
        repro::mma_bf16(acc[j + 1], bf, r[2], r[3]);
      }
      if constexpr (NA % 2 == 1) {
        uint32_t r[2];
        repro::ldmatrix_x2(r, as + ((NA - 1) * 8 + lane % 8) * kPitch + ks + ((lane / 8) % 2) * 8);
        repro::mma_bf16(acc[NA - 1], bf, r[0], r[1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  // acc[j] is the m16n8 tile (B rows warp*16.., A rows j*8..): element e at
  // B row lane/4 + 8*(e/2), A row 2*(lane%4) + e%2 -- stored transposed.
#pragma unroll
  for (int j = 0; j < NA; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gn = n0 + warp * 16 + lane / 4 + (e / 2) * 8;
      const int gm = m0 + j * 8 + (lane % 4) * 2 + e % 2;
      if (gm < m && gn < n) {
        if (ws != nullptr) {
          ws[(static_cast<size_t>(blockIdx.z) * m + gm) * n + gn] = acc[j][e];
        } else {
          c[static_cast<size_t>(gm) * n + gn] = __float2bfloat16(acc[j][e]);
        }
      }
    }
  }
}

template <int MA>
cudaError_t launch_nt(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c,
                      float* ws, int m, int n, int k, int splits, int kb_per_split, dim3 grid,
                      cudaStream_t s) {
  const cudaError_t e = repro::allow_dynamic_smem<nt_bf16<MA>>(NtCfg<MA>::kSmem);
  if (e != cudaSuccess) return e;
  nt_bf16<MA><<<grid, kThreads, NtCfg<MA>::kSmem, s>>>(a, b, c, splits > 1 ? ws : nullptr,
                                                       m, n, k, kb_per_split);
  return cudaGetLastError();
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// bf16 only.  splits > 1: ws holds splits x m x n f32 (allocated by the
// caller) and a second kernel sums it into C; splits * kb_per_split must
// cover the cdiv(k, 64) k-blocks with none empty.  Grid (gx, gy, gz): the
// wrapper's spec (kernels/matmul_nt.py::nt_grid_specs), block (x, y, z) at
// 128 rows of B x, 64 rows of A y, split z; reduce_programs: the blocks
// of the split's reduce.
REPRO_EXPORT int repro_matmul_nt(const void* a, const void* b, void* c, void* ws, int m,
                                 int n, int k, int splits, int kb_per_split, int gx, int gy,
                                 int gz, int reduce_programs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* cp = static_cast<__nv_bfloat16*>(c);
  auto* wp = static_cast<float*>(ws);
  dim3 grid;
  if (splits < 1 || kb_per_split < 1 || (splits > 1 && wp == nullptr) ||
      !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = m < kMTile ? m : kMTile;
  cudaError_t e;
  if (rows <= 8) {
    e = launch_nt<8>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  } else if (rows <= 16) {
    e = launch_nt<16>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  } else if (rows <= 32) {
    e = launch_nt<32>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  } else {
    e = launch_nt<64>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(repro::launch_splitk_reduce(wp, cp, static_cast<size_t>(m) * n,
                                                      splits, reduce_programs, s));
}
