// NN GEMM, bf16: C = A @ B, A:(m, k), B:(k, n), C:(m, n) in bf16, f32
// accumulation.  Replaces src/repro/kernels/matmul_nn.py:77 for bf16; the
// f32 instance, and bf16 operands these kernels do not take, stay with the
// FMA kernel of csrc/matmul.cu.
//
// What the Pallas kernel does on the TPU: an (i, j, k) grid with k
// sequential, an f32 accumulator in scratch memory, B's (k, n) block fed to
// the MXU as it is stored.  NN is stage 2 of the paper's TNN, every data
// gradient (G . W) and stage 2 of every weight gradient (transpose(G) . X).
//
// Two variants, picked by the wrapper (kernels/matmul_nn.py::nn_plans)
// before the launch; both need k % 8 == 0, n % 8 == 0 and 16-byte aligned
// operands (TMA's and cp.async's 16-byte rule):
//
//   wgmma (m > 64): training, m = 2048 tokens or a weight's rows, n 576 or
//   1536, k 192-49152 -- bound by operations.  The structure of the fused
//   TNN's wgmma kernel: a persistent grid of at most one CTA per SM, one TMA
//   producer thread feeding a 3-4 stage mbarrier ring, two consumer
//   warpgroups of 64 rows each running wgmma.mma_async m64nBNk16, a padded
//   shared-memory epilogue with 16-byte stores.  What is new is B: stored
//   (k, n), it is the MN-major operand.  TMA loads it as BN/64 boxes of 64
//   k-rows x 64 columns each (128-byte swizzle, 8 KB, 1024-byte aligned in
//   the stage; boxes wholly right of n are not loaded, and the columns they
//   would feed are never stored), and wgmma reads it with the transpose-B
//   immediate set and an MN-major descriptor: LBO 8 KB between 64-column
//   chunks, SBO 1 KB between 8-row k groups, a k16 step 16 rows (2 KB).
//   Split k where the output tiles cannot fill the card (the LM head's data
//   gradient: 48 tiles of 128 x 192 each walking k = 49152; a k/v weight
//   gradient: 18 tiles): the grid walks (split, tile) units, split-major so
//   that concurrent units share one k range of A and B in L2, and within a
//   split the smaller operand's tiles fastest, so that the larger operand
//   (the LM head's 49152 x 2048 transposed gradient) streams from memory
//   once instead of once per tile column.  Each split writes f32 partials
//   into a workspace the wrapper allocates, and splitk_reduce
//   (csrc/common.cuh) sums them in split order (deterministic) and casts to
//   bf16.  BN (64, 128, 192 or 256) and the split count come from the
//   wrapper's cost model over waves on the SMs.
//
//   skinny (m <= 64): decode and short prefill -- bound by the bytes of B.
//   The swap-AB design of csrc/matmul_nt.cu: C^T = B^T . A^T, so B's
//   columns are the row-major m16 operand of mma.sync.m16n8k16 and A's 1-64
//   rows the column-major n8 operand.  B's (k, n) tile is stored as it is
//   (n contiguous, rows padded to 272 bytes) and read with ldmatrix.trans;
//   A's rows need no .trans.  8 warps own 128 columns of B (16 each) and
//   stream them along k through a 4-stage cp.async ring; gridDim.z splits
//   k for the narrow projections (the wrapper's nt_split), reduced as above.
#include "hopper.cuh"

namespace {

using repro::cp_async16;
using repro::encode_map;
using repro::fence_regs;
using repro::ldmatrix_x2;
using repro::ldmatrix_x4;
using repro::ldmatrix_x4_trans;
using repro::mbar_arrive;
using repro::mbar_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::mma_bf16;
using repro::named_bar;
using repro::smem_addr;
using repro::sw128_desc;
using repro::sw128_mn_desc;
using repro::tma_load_2d;
using repro::wgmma_bf16;
using repro::wgmma_commit;
using repro::wgmma_fence;
using repro::wgmma_wait_all;

// -- the wgmma variant ---------------------------------------------------------

constexpr int kWgBM = 128;       // two consumer warpgroups x 64 rows
constexpr int kWgBK = 64;        // 64 bf16 of A's rows: one 128-byte swizzle row
constexpr int kWgThreads = 384;  // warpgroups 0, 1 consume; warpgroup 2 loads
constexpr int kChunkBytes = kWgBK * repro::kBox * 2;  // one B box, 64 k x 64 columns: 8 KB

template <int BN>
struct WgCfg {
  static constexpr int kStages = BN == 256 ? 3 : 4;
  static constexpr int kABytes = kWgBM * kWgBK * 2;  // 16 KB
  static constexpr int kBBytes = (BN / 64) * kChunkBytes;
  static constexpr int kRing = kStages * (kABytes + kBBytes);
  // epilogue: 64 rows x BN per consumer warpgroup; 16 bytes of padding per
  // row put the 8 rows of one bf16x2 store in 8 different bank quads
  static constexpr int kEpiPitch = BN + 8;
  static constexpr int kEpiBytes = 2 * 64 * kEpiPitch * 2;
  // 1024 bytes of slack: the 128-byte swizzle wants 1024-byte aligned tiles
  static constexpr int kSmem = 1024 + kRing + kEpiBytes + 2 * kStages * 8;
};

// Unit u of the persistent walk: split u / tiles, tile u % tiles.  Tile t
// walks the smaller operand's tiles fastest, so that the CTAs in flight
// share the larger operand's strip in L2 and read it from memory once:
// n_fast (A larger than B) covers rows (t / n_tiles) * 128 and columns
// (t % n_tiles) * BN; else rows (t % m_tiles) * 128, columns
// (t / m_tiles) * BN.
// ws == nullptr (one split): write bf16 C; else write split s's f32
// partials to ws[s] (m x n each).
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    nn_wgmma(const __grid_constant__ CUtensorMap map_a,
             const __grid_constant__ CUtensorMap map_b, __nv_bfloat16* __restrict__ c,
             float* __restrict__ ws, int m, int n, int k, int splits, int kb_per_split,
             bool n_fast) {
  using Cfg = WgCfg<BN>;
  constexpr int S = Cfg::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t a_ring = base;                     // S x 128 rows x 128 B
  const uint32_t b_ring = base + S * Cfg::kABytes;  // S x BN/64 boxes of 64 rows x 128 B
  __nv_bfloat16* epi =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + (base - raw) + Cfg::kRing);
  const uint32_t full = base + Cfg::kRing + Cfg::kEpiBytes;  // S barriers of 8 B
  const uint32_t empty = full + S * 8;

  const int m_tiles = (m + kWgBM - 1) / kWgBM;
  const int n_tiles = (n + BN - 1) / BN;
  const int tiles = m_tiles * n_tiles;
  auto tile_origin = [&](int t, int& m0, int& n0) {
    m0 = (n_fast ? t / n_tiles : t % m_tiles) * kWgBM;
    n0 = (n_fast ? t % n_tiles : t / m_tiles) * BN;
  };
  const int units = tiles * splits;
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

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      uint32_t phase = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int sp = u / tiles;
        int m0, n0;
        tile_origin(u % tiles, m0, n0);
        const int kb1 = min(nkb, (sp + 1) * kb_per_split);
        const int chunks = min(BN / 64, (n - n0 + 63) / 64);  // boxes that reach into B
        for (int kb = sp * kb_per_split; kb < kb1; ++kb) {
          mbar_wait(empty + 8 * s, phase ^ 1);  // the first pass finds it free
          mbar_expect_tx(full + 8 * s, Cfg::kABytes + chunks * kChunkBytes);
          tma_load_2d(a_ring + s * Cfg::kABytes, &map_a, full + 8 * s, kb * kWgBK, m0);
          for (int j = 0; j < chunks; ++j) {
            tma_load_2d(b_ring + s * Cfg::kBBytes + j * kChunkBytes, &map_b, full + 8 * s,
                        n0 + j * 64, kb * kWgBK);
          }
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
    float acc[BN / 2];
    int s = 0;
    uint32_t phase = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int sp = u / tiles;
      int m0, n0;
      tile_origin(u % tiles, m0, n0);
      const int kb1 = min(nkb, (sp + 1) * kb_per_split);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      for (int kb = sp * kb_per_split; kb < kb1; ++kb) {
        mbar_wait(full + 8 * s, phase);
        fence_regs(acc);
        wgmma_fence();
        const uint32_t a_tile = a_ring + s * Cfg::kABytes + wg * 64 * 128;
        const uint32_t b_tile = b_ring + s * Cfg::kBBytes;
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) {
          wgmma_bf16<1>(acc, sw128_desc(a_tile + kk * 32),
                        sw128_mn_desc(b_tile + kk * 16 * 128, kChunkBytes));
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
      if (ws != nullptr) {
        // f32 partials straight from the registers: two columns a store
        float* part = ws + static_cast<size_t>(sp) * m * n;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int row = m0 + wg * 64 + warp * 16 + lane / 4;
          const int col = n0 + j * 8 + (lane % 4) * 2;  // even, and n % 8 == 0
          if (col >= n) continue;
          if (row < m) {
            *reinterpret_cast<float2*>(&part[static_cast<size_t>(row) * n + col]) =
                make_float2(acc[4 * j], acc[4 * j + 1]);
          }
          if (row + 8 < m) {
            *reinterpret_cast<float2*>(&part[static_cast<size_t>(row + 8) * n + col]) =
                make_float2(acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
        continue;
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
        if (gr >= m || gc >= n) continue;  // n % 8 == 0: a chunk is all in or all out
        *reinterpret_cast<uint4*>(c + static_cast<size_t>(gr) * n + gc) =
            *reinterpret_cast<const uint4*>(&my_epi[r * Cfg::kEpiPitch + ch * 8]);
      }
    }
  }
}

// `programs` persistent blocks walk the (split, tile) units: the wrapper's
// spec (kernels/matmul_nn.py::nn_grid_specs), min(units, SMs).
template <int BN>
cudaError_t launch_wgmma(const void* a, const void* b, __nv_bfloat16* c, float* ws, int m,
                         int n, int k, int splits, int kb_per_split, int programs,
                         int reduce_programs, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, a, m, k, kWgBM) || !encode_map(&map_b, b, k, n, kWgBK)) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = repro::allow_dynamic_smem<nn_wgmma<BN>>(WgCfg<BN>::kSmem);
  if (e != cudaSuccess) return e;
  nn_wgmma<BN><<<programs, kWgThreads, WgCfg<BN>::kSmem, s>>>(
      map_a, map_b, c, splits > 1 ? ws : nullptr, m, n, k, splits, kb_per_split,
      /*n_fast=*/m > n);  // A is (m, k), B (k, n): A is the larger when m > n
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  return repro::launch_splitk_reduce(ws, c, static_cast<size_t>(m) * n, splits,
                                     reduce_programs, s);
}

// -- the skinny variant ----------------------------------------------------------

constexpr int kCols = 128;            // B columns (output columns) per block: 8 warps x 16
constexpr int kMTile = 64;            // A rows (output rows) per block at most
constexpr int kBK = 64;               // k per stage
constexpr int kBPitch = kCols + 8;    // bf16 per shared k-row of B: 272 bytes
constexpr int kAPitch = kBK + 8;      // bf16 per shared row of A: 144 bytes
constexpr int kStages = 4;
constexpr int kThreads = 256;

template <int MA>
struct SkCfg {
  static constexpr int kBElems = kBK * kBPitch;
  static constexpr int kStageElems = kBElems + MA * kAPitch;
  static constexpr int kSmem = kStages * kStageElems * 2;
};

// MA: A rows per block tile (8, 16, 32 or 64).  ws == nullptr: write bf16
// C; else write this split's f32 partials to ws[blockIdx.z] (m x n each).
template <int MA>
__global__ void __launch_bounds__(kThreads)
    nn_skinny(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ b,
              __nv_bfloat16* __restrict__ c, float* __restrict__ ws, int m, int n, int k,
              int kb_per_split) {
  using Cfg = SkCfg<MA>;
  constexpr int NA = MA / 8;  // n8 tiles of A rows
  extern __shared__ __align__(16) __nv_bfloat16 nn_smem[];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kMTile;
  const int nkb_all = (k + kBK - 1) / kBK;
  const int kb0 = blockIdx.z * kb_per_split;
  const int nkb = min(nkb_all, kb0 + kb_per_split) - kb0;

  float acc[NA][4];
#pragma unroll
  for (int j = 0; j < NA; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // B rows [k0, k0 + 64) x columns [n0, n0 + 128) as stored, and A rows
  // [m0, m0 + MA) x k-columns [k0, k0 + 64); zeros outside (k % 8 == 0 and
  // n % 8 == 0: a 16-byte chunk is all in or all out)
  auto load_stage = [&](int slot, int kb) {
    __nv_bfloat16* bs = nn_smem + slot * Cfg::kStageElems;
    __nv_bfloat16* as = bs + Cfg::kBElems;
    const int k0 = kb * kBK;
    for (int ch = threadIdx.x; ch < kBK * (kCols / 8); ch += kThreads) {
      const int r = ch / (kCols / 8), cc = (ch % (kCols / 8)) * 8;
      const int gk = k0 + r, gn = n0 + cc;
      const bool in = gk < k && gn < n;
      cp_async16(smem_addr(bs + r * kBPitch + cc), in ? b + static_cast<size_t>(gk) * n + gn : b,
                 in);
    }
    for (int ch = threadIdx.x; ch < MA * (kBK / 8); ch += kThreads) {
      const int r = ch / (kBK / 8), kc = (ch % (kBK / 8)) * 8;
      const int gm = m0 + r, gk = k0 + kc;
      const bool in = gm < m && gk < k;
      cp_async16(smem_addr(as + r * kAPitch + kc), in ? a + static_cast<size_t>(gm) * k + gk : a,
                 in);
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nkb) load_stage(s, kb0 + s);
    repro::cp_async_commit();
  }
  for (int i = 0; i < nkb; ++i) {
    repro::cp_async_wait<kStages - 2>();  // stage i has landed (this thread's copies)
    __syncthreads();                      // ... everyone's; and slot (i - 1) is free
    if (i + kStages - 1 < nkb) load_stage((i + kStages - 1) % kStages, kb0 + i + kStages - 1);
    repro::cp_async_commit();
    const __nv_bfloat16* bs = nn_smem + (i % kStages) * Cfg::kStageElems;
    const __nv_bfloat16* as = bs + Cfg::kBElems;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      // B^T fragment, the mma's row-major A, from B's k-rows transposed:
      // matrix i = lane/8 holds columns +8*(i%2) at k +8*(i/2), so a0..a3
      // are (cols 0-7, k 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, bs + (ks + (lane / 16) * 8 + lane % 8) * kBPitch + warp * 16 +
                                ((lane / 8) % 2) * 8);
      // A fragments, the mma's column-major B, straight from A's stored
      // rows: one x4 covers two n8 tiles at k 0-7 and 8-15.
#pragma unroll
      for (int j = 0; j + 1 < NA; j += 2) {
        uint32_t r[4];
        ldmatrix_x4(r, as + (j * 8 + lane % 8 + (lane / 16) * 8) * kAPitch + ks +
                           ((lane / 8) % 2) * 8);
        mma_bf16(acc[j], bf, r[0], r[1]);
        mma_bf16(acc[j + 1], bf, r[2], r[3]);
      }
      if constexpr (NA % 2 == 1) {
        uint32_t r[2];
        ldmatrix_x2(r, as + ((NA - 1) * 8 + lane % 8) * kAPitch + ks + ((lane / 8) % 2) * 8);
        mma_bf16(acc[NA - 1], bf, r[0], r[1]);
      }
    }
  }
  repro::cp_async_wait<0>();

  // acc[j] is the m16n8 tile (B columns warp*16.., A rows j*8..): element
  // e at column lane/4 + 8*(e/2), A row 2*(lane%4) + e%2 -- stored
  // transposed.
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
cudaError_t launch_skinny(const __nv_bfloat16* a, const __nv_bfloat16* b, __nv_bfloat16* c,
                          float* ws, int m, int n, int k, int splits, int kb_per_split,
                          dim3 grid, cudaStream_t s) {
  const cudaError_t e = repro::allow_dynamic_smem<nn_skinny<MA>>(SkCfg<MA>::kSmem);
  if (e != cudaSuccess) return e;
  nn_skinny<MA><<<grid, kThreads, SkCfg<MA>::kSmem, s>>>(a, b, c, splits > 1 ? ws : nullptr,
                                                         m, n, k, kb_per_split);
  return cudaGetLastError();
}

bool bad_split(const void* ws, int splits, int kb_per_split) {
  return splits < 1 || kb_per_split < 1 || (splits > 1 && ws == nullptr);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// Both entry points: bf16; k % 8 == 0, n % 8 == 0, A and B 16-byte aligned
// (the wrapper checks).  splits > 1: ws holds splits x m x n f32 (allocated
// by the caller) and a second kernel sums it into C; splits * kb_per_split
// must cover the cdiv(k, 64) k-blocks with none empty.

// m > 64; block_n: 64, 128, 192 or 256; `programs` persistent blocks
// (kernels/matmul_nn.py::nn_grid_specs).
REPRO_EXPORT int repro_matmul_nn_wgmma(const void* a, const void* b, void* c, void* ws, int m,
                                       int n, int k, int block_n, int splits,
                                       int kb_per_split, int programs, int reduce_programs,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* cp = static_cast<__nv_bfloat16*>(c);
  auto* wp = static_cast<float*>(ws);
  dim3 grid;
  if (bad_split(ws, splits, kb_per_split) || !repro::declared_grid(programs, 1, 1, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t e;
  switch (block_n) {
    case 64:
      e = launch_wgmma<64>(a, b, cp, wp, m, n, k, splits, kb_per_split, programs,
                           reduce_programs, s);
      break;
    case 128:
      e = launch_wgmma<128>(a, b, cp, wp, m, n, k, splits, kb_per_split, programs,
                            reduce_programs, s);
      break;
    case 192:
      e = launch_wgmma<192>(a, b, cp, wp, m, n, k, splits, kb_per_split, programs,
                            reduce_programs, s);
      break;
    case 256:
      e = launch_wgmma<256>(a, b, cp, wp, m, n, k, splits, kb_per_split, programs,
                            reduce_programs, s);
      break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// Any m (tuned for m <= 64).  Grid (gx, gy, gz): the wrapper's spec,
// block (x, y, z) at 128 columns x, 64 rows of A y, split z.
REPRO_EXPORT int repro_matmul_nn_skinny(const void* a, const void* b, void* c, void* ws, int m,
                                        int n, int k, int splits, int kb_per_split, int gx,
                                        int gy, int gz, int reduce_programs, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const __nv_bfloat16*>(a);
  const auto* bp = static_cast<const __nv_bfloat16*>(b);
  auto* cp = static_cast<__nv_bfloat16*>(c);
  auto* wp = static_cast<float*>(ws);
  dim3 grid;
  if (bad_split(ws, splits, kb_per_split) || !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = m < kMTile ? m : kMTile;
  cudaError_t e;
  if (rows <= 8) {
    e = launch_skinny<8>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  } else if (rows <= 16) {
    e = launch_skinny<16>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  } else if (rows <= 32) {
    e = launch_skinny<32>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  } else {
    e = launch_skinny<64>(ap, bp, cp, wp, m, n, k, splits, kb_per_split, grid, s);
  }
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  return static_cast<int>(repro::launch_splitk_reduce(wp, cp, static_cast<size_t>(m) * n,
                                                      splits, reduce_programs, s));
}
