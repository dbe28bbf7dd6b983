// Fused masked attention forward: out = softmax(mask(Q K^T)) V per slice,
// with an online f32 softmax, so the (m, n) logits never reach device memory.
//
//   q:(g, m, dh)  k, v:(g, n, dh)  lengths:(g,) int32  ->  out:(g, m, dh)
//
// Replaces the Pallas kernel src/repro/kernels/attention_fused.py:338
// (`attention_fused`, body `_kernel` at :177) and keeps all of its
// semantics: per-slice `lengths` validity, causal / sliding window /
// prefix-LM masks at the offsets q_start and k_start, the GQA fold (row r
// sits at q_start + r % q_seg), the logit softcap, the finite NEG_INF, V
// zeroed beyond `lengths`, p cast to V's dtype before the PV product and a
// zero denominator replaced by 1.  One difference, only in rows that see no
// key at all (which the model never produces: causal rows see themselves,
// decode rows see slot 0): masked entries add exactly 0 here, so such a row
// comes out 0, where the Pallas kernel's result depends on its tiling.
//
// Four kernels; the wrapper picks one per call from dtype, shape and
// alignment (kernels/attention_fused.py::attention_variant):
//
// attention_flash -- bf16, dh 64, 112, 120, 128 or 256, m > 16: prefill
//   and training.
//   Bound on the H100: bytes.  At the training shape (g 24, m 768 = 3 heads
//   x 256 queries folded, n 256, causal, dh 64) Q, K, V and the output are
//   6.3 MB, 1.9 us at 3.35 TB/s, against 0.6 us of tensor-core work.
//   Design: a flash-attention forward on the tensor cores.  A block is one
//   warpgroup and takes 64 query rows.  64-key K/V tiles of the block's
//   live key range (the Pallas `_kv_band`) come through a 2-stage cp.async
//   ring of 16-byte copies, written in the 128-byte swizzle the wgmma
//   descriptors read; keys at or beyond `lengths` are never read, they land
//   as 0.  S = Q K^T is wgmma with Q's tile and K's stored (n, dh) rows as
//   K-major operands in shared memory; the online softmax runs in
//   registers (row max and sum over the lane quad by shuffles, exp2 of
//   log2e-scaled logits on the SFU); P is rounded to bf16 in registers and
//   is the register A operand of P V, whose B is V's tile read MN-major.
//   Tiles wholly inside the visible band skip the per-element mask.  Under
//   a causal mask the q-blocks that see most keys launch first.  wgmma, not
//   mma.sync: at these short sweeps (a 64-row block sees at most a few
//   tiles) each warp's chain of dependent instructions per tile sets the
//   time, and an mma.sync version (64 mma and 32 ldmatrix a warp per tile)
//   measured slower on the card than the 8 wgmma that replace them.
//   Instances by the tile width DH: 64, 128 and 256.  dh 112 and 120 run
//   the 128 instance over rows of their true stride: the 16-byte pieces
//   from dh to 127 of Q, K and V land as zeros through the same cp.async
//   zero-fill, add nothing to S, give output columns that are never
//   stored (the Pallas kernel pads every dh to the 128 edge too; 14 and 7 %
//   more tensor-core work).  The 256 instance holds o[128] accumulator
//   floats a thread, issues P V as one m64n256k16 over V's four 64-column
//   chunks, and keeps the 2-stage ring: Q and two (K, V) stages of 32 KiB
//   tiles, 161 KiB of dynamic shared memory, one block an SM.  nvcc
//   -Xptxas -v (CUDA 12.8, sm_90a): 248 registers a thread for the 256
//   instance, 170 for 128, 110 for 64, none spilling.

// attention_flash_f32 -- f32, dh 64, 112, 120, 128 or 256, 16-byte aligned
//   operands, m > 16: prefill and training in f32.
//   Bound on the H100: operations, exact f32 FFMA (no TF32): at gemma3's
//   prefill (g 4, m 2048, n 1024, window 1024, dh 256) the visible
//   products are 4.3 GFLOP, 64 us at 67 TFLOP/s, against 13 us of bytes.
//   Design: a flash-attention forward in FFMA.  A block takes 64 query
//   rows with 256 threads, thread (ty, tx) the rows 4 ty .. 4 ty + 3; the
//   16 lanes of a half-warp share those rows.  K/V tiles of the block's
//   live key range come through a 2-stage cp.async ring of 16-byte
//   copies, as stored (dh-contiguous rows padded by 4 floats, so the 16
//   keys a K load reads sit in distinct bank groups); keys at or beyond
//   `lengths` are never read, they land as 0.  S = Q K^T: each thread
//   scores its 4 rows against keys tx + 16 j, reading float4 runs along dh
//   of Q's and K's stored rows (a quarter-warp's Q read is a broadcast).
//   The online softmax runs in registers: a row's max by shuffles over its
//   half-warp, exp as exp2f of log2e-scaled f32 differences, each lane
//   keeping its share of the row sum until the end.  P goes to shared
//   memory, where only the row's own half-warp reads it back (a warp
//   barrier, no block barrier), and O += P V reads V's stored rows as
//   float4 along dh: 4 rows x dh / 16 columns of O a thread.  The masks are
//   the flash kernel's (visible_cols, residues, live_keys, all_visible,
//   flash_block_row: most keys first under a causal mask).  Instances by
//   the tile width DH: 64, 128 and 256, with 64-key tiles (32 at 256: Q
//   and two stages of 32 keys are 204 KiB of dynamic shared memory, one
//   block an SM; 64 at DH 64 is 102 KiB, two blocks; 182 KiB at 128, one).
//   dh 112 and 120 run the 128 instance over rows of their true stride,
//   the pieces from dh to 127 zero-filled and never stored.  Where the
//   q-blocks fill less than two waves of the card (gemma3's and
//   paligemma's prefill: 128 blocks, one an SM at dh 256, the causal ones
//   seeing 2 to 32 tiles), each block's live tiles split into 2 to 4 runs
//   over gridDim.z (kernels/attention_fused.py::flash_f32_splits, from the
//   shape and the SM count, never from `lengths`), whose f32 partials
//   attention_flash_combine adds in split order: the same bits on every
//   call.  nvcc -Xptxas -v (CUDA 12.8, sm_90a): 205 registers a thread at
//   DH 256, 160 at 128, 128 at 64 (the two-block cap), none spilling.
//
// attention_decode_split + attention_combine -- m <= 16 (decode: one kv
//   head's GQA group of rows), both dtypes, any dh up to 256.  Bound on the
//   H100: bytes (K and V of the live prefix, read once) and, at decode's
//   size, launch latency.  Design: split-KV ("flash decoding").  The grid
//   is (g, splits), splits (at most 64) chosen on the host from n and the
//   SM count so that g x splits fills the card; a split with no live key
//   writes a "no key" partial and exits.  Inside a block every row is
//   handled at once: each warp walks a run of keys, `lanes` lanes sharing
//   a key row with 16-byte loads (8 lanes for a 64-dim bf16 row, the whole
//   warp for a 256-dim one; lanes past a ragged row's chunks add 0), the next
//   step's loads in flight, dot products reduced by shuffles, FFMA in f32,
//   an online softmax per lane group,
//   merged over the warp by shuffles and over the block through shared
//   memory.  Each split writes f32 partials (acc[m][dh], max[m], sum[m]);
//   attention_combine folds them in split order (the same bits on every
//   call), each scaled by exp(max_i - max).  With one split the block
//   writes the output itself: one launch.
//
// attention_kernel -- FMA: m > 16 with unaligned operands or a dh that
//   no flash instance takes (in either dtype).  The kernel of the port's
//   first slice, kept as it was.  Bound at prefill by its FMA
//   work: one block of 128 threads per (slice, 16 query rows), a loop
//   inside the block over 32-key tiles of the live range; Q, K, V tiles and
//   the tile's scores sit in shared memory as f32; each thread owns one
//   query row's slice of the f32 output accumulator in registers.  It is
//   also the kernel the flash (bf16 and f32) and split kernels replaced
//   (repro_attention_fused_fma launches it for any operands).
//
// Head dims.  The FMA and split kernels are templates on a head-dim bound,
// 128 or 256, which the host picks per call: dh <= 128 runs the 128-bound
// instances, whose shared memory (42 KiB FMA, 41 KiB split) stays static
// as it always was; dh 129..256 runs the 256-bound ones, whose f32 staging
// doubles to 82 KiB (FMA) and 81 KiB (split kernel at 16 rows), past the
// 48 KiB static limit, so it comes from dynamic shared memory (block_smem).
// The FMA kernel's accumulator doubles to 32 registers a thread.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 16;       // query rows per block
constexpr int kBKV = 32;      // keys per tile
constexpr int kDhSmall = 128;  // the head-dim bounds of the FMA and split kernels
constexpr int kDhMax = 256;    // largest head dim they take
constexpr int kThreads = 128;
constexpr int kLanes = 8;     // threads per query row
constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - finite) == 0
constexpr int kStaticSmemMax = 48 * 1024;  // the most static shared memory a block has

// A block's shared memory as one struct S: a static __shared__ variable
// when S fits the static limit, else the launch's dynamic shared memory,
// which launch_smem sizes.
template <typename S>
__device__ __forceinline__ S& block_smem() {
  if constexpr (sizeof(S) <= kStaticSmemMax) {
    __shared__ S s;
    return s;
  } else {
    extern __shared__ __align__(16) uint8_t dyn_smem[];
    return *reinterpret_cast<S*>(dyn_smem);
  }
}

// The dynamic shared memory a launch of `Kernel` with block_smem<S> needs:
// 0 for a static S; else sizeof(S), after raising the kernel's limit.
template <typename S, auto Kernel>
cudaError_t launch_smem(int& bytes) {
  bytes = 0;
  if constexpr (sizeof(S) > kStaticSmemMax) {
    bytes = static_cast<int>(sizeof(S));
    return repro::allow_dynamic_smem<Kernel>(bytes);
  }
  return cudaSuccess;
}

struct Mask {
  int causal;
  int window;
  int q_start;
  int k_start;
  int prefix_len;
  int q_seg;
  float softcap;
};

// Helpers of the flash and split kernels.

// The key columns a query at position q_pos sees: lo <= col <= hi (valid,
// causal, window), or col < pre (valid and in the prefix).
struct VisibleCols {
  int lo, hi, pre;
};

__device__ __forceinline__ VisibleCols visible_cols(int q_pos, int len, const Mask& mask) {
  VisibleCols c{0, len - 1, 0};
  if (mask.causal) c.hi = min(c.hi, q_pos - mask.k_start);
  if (mask.window > 0) c.lo = q_pos - mask.window + 1 - mask.k_start;
  if (mask.prefix_len > 0) c.pre = min(len, mask.prefix_len - mask.k_start);
  return c;
}

__device__ __forceinline__ bool visible(int col, const VisibleCols& c) {
  return (col >= c.lo && col <= c.hi) || col < c.pre;
}

// The fold residues [min_mod, max_mod] of rows r_lo..r_hi: rows spanning a
// fold boundary hold every residue of the segment.
struct Residues {
  int min_mod, max_mod;
};

__device__ __forceinline__ Residues residues(int r_lo, int r_hi, int seg) {
  if (r_lo / seg == r_hi / seg) return {r_lo % seg, r_hi % seg};
  return {0, seg - 1};
}

// The live key columns [lo, hi] of rows with these residues (empty when
// hi < lo): the columns outside see none of the rows.
struct KeyRange {
  int lo, hi;
};

__device__ __forceinline__ KeyRange live_keys(Residues res, int len, const Mask& mask) {
  int lo = 0, hi = len - 1;
  if (mask.causal) hi = min(hi, mask.q_start + res.max_mod - mask.k_start);
  if (mask.window > 0) {
    lo = max(0, mask.q_start + res.min_mod - mask.window + 1 - mask.k_start);
  }
  if (mask.prefix_len > 0) {  // prefix keys stay visible to every row
    lo = 0;
    hi = max(hi, min(len, mask.prefix_len - mask.k_start) - 1);
  }
  return {lo, hi};
}

// Whether every key column in [c0, c1] is visible to every row with these
// residues: such a tile needs no per-element mask.
__device__ __forceinline__ bool all_visible(int c0, int c1, Residues res, int len,
                                            const Mask& mask) {
  if (c1 >= len) return false;
  const int k_lo = mask.k_start + c0, k_hi = mask.k_start + c1;
  bool all = true;
  if (mask.causal) all = all && k_hi <= mask.q_start + res.min_mod;
  if (mask.window > 0) all = all && k_lo > mask.q_start + res.max_mod - mask.window;
  if (mask.prefix_len > 0) all = all || k_hi < mask.prefix_len;
  return all;
}

// -- attention_kernel (FMA) ---------------------------------------------------

template <int DHMAX>
struct FmaSmem {
  float q_s[kBQ][DHMAX + 1];
  float k_s[kBKV][DHMAX + 1];
  float v_s[kBKV][DHMAX];
  float p_s[kBQ][kBKV + 1];
  float row_max[kBQ];
  float row_sum[kBQ];
  float row_alpha[kBQ];
};

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, int m, int n, int dh, Mask mask) {
  constexpr int kColsPerThread = DHMAX / kLanes;
  FmaSmem<DHMAX>& sm = block_smem<FmaSmem<DHMAX>>();
  auto& q_s = sm.q_s;
  auto& k_s = sm.k_s;
  auto& v_s = sm.v_s;
  auto& p_s = sm.p_s;
  auto& row_max = sm.row_max;
  auto& row_sum = sm.row_sum;
  auto& row_alpha = sm.row_alpha;

  const int slice = blockIdx.x;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const size_t q_off = static_cast<size_t>(slice) * m * dh;
  const size_t kv_off = static_cast<size_t>(slice) * n * dh;
  const int len = min(max(lengths[slice], 0), n);
  const int seg = mask.q_seg > 0 ? mask.q_seg : m;

  for (int e = tid; e < kBQ * dh; e += kThreads) {
    const int r = e / dh, d = e % dh;
    q_s[r][d] = (q0 + r < m)
                    ? repro::to_float(q[q_off + static_cast<size_t>(q0 + r) * dh + d])
                    : 0.f;
  }
  if (tid < kBQ) {
    row_max[tid] = kNegInf;
    row_sum[tid] = 0.f;
    row_alpha[tid] = 1.f;
  }

  // The live key columns of this block's real rows: [lo, hi].  A block
  // spanning a fold boundary holds every residue of the segment.
  const int r_lo = q0, r_hi = min(q0 + kBQ, m) - 1;
  const bool one_seg = (r_lo / seg) == (r_hi / seg);
  const int min_mod = one_seg ? r_lo % seg : 0;
  const int max_mod = one_seg ? r_hi % seg : seg - 1;
  int lo = 0, hi = len - 1;
  if (mask.causal) hi = min(hi, mask.q_start + max_mod - mask.k_start);
  if (mask.window > 0) {
    lo = max(0, mask.q_start + min_mod - mask.window + 1 - mask.k_start);
  }
  if (mask.prefix_len > 0) {  // prefix keys stay visible to every row
    lo = 0;
    hi = max(hi, min(len, mask.prefix_len - mask.k_start) - 1);
  }

  const int pr = tid / kLanes;  // this thread's query row in the block
  const int pc = tid % kLanes;  // its lane within the row
  const int row = q0 + pr;
  const int q_pos = mask.q_start + row % seg;
  float acc[kColsPerThread];
#pragma unroll
  for (int i = 0; i < kColsPerThread; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = hi >= lo ? (lo / kBKV) * kBKV : n; t0 <= hi; t0 += kBKV) {
    for (int e = tid; e < kBKV * dh; e += kThreads) {
      const int j = e / dh, d = e % dh, col = t0 + j;
      const size_t idx = kv_off + static_cast<size_t>(col) * dh + d;
      k_s[j][d] = col < n ? repro::to_float(k[idx]) : 0.f;
      v_s[j][d] = col < len ? repro::to_float(v[idx]) : 0.f;  // V zeroed past len
    }
    __syncthreads();

    // scores: lane pc of row pr takes columns pc, pc + 8, pc + 16, pc + 24
#pragma unroll
    for (int u = 0; u < kBKV / kLanes; ++u) {
      const int j = pc + kLanes * u, col = t0 + j;
      float s = 0.f;
      for (int d = 0; d < dh; ++d) s = fmaf(q_s[pr][d], k_s[j][d], s);
      if (mask.softcap != 0.f) s = mask.softcap * tanhf(s / mask.softcap);
      const bool valid = col < len;
      const int k_pos = mask.k_start + col;
      bool vis = valid;
      if (mask.causal) vis = vis && k_pos <= q_pos;
      if (mask.window > 0) vis = vis && k_pos > q_pos - mask.window;
      if (mask.prefix_len > 0) vis = vis || (valid && k_pos < mask.prefix_len);
      p_s[pr][j] = vis ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one thread per row; all state f32
    if (tid < kBQ) {
      const float m_prev = row_max[tid];
      float m_tile = kNegInf;
      for (int j = 0; j < kBKV; ++j) m_tile = fmaxf(m_tile, p_s[tid][j]);
      const float m_new = fmaxf(m_prev, m_tile);
      const bool seen = m_new > kNegInf;  // some visible key so far
      float sum = 0.f;
      for (int j = 0; j < kBKV; ++j) {
        const float p = seen ? expf(p_s[tid][j] - m_new) : 0.f;
        sum += p;
        p_s[tid][j] = repro::round_to<T>(p);  // p in V's dtype for the PV product
      }
      const float alpha = expf(m_prev - m_new);
      row_max[tid] = m_new;
      row_sum[tid] = row_sum[tid] * alpha + sum;
      row_alpha[tid] = alpha;
    }
    __syncthreads();

    const float alpha = row_alpha[pr];
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int d = pc + kLanes * i;
      if (d < dh) {
        float a = acc[i] * alpha;
        for (int j = 0; j < kBKV; ++j) a = fmaf(p_s[pr][j], v_s[j][d], a);
        acc[i] = a;
      }
    }
    __syncthreads();
  }

  if (row < m) {
    float denom = row_sum[pr];
    if (denom == 0.f) denom = 1.f;
#pragma unroll
    for (int i = 0; i < kColsPerThread; ++i) {
      const int d = pc + kLanes * i;
      if (d < dh) {
        out[q_off + static_cast<size_t>(row) * dh + d] =
            repro::from_float<T>(acc[i] / denom);
      }
    }
  }
}

// -- attention_flash ----------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFlashRows = 64;     // query rows per block: one warpgroup, 16 rows a warp
constexpr int kFlashKeys = 64;     // keys per K/V tile
constexpr int kFlashThreads = 128;
constexpr int kFlashStages = 2;    // (K, V) tiles in the ring

// 2^x by the SFU, flushing a subnormal result to 0 (a p below 2^-126 adds
// nothing that a bf16 P or an f32 sum of terms up to 1 can hold).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The first row of the q-block that block `rank` takes.  Under a causal
// mask a later row sees more keys, so the latest blocks (the latest in
// each fold segment, when whole blocks tile the segments) go first and
// the longest do not trail the grid.
__device__ __forceinline__ int flash_block_row(int rank, int blocks, int rows, int m, int seg,
                                               bool causal) {
  if (!causal) return rank * rows;
  if (seg < m && seg % rows == 0 && m % seg == 0) {
    const int per_seg = seg / rows, segs = m / seg;
    return ((rank % segs) * per_seg + per_seg - 1 - rank / segs) * rows;
  }
  return (blocks - 1 - rank) * rows;
}

// The 128-byte swizzle of a K-major tile of `rows` rows x DH bf16, as the
// wgmma descriptors read it: 64-column chunks of rows x 128 bytes, the
// 16-byte piece c of row r at position (c % 8) ^ (r % 8) of its row.
__device__ __forceinline__ uint32_t sw_piece(int r, int c, int rows) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// D(64 x N) += A(64 x 16) . B(16 x N), N = 64, 128 or 256: A from registers
// (each warp's 16 rows in the layout of the mma.sync A fragment, which is
// the layout of an m64nNk16 accumulator pair), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int DH>
struct FlashCfg {
  static constexpr int kTileBytes = 64 * DH * 2;  // a Q, K or V tile of 64 rows
  // Q, then the stages' (K, V); 1024 bytes of slack align the tiles for the swizzle
  static constexpr int kSmem = 1024 + (1 + 2 * kFlashStages) * kTileBytes;
};

template <int DH>
__global__ void __launch_bounds__(kFlashThreads)
    attention_flash(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int m, int n, int dh, Mask mask) {
  // dh <= DH is the row stride of q, k, v and out; pieces from dh to DH
  // land as zeros and are never stored.
  constexpr int kRows = kFlashRows, kKeys = kFlashKeys, kThreads = kFlashThreads;
  constexpr int kStages = kFlashStages;
  constexpr int kChunks = DH / 8;  // 16-byte pieces of a row
  constexpr int kStep = kThreads / kChunks;
  constexpr int kTile = FlashCfg<DH>::kTileBytes;
  static_assert(kRows % kStep == 0 && kKeys % kStep == 0, "copy layout");
  extern __shared__ __align__(16) uint8_t flash_smem[];
  const uint32_t base = (repro::smem_addr(flash_smem) + 1023) & ~1023u;
  uint8_t* gbase = flash_smem + (base - repro::smem_addr(flash_smem));
  const uint32_t qs = base;  // the Q tile, at the end the output's
  auto k_tile = [&](int slot) { return base + kTile * (1 + 2 * slot); };
  auto v_tile = [&](int slot) { return base + kTile * (2 + 2 * slot); };

  const int slice = blockIdx.x;
  const int seg = mask.q_seg > 0 ? mask.q_seg : m;
  const int q0 = flash_block_row(blockIdx.y, gridDim.y, kRows, m, seg, mask.causal != 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = min(max(lengths[slice], 0), n);
  q += static_cast<size_t>(slice) * m * dh;
  out += static_cast<size_t>(slice) * m * dh;
  k += static_cast<size_t>(slice) * n * dh;
  v += static_cast<size_t>(slice) * n * dh;

  const KeyRange keys = live_keys(residues(q0, min(q0 + kRows, m) - 1, seg), len, mask);
  const int tile_lo = keys.lo / kKeys;
  const int n_tiles = keys.hi >= keys.lo ? keys.hi / kKeys - tile_lo + 1 : 0;

  // 16-byte copies: the thread takes piece c_of of rows r_of, r_of + kStep, ...
  const int r_of = threadIdx.x / kChunks, c_of = threadIdx.x % kChunks;
  const bool piece_in = c_of * 8 < dh;  // dh % 8 == 0: a piece is all in or all out
#pragma unroll
  for (int i = 0; i < kRows / kStep; ++i) {
    const int r = r_of + i * kStep;
    const bool in = piece_in && q0 + r < m;
    repro::cp_async16(qs + sw_piece(r, c_of, kRows),
                      in ? q + static_cast<size_t>(q0 + r) * dh + c_of * 8 : q, in);
  }
  // Tile t into its ring slot; K and V rows at or beyond lengths are not
  // read: they land as 0.  One commit group per tile, empty past the last.
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const int t0 = (tile_lo + t) * kKeys;
#pragma unroll
      for (int i = 0; i < kKeys / kStep; ++i) {
        const int r = r_of + i * kStep;
        const bool in = piece_in && t0 + r < len;
        const size_t off = static_cast<size_t>(t0 + r) * dh + c_of * 8;
        repro::cp_async16(k_tile(t % kStages) + sw_piece(r, c_of, kKeys), in ? k + off : k, in);
        repro::cp_async16(v_tile(t % kStages) + sw_piece(r, c_of, kKeys), in ? v + off : v, in);
      }
    }
    repro::cp_async_commit();
  };
  load_tile(0);  // with Q

  // This warp's 16 rows; the thread holds rows lane / 4 and lane / 4 + 8.
  const int w0 = q0 + warp * 16;
  const Residues w_res = residues(w0, min(w0 + 15, m - 1), seg);
  const int row_a = w0 + lane / 4;
  const VisibleCols cols[2] = {visible_cols(mask.q_start + row_a % seg, len, mask),
                               visible_cols(mask.q_start + (row_a + 8) % seg, len, mask)};

  // wgmma accumulators: i of a thread sits at row 16 * warp + lane / 4 +
  // 8 * ((i / 2) % 2) of the block, column 8 * (i / 4) + 2 * (lane % 4) + i % 2.
  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float row_max[2] = {kNegInf, kNegInf}, row_sum[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait<0>();  // tile it (first with Q) has landed: this thread's copies,
    fence_proxy_async();        // made visible to the tensor cores' reads,
    __syncthreads();            // then everyone's; and slot it - 1 is free
    load_tile(it + 1);
    const int t0 = (tile_lo + it) * kKeys;
    const uint32_t ks = k_tile(it % kStages), vs = v_tile(it % kStages);

    // S = Q K^T, 64 rows x 64 keys: Q's tile (A) and K's stored rows (B,
    // K-major) straight from shared memory, one wgmma per 16 of dh.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t off = (kk / 4) * 64 * 128 + (kk % 4) * 32;
      repro::wgmma_bf16<0>(s, repro::sw128_desc(qs + off), repro::sw128_desc(ks + off));
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(s);

    if (mask.softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = mask.softcap * tanhf(s[i] / mask.softcap);
    }
    if (!all_visible(t0, t0 + kKeys - 1, w_res, len, mask)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = t0 + 8 * (i / 4) + (lane % 4) * 2 + (i & 1);
        if (!visible(col, cols[(i / 2) % 2])) s[i] = kNegInf;
      }
    }
    // online softmax of rows a (i % 4 = 0, 1) and b (2, 3); all state f32
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(row_max[h], mx);
      const float alpha = fast_exp2((row_max[h] - m_new) * kLog2e);
      // No visible key so far (m_new is NEG_INF): every logit is NEG_INF,
      // and against a shift of 0 each p is exactly 0 -- never
      // exp(NEG_INF - NEG_INF) = 1.
      const float shift = m_new > kNegInf ? m_new * kLog2e : 0.f;
      float sum[2] = {0.f, 0.f};  // two chains: columns 2t and 2t + 1
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = fast_exp2(fmaf(s[4 * j + 2 * h + e], kLog2e, -shift));
          s[4 * j + 2 * h + e] = p;
          sum[e] += p;
        }
      }
      row_sum[h] = row_sum[h] * alpha + (sum[0] + sum[1]);
      row_max[h] = m_new;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j + 2 * h] *= alpha;
        o[4 * j + 2 * h + 1] *= alpha;
      }
    }
    // O += P V: P rounded to bf16 in registers is the A operand (the
    // Pallas p.astype(v.dtype); accumulators 8kk..8kk+7 are the A fragment
    // of key step kk); V's (key, dh) tile is the MN-major B.
    repro::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[8 * kk], s[8 * kk + 1]),
                             pack_bf16(s[8 * kk + 2], s[8 * kk + 3]),
                             pack_bf16(s[8 * kk + 4], s[8 * kk + 5]),
                             pack_bf16(s[8 * kk + 6], s[8 * kk + 7])};
      wgmma_rs(o, a, repro::sw128_mn_desc(vs + kk * 16 * 128, kKeys * 128));
    }
    repro::wgmma_commit();
    repro::wgmma_wait_all();
    repro::fence_regs(o);
  }

  // Epilogue through the Q tile, which no wgmma reads any more: rows as
  // bf16 pairs, then 16-byte stores of the real rows.
  repro::cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float sum = row_sum[h];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float denom = sum == 0.f ? 1.f : sum;
    const int r = warp * 16 + lane / 4 + 8 * h;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int col = 8 * j + (lane % 4) * 2;
      *reinterpret_cast<__nv_bfloat162*>(gbase + sw_piece(r, col / 8, kRows) + (col % 8) * 2) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] / denom, o[4 * j + 2 * h + 1] / denom);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRows / kStep; ++i) {
    const int r = r_of + i * kStep;
    if (piece_in && q0 + r < m) {
      *reinterpret_cast<int4*>(out + static_cast<size_t>(q0 + r) * dh + c_of * 8) =
          *reinterpret_cast<const int4*>(gbase + sw_piece(r, c_of, kRows));
    }
  }
}

template <int DH>
cudaError_t launch_flash(const void* q, const void* k, const void* v, const int* lengths,
                         void* out, int m, int n, int dh, Mask mask, dim3 grid, cudaStream_t s) {
  const cudaError_t e = repro::allow_dynamic_smem<attention_flash<DH>>(FlashCfg<DH>::kSmem);
  if (e != cudaSuccess) return e;
  attention_flash<DH><<<grid, kFlashThreads, FlashCfg<DH>::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths, static_cast<__nv_bfloat16*>(out), m, n, dh,
      mask);
  return cudaGetLastError();
}

// -- attention_flash_f32 ------------------------------------------------------

constexpr int kF32Rows = 64;      // query rows per block
constexpr int kF32Threads = 256;  // 16 x 16; thread (ty, tx) holds rows 4 ty .. 4 ty + 3
constexpr int kF32Stages = 2;     // (K, V) tiles in the ring

// Shared memory of the DH instance, in floats: Q's tile, the stages' K and
// V tiles (rows padded by 4 floats: consecutive rows in distinct 16-byte
// bank groups), and P.  64-key tiles, 32 at DH 256, where two stages of
// 64 keys would not fit beside Q.
template <int DH>
struct FlashF32Cfg {
  static constexpr int kKeys = DH == 256 ? 32 : 64;
  static constexpr int kKJ = kKeys / 16;  // keys a thread scores per tile
  static constexpr int kDC = DH / 64;     // float4 column groups of O a thread holds
  static constexpr int kPitch = DH + 4;
  static constexpr int kPPitch = kKeys + 4;
  static constexpr int kQ = kF32Rows * kPitch;
  static constexpr int kKV = kKeys * kPitch;  // one K or V tile
  static constexpr int kSmem = (kQ + 2 * kF32Stages * kKV + kF32Rows * kPPitch) * 4;
  static constexpr int kMinBlocks = kSmem <= 113 * 1024 ? 2 : 1;  // two fit an SM's 228 KB
};

// Block (x, y, z): slice x, q-block y (flash_block_row's order), split z
// of the block's live key tiles (contiguous runs of cdiv(tiles, splits)).
// ws == nullptr: one split, which writes the output; else the split's f32
// partial goes to ws: O unnormalised at ((slice * splits + z) * m + row)
// * dh, and (row max, row sum) at g * splits * m * dh + 2 * (that row's
// index), for attention_flash_combine.
template <int DH>
__global__ void __launch_bounds__(kF32Threads, FlashF32Cfg<DH>::kMinBlocks)
    attention_flash_f32(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const int* __restrict__ lengths,
                        float* __restrict__ out, float* __restrict__ ws, int m, int n, int dh,
                        Mask mask) {
  // dh <= DH is the row stride of q, k, v and out (dh % 4 == 0); pieces
  // from dh to DH land as zeros and are never stored.
  using Cfg = FlashF32Cfg<DH>;
  constexpr int kKeys = Cfg::kKeys, kKJ = Cfg::kKJ, kDC = Cfg::kDC;
  constexpr int kPitch = Cfg::kPitch, kPPitch = Cfg::kPPitch;
  constexpr int kPieces = DH / 4;  // 16-byte pieces of a row
  static_assert((kKeys * kPieces) % kF32Threads == 0, "copy layout");
  extern __shared__ __align__(16) float flash_f32_smem[];
  float* q_s = flash_f32_smem;
  float* kv_s = q_s + Cfg::kQ;  // stage s: K at kv_s + 2 s kKV, its V after it
  float* p_s = kv_s + 2 * kF32Stages * Cfg::kKV;
  const uint32_t q_addr = repro::smem_addr(q_s), kv_addr = repro::smem_addr(kv_s);

  const int slice = blockIdx.x;
  const int seg = mask.q_seg > 0 ? mask.q_seg : m;
  const int q0 = flash_block_row(blockIdx.y, gridDim.y, kF32Rows, m, seg, mask.causal != 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = lane % 16, ty = warp * 2 + lane / 16;  // a row's 16 lanes: one half-warp
  const int r0 = 4 * ty;
  const int len = min(max(lengths[slice], 0), n);
  q += static_cast<size_t>(slice) * m * dh;
  k += static_cast<size_t>(slice) * n * dh;
  v += static_cast<size_t>(slice) * n * dh;

  // the block's live key tiles, and this split's run of them
  const KeyRange keys = live_keys(residues(q0, min(q0 + kF32Rows, m) - 1, seg), len, mask);
  const int all_tiles = keys.hi >= keys.lo ? keys.hi / kKeys - keys.lo / kKeys + 1 : 0;
  const int run = (all_tiles + gridDim.z - 1) / gridDim.z;
  const int tile_lo = keys.lo / kKeys + static_cast<int>(blockIdx.z) * run;
  const int n_tiles = max(0, min(run, all_tiles - static_cast<int>(blockIdx.z) * run));

  // Q as stored: rows past m and pieces past dh land as 0.
  for (int c = threadIdx.x; c < kF32Rows * kPieces; c += kF32Threads) {
    const int r = c / kPieces, p = c % kPieces;
    const bool in = p * 4 < dh && q0 + r < m;
    repro::cp_async16(q_addr + (r * kPitch + p * 4) * 4,
                      in ? q + static_cast<size_t>(q0 + r) * dh + p * 4 : q, in);
  }
  // Tile t into its ring slot as stored; K and V rows at or beyond lengths
  // are not read: they land as 0.  One commit group per tile, empty past
  // the last.
  auto load_tile = [&](int t) {
    if (t < n_tiles) {
      const int t0 = (tile_lo + t) * kKeys;
      const uint32_t ks = kv_addr + (t % kF32Stages) * 2 * Cfg::kKV * 4;
      const uint32_t vs = ks + Cfg::kKV * 4;
#pragma unroll
      for (int i = 0; i < kKeys * kPieces / kF32Threads; ++i) {
        const int c = threadIdx.x + i * kF32Threads;
        const int r = c / kPieces, p = c % kPieces;
        const bool in = p * 4 < dh && t0 + r < len;
        const size_t off = static_cast<size_t>(t0 + r) * dh + p * 4;
        const uint32_t d = (r * kPitch + p * 4) * 4;
        repro::cp_async16(ks + d, in ? k + off : k, in);
        repro::cp_async16(vs + d, in ? v + off : v, in);
      }
    }
    repro::cp_async_commit();
  };
  load_tile(0);  // with Q

  // The key columns each of this thread's rows sees, and the fold residues
  // of this warp's 8 rows (for the tiles that need no per-element mask).
  VisibleCols cols[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) cols[i] = visible_cols(mask.q_start + (q0 + r0 + i) % seg, len, mask);
  const int w_hi = min(q0 + 8 * warp + 7, m - 1);
  const Residues w_res = residues(min(q0 + 8 * warp, w_hi), w_hi, seg);

  // o[i][c]: row r0 + i, columns 4 tx + 64 c .. + 3
  float4 o[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int c = 0; c < kDC; ++c) o[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float row_max[4], row_sum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_max[i] = kNegInf;
    row_sum[i] = 0.f;  // this thread's share; the half-warp's sum at the end
  }

  for (int it = 0; it < n_tiles; ++it) {
    repro::cp_async_wait<0>();  // tile it (first with Q) has landed: this thread's copies,
    __syncthreads();            // then everyone's; and slot it - 1 and P are free
    load_tile(it + 1);
    const int t0 = (tile_lo + it) * kKeys;
    const float* ks = kv_s + (it % kF32Stages) * 2 * Cfg::kKV;
    const float* vs = ks + Cfg::kKV;

    // S = Q K^T: rows r0 .. r0 + 3 x keys tx + 16 j, float4 runs along dh
    // of Q's and K's stored rows.
    float s[4][kKJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kKJ; ++j) s[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < dh; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(q_s + (r0 + i) * kPitch + d);
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * kPitch + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv.x, x);
          x = fmaf(qv[i].y, kv.y, x);
          x = fmaf(qv[i].z, kv.z, x);
          s[i][j] = fmaf(qv[i].w, kv.w, x);
        }
      }
    }
    if (mask.softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kKJ; ++j) s[i][j] = mask.softcap * tanhf(s[i][j] / mask.softcap);
      }
    }
    if (!all_visible(t0, t0 + kKeys - 1, w_res, len, mask)) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < kKJ; ++j) {
          if (!visible(t0 + tx + 16 * j, cols[i])) s[i][j] = kNegInf;
        }
      }
    }
    // online softmax in registers; a row's max over its half-warp by shuffles
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < kKJ; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(row_max[i], mx);
      // No visible key so far (m_new is NEG_INF): every p is exactly 0,
      // never exp(NEG_INF - NEG_INF) = 1.
      const bool seen = m_new > kNegInf;
      const float alpha = exp2f((row_max[i] - m_new) * kLog2e);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKJ; ++j) {
        const float p = seen ? exp2f((s[i][j] - m_new) * kLog2e) : 0.f;
        s[i][j] = p;
        sum += p;
      }
      row_sum[i] = row_sum[i] * alpha + sum;
      row_max[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) {
        o[i][c].x *= alpha;
        o[i][c].y *= alpha;
        o[i][c].z *= alpha;
        o[i][c].w *= alpha;
      }
    }
    // P through shared memory: a row is written and read by its own
    // half-warp only, so a warp barrier orders the two.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < kKJ; ++j) p_s[(r0 + i) * kPPitch + tx + 16 * j] = s[i][j];
    }
    __syncwarp();
    // O += P V: P's float4 runs along the keys, V's stored rows along dh.
#pragma unroll 2
    for (int j4 = 0; j4 < kKeys; j4 += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(p_s + (r0 + i) * kPPitch + j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vs + (j4 + e) * kPitch + 4 * tx + 64 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pv[i].x : e == 1 ? pv[i].y : e == 2 ? pv[i].z : pv[i].w;
            o[i][c].x = fmaf(p, vv.x, o[i][c].x);
            o[i][c].y = fmaf(p, vv.y, o[i][c].y);
            o[i][c].z = fmaf(p, vv.z, o[i][c].z);
            o[i][c].w = fmaf(p, vv.w, o[i][c].w);
          }
        }
      }
    }
  }
  repro::cp_async_wait<0>();  // no copy outlives the block (n_tiles may be 0)

  // the row sums over the half-warp; unsplit, a zero denominator becomes 1
  const size_t part = (static_cast<size_t>(slice) * gridDim.z + blockIdx.z) * m;
  float* stats = ws != nullptr ? ws + static_cast<size_t>(gridDim.x) * gridDim.z * m * dh
                               : nullptr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float sum = row_sum[i];
#pragma unroll
    for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int row = q0 + r0 + i;
    if (row >= m) continue;
    const float inv = ws != nullptr ? 1.f : 1.f / (sum == 0.f ? 1.f : sum);
    float* dst = ws != nullptr ? ws + (part + row) * dh
                               : out + (static_cast<size_t>(slice) * m + row) * dh;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = 4 * tx + 64 * c;
      if (col < dh) {
        *reinterpret_cast<float4*>(dst + col) =
            make_float4(o[i][c].x * inv, o[i][c].y * inv, o[i][c].z * inv, o[i][c].w * inv);
      }
    }
    if (ws != nullptr && tx == 0) {
      *reinterpret_cast<float2*>(stats + 2 * (part + row)) = make_float2(row_max[i], sum);
    }
  }
}

constexpr int kCombineThreads = 256;

// out = (sum_s O_s e^(max_s - M)) / (sum_s sum_s e^(max_s - M)) over the
// splits of attention_flash_f32, added in split order (the same bits on
// every call); a split whose row saw no key scales by exactly 0, and a
// zero denominator becomes 1.  One thread per (row, 4 columns); grid
// (cdiv(m * dh / 4, 256), g).
__global__ void __launch_bounds__(kCombineThreads)
    attention_flash_combine(const float* __restrict__ ws, float* __restrict__ out, int m,
                            int dh, int splits) {
  const int slice = blockIdx.y, pieces = dh / 4;
  const size_t i = static_cast<size_t>(blockIdx.x) * kCombineThreads + threadIdx.x;
  if (i >= static_cast<size_t>(m) * pieces) return;
  const int row = static_cast<int>(i / pieces), col = static_cast<int>(i % pieces) * 4;
  const float* stats = ws + static_cast<size_t>(gridDim.y) * splits * m * dh;
  const size_t part0 = static_cast<size_t>(slice) * splits * m + row;
  float mx = kNegInf;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, stats[2 * (part0 + s * m)]);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float2 st = *reinterpret_cast<const float2*>(stats + 2 * (part0 + s * m));
    const float sc = st.x == kNegInf ? 0.f : exp2f((st.x - mx) * kLog2e);
    den += st.y * sc;
    const float4 o = *reinterpret_cast<const float4*>(ws + (part0 + s * m) * dh + col);
    acc.x += o.x * sc;
    acc.y += o.y * sc;
    acc.z += o.z * sc;
    acc.w += o.w * sc;
  }
  const float inv = 1.f / (den == 0.f ? 1.f : den);
  *reinterpret_cast<float4*>(out + (static_cast<size_t>(slice) * m + row) * dh + col) =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// grid: the kernel's, (slice, q-block, split); cgrid: the combine's.
template <int DH>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const int* lengths,
                             void* out, void* ws, int m, int n, int dh, Mask mask, int splits,
                             dim3 grid, dim3 cgrid, cudaStream_t s) {
  constexpr int kSmem = FlashF32Cfg<DH>::kSmem;
  const cudaError_t e = repro::allow_dynamic_smem<attention_flash_f32<DH>>(kSmem);
  if (e != cudaSuccess) return e;
  float* part = splits > 1 ? static_cast<float*>(ws) : nullptr;
  attention_flash_f32<DH><<<grid, kF32Threads, kSmem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      lengths, static_cast<float*>(out), part, m, n, dh, mask);
  const cudaError_t e2 = cudaGetLastError();
  if (e2 != cudaSuccess || splits == 1) return e2;
  attention_flash_combine<<<cgrid, kCombineThreads, 0, s>>>(part, static_cast<float*>(out), m,
                                                           dh, splits);
  return cudaGetLastError();
}

// -- attention_decode_split, attention_combine ---------------------------------

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeMaxRows = 16;  // the split kernel takes m <= 16

// K (or V) values a lane holds of one key row: CPL chunks of VEC elements
// (16-byte chunks; with scalar loads one element a chunk), enough for 32
// lanes to cover DHMAX.
template <int VEC, int DHMAX>
struct DecodeCfg {
  static constexpr int kCpl = (DHMAX + 32 * VEC - 1) / (32 * VEC);
  static constexpr int kElems = kCpl * VEC;
};

template <int MR, int DHMAX>
struct DecodeSmem {
  float q_s[MR][DHMAX];
  float red_max[kDecodeWarps][MR];
  float red_sum[kDecodeWarps][MR];
  float red_acc[kDecodeWarps][MR][DHMAX];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, float* dst) {
  if constexpr (VEC == 1) {
    dst[0] = repro::to_float(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "a vector chunk is 16 bytes");
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = repro::to_float(e[i]);
  }
}

// e^x by the SFU (2^(x log2 e)); e^(NEG_INF - finite) is exactly 0.
__device__ __forceinline__ float fast_exp(float x) { return fast_exp2(x * kLog2e); }

// One (slice, split) per block.  Keys [split * per, split * per + per) of
// the live range; `lanes` lanes share a key row (a power of two, at least
// dh / VEC chunks, or 32: then a lane takes chunks sub, sub + 32, ...).
// ws == nullptr: a single split, which writes the output; else the
// split's f32 partial goes to ws at
// ((slice * splits + split) * m * (dh + 2)): acc[m][dh], max[m], sum[m].
template <typename T, int VEC, int MR, int DHMAX>
__global__ void __launch_bounds__(kDecodeThreads)
    attention_decode_split(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, const int* __restrict__ lengths,
                           T* __restrict__ out, float* __restrict__ ws, int m, int n, int dh,
                           int per, int lanes, Mask mask) {
  constexpr int kCpl = DecodeCfg<VEC, DHMAX>::kCpl;
  constexpr int kElems = DecodeCfg<VEC, DHMAX>::kElems;
  DecodeSmem<MR, DHMAX>& sm = block_smem<DecodeSmem<MR, DHMAX>>();
  auto& q_s = sm.q_s;
  auto& red_max = sm.red_max;
  auto& red_sum = sm.red_sum;
  auto& red_acc = sm.red_acc;

  const int slice = blockIdx.x, split = blockIdx.y;
  const int len = min(max(lengths[slice], 0), n);
  const int seg = mask.q_seg > 0 ? mask.q_seg : m;
  const KeyRange live = live_keys(residues(0, m - 1, seg), len, mask);
  const int k0 = max(live.lo, split * per), k1 = min(live.hi, split * per + per - 1);
  const size_t o_off = static_cast<size_t>(slice) * m * dh;
  const size_t part = (static_cast<size_t>(slice) * gridDim.y + split) * m * (dh + 2);

  if (k0 > k1) {  // no live key: a "no key" partial, or unsplit a zero output
    for (int i = threadIdx.x; i < m * dh; i += kDecodeThreads) {
      if (ws != nullptr) {
        ws[part + i] = 0.f;
      } else {
        out[o_off + i] = repro::from_float<T>(0.f);
      }
    }
    if (ws != nullptr) {
      for (int r = threadIdx.x; r < m; r += kDecodeThreads) {
        ws[part + m * dh + r] = kNegInf;
        ws[part + m * dh + m + r] = 0.f;
      }
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane % lanes;  // this lane's place in its key row
  const int keys_per_warp = 32 / lanes;
  const int stride = kDecodeWarps * keys_per_warp;  // keys a block takes a step
  const int chunks = dh / VEC;
  k += static_cast<size_t>(slice) * n * dh;
  v += static_cast<size_t>(slice) * n * dh;

  // This lane's K and V chunks of key `col`; zeros past the run's end.
  auto load_key = [&](int col, float (&kf)[kElems], float (&vf)[kElems]) {
#pragma unroll
    for (int c = 0; c < kCpl; ++c) {
      const int chunk = sub + c * lanes;
      if (col <= k1 && chunk < chunks) {
        const size_t off = static_cast<size_t>(col) * dh + chunk * VEC;
        load_chunk<T, VEC>(k + off, kf + c * VEC);
        load_chunk<T, VEC>(v + off, vf + c * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[c * VEC + e] = vf[c * VEC + e] = 0.f;
      }
    }
  };
  // the first step's keys are in flight while Q is staged
  int col = k0 + warp * keys_per_warp + lane / lanes;
  float kf[kElems], vf[kElems];
  load_key(col, kf, vf);
  for (int i = threadIdx.x; i < m * dh; i += kDecodeThreads) {
    q_s[i / dh][i % dh] = repro::to_float(q[o_off + i]);
  }
  __syncthreads();

  float acc[MR][kElems], row_max[MR], row_sum[MR];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    row_max[r] = kNegInf;
    row_sum[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kElems; ++e) acc[r][e] = 0.f;
  }

  // Each warp takes keys_per_warp keys a step, the next step's loads in
  // flight; every lane of a warp runs the same steps, so the shuffles see
  // the whole warp.
  for (int base = k0 + warp * keys_per_warp; base <= k1; base += stride, col += stride) {
    float kn[kElems], vn[kElems];
    load_key(col + stride, kn, vn);
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= m) break;
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const int chunk = sub + c * lanes;
        if (chunk < chunks) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(q_s[r][chunk * VEC + e], kf[c * VEC + e], d);
        }
      }
      for (int off = lanes / 2; off > 0; off /= 2) d += __shfl_xor_sync(0xffffffffu, d, off);
      if (mask.softcap != 0.f) d = mask.softcap * tanhf(d / mask.softcap);
      if (col <= k1 && visible(col, visible_cols(mask.q_start + r % seg, len, mask))) {
        const float m_new = fmaxf(row_max[r], d);
        const float alpha = fast_exp(row_max[r] - m_new), p = fast_exp(d - m_new);
        row_sum[r] = row_sum[r] * alpha + p;
        const float pv = repro::round_to<T>(p);  // p in V's dtype for the PV product
#pragma unroll
        for (int e = 0; e < kElems; ++e) acc[r][e] = fmaf(pv, vf[e], acc[r][e] * alpha);
        row_max[r] = m_new;
      }
    }
#pragma unroll
    for (int e = 0; e < kElems; ++e) {
      kf[e] = kn[e];
      vf[e] = vn[e];
    }
  }

  // Merge the warp's lane groups (a group that saw no key has max NEG_INF,
  // sum and acc 0, and adds 0), then the warps through shared memory.
  for (int off = lanes; off < 32; off *= 2) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= m) break;
      const float o_max = __shfl_xor_sync(0xffffffffu, row_max[r], off);
      const float o_sum = __shfl_xor_sync(0xffffffffu, row_sum[r], off);
      const float mx = fmaxf(row_max[r], o_max);
      const float a = fast_exp(row_max[r] - mx), b = fast_exp(o_max - mx);
      row_sum[r] = row_sum[r] * a + o_sum * b;
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        acc[r][e] = acc[r][e] * a + __shfl_xor_sync(0xffffffffu, acc[r][e], off) * b;
      }
      row_max[r] = mx;
    }
  }
  if (lane < lanes) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      if (r >= m) break;
#pragma unroll
      for (int c = 0; c < kCpl; ++c) {
        const int chunk = sub + c * lanes;
        if (chunk < chunks) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) red_acc[warp][r][chunk * VEC + e] = acc[r][c * VEC + e];
        }
      }
      if (lane == 0) {
        red_max[warp][r] = row_max[r];
        red_sum[warp][r] = row_sum[r];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * dh; i += kDecodeThreads) {
    const int r = i / dh, d = i % dh;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, red_max[w][r]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float sc = fast_exp(red_max[w][r] - mx);
      sum += red_sum[w][r] * sc;
      a += red_acc[w][r][d] * sc;
    }
    if (ws == nullptr) {
      out[o_off + i] = repro::from_float<T>(a / (sum == 0.f ? 1.f : sum));
    } else {
      ws[part + i] = a;
      if (d == 0) {
        ws[part + m * dh + r] = mx;
        ws[part + m * dh + m + r] = sum;
      }
    }
  }
}

constexpr int kCombineMaxSplits = 64;  // splits whose scales the combine keeps in shared memory

// out = (sum_i acc_i e^(max_i - max)) / (sum_i sum_i e^(max_i - max)) over
// the splits, added in split order; one block per slice.  Warp w finds the
// max and the scales of rows w, w + 4, ... with one split a lane; a split
// that saw no key scales by exactly 0.
template <typename T>
__global__ void __launch_bounds__(kDecodeThreads)
    attention_combine(const float* __restrict__ ws, T* __restrict__ out, int m, int dh,
                      int splits) {
  static_assert(kCombineMaxSplits <= 64, "two splits a lane");
  __shared__ float scale[kDecodeMaxRows][kCombineMaxSplits];
  __shared__ float sums[kDecodeMaxRows][kCombineMaxSplits];
  __shared__ float denom[kDecodeMaxRows];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t stride = static_cast<size_t>(m) * (dh + 2);
  const float* part = ws + static_cast<size_t>(blockIdx.x) * splits * stride;
  for (int r = warp; r < m; r += kDecodeWarps) {
    float p_max[2], p_sum[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      p_max[h] = sp < splits ? part[sp * stride + m * dh + r] : kNegInf;
      p_sum[h] = sp < splits ? part[sp * stride + m * dh + m + r] : 0.f;
    }
    float mx = fmaxf(p_max[0], p_max[1]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sp = lane + 32 * h;
      if (sp < splits) {
        scale[r][sp] = p_max[h] == kNegInf ? 0.f : fast_exp(p_max[h] - mx);
        sums[r][sp] = p_sum[h];
      }
    }
    __syncwarp();
    if (lane == 0) {
      float sum = 0.f;
      for (int sp = 0; sp < splits; ++sp) sum += sums[r][sp] * scale[r][sp];
      denom[r] = sum == 0.f ? 1.f : sum;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < m * dh; i += kDecodeThreads) {
    const int r = i / dh;
    float a = 0.f;
#pragma unroll 8
    for (int sp = 0; sp < splits; ++sp) a += part[sp * stride + i] * scale[r][sp];
    out[static_cast<size_t>(blockIdx.x) * m * dh + i] = repro::from_float<T>(a / denom[r]);
  }
}

// The split kernel for MR rows at most, head dims up to DHMAX.
template <typename T, int VEC, int MR, int DHMAX>
cudaError_t launch_split(const T* q, const T* k, const T* v, const int* lengths, T* out,
                         float* part, int m, int n, int dh, int per, int lanes, Mask mask,
                         dim3 grid, cudaStream_t s) {
  int smem = 0;
  const cudaError_t e =
      launch_smem<DecodeSmem<MR, DHMAX>, attention_decode_split<T, VEC, MR, DHMAX>>(smem);
  if (e != cudaSuccess) return e;
  attention_decode_split<T, VEC, MR, DHMAX><<<grid, kDecodeThreads, smem, s>>>(
      q, k, v, lengths, out, part, m, n, dh, per, lanes, mask);
  return cudaGetLastError();
}

// grid: the split kernel's, (slice, split); cgrid: the combine's, a block
// a slice (used where splits > 1).
template <typename T, int VEC, int DHMAX>
cudaError_t launch_decode(const T* q, const T* k, const T* v, const int* lengths, T* out,
                          float* ws, int m, int n, int dh, int splits, int per, Mask mask,
                          dim3 grid, dim3 cgrid, cudaStream_t s) {
  int lanes = 1;
  while (lanes < 32 && lanes * VEC < dh) lanes *= 2;
  float* part = splits > 1 ? ws : nullptr;
  const cudaError_t e =
      m <= 4 ? launch_split<T, VEC, 4, DHMAX>(q, k, v, lengths, out, part, m, n, dh, per, lanes,
                                              mask, grid, s)
             : launch_split<T, VEC, kDecodeMaxRows, DHMAX>(q, k, v, lengths, out, part, m, n, dh,
                                                           per, lanes, mask, grid, s);
  if (e != cudaSuccess || splits == 1) return e;
  attention_combine<T><<<cgrid, kDecodeThreads, 0, s>>>(ws, out, m, dh, splits);
  return cudaGetLastError();
}

template <typename T, int DHMAX>
cudaError_t launch_decode_dh(const T* q, const T* k, const T* v, const int* lengths, T* out,
                             float* ws, int m, int n, int dh, int splits, int per, Mask mask,
                             dim3 grid, dim3 cgrid, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  // 16-byte loads when every key row starts on a 16-byte boundary
  const bool vec = dh % kVec == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  return vec ? launch_decode<T, kVec, DHMAX>(q, k, v, lengths, out, ws, m, n, dh, splits, per,
                                             mask, grid, cgrid, s)
             : launch_decode<T, 1, DHMAX>(q, k, v, lengths, out, ws, m, n, dh, splits, per,
                                          mask, grid, cgrid, s);
}

template <typename T>
cudaError_t launch_decode_any(const void* q, const void* k, const void* v, const int* lengths,
                              void* out, void* ws, int m, int n, int dh, int splits, int per,
                              Mask mask, dim3 grid, dim3 cgrid, cudaStream_t s) {
  const auto* qp = static_cast<const T*>(q);
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  auto* op = static_cast<T*>(out);
  auto* wp = static_cast<float*>(ws);
  return dh <= kDhSmall
             ? launch_decode_dh<T, kDhSmall>(qp, kp, vp, lengths, op, wp, m, n, dh, splits, per,
                                             mask, grid, cgrid, s)
             : launch_decode_dh<T, kDhMax>(qp, kp, vp, lengths, op, wp, m, n, dh, splits, per,
                                           mask, grid, cgrid, s);
}

// The FMA kernel at head dims up to DHMAX, block (x, y) = (slice, 16-row
// q-block).
template <typename T, int DHMAX>
cudaError_t launch_fma_dh(const void* q, const void* k, const void* v, const int* lengths,
                          void* out, int m, int n, int dh, Mask mask, dim3 grid,
                          cudaStream_t s) {
  int smem = 0;
  const cudaError_t e = launch_smem<FmaSmem<DHMAX>, attention_kernel<T, DHMAX>>(smem);
  if (e != cudaSuccess) return e;
  attention_kernel<T, DHMAX><<<grid, kThreads, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), lengths,
      static_cast<T*>(out), m, n, dh, mask);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fma(const void* q, const void* k, const void* v, const int* lengths,
                       void* out, int m, int n, int dh, Mask mask, dim3 grid, cudaStream_t s) {
  return dh <= kDhSmall ? launch_fma_dh<T, kDhSmall>(q, k, v, lengths, out, m, n, dh, mask, grid, s)
                        : launch_fma_dh<T, kDhMax>(q, k, v, lengths, out, m, n, dh, mask, grid, s);
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// Every entry point launches the grids of the wrapper's specs
// (kernels/attention_fused.py::attention_grid_specs): (gx, gy, gz) the
// kernel's, (cx, cy, cz) the combine's where the keys split.

// The FMA kernel, for any operands of either dtype, dh <= 256.
REPRO_EXPORT int repro_attention_fused_fma(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int g, int m, int n, int dh, int causal, int window,
    int q_start, int k_start, int prefix_len, int q_seg, float softcap,
    int dtype, int gx, int gy, int gz, void* stream) {
  dim3 grid;
  if (dh < 1 || dh > kDhMax || !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask mask{causal, window, q_start, k_start, prefix_len, q_seg, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == repro::kF32) {
    return static_cast<int>(launch_fma<float>(q, k, v, len, out, m, n, dh, mask, grid, s));
  }
  if (dtype == repro::kBF16) {
    return static_cast<int>(
        launch_fma<__nv_bfloat16>(q, k, v, len, out, m, n, dh, mask, grid, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// bf16, dh 64, 112, 120, 128 or 256, q, k, v and out 16-byte aligned (the
// wrapper checks).
REPRO_EXPORT int repro_attention_fused_flash(
    const void* q, const void* k, const void* v, const void* lengths, void* out, int g, int m,
    int n, int dh, int causal, int window, int q_start, int k_start, int prefix_len, int q_seg,
    float softcap, int gx, int gy, int gz, void* stream) {
  dim3 grid;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out)) % 16 != 0 ||
      !repro::declared_grid(gx, gy, gz, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask mask{causal, window, q_start, k_start, prefix_len, q_seg, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dh == 64) {
    return static_cast<int>(launch_flash<64>(q, k, v, len, out, m, n, dh, mask, grid, s));
  }
  if (dh == 112 || dh == 120 || dh == 128) {
    return static_cast<int>(launch_flash<128>(q, k, v, len, out, m, n, dh, mask, grid, s));
  }
  if (dh == 256) {
    return static_cast<int>(launch_flash<256>(q, k, v, len, out, m, n, dh, mask, grid, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// f32, dh 64, 112, 120, 128 or 256, q, k, v, out and ws 16-byte aligned
// (the wrapper checks); splits >= 1 runs of each q-block's key tiles,
// splits <= 65535; splits > 1: ws holds g x splits x m x (dh + 2) f32
// (allocated by the caller) and a second kernel combines them into out.
REPRO_EXPORT int repro_attention_fused_flash_f32(
    const void* q, const void* k, const void* v, const void* lengths, void* out, void* ws, int g,
    int m, int n, int dh, int causal, int window, int q_start, int k_start, int prefix_len,
    int q_seg, float softcap, int splits, int gx, int gy, int gz, int cx, int cy, int cz,
    void* stream) {
  dim3 grid, cgrid;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out) |
       reinterpret_cast<uintptr_t>(ws)) % 16 != 0 ||
      splits < 1 || splits > 65535 || (splits > 1 && ws == nullptr) ||
      !repro::declared_grid(gx, gy, gz, grid) ||
      (splits > 1 && !repro::declared_grid(cx, cy, cz, cgrid))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask mask{causal, window, q_start, k_start, prefix_len, q_seg, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dh == 64) {
    return static_cast<int>(
        launch_flash_f32<64>(q, k, v, len, out, ws, m, n, dh, mask, splits, grid, cgrid, s));
  }
  if (dh == 112 || dh == 120 || dh == 128) {
    return static_cast<int>(
        launch_flash_f32<128>(q, k, v, len, out, ws, m, n, dh, mask, splits, grid, cgrid, s));
  }
  if (dh == 256) {
    return static_cast<int>(
        launch_flash_f32<256>(q, k, v, len, out, ws, m, n, dh, mask, splits, grid, cgrid, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// m <= 16, dh <= 256, either dtype; splits * per must cover the n keys.
// splits > 1: ws holds g x splits x m x (dh + 2) f32 (allocated by the
// caller) and a second kernel combines them into out.
REPRO_EXPORT int repro_attention_fused_decode(
    const void* q, const void* k, const void* v, const void* lengths, void* out, void* ws,
    int g, int m, int n, int dh, int causal, int window, int q_start, int k_start,
    int prefix_len, int q_seg, float softcap, int splits, int per, int dtype, int gx, int gy,
    int gz, int cx, int cy, int cz, void* stream) {
  dim3 grid, cgrid;
  if (m < 1 || m > kDecodeMaxRows || dh < 1 || dh > kDhMax || splits < 1 || per < 1 ||
      splits > kCombineMaxSplits || static_cast<long long>(splits) * per < n ||
      (splits > 1 && ws == nullptr) || !repro::declared_grid(gx, gy, gz, grid) ||
      (splits > 1 && !repro::declared_grid(cx, cy, cz, cgrid))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask mask{causal, window, q_start, k_start, prefix_len, q_seg, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == repro::kF32) {
    return static_cast<int>(launch_decode_any<float>(q, k, v, len, out, ws, m, n, dh, splits,
                                                     per, mask, grid, cgrid, s));
  }
  if (dtype == repro::kBF16) {
    return static_cast<int>(launch_decode_any<__nv_bfloat16>(q, k, v, len, out, ws, m, n, dh,
                                                              splits, per, mask, grid, cgrid, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
