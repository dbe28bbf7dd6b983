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
// Bound on the H100: at decode (m = 3 rows per kv head, n = cache extent)
// the kernel is bound by bytes -- K and V of the live prefix are read once;
// at prefill by its FMA work.  Design: one block of 128 threads per
// (slice, 16 query rows), a loop inside the block over 32-key tiles (the
// Pallas sequential kv grid axis).  The block computes the live key range
// from the mask parameters and visits only the tiles in it, which replaces
// the TPU's banded grid (`_kv_band`).  Q, K, V tiles and the tile's scores
// sit in shared memory as f32; each thread owns one query row's slice of
// the f32 output accumulator in registers.  dh is not padded (up to 128).
#include "common.cuh"

namespace {

constexpr int kBQ = 16;       // query rows per block
constexpr int kBKV = 32;      // keys per tile
constexpr int kDhMax = 128;   // largest head dim the kernel takes
constexpr int kThreads = 128;
constexpr int kLanes = 8;     // threads per query row
constexpr int kColsPerThread = kDhMax / kLanes;
constexpr float kNegInf = -1e30f;  // finite: exp(kNegInf - finite) == 0

struct Mask {
  int causal;
  int window;
  int q_start;
  int k_start;
  int prefix_len;
  int q_seg;
  float softcap;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ lengths,
                     T* __restrict__ out, int m, int n, int dh, Mask mask) {
  __shared__ float q_s[kBQ][kDhMax + 1];
  __shared__ float k_s[kBKV][kDhMax + 1];
  __shared__ float v_s[kBKV][kDhMax];
  __shared__ float p_s[kBQ][kBKV + 1];
  __shared__ float row_max[kBQ];
  __shared__ float row_sum[kBQ];
  __shared__ float row_alpha[kBQ];

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

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT int repro_attention_fused(
    const void* q, const void* k, const void* v, const void* lengths,
    void* out, int g, int m, int n, int dh, int causal, int window,
    int q_start, int k_start, int prefix_len, int q_seg, float softcap,
    int dtype, void* stream) {
  if (dh > kDhMax) return static_cast<int>(cudaErrorInvalidValue);
  const Mask mask{causal, window, q_start, k_start, prefix_len, q_seg, softcap};
  const dim3 grid(g, repro::cdiv(m, kBQ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == repro::kF32) {
    attention_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), len, static_cast<float*>(out), m, n, dh,
        mask);
  } else if (dtype == repro::kBF16) {
    attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), len,
        static_cast<__nv_bfloat16*>(out), m, n, dh, mask);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
