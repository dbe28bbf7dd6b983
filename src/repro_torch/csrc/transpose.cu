// Out-of-place transpose B:(rows, cols) -> B^T:(cols, rows), row-major.
//
// Replaces the Pallas kernel src/repro/kernels/transpose.py:64 (`transpose`,
// body `_kernel` at :45), stage 1 of the paper's TNN.
//
// Bound on the H100: bytes.  It reads and writes every element once and does
// no arithmetic, so the floor is 2 * rows * cols * itemsize over the memory
// rate.  Design (Ruetsch & Micikevicius, the source transpose.py cites): one
// 32x32 tile per block staged through shared memory, so the global read runs
// along input rows and the global write along output rows -- both coalesced.
// The tile has one padding column so the column-wise shared-memory read hits
// 32 different banks.  Ragged edges are masked in the kernel; no padded copy.
// Elements are moved as raw 32- or 16-bit words, so the result is bit-exact.
#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kRows = 8;  // block is kTile x kRows threads; each moves 4 rows

template <typename Word>
__global__ void __launch_bounds__(kTile * kRows)
    transpose_kernel(const Word* __restrict__ in, Word* __restrict__ out,
                     int rows, int cols) {
  __shared__ Word tile[kTile][kTile + 1];
  const int col0 = blockIdx.x * kTile;  // first input column of this tile
  const int row0 = blockIdx.y * kTile;  // first input row of this tile

  const int x = col0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int y = row0 + j;
    if (x < cols && y < rows) {
      tile[j][threadIdx.x] = in[static_cast<size_t>(y) * cols + x];
    }
  }
  __syncthreads();
  // output row = input column, output column = input row
  const int ox = row0 + threadIdx.x;
  for (int j = threadIdx.y; j < kTile; j += kRows) {
    const int oy = col0 + j;
    if (ox < rows && oy < cols) {
      out[static_cast<size_t>(oy) * rows + ox] = tile[threadIdx.x][j];
    }
  }
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

REPRO_EXPORT int repro_transpose(const void* in, void* out, int rows, int cols,
                                 int dtype, void* stream) {
  const dim3 grid(repro::cdiv(cols, kTile), repro::cdiv(rows, kTile));
  const dim3 block(kTile, kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kF32) {
    transpose_kernel<uint32_t><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
        cols);
  } else if (dtype == repro::kBF16) {
    transpose_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out), rows,
        cols);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
