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
//
// Tile instances: the kernel is a template on its tile, (BR, BC) input
// rows x input columns, each 32 or 64; the block stays 32 x 8 threads, each
// moving BR / 8 x BC / 32 elements on the read and BC / 8 x BR / 32 on the
// write.  <32, 32> is the kernel above and what a call with no tile config
// launches.  The write reads a shared column: a warp's 32 lanes read 32
// rows of one column.  32-bit words: a pitch of BC + 1 words (odd) puts the
// rows in 32 different banks.  16-bit words at BC 32 keep the default's
// pitch of 33 halfwords, at most two rows to a bank; at BC 64 a pitch of
// 65 halfwords would put rows 2j and 2j + 1 in one bank at every column,
// so it is BC + 2 halfwords (33 words, odd): one row to a bank.
#include "common.cuh"

namespace {

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;  // the block is 32 x 8 threads at every tile

template <typename Word, int BC>
struct TilePitch {
  static constexpr int value = BC + ((sizeof(Word) == 2 && BC % 64 == 0) ? 2 : 1);
};

template <typename Word, int BR, int BC>
__global__ void __launch_bounds__(kThreadsX * kThreadsY)
    transpose_kernel(const Word* __restrict__ in, Word* __restrict__ out,
                     int rows, int cols) {
  __shared__ Word tile[BR][TilePitch<Word, BC>::value];
  const int col0 = blockIdx.x * BC;  // first input column of this tile
  const int row0 = blockIdx.y * BR;  // first input row of this tile

  for (int i = threadIdx.x; i < BC; i += kThreadsX) {
    const int x = col0 + i;
    for (int j = threadIdx.y; j < BR; j += kThreadsY) {
      const int y = row0 + j;
      if (x < cols && y < rows) {
        tile[j][i] = in[static_cast<size_t>(y) * cols + x];
      }
    }
  }
  __syncthreads();
  // output row = input column, output column = input row
  for (int i = threadIdx.x; i < BR; i += kThreadsX) {
    const int ox = row0 + i;
    for (int j = threadIdx.y; j < BC; j += kThreadsY) {
      const int oy = col0 + j;
      if (ox < rows && oy < cols) {
        out[static_cast<size_t>(oy) * rows + ox] = tile[i][j];
      }
    }
  }
}

template <int BR, int BC>
cudaError_t launch(const void* in, void* out, int rows, int cols, int dtype, dim3 grid,
                   cudaStream_t s) {
  const dim3 block(kThreadsX, kThreadsY);
  if (dtype == repro::kF32) {
    transpose_kernel<uint32_t, BR, BC><<<grid, block, 0, s>>>(
        static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), rows,
        cols);
  } else if (dtype == repro::kBF16) {
    transpose_kernel<uint16_t, BR, BC><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(in), static_cast<uint16_t*>(out), rows,
        cols);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

REPRO_DEFINE_ERROR_STRING

// The (b_rows, b_cols) instances, 32 or 64 each; (32, 32) is the default.
// Grid (gx, gy, gz): the wrapper's spec (kernels/transpose.py::
// transpose_grid_spec), block (x, y) at column-tile x, row-tile y.
REPRO_EXPORT int repro_transpose(const void* in, void* out, int rows, int cols,
                                 int b_rows, int b_cols, int dtype, int gx, int gy, int gz,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid;
  if (!repro::declared_grid(gx, gy, gz, grid)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (b_rows == 32 && b_cols == 32) {
    e = launch<32, 32>(in, out, rows, cols, dtype, grid, s);
  } else if (b_rows == 32 && b_cols == 64) {
    e = launch<32, 64>(in, out, rows, cols, dtype, grid, s);
  } else if (b_rows == 64 && b_cols == 32) {
    e = launch<64, 32>(in, out, rows, cols, dtype, grid, s);
  } else if (b_rows == 64 && b_cols == 64) {
    e = launch<64, 64>(in, out, rows, cols, dtype, grid, s);
  } else {
    e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
