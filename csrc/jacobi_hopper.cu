// Fused multi-sweep Jacobi for the stable-fluids solves, for Hopper (sm_90a).
//
// One launch runs up to kMaxSweeps Jacobi sweeps (FluidSequential.c:85-104)
// of a (batch, side, side) grid.  Each block owns an output tile and loads
// it with a halo ring of `sweeps + 1` cells into shared memory; the sweeps
// ping-pong between two shared buffers, so device memory is read and
// written once per launch instead of once per sweep.  Cells near the
// region's edge go stale one ring per sweep; the halo is deep enough that
// the tile, and the one ring around it that the ghost rule reads, stays
// exact.
//
// The mode-b boundary rule (set_bnd, FluidSequential.c:62-75) is applied
// after every sweep by the blocks whose region touches the grid's edge:
// ghost edges mirror the adjacent new interior cell (negated on the
// wall-normal component), corners average their two adjacent edge cells.
//
// The Chebyshev variant (ops/chebyshev.py) updates
// x_{k+1} = w*S(x_k) + (1-w)*x_{k-1} in place: the ping-pong partner holds
// x_{k-1} when sweep k writes into it.  A chained launch takes x_{k-1} as
// an input and returns it as a second output, so the recurrence spans
// launches.
#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kMaxSweeps = 16;

struct Weights {
  float w[kMaxSweeps];
};

template <int kRows, int kCols, int kThreadRows, bool kCheby>
__global__ void __launch_bounds__(32 * kThreadRows)
    jacobi_sweeps(const float* __restrict__ x_in,
                  const float* __restrict__ xm_in,
                  const float* __restrict__ rhs, float* __restrict__ x_out,
                  float* __restrict__ xm_out, int side, int sweeps, int halo,
                  float alpha, float beta, float sx, float sy, Weights ws) {
  constexpr int kCellRows = kRows / kThreadRows;
  constexpr int kCellCols = kCols / 32;
  static_assert(kCellRows * kCellCols <= 32, "interior mask is 32 bits");
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + kRows * kCols;

  const size_t offset = size_t(blockIdx.z) * side * side;
  x_in += offset;
  rhs += offset;
  x_out += offset;
  if (kCheby) {
    xm_in += offset;
    xm_out += offset;
  }
  const int last = side - 1;
  const int r0 = int(blockIdx.y) * (kRows - 2 * halo) - halo;
  const int c0 = int(blockIdx.x) * (kCols - 2 * halo) - halo;
  const bool edge_block = r0 <= 0 || c0 <= 0 || r0 + kRows > last ||
                          c0 + kCols > last;

  float rhs_r[kCellRows][kCellCols];
  uint32_t interior = 0;
#pragma unroll
  for (int q = 0; q < kCellRows; ++q) {
    const int i = threadIdx.y + q * kThreadRows;
    const int gi = r0 + i;
#pragma unroll
    for (int m = 0; m < kCellCols; ++m) {
      const int j = threadIdx.x + m * 32;
      const int gj = c0 + j;
      const bool in_grid = gi >= 0 && gi <= last && gj >= 0 && gj <= last;
      const size_t g = size_t(gi) * side + gj;
      cur[i * kCols + j] = in_grid ? x_in[g] : 0.0f;
      if (kCheby) nxt[i * kCols + j] = in_grid ? xm_in[g] : 0.0f;
      const bool upd = gi >= 1 && gi < last && gj >= 1 && gj < last &&
                       i >= 1 && i < kRows - 1 && j >= 1 && j < kCols - 1;
      rhs_r[q][m] = upd ? rhs[g] : 0.0f;
      interior |= uint32_t(upd) << (q * kCellCols + m);
    }
  }
  __syncthreads();

  for (int t = 0; t < sweeps; ++t) {
    const float w = ws.w[t];
    const float omw = 1.0f - w;
#pragma unroll
    for (int q = 0; q < kCellRows; ++q) {
      const int i = threadIdx.y + q * kThreadRows;
#pragma unroll
      for (int m = 0; m < kCellCols; ++m) {
        const int idx = i * kCols + threadIdx.x + m * 32;
        float v;
        if (interior & (1u << (q * kCellCols + m))) {
          const float neigh = ((cur[idx - 1] + cur[idx + 1]) +
                               cur[idx - kCols]) + cur[idx + kCols];
          v = (rhs_r[q][m] + alpha * neigh) / beta;
          if (kCheby) v = w * v + omw * nxt[idx];
        } else {
          v = cur[idx];
        }
        nxt[idx] = v;
      }
    }
    __syncthreads();
    if (edge_block) {
#pragma unroll
      for (int q = 0; q < kCellRows; ++q) {
        const int i = threadIdx.y + q * kThreadRows;
        const int gi = r0 + i;
#pragma unroll
        for (int m = 0; m < kCellCols; ++m) {
          const int j = threadIdx.x + m * 32;
          const int gj = c0 + j;
          const bool row_edge = gi == 0 || gi == last;
          const bool col_edge = gj == 0 || gj == last;
          if (!(row_edge || col_edge) || gi < 0 || gi > last || gj < 0 ||
              gj > last)
            continue;
          const int mi = i + (gi == 0) - (gi == last);
          const int mj = j + (gj == 0) - (gj == last);
          if (mi < 0 || mi >= kRows || mj < 0 || mj >= kCols) continue;
          const float v = nxt[mi * kCols + mj];
          float g;
          if (row_edge && col_edge) {
            g = 0.5f * (sy * v + sx * v);
          } else {
            g = (col_edge ? sx : sy) * v;
          }
          nxt[i * kCols + j] = g;
        }
      }
      __syncthreads();
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

#pragma unroll
  for (int q = 0; q < kCellRows; ++q) {
    const int i = threadIdx.y + q * kThreadRows;
    const int gi = r0 + i;
#pragma unroll
    for (int m = 0; m < kCellCols; ++m) {
      const int j = threadIdx.x + m * 32;
      const int gj = c0 + j;
      if (i < halo || i >= kRows - halo || j < halo || j >= kCols - halo ||
          gi > last || gj > last)
        continue;
      const size_t g = size_t(gi) * side + gj;
      x_out[g] = cur[i * kCols + j];
      if (kCheby) xm_out[g] = nxt[i * kCols + j];
    }
  }
}

// A block sweeps a region of kRows x kCols cells with 32 x kThreadRows
// threads, each owning 4 x 4 cells: 128 KB of shared memory for the two
// buffers, one block per SM.  The fastest of 64 and 128 rows for the
// 20-sweep 2048² and 40-sweep 8192² solves on an H100.
constexpr int kRows = 128;
constexpr int kCols = 128;
constexpr int kThreadRows = 32;

template <bool kCheby>
ffi::Error Launch(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                  const float* xm, ffi::Buffer<ffi::F32> rhs, float* x_out,
                  float* xm_out, float alpha, float beta, int32_t b,
                  ffi::Span<const float> weights) {
  const auto dims = x.dimensions();
  if (dims.size() < 2 || dims[dims.size() - 1] != dims[dims.size() - 2]) {
    return ffi::Error::InvalidArgument("expected (..., side, side) grids");
  }
  const int64_t side = dims[dims.size() - 1];
  const int64_t batch = int64_t(x.element_count()) / (side * side);
  const int sweeps = int(weights.size());
  const int halo = sweeps + 1;
  if (sweeps < 1 || sweeps > kMaxSweeps) {
    return ffi::Error::InvalidArgument(
        "sweeps per launch must be in [1, " + std::to_string(kMaxSweeps) +
        "]");
  }
  Weights ws{};
  for (int t = 0; t < sweeps; ++t) ws.w[t] = weights[t];
  auto kernel = jacobi_sweeps<kRows, kCols, kThreadRows, kCheby>;
  const int smem = 2 * kRows * kCols * int(sizeof(float));
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int tile_r = kRows - 2 * halo;
  const int tile_c = kCols - 2 * halo;
  const dim3 grid(unsigned((side + tile_c - 1) / tile_c),
                  unsigned((side + tile_r - 1) / tile_r), unsigned(batch));
  const dim3 block(32, kThreadRows);
  const float sx = b == 1 ? -1.0f : 1.0f;
  const float sy = b == 2 ? -1.0f : 1.0f;
  kernel<<<grid, block, smem, stream>>>(
      x.typed_data(), xm, rhs.typed_data(), x_out, xm_out, int(side), sweeps,
      halo, alpha, beta, sx, sy, ws);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error JacobiImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                      ffi::Buffer<ffi::F32> rhs,
                      ffi::ResultBuffer<ffi::F32> x_out, float alpha,
                      float beta, int32_t b, ffi::Span<const float> weights) {
  return Launch<false>(stream, x, nullptr, rhs, x_out->typed_data(), nullptr,
                       alpha, beta, b, weights);
}

ffi::Error JacobiChebyImpl(cudaStream_t stream, ffi::Buffer<ffi::F32> x,
                           ffi::Buffer<ffi::F32> xm,
                           ffi::Buffer<ffi::F32> rhs,
                           ffi::ResultBuffer<ffi::F32> x_out,
                           ffi::ResultBuffer<ffi::F32> xm_out, float alpha,
                           float beta, int32_t b,
                           ffi::Span<const float> weights) {
  return Launch<true>(stream, x, xm.typed_data(), rhs, x_out->typed_data(),
                      xm_out->typed_data(), alpha, beta, b, weights);
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(FluidJacobi, JacobiImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<float>("alpha")
                                  .Attr<float>("beta")
                                  .Attr<int32_t>("b")
                                  .Attr<ffi::Span<const float>>("weights"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(FluidJacobiCheby, JacobiChebyImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<float>("alpha")
                                  .Attr<float>("beta")
                                  .Attr<int32_t>("b")
                                  .Attr<ffi::Span<const float>>("weights"));
