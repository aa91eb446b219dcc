// DRS search kernels: replace repro/kernels/drs_search.py `drs_project` and
// `drs_scores` (Pallas).
//
// drs_project: f(X) = X @ R^T, x (M, d), r (k, d) -> (M, k) in x's dtype,
// f32 accumulation.  A 16 x 16 output tile per block walks d in 16-wide
// shared-memory tiles; any M, k and d are taken (ragged edges are masked).
// Bound on the H100: bytes at the main path's shapes (R is 256 x 2048 and
// M is a prompt bucket or the slot count, so 2 * M * k * d flops stay below
// the tensor cores' byte-to-flop balance); the tile reuses each loaded x and
// R element 16 times from shared memory.
//
// drs_scores: relu(fx @ fw) summed over each `block`-wide group, fx (M, k),
// fw (k, F) -> (M, F / block) f32.  One block per (row tile, group): each
// thread owns one column of the group and accumulates up to 16 rows in
// registers over k, then the group's relu values are summed in a fixed
// order per row.  The (rows x block) virtual tile never leaves the chip;
// only the scores are written.  Bound on the H100: bytes (fw is read once
// per row tile), the same as the Pallas kernel's single-pass design.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kMaxRows = 16;

template <typename T>
__global__ void project_kernel(const T* __restrict__ x,
                               const T* __restrict__ r, T* __restrict__ out,
                               int m, int k, int d) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float rs[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * kTile + ty;   // row of x / out
  const int col = blockIdx.x * kTile + tx;   // row of r / column of out
  const int rrow = blockIdx.x * kTile + ty;  // row of r this thread loads
  float acc = 0.f;
  for (int c0 = 0; c0 < d; c0 += kTile) {
    const int c = c0 + tx;
    xs[ty][tx] = (row < m && c < d) ? repro::to_f(x[(size_t)row * d + c]) : 0.f;
    rs[ty][tx] = (rrow < k && c < d) ? repro::to_f(r[(size_t)rrow * d + c]) : 0.f;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile; ++i) acc += xs[ty][i] * rs[tx][i];
    __syncthreads();
  }
  if (row < m && col < k) out[(size_t)row * k + col] = repro::from_f<T>(acc);
}

template <typename T>
__global__ void scores_kernel(const T* __restrict__ fx,
                              const T* __restrict__ fw,
                              float* __restrict__ out, int m, int k, int f,
                              int block, int rows) {
  extern __shared__ float smem[];
  float* fxs = smem;                 // (rows, k)
  float* red = fxs + rows * k;       // (rows, block)
  const int grp = blockIdx.x, row0 = blockIdx.y * rows;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < rows * k; i += nt) {
    const int r = i / k, c = i - r * k;
    fxs[i] = (row0 + r < m) ? repro::to_f(fx[(size_t)(row0 + r) * k + c]) : 0.f;
  }
  __syncthreads();
  float acc[kMaxRows];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) acc[r] = 0.f;
  const T* w = fw + (size_t)grp * block + tid;
  for (int c = 0; c < k; ++c) {
    const float wv = repro::to_f(w[(size_t)c * f]);
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r)
      if (r < rows) acc[r] += fxs[r * k + c] * wv;
  }
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r)
    if (r < rows) red[r * block + tid] = fmaxf(acc[r], 0.f);
  __syncthreads();
  const int groups = f / block;
  for (int r = tid; r < rows; r += nt) {
    if (row0 + r >= m) continue;
    float s = 0.f;
    for (int i = 0; i < block; ++i) s += red[r * block + i];
    out[(size_t)(row0 + r) * groups + grp] = s;
  }
}

}  // namespace

extern "C" int repro_drs_project(int dtype, const void* x, const void* r,
                                 void* out, int m, int k, int d,
                                 void* stream) {
  const dim3 grid((k + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  REPRO_DISPATCH(dtype, {
    project_kernel<T><<<grid, dim3(kTile, kTile), 0, (cudaStream_t)stream>>>(
        (const T*)x, (const T*)r, (T*)out, m, k, d);
  });
  return (int)cudaGetLastError();
}

extern "C" int repro_drs_scores(int dtype, const void* fx, const void* fw,
                                void* out, int m, int k, int f, int block,
                                int rows, int smem_bytes, void* stream) {
  if (rows < 1 || rows > kMaxRows) return (int)cudaErrorInvalidValue;
  const dim3 grid(f / block, (m + rows - 1) / rows);
  REPRO_DISPATCH(dtype, {
    scores_kernel<T><<<grid, block, smem_bytes, (cudaStream_t)stream>>>(
        (const T*)fx, (const T*)fw, (float*)out, m, k, f, block, rows);
  });
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
