// Group-sparse SwiGLU FFN kernels: replace repro/kernels/dsg_ffn.py
// `dsg_ffn_csr` (Pallas, body `_csr_kernel`) and `dsg_ffn` (Pallas, body
// `_kernel`).  Both keep the reference's rounding of h = silu(g) * u to
// x's dtype before the down projection, and both accumulate the down
// projection in f32 and round once, where the Pallas kernels round their
// x-dtype accumulator after every slot or F block: in f32 the two agree to
// summation order, in bf16 the port's sum is the more accurate one.
// Blocks run in parallel in any order, so each kernel takes two
// deterministic launches and no atomics: greedy streams and bf16 results
// do not change from run to run.
//
// --- dsg_ffn_csr: group-CSR decode ---------------------------------------
//
// x (B, d) holds one token per lane; lane b keeps the neuron groups
// idx[b, :counts[b]] of the FFN's F = G * block hidden units:
//   (a) gate_up, grid (B, K): slot j < counts[b] computes the block-wide
//       gate and up products over d for group idx[b, j] and stores
//       h = silu(g) * u in x's dtype (as the reference casts h before the
//       down projection).  Padded slots exit at once.
//   (b) down, grid (B, d / 64): each output column sums
//       h[b, j, :] . wd[idx[b, j] * block + r, col] over j < counts[b] in a
//       fixed order, in f32, and is cast to x's dtype once.
//
// Bound on the H100: bytes.  Each active group costs 3 * d * block weight
// elements and 6 * d * block flops per lane, about 1 flop per byte in bf16.
// Lanes read their own groups' blocks; the least traffic is the union of
// the lanes' active groups, which is what the bound counts.  Loads are
// coalesced along the contiguous block (gate/up) and d (down) axes, and
// each block splits its reduction over several thread slices so enough
// loads are in flight; lanes with overlapping groups still read a shared
// block once per lane.
#include "common.cuh"

namespace {

constexpr int kGateUpThreads = 512;
constexpr int kDownCols = 64;
constexpr int kDownSplit = 4;

template <typename T>
__global__ void gate_up_kernel(const T* __restrict__ x,
                               const T* __restrict__ wg,
                               const T* __restrict__ wu,
                               const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ counts,
                               T* __restrict__ h, int d, int f, int kslots,
                               int block) {
  const int b = blockIdx.x, j = blockIdx.y;
  if (j >= counts[b]) return;  // uniform across the block
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  float* xs = smem;            // (d,)
  float* pg = xs + d;          // (nt,) partial gate sums
  float* pu = pg + nt;         // (nt,) partial up sums
  for (int i = tid; i < d; i += nt) xs[i] = repro::to_f(x[(size_t)b * d + i]);
  __syncthreads();
  const int col = tid % block, slice = tid / block, nslice = nt / block;
  const size_t c0 = (size_t)idx[b * kslots + j] * block + col;
  float gs = 0.f, us = 0.f;
#pragma unroll 4
  for (int r = slice; r < d; r += nslice) {
    const float xv = xs[r];
    gs += xv * repro::to_f(wg[(size_t)r * f + c0]);
    us += xv * repro::to_f(wu[(size_t)r * f + c0]);
  }
  pg[tid] = gs;
  pu[tid] = us;
  __syncthreads();
  if (slice == 0) {
    float gt = 0.f, ut = 0.f;
    for (int s = 0; s < nslice; ++s) {
      gt += pg[s * block + col];
      ut += pu[s * block + col];
    }
    const float hv = gt / (1.f + expf(-gt)) * ut;
    h[((size_t)b * kslots + j) * block + col] = repro::from_f<T>(hv);
  }
}

template <typename T>
__global__ void down_kernel(const T* __restrict__ h, const T* __restrict__ wd,
                            const int32_t* __restrict__ idx,
                            const int32_t* __restrict__ counts,
                            T* __restrict__ out, int d, int kslots,
                            int block) {
  extern __shared__ float smem[];
  float* hs = smem;                        // (block,)
  float* part = hs + block;                // (kDownSplit, kDownCols)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int cl = tid % kDownCols, rs = tid / kDownCols;
  const int col = blockIdx.y * kDownCols + cl;
  const int n = counts[b];
  float acc = 0.f;
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    for (int i = tid; i < block; i += blockDim.x)
      hs[i] = repro::to_f(h[((size_t)b * kslots + j) * block + i]);
    __syncthreads();
    if (col < d) {
      const T* w = wd + (size_t)idx[b * kslots + j] * block * d + col;
#pragma unroll 4
      for (int r = rs; r < block; r += kDownSplit)
        acc += hs[r] * repro::to_f(w[(size_t)r * d]);
    }
  }
  part[rs * kDownCols + cl] = acc;
  __syncthreads();
  if (rs == 0 && col < d) {
    float s = 0.f;
    for (int i = 0; i < kDownSplit; ++i) s += part[i * kDownCols + cl];
    out[(size_t)b * d + col] = repro::from_f<T>(s);
  }
}

}  // namespace

extern "C" int repro_dsg_ffn_csr(int dtype, const void* x, const void* wg,
                                 const void* wu, const void* wd,
                                 const void* idx, const void* counts,
                                 void* h, void* out, int b, int d, int f,
                                 int kslots, int block, void* stream) {
  if (block <= 0 || kGateUpThreads % block) return (int)cudaErrorInvalidValue;
  const size_t up_smem = (size_t)(d + 2 * kGateUpThreads) * sizeof(float);
  const size_t down_smem = (size_t)(block + kDownSplit * kDownCols) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  REPRO_DISPATCH(dtype, {
    gate_up_kernel<T><<<dim3(b, kslots), kGateUpThreads, up_smem, s>>>(
        (const T*)x, (const T*)wg, (const T*)wu, (const int32_t*)idx,
        (const int32_t*)counts, (T*)h, d, f, kslots, block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    down_kernel<T><<<dim3(b, (d + kDownCols - 1) / kDownCols),
                     kDownCols * kDownSplit, down_smem, s>>>(
        (const T*)h, (const T*)wd, (const int32_t*)idx,
        (const int32_t*)counts, (T*)out, d, kslots, block);
  });
  return (int)cudaGetLastError();
}

// --- dsg_ffn: tile-masked, multi-token rows --------------------------------
//
// x (M, d), wg/wu (d, F), wd (F, d), token_mask (M, G = F / block) f32
// {0, 1} -> (M, d) in x's dtype.  The kernel cuts the product into cells
// of kTM token rows by kTN hidden columns.  A cell is dead when no token
// of its rows selected any group that its columns touch; its gate/up and
// down work is skipped, which changes the time and never the result, since
// a dead cell's h is zero for every token.
//   (a) tile_gate_up, grid (M / kTM, F / kTN): reads its cell's slice of
//       token_mask, ORs it (the reference builds that tile mask with XLA
//       before its kernel), writes the cell's live flag, and for a live
//       cell computes silu(x . wg) * (x . wu) in f32, multiplies by the
//       per-token group mask and stores h in x's dtype.
//   (b) tile_down, grid (M / kTM, d / kTN): walks the F axis in the cells'
//       kTN-wide chunks in order, skips the chunks its row tile marked dead,
//       and sums h . wd in f32, rounded once.
//
// Bound on the H100: bytes at M = 256 (x and out once, 3 * d weight
// columns for each F block live in any row tile; 6 * d flops per live
// (token, hidden unit) pair, so about 2 * M / el flops per weight byte,
// below the ~295 where the tensor cores bound).  This first version is a
// SIMT tiled product on the CUDA cores (kTM x kTN cells, 4 x 4 outputs a
// thread, f32 tiles in shared memory), so it is bound by the CUDA cores'
// f32 rate; tensor-core (wgmma) tiles are the next step.

namespace {

constexpr int kTM = 64, kTN = 64, kTK = 16, kTileThreads = 256;

// acc[b][i][j] += A[m0 + ty + 16 i, k] * B_b[k, n0 + tx + 16 j] over
// k in [k0, k1), for NB right-hand matrices B_b (ldb wide) that share the
// left-hand tile A (lda wide, `rows` valid rows).  Called by every thread.
template <typename T, int NB>
__device__ __forceinline__ void tile_product(
    float (&acc)[NB][4][4], float (*as)[kTM + 1], float (*bs)[kTK][kTN],
    const T* __restrict__ a, int lda, int rows, const T* const* b, int ldb,
    int cols, int k0, int k1) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  for (int kk = k0; kk < k1; kk += kTK) {
    __syncthreads();
    for (int e = tid; e < kTM * kTK; e += kTileThreads) {
      const int m = e / kTK, k = e % kTK;
      as[k][m] = (m < rows && kk + k < k1)
                     ? repro::to_f(a[(size_t)m * lda + kk + k]) : 0.f;
    }
#pragma unroll
    for (int bi = 0; bi < NB; ++bi)
      for (int e = tid; e < kTK * kTN; e += kTileThreads) {
        const int k = e / kTN, n = e % kTN;
        bs[bi][k][n] = (n < cols && kk + k < k1)
                           ? repro::to_f(b[bi][(size_t)(kk + k) * ldb + n])
                           : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTK; ++k) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[k][ty + 16 * i];
#pragma unroll
      for (int bi = 0; bi < NB; ++bi)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float bv = bs[bi][k][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[bi][i][j] += av[i] * bv;
        }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tile_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                    const T* __restrict__ wu,
                    const float* __restrict__ token_mask,
                    int32_t* __restrict__ live, T* __restrict__ h, int m,
                    int d, int f, int block) {
  __shared__ float as[kTK][kTM + 1];
  __shared__ float bs[2][kTK][kTN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int rows = min(kTM, m - m0), cols = min(kTN, f - n0);
  const int g = f / block, g0 = n0 / block, g1 = (n0 + cols - 1) / block;
  const int ng = g1 - g0 + 1;
  int any = 0;
  for (int e = tid; e < rows * ng; e += kTileThreads)
    any |= token_mask[(size_t)(m0 + e / ng) * g + g0 + e % ng] > 0.f;
  any = __syncthreads_or(any);
  if (tid == 0) live[blockIdx.x * gridDim.y + blockIdx.y] = any;
  if (!any) return;  // uniform across the block
  float acc[2][4][4] = {};
  const T* bmat[2] = {wg + n0, wu + n0};
  tile_product<T, 2>(acc, as, bs, x + (size_t)m0 * d, d, rows, bmat, f, cols,
                     0, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (c >= cols) continue;
      const float gv = acc[0][i][j], uv = acc[1][i][j];
      const float tok = token_mask[(size_t)(m0 + r) * g + (n0 + c) / block];
      h[(size_t)(m0 + r) * f + n0 + c] =
          repro::from_f<T>(gv / (1.f + expf(-gv)) * uv * tok);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kTileThreads)
tile_down_kernel(const T* __restrict__ h, const T* __restrict__ wd,
                 const int32_t* __restrict__ live, T* __restrict__ out,
                 int m, int d, int f) {
  __shared__ float as[kTK][kTM + 1];
  __shared__ float bs[1][kTK][kTN];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kTM, n0 = blockIdx.y * kTN;
  const int rows = min(kTM, m - m0), cols = min(kTN, d - n0);
  const int chunks = (f + kTN - 1) / kTN;
  float acc[1][4][4] = {};
  const T* bmat[1] = {wd + n0};
  for (int c = 0; c < chunks; ++c) {
    if (!live[blockIdx.x * chunks + c]) continue;  // uniform across the block
    tile_product<T, 1>(acc, as, bs, h + (size_t)m0 * f, f, rows, bmat, d,
                       cols, c * kTN, min(f, (c + 1) * kTN));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cc = tx + 16 * j;
      if (cc < cols)
        out[(size_t)(m0 + r) * d + n0 + cc] = repro::from_f<T>(acc[0][i][j]);
    }
  }
}

}  // namespace

extern "C" int repro_dsg_ffn_tile(int dtype, const void* x, const void* wg,
                                  const void* wu, const void* wd,
                                  const void* token_mask, void* live, void* h,
                                  void* out, int m, int d, int f, int block,
                                  void* stream) {
  if (m <= 0 || d <= 0 || f <= 0 || block <= 0 || f % block)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int mt = (m + kTM - 1) / kTM;
  REPRO_DISPATCH(dtype, {
    tile_gate_up_kernel<T><<<dim3(mt, (f + kTN - 1) / kTN), kTileThreads, 0,
                             s>>>(
        (const T*)x, (const T*)wg, (const T*)wu, (const float*)token_mask,
        (int32_t*)live, (T*)h, m, d, f, block);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tile_down_kernel<T><<<dim3(mt, (d + kTN - 1) / kTN), kTileThreads, 0,
                          s>>>(
        (const T*)h, (const T*)wd, (const int32_t*)live, (T*)out, m, d, f);
  });
  return (int)cudaGetLastError();
}
