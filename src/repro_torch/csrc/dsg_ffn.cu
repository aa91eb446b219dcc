// Group-CSR SwiGLU decode: replaces repro/kernels/dsg_ffn.py `dsg_ffn_csr`
// (Pallas, body `_csr_kernel`).
//
// x (B, d) holds one token per lane; lane b keeps the neuron groups
// idx[b, :counts[b]] of the FFN's F = G * block hidden units.  Two
// deterministic launches, no atomics, so greedy streams do not change from
// run to run:
//   (a) gate_up, grid (B, K): slot j < counts[b] computes the block-wide
//       gate and up products over d for group idx[b, j] and stores
//       h = silu(g) * u in x's dtype (as the reference casts h before the
//       down projection).  Padded slots exit at once.
//   (b) down, grid (B, d / 64): each output column sums
//       h[b, j, :] . wd[idx[b, j] * block + r, col] over j < counts[b] in a
//       fixed order, in f32, and is cast to x's dtype once.
// The reference adds each slot's contribution into an accumulator of x's
// dtype; this kernel accumulates in f32, so in bf16 it rounds once where
// the reference rounds `counts` times.
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
