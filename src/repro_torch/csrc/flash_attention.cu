// Flash attention: replaces repro/kernels/flash_attention.py
// `flash_attention` (Pallas, body `_kernel`).
//
// q (BH, S, D), k/v (BH, T, D) -> o (BH, S, D) in q's dtype.  Under
// `causal`, query row i sits at absolute position i + offset with
// offset = T - S (the suffix convention) and sees keys j <= i + offset.
//
// One block per (bh, tile of kBQ query rows).  The Pallas grid carries the
// running max, sum and accumulator across key blocks in order; here a loop
// inside the block walks the key tiles of kBK keys in order and keeps them
// in shared memory (max, sum) and registers (accumulator).  q, k and v are
// upcast to f32 on load, scores are (q . k) * scale in f32, masked scores
// are NEG = -1e30 and their probabilities are zeroed a second time after
// exp, and the output is acc / max(l, 1e-20) rounded once to q's dtype.
// A row that sees no key (causal with S > T) therefore gives zeros, as the
// Pallas kernel does.  Key tiles wholly in the future of the block's last
// row are never visited.  Ragged edges of S and T are masked, so the tile
// sizes here are the kernel's own and the result does not depend on the
// caller's block_q / block_k.
//
// Bound on the H100: bytes at the shapes it serves (q, k, v and o once;
// 4 * D flops per attended pair, about 1 flop per byte at T = 2048 in
// bf16).  This first version runs its products on the CUDA cores from
// f32 tiles in shared memory (K rows padded by one word against bank
// conflicts), so at D = 128 it is bound by shared-memory loads, not by
// device memory; tensor-core (wgmma) tiles and TMA loads are the next step.
// Shared memory per block is about 4 * (kBQ + 2 * kBK) * (D + 1) bytes,
// 91 KB at D = 128, above the 48 KB default, so the entry point opts in to
// the larger dynamic allocation before it launches.
#include "common.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBQ = 32;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;
constexpr int kMaxD = 256;
constexpr int kMaxOwn = kBQ * kMaxD / kThreads;  // accumulator slots/thread

inline size_t smem_floats(int d) {
  return (size_t)kBQ * (d + 1) + (size_t)kBK * (d + 1) + (size_t)kBK * d +
         (size_t)kBQ * (kBK + 1) + 2 * kBQ;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int s_len,
             int t_len, int d, int causal, int offset, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* qs = smem;                     // (kBQ, d + 1)
  float* ks = qs + kBQ * ld;            // (kBK, d + 1)
  float* vs = ks + kBK * ld;            // (kBK, d)
  float* ps = vs + kBK * d;             // (kBQ, kBK + 1) scores, then p
  float* m_s = ps + kBQ * (kBK + 1);    // (kBQ,) running max
  float* l_s = m_s + kBQ;               // (kBQ,) running sum
  const int tid = threadIdx.x, bh = blockIdx.y, q0 = blockIdx.x * kBQ;
  const size_t qbase = ((size_t)bh * s_len + q0) * d;
  const size_t kbase = (size_t)bh * t_len * d;
  const int rows = min(kBQ, s_len - q0);

  for (int i = tid; i < kBQ * d; i += kThreads) {
    const int r = i / d, c = i - r * d;
    qs[r * ld + c] = r < rows ? repro::to_f(q[qbase + i]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = kNeg;
    l_s[tid] = 0.f;
  }
  // accumulator: this thread owns elements tid + j * kThreads of (kBQ, d)
  const int own = kBQ * d / kThreads + ((kBQ * d) % kThreads > tid);
  float acc[kMaxOwn];
#pragma unroll
  for (int j = 0; j < kMaxOwn; ++j) acc[j] = 0.f;

  // keys past the last row's position are never needed
  const int kend = causal ? min(t_len, q0 + rows + offset) : t_len;
  // score tile: thread owns rows ty, ty + 16 and columns tx + 16 * c
  const int ty = tid / 16, tx = tid % 16;
  // softmax: 8 threads per row
  const int sr = tid / 8, sl = tid % 8;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();
    for (int i = tid; i < kBK * d; i += kThreads) {
      const int r = i / d, c = i - r * d;
      const bool in = k0 + r < t_len;
      ks[r * ld + c] = in ? repro::to_f(k[kbase + (size_t)k0 * d + i]) : 0.f;
      vs[i] = in ? repro::to_f(v[kbase + (size_t)k0 * d + i]) : 0.f;
    }
    __syncthreads();
    float sc[2][4] = {};
    for (int i = 0; i < d; ++i) {
      const float a0 = qs[ty * ld + i], a1 = qs[(ty + 16) * ld + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float b = ks[(tx + 16 * c) * ld + i];
        sc[0][c] += a0 * b;
        sc[1][c] += a1 * b;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ty + 16 * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 16 * c, kj = k0 + col;
        const bool ok = row < rows && kj < t_len &&
                        (!causal || kj <= q0 + row + offset);
        ps[row * (kBK + 1) + col] = ok ? sc[r][c] * scale : kNeg;
      }
    }
    __syncthreads();
    {
      float* prow = ps + sr * (kBK + 1);
      float mx = kNeg;
      for (int c = sl; c < kBK; c += 8) mx = fmaxf(mx, prow[c]);
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[sr], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = sl; c < kBK; c += 8) {
        const int kj = k0 + c;
        const bool ok = sr < rows && kj < t_len &&
                        (!causal || kj <= q0 + sr + offset);
        const float p = ok ? expf(prow[c] - m_new) : 0.f;
        prow[c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (sl == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[sr] = l_s[sr] * corr + sum;
        m_s[sr] = m_new;
        // the corrections ride in the row's padding column
        prow[kBK] = corr;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOwn; ++j) {
      if (j < own) {
        const int e = tid + j * kThreads, r = e / d, c = e - r * d;
        const float* prow = ps + r * (kBK + 1);
        float a = acc[j] * prow[kBK];
        for (int kk = 0; kk < kBK; ++kk) a += prow[kk] * vs[kk * d + c];
        acc[j] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kMaxOwn; ++j) {
    if (j < own) {
      const int e = tid + j * kThreads, r = e / d;
      if (r < rows)
        o[qbase + e] = repro::from_f<T>(acc[j] / fmaxf(l_s[r], 1e-20f));
    }
  }
}

}  // namespace

extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* out, int bh,
                                     int s_len, int t_len, int d, int causal,
                                     int offset, float scale, void* stream) {
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(d) * sizeof(float);
  const dim3 grid((s_len + kBQ - 1) / kBQ, bh);
  REPRO_DISPATCH(dtype, {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    flash_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, s_len, t_len, d,
        causal, offset, scale);
  });
  return (int)cudaGetLastError();
}
