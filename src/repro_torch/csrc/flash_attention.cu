// Flash attention: replaces repro/kernels/flash_attention.py
// `flash_attention` (Pallas, body `_kernel`).
//
// q (BH, S, D), k/v (BH, T, D) -> o (BH, S, D) in q's dtype.  Under
// `causal`, query row i sits at absolute position i + offset with
// offset = T - S (the suffix convention) and sees keys j <= i + offset.
// Scores are (q . k) * scale in f32, masked scores are NEG = -1e30 and
// their probabilities are zeroed a second time after exp, and the output
// is acc / max(l, 1e-20) rounded once to q's dtype, so a row that sees no
// key (causal with S > T) gives zeros, as the Pallas kernel does.  Key
// tiles wholly in the future of a block's last row are never loaded.
// Ragged edges of S and T are masked, so the tile sizes here are the
// kernel's own and the result does not depend on the caller's block_q /
// block_k.  Two kernels, chosen by the wrapper from dtype and shape:
//
// flash_tc_kernel (bf16, D a multiple of 64 up to 256): Hopper's tensor
// cores.  One warpgroup (128 threads) owns 64 query rows, the wgmma M.
// Q and a ring of two stages of 64-key K and V tiles come into shared
// memory by TMA with 128-byte swizzle (a D = 128 row is two 64-wide
// boxes), each stage completing on an mbarrier, so the next tile's load
// runs under this tile's products.  S = Q K^T is wgmma m64n64k16 with both
// operands K-major in shared memory; the online softmax runs on the f32
// accumulator fragments in registers (row max and sum across the four
// lanes of a quad by shuffles, exp2 of log2(e)-scaled scores); P is
// rounded to bf16 in registers and is the A operand of the PV wgmma, with
// V the MN-major B operand (transposed by the instruction).  Rounding P
// to bf16 is the one numerical change from the Pallas kernel, which
// multiplies f32 probabilities by f32 V.  Only key tiles that cross the
// diagonal or the end of T are masked.  Where the query tiles are fewer
// than the SMs, the wrapper splits the key tiles across blocks: each
// split writes its f32 (m, l, acc) partial to a workspace, and
// flash_merge_kernel combines the splits in split order, with no atomics,
// so results are the same bit for bit from run to run.  A split in which a
// row sees no key carries m = NEG, l = 0, acc = 0, and the merge keeps a
// row that no split saw exactly zero.  Bound on the H100: bytes at the
// main shapes (about 1 flop per byte of q, k, v and o at T = 2048 in
// bf16... the products are 4 * D flops per attended pair and run on the
// tensor cores at up to 989 TFLOP/s).
//
// flash_kernel (f32, or D not a multiple of 64; D <= 256): a SIMT
// kernel.  One block per (bh, tile of kBQ query rows) walks the key tiles
// in order with an f32 online softmax in shared memory (max, sum) and
// registers (accumulator); q, k and v are upcast to f32 on load (K rows
// padded by one word against bank conflicts), about 91 KB at D = 128,
// above the 48 KB default, so the entry point opts in to the larger
// dynamic allocation before it launches.
#include "common.cuh"
#include "sm90.cuh"

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


// ---- tensor-core path (bf16) -------------------------------------------
constexpr int kTcThreads = 128;  // one warpgroup: 64 query rows
constexpr int kTcStages = 2;     // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

inline size_t tc_smem_bytes(int d) {
  // Q, then the stages' K tiles, then their V tiles; 1 KB for alignment
  return (size_t)(d / 64) * repro::sm90::kTileBytes * (1 + 2 * kTcStages) +
         1024;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ out, float* __restrict__ ws_acc,
                float* __restrict__ ws_ml, int bh_count, int s_len, int t_len,
                int causal, int offset, float scale_log2, int tiles_per_split,
                int splits) {
  namespace h = repro::sm90;
  constexpr int kC = D / 64;                 // 64-wide column boxes
  constexpr int kKVBytes = 2 * kC * h::kTileBytes;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kTcStages];
  __shared__ uint64_t qbar;
  uint8_t* qs = h::align1024(smem_raw);
  uint8_t* ks = qs + kC * h::kTileBytes;
  uint8_t* vs = ks + kTcStages * kC * h::kTileBytes;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * 64, bh = blockIdx.y, split = blockIdx.z;
  // this block's key tiles: its split's share of [0, ceil(T / 64)), cut at
  // the last row's causal limit
  int kt_end = (t_len + 63) / 64;
  if (causal) {
    const int kend = min(t_len, q0 + 64 + offset);
    kt_end = kend > 0 ? (kend + 63) / 64 : 0;
  }
  const int kt0 = split * tiles_per_split;
  const int n = max(0, min(kt_end, kt0 + tiles_per_split) - kt0);

  if (tid == 0) {
    h::mbar_init(&qbar, 1);
    for (int i = 0; i < kTcStages; ++i) h::mbar_init(&full[i], 1);
    h::mbar_fence_init();
  }
  __syncthreads();
  auto load_kv = [&](int j) {
    const int slot = j % kTcStages, key0 = (kt0 + j) * 64;
    h::mbar_expect_tx(&full[slot], kKVBytes);
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      h::tma_load_3d(ks + (slot * kC + c) * h::kTileBytes, &kmap, &full[slot],
                     c * 64, key0, bh);
      h::tma_load_3d(vs + (slot * kC + c) * h::kTileBytes, &vmap, &full[slot],
                     c * 64, key0, bh);
    }
  };
  if (tid == 0 && n > 0) {
    h::mbar_expect_tx(&qbar, kC * h::kTileBytes);
#pragma unroll
    for (int c = 0; c < kC; ++c)
      h::tma_load_3d(qs + c * h::kTileBytes, &qmap, &qbar, c * 64, q0, bh);
    for (int j = 0; j < min(n, kTcStages); ++j) load_kv(j);
  }

  // rows r and r + 8 of the tile belong to this thread
  const int r = warp * 16 + lane / 4, cq = 2 * (lane % 4);
  float o[kC][32];
#pragma unroll
  for (int c = 0; c < kC; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  if (n > 0) h::mbar_wait(&qbar, 0);
  for (int j = 0; j < n; ++j) {
    const int slot = j % kTcStages;
    h::mbar_wait(&full[slot], (j / kTcStages) & 1);
    const uint8_t* kt = ks + slot * kC * h::kTileBytes;
    const uint8_t* vt = vs + slot * kC * h::kTileBytes;
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk / 4) * h::kTileBytes + (kk % 4) * 32;
      h::wgmma_ss(s, h::desc_sw128(qs + off, 16, 1024),
                  h::desc_sw128(kt + off, 16, 1024), 1);
    }
    h::wgmma_commit();
    h::wgmma_wait_all();
    h::fence_regs(s);

    // scale, mask where the tile crosses the diagonal or the end of T
    const int key0 = (kt0 + j) * 64;
    const bool edge = key0 + 64 > t_len || (causal && key0 + 63 > q0 + offset);
    auto masked = [&](int i) {
      const int row = q0 + r + 8 * ((i >> 1) & 1);
      const int key = key0 + 8 * (i >> 2) + cq + (i & 1);
      return key >= t_len || (causal && key > row + offset);
    };
    float tmax[2] = {kNeg, kNeg};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = (edge && masked(i)) ? kNeg : s[i] * scale_log2;
      tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], s[i]);
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 1));
      tmax[hh] = fmaxf(tmax[hh], __shfl_xor_sync(0xffffffffu, tmax[hh], 2));
      const float m_new = fmaxf(m[hh], tmax[hh]);
      corr[hh] = exp2f(m[hh] - m_new);
      m[hh] = m_new;
      l[hh] *= corr[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const float p = (edge && masked(i)) ? 0.f : exp2f(s[i] - m[hh]);
      l[hh] += p;
      s[i] = p;
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] *= corr[(i >> 1) & 1];
    // P as bf16 A fragments: k-step kk covers keys 16 kk .. 16 kk + 15
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = h::pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
#pragma unroll
    for (int c = 0; c < kC; ++c) h::fence_regs(o[c]);
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < kC; ++c)
        h::wgmma_rs_tb(o[c], pa[kk],
                       h::desc_sw128(vt + c * h::kTileBytes + kk * 16 * 128,
                                     h::kTileBytes, 1024),
                       1);
    h::wgmma_commit();
    h::wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kC; ++c) h::fence_regs(o[c]);
    // every thread is done with this slot: refill it
    __syncthreads();
    if (tid == 0 && j + kTcStages < n) load_kv(j + kTcStages);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r + 8 * hh;
    if (row >= s_len) continue;
    const size_t base = (size_t)bh * s_len + row;
    if (splits == 1) {
      const float den = fmaxf(l[hh], 1e-20f);
      __nv_bfloat16* orow = out + base * D;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          const int col = c * 64 + 8 * g + cq;
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][4 * g + 2 * hh] / den,
                                    o[c][4 * g + 2 * hh + 1] / den);
        }
    } else {
      const size_t pbase = (size_t)split * bh_count * s_len + base;
      float* arow = ws_acc + pbase * D;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int g = 0; g < 8; ++g)
          *reinterpret_cast<float2*>(arow + c * 64 + 8 * g + cq) =
              make_float2(o[c][4 * g + 2 * hh], o[c][4 * g + 2 * hh + 1]);
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(ws_ml + 2 * pbase) =
            make_float2(m[hh], l[hh]);
    }
  }
}

// Combines the splits' (m, l, acc) partials of each row in split order:
// out = sum_s acc_s 2^(m_s - m) / max(sum_s l_s 2^(m_s - m), 1e-20), with
// m = max_s m_s (scores in log2 units).  One warp per row, each lane owning
// D / 32 columns; the split loops are unrolled so that several splits'
// loads are in flight at once.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_merge_kernel(const float* __restrict__ ws_acc,
                   const float* __restrict__ ws_ml,
                   __nv_bfloat16* __restrict__ out, int rows, int splits) {
  constexpr int kPer = D / 32;  // columns per lane: 2, 4, 6 or 8
  const int row = blockIdx.x * (kTcThreads / 32) + threadIdx.x / 32;
  const int col = (threadIdx.x % 32) * kPer;
  if (row >= rows) return;
  float mx = kNeg;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp)
    mx = fmaxf(mx, ws_ml[2 * ((size_t)sp * rows + row)]);
  float l = 0.f, a[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) a[j] = 0.f;
#pragma unroll 4
  for (int sp = 0; sp < splits; ++sp) {
    const size_t p = (size_t)sp * rows + row;
    const float2 ml = *reinterpret_cast<const float2*>(ws_ml + 2 * p);
    const float w = exp2f(ml.x - mx);
    l += ml.y * w;
#pragma unroll
    for (int j = 0; j < kPer; j += 2) {
      const float2 v =
          *reinterpret_cast<const float2*>(ws_acc + p * D + col + j);
      a[j] += v.x * w;
      a[j + 1] += v.y * w;
    }
  }
  const float den = fmaxf(l, 1e-20f);
#pragma unroll
  for (int j = 0; j < kPer; j += 2)
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * D + col + j) =
        __floats2bfloat162_rn(a[j] / den, a[j + 1] / den);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* ws_acc, void* ws_ml, int bh, int s_len, int t_len,
              int causal, int offset, float scale, int tiles_per_split,
              int splits, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)s_len, (uint64_t)bh};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)t_len, (uint64_t)bh};
  int err = repro::sm90::encode_bf16_rows(&qmap, q, 3, qdims);
  if (!err) err = repro::sm90::encode_bf16_rows(&kmap, k, 3, kdims);
  if (!err) err = repro::sm90::encode_bf16_rows(&vmap, v, 3, kdims);
  if (err) return err;
  const size_t smem = tc_smem_bytes(D);
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((s_len + 63) / 64, bh, splits);
  flash_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)out, (float*)ws_acc, (float*)ws_ml,
      bh, s_len, t_len, causal, offset, scale * kLog2e, tiles_per_split,
      splits);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int rows = bh * s_len, per_block = kTcThreads / 32;
    flash_merge_kernel<D><<<(rows + per_block - 1) / per_block, kTcThreads, 0,
                            stream>>>((const float*)ws_acc,
                                      (const float*)ws_ml,
                                      (__nv_bfloat16*)out, rows, splits);
  }
  return (int)cudaGetLastError();
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

// bf16 q, k, v, out with 16-byte aligned rows; d in {64, 128, 192, 256}.
// ws_acc (splits, bh, s, d) and ws_ml (splits, bh, s, 2) f32 are read only
// when splits > 1.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* out,
                                        void* ws_acc, void* ws_ml, int bh,
                                        int s_len, int t_len, int d,
                                        int causal, int offset, float scale,
                                        int tiles_per_split, int splits,
                                        void* stream) {
  if (splits < 1 || tiles_per_split < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (d) {
    case 64:
      return launch_tc<64>(q, k, v, out, ws_acc, ws_ml, bh, s_len, t_len,
                           causal, offset, scale, tiles_per_split, splits, st);
    case 128:
      return launch_tc<128>(q, k, v, out, ws_acc, ws_ml, bh, s_len, t_len,
                            causal, offset, scale, tiles_per_split, splits,
                            st);
    case 192:
      return launch_tc<192>(q, k, v, out, ws_acc, ws_ml, bh, s_len, t_len,
                            causal, offset, scale, tiles_per_split, splits,
                            st);
    case 256:
      return launch_tc<256>(q, k, v, out, ws_acc, ws_ml, bh, s_len, t_len,
                            causal, offset, scale, tiles_per_split, splits,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
