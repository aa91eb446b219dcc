// Paged-attention decode step: replaces repro/kernels/paged_attention.py
// `paged_decode` (Pallas, body `_kernel`).
//
// Each (lane, kv head) writes the lane's new K/V row into row pos % ps of
// logical page pos // ps (when that page lies inside the walk), then walks
// the lane's pages 0..min(pos // ps, walk - 1) with a flash-decode online
// softmax for the g = H / Kv query heads that share the kv head.  Scores
// and softmax statistics are f32.
//
// Bound on the H100: bytes.  A lane reads its live K/V pages once (the
// attended positions times 2 * Kv * D elements) and does 4 * H * D flops
// per position, far below the ~295 flops/byte where compute would bound;
// at the serve shape the whole step reads about 2.4 MB (0.7 us at
// 3.35 TB/s), so launch latency and the page walk's dependent loads set
// its time.
//
// Two kernels, picked by `paged_attention.plan` from dtype and shape:
//
// paged_split_kernel (bf16, D in {64, 128, 256}, g a power of two with
// 128 <= g * D <= 1024, ps <= 32).  Grid (B, Kv, S), the S split blocks of
// one (lane, kv head) forming a cluster: split s walks a contiguous run of
// the lane's pages, so B * Kv * S blocks share the walk where B * Kv alone
// would leave most SMs idle.  A lane's cut depends on its own page count n
// alone: its walk is cut into runs of per = ceil(n / lane_splits) pages,
// lane_splits a constant of the plan, and split s takes run s.  The grid
// holds S = min(lane_splits, the walk rounded up to a power of two)
// splits, enough for the deepest lane; a split past a lane's runs is an
// empty partial.  So a lane's output is the same whatever its co-resident
// lanes hold and whatever the walk bound (the batch's deepest lane, and a
// fused chunk's widening of it) happens to be.  Each split streams its pages' K and V rows
// (ps rows of D contiguous elements at a stride of Kv * D) into a ring of
// kSplitStages pages in shared memory with 16-byte cp.async copies, in
// bf16, so page j + 1 is in flight while page j is used.  Scores take
// D / 8 lanes per (head, key row), 8 values per lane and a shuffle sum;
// the online softmax runs one warp per head, one lane per key row; each
// thread keeps g * D / 128 accumulator elements in registers.  A split
// with no page, or whose rows are all masked, keeps m = -1e30, l = 0,
// acc = 0.  Rank 0 merges the splits' (m, l, acc) in rank order through
// distributed shared memory, divides by max(l, 1e-20) and writes o: one
// launch, no merge kernel.
//
// paged_decode_kernel (f32 and other shapes, the first port's kernel): one
// block per (lane, kv head) walks the pages serially, widening K and V to
// f32 in shared memory with 2-byte loads.
//
// Blocks run in parallel in any order.  Free serving lanes mirror a donor's
// page-table row, so two blocks may write the same pool row: the block (the
// split) that walks page pos // ps takes row `off` from its own
// k_new/v_new and never re-reads it from the pool, so the duplicate writes
// carry identical bytes and their order does not matter.  An undersized
// walk (pos // ps >= walk) writes nothing and attends over the truncated
// window.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr float kNeg = -1e30f;

template <typename T>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pages, T* v_pages,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ pos,
    T* __restrict__ out, int kv, int g, int d, int ps, int max_pages,
    int walk, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;            // (g, d)
  float* acc = qs + g * d;     // (g, d)
  float* ks = acc + g * d;     // (ps, d)
  float* vs = ks + ps * d;     // (ps, d)
  float* sc = vs + ps * d;     // (g, ps) scores, then probabilities
  float* m = sc + g * ps;      // (g,) running max
  float* l = m + g;            // (g,) running sum
  float* corr = l + g;         // (g,) this page's rescale factor

  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const int p = pos[b];
  const int lp = p / ps, off = p % ps;
  const int last = min(lp, walk - 1);
  const int32_t* pt = page_table + (size_t)b * max_pages;
  const T* kn = k_new + ((size_t)b * kv + h) * d;
  const T* vn = v_new + ((size_t)b * kv + h) * d;
  const size_t qo = ((size_t)b * kv * g + (size_t)h * g) * d;

  for (int i = tid; i < g * d; i += nt) {
    qs[i] = repro::to_f(q[qo + i]);
    acc[i] = 0.f;
  }
  for (int i = tid; i < g; i += nt) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  if (lp < walk) {
    const size_t row = (((size_t)pt[lp] * ps + off) * kv + h) * d;
    for (int c = tid; c < d; c += nt) {
      k_pages[row + c] = kn[c];
      v_pages[row + c] = vn[c];
    }
  }
  __syncthreads();

  for (int j = 0; j <= last; ++j) {
    const size_t page = (size_t)pt[j] * ps;
    for (int i = tid; i < ps * d; i += nt) {
      const int r = i / d, c = i - r * d;
      if (j == lp && r == off) {
        ks[i] = repro::to_f(kn[c]);
        vs[i] = repro::to_f(vn[c]);
      } else {
        const size_t a = ((page + r) * kv + h) * d + c;
        ks[i] = repro::to_f(k_pages[a]);
        vs[i] = repro::to_f(v_pages[a]);
      }
    }
    __syncthreads();
    for (int pr = warp; pr < g * ps; pr += nw) {
      const int hi = pr / ps, r = pr - hi * ps;
      float s = 0.f;
      for (int c = lane; c < d; c += 32) s += qs[hi * d + c] * ks[r * d + c];
      s = repro::warp_sum(s);
      if (lane == 0) {
        const int t = j * ps + r;
        const bool valid = t <= p && (window <= 0 || t > p - window);
        sc[pr] = valid ? s * scale : kNeg;
      }
    }
    __syncthreads();
    for (int hi = tid; hi < g; hi += nt) {
      const float mp = m[hi];
      float mx = mp;
      for (int r = 0; r < ps; ++r) mx = fmaxf(mx, sc[hi * ps + r]);
      float sum = 0.f;
      for (int r = 0; r < ps; ++r) {
        const int t = j * ps + r;
        const bool valid = t <= p && (window <= 0 || t > p - window);
        const float e = valid ? expf(sc[hi * ps + r] - mx) : 0.f;
        sc[hi * ps + r] = e;
        sum += e;
      }
      const float cr = expf(mp - mx);
      l[hi] = l[hi] * cr + sum;
      m[hi] = mx;
      corr[hi] = cr;
    }
    __syncthreads();
    for (int i = tid; i < g * d; i += nt) {
      const int hi = i / d, c = i - hi * d;
      float a = acc[i] * corr[hi];
      for (int r = 0; r < ps; ++r) a += sc[hi * ps + r] * vs[r * d + c];
      acc[i] = a;
    }
    __syncthreads();
  }
  for (int i = tid; i < g * d; i += nt)
    out[qo + i] = repro::from_f<T>(acc[i] / fmaxf(l[i / d], 1e-20f));
}

}  // namespace

extern "C" int repro_paged_decode(int dtype, const void* q, const void* k_new,
                                  const void* v_new, void* k_pages,
                                  void* v_pages, const void* page_table,
                                  const void* pos, void* out, int b, int kv,
                                  int g, int d, int ps, int max_pages,
                                  int walk, int window, float scale,
                                  int threads, int smem_bytes, void* stream) {
  REPRO_DISPATCH(dtype, {
    paged_decode_kernel<T><<<dim3(b, kv), threads, smem_bytes,
                             (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pages,
        (T*)v_pages, (const int32_t*)page_table, (const int32_t*)pos,
        (T*)out, kv, g, d, ps, max_pages, walk, window, scale);
  });
  return (int)cudaGetLastError();
}

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kSplitThreads = 128;
constexpr int kSplitStages = 3;   // pages in flight per split
constexpr int kMaxEpt = 8;        // accumulator elements a thread: g * D / 128

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int D>
__global__ void __launch_bounds__(kSplitThreads) paged_split_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_new,
    const bf16* __restrict__ v_new, bf16* k_pages, bf16* v_pages,
    const int32_t* __restrict__ page_table, const int32_t* __restrict__ pos,
    bf16* __restrict__ out, int kv, int g, int ps, int max_pages, int walk,
    int window, float scale, int lane_splits) {
  constexpr int kChunks = D / 8;       // 16-byte chunks of a row
  constexpr int kPairs = 32 / kChunks;  // (head, key row) pairs a warp
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // shared memory: the page ring (stage, K | V, ps, D) in bf16, then in
  // f32 q (g, D), this split's acc (g, D), the score tile (g, ps) and the
  // per-head m, l and this page's rescale factor
  bf16* ring = reinterpret_cast<bf16*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw +
                                      (size_t)kSplitStages * 2 * ps * D * 2);
  float* accs = qs + g * D;
  float* sc = accs + g * D;
  float* ms = sc + g * ps;
  float* ls = ms + g;
  float* corr = ls + g;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = pos[b], lp = p / ps, off = p - lp * ps;
  const int n = min(lp, walk - 1) + 1;   // pages the lane walks
  const int per = (n + lane_splits - 1) / lane_splits;  // the lane's own cut
  const int j0 = min(n, split * per), j1 = min(n, j0 + per);
  const int32_t* pt = page_table + (size_t)b * max_pages;
  const bf16* kn = k_new + ((size_t)b * kv + h) * D;
  const bf16* vn = v_new + ((size_t)b * kv + h) * D;
  const size_t qo = ((size_t)b * kv + h) * g * D;

  if (lp < walk && j0 <= lp && lp < j1) {  // this split walks the write page
    const size_t row = (((size_t)pt[lp] * ps + off) * kv + h) * D;
    for (int c = tid; c < 2 * kChunks; c += kSplitThreads) {
      const int m = c / kChunks, cc = c - m * kChunks;
      reinterpret_cast<uint4*>((m ? v_pages : k_pages) + row)[cc] =
          reinterpret_cast<const uint4*>(m ? vn : kn)[cc];
    }
  }
  for (int i = tid; i < g * D; i += kSplitThreads)
    qs[i] = __bfloat162float(q[qo + i]);
  if (tid < g) {
    ms[tid] = kNeg;
    ls[tid] = 0.f;
  }

  // page j's K and V rows into ring slot `slot`; row `off` of the write
  // page comes from k_new / v_new
  auto load_page = [&](int j, int slot) {
    const size_t page = (size_t)pt[j] * ps;
    for (int e = tid; e < 2 * ps * kChunks; e += kSplitThreads) {
      const int m = e / (ps * kChunks), rem = e - m * ps * kChunks;
      const int r = rem / kChunks, cc = rem - r * kChunks;
      const bf16* src =
          (j == lp && r == off)
              ? (m ? vn : kn) + cc * 8
              : (m ? v_pages : k_pages) + ((page + r) * kv + h) * D + cc * 8;
      repro::sm90::cp_async16(
          ring + ((size_t)(slot * 2 + m) * ps + r) * D + cc * 8, src);
    }
  };
  const int npg = j1 - j0;
#pragma unroll
  for (int i = 0; i < kSplitStages - 1; ++i) {
    if (i < npg) load_page(j0 + i, i);
    repro::sm90::cp_async_commit();
  }

  const int ept = g * D / kSplitThreads;
  const int e0 = tid * ept, hi_t = e0 / D, c0 = e0 - hi_t * D;
  float acc[kMaxEpt];
#pragma unroll
  for (int i = 0; i < kMaxEpt; ++i) acc[i] = 0.f;
  const int npairs = g * ps;
  for (int i = 0; i < npg; ++i) {
    const int j = j0 + i, nx = i + kSplitStages - 1;
    if (nx < npg) load_page(j0 + nx, nx % kSplitStages);
    repro::sm90::cp_async_commit();
    repro::sm90::cp_async_wait<kSplitStages - 1>();
    __syncthreads();  // page j has landed, from every thread's copies
    const bf16* ks = ring + (size_t)(i % kSplitStages) * 2 * ps * D;
    const bf16* vs = ks + ps * D;
    // scores: kChunks lanes per (head, key row) pair
    for (int base = 0; base < npairs; base += (kSplitThreads / 32) * kPairs) {
      const int pr = base + warp * kPairs + lane / kChunks;
      const int cc = lane % kChunks;
      float dot = 0.f;
      if (pr < npairs) {
        const int hi = pr / ps, r = pr - hi * ps;
        float kf[8];
        repro::sm90::bf16x8_to_f32(
            *reinterpret_cast<const uint4*>(ks + r * D + cc * 8), kf);
        const float* qr = qs + hi * D + cc * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e) dot = fmaf(qr[e], kf[e], dot);
      }
#pragma unroll
      for (int o = kChunks / 2; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (pr < npairs && cc == 0) {
        const int t = j * ps + pr % ps;
        const bool valid = t <= p && (window <= 0 || t > p - window);
        sc[pr] = valid ? dot * scale : kNeg;
      }
    }
    __syncthreads();
    // online softmax: a warp per head, a lane per key row
    for (int hi = warp; hi < g; hi += kSplitThreads / 32) {
      const int t = j * ps + lane;
      const bool valid =
          lane < ps && t <= p && (window <= 0 || t > p - window);
      const float sv = lane < ps ? sc[hi * ps + lane] : kNeg;
      const float m_old = ms[hi];
      const float mx = fmaxf(m_old, warp_max(sv));
      const float e = valid ? expf(sv - mx) : 0.f;
      const float sum = repro::warp_sum(e);
      if (lane < ps) sc[hi * ps + lane] = e;
      if (lane == 0) {
        const float cr = expf(m_old - mx);
        corr[hi] = cr;
        ls[hi] = ls[hi] * cr + sum;
        ms[hi] = mx;
      }
    }
    __syncthreads();
    const float cr = corr[hi_t];
#pragma unroll
    for (int e = 0; e < kMaxEpt; ++e)
      if (e < ept) acc[e] *= cr;
    for (int r = 0; r < ps; ++r) {
      const float pv = sc[hi_t * ps + r];
      const bf16* vr = vs + r * D + c0;
#pragma unroll
      for (int e = 0; e < kMaxEpt; ++e)
        if (e < ept) acc[e] = fmaf(pv, __bfloat162float(vr[e]), acc[e]);
    }
    __syncthreads();  // the slot and the score tile are rewritten next
  }
#pragma unroll
  for (int e = 0; e < kMaxEpt; ++e)
    if (e < ept) accs[e0 + e] = acc[e];

  cg::cluster_group cl = cg::this_cluster();
  if (splits > 1) cl.sync();  // every split's (m, l, acc) is in place
  else __syncthreads();
  if (split == 0) {
    float mx = kNeg;
#pragma unroll 8
    for (int s = 0; s < splits; ++s)
      mx = fmaxf(mx, (s ? cl.map_shared_rank(ms, s) : ms)[hi_t]);
    float l = 0.f, a[kMaxEpt] = {};
#pragma unroll 8
    for (int s = 0; s < splits; ++s) {
      const float* qs_s = s ? cl.map_shared_rank(qs, s) : qs;
      const float* acc_s = qs_s + g * D;
      const float* m_s = acc_s + g * D + g * ps;
      const float w = expf(m_s[hi_t] - mx);
      l += m_s[g + hi_t] * w;
#pragma unroll
      for (int e = 0; e < kMaxEpt; ++e)
        if (e < ept) a[e] += acc_s[e0 + e] * w;
    }
#pragma unroll
    for (int e = 0; e < kMaxEpt; ++e)
      if (e < ept)
        out[qo + e0 + e] = __float2bfloat16_rn(a[e] / fmaxf(l, 1e-20f));
  }
  if (splits > 1) cl.sync();  // rank 0 has read the other splits
}

template <int D>
int paged_split(const void* q, const void* k_new, const void* v_new,
                void* k_pages, void* v_pages, const void* page_table,
                const void* pos, void* out, int b, int kv, int g, int ps,
                int max_pages, int walk, int window, float scale,
                int lane_splits, cudaStream_t stream) {
  const size_t smem = (size_t)kSplitStages * 2 * ps * D * 2 +
                      4 * ((size_t)2 * g * D + g * ps + 3 * g);
  int splits = 1;  // the walk rounded up to a power of two, at most lane_splits
  while (splits < walk && splits < lane_splits) splits *= 2;
  if (splits > lane_splits) splits = lane_splits;
  const cudaError_t e = repro::sm90::launch_cluster(
      paged_split_kernel<D>, dim3(b, kv, splits), kSplitThreads,
      dim3(1, 1, splits), smem, stream, (const bf16*)q, (const bf16*)k_new,
      (const bf16*)v_new, (bf16*)k_pages, (bf16*)v_pages,
      (const int32_t*)page_table, (const int32_t*)pos, (bf16*)out, kv, g, ps,
      max_pages, walk, window, scale, lane_splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The split kernel, bf16 only: each lane's walk cut into `splits` runs of
// ceil(n / splits) of its n pages, one block per run, in a grid of
// min(splits, the walk rounded up to a power of two) blocks per (lane, kv
// head).
extern "C" int repro_paged_decode_split(
    const void* q, const void* k_new, const void* v_new, void* k_pages,
    void* v_pages, const void* page_table, const void* pos, void* out, int b,
    int kv, int g, int d, int ps, int max_pages, int walk, int window,
    float scale, int splits, void* stream) {
  if (b < 1 || kv < 1 || g < 1 || (g & (g - 1)) || g * d < kSplitThreads ||
      g * d > kSplitThreads * kMaxEpt || ps < 1 || ps > 32 || walk < 1 ||
      walk > max_pages || splits < 1 || splits > 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (d) {
    case 64: return paged_split<64>(q, k_new, v_new, k_pages, v_pages,
                                    page_table, pos, out, b, kv, g, ps,
                                    max_pages, walk, window, scale, splits, s);
    case 128: return paged_split<128>(q, k_new, v_new, k_pages, v_pages,
                                      page_table, pos, out, b, kv, g, ps,
                                      max_pages, walk, window, scale, splits,
                                      s);
    case 256: return paged_split<256>(q, k_new, v_new, k_pages, v_pages,
                                      page_table, pos, out, b, kv, g, ps,
                                      max_pages, walk, window, scale, splits,
                                      s);
    default: return (int)cudaErrorInvalidValue;
  }
}
