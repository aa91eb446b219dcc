// Paged-attention decode step: replaces repro/kernels/paged_attention.py
// `paged_decode` (Pallas, body `_kernel`).
//
// One block per (lane, kv head).  The block writes the lane's new K/V row
// into row pos % ps of logical page pos // ps (when that page lies inside
// the walk), then walks the lane's pages 0..min(pos // ps, walk - 1) with a
// flash-decode online softmax for the g = H / Kv query heads that share the
// kv head.  Scores and softmax statistics are f32 in shared memory.
//
// Bound on the H100: bytes.  A lane reads its live K/V pages once (the
// attended positions times 2 * Kv * D elements) and does 4 * H * D flops
// per position, far below the ~295 flops/byte where compute would bound.
// The design reads each live page once per (lane, kv head) with coalesced
// row loads and keeps scores out of device memory; blocks are few at decode
// batch sizes (B * Kv), so splitting the walk across blocks is the next
// step for speed.
//
// Blocks run in parallel in any order.  Free serving lanes mirror a donor's
// page-table row, so two blocks may write the same pool row: each block
// takes row `off` of page `lp` from its own k_new/v_new and never re-reads
// it from the pool, so the duplicate writes carry identical bytes and their
// order does not matter.  An undersized walk (pos // ps >= walk) writes
// nothing and attends over the truncated window.
#include "common.cuh"

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
