// DRS search kernels: replace repro/kernels/drs_search.py `drs_project` and
// `drs_scores` (Pallas).
//
// drs_project: f(X) = X @ R^T, x (M, d), r (k, d) -> (M, k) in x's dtype,
// f32 accumulation, rounded once.  Bound on the H100: bytes at the main
// path's shapes (R is 256 x 2048, 1 MB, and M is a prompt bucket of at
// most 256 or the lane count, so 2 * M * k * d flops stay below the
// tensor cores' flop-to-byte balance).  Three kernels, chosen by the
// wrapper from dtype and shape:
//
// - project_gemv_kernel (bf16, M <= 16: the refresh step, M = 4 lanes):
//   a bytes-bound GEMV.  x's M rows (at most 64 KB) come into shared
//   memory once per block by one bulk asynchronous copy on an mbarrier,
//   while each warp already loads its R row with 16-byte loads.  One warp
//   reduces one R row (one output column), or a fixed share of it where k
//   alone gives fewer than 128 warps; each lane keeps M f32 sums, reduced
//   by warp shuffles and then across the row's shares in a fixed order.
// - project_tc_kernel (bf16, M > 16: admission, M = the prompt bucket):
//   wgmma tiles.  x and R are both K-major as stored, so 64 x 64 boxes of
//   each come into shared memory by TMA (128-byte swizzle) through a ring
//   of mbarrier stages, and wgmma m64n64k16 runs with both operands in
//   shared memory.  With few output tiles (12 at M = 192, k = 256), d is
//   split across blocks until tiles x splits fill the SMs; the f32
//   partials go to a workspace and project_merge_kernel sums them in split
//   order and rounds once, so results are the same bit for bit from run to
//   run.
// - project_kernel (f32, or rows that are not 16-byte aligned): a
//   16 x 16 shared-memory SIMT tile; any M, k and d (ragged edges masked).
//
// drs_scores: relu(fx @ fw) summed over each `block`-wide group, fx (M, k),
// fw (k, F) -> (M, F / block) f32.  Bound on the H100: bytes (fw, 4 MB at
// the serve shape, read once; 2 * M * k * F flops stay below the tensor
// cores' balance at M <= 256).  Three kernels, chosen by
// `drs_search.scores_plan` from dtype and shape:
//
// - scores_gemv_kernel (bf16, M <= 16: the refresh step): fw streamed
//   once with 16-byte loads, each group's columns split across a cluster
//   so that the blocks fill the SMs; the k sum is complete before the ReLU
//   and rank 0 sums the slices' partial group sums in rank order.
// - scores_tc_kernel (bf16, M > 16: admission): wgmma with fx K-major and
//   fw's 128-column slab MN-major, both by TMA, ReLU and group sums on the
//   accumulator fragments, one f32 per (row, group) stored.
// - scores_kernel (f32, or groups the bf16 kernels do not tile): one block
//   per (row tile of at most 16, group), a serial dot a thread.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

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


// ---- bf16 GEMV (M <= 16) ---------------------------------------------
constexpr int kGemvMaxM = 16;
constexpr int kGemvWarps = 4;

__device__ __forceinline__ float dot8(uint4 a, uint4 b) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), v = __bfloat1622float2(y[i]);
    s = fmaf(u.x, v.x, s);
    s = fmaf(u.y, v.y, s);
  }
  return s;
}

// Block: kGemvWarps warps; warp w reduces share w % shares of R row
// blockIdx.x * (kGemvWarps / shares) + w / shares over d's 8-wide chunks.
// M is a template parameter: loops over a runtime M <= 16 with predicated
// bodies measured three times slower on the H100 (PERF.md).
template <int M>
__global__ void __launch_bounds__(kGemvWarps * 32)
project_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ r,
                    __nv_bfloat16* __restrict__ out, int k, int d,
                    int shares) {
  namespace h = repro::sm90;
  extern __shared__ __align__(16) uint8_t xs_raw[];
  __shared__ uint64_t bar;
  __shared__ float part[kGemvWarps][M];
  const uint4* xs = reinterpret_cast<const uint4*>(xs_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    h::mbar_init(&bar, 1);
    h::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = (uint32_t)M * d * 2;
    h::mbar_expect_tx(&bar, bytes);
    h::bulk_load(xs_raw, x, bytes, &bar);
  }
  const int row = blockIdx.x * (kGemvWarps / shares) + warp / shares;
  const int share = warp % shares, chunks = d / 8;
  const int per = (chunks + shares - 1) / shares;
  const int c0 = share * per, c1 = min(chunks, c0 + per);
  const uint4* rrow =
      reinterpret_cast<const uint4*>(r + (size_t)min(row, k - 1) * d);
  // the first loads of R go out before x has arrived
  constexpr int kAhead = 8;
  uint4 rv[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    const int c = c0 + lane + 32 * u;
    rv[u] = c < c1 ? __ldg(rrow + c) : make_uint4(0, 0, 0, 0);
  }
  float acc[M];
#pragma unroll
  for (int i = 0; i < M; ++i) acc[i] = 0.f;
  h::mbar_wait(&bar, 0);
  for (int base = c0; base < c1; base += 32 * kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = base + lane + 32 * u;
      if (c < c1) {
#pragma unroll
        for (int i = 0; i < M; ++i)
          acc[i] += dot8(rv[u], xs[(size_t)i * chunks + c]);
      }
      const int nxt = c + 32 * kAhead;
      if (nxt < c1) rv[u] = __ldg(rrow + nxt);
    }
  }
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const float v = repro::warp_sum(acc[i]);
    if (lane == 0) part[warp][i] = v;
  }
  __syncthreads();
  if (share == 0 && row < k && lane < M) {
    float v = 0.f;
    for (int sh = 0; sh < shares; ++sh) v += part[warp + sh][lane];
    out[(size_t)lane * k + row] = __float2bfloat16_rn(v);
  }
}

template <int M>
int launch_gemv(const void* x, const void* r, void* out, int k, int d,
                int shares, cudaStream_t stream) {
  const int smem = M * d * 2;
  cudaError_t e = cudaFuncSetAttribute(
      project_gemv_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int rows_per_block = kGemvWarps / shares;
  project_gemv_kernel<M><<<(k + rows_per_block - 1) / rows_per_block,
                           kGemvWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)r, (__nv_bfloat16*)out,
      k, d, shares);
  return (int)cudaGetLastError();
}

typedef int (*GemvLaunch)(const void*, const void*, void*, int, int, int,
                          cudaStream_t);
constexpr GemvLaunch kGemvLaunch[kGemvMaxM] = {
    launch_gemv<1>,  launch_gemv<2>,  launch_gemv<3>,  launch_gemv<4>,
    launch_gemv<5>,  launch_gemv<6>,  launch_gemv<7>,  launch_gemv<8>,
    launch_gemv<9>,  launch_gemv<10>, launch_gemv<11>, launch_gemv<12>,
    launch_gemv<13>, launch_gemv<14>, launch_gemv<15>, launch_gemv<16>};

// ---- bf16 wgmma tiles (M > 16) ---------------------------------------
constexpr int kTcStages = 4;

// Block (n tile, m tile, split): the 64 x 64 output tile's sum over the
// split's 64-wide chunks of d.
__global__ void __launch_bounds__(128)
project_tc_kernel(const __grid_constant__ CUtensorMap xmap,
                  const __grid_constant__ CUtensorMap rmap,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
                  int m, int k, int d, int chunks_per_split, int splits) {
  namespace h = repro::sm90;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kTcStages];
  uint8_t* xs = h::align1024(smem_raw);
  uint8_t* rs = xs + kTcStages * h::kTileBytes;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * 64, m0 = blockIdx.y * 64, split = blockIdx.z;
  const int kc0 = split * chunks_per_split;
  const int n = max(0, min((d + 63) / 64, kc0 + chunks_per_split) - kc0);
  if (tid == 0) {
    for (int i = 0; i < kTcStages; ++i) h::mbar_init(&full[i], 1);
    h::mbar_fence_init();
  }
  __syncthreads();
  auto load = [&](int j) {
    const int slot = j % kTcStages, col = (kc0 + j) * 64;
    h::mbar_expect_tx(&full[slot], 2 * h::kTileBytes);
    h::tma_load_2d(xs + slot * h::kTileBytes, &xmap, &full[slot], col, m0);
    h::tma_load_2d(rs + slot * h::kTileBytes, &rmap, &full[slot], col, n0);
  };
  if (tid == 0)
    for (int j = 0; j < min(n, kTcStages); ++j) load(j);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const int slot = j % kTcStages;
    h::mbar_wait(&full[slot], (j / kTcStages) & 1);
    h::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      h::wgmma_ss(acc,
                  h::desc_sw128(xs + slot * h::kTileBytes + kk * 32, 16, 1024),
                  h::desc_sw128(rs + slot * h::kTileBytes + kk * 32, 16, 1024),
                  1);
    h::wgmma_commit();
    h::wgmma_wait_all();
    h::fence_regs(acc);
    __syncthreads();
    if (tid == 0 && j + kTcStages < n) load(j + kTcStages);
  }
  const int r = warp * 16 + lane / 4, cq = 2 * (lane % 4);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + r + 8 * hh;
    if (row >= m) continue;
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      const int col = n0 + 8 * g + cq;
      const float a0 = acc[4 * g + 2 * hh], a1 = acc[4 * g + 2 * hh + 1];
      if (splits == 1) {
        if (col < k) out[(size_t)row * k + col] = __float2bfloat16_rn(a0);
        if (col + 1 < k)
          out[(size_t)row * k + col + 1] = __float2bfloat16_rn(a1);
      } else {
        float* w = ws + ((size_t)split * m + row) * k;
        if (col + 1 < k && k % 2 == 0) {
          *reinterpret_cast<float2*>(w + col) = make_float2(a0, a1);
        } else {
          if (col < k) w[col] = a0;
          if (col + 1 < k) w[col + 1] = a1;
        }
      }
    }
  }
}

// out[i] = round(sum over splits, in order, of ws[s][i]); four outputs a
// thread where count is a multiple of 4, the split loop unrolled so that
// several splits' loads are in flight at once.
__global__ void project_merge_kernel(const float* __restrict__ ws,
                                     __nv_bfloat16* __restrict__ out,
                                     int count, int splits) {
  const int i = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (i >= count) return;
  if (count % 4 == 0) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int sp = 0; sp < splits; ++sp) {
      const float4 p =
          *reinterpret_cast<const float4*>(ws + (size_t)sp * count + i);
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    *reinterpret_cast<__nv_bfloat162*>(out + i) =
        __floats2bfloat162_rn(v.x, v.y);
    *reinterpret_cast<__nv_bfloat162*>(out + i + 2) =
        __floats2bfloat162_rn(v.z, v.w);
    return;
  }
  for (int j = i; j < min(count, i + 4); ++j) {
    float v = 0.f;
    for (int sp = 0; sp < splits; ++sp) v += ws[(size_t)sp * count + j];
    out[j] = __float2bfloat16_rn(v);
  }
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

// ---- drs_scores, bf16 GEMV (M <= 16: the refresh step) -------------------
constexpr int kScoresThreads = 128;

// Block (slice s, group g), clusters of `slices` blocks along x: the block
// computes fx . fw over all of k for `width` = block / slices adjacent
// columns of group g, each thread 8 adjacent columns (one 16-byte load a
// row of fw) for rows ph, ph + phases, ... of k, with M x 8 f32 sums.  The
// sums over k are complete before the ReLU: a warp-shuffle tree over the
// warp's row phases, then the four warps in order through shared memory.
// Then ReLU, the slice's column sum of each row (a warp per row: strided
// loads in column order and a shuffle tree), and rank 0 sums the slices'
// partial group sums in rank order through distributed shared memory (a
// column split may be summed after the ReLU, which is per element).
template <int M>
__global__ void __launch_bounds__(kScoresThreads)
scores_gemv_kernel(const __nv_bfloat16* __restrict__ fx,
                   const __nv_bfloat16* __restrict__ fw,
                   float* __restrict__ out, int k, int f, int block,
                   int slices) {
  namespace h = repro::sm90;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ uint64_t bar;
  __shared__ float part[M];
  const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw + (size_t)M * k * 2);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int width = block / slices, cpr = width / 8;
  const int phases = kScoresThreads / cpr;
  const int s = blockIdx.x, g = blockIdx.y, groups = f / block;
  const int c = tid % cpr, ph = tid / cpr;
  if (tid == 0) {
    h::mbar_init(&bar, 1);
    h::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bytes = (uint32_t)M * k * 2;
    h::mbar_expect_tx(&bar, bytes);
    h::bulk_load(smem_raw, fx, bytes, &bar);
  }
  const size_t ld = (size_t)f / 8;  // a row of fw in 16-byte chunks
  const uint4* w = reinterpret_cast<const uint4*>(fw) +
                   ((size_t)g * block + s * width) / 8 + c;
  const int n = ph < k ? (k - ph + phases - 1) / phases : 0;
  // the first loads of fw go out before fx has arrived
  constexpr int kAhead = 8;
  uint4 wv[kAhead];
#pragma unroll
  for (int u = 0; u < kAhead; ++u)
    wv[u] = u < n ? __ldg(w + (size_t)(ph + u * phases) * ld)
                  : make_uint4(0, 0, 0, 0);
  float acc[M][8];
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  h::mbar_wait(&bar, 0);
  for (int base = 0; base < n; base += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int i = base + u;
      if (i < n) {
        const int row = ph + i * phases;
        float wf[8];
        h::bf16x8_to_f32(wv[u], wf);
#pragma unroll
        for (int r = 0; r < M; ++r) {
          const float xv = __bfloat162float(xs[r * k + row]);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv, wf[j], acc[r][j]);
        }
      }
      const int nxt = i + kAhead;
      if (nxt < n) wv[u] = __ldg(w + (size_t)(ph + nxt * phases) * ld);
    }
  }
  // the warp's row phases: lanes c + cpr * p hold column chunk c
  for (int o = cpr; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[r][j] += __shfl_xor_sync(0xffffffffu, acc[r][j], o);
  if (lane < cpr)
#pragma unroll
    for (int r = 0; r < M; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        red[(warp * M + r) * width + c * 8 + j] = acc[r][j];
  __syncthreads();
  constexpr int kWarps = kScoresThreads / 32;
  for (int o = tid; o < M * width; o += kScoresThreads) {
    float v = red[o];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) v += red[q * M * width + o];
    red[o] = fmaxf(v, 0.f);
  }
  __syncthreads();
  for (int r = warp; r < M; r += kWarps) {
    float v = 0.f;
    for (int col = lane; col < width; col += 32) v += red[r * width + col];
    v = repro::warp_sum(v);
    if (lane == 0) part[r] = v;
  }
  cg::cluster_group cl = cg::this_cluster();
  if (slices > 1) cl.sync();  // every slice's sums are in its shared memory
  else __syncthreads();
  if (s == 0 && tid < M) {
    float v = 0.f;
    for (int q = 0; q < slices; ++q)
      v += (q ? cl.map_shared_rank(part, q) : part)[tid];
    out[(size_t)tid * groups + g] = v;
  }
  if (slices > 1) cl.sync();  // rank 0 has read the other slices' sums
}

template <int M>
int launch_scores_gemv(const void* fx, const void* fw, void* out, int k,
                       int f, int block, int slices, cudaStream_t stream) {
  const size_t smem = (size_t)M * k * 2 +
                      (size_t)(kScoresThreads / 32) * M * (block / slices) * 4;
  return (int)repro::sm90::launch_cluster(
      scores_gemv_kernel<M>, dim3(slices, f / block), kScoresThreads,
      dim3(slices, 1, 1), smem, stream, (const __nv_bfloat16*)fx,
      (const __nv_bfloat16*)fw, (float*)out, k, f, block, slices);
}

typedef int (*ScoresGemvLaunch)(const void*, const void*, void*, int, int,
                                int, int, cudaStream_t);
constexpr ScoresGemvLaunch kScoresGemvLaunch[kGemvMaxM] = {
    launch_scores_gemv<1>,  launch_scores_gemv<2>,  launch_scores_gemv<3>,
    launch_scores_gemv<4>,  launch_scores_gemv<5>,  launch_scores_gemv<6>,
    launch_scores_gemv<7>,  launch_scores_gemv<8>,  launch_scores_gemv<9>,
    launch_scores_gemv<10>, launch_scores_gemv<11>, launch_scores_gemv<12>,
    launch_scores_gemv<13>, launch_scores_gemv<14>, launch_scores_gemv<15>,
    launch_scores_gemv<16>};

// ---- drs_scores, bf16 wgmma tiles (M > 16: admission) ---------------------
// Block (128-column tile n, run y of `per` 64-row tiles): fw's (k x 128)
// slab of the tile comes into shared memory once by TMA, as MN-major B
// tiles (64 k rows of 64 columns, 128-byte swizzle), and stays there while
// the block walks its row tiles; each 64 x k tile of fx, the K-major A
// operand, comes by TMA through two stages (one where the block has one
// tile, so that two blocks fit on an SM), so the next tile loads under this
// one's products.  wgmma m64n64k16 twice a K step (the two 64-column
// halves) into f32 accumulators; ReLU on the fragments; each thread sums
// its values of a group's columns in register order, then the quad
// (shuffles xor 1, 2), and one f32 per (row, group) is stored.  Groups of
// BLK in {8, 16, 32, 64, 128} columns tile the 128 exactly.  Ragged M and
// k are zero-filled by TMA (a zero row or k step adds nothing); rows past
// M are not stored.
constexpr int kScoresTile = 128;

template <int BLK>
__global__ void __launch_bounds__(128)
scores_tc_kernel(const __grid_constant__ CUtensorMap fxmap,
                 const __grid_constant__ CUtensorMap fwmap,
                 float* __restrict__ out, int m, int k, int f, int per) {
  namespace h = repro::sm90;
  constexpr int kG = kScoresTile / BLK;  // groups of the column tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t wbar, full[2];
  const int kc = (k + 63) / 64;
  uint8_t* ws = h::align1024(smem_raw);        // (kc, 2) fw tiles
  uint8_t* xs = ws + 2 * kc * h::kTileBytes;   // (stages, kc) fx tiles
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * kScoresTile, mt = (m + 63) / 64;
  const int stages = min(2, per);
  const int t0 = blockIdx.y * per, nt = max(0, min(mt, t0 + per) - t0);
  if (nt == 0) return;  // uniform across the block
  if (tid == 0) {
    h::mbar_init(&wbar, 1);
    h::mbar_init(&full[0], 1);
    h::mbar_init(&full[1], 1);
    h::mbar_fence_init();
  }
  __syncthreads();
  auto load_x = [&](int j) {
    const int slot = j % stages;
    h::mbar_expect_tx(&full[slot], kc * h::kTileBytes);
    for (int i = 0; i < kc; ++i)
      h::tma_load_2d(xs + (slot * kc + i) * h::kTileBytes, &fxmap,
                     &full[slot], i * 64, (t0 + j) * 64);
  };
  if (tid == 0) {
    h::mbar_expect_tx(&wbar, 2 * kc * h::kTileBytes);
    for (int i = 0; i < kc; ++i)
      for (int hn = 0; hn < 2; ++hn)
        h::tma_load_2d(ws + (2 * i + hn) * h::kTileBytes, &fwmap, &wbar,
                       n0 + 64 * hn, i * 64);
    for (int j = 0; j < min(nt, stages); ++j) load_x(j);
  }
  const int groups = f / BLK, g0 = n0 / BLK;
  const int r = warp * 16 + lane / 4;
  h::mbar_wait(&wbar, 0);
  for (int j = 0; j < nt; ++j) {
    const int slot = j % stages;
    h::mbar_wait(&full[slot], (j / stages) & 1);
    float a0[32], a1[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) a0[i] = a1[i] = 0.f;
    h::wgmma_fence();
    for (int i = 0; i < kc; ++i) {
      const uint8_t* xt = xs + (slot * kc + i) * h::kTileBytes;
      const uint8_t* wt = ws + 2 * i * h::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = h::desc_k(xt, kk);
        h::wgmma_ss_tb(a0, da, h::desc_mn(wt, kk), 1);
        h::wgmma_ss_tb(a1, da, h::desc_mn(wt + h::kTileBytes, kk), 1);
      }
    }
    h::wgmma_commit();
    h::wgmma_wait_all();
    h::fence_regs(a0);
    h::fence_regs(a1);
    __syncthreads();  // every thread is done with this stage: refill it
    if (tid == 0 && j + stages < nt) load_x(j + stages);
    // accumulator i of half hn: row r + 8 ((i >> 1) & 1), column
    // 64 hn + 8 (i / 4) + 2 (lane % 4) + (i % 2), in group
    // (64 hn + 8 (i / 4)) / BLK since BLK is a multiple of 8
    float sum[2][kG];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < kG; ++q) sum[hh][q] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      sum[(i >> 1) & 1][(8 * (i / 4)) / BLK] += fmaxf(a0[i], 0.f);
      sum[(i >> 1) & 1][(64 + 8 * (i / 4)) / BLK] += fmaxf(a1[i], 0.f);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int q = 0; q < kG; ++q) {
        sum[hh][q] += __shfl_xor_sync(0xffffffffu, sum[hh][q], 1);
        sum[hh][q] += __shfl_xor_sync(0xffffffffu, sum[hh][q], 2);
      }
    if (lane % 4 == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = (t0 + j) * 64 + r + 8 * hh;
        if (row >= m) continue;
#pragma unroll
        for (int q = 0; q < kG; ++q)
          if (g0 + q < groups) out[(size_t)row * groups + g0 + q] = sum[hh][q];
      }
    }
  }
}

template <int BLK>
int launch_scores_tc(const void* fx, const void* fw, void* out, int m, int k,
                     int f, int per, cudaStream_t stream) {
  CUtensorMap fxmap, fwmap;
  const uint64_t xdims[2] = {(uint64_t)k, (uint64_t)m};
  const uint64_t wdims[2] = {(uint64_t)f, (uint64_t)k};
  int err = repro::sm90::encode_bf16_rows(&fxmap, fx, 2, xdims);
  if (!err) err = repro::sm90::encode_bf16_rows(&fwmap, fw, 2, wdims);
  if (err) return err;
  const int kc = (k + 63) / 64, mt = (m + 63) / 64;
  const size_t smem =
      (size_t)(2 + (per < 2 ? per : 2)) * kc * repro::sm90::kTileBytes + 1024;
  const dim3 grid((f + kScoresTile - 1) / kScoresTile, (mt + per - 1) / per);
  return (int)repro::sm90::launch_cluster(scores_tc_kernel<BLK>, grid, 128,
                                          dim3(1, 1, 1), smem, stream, fxmap,
                                          fwmap, (float*)out, m, k, f, per);
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

// bf16, x (m, d) with m <= 16 and m * d * 2 bytes of shared memory,
// 16-byte aligned rows (d % 8 == 0); shares in {1, 2, 4}.
extern "C" int repro_drs_project_gemv(const void* x, const void* r, void* out,
                                      int m, int k, int d, int shares,
                                      void* stream) {
  if (m < 1 || m > kGemvMaxM || d % 8 || kGemvWarps % shares)
    return (int)cudaErrorInvalidValue;
  return kGemvLaunch[m - 1](x, r, out, k, d, shares, (cudaStream_t)stream);
}

// bf16, 16-byte aligned rows (d % 8 == 0); ws (splits, m, k) f32 is used
// only when splits > 1.
extern "C" int repro_drs_project_tc(const void* x, const void* r, void* out,
                                    void* ws, int m, int k, int d,
                                    int chunks_per_split, int splits,
                                    void* stream) {
  if (d % 8 || splits < 1 || chunks_per_split < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, rmap;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)m};
  const uint64_t rdims[2] = {(uint64_t)d, (uint64_t)k};
  int err = repro::sm90::encode_bf16_rows(&xmap, x, 2, xdims);
  if (!err) err = repro::sm90::encode_bf16_rows(&rmap, r, 2, rdims);
  if (err) return err;
  const int smem = 2 * kTcStages * repro::sm90::kTileBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      project_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((k + 63) / 64, (m + 63) / 64, splits);
  project_tc_kernel<<<grid, 128, smem, st>>>(xmap, rmap, (__nv_bfloat16*)out,
                                             (float*)ws, m, k, d,
                                             chunks_per_split, splits);
  if (splits > 1) {
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int count = m * k, threads = (count + 3) / 4;
    project_merge_kernel<<<(threads + 255) / 256, 256, 0, st>>>(
        (const float*)ws, (__nv_bfloat16*)out, count, splits);
  }
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

// bf16, fx (m, k) with m <= 16, k % 8 == 0, f % 8 == 0, 16-byte aligned
// bases; `slices` (1, 2, 4 or 8) column slices of a group, each 8 a
// multiple of 8 columns wide and at most 256 (a power of two).
extern "C" int repro_drs_scores_gemv(const void* fx, const void* fw,
                                     void* out, int m, int k, int f,
                                     int block, int slices, void* stream) {
  const int width = slices > 0 ? block / slices : 0;
  if (m < 1 || m > kGemvMaxM || k < 1 || k % 8 || f % 8 || block < 8 ||
      f % block || slices < 1 || slices > 8 || block % slices ||
      width < 8 || width > 256 || (width & (width - 1)))
    return (int)cudaErrorInvalidValue;
  return kScoresGemvLaunch[m - 1](fx, fw, out, k, f, block, slices,
                                  (cudaStream_t)stream);
}

// bf16, k % 8 == 0, f % 8 == 0, 16-byte aligned bases; block in {8, 16,
// 32, 64, 128}; each block walks `per` 64-row tiles.
extern "C" int repro_drs_scores_tc(const void* fx, const void* fw, void* out,
                                   int m, int k, int f, int block, int per,
                                   void* stream) {
  if (m < 1 || k < 1 || k % 8 || f % 8 || per < 1 || block < 1 || f % block)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (block) {
    case 8: return launch_scores_tc<8>(fx, fw, out, m, k, f, per, st);
    case 16: return launch_scores_tc<16>(fx, fw, out, m, k, f, per, st);
    case 32: return launch_scores_tc<32>(fx, fw, out, m, k, f, per, st);
    case 64: return launch_scores_tc<64>(fx, fw, out, m, k, f, per, st);
    case 128: return launch_scores_tc<128>(fx, fw, out, m, k, f, per, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
