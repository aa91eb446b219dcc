// Group-sparse SwiGLU FFN kernels: replace repro/kernels/dsg_ffn.py
// `dsg_ffn_csr` (Pallas, body `_csr_kernel`) and `dsg_ffn` (Pallas, body
// `_kernel`).  All keep the reference's rounding of h = silu(g) * u to
// x's dtype before the down projection, and accumulate the down
// projection in f32 and round once, where the Pallas kernels round their
// x-dtype accumulator after every slot or F block: in f32 the two agree to
// summation order, in bf16 the port's sum is the more accurate one.
// Blocks run in parallel in any order, so each kernel takes two
// deterministic launches and no atomics on device memory: greedy streams
// and bf16 results do not change from run to run.
//
// --- dsg_ffn_csr: group-CSR decode ---------------------------------------
//
// x (B, d) holds one token per lane; lane b keeps the neuron groups
// idx[b, :counts[b]] (ascending, zero-padded past counts) of the FFN's
// F = G * block hidden units.
//
// Bound on the H100: bytes.  Each active group costs 3 * d * block weight
// elements, and 6 * d * block flops per lane that lists it: at 4 lanes
// about 4 flops per weight byte, far below the ~295 where the tensor cores
// would bound.  The least traffic reads the union of the lanes' groups
// once, which is what the bound counts (at the serve shape 58 of 64
// groups, 91 MB, 0.027 ms at 3.35 TB/s).
//
// Two paths, picked by `dsg_ffn.csr_plan` from dtype and shape:
//
// The union path (bf16, up to 8 lanes).  Lanes list overlapping groups,
// and free serving lanes mirror a donor's row outright, so reading each
// lane's groups on its own moves about twice the union's bytes.  Work is
// indexed by union group instead:
//   (a) csr_gate_up, grid (U * block / slice, cluster), U = min(G, B * K),
//       clusters of `cluster` blocks along y.  Every block builds the
//       ascending union of the lanes' listed groups itself (slots
//       j < counts[b] only: the zero padding adds nothing) into shared
//       memory.  The cluster of union entry u reads the (d x slice) gate
//       and up slices of group ulist[u] once, its blocks splitting d, and
//       computes the partial products for all lanes at once (x rows past B
//       are zero).  Rank 0 sums the ranks' f32 partials through
//       distributed shared memory in rank order, applies silu(g) * u,
//       rounds h to bf16 and writes h[u, lane]: exact zeros for a lane that
//       does not list the group.  Blocks past the union exit at once.
//   (b) csr_down, grid (d / tile, splits), clusters of `splits` along y.
//       Split s walks its contiguous share of the union in ascending order
//       and sums h[u, lane] . wd[g * block + r, tile columns] in f32 for all
//       lanes; rank 0 sums the splits in rank order and rounds once.
// Every thread streams its own 16-byte chunks of weight rows through a
// ring of kStages cp.async copies (7 in flight) and consumes each chunk
// itself, so the copies stay in flight without a block barrier; the
// product is SIMT FMAs on 8 bf16 values per chunk, which keep up with the
// loads at a few flops per byte (an mma.sync tile would spend 12 of its
// 16 rows on padding at 4 lanes).  The threads that share a column chunk
// sum their row phases in shared memory in a fixed order.
//
// The lanes path (f32, more than 8 lanes, other shapes), the first port's
// kernels:
//   (a) gate_up, grid (B, K): slot j < counts[b] computes the block-wide
//       gate and up products over d for group idx[b, j] and stores
//       h = silu(g) * u in x's dtype (as the reference casts h before the
//       down projection).  Padded slots exit at once.
//   (b) down, grid (B, d / 64): each output column sums
//       h[b, j, :] . wd[idx[b, j] * block + r, col] over j < counts[b] in a
//       fixed order, in f32, and is cast to x's dtype once.
// Lanes read their own groups' blocks with 2-byte loads.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

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

// --- dsg_ffn_csr, the union path ------------------------------------------

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // threads of the union path's blocks
constexpr int kMaxGroups = 1024;  // the most groups (F / block) it takes

constexpr int kStages = 8;        // ring slots a thread: 7 copies in flight

// Shared memory of the copy ring, which the row-phase sums overlay.
__host__ __device__ constexpr size_t ring_bytes(int nb) {
  return (size_t)kThreads * 16 * kStages > (size_t)kThreads * nb * 8 * 4
             ? (size_t)kThreads * 16 * kStages
             : (size_t)kThreads * nb * 8 * 4;
}

// The ascending list of the groups that some lane lists in a slot
// j < counts[lane] (ulist) and each group's lanes as bits (lanes_of);
// returns the list's length.  Called by every thread of the block.
__device__ int build_union(const int32_t* __restrict__ idx,
                           const int32_t* __restrict__ counts, int b, int k,
                           int groups, uint32_t* lanes_of, int* ulist,
                           int* n_union) {
  for (int i = threadIdx.x; i < groups; i += blockDim.x) lanes_of[i] = 0;
  __syncthreads();
  for (int e = threadIdx.x; e < b * k; e += blockDim.x) {
    const int lane = e / k, g = idx[e];
    if (e - lane * k < counts[lane] && g >= 0 && g < groups)
      atomicOr(&lanes_of[g], 1u << lane);
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int n = 0;
    for (int g0 = 0; g0 < groups; g0 += 32) {
      const int g = g0 + lane;
      const bool on = g < groups && lanes_of[g] != 0;
      const uint32_t bits = __ballot_sync(0xffffffffu, on);
      if (on) ulist[n + __popc(bits & ((1u << lane) - 1u))] = g;
      n += __popc(bits);
    }
    if (lane == 0) *n_union = n;
  }
  __syncthreads();
  return *n_union;
}

// Streams the calling thread's n 16-byte chunks, chunk i from src(i),
// through its own ring of kStages slots (ring[slot * kThreads]), and hands
// each to use(i, chunk) in order.  A thread waits only for its own copies,
// so no barrier is needed.
template <typename Src, typename Use>
__device__ __forceinline__ void stream_chunks(uint4* ring, int n, Src src,
                                              Use use) {
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) repro::sm90::cp_async16(ring + i * kThreads, src(i));
    repro::sm90::cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int nx = i + kStages - 1;
    if (nx < n)
      repro::sm90::cp_async16(ring + (nx % kStages) * kThreads, src(nx));
    repro::sm90::cp_async_commit();
    repro::sm90::cp_async_wait<kStages - 1>();
    use(i, ring[(i % kStages) * kThreads]);
  }
}

// Sums the partials acc (NB lanes x 8 columns) of the threads that share a
// column chunk over their row phases, in phase order: thread
// t = phase * tpr + c holds chunk c.  `red` (kThreads * NB * 8 floats)
// overlays the copy ring.  Leaves part[lane * tpr * 8 + c * 8 + j].
// Called by every thread.
template <int NB>
__device__ void sum_phases(const float (&acc)[NB][8], float* red, float* part,
                           int tpr) {
  __syncthreads();  // every thread is done with the ring
#pragma unroll
  for (int l = 0; l < NB; ++l)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[(l * 8 + j) * kThreads + threadIdx.x] = acc[l][j];
  __syncthreads();
  const int phases = kThreads / tpr;
  for (int o = threadIdx.x; o < tpr * NB * 8; o += kThreads) {
    const int c = o % tpr, e = o / tpr;
    float s = 0.f;
#pragma unroll 8
    for (int ph = 0; ph < phases; ++ph) s += red[e * kThreads + ph * tpr + c];
    part[(e / 8) * tpr * 8 + c * 8 + e % 8] = s;
  }
  __syncthreads();
}

template <int NB>
__global__ void __launch_bounds__(kThreads) csr_gate_up_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ wg,
    const bf16* __restrict__ wu, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ counts, bf16* __restrict__ h, int b, int d,
    int f, int k, int block, int slice, int cluster) {
  __shared__ uint32_t lanes_of[kMaxGroups];
  __shared__ int ulist[kMaxGroups];
  __shared__ int n_union;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nu = build_union(idx, counts, b, k, f / block, lanes_of, ulist,
                             &n_union);
  const int nslices = block / slice;
  const int u = blockIdx.x / nslices, s = blockIdx.x - u * nslices;
  if (u >= nu) return;  // uniform across the cluster, which shares u
  const int g = ulist[u], rank = blockIdx.y, tid = threadIdx.x;
  const int cpr = slice / 8, tpr = 2 * cpr, phases = kThreads / tpr;
  const int per = (d + 8 * cluster - 1) / (8 * cluster) * 8;  // rows a rank
  const int r0 = min(d, rank * per), nr = min(d, r0 + per) - r0;
  // shared memory: the copy ring (overlaid by the phase sums), the
  // block's sums (NB, gate slice | up slice), x's rows (nr, NB) in f32
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw + ring_bytes(NB));
  float* xs = part + NB * 2 * slice;
  for (int i = tid; i < nr / 8 * NB; i += kThreads) {  // 8 rows a load
    const int l = i % NB, r = i / NB * 8;
    float v[8] = {};
    if (l < b)
      repro::sm90::bf16x8_to_f32(
          *reinterpret_cast<const uint4*>(x + (size_t)l * d + r0 + r), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) xs[(r + j) * NB + l] = v[j];
  }
  __syncthreads();
  const int c = tid % tpr, phase = tid / tpr, mat = c / cpr;
  const bf16* w = (mat ? wu : wg) + (size_t)r0 * f + (size_t)g * block +
                  s * slice + (c - mat * cpr) * 8;
  const int n = phase < nr ? (nr - phase + phases - 1) / phases : 0;
  float acc[NB][8] = {};
  stream_chunks(
      ring + tid, n,
      [&](int i) { return w + (size_t)(phase + i * phases) * f; },
      [&](int i, const uint4& v) {
        float wf[8];
        repro::sm90::bf16x8_to_f32(v, wf);
        const float* xr = xs + (phase + i * phases) * NB;
#pragma unroll
        for (int l = 0; l < NB; ++l) {
          const float xv = xr[l];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[l][j] = fmaf(xv, wf[j], acc[l][j]);
        }
      });
  sum_phases<NB>(acc, red, part, tpr);
  cg::cluster_group cl = cg::this_cluster();
  if (cluster > 1) cl.sync();  // every rank's sums are in its shared memory
  if (rank == 0) {
    const uint32_t on = lanes_of[g];
    for (int o = tid; o < b * slice; o += kThreads) {
      const int l = o / slice, col = o - l * slice;
      float gs = 0.f, us = 0.f;
#pragma unroll 8
      for (int q = 0; q < cluster; ++q) {
        const float* pq = q ? cl.map_shared_rank(part, q) : part;
        gs += pq[l * 2 * slice + col];
        us += pq[l * 2 * slice + slice + col];
      }
      const float hv = ((on >> l) & 1u) ? gs / (1.f + expf(-gs)) * us : 0.f;
      h[((size_t)u * b + l) * block + s * slice + col] =
          __float2bfloat16_rn(hv);
    }
  }
  if (cluster > 1) cl.sync();  // rank 0 has read the other ranks' sums
}

template <int NB>
__global__ void __launch_bounds__(kThreads) csr_down_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ wd,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ counts,
    bf16* __restrict__ out, int b, int d, int f, int k, int block, int tile,
    int splits) {
  __shared__ uint32_t lanes_of[kMaxGroups];
  __shared__ int ulist[kMaxGroups];
  __shared__ int n_union;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int nu = build_union(idx, counts, b, k, f / block, lanes_of, ulist,
                             &n_union);
  const int split = blockIdx.y, tid = threadIdx.x;
  const int per = (nu + splits - 1) / splits;
  const int u0 = min(nu, split * per), ng = min(nu, u0 + per) - u0;
  // shared memory: the copy ring (overlaid by the phase sums), the
  // block's sums (NB, tile), this split's h (ng * block rows, NB) in f32
  // and the wd row of each of its rows
  uint4* ring = reinterpret_cast<uint4*>(smem_raw);
  float* red = reinterpret_cast<float*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw + ring_bytes(NB));
  float* hs = part + NB * tile;
  int* wrow = reinterpret_cast<int*>(hs + (size_t)per * block * NB);
  for (int q = tid; q < ng * block; q += kThreads)
    wrow[q] = ulist[u0 + q / block] * block + q % block;
  for (int i = tid; i < ng * block / 8 * NB; i += kThreads) {  // 8 a load
    const int l = i % NB, rr = i / NB * 8, gi = rr / block;
    float v[8] = {};
    if (l < b)
      repro::sm90::bf16x8_to_f32(
          *reinterpret_cast<const uint4*>(
              h + ((size_t)(u0 + gi) * b + l) * block + rr - gi * block),
          v);
#pragma unroll
    for (int j = 0; j < 8; ++j) hs[(rr + j) * NB + l] = v[j];
  }
  __syncthreads();
  // thread (phase, c) takes the split's rows phase, phase + phases, ...
  // (block is a multiple of phases) at columns 8 c .. 8 c + 7 of the tile
  const int cpr = tile / 8, c = tid % cpr, phase = tid / cpr;
  const int phases = kThreads / cpr;
  const bf16* w = wd + (size_t)blockIdx.x * tile + c * 8;
  float acc[NB][8] = {};
  stream_chunks(
      ring + tid, ng * block / phases,
      [&](int i) { return w + (size_t)wrow[phase + i * phases] * d; },
      [&](int i, const uint4& v) {
        float wf[8];
        repro::sm90::bf16x8_to_f32(v, wf);
        const float* hr = hs + (phase + i * phases) * NB;
#pragma unroll
        for (int l = 0; l < NB; ++l) {
          const float hv = hr[l];
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[l][j] = fmaf(hv, wf[j], acc[l][j]);
        }
      });
  sum_phases<NB>(acc, red, part, cpr);
  cg::cluster_group cl = cg::this_cluster();
  if (splits > 1) cl.sync();  // every split's sums are in its shared memory
  if (split == 0) {
    for (int o = tid; o < b * tile; o += kThreads) {
      const int l = o / tile, col = o - l * tile;
      float acc_o = 0.f;
#pragma unroll 8
      for (int q = 0; q < splits; ++q)
        acc_o += (q ? cl.map_shared_rank(part, q) : part)[l * tile + col];
      out[(size_t)l * d + blockIdx.x * tile + col] = __float2bfloat16_rn(acc_o);
    }
  }
  if (splits > 1) cl.sync();  // rank 0 has read the other splits' sums
}

template <int NB>
int csr_union(const void* x, const void* wg, const void* wu, const void* wd,
              const void* idx, const void* counts, void* h, void* out, int b,
              int d, int f, int k, int block, int cluster, int slice,
              int tile, int splits, cudaStream_t stream) {
  const int groups = f / block;
  const int max_union = groups < b * k ? groups : b * k;
  if (max_union > 0) {
    const size_t smem = ring_bytes(NB) + (size_t)NB * 2 * slice * 4 +
                        (size_t)((d + 8 * cluster - 1) / (8 * cluster) * 8) *
                            NB * 4;
    const cudaError_t e = repro::sm90::launch_cluster(
        csr_gate_up_kernel<NB>, dim3(max_union * (block / slice), cluster),
        kThreads, dim3(1, cluster, 1), smem, stream, (const bf16*)x,
        (const bf16*)wg, (const bf16*)wu, (const int32_t*)idx,
        (const int32_t*)counts, (bf16*)h, b, d, f, k, block, slice, cluster);
    if (e != cudaSuccess) return (int)e;
  }
  const int per = (max_union + splits - 1) / splits;
  const size_t smem = ring_bytes(NB) + (size_t)NB * tile * 4 +
                      (size_t)per * block * (NB + 1) * 4;
  const cudaError_t e = repro::sm90::launch_cluster(
      csr_down_kernel<NB>, dim3(d / tile, splits), kThreads,
      dim3(1, splits, 1), smem, stream, (const bf16*)h, (const bf16*)wd,
      (const int32_t*)idx, (const int32_t*)counts, (bf16*)out, b, d, f, k,
      block, tile, splits);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The union path, bf16 only: h holds min(G, B * K) x B x block values.
// nb (1, 2, 4 or 8, at least B) is the lane count the kernels compute;
// `cluster` blocks split d for each (union group, `slice` columns) of the
// gate/up product; the down projection runs `splits` group splits for each
// `tile` output columns.
extern "C" int repro_dsg_ffn_csr_union(const void* x, const void* wg,
                                       const void* wu, const void* wd,
                                       const void* idx, const void* counts,
                                       void* h, void* out, int b, int d,
                                       int f, int k, int block, int nb,
                                       int cluster, int slice, int tile,
                                       int splits, void* stream) {
  if (b < 1 || b > nb || k < 0 || d < 8 || d % 8 || block < 32 ||
      block % 32 || f % block || f / block > kMaxGroups || cluster < 1 ||
      cluster > 8 || (slice != 32 && slice != 64 && slice != 128) ||
      block % slice || (tile != 64 && tile != 128) || d % tile ||
      splits < 1 || splits > 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (nb) {
    case 1: return csr_union<1>(x, wg, wu, wd, idx, counts, h, out, b, d, f,
                                k, block, cluster, slice, tile, splits, s);
    case 2: return csr_union<2>(x, wg, wu, wd, idx, counts, h, out, b, d, f,
                                k, block, cluster, slice, tile, splits, s);
    case 4: return csr_union<4>(x, wg, wu, wd, idx, counts, h, out, b, d, f,
                                k, block, cluster, slice, tile, splits, s);
    case 8: return csr_union<8>(x, wg, wu, wd, idx, counts, h, out, b, d, f,
                                k, block, cluster, slice, tile, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
