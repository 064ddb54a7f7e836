// Bitonic sort network over stacked uint32 key planes, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of auron_tpu/ops/bitonic.py:
//   - _bitonic_kernel (_run_pallas), the whole network on chip: here
//     `bitonic_cluster` in sort mode, which sorts up to one thread-block
//     cluster's worth of elements (16 CTAs x 2048) in one launch;
//   - _merge_kernel (_run_pallas_merge / _merge_pairs / _tiled_sort), the
//     merge stages past one block: here `bitonic_strides` (up to three
//     strides of one stage a launch, in registers) for the strides past one
//     cluster and `bitonic_cluster` in tail mode for the rest of the stage.
// Plane counts above kMaxNP take the general kernels `bitonic_local` (a
// shared-memory tile, any NP) and `bitonic_global` (one stride a launch).
//
// Data: NP planes of P uint32 each, plane-major ([NP][P], stride P), the
// last plane a distinct int32 payload, so the lexicographic order across
// planes is total and the result equals a stable multi-key sort. P is a
// power of two. Planes are sorted in place. The host (ops/bitonic.py
// `sort_plan`) decides the launches; `auron_bitonic_run` issues them.
//
// Bound: the bytes (each plane read and written once) take less than one
// launch's latency at the main path's shapes (16,384 x 8 planes is 1 MB).
// What bounds the sort is the chain of log2(P)(log2(P)+1)/2 dependent
// substages, each a compare-exchange of every element across NP planes,
// on the few SMs one sort can use, and the barriers between them. The
// design:
//   - one launch when the sort fits one cluster, spread over up to 16 CTAs
//     (Hopper's non-portable cluster size; 16 measured 1.4-1.9x faster than
//     8 at the main path's shapes): each CTA's tile (T elements x NP
//     planes) lives in registers and shared memory, and the strides past a
//     tile run over distributed shared memory with a cluster barrier after
//     each pass;
//   - NP is a template parameter, so a thread's E = 4 elements sit in
//     registers (unsigned v[E][NP]), with 32-bit indices in a tile, and the
//     lexicographic compare is one subtract-with-borrow chain across the
//     planes: no data-dependent exit, one instruction a plane (the lt/eq
//     chain of the plain _substage measured 1.3x slower);
//   - strides below E run in a thread's registers, strides E .. 16E by
//     __shfl_xor_sync across a warp, with no barrier; strides of 32E and
//     more go through shared memory (or another CTA's), two strides a pass
//     (4 elements a thread in registers), one barrier a pass;
//   - past one cluster, a launch runs up to three strides of a stage in
//     registers (8 elements a thread; two strides, 4 elements, above 10
//     planes) instead of one stride a launch.
// The direction of every compare-exchange is bit k of the GLOBAL index of
// the pair's lower element (want_max = bit_j != bit_k in the Pallas
// network's _substage), so a tile or cluster of a larger sort comes out in
// the direction the network needs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMinNP = 2;
constexpr int kMaxNP = 16;       // plane counts with a register kernel
constexpr unsigned kTile = 2048;  // elements of a CTA of bitonic_cluster (at most)
constexpr int kMaxSmem = 232448;  // 227 KB: dynamic shared memory a CTA may use
constexpr int kStridesThreads = 256;

// Elements a thread of bitonic_cluster holds in registers (E): 512
// threads for a 2048-element tile. E = 8 (256 threads) measured slower.
constexpr int kPerThread = 4;
constexpr int kMaxCluster = 16;  // CTAs a cluster (non-portable above 8)

// Strides a bitonic_strides launch may run: 2^M elements x NP planes of a
// thread stay in registers without spills (-Xptxas -v) up to NP = 10 at M = 3.
constexpr int max_strides(int np) { return np <= 10 ? 3 : 2; }

// Borrow out of (a3 a2 a1 a0) - (b3 b2 b1 b0) - borrow_in (a3 the most
// significant word): one subtract-with-borrow per word, no branch.
__device__ __forceinline__ unsigned sub_borrow4(unsigned a3, unsigned b3, unsigned a2,
                                                unsigned b2, unsigned a1, unsigned b1,
                                                unsigned a0, unsigned b0, unsigned borrow_in) {
  unsigned out;
  asm("{\n\t.reg .u32 t;\n\t"
      "sub.cc.u32 t, 0, %9;\n\t"
      "subc.cc.u32 t, %7, %8;\n\t"
      "subc.cc.u32 t, %5, %6;\n\t"
      "subc.cc.u32 t, %3, %4;\n\t"
      "subc.cc.u32 t, %1, %2;\n\t"
      "subc.u32 %0, 0, 0;\n\t}"
      : "=r"(out)
      : "r"(a3), "r"(b3), "r"(a2), "r"(b2), "r"(a1), "r"(b1), "r"(a0), "r"(b0), "r"(borrow_in));
  return out & 1u;
}

// Lexicographic a < b over NP planes (plane 0 most significant): the
// borrow of the multiword subtraction a - b, four planes an instruction
// group, least significant first; missing leading planes count as equal.
template <int NP>
__device__ __forceinline__ bool lex_less(const unsigned (&a)[NP], const unsigned (&b)[NP]) {
  unsigned borrow = 0;
#pragma unroll
  for (int hi = NP; hi > 0; hi -= 4) {
    const unsigned a3 = hi >= 4 ? a[hi - 4] : 0u, b3 = hi >= 4 ? b[hi - 4] : 0u;
    const unsigned a2 = hi >= 3 ? a[hi - 3] : 0u, b2 = hi >= 3 ? b[hi - 3] : 0u;
    const unsigned a1 = hi >= 2 ? a[hi - 2] : 0u, b1 = hi >= 2 ? b[hi - 2] : 0u;
    borrow = sub_borrow4(a3, b3, a2, b2, a1, b1, a[hi - 1], b[hi - 1], borrow);
  }
  return borrow != 0;
}

// Order two whole elements: a gets the smaller (desc: the larger); returns
// whether the two were swapped. Equal elements are identical in every
// plane, so swapping them (when a < b is false) changes nothing, and one
// compare serves both directions.
template <int NP>
__device__ __forceinline__ bool order_pair(unsigned (&a)[NP], unsigned (&b)[NP], bool desc) {
  const bool swap = lex_less<NP>(a, b) == desc;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const unsigned t = swap ? b[p] : a[p];
    b[p] = swap ? a[p] : b[p];
    a[p] = t;
  }
  return swap;
}

// a <- partner q where (a < q) == want_max: the network's select.
template <int NP>
__device__ __forceinline__ void take_if(unsigned (&a)[NP], const unsigned (&q)[NP],
                                        bool want_max) {
  const bool take = lex_less<NP>(a, q) == want_max;
#pragma unroll
  for (int p = 0; p < NP; ++p) a[p] = take ? q[p] : a[p];
}

template <int NP, int E>
__device__ __forceinline__ void store_own(unsigned* s, unsigned T, unsigned own0,
                                          const unsigned (&v)[E][NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint4* d = reinterpret_cast<uint4*>(s + p * T + own0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      d[q] = make_uint4(v[4 * q][p], v[4 * q + 1][p], v[4 * q + 2][p], v[4 * q + 3][p]);
  }
}

template <int NP, int E>
__device__ __forceinline__ void load_own(const unsigned* s, unsigned T, unsigned own0,
                                         unsigned (&v)[E][NP]) {
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint4* d = reinterpret_cast<const uint4*>(s + p * T + own0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint4 w = d[q];
      v[4 * q][p] = w.x;
      v[4 * q + 1][p] = w.y;
      v[4 * q + 2][p] = w.z;
      v[4 * q + 3][p] = w.w;
    }
  }
}

// One group of 2^M elements, (ptr[m][p * T + o]) for m < 2^M, whose
// indices differ in M stride bits: its M substages (strides 2^(M-1) .. 1
// in m) run in registers. k is above every stride, so one direction
// serves the group.
template <int NP, int M>
__device__ __forceinline__ void order_group(unsigned* const (&ptr)[1 << M], unsigned T, unsigned o,
                                            bool desc) {
  constexpr int R = 1 << M;
  unsigned v[R][NP];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int p = 0; p < NP; ++p) v[m][p] = ptr[m][p * T + o];
#pragma unroll
  for (int bit = R / 2; bit >= 1; bit >>= 1)
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (!(m & bit)) order_pair<NP>(v[m], v[m | bit], desc);
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int p = 0; p < NP; ++p) ptr[m][p * T + o] = v[m][p];
}

// Strides j_lo << (M-1) .. j_lo of stage k (all below T) over the tile in
// shared memory, one pass: group t is t with M zero bits inserted at
// log2(j_lo), plus m * j_lo.
template <int NP, int M>
__device__ __forceinline__ void tile_pass(unsigned* s, unsigned T, unsigned tile0, unsigned j_lo,
                                          unsigned k) {
  constexpr int R = 1 << M;
  const unsigned sh = __ffs(j_lo) - 1;
  unsigned* ptr[R];
#pragma unroll
  for (int m = 0; m < R; ++m) ptr[m] = s + m * j_lo;
  for (unsigned t = threadIdx.x; t < T / R; t += blockDim.x) {
    const unsigned b = ((t >> sh) << (sh + M)) | (t & (j_lo - 1));
    order_group<NP, M>(ptr, T, b, ((tile0 + b) & k) != 0);
  }
}

// Strides j_lo << (M-1) .. j_lo of stage k (all T or more) in one pass over
// distributed shared memory: a group is one offset in each of 2^M tiles
// j_lo apart, i.e. the CTAs of ranks rbase + m * (j_lo / T). This CTA is
// number q of its 2^M and orders the offsets [q T/2^M, (q + 1) T/2^M),
// reading and writing the others' shared memory.
template <int NP, int M>
__device__ __forceinline__ void cluster_pass(cg::cluster_group& cluster, unsigned* s, unsigned T,
                                             unsigned tile0, unsigned j_lo, unsigned k) {
  constexpr int R = 1 << M;
  const unsigned jr = j_lo / T;
  const unsigned rank = cluster.block_rank();
  const unsigned q = (rank / jr) & (R - 1);
  unsigned* ptr[R];
#pragma unroll
  for (int m = 0; m < R; ++m) ptr[m] = cluster.map_shared_rank(s, rank - q * jr + m * jr);
  const unsigned lo0 = tile0 - q * j_lo;  // global index of the group's first tile
  for (unsigned t = threadIdx.x; t < T / R; t += blockDim.x) {
    const unsigned o = q * (T / R) + t;
    order_group<NP, M>(ptr, T, o, ((lo0 + o) & k) != 0);
  }
}

// Stages k = k_lo .. k_hi (powers of two) of the network over this
// cluster's C tiles of T = blockDim.x * E elements, each stage from stride
// min(k/2, C*T/2) down to 1. Sort mode: k_lo = 2, k_hi <= C*T (C*T = P:
// the whole sort). Tail mode: k_lo = k_hi = k > C*T, the strides of stage
// k below one cluster. Thread t holds elements t*E .. t*E + E - 1 of its
// tile in registers; shared memory holds the tile ([NP][T]) while strides
// of 32E and more run, two strides a pass.
template <int NP>
__global__ void __launch_bounds__(kTile / kPerThread)
bitonic_cluster(unsigned* __restrict__ x, unsigned P, unsigned k_lo, unsigned k_hi) {
  constexpr int E = kPerThread;
  extern __shared__ __align__(16) unsigned s[];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned T = blockDim.x * E;
  const unsigned span = cluster.num_blocks() * T;
  const unsigned tile0 = blockIdx.x * T;
  const unsigned own0 = threadIdx.x * E;
  const unsigned g0 = tile0 + own0;  // global index of this thread's first element

  unsigned v[E][NP];
#pragma unroll
  for (int p = 0; p < NP; ++p) {
    const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)p * P + g0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const uint4 w = src[q];
      v[4 * q][p] = w.x;
      v[4 * q + 1][p] = w.y;
      v[4 * q + 2][p] = w.z;
      v[4 * q + 3][p] = w.w;
    }
  }

  for (unsigned k = k_lo; k <= k_hi; k <<= 1) {
    unsigned j = min(k >> 1, span >> 1);
    if (j >= 32u * E) {
      store_own<NP, E>(s, T, own0, v);
      if (j >= T) {
        // Every CTA ends each cross-tile pass at cluster.sync(), so no CTA
        // touches another's shared memory after its last barrier: a CTA
        // never exits while another may still read it.
        cluster.sync();
        for (; j >= T; j >>= (j >= 2 * T ? 2 : 1)) {
          if (j >= 2 * T)
            cluster_pass<NP, 2>(cluster, s, T, tile0, j >> 1, k);
          else
            cluster_pass<NP, 1>(cluster, s, T, tile0, j, k);
          cluster.sync();
        }
      } else {
        __syncthreads();
      }
      for (; j >= 32u * E; j >>= (j >= 64u * E ? 2 : 1)) {
        if (j >= 64u * E)
          tile_pass<NP, 2>(s, T, tile0, j >> 1, k);
        else
          tile_pass<NP, 1>(s, T, tile0, j, k);
        __syncthreads();
      }
      load_own<NP, E>(s, T, own0, v);
    }
    // strides E .. 16E: the partner element is register r of lane ^ (j/E)
    for (; j >= (unsigned)E; j >>= 1) {
      const unsigned lane_mask = j / E;
      const bool upper = (own0 & j) != 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        unsigned q[NP];
#pragma unroll
        for (int p = 0; p < NP; ++p) q[p] = __shfl_xor_sync(0xffffffffu, v[r][p], lane_mask);
        take_if<NP>(v[r], q, upper != (((g0 + r) & k) != 0));
      }
    }
    // strides below E: both elements in this thread's registers
#pragma unroll
    for (int jr = E / 2; jr >= 1; jr >>= 1) {
      if ((unsigned)jr > j) continue;
#pragma unroll
      for (int r = 0; r < E; ++r)
        if (!(r & jr)) order_pair<NP>(v[r], v[r | jr], ((g0 + r) & k) != 0);
    }
  }

#pragma unroll
  for (int p = 0; p < NP; ++p) {
    uint4* dst = reinterpret_cast<uint4*>(x + (size_t)p * P + g0);
#pragma unroll
    for (int q = 0; q < E / 4; ++q)
      dst[q] = make_uint4(v[4 * q][p], v[4 * q + 1][p], v[4 * q + 2][p], v[4 * q + 3][p]);
  }
}

// M strides of stage k, j_lo << (M-1) down to j_lo (all >= one cluster's
// span), in one pass: thread q holds the 2^M elements b + m * j_lo (b: q
// with M zero bits inserted at log2(j_lo)), so each stride pairs two of its
// registers; k > j_lo << M, so the direction is one bit of b.
template <int NP, int M>
__global__ void __launch_bounds__(kStridesThreads)
bitonic_strides(unsigned* __restrict__ x, unsigned P, unsigned k, unsigned j_lo) {
  constexpr int R = 1 << M;
  const unsigned q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= (P >> M)) return;
  const unsigned sh = __ffs(j_lo) - 1;
  const unsigned b = ((q >> sh) << (sh + M)) | (q & (j_lo - 1));
  const bool desc = (b & k) != 0;
  unsigned v[R][NP];
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int p = 0; p < NP; ++p) v[m][p] = x[(size_t)p * P + b + m * j_lo];
#pragma unroll
  for (int bit = R / 2; bit >= 1; bit >>= 1)
#pragma unroll
    for (int m = 0; m < R; ++m)
      if (!(m & bit)) order_pair<NP>(v[m], v[m | bit], desc);
#pragma unroll
  for (int m = 0; m < R; ++m)
#pragma unroll
    for (int p = 0; p < NP; ++p) x[(size_t)p * P + b + m * j_lo] = v[m][p];
}

// ---- general kernels: any plane count (the path above kMaxNP) ----

// -1 / 0 / +1: lexicographic compare of elements ia and ib across np planes.
__device__ __forceinline__ int lex_cmp(const unsigned* base, long long stride,
                                       long long ia, long long ib, int np) {
  for (int p = 0; p < np; ++p) {
    unsigned a = base[p * stride + ia];
    unsigned b = base[p * stride + ib];
    if (a != b) return a < b ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ void swap_planes(unsigned* base, long long stride,
                                            long long ia, long long ib, int np) {
  for (int p = 0; p < np; ++p) {
    unsigned t = base[p * stride + ia];
    base[p * stride + ia] = base[p * stride + ib];
    base[p * stride + ib] = t;
  }
}

// Position of the t-th pair's lower element for stride j: insert a 0 bit at j.
__device__ __forceinline__ long long pair_lo(long long t, long long j) {
  return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

__device__ __forceinline__ void cmp_exchange(unsigned* base, long long stride,
                                             long long i, long long l,
                                             bool desc, int np) {
  int c = lex_cmp(base, stride, i, l, np);
  if (desc ? (c < 0) : (c > 0)) swap_planes(base, stride, i, l, np);
}

// One CTA per tile of T elements. k_fixed == 0: tile sort, every stage
// k = 2..T with all its substages. k_fixed > 0: the tail of stage k_fixed,
// substages j = T/2..1.
__global__ void bitonic_local(unsigned* __restrict__ x, int np, long long P,
                              int T, long long k_fixed) {
  extern __shared__ unsigned sg[];
  const long long base = (long long)blockIdx.x * T;
  for (int p = 0; p < np; ++p)
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      sg[p * T + i] = x[p * P + base + i];
  __syncthreads();
  const int half = T >> 1;
  const long long k_lo = k_fixed ? k_fixed : 2;
  const long long k_hi = k_fixed ? k_fixed : T;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    const int j0 = k_fixed ? half : (int)(k >> 1);
    for (int j = j0; j >= 1; j >>= 1) {
      for (int t = threadIdx.x; t < half; t += blockDim.x) {
        const long long i = pair_lo(t, j);
        cmp_exchange(sg, T, i, i | j, ((base + i) & k) != 0, np);
      }
      __syncthreads();
    }
  }
  for (int p = 0; p < np; ++p)
    for (int i = threadIdx.x; i < T; i += blockDim.x)
      x[p * P + base + i] = sg[p * T + i];
}

// One substage of stage k with a stride j >= T: one thread per pair.
__global__ void bitonic_global(unsigned* __restrict__ x, int np, long long P,
                               long long k, long long j) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (P >> 1)) return;
  const long long i = pair_lo(t, j);
  cmp_exchange(x, P, i, i | j, (i & k) != 0, np);
}

// ---- host side ----

using PlaneKernel = void (*)(unsigned*, unsigned, unsigned, unsigned);

#define AURON_BITONIC_NP(X) \
  X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

PlaneKernel cluster_kernel(int np) {
  switch (np) {
#define AURON_CASE(n) \
  case n:             \
    return bitonic_cluster<n>;
    AURON_BITONIC_NP(AURON_CASE)
#undef AURON_CASE
  }
  return nullptr;
}

template <int NP, int M>
PlaneKernel strides_instance() {
  if constexpr (M <= max_strides(NP)) {
    return bitonic_strides<NP, M>;
  } else {
    return nullptr;  // not compiled: it would spill
  }
}

PlaneKernel strides_kernel(int np, int m) {
  switch (np * 4 + m) {
#define AURON_CASE(n)                \
  case n * 4 + 1:                    \
    return strides_instance<n, 1>(); \
  case n * 4 + 2:                    \
    return strides_instance<n, 2>(); \
  case n * 4 + 3:                    \
    return strides_instance<n, 3>();
    AURON_BITONIC_NP(AURON_CASE)
#undef AURON_CASE
  }
  return nullptr;
}

// The shared-memory limit is raised once per kernel, not per launch.
bool g_cluster_attr[kMaxNP + 1];
bool g_local_attr;

cudaError_t raise_cluster_smem(int np) {
  if (g_cluster_attr[np]) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(cluster_kernel(np),
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       np * (int)kTile * (int)sizeof(unsigned));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(cluster_kernel(np), cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) g_cluster_attr[np] = true;
  return e;
}

cudaLaunchConfig_t cluster_config(int np, unsigned P, unsigned T, unsigned C,
                                  cudaLaunchAttribute* attr, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P / T, 1, 1);
  cfg.blockDim = dim3(T / kPerThread, 1, 1);
  cfg.dynamicSmemBytes = (size_t)np * T * sizeof(unsigned);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

bool register_path(int np, long long P, int T, int C, int E) {
  return np >= kMinNP && np <= kMaxNP && E == kPerThread && T >= 32 * E &&
         (unsigned)T <= kTile && P % ((long long)T * C) == 0 && C >= 1 && C <= kMaxCluster;
}

}  // namespace

extern "C" {

// Raises bitonic_cluster<np>'s shared-memory limit (once) and returns how
// many clusters of C CTAs of T elements the card can hold at once (0: the
// shape cannot be scheduled), or minus a CUDA error code.
int auron_bitonic_prepare(int np, int T, int C, int E) {
  if (!register_path(np, (long long)T * C, T, C, E)) return -(int)cudaErrorInvalidValue;
  cudaError_t e = raise_cluster_smem(np);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(np, (unsigned)T * C, T, C, attr, 0);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)cluster_kernel(np), &cfg);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

// Issues a sort plan (ops/bitonic.py sort_plan) on planes x ([np][P]):
// n_launches rows of 4 int64 each, {kind, a, b, c}:
//   0 cluster   stages a..b of bitonic_cluster (tiles of T, clusters of C)
//   1 strides   stage a, strides b down to b >> (c - 1) (c = M)
//   2 local     bitonic_local, tile T; a = 0: tile sort, else the tail of stage a
//   3 global    bitonic_global, stage a, stride b
// Returns 0 or the first CUDA error (launches after it are not issued).
int auron_bitonic_run(void* x, int np, long long P, int T, int C, int E,
                      const long long* launches, int n_launches, void* stream) {
  if (P < 2 || (P & (P - 1)) || P > (1LL << 30) || T < 2 || P % T != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* xp = (unsigned*)x;
  for (int i = 0; i < n_launches; ++i) {
    const long long* d = launches + 4 * i;
    cudaError_t e = cudaSuccess;
    switch (d[0]) {
      case 0: {
        if (!register_path(np, P, T, C, E)) return (int)cudaErrorInvalidValue;
        e = raise_cluster_smem(np);
        if (e != cudaSuccess) return (int)e;
        cudaLaunchAttribute attr[1];
        cudaLaunchConfig_t cfg = cluster_config(np, (unsigned)P, T, C, attr, st);
        e = cudaLaunchKernelEx(&cfg, cluster_kernel(np), xp, (unsigned)P, (unsigned)d[1],
                               (unsigned)d[2]);
        break;
      }
      case 1: {
        const int m = (int)d[3];
        PlaneKernel kern = m >= 1 && m <= 3 ? strides_kernel(np, m) : nullptr;
        if (kern == nullptr || (d[2] >> (m - 1)) < 32 || (d[2] << 1) > d[1])
          return (int)cudaErrorInvalidValue;
        const long long j_lo = d[2] >> (m - 1);
        const long long threads = P >> m;
        kern<<<(unsigned)((threads + kStridesThreads - 1) / kStridesThreads), kStridesThreads, 0,
               st>>>(xp, (unsigned)P, (unsigned)d[1], (unsigned)j_lo);
        break;
      }
      case 2: {
        const size_t smem = (size_t)np * T * sizeof(unsigned);
        if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
        if (!g_local_attr) {
          e = cudaFuncSetAttribute(bitonic_local, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   kMaxSmem);
          if (e != cudaSuccess) return (int)e;
          g_local_attr = true;
        }
        const int threads = (T / 2) < 1024 ? (T / 2) : 1024;
        bitonic_local<<<(unsigned)(P / T), threads, smem, st>>>(xp, np, P, T, d[1]);
        break;
      }
      case 3: {
        const long long pairs = P >> 1;
        bitonic_global<<<(unsigned)((pairs + 255) / 256), 256, 0, st>>>(xp, np, P, d[1], d[2]);
        break;
      }
      default:
        return (int)cudaErrorInvalidValue;
    }
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* auron_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
