// K2: segmented inclusive prefix sum on Hopper (sm_90a), one launch a call.
//
// Replaces stereomatch_tpu/ops/mst_scan_pallas.py::segmented_cumsum_pallas
// (Pallas body _seg_scan_kernel) and, with it, the XLA scan
// ops/mst.py::_segmented_cumsum_mm. Every tree_filter pass of the 3DMST
// refine runs through it: rows are the K candidate labels (7 on the
// production path), the axis is N nodes or 2N Euler events. A second entry
// point (ancestor_sums_launch) is the same kernel with the Euler gathers
// of stereomatch_tpu/ops/mst.py::_ancestor_sums fused into its loads and
// stores: it loads +-v[k, euler_src[j]] (minus at out-events) and stores
// only in-events, to out[k, euler_src[j]]. Since in_pos[euler_src[j]] == j
// at every in-event, that is the composition's final index_select(in_pos),
// and the (K, 2N) scan never reaches device memory.
//
// It keeps the JAX scans' 256-element reassociation: within each
// 256-element sub-block the raw inclusive prefix pf is taken, and an
// element j after the sub-block's last reset r <= j gets pf[j] - pf[r-1]
// (the JAX `pf - base`). The value of the segment open at a sub-block's
// end is carried into the next sub-block and added to its elements before
// their first reset. The reset mask is read as uint8 directly; the TPU's
// packed int32 maps and triangular MXU products are not needed.
//
// What bounds it: bytes (x read once, the scan written once; one add a
// value). The TPU kernel carried the open segment through a sequential
// grid; blocks here run in no order, so the carry crosses tiles by a
// single-pass decoupled look-back:
//   - a block takes one tile of 1024 elements (4 sub-blocks, one warp
//     each, 8 elements a lane) for up to 4 rows at once, so the reset mask
//     is read once per tile and row group; values move by 16-byte loads
//     and stores. A block holds its tile in registers from the loads
//     through the look-back to the stores, so small blocks (128 threads,
//     6 an SM) keep the most tiles in flight: on the H100 this measured
//     faster than 8 sub-blocks x 8 rows (2 blocks an SM) or 2 rows;
//   - its tile id comes from an atomic counter, not blockIdx, so a block
//     only ever waits on tiles taken by blocks already running;
//   - it publishes, per row, the (value, status) of the segment open at
//     its end as one 64-bit word tagged with the call's epoch: a tile that
//     holds a reset publishes its final value (a prefix) at once, one
//     without publishes its aggregate, looks back, then its prefix. So
//     look-back chains break at every tile with a reset. The word holds
//     its own value, so relaxed 64-bit loads and stores suffice;
//   - warp r looks back for row r, 32 predecessors a step;
//   - the workspace (an id counter, look-back counts, the words) belongs
//     to the caller's stream and is never cleared between calls: words of
//     an older epoch read as not yet published, and ids are counted from
//     the caller's id_base.

#include <cstdint>

#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"

namespace {

constexpr int kSub = 256;                 // sub-block = the JAX scan block = one warp
constexpr int kPer = 8;                   // elements a lane
constexpr int kWarps = 4;                 // sub-blocks a tile
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = kSub * kWarps;      // 1024 elements
constexpr int kMaxRows = 4;               // rows a tile
constexpr int kHeader = 4;                // workspace words before the flags
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kAggregate = 1, kPrefix = 2;  // word status; 0: not published
static_assert(kMaxRows <= kWarps, "warp r publishes and looks back for row r");

struct ScanArgs {
  const float* x;          // (k, m), the plain scan
  const float* v;          // (k, n), the ancestor sum: its loads gather v
  const int64_t* src;      // (m,) node of each Euler event
  const uint8_t* is_in;    // (m,) in-event
  const uint8_t* reset;    // (m,)
  float* out;              // (k, m), or (k, n) for the ancestor sum
  unsigned long long* ws;  // [0] id counter, [1] look-backs, [2] deep look-backs, flags
  unsigned long long id_base;
  uint32_t epoch;
  int k, ngroups;
  int64_t m, n;
  bool vec;                // x and out rows are 16-byte aligned
  bool masks8;             // reset and is_in are 8-byte aligned
  bool src16;              // src is 16-byte aligned
};

__device__ __forceinline__ void publish(unsigned long long* p, uint32_t epoch, uint32_t status,
                                        float v) {
  const unsigned long long w =
      ((unsigned long long)((epoch << 2) | status) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}

// bit i: p[j0 + i] != 0, and `past` for elements at or beyond m
__device__ __forceinline__ unsigned load_mask8(const uint8_t* p, int64_t j0, int64_t m,
                                               bool aligned, unsigned past) {
  unsigned bits = 0;
  if (aligned && j0 + kPer <= m) {
    const unsigned long long r = __ldg(reinterpret_cast<const unsigned long long*>(p + j0));
#pragma unroll
    for (int i = 0; i < kPer; ++i) bits |= ((r >> (8 * i)) & 0xffull) ? 1u << i : 0u;
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int64_t j = j0 + i;
      bits |= (j < m ? (p[j] != 0) : past) << i;
    }
  }
  return bits;
}

// Exclusive carry into tile `tile` of row r of group g: walks back from the
// tile before it, 32 words a step, until the nearest word that is not an
// aggregate is a prefix; sums the values up to it. Warp-wide.
template <int kRows>
__device__ __forceinline__ float look_back(unsigned long long* ws, uint32_t epoch, int ngroups,
                                           int64_t tile, int g, int r, int lane) {
  const unsigned long long* flags = ws + kHeader;
  int64_t pred = tile - 1;
  float sum = 0.f;
  bool deep = false;
  for (;;) {
    const int64_t t = pred - lane;
    unsigned long long word = 0ull;  // before the first tile: an empty prefix
    unsigned stop;
    for (;;) {
      uint32_t st = kPrefix;
      if (t >= 0) {
        word = peek(flags + (t * ngroups + g) * kRows + r);
        const uint32_t hi = (uint32_t)(word >> 32);
        st = (hi >> 2) == epoch ? (hi & 3u) : 0u;
      }
      const unsigned unpublished = __ballot_sync(kFull, st == 0u);
      const unsigned prefix = __ballot_sync(kFull, st == kPrefix);
      stop = unpublished | prefix;
      if (stop == 0u || (prefix & stop & (0u - stop))) break;
      __nanosleep(32);  // the nearest word that decides is not published yet
    }
    const int s = stop ? __ffs(stop) - 1 : 31;
    float val = lane <= s ? __uint_as_float((uint32_t)word) : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) val += __shfl_xor_sync(kFull, val, off);
    sum += val;
    if (stop) {
      deep |= s > 0;
      break;
    }
    pred -= 32;
    deep = true;
  }
  if (r == 0 && lane == 0) {
    atomicAdd(ws + 1, 1ull);
    if (deep) atomicAdd(ws + 2, 1ull);
  }
  return sum;
}

template <int kRows, bool kFused>
__global__ void __launch_bounds__(kThreads, kRows == 1 ? 12 : 6)
seg_scan_kernel(const ScanArgs a) {
  __shared__ float agg_v[kWarps][kRows];  // per sub-block: value open at its end
  __shared__ int agg_f[kWarps];           // per sub-block: holds a reset
  __shared__ float tile_carry[kRows];
  __shared__ long long s_id;
  __shared__ int s_start_reset;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_id = (long long)(atomicAdd(a.ws, 1ull) - a.id_base);
  __syncthreads();
  const int64_t id = s_id;
  const int64_t tile = id / a.ngroups;
  const int g = (int)(id - tile * a.ngroups);
  const int row0 = g * kRows;
  const int rows = min(kRows, a.k - row0);
  const int64_t j0 = tile * kTile + w * kSub + lane * kPer;

  // the ragged tail is its own dead segment: zero value, reset everywhere
  const unsigned rbits = load_mask8(a.reset, j0, a.m, a.masks8, 1u);
  float xv[kRows][kPer];
  int dst[kPer];  // the ancestor sum: node of each event
  unsigned in_bits = 0;
  if constexpr (kFused) {
    in_bits = load_mask8(a.is_in, j0, a.m, a.masks8, 0u);
    if (a.src16 && j0 + kPer <= a.m) {
      const longlong2* s2 = reinterpret_cast<const longlong2*>(a.src + j0);
#pragma unroll
      for (int q = 0; q < kPer / 2; ++q) {
        const longlong2 s = __ldg(s2 + q);
        dst[2 * q] = (int)s.x;
        dst[2 * q + 1] = (int)s.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[i] = j0 + i < a.m ? (int)a.src[j0 + i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* vr = a.v + (int64_t)(row0 + min(r, rows - 1)) * a.n;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float val = (r < rows && j0 + i < a.m) ? __ldg(vr + dst[i]) : 0.f;
        xv[r][i] = (in_bits >> i) & 1u ? val : -val;
      }
    }
  } else {
    const bool vec = a.vec && j0 + kPer <= a.m;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* xr = a.x + (int64_t)(row0 + min(r, rows - 1)) * a.m;
      if (r < rows && vec) {
        const float4 lo = __ldcs(reinterpret_cast<const float4*>(xr + j0));
        const float4 hi = __ldcs(reinterpret_cast<const float4*>(xr + j0) + 1);
        xv[r][0] = lo.x, xv[r][1] = lo.y, xv[r][2] = lo.z, xv[r][3] = lo.w;
        xv[r][4] = hi.x, xv[r][5] = hi.y, xv[r][6] = hi.z, xv[r][7] = hi.w;
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) xv[r][i] = (r < rows && j0 + i < a.m) ? xr[j0 + i] : 0.f;
      }
    }
  }

  // The reset structure is the rows' own: the nearest lane before this one
  // with a reset, and which elements see no reset at or before them in the
  // sub-block (they take the carry).
  const unsigned bal = __ballot_sync(kFull, rbits != 0u);
  const unsigned before = bal & ((1u << lane) - 1u);
  const int prev_lane = before ? 31 - __clz(before) : -1;
  unsigned carry_bits = 0;
  if (prev_lane < 0) carry_bits = rbits ? (1u << (__ffs(rbits) - 1)) - 1u : (1u << kPer) - 1u;

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;  // uniform over the block
    // pf: the lane's own prefix, then the warp's over the lanes' totals
    float s[kPer];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) s[i] = run += xv[r][i];
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.f;
    // pf just before the lane's last reset: the base of the lanes after it
    float lane_base = excl;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if ((rbits >> i) & 1u) lane_base = i == 0 ? excl : excl + s[i - 1];
    float base = __shfl_sync(kFull, lane_base, prev_lane < 0 ? 0 : prev_lane);
    bool seen = prev_lane >= 0;
    float prev_pf = excl;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const float pf = excl + s[i];
      if ((rbits >> i) & 1u) {
        base = prev_pf;
        seen = true;
      }
      xv[r][i] = seen ? pf - base : pf;
      prev_pf = pf;
    }
    if (lane == 31) agg_v[w][r] = xv[r][kPer - 1];
  }
  if (lane == 0) agg_f[w] = bal != 0u;
  if (threadIdx.x == 0) s_start_reset = rbits & 1u;
  __syncthreads();

  // warp r publishes row r's word and, unless the tile starts a segment,
  // looks back for the carry into the tile
  if (w < rows) {
    float c = 0.f;
    bool f = false;
#pragma unroll
    for (int b = 0; b < kWarps; ++b) {
      c = agg_f[b] ? agg_v[b][w] : c + agg_v[b][w];
      f |= agg_f[b] != 0;
    }
    unsigned long long* slot = a.ws + kHeader + id * kRows + w;
    const bool final_now = f || tile == 0;
    if (lane == 0) publish(slot, a.epoch, final_now ? kPrefix : kAggregate, c);
    float carry = 0.f;
    if (tile > 0 && !s_start_reset)
      carry = look_back<kRows>(a.ws, a.epoch, a.ngroups, tile, g, w, lane);
    if (lane == 0) {
      if (!final_now) publish(slot, a.epoch, kPrefix, carry + c);
      tile_carry[w] = carry;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;
    // carry into this sub-block: the tile's, then the sub-blocks before it
    float c = tile_carry[r];
#pragma unroll
    for (int b = 0; b < kWarps - 1; ++b)
      if (b < w) c = agg_f[b] ? agg_v[b][r] : c + agg_v[b][r];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      if ((carry_bits >> i) & 1u) xv[r][i] += c;
    if constexpr (kFused) {
      float* outr = a.out + (int64_t)(row0 + r) * a.n;
#pragma unroll
      for (int i = 0; i < kPer; ++i)
        if (((in_bits >> i) & 1u) && j0 + i < a.m) outr[dst[i]] = xv[r][i];
    } else {
      float* outr = a.out + (int64_t)(row0 + r) * a.m;
      if (a.vec && j0 + kPer <= a.m) {
        float4* o = reinterpret_cast<float4*>(outr + j0);
        o[0] = make_float4(xv[r][0], xv[r][1], xv[r][2], xv[r][3]);
        o[1] = make_float4(xv[r][4], xv[r][5], xv[r][6], xv[r][7]);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          if (j0 + i < a.m) outr[j0 + i] = xv[r][i];
      }
    }
  }
}

// a single row gets its own, smaller kernel; more rows share each tile's
// reset mask, kMaxRows at a time
int rows_per_tile(int k) { return k == 1 ? 1 : kMaxRows; }
int row_groups(int k) { return (k + rows_per_tile(k) - 1) / rows_per_tile(k); }

template <bool kFused>
void launch(ScanArgs a, cudaStream_t stream) {
  const int64_t ids = seg_scan_plan(a.k, a.m).ids;
  if (ids == 0) return;
  a.ngroups = row_groups(a.k);
  a.masks8 = reinterpret_cast<uintptr_t>(a.reset) % 8 == 0 &&
             reinterpret_cast<uintptr_t>(a.is_in) % 8 == 0;
  a.src16 = reinterpret_cast<uintptr_t>(a.src) % 16 == 0;
  if (rows_per_tile(a.k) == 1)
    seg_scan_kernel<1, kFused><<<(unsigned)ids, kThreads, 0, stream>>>(a);
  else
    seg_scan_kernel<kMaxRows, kFused><<<(unsigned)ids, kThreads, 0, stream>>>(a);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

SegScanPlan seg_scan_plan(int k, int64_t m) {
  const int64_t ids = (m + kTile - 1) / kTile * row_groups(k);
  return {ids, kHeader + ids * rows_per_tile(k)};
}

void seg_scan_launch(const float* x, const uint8_t* reset, float* out, int k, int64_t m,
                     unsigned long long* ws, unsigned long long id_base, uint32_t epoch,
                     cudaStream_t stream) {
  ScanArgs a{};
  a.x = x, a.reset = reset, a.out = out, a.ws = ws, a.id_base = id_base, a.epoch = epoch;
  a.k = k, a.m = m, a.n = m;
  a.vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  launch<false>(a, stream);
}

void ancestor_sums_launch(const float* v, const int64_t* src, const uint8_t* is_in,
                          const uint8_t* reset, float* out, int k, int64_t n, int64_t m,
                          unsigned long long* ws, unsigned long long id_base, uint32_t epoch,
                          cudaStream_t stream) {
  ScanArgs a{};
  a.v = v, a.src = src, a.is_in = is_in, a.reset = reset, a.out = out;
  a.ws = ws, a.id_base = id_base, a.epoch = epoch;
  a.k = k, a.m = m, a.n = n;
  launch<true>(a, stream);
}
