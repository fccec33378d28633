// K1: SGBM path aggregation on Hopper (sm_90a), every direction in one launch.
//
// Replaces stereomatch_tpu/ops/sgbm_pallas.py::aggregate_8path_pallas (the
// Pallas calls of _row_pass / _row_kernel and _col_pass / _col_kernel, and
// their chunked-carry variants _row_chunk_call / _col_chunk_call). For each
// direction r of the set (8, 5 or 4 of them) it computes
//     Lr(p,d) = (C(p,d) + min(Lr(q,d), Lr(q,d-1)+P1, Lr(q,d+1)+P1,
//                             minLr(q)+P2)) - minLr(q),   q = p - r,
// with zero state where q leaves the image, and S = sum over r of Lr, f32.
//
// What bounds it: bytes. The function reads C once and writes S once: at
// 960 x 1152 x 128, 0.28 GB of bf16 C and 0.57 GB of f32 S, 0.25 ms at
// 3.35 TB/s; a few operations per byte. This design moves C once per
// direction and S once per direction as reductions, plus the wrapper's zero
// fill of S: about 11.9 GB at 8 directions, 3.6 ms. The TPU kernel keeps the
// DP carry of a row sweep in VMEM and walks rows on one serial grid; here
// the parallelism is the path lines, and the design keeps enough of them in
// flight, and keeps every load off the DP's serial chain:
//
// 1. One launch per call. Path lines (rows for a horizontal r, columns for
//    a vertical r, x -/+ y = const diagonals for a diagonal r) are
//    independent: one warp walks its lines, carrying Lr in registers (lane l
//    holds disparities [l*VPT, (l+1)*VPT)); the d-1 / d+1 neighbours cross
//    lanes with __shfl_up/down_sync and minLr is a __shfl_xor_sync butterfly
//    (the GPU SGM design of arXiv 1610.04121). blockIdx.x encodes the
//    direction and a group of kWarpsPerBlock adjacent walks, so the walks of
//    all directions (8832 warps at 960 x 1152) share the card at once. A
//    diagonal walk starts on the first row and wraps around the image's
//    sides (leaving one side, it goes on at the next row on the other side,
//    a new line with zero state), so every walk of a downward or upward r is
//    h steps long and meets the rows in order, one a step. The downward
//    directions' blocks come first, then the upward ones', so the walks that
//    meet a row of C and S together run together, and the row's bytes are
//    often still in L2 when the second and third direction reach them.
// 2. C streams ahead of the DP. Each warp keeps a ring of kRing steps of its
//    line in shared memory (one step is the D contiguous costs of a pixel),
//    filled by 16-byte cp.async copies kRing - 1 steps ahead of the step the
//    DP reads, so no global load sits on the DP's dependency chain.
// 3. S is accumulated with fire-and-forget reductions: red.global.add in its
//    .v4 / .v2 f32 form where the toolkit has it (PTX ISA 8.1, sm_90),
//    otherwise atomicAdd with its result unused (compiled to RED); chosen at
//    compile time. S is never loaded; the wrapper's zero fill is its only
//    other write.
//
// 4. The carry entry (K1c) replaces sgbm_pallas.py::_row_chunk_call /
//    _row_kernel_carry (:122 / :89), the row DP seeded from and drained to
//    an explicit (ndir, W, D) carry, which the band-streamed SGBM
//    (ops/sgbm.py::sgbm_disparity_banded) hands from band to band. A walk
//    of a vertical or diagonal direction takes its state before its first
//    step from carry_in, at the predecessor's column x - dx of the band's
//    first row (zero where that column leaves the image, as the JAX
//    package's _shift_carry); a walk that wraps round still starts its new
//    line at zero. At its last step, on the band's last row, it stores its
//    Lr into carry_out. That is one extra load a walk and one extra store,
//    outside the DP's chain. A null S skips the reductions (an upward sweep
//    that only records its carry). Horizontal directions take no carry; with
//    no carry and an S the launch is K1 as before.
//
// The reductions land in any order. Each Lr is computed exactly as the twin
// (ops/sgbm.py::aggregate_paths) computes it, and the twin sums S one
// direction after another; so the two agree bit for bit whenever every
// partial sum is exact in float32: integer-valued C, P1 and P2 with S below
// 2^24, as on the SGBM cost path (ops/sgbm.py). Otherwise they agree to
// float32 reassociation of the sum over directions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"

namespace {

constexpr float kBig = 1e9f;  // out-of-range neighbour, as the JAX _BIG
constexpr int kWarpsPerBlock = 4;
constexpr int kMaxDirections = 8;
constexpr unsigned kFull = 0xffffffffu;

#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ > 12 || (__CUDACC_VER_MAJOR__ == 12 && __CUDACC_VER_MINOR__ >= 1))
#define K1_VECTOR_RED 1
#else
#define K1_VECTOR_RED 0
#endif

// The directions of one call and the blocks each one owns:
// blocks [first_block[k], first_block[k + 1]) take the walks of (dy[k], dx[k]),
// whose carry (if the call has one) is slice carry_slot[k] of carry_in and
// carry_out.
struct Directions {
  int n;
  int dy[kMaxDirections];
  int dx[kMaxDirections];
  int carry_slot[kMaxDirections];
  int first_block[kMaxDirections + 1];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem_src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void red_add2(float* p, float a, float b) {
#if K1_VECTOR_RED
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(a), "f"(b) : "memory");
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
#endif
}

__device__ __forceinline__ void red_add4(float* p, float a, float b, float c, float d) {
#if K1_VECTOR_RED
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(a), "f"(b),
               "f"(c), "f"(d)
               : "memory");
#else
  atomicAdd(p, a);
  atomicAdd(p + 1, b);
  atomicAdd(p + 2, c);
  atomicAdd(p + 3, d);
#endif
}

// S[d0 .. d0 + VPT) += v, for the lane's disparities below d. With D % 16
// == 0, a lane of VPT 2, 4 or 8 holds all its disparities or none, and its
// first one is 8- or 16-byte aligned.
template <int VPT>
__device__ __forceinline__ void accumulate(float* p, const float (&v)[VPT], int d0, int d) {
  if constexpr (VPT % 4 == 0) {
    if (d0 < d) {
#pragma unroll
      for (int j = 0; j < VPT; j += 4) red_add4(p + j, v[j], v[j + 1], v[j + 2], v[j + 3]);
    }
  } else if constexpr (VPT == 2) {
    if (d0 < d) red_add2(p, v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (d0 + j < d) atomicAdd(p + j, v[j]);
    }
  }
}

// Walks of direction (dy, dx): h walks of w steps along the rows for a
// horizontal direction, else w walks of h steps from the first row, walk x
// starting at column x. A diagonal walk leaves the image's side at some row
// and goes on at the next row on the other side (the column wraps): that
// step starts a new path line, with zero state. So every walk of a vertical
// or diagonal direction meets the rows in the same order, one a step.
__host__ __device__ __forceinline__ int num_walks(int h, int w, int dy) {
  return dy == 0 ? h : w;
}

// Moves (y, x) one step along (dy, dx); true if the column wrapped (only a
// diagonal walk wraps before its last step).
__device__ __forceinline__ bool advance(int& y, int& x, int w, int dy, int dx) {
  y += dy;
  x += dx;
  if (x == w) {
    x = 0;
    return true;
  }
  if (x < 0) {
    x = w - 1;
    return true;
  }
  return false;
}

template <typename T, int VPT, int RING>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgbm_aggregate_kernel(const T* __restrict__ cost, float* __restrict__ s, int h, int w, int d,
                      Directions dirs, float p1, float p2, const float* __restrict__ carry_in,
                      float* __restrict__ carry_out) {
  static_assert(RING >= 4 && (RING & (RING - 1)) == 0, "the ring is a power of 2, >= 4 steps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int block = static_cast<int>(blockIdx.x);
  int dy = dirs.dy[0], dx = dirs.dx[0], slot = dirs.carry_slot[0], first_block = 0;
#pragma unroll
  for (int k = 1; k < kMaxDirections; ++k) {  // first_block rises with k
    if (k < dirs.n && block >= dirs.first_block[k]) {
      dy = dirs.dy[k];
      dx = dirs.dx[k];
      slot = dirs.carry_slot[k];
      first_block = dirs.first_block[k];
    }
  }
  const int walk = (block - first_block) * kWarpsPerBlock + warp;
  if (walk >= num_walks(h, w, dy)) return;  // the whole warp
  const int len = dy == 0 ? w : h;
  // the step the DP is at, and the step the next copy fetches
  int y = dy == 0 ? walk : (dy > 0 ? 0 : h - 1);
  int x = dy == 0 ? (dx > 0 ? 0 : w - 1) : walk;
  int fy = y, fx = x;
  T* ring = reinterpret_cast<T*>(smem) + static_cast<long long>(warp) * RING * d;
  constexpr int kPerChunk = 16 / static_cast<int>(sizeof(T));
  const int chunks = d / kPerChunk;  // 16-byte pieces of one step

  auto fetch = [&](int i) {  // step i, at (fy, fx), into its ring slot
    const T* g = cost + (static_cast<long long>(fy) * w + fx) * d;
    T* r = ring + (i & (RING - 1)) * d;
    for (int q = lane; q < chunks; q += 32) cp_async16(r + q * kPerChunk, g + q * kPerChunk);
  };
#pragma unroll
  for (int i = 0; i < RING - 1; ++i) {
    if (i < len) fetch(i);
    cp_async_commit();  // one group per step, empty past the walk's end
    advance(fy, fx, w, dy, dx);
  }

  const int d0 = lane * VPT;
  float lr[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) lr[j] = d0 + j < d ? 0.f : kBig;
  // the carried state before the first step: the predecessor's Lr on the
  // row above the band (below it for an upward walk), at column x - dx
  if (carry_in != nullptr && dy != 0 && x - dx >= 0 && x - dx < w) {
    const float* src = carry_in + (static_cast<long long>(slot) * w + (x - dx)) * d + d0;
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (d0 + j < d) lr[j] = src[j];
    }
  }

  for (int i = 0; i < len; ++i) {
    // step i has landed (at most RING - 2 younger groups pending); the
    // warp barrier makes every lane's copies visible and retires step
    // i - 1's reads of the slot the next copy overwrites
    cp_async_wait<RING - 2>();
    __syncwarp();
    if (i + RING - 1 < len) fetch(i + RING - 1);
    cp_async_commit();
    advance(fy, fx, w, dy, dx);

    const T* cur = ring + (i & (RING - 1)) * d;
    float c[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) c[j] = d0 + j < d ? to_float(cur[d0 + j]) : 0.f;

    float m = lr[0];
#pragma unroll
    for (int j = 1; j < VPT; ++j) m = fminf(m, lr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
    float left = __shfl_up_sync(kFull, lr[VPT - 1], 1);
    float right = __shfl_down_sync(kFull, lr[0], 1);
    if (lane == 0) left = kBig;
    if (lane == 31) right = kBig;
    float nl[VPT];
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      if (d0 + j < d) {
        const float up = j == 0 ? left : lr[j - 1];
        const float dn = j == VPT - 1 ? right : lr[j + 1];
        const float cand = fminf(fminf(lr[j], up + p1), fminf(dn + p1, m + p2));
        nl[j] = (c[j] + cand) - m;
      } else {
        nl[j] = kBig;
      }
    }
    if (s != nullptr) accumulate<VPT>(s + (static_cast<long long>(y) * w + x) * d + d0, nl, d0, d);
    if (carry_out != nullptr && dy != 0 && i == len - 1) {  // the band's last row
      float* dst = carry_out + (static_cast<long long>(slot) * w + x) * d + d0;
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (d0 + j < d) dst[j] = nl[j];
      }
    }
    const bool new_line = advance(y, x, w, dy, dx);
#pragma unroll
    for (int j = 0; j < VPT; ++j) lr[j] = new_line ? (d0 + j < d ? 0.f : kBig) : nl[j];
  }
  cp_async_wait<0>();
}

// The launch's arguments past the template's.
struct Args {
  const void* cost;
  float* s;
  int h, w, d;
  Directions dirs;
  float p1, p2;
  const float* carry_in;
  float* carry_out;
};

template <typename T, int VPT>
void launch(const Args& a, cudaStream_t stream) {
  constexpr int kRing = sizeof(T) == 2 ? 8 : 4;  // 256 B (bf16) or 512 B (f32) steps at D=128
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * kRing * a.d * sizeof(T);
  sgbm_aggregate_kernel<T, VPT, kRing>
      <<<a.dirs.first_block[a.dirs.n], kWarpsPerBlock * 32, smem, stream>>>(
          static_cast<const T*>(a.cost), a.s, a.h, a.w, a.d, a.dirs, a.p1, a.p2, a.carry_in,
          a.carry_out);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

template <int VPT>
void launch_vpt(const Args& a, bool bf16, cudaStream_t stream) {
  if (bf16) {
    launch<__nv_bfloat16, VPT>(a, stream);
  } else {
    launch<float, VPT>(a, stream);
  }
}

}  // namespace

void sgbm_aggregate_launch(const void* cost, bool cost_bf16, float* s, int h, int w, int d,
                           int ndirs, const int* dys, const int* dxs, float p1, float p2,
                           const float* carry_in, float* carry_out, cudaStream_t stream) {
  TORCH_CHECK(ndirs >= 1 && ndirs <= kMaxDirections, "sgbm_aggregate_launch: 1 to ",
              kMaxDirections, " directions, got ", ndirs);
  TORCH_CHECK(d > 0 && d <= 256 && d % 16 == 0,
              "sgbm_aggregate_launch: D must be a multiple of 16 in [16, 256], got ", d);
  if (h == 0 || w == 0) return;
  for (int k = 0; k < ndirs; ++k) {
    TORCH_CHECK(dys[k] >= -1 && dys[k] <= 1 && dxs[k] >= -1 && dxs[k] <= 1 &&
                    (dys[k] != 0 || dxs[k] != 0),
                "sgbm_aggregate_launch: bad direction (", dys[k], ", ", dxs[k], ")");
  }
  Args a{cost, s, h, w, d, Directions{}, p1, p2, carry_in, carry_out};
  Directions& dirs = a.dirs;
  dirs.n = ndirs;
  // a carried direction's slice of the carries: its rank among the call's
  // vertical and diagonal directions, in the caller's order
  int carry_slot[kMaxDirections];
  for (int k = 0, c = 0; k < ndirs; ++k) carry_slot[k] = dys[k] != 0 ? c++ : -1;
  int blocks = 0, slot = 0;
  // the downward directions first, then the upward ones, then the
  // horizontal ones, so that the walks that meet the same rows together
  // start together
  for (const int sweep : {1, -1, 0}) {
    for (int k = 0; k < ndirs; ++k) {
      if (dys[k] != sweep) continue;
      dirs.dy[slot] = dys[k];
      dirs.dx[slot] = dxs[k];
      dirs.carry_slot[slot] = carry_slot[k];
      dirs.first_block[slot] = blocks;
      blocks += (num_walks(h, w, dys[k]) + kWarpsPerBlock - 1) / kWarpsPerBlock;
      ++slot;
    }
  }
  dirs.first_block[slot] = blocks;
  switch ((d + 31) / 32) {
    case 1: launch_vpt<1>(a, cost_bf16, stream); break;
    case 2: launch_vpt<2>(a, cost_bf16, stream); break;
    case 3: launch_vpt<3>(a, cost_bf16, stream); break;
    case 4: launch_vpt<4>(a, cost_bf16, stream); break;
    case 5: launch_vpt<5>(a, cost_bf16, stream); break;
    case 6: launch_vpt<6>(a, cost_bf16, stream); break;
    case 7: launch_vpt<7>(a, cost_bf16, stream); break;
    default: launch_vpt<8>(a, cost_bf16, stream); break;
  }
}
