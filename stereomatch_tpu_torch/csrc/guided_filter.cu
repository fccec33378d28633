// K4: the zero-padded gray guided filter of an (H, W, D) float32 cost
// volume on Hopper (sm_90a), one launch a view.
//
// Replaces no TPU kernel: the JAX package leaves the filter to XLA
// (stereomatch_tpu/ops/filters.py::guided_filter_volume, cumsum box
// filters a 16-slice slab). The port ran the same eager code: 4 box filters
// a slab, each two padded cumsums plus differences and scalings, 432
// launches a view at the rig's 2048x1536x100, 1% of the bound below. This
// kernel computes the same stages in the same order, all in float32:
// mean_g, var_g = mean(g g) - mean_g^2, mean_p, corr_gp = mean(g p),
// a = (corr_gp - mean_g mean_p) / (var_g + eps), b = mean_p - a mean_g,
// out = mean(a) g + mean(b), every mean a (2r+1)^2 window sum over the
// zero-padded image times 1 / (2r+1)^2. The guide statistics are computed
// inside K4 too (by every block, for its own columns), so a view is one
// launch and nothing else.
//
// What bounds it: bytes. A view reads its volume and its guide once and
// writes the filtered volume once, (2 D + 1) H W 4 bytes: 2.53 GB, 0.755 ms
// at 3.35 TB/s for 2048x1536x100. A window sum done directly costs 2r + 1
// adds an element and stage; the design keeps every intermediate on chip
// and brings each window sum down to a few operations:
//   - A block owns kTW = 28 output columns and kDC = 8 consecutive
//     disparities (32 bytes a pixel) and walks down a segment of rows, one
//     input row a step. Every thread copies its share of the row kPref rows
//     ahead (cp.async: 16 bytes of the volume or one guide value a thread)
//     into a ring of 2r + 3 + kPref rows in shared memory; halo re-reads of
//     the neighbouring blocks hit L2.
//   - Phase A: vertical window sums of p and g p (threads 0-127, four
//     disparities each) and of g and g g (threads 128-143, four columns
//     each) for every input column, running sums in registers (add the new
//     row, take the row 2r + 1 above out of the ring), summed afresh from
//     the ring every kAnchor steps so that rounding cannot drift down the
//     image.
//   - Phase B, three roles at once, each a step behind the one before, so
//     that no role waits for another inside a step: one warp turns the
//     guide's vertical sums into mean_g and 1 / (var_g + eps) at this step's
//     centre row; three warps take the previous step's vertical sums of p
//     and g p across kRun columns a thread (the first window summed as a
//     tree, then slid) into a and b; two warps take a and b of the step
//     before that across their columns, keep the last 2r + 1 rows of those
//     sums in a ring and vertical running sums of them (re-summed every
//     kAnchor rows), and write out = mean_a g + mean_b for the row 2r above,
//     once.
//   - The radius is a template parameter (0 to kMaxRadius), so every window
//     and ring index is a constant. Rows are split into segments where the
//     grid would not fill the card twice; a segment re-reads 4r rows.
// What bounds the design on the H100 is the issue of shared-memory
// instructions: about 0.47 32-bit loads a cycle an SM (0.42 64-bit, 0.24
// 128-bit, the last at the full 128 bytes a cycle), and phase B's window
// sums read their columns 32 bits at a time. Its time follows the count of
// those instructions a step (variants of this kernel timed on the H100,
// PERF.md section 6); moving two disparities a thread to 64-bit reads left
// too few warps to hide the latency, and was slower.
// Zero padding is the image's border: rows and columns outside the image
// load as zeros, and a and b outside it are zero, as the eager box filters
// pad each pass. Any H, W, D >= 1.

#include <cstdint>

#include <algorithm>

#include <cuda_runtime.h>

#include <c10/cuda/CUDAException.h>

#include "kernels.h"

namespace {

constexpr int kMaxRadius = 9;
constexpr int kDC = 8;       // disparities a block
constexpr int kTW = 28;      // output columns a block
constexpr int kRun = 4;      // columns a thread's horizontal window sums slide over
constexpr int kPref = 5;     // input rows in flight ahead of the one consumed
constexpr int kAnchor = 32;  // steps between direct sums of a running vertical sum
constexpr int kMinSegRows = 64;
constexpr int kThreads = 192;  // warps 0-2 a and b, 3-4 the output, 5 the guide statistics
constexpr int kXIn = kTW + 4 * kMaxRadius;                        // 64 input columns
constexpr int kRuns1 = (kTW + 2 * kMaxRadius + kRun - 1) / kRun;  // 12 runs of a, b columns
constexpr int kRuns2 = kTW / kRun;                                // 7 runs of output columns
constexpr int kOut = kRuns2 * kDC;                                // 56 output threads
constexpr int kRing = 2 * kMaxRadius + 3 + kPref;                 // input rows held
// columns of the vertical sums: the a, b slides read 66, rounded up to rows
// of whole 16-byte pieces
constexpr int kVSCols = kRuns1 * kRun + 2 * kMaxRadius + 2;
constexpr int kABCols = kRuns1 * kRun;
// floats a column of the slid arrays: 8 disparities and 2 of padding, so
// that the 32 lanes of a warp (8 disparities x 4 runs kRun apart) read 32
// banks
constexpr int kPitch = 10;
static_assert(kRuns1 * kDC == 3 * 32 && kOut <= 2 * 32 && kRuns1 <= 32, "warp roles");
static_assert(kDC == 8 && kXIn % 4 == 0 && 2 * kXIn + kXIn / 4 <= kThreads, "phase A items");
static_assert(2 * kXIn + kXIn <= kThreads, "one copy a thread a row");

struct Smem {
  float p[kRing][kXIn][kDC];           // input rows of the volume (cp.async, 16-byte aligned)
  float g[kRing][kXIn];                // input rows of the guide
  float vs[2][2][kVSCols][kPitch];     // vertical window sums of p and g p, by step parity
  float vg[2][2][kVSCols];             // ... of g and g g
  float ab[2][2][kABCols][kPitch];     // a and b, by the parity of the step that made them
  float mgiv[2][2][kABCols];           // mean_g and 1 / (var_g + eps), by step parity
  float ring2[2 * kMaxRadius + 1][2][kRun][kOut];  // horizontal sums of a and b, last rows
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x[0] + ... + x[N - 1], summed as a balanced tree
template <int N>
__device__ __forceinline__ float tree_sum(const float* x) {
  if constexpr (N == 1) {
    return x[0];
  } else {
    return tree_sum<N / 2>(x) + tree_sum<N - N / 2>(x + N / 2);
  }
}

// out[i] = x[i] + ... + x[i + 2R] for i < kRun: the first window as a
// tree, each next one slid by a column
template <int R>
__device__ __forceinline__ void slide(const float* x, float (&out)[kRun]) {
  float s = tree_sum<2 * R + 1>(x);
  out[0] = s;
#pragma unroll
  for (int i = 1; i < kRun; ++i) {
    s = s + x[i + 2 * R] - x[i - 1];
    out[i] = s;
  }
}

// the window sums of one value a column, columns `stride` floats apart
template <int R>
__device__ __forceinline__ void window_sums(const float* v, int stride, float (&out)[kRun]) {
  float x[kRun + 2 * R];
#pragma unroll
  for (int c = 0; c < kRun + 2 * R; ++c) x[c] = v[c * stride];
  slide<R>(x, out);
}

// the window sums of one value a column, in 16-byte pieces (v 16-byte
// aligned; reads up to 3 columns past the last window)
template <int R>
__device__ __forceinline__ void window_sums4(const float* v, float (&out)[kRun]) {
  constexpr int n4 = (kRun + 2 * R + 3) / 4;
  float x[4 * n4];
#pragma unroll
  for (int c = 0; c < n4; ++c) {
    const float4 e = reinterpret_cast<const float4*>(v)[c];
    x[4 * c] = e.x, x[4 * c + 1] = e.y, x[4 * c + 2] = e.z, x[4 * c + 3] = e.w;
  }
  slide<R>(x, out);
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    guided_filter_kernel(const float* __restrict__ guide, const float* __restrict__ vol,
                         float* __restrict__ out, int h, int w, int d, float eps, int seg_rows,
                         bool vec) {
  constexpr int win = 2 * R + 1, xin = kTW + 4 * R, x1n = kTW + 2 * R;
  constexpr int ring = 2 * R + 3 + kPref;
  constexpr float inv_n = 1.0f / static_cast<float>(win * win);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int x0 = blockIdx.x * kTW, d0 = blockIdx.y * kDC;
  const int ya = blockIdx.z * seg_rows, yb = min(h, ya + seg_rows);
  const int y0 = ya - 2 * R;  // the walk's first input row
  // phase A takes walk row s at step s; a and b of its centre row at s + 1;
  // their sums the output row 2R above at s + 2
  const int nsteps = (yb - ya) + 4 * R + 2;

  for (int i = tid; i < static_cast<int>(sizeof(Smem) / 16); i += kThreads)
    reinterpret_cast<float4*>(smem_raw)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // this thread's copy of each row: threads 0-127 half a pixel's 8
  // disparities (16 bytes), 128-191 a guide value, of input column xc
  // (global x0 - 2R + xc)
  const bool p_copy = tid < 2 * kXIn;
  const int xc = p_copy ? tid >> 1 : tid - 2 * kXIn, gxc = x0 - 2 * R + xc;
  const bool col_ok = xc < xin && gxc >= 0 && gxc < w;
  const int dq = d0 + 4 * (tid & 1);
  const int64_t row_stride = p_copy ? static_cast<int64_t>(w) * d : w;
  const float* src0 = p_copy ? vol + static_cast<int64_t>(gxc) * d + dq : guide + gxc;
  // walk row k (input row y0 + k) into ring slot `slot`, zeros outside the
  // image; one commit group a row
  auto load_row = [&](int k, int slot) {
    const int y = y0 + k;
    const bool ok = col_ok && y >= 0 && y < h;
    const float* src = ok ? src0 + y * row_stride : vol;
    if (!p_copy) {
      if (xc < xin) cp_async4(&sm.g[slot][xc], src, ok ? 4 : 0);
    } else if (vec) {
      if (xc < xin) cp_async16(&sm.p[slot][xc][dq - d0], src, ok && dq < d ? 16 : 0);
    } else {
      for (int i = tid; i < xin * kDC; i += 2 * kXIn) {
        const int xi = i >> 3, dd = i & 7, gx = x0 - 2 * R + xi;
        const bool in = y >= 0 && y < h && gx >= 0 && gx < w && d0 + dd < d;
        const float* e = in ? vol + (static_cast<int64_t>(y) * w + gx) * d + d0 + dd : vol;
        cp_async4(&sm.p[slot][xi][dd], e, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int k = 0; k < kPref; ++k) load_row(k, k);

  // phase A's running sums: of p and g p, or of g and g g for a guide quad
  float4 ap = make_float4(0.f, 0.f, 0.f, 0.f), agp = ap;
  float va[kRun] = {0.f, 0.f, 0.f, 0.f}, vb[kRun] = {0.f, 0.f, 0.f, 0.f};  // output warps
  // ring slots of walk rows s, s - 2R - 1 and s + kPref; ring2's of stage 2's row
  int sn = 0, so = ring - 2 * R - 1, sl = kPref, s2 = 0;

  for (int s = 0; s < nsteps; ++s) {
    cp_async_wait<kPref - 1>();  // this thread's copies of walk row s have landed
    __syncthreads();
    if (s + kPref < nsteps) {
      load_row(s + kPref, sl);  // into the slot of walk row s - 2R - 3, read by no one now
    } else {
      cp_async_commit();  // an empty group: one a step keeps the wait count
    }

    // ---- phase A: vertical window sums at centre row y0 + s - R: threads
    // 0-127 four disparities of input column tid / 2, threads 128-143 the
    // guide at four input columns ----
    const bool anchor = (s & (kAnchor - 1)) == 0;
    if (tid < 2 * kXIn) {
      const int xi = tid >> 1, q4 = 4 * (tid & 1);
      if (xi < xin) {
        if (anchor) {
          float4 sp = make_float4(0.f, 0.f, 0.f, 0.f), sgp = sp;
#pragma unroll
          for (int t = 0; t < win; ++t) {
            const int slot = sn - t + (sn < t ? ring : 0);
            const float4 v = *reinterpret_cast<const float4*>(&sm.p[slot][xi][q4]);
            const float gv = sm.g[slot][xi];
            sp = make_float4(sp.x + v.x, sp.y + v.y, sp.z + v.z, sp.w + v.w);
            sgp = make_float4(fmaf(gv, v.x, sgp.x), fmaf(gv, v.y, sgp.y), fmaf(gv, v.z, sgp.z),
                              fmaf(gv, v.w, sgp.w));
          }
          ap = sp, agp = sgp;
        } else {
          const float4 pn = *reinterpret_cast<const float4*>(&sm.p[sn][xi][q4]);
          const float4 po = *reinterpret_cast<const float4*>(&sm.p[so][xi][q4]);
          const float gn = sm.g[sn][xi], go = sm.g[so][xi];
          ap = make_float4(ap.x + pn.x - po.x, ap.y + pn.y - po.y, ap.z + pn.z - po.z,
                           ap.w + pn.w - po.w);
          agp = make_float4(fmaf(-go, po.x, fmaf(gn, pn.x, agp.x)),
                            fmaf(-go, po.y, fmaf(gn, pn.y, agp.y)),
                            fmaf(-go, po.z, fmaf(gn, pn.z, agp.z)),
                            fmaf(-go, po.w, fmaf(gn, pn.w, agp.w)));
        }
        float2* v0 = reinterpret_cast<float2*>(&sm.vs[s & 1][0][xi][q4]);
        float2* v1 = reinterpret_cast<float2*>(&sm.vs[s & 1][1][xi][q4]);
        v0[0] = make_float2(ap.x, ap.y), v0[1] = make_float2(ap.z, ap.w);
        v1[0] = make_float2(agp.x, agp.y), v1[1] = make_float2(agp.z, agp.w);
      }
    } else if (tid < 2 * kXIn + kXIn / 4) {
      const int xg = 4 * (tid - 2 * kXIn);
      if (xg < xin) {
        if (anchor) {
          float4 sg = make_float4(0.f, 0.f, 0.f, 0.f), sgg = sg;
#pragma unroll
          for (int t = 0; t < win; ++t) {
            const float4 v =
                *reinterpret_cast<const float4*>(&sm.g[sn - t + (sn < t ? ring : 0)][xg]);
            sg = make_float4(sg.x + v.x, sg.y + v.y, sg.z + v.z, sg.w + v.w);
            sgg = make_float4(fmaf(v.x, v.x, sgg.x), fmaf(v.y, v.y, sgg.y),
                              fmaf(v.z, v.z, sgg.z), fmaf(v.w, v.w, sgg.w));
          }
          ap = sg, agp = sgg;
        } else {
          const float4 gn = *reinterpret_cast<const float4*>(&sm.g[sn][xg]);
          const float4 go = *reinterpret_cast<const float4*>(&sm.g[so][xg]);
          ap = make_float4(ap.x + gn.x - go.x, ap.y + gn.y - go.y, ap.z + gn.z - go.z,
                           ap.w + gn.w - go.w);
          agp = make_float4(fmaf(-go.x, go.x, fmaf(gn.x, gn.x, agp.x)),
                            fmaf(-go.y, go.y, fmaf(gn.y, gn.y, agp.y)),
                            fmaf(-go.z, go.z, fmaf(gn.z, gn.z, agp.z)),
                            fmaf(-go.w, go.w, fmaf(gn.w, gn.w, agp.w)));
        }
        *reinterpret_cast<float4*>(&sm.vg[s & 1][0][xg]) = ap;
        *reinterpret_cast<float4*>(&sm.vg[s & 1][1][xg]) = agp;
      }
    }
    __syncthreads();

    // ---- phase B ----
    if (warp < 3) {
      // a and b at centre row c1 = y0 + s - 1 - R, columns x1 = xa + i
      // (global x0 - R + x1), from phase A's sums of the step before
      const int dd = tid & 7, xa = (tid >> 3) * kRun, c1 = y0 + s - 1 - R;
      if (s >= 1 && xa < x1n) {
        const int b1 = (s - 1) & 1;
        float sp[kRun], sgp[kRun];
        window_sums<R>(&sm.vs[b1][0][xa][dd], kPitch, sp);
        window_sums<R>(&sm.vs[b1][1][xa][dd], kPitch, sgp);
        const float4 mg4 = *reinterpret_cast<const float4*>(&sm.mgiv[b1][0][xa]);
        const float4 iv4 = *reinterpret_cast<const float4*>(&sm.mgiv[b1][1][xa]);
        const float mg[kRun] = {mg4.x, mg4.y, mg4.z, mg4.w};
        const float iv[kRun] = {iv4.x, iv4.y, iv4.z, iv4.w};
        const bool row_in = c1 >= 0 && c1 < h;
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          const int x1 = xa + i, gx = x0 - R + x1;
          const float mp = sp[i] * inv_n, corr = sgp[i] * inv_n;
          const bool in = row_in && gx >= 0 && gx < w;
          const float a = in ? (corr - mg[i] * mp) * iv[i] : 0.f;
          const float b = in ? mp - a * mg[i] : 0.f;
          if (x1 < x1n) {
            sm.ab[b1][0][x1][dd] = a;
            sm.ab[b1][1][x1][dd] = b;
          }
        }
      }
    } else if (warp < 5) {
      // a and b of centre row y0 + s - 2 - R (stage 2's row k): their
      // horizontal sums into the ring, the vertical running sums, and the
      // output row 2R above them
      const int t2 = tid - 96, dd = t2 & 7, xo = (t2 >> 3) * kRun, k = s - 2 - 2 * R;
      if (t2 < kOut && k >= 0) {
        const int b2 = s & 1;  // = (s - 2) & 1
        float ha[kRun], hb[kRun];
        window_sums<R>(&sm.ab[b2][0][xo][dd], kPitch, ha);
        window_sums<R>(&sm.ab[b2][1][xo][dd], kPitch, hb);
        // every shared load before any store: the compiler cannot tell the
        // arrays apart, and a load behind a store waits for it
        const int gslot = k % ring;  // walk row k
        float ea[kRun], eb[kRun], gv[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          ea[i] = sm.ring2[s2][0][i][t2];
          eb[i] = sm.ring2[s2][1][i][t2];
          gv[i] = sm.g[gslot][xo + i + 2 * R];
        }
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          va[i] = va[i] + ha[i] - ea[i];
          vb[i] = vb[i] + hb[i] - eb[i];
          sm.ring2[s2][0][i][t2] = ha[i];
          sm.ring2[s2][1][i][t2] = hb[i];
        }
        if ((k & (kAnchor - 1)) == 0) {
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            float xa_[win], xb_[win];
#pragma unroll
            for (int t = 0; t < win; ++t) {
              xa_[t] = sm.ring2[t][0][i][t2];
              xb_[t] = sm.ring2[t][1][i][t2];
            }
            va[i] = tree_sum<win>(xa_);
            vb[i] = tree_sum<win>(xb_);
          }
        }
        if (k >= 2 * R && d0 + dd < d) {
          float* row = out + (static_cast<int64_t>(y0 + k) * w + x0 + xo) * d + d0 + dd;
#pragma unroll
          for (int i = 0; i < kRun; ++i) {
            if (x0 + xo + i < w)
              row[static_cast<int64_t>(i) * d] = (va[i] * inv_n) * gv[i] + vb[i] * inv_n;
          }
        }
        s2 = s2 == 2 * R ? 0 : s2 + 1;
      }
    } else {
      // the guide's statistics at this step's centre row, for the a, b warps
      // of the next step: lanes 0-11, 4 columns each, read 16 bytes at a time
      const int lane = tid & 31, xa = lane * kRun;
      if (lane < kRuns1 && xa < x1n) {
        float sg[kRun], sgg[kRun];
        window_sums4<R>(&sm.vg[s & 1][0][xa], sg);
        window_sums4<R>(&sm.vg[s & 1][1][xa], sgg);
        float mg[kRun], iv[kRun];
#pragma unroll
        for (int i = 0; i < kRun; ++i) {
          mg[i] = sg[i] * inv_n;
          iv[i] = 1.0f / (sgg[i] * inv_n - mg[i] * mg[i] + eps);
        }
        *reinterpret_cast<float4*>(&sm.mgiv[s & 1][0][xa]) =
            make_float4(mg[0], mg[1], mg[2], mg[3]);
        *reinterpret_cast<float4*>(&sm.mgiv[s & 1][1][xa]) =
            make_float4(iv[0], iv[1], iv[2], iv[3]);
      }
    }
    sn = sn == ring - 1 ? 0 : sn + 1;
    so = so == ring - 1 ? 0 : so + 1;
    sl = sl == ring - 1 ? 0 : sl + 1;
  }
  cp_async_wait<0>();
}

int g_occupancy[kMaxRadius + 1][64] = {};  // blocks an SM, by radius and device; 0 until asked

template <int R>
void launch(const float* guide, const float* vol, float* out, int h, int w, int d, float eps,
            cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(Smem));
  int dev = 0, sms = 0;
  C10_CUDA_CHECK(cudaGetDevice(&dev));
  C10_CUDA_CHECK(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  int& occ = g_occupancy[R][dev & 63];
  if (occ == 0) {
    C10_CUDA_CHECK(cudaFuncSetAttribute(guided_filter_kernel<R>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
    C10_CUDA_CHECK(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, guided_filter_kernel<R>,
                                                                 kThreads, smem));
    occ = std::max(occ, 1);
  }
  const int strips = (w + kTW - 1) / kTW, chunks = (d + kDC - 1) / kDC;
  // at least two full waves of blocks, segments of at least kMinSegRows rows
  const int64_t blocks = static_cast<int64_t>(strips) * chunks;
  const int64_t want = (2LL * sms * occ + blocks - 1) / blocks;
  const int segs = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(want, (h + kMinSegRows - 1) / kMinSegRows)));
  const int seg_rows = (h + segs - 1) / segs;
  const dim3 grid(strips, chunks, (h + seg_rows - 1) / seg_rows);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(vol) % 16 == 0;
  guided_filter_kernel<R>
      <<<grid, kThreads, smem, stream>>>(guide, vol, out, h, w, d, eps, seg_rows, vec);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

}  // namespace

void guided_filter_launch(const float* guide, const float* vol, float* out, int h, int w, int d,
                          int radius, float eps, cudaStream_t stream) {
  if (h <= 0 || w <= 0 || d <= 0) return;
  switch (radius) {
    case 0: return launch<0>(guide, vol, out, h, w, d, eps, stream);
    case 1: return launch<1>(guide, vol, out, h, w, d, eps, stream);
    case 2: return launch<2>(guide, vol, out, h, w, d, eps, stream);
    case 3: return launch<3>(guide, vol, out, h, w, d, eps, stream);
    case 4: return launch<4>(guide, vol, out, h, w, d, eps, stream);
    case 5: return launch<5>(guide, vol, out, h, w, d, eps, stream);
    case 6: return launch<6>(guide, vol, out, h, w, d, eps, stream);
    case 7: return launch<7>(guide, vol, out, h, w, d, eps, stream);
    case 8: return launch<8>(guide, vol, out, h, w, d, eps, stream);
    case 9: return launch<9>(guide, vol, out, h, w, d, eps, stream);
    default: TORCH_CHECK(false, "K4 takes 0 <= radius <= 9, got ", radius);
  }
}
