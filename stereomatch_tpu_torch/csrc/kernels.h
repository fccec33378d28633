// Host launchers of the hand-written Hopper kernels (sm_90a). Each
// launcher enqueues its kernel(s) on `stream`, allocates nothing and does
// not synchronise; it checks every launch with C10_CUDA_KERNEL_LAUNCH_CHECK.
#pragma once

#include <cstdint>
#include <cuda_runtime_api.h>

// K1 (sgbm_aggregate.cu): S += sum over the ndirs directions of Lr, one
// launch. cost (h, w, d) float32 or bfloat16, 16-byte aligned; s (h, w, d)
// float32, zero-filled by the caller, 16-byte aligned, or null to skip S;
// both contiguous; direction k is (dys[k], dxs[k]) = pixel - predecessor,
// each in {-1, 0, 1}; 1 <= ndirs <= 8; d a multiple of 16, at most 256.
// K1c, its carry entry: carry_in and carry_out, each null or (c, w, d)
// float32 contiguous, not overlapping, with c the number of directions with
// dy != 0 and slice j the j-th of them in the caller's order. A walk of
// such a direction starts from carry_in's state at column x - dx (zero
// outside the image) and stores its Lr on the last row it meets in
// carry_out.
void sgbm_aggregate_launch(const void* cost, bool cost_bf16, float* s, int h, int w, int d,
                           int ndirs, const int* dys, const int* dxs, float p1, float p2,
                           const float* carry_in, float* carry_out, cudaStream_t stream);

// K2 (seg_scan.cu): inclusive segmented prefix sum of each row of x (k, m)
// float32, segments restarting where reset (m,) is nonzero, in 256-element
// sub-blocks; one single-pass launch. The caller keeps one workspace `ws`
// per stream: at least seg_scan_plan(k, m).words 64-bit words, zero when
// first allocated and never cleared between calls. Each call takes the
// next epoch (1 .. 2^30 - 1; zero the workspace before an epoch comes
// round again) and id_base = the tile ids (seg_scan_plan(...).ids) that
// earlier calls on this workspace took. ws[1] and ws[2] count the look-
// backs (row 0 of each tile) and those that went past the tile before.
struct SegScanPlan {
  int64_t ids;    // tile ids the call takes (blocks it launches)
  int64_t words;  // workspace words it needs
};
SegScanPlan seg_scan_plan(int k, int64_t m);
void seg_scan_launch(const float* x, const uint8_t* reset, float* out, int k, int64_t m,
                     unsigned long long* ws, unsigned long long id_base, uint32_t epoch,
                     cudaStream_t stream);

// K2's ancestor-sum entry: out (k, n) = the in-event values of the
// segmented scan of +-v[:, src[j]] (minus where is_in[j] is 0) over the m
// events, stored at out[:, src[j]]; every node 0 <= src < n < 2^31 has one
// in-event. Same workspace protocol as seg_scan_launch.
void ancestor_sums_launch(const float* v, const int64_t* src, const uint8_t* is_in,
                          const uint8_t* reset, float* out, int k, int64_t n, int64_t m,
                          unsigned long long* ws, unsigned long long id_base, uint32_t epoch,
                          cudaStream_t stream);

// K3 (threefry.cu): threefry-2x32 draws keyed by the uint32 values held in
// key[0] and key[key_stride] (int64 words on the device, read by the
// kernel). The keys entry writes out (n, 2) int64, row i = threefry(key,
// (0, base + i)); the uniform entry writes out (n,) float32, element i =
// max(lo, fma(f, hi - lo, lo)) with f the top 23 bits of y0 ^ y1 of
// threefry(key, (i >> 32, i & 0xFFFFFFFF)) as a float in [0, 1). One
// launch each, none for n == 0.
void threefry_keys_launch(const int64_t* key, int64_t key_stride, uint32_t base, int64_t n,
                          int64_t* out, cudaStream_t stream);
void threefry_uniform_launch(const int64_t* key, int64_t key_stride, int64_t n, float lo,
                             float hi, float* out, cudaStream_t stream);

// K4 (guided_filter.cu): the zero-padded gray guided filter of an (h, w, d)
// float32 volume with an (h, w) float32 guide, window 2 radius + 1, eps;
// out (h, w, d) float32. All three contiguous, out not overlapping the
// inputs; 0 <= radius <= 9; any h, w, d. One launch, none when empty.
void guided_filter_launch(const float* guide, const float* vol, float* out, int h, int w, int d,
                          int radius, float eps, cudaStream_t stream);
