// Host launchers of the hand-written Hopper kernels (sm_90a). Each
// launcher enqueues its kernel(s) on `stream`, allocates nothing and does
// not synchronise; it checks every launch with C10_CUDA_KERNEL_LAUNCH_CHECK.
#pragma once

#include <cstdint>
#include <cuda_runtime_api.h>

// K1 (sgbm_aggregate.cu): S += sum over the ndirs directions of Lr, one
// launch. cost (h, w, d) float32 or bfloat16, 16-byte aligned; s (h, w, d)
// float32, zero-filled by the caller, 16-byte aligned; both contiguous;
// direction k is (dys[k], dxs[k]) = pixel - predecessor, each in {-1, 0, 1};
// 1 <= ndirs <= 8; d a multiple of 16, at most 256.
void sgbm_aggregate_launch(const void* cost, bool cost_bf16, float* s, int h, int w, int d,
                           int ndirs, const int* dys, const int* dxs, float p1, float p2,
                           cudaStream_t stream);

// K2 (seg_scan.cu): inclusive segmented prefix sum of each row of x (k, m)
// float32, segments restarting where reset (m,) is nonzero, in 256-element
// sub-blocks. Scratch: agg_v, carry (k, nb) float32; agg_f (k, nb) uint8;
// nc_end (k, nb) int32, nb = ceil(m / 256).
void seg_scan_launch(const float* x, const uint8_t* reset, float* out, float* agg_v,
                     uint8_t* agg_f, int32_t* nc_end, float* carry, int k, int64_t m,
                     cudaStream_t stream);
