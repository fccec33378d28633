// PyTorch bindings of the Hopper kernels. The only source that includes
// torch/extension.h; the kernels themselves see raw pointers. The Python
// wrappers (ops/sgbm_cuda.py, ops/mst_scan_cuda.py) check device, dtype,
// shape and contiguity before calling in; the checks here guard the
// pointer arithmetic the kernels rely on.

#include <torch/extension.h>

#include <cstdint>
#include <vector>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

void check_cuda_contig(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

void sgbm_aggregate(const at::Tensor& cost, at::Tensor s, const std::vector<int64_t>& dys,
                    const std::vector<int64_t>& dxs, double p1, double p2) {
  check_cuda_contig(cost, "cost");
  check_cuda_contig(s, "s");
  TORCH_CHECK(cost.dim() == 3 && s.sizes() == cost.sizes(), "cost and s must be (H, W, D)");
  TORCH_CHECK(s.scalar_type() == at::kFloat, "s must be float32");
  const bool bf16 = cost.scalar_type() == at::kBFloat16;
  TORCH_CHECK(bf16 || cost.scalar_type() == at::kFloat, "cost must be float32 or bfloat16");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(cost.data_ptr()) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(s.data_ptr()) % 16 == 0,
              "cost and s must be 16-byte aligned");
  TORCH_CHECK(dys.size() == dxs.size(), "one dy per dx");
  const std::vector<int> dy(dys.begin(), dys.end()), dx(dxs.begin(), dxs.end());
  const c10::cuda::CUDAGuard guard(cost.device());
  sgbm_aggregate_launch(cost.data_ptr(), bf16, s.data_ptr<float>(), (int)cost.size(0),
                        (int)cost.size(1), (int)cost.size(2), (int)dy.size(), dy.data(),
                        dx.data(), (float)p1, (float)p2, at::cuda::getCurrentCUDAStream());
}

void seg_scan(const at::Tensor& x, const at::Tensor& reset, at::Tensor out,
              at::Tensor agg_v, at::Tensor agg_f, at::Tensor nc_end, at::Tensor carry) {
  const std::initializer_list<const at::Tensor*> operands = {&x,     &reset,  &out,  &agg_v,
                                                             &agg_f, &nc_end, &carry};
  for (const at::Tensor* t : operands) check_cuda_contig(*t, "seg_scan operand");
  TORCH_CHECK(x.dim() == 2 && x.scalar_type() == at::kFloat, "x must be (K, M) float32");
  TORCH_CHECK(out.sizes() == x.sizes() && out.scalar_type() == at::kFloat, "bad out");
  TORCH_CHECK(reset.dim() == 1 && reset.size(0) == x.size(1) &&
                  reset.scalar_type() == at::kByte, "reset must be (M,) uint8");
  const int64_t k = x.size(0), m = x.size(1), nb = (m + 255) / 256;
  TORCH_CHECK(k <= 65535, "x may have at most 65535 rows (the grid's y extent), got ", k);
  TORCH_CHECK(agg_v.numel() == k * nb && carry.numel() == k * nb && agg_f.numel() == k * nb &&
                  nc_end.numel() == k * nb, "scratch must hold K * ceil(M / 256) entries");
  TORCH_CHECK(agg_v.scalar_type() == at::kFloat && carry.scalar_type() == at::kFloat &&
                  agg_f.scalar_type() == at::kByte && nc_end.scalar_type() == at::kInt,
              "bad scratch dtypes");
  const c10::cuda::CUDAGuard guard(x.device());
  seg_scan_launch(x.data_ptr<float>(), reset.data_ptr<uint8_t>(), out.data_ptr<float>(),
                  agg_v.data_ptr<float>(), agg_f.data_ptr<uint8_t>(),
                  nc_end.data_ptr<int32_t>(), carry.data_ptr<float>(), (int)k, m,
                  at::cuda::getCurrentCUDAStream());
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("sgbm_aggregate", &sgbm_aggregate, "K1: S += sum of Lr over the given directions");
  m.def("seg_scan", &seg_scan, "K2: segmented inclusive prefix sum along rows");
}
