// PyTorch bindings of the Hopper kernels. The only source that includes
// torch/extension.h; the kernels themselves see raw pointers. The Python
// wrappers (ops/sgbm_cuda.py, ops/mst_scan_cuda.py, random.py) check device, dtype,
// shape and contiguity before calling in; the checks here guard the
// pointer arithmetic the kernels rely on.

#include <torch/extension.h>

#include <cstdint>
#include <initializer_list>
#include <tuple>
#include <vector>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAGuard.h>

#include "kernels.h"

namespace {

void check_cuda_contig(const at::Tensor& t, const char* name) {
  TORCH_CHECK(t.is_cuda(), name, " must be a CUDA tensor");
  TORCH_CHECK(t.is_contiguous(), name, " must be contiguous");
}

// K1 and its carry entry K1c. An empty s, carry_in or carry_out stands
// for none (null in the launcher).
void sgbm_aggregate(const at::Tensor& cost, at::Tensor s, const std::vector<int64_t>& dys,
                    const std::vector<int64_t>& dxs, double p1, double p2,
                    const at::Tensor& carry_in, const at::Tensor& carry_out) {
  check_cuda_contig(cost, "cost");
  TORCH_CHECK(cost.dim() == 3, "cost must be (H, W, D)");
  const bool bf16 = cost.scalar_type() == at::kBFloat16;
  TORCH_CHECK(bf16 || cost.scalar_type() == at::kFloat, "cost must be float32 or bfloat16");
  TORCH_CHECK(reinterpret_cast<uintptr_t>(cost.data_ptr()) % 16 == 0,
              "cost must be 16-byte aligned");
  TORCH_CHECK(dys.size() == dxs.size(), "one dy per dx");
  const std::vector<int> dy(dys.begin(), dys.end()), dx(dxs.begin(), dxs.end());
  float* s_ptr = nullptr;
  if (s.numel() > 0) {
    check_cuda_contig(s, "s");
    TORCH_CHECK(s.sizes() == cost.sizes() && s.scalar_type() == at::kFloat,
                "s must be float32 of cost's shape");
    TORCH_CHECK(reinterpret_cast<uintptr_t>(s.data_ptr()) % 16 == 0, "s must be 16-byte aligned");
    s_ptr = s.data_ptr<float>();
  }
  int64_t carried = 0;
  for (const int v : dy) carried += v != 0;
  const float* in_ptr = nullptr;
  float* out_ptr = nullptr;
  for (const at::Tensor* t : std::initializer_list<const at::Tensor*>{&carry_in, &carry_out}) {
    if (t->numel() == 0) continue;
    check_cuda_contig(*t, "carry");
    TORCH_CHECK(t->scalar_type() == at::kFloat && t->dim() == 3 && t->size(0) == carried &&
                    t->size(1) == cost.size(1) && t->size(2) == cost.size(2),
                "carries must be float32 (", carried, ", W, D)");
  }
  if (carry_in.numel() > 0) in_ptr = carry_in.data_ptr<float>();
  if (carry_out.numel() > 0) out_ptr = carry_out.data_ptr<float>();
  const c10::cuda::CUDAGuard guard(cost.device());
  sgbm_aggregate_launch(cost.data_ptr(), bf16, s_ptr, (int)cost.size(0), (int)cost.size(1),
                        (int)cost.size(2), (int)dy.size(), dy.data(), dx.data(), (float)p1,
                        (float)p2, in_ptr, out_ptr, at::cuda::getCurrentCUDAStream());
}

std::tuple<int64_t, int64_t> plan(int64_t k, int64_t m) {
  TORCH_CHECK(k >= 0 && k < (1 << 30) && m >= 0, "bad K2 shape (", k, ", ", m, ")");
  const SegScanPlan p = seg_scan_plan((int)k, m);
  TORCH_CHECK(p.ids < (int64_t(1) << 31), "K2 call too large: ", p.ids, " tiles");
  return {p.ids, p.words};
}

// K2's workspace: int64 words on x's device, as many as the call's plan
unsigned long long* check_workspace(const at::Tensor& ws, const at::Tensor& x, int64_t k,
                                    int64_t m, int64_t epoch) {
  check_cuda_contig(ws, "ws");
  TORCH_CHECK(ws.scalar_type() == at::kLong && ws.device() == x.device(), "bad K2 workspace");
  TORCH_CHECK(ws.numel() >= std::get<1>(plan(k, m)), "K2 workspace too small");
  TORCH_CHECK(epoch >= 1 && epoch < (int64_t(1) << 30), "K2 epoch out of range: ", epoch);
  return reinterpret_cast<unsigned long long*>(ws.data_ptr<int64_t>());
}

void seg_scan(const at::Tensor& x, const at::Tensor& reset, at::Tensor out, const at::Tensor& ws,
              int64_t id_base, int64_t epoch) {
  for (const at::Tensor* t : std::initializer_list<const at::Tensor*>{&x, &reset, &out})
    check_cuda_contig(*t, "seg_scan operand");
  TORCH_CHECK(x.dim() == 2 && x.scalar_type() == at::kFloat, "x must be (K, M) float32");
  TORCH_CHECK(out.sizes() == x.sizes() && out.scalar_type() == at::kFloat, "bad out");
  TORCH_CHECK(reset.dim() == 1 && reset.size(0) == x.size(1) &&
                  reset.scalar_type() == at::kByte, "reset must be (M,) uint8");
  const int64_t k = x.size(0), m = x.size(1);
  unsigned long long* w = check_workspace(ws, x, k, m, epoch);
  const c10::cuda::CUDAGuard guard(x.device());
  seg_scan_launch(x.data_ptr<float>(), reset.data_ptr<uint8_t>(), out.data_ptr<float>(),
                  (int)k, m, w, (unsigned long long)id_base, (uint32_t)epoch,
                  at::cuda::getCurrentCUDAStream());
}

void ancestor_sums(const at::Tensor& v, const at::Tensor& src, const at::Tensor& is_in,
                   const at::Tensor& reset, at::Tensor out, const at::Tensor& ws,
                   int64_t id_base, int64_t epoch) {
  for (const at::Tensor* t :
       std::initializer_list<const at::Tensor*>{&v, &src, &is_in, &reset, &out})
    check_cuda_contig(*t, "ancestor_sums operand");
  TORCH_CHECK(v.dim() == 2 && v.scalar_type() == at::kFloat, "v must be (K, N) float32");
  TORCH_CHECK(out.sizes() == v.sizes() && out.scalar_type() == at::kFloat, "bad out");
  const int64_t k = v.size(0), n = v.size(1), m = src.numel();
  TORCH_CHECK(n < (int64_t(1) << 31), "at most 2^31 - 1 nodes");
  TORCH_CHECK(src.dim() == 1 && src.scalar_type() == at::kLong, "euler_src must be (M,) int64");
  for (const at::Tensor* t : {&is_in, &reset})
    TORCH_CHECK(t->dim() == 1 && t->size(0) == m && t->scalar_type() == at::kByte,
                "euler_is_in and euler_reset must be (M,) uint8");
  unsigned long long* w = check_workspace(ws, v, k, m, epoch);
  const c10::cuda::CUDAGuard guard(v.device());
  ancestor_sums_launch(v.data_ptr<float>(), src.data_ptr<int64_t>(), is_in.data_ptr<uint8_t>(),
                       reset.data_ptr<uint8_t>(), out.data_ptr<float>(), (int)k, n, m, w,
                       (unsigned long long)id_base, (uint32_t)epoch,
                       at::cuda::getCurrentCUDAStream());
}

// K3's key: an int64 (2,) tensor on out's device, read by the kernel
const int64_t* check_key(const at::Tensor& key, const at::Tensor& out) {
  TORCH_CHECK(key.is_cuda() && key.scalar_type() == at::kLong && key.dim() == 1 &&
                  key.size(0) == 2, "a key must be an int64 CUDA tensor of shape (2,)");
  check_cuda_contig(out, "out");
  TORCH_CHECK(out.device() == key.device(), "out must be on the key's device");
  return key.data_ptr<int64_t>();
}

void threefry_keys(const at::Tensor& key, int64_t base, at::Tensor out) {
  const int64_t* k = check_key(key, out);
  TORCH_CHECK(out.scalar_type() == at::kLong && out.dim() >= 1 && out.size(-1) == 2,
              "out must be int64 (..., 2)");
  TORCH_CHECK(base >= 0 && base <= 0xFFFFFFFFll && base + out.numel() / 2 <= (int64_t(1) << 32),
              "counters must fit 32 bits");
  const c10::cuda::CUDAGuard guard(key.device());
  threefry_keys_launch(k, key.stride(0), (uint32_t)base, out.numel() / 2,
                       out.data_ptr<int64_t>(), at::cuda::getCurrentCUDAStream());
}

void threefry_uniform(const at::Tensor& key, at::Tensor out, double lo, double hi) {
  const int64_t* k = check_key(key, out);
  TORCH_CHECK(out.scalar_type() == at::kFloat, "out must be float32");
  const c10::cuda::CUDAGuard guard(key.device());
  threefry_uniform_launch(k, key.stride(0), out.numel(), (float)lo, (float)hi,
                          out.data_ptr<float>(), at::cuda::getCurrentCUDAStream());
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("sgbm_aggregate", &sgbm_aggregate,
        "K1 / K1c: S += sum of Lr over the given directions, carries in and out");
  m.def("seg_scan_plan", &plan, "K2: (tile ids, workspace words) of a (K, M) call");
  m.def("seg_scan", &seg_scan, "K2: segmented inclusive prefix sum along rows");
  m.def("ancestor_sums", &ancestor_sums, "K2 with the Euler ancestor-sum gathers fused");
  m.def("threefry_keys", &threefry_keys, "K3: (..., 2) keys threefry(key, (0, base + i))");
  m.def("threefry_uniform", &threefry_uniform, "K3: float32 uniform draws in [lo, hi)");
}
