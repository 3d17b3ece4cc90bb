// Iter-Fisher compensation and λ-statistics over the flat packed fp32
// buffers of repro_torch/kernels/packing.py, for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas kernels of the JAX package:
//   compensate_packed  <- src/repro/kernels/packing.py:178 compensate_packed
//                         (body _compensate_kernel, :170)
//   stats_packed       <- src/repro/kernels/packing.py:220 stats_packed
//                         (body _stats_kernel, :207)
//
// Both are elementwise passes over buffers of hundreds of MB, so device
// memory bounds them: compensate moves (2+τ)·total·4 bytes, stats 6·total·4.
// The design follows from that: 16-byte (float4) loads and stores on
// neighbouring addresses, a grid-stride loop over a grid that fills the
// card, every operand read once and every result written once. Compensate
// keeps g in registers across its τ Δθ rows and stores once. Stats writes
// v_r' and v_a' in the same pass that reduces s1 and s2.
//
// Exactness: every multiply and add goes through __fmul_rn / __fadd_rn /
// __fsub_rn, which nvcc never contracts into an FMA, so the elementwise
// results round exactly like the plain PyTorch versions in kernels/ref.py.
// s1 and s2 are summed in double per thread, then per block in a fixed
// shuffle order, then across blocks by one block in a fixed order: no float
// atomics, so the sums (and λ, which they feed) are the same on every run.
//
// The entry points take plain pointers and PyTorch's current stream, never
// synchronise, allocate nothing, and return cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Grid cap: 1024 blocks of 256 threads is about one full wave on 132 SMs.
// The stats grid is a function of `total` alone (never of the device), so
// its partial sums, and their fixed-order total, do not depend on the card.
constexpr long long kMaxBlocks = 1024;

int grid_for(long long n4) {
  long long blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

// g + λ·g·g·d, rounded after each operation in the plain version's order.
__device__ __forceinline__ float comp1(float g, float lam, float d) {
  return __fadd_rn(g, __fmul_rn(__fmul_rn(__fmul_rn(lam, g), g), d));
}

__global__ void __launch_bounds__(kThreads)
compensate_kernel(const float4* __restrict__ g, const float4* __restrict__ d,
                  const float* __restrict__ lam_ptr, float4* __restrict__ out,
                  long long n4, int tau) {
  const float lam = __ldg(lam_ptr);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    float4 x = g[i];
    for (int t = 0; t < tau; ++t) {
      const float4 dd = __ldg(&d[static_cast<long long>(t) * n4 + i]);
      x.x = comp1(x.x, lam, dd.x);
      x.y = comp1(x.y, lam, dd.y);
      x.z = comp1(x.z, lam, dd.z);
      x.w = comp1(x.w, lam, dd.w);
    }
    out[i] = x;
  }
}

// One lane of the statistics pass; accumulates into s1, s2.
__device__ __forceinline__ void stats1(float g, float d, float vr, float va,
                                       float alpha, float oma, float& nvr,
                                       float& nva, double& s1, double& s2) {
  const float dv_r = __fmul_rn(oma, __fsub_rn(g, vr));
  s1 += static_cast<double>(__fmul_rn(dv_r, va));
  s2 += static_cast<double>(__fmul_rn(va, va));
  nvr = __fadd_rn(__fmul_rn(alpha, vr), __fmul_rn(oma, g));
  nva = __fadd_rn(__fmul_rn(alpha, va), __fmul_rn(oma, __fmul_rn(__fmul_rn(g, g), d)));
}

// Fixed-order block sum of one double per thread; the result is valid in
// thread 0.
__device__ __forceinline__ double block_sum(double v, double* smem) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // smem may still be read by a previous call
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    if (lane < (blockDim.x >> 5)) v = smem[lane];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float4* __restrict__ g, const float4* __restrict__ d,
             const float4* __restrict__ vr, const float4* __restrict__ va,
             float4* __restrict__ nvr, float4* __restrict__ nva,
             double* __restrict__ partials, long long n4, float alpha, float oma) {
  __shared__ double smem[kThreads / 32];
  double s1 = 0.0, s2 = 0.0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n4; i += stride) {
    const float4 G = g[i], D = d[i], R = vr[i], A = va[i];
    float4 nr, na;
    stats1(G.x, D.x, R.x, A.x, alpha, oma, nr.x, na.x, s1, s2);
    stats1(G.y, D.y, R.y, A.y, alpha, oma, nr.y, na.y, s1, s2);
    stats1(G.z, D.z, R.z, A.z, alpha, oma, nr.z, na.z, s1, s2);
    stats1(G.w, D.w, R.w, A.w, alpha, oma, nr.w, na.w, s1, s2);
    nvr[i] = nr;
    nva[i] = na;
  }
  s1 = block_sum(s1, smem);
  s2 = block_sum(s2, smem);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s1;
    partials[gridDim.x + blockIdx.x] = s2;
  }
}

// Second launch: one block sums the per-block partials in a fixed order
// into the two fp32 device scalars.
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const double* __restrict__ partials, int nblocks,
                    float* __restrict__ s1_out, float* __restrict__ s2_out) {
  __shared__ double smem[kThreads / 32];
  double s1 = 0.0, s2 = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += blockDim.x) {
    s1 += partials[i];
    s2 += partials[nblocks + i];
  }
  s1 = block_sum(s1, smem);
  s2 = block_sum(s2, smem);
  if (threadIdx.x == 0) {
    *s1_out = static_cast<float>(s1);
    *s2_out = static_cast<float>(s2);
  }
}

}  // namespace

extern "C" {

// Doubles of scratch that ferret_stats_packed needs for `total` elements.
int ferret_stats_scratch_len(int total) { return 2 * grid_for(total / 4); }

const char* ferret_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// out = Eq. 9 applied to g with the τ rows of d (τ·total floats, oldest
// first) and λ read from the device. total % 4 == 0, buffers 16-byte aligned.
int ferret_compensate_packed(const void* g, const void* d, const void* lam, void* out,
                             int total, int tau, void* stream) {
  const long long n4 = total / 4;
  compensate_kernel<<<grid_for(n4), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(g), static_cast<const float4*>(d),
      static_cast<const float*>(lam), static_cast<float4*>(out), n4, tau);
  return static_cast<int>(cudaGetLastError());
}

// (v_r', v_a', s1, s2) of Alg. 1; `partials` holds
// ferret_stats_scratch_len(total) doubles; s1 and s2 are fp32 device scalars.
int ferret_stats_packed(const void* g, const void* d, const void* vr, const void* va,
                        void* nvr, void* nva, void* partials, void* s1, void* s2,
                        int total, float alpha, float one_minus_alpha, void* stream) {
  const long long n4 = total / 4;
  const int blocks = grid_for(n4);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  stats_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float4*>(g), static_cast<const float4*>(d),
      static_cast<const float4*>(vr), static_cast<const float4*>(va),
      static_cast<float4*>(nvr), static_cast<float4*>(nva),
      static_cast<double*>(partials), n4, alpha, one_minus_alpha);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<<<1, kThreads, 0, st>>>(static_cast<const double*>(partials), blocks,
                                              static_cast<float*>(s1),
                                              static_cast<float*>(s2));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
