// Mamba-2 SSD chunked scan, forward and backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel of the JAX package:
//   ssd_scan_fwd / ssd_scan_bwd <- src/repro/kernels/ssd_scan.py:77 ssd_scan_pallas
//                                  (body _ssd_kernel, :26)
// The Pallas kernel has no VJP; the JAX trainer differentiates
// repro.kernels.ref.ssd_scan_ref. The backward here computes that gradient.
// Plain versions: repro_torch/kernels/ref.py ssd_scan_fwd_ref / ssd_scan_bwd_ref.
//
// Shapes: x, dy (b,l,h,p) in T (float or bf16, read directly); dt (b,l,h)
// and A (h,) f32; B, C (b,l,n) in T; states (b,h,p,n) f32. Per batch,
// chunk c of Q tokens and head h, with cs = cumsum(dt·A) inside the chunk:
//   y_l     = e^{cs_l}·C_l·S_cᵀ + Σ_{s≤l} (C_l·B_s)·e^{cs_l−cs_s}·dt_s·x_s
//   S_{c+1} = e^{cs_end}·S_c + Σ_s dt_s·e^{cs_end−cs_s}·x_s ⊗ B_s
//
// Design. The TPU kernel walks the chunks of one (batch, head) in order on
// one core and carries the state in VMEM. Here the chunks run in parallel:
// (1) every (b, c, h) block forms its chunk's end state (a p×n product over
// Q), (2) a short scan over chunks turns them into the state before each
// chunk, (3) every (b, c, h, 64-row tile) block forms its outputs. That gives
// b·c·h·Q/64 blocks (1536 at b 2, l 1024, h 48, Q 256) instead of b·h
// sequential ones. The backward has the same shape: per-chunk state
// gradients, a reverse scan over chunks, then a row pass (dC, ∂cs from rows)
// and a column pass (dx, dB, ∂dt, ∂cs from columns), a per-chunk pass that
// turns ∂cs into ∂dt and dA through a reverse cumsum, and fixed-order sums
// over heads (dB, dC) and over batch and chunks (dA).
//
// What bounds it: the least work is set by bytes (each input read once,
// each output written once), not by the contractions, once C·Bᵀ, dG·B and
// dGᵀ·C are formed once per (b, chunk) rather than per head and every Q×Q
// product is taken causal. Here the contractions are done per head in fp32
// FMA on shared-memory tiles (64×64 output tiles, 4×4 or 4×8 per thread,
// operands read as 16-byte vectors), not on the tensor cores, so this first
// version is bound by fp32 issue and shared-memory bandwidth, far from that
// bound. The backward's row and column passes each recompute C·Bᵀ and
// dy·xᵀ. Sharing C·Bᵀ over heads, wgmma, TMA and one backward pass are
// later work.
//
// Exactness: nothing is summed with atomics. Every sum across threads or
// blocks (rows and columns of M, dB/dC over heads, dA over positions) is
// taken in a fixed order, so two runs give the same bits. The mask is
// applied before the exp (e^{cs_l−cs_s} is only formed for s ≤ l).
//
// Limits (checked by the wrapper): p ≤ 64, n ≤ 128, Q a multiple of 64 and
// at most 1024. Smaller p and n are zero-padded inside the tiles.
//
// The entry points take plain pointers and PyTorch's current stream, never
// synchronise, allocate nothing, and return cudaGetLastError() of the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16×16 threads per output tile
constexpr int LT = 64;         // rows of a tile (positions) and the p tile
constexpr int NT = 128;        // the n tile
// smem row strides of 64- and 128-wide tiles: multiples of 4 floats, so
// the tile products read 16-byte vectors
constexpr int LD = LT + 4;
constexpr int LDN = NT + 4;
constexpr int kMaxQ = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Load `rows` (≤ 64) rows of `cols_valid` values from a row-major source
// with row stride `stride` into smem, zero-filling to 64 rows × `cols`.
// natural: dst[r*ld + k], neighbouring threads on neighbouring k;
// transposed (k-major): dst[k*ld + r], neighbouring threads on neighbouring
// r, so the smem stores never conflict (the strided global reads of a tile
// are served from L1 after the first).
template <class T>
__device__ void load_tile(float* dst, int ld, bool transposed, const T* src, long long stride,
                          int rows, int cols, int cols_valid) {
  for (int idx = threadIdx.x; idx < LT * cols; idx += blockDim.x) {
    const int r = transposed ? idx % LT : idx / cols;
    const int k = transposed ? idx / LT : idx % cols;
    float v = 0.f;
    if (r < rows && k < cols_valid) v = to_f32(src[r * stride + k]);
    dst[transposed ? k * ld + r : r * ld + k] = v;
  }
}

// The tile element a thread owns: rows trow(i) = 4·ty + i (i < 4) and
// columns tcol(j) = 64·(j/4) + 4·tx + j%4 (j < J), tx = thread % 16,
// ty = thread / 16. A row's 16 owners are one half-warp.
__device__ __forceinline__ int trow(int i) { return (threadIdx.x >> 4) * 4 + i; }
__device__ __forceinline__ int tcol(int j) {
  return (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
}

// acc[i][j] += Σ_k As[k*lda + trow(i)] · Bs[k*ldb + tcol(j)]: a 64 × (16·J)
// tile product with both operands k-major in shared memory, read as 16-byte
// vectors (one broadcast vector of A and J/4 of B per k).
template <int J>
__device__ __forceinline__ void mma_tile(float (&acc)[4][J], const float* As, int lda,
                                         const float* Bs, int ldb, int K) {
  const float* ap = As + trow(0);
  const float* bp = Bs + tcol(0);
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float4 a4 = *reinterpret_cast<const float4*>(ap + k * lda);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    float b[J];
#pragma unroll
    for (int q = 0; q < J / 4; ++q) {
      const float4 b4 = *reinterpret_cast<const float4*>(bp + k * ldb + 64 * q);
      b[4 * q] = b4.x;
      b[4 * q + 1] = b4.y;
      b[4 * q + 2] = b4.z;
      b[4 * q + 3] = b4.w;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&acc)[4][J]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.f;
}

// Sum over the 16 threads of a tile row (one half-warp), in a fixed order;
// every thread of the half-warp gets the sum.
__device__ __forceinline__ float row_sum16(float v) {
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Fixed-order block sum; valid in thread 0.
__device__ float block_sum(float v, float* smem) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = 0.f;
  if (warp == 0) {
    if (lane < (blockDim.x >> 5)) v = smem[lane];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// dt of one (b, chunk, h) into dt_s and cs = inclusive cumsum(dt·A) into
// cs_s. Warp 0 scans: each lane sums Q/32 consecutive values, then the lane
// totals are scanned with shuffles. The same code in every kernel, so every
// pass sees the same cs bits. Ends with __syncthreads().
__device__ void chunk_cumsum(const float* __restrict__ dt, long long base, int h, float A,
                             int Q, float* dt_s, float* cs_s) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x) dt_s[i] = dt[base + (long long)i * h];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, per = Q / 32;
    float run = 0.f;
    for (int k = 0; k < per; ++k) {
      run = __fadd_rn(run, __fmul_rn(dt_s[lane * per + k], A));
      cs_s[lane * per + k] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.f;
    for (int k = 0; k < per; ++k) cs_s[lane * per + k] += excl;
  }
  __syncthreads();
}

struct Dims {
  int b, l, h, p, n, Q, nc;
};

// Block index (b, c, h) -> batch, chunk, head and the global row of the
// chunk's first position.
struct Blk {
  int bi, ci, hi;
  long long row0;  // bi*l + ci*Q
  __device__ Blk(int blk, const Dims& d) {
    hi = blk % d.h;
    ci = (blk / d.h) % d.nc;
    bi = blk / (d.h * d.nc);
    row0 = (long long)bi * d.l + (long long)ci * d.Q;
  }
};

// ---------------------------------------------------------------------------
// out[p,n] = Σ_s w_s·X[s,p]·Y[s,n] over one chunk, for every (b, c, h):
//   mode 0 (forward):  X = x,  Y = B, w = dt·e^{cs_end−cs}  (the chunk's
//                      own end-state increment)
//   mode 1 (backward): X = dy, Y = C, w = e^{cs}  (∂/∂S_c from y_off)
// Also writes decay[blk] = e^{cs_end}.
// ---------------------------------------------------------------------------
template <class T>
__global__ void __launch_bounds__(kThreads)
chunk_outer_kernel(const T* __restrict__ X, const T* __restrict__ Y,
                   const float* __restrict__ dt, const float* __restrict__ A, Dims d,
                   int mode, float* __restrict__ out, float* __restrict__ decay) {
  constexpr int KS = 32;
  __shared__ __align__(16) float Xs[KS * LD];
  __shared__ __align__(16) float Ys[KS * LDN];
  __shared__ float dt_s[kMaxQ], cs_s[kMaxQ], w_s[kMaxQ];
  const Blk k(blockIdx.x, d);
  const float a = A[k.hi];
  chunk_cumsum(dt, k.row0 * d.h + k.hi, d.h, a, d.Q, dt_s, cs_s);
  const float cs_end = cs_s[d.Q - 1];
  for (int i = threadIdx.x; i < d.Q; i += blockDim.x)
    w_s[i] = mode == 0 ? dt_s[i] * expf(cs_end - cs_s[i]) : expf(cs_s[i]);
  if (threadIdx.x == 0) decay[blockIdx.x] = expf(cs_end);
  float acc[4][8];
  zero(acc);
  const long long xs = (long long)d.h * d.p;
  for (int s0 = 0; s0 < d.Q; s0 += KS) {
    __syncthreads();
    // Xs[s][p] = w_s·X[s,p]; Ys[s][n] = Y[s,n] (k-major over s already)
    for (int idx = threadIdx.x; idx < KS * LT; idx += blockDim.x) {
      const int s = idx / LT, pi = idx % LT;
      Xs[s * LD + pi] = pi < d.p
          ? to_f32(X[(k.row0 + s0 + s) * xs + (long long)k.hi * d.p + pi]) * w_s[s0 + s]
          : 0.f;
    }
    for (int idx = threadIdx.x; idx < KS * NT; idx += blockDim.x) {
      const int s = idx / NT, ni = idx % NT;
      Ys[s * LDN + ni] = ni < d.n ? to_f32(Y[(k.row0 + s0 + s) * d.n + ni]) : 0.f;
    }
    __syncthreads();
    mma_tile<8>(acc, Xs, LD, Ys, LDN, KS);
  }
  float* o = out + (long long)blockIdx.x * d.p * d.n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pi = trow(i), ni = tcol(j);
      if (pi < d.p && ni < d.n) o[pi * d.n + ni] = acc[i][j];
    }
}

// Forward scan over chunks, in place: buf[c] holds chunk c's increment on
// entry and the state before chunk c on exit. Grid (b·h, ⌈p·n/256⌉).
__global__ void __launch_bounds__(kThreads)
state_scan_kernel(float* __restrict__ buf, const float* __restrict__ decay,
                  const float* __restrict__ s0, float* __restrict__ final_state, Dims d) {
  const int bh = blockIdx.x, bi = bh / d.h, hi = bh % d.h;
  const int pn = d.p * d.n;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= pn) return;
  float S = s0 ? s0[(long long)bh * pn + e] : 0.f;
  for (int c = 0; c < d.nc; ++c) {
    const long long blk = ((long long)bi * d.nc + c) * d.h + hi;
    const float inc = buf[blk * pn + e];
    buf[blk * pn + e] = S;
    S = S * decay[blk] + inc;
  }
  final_state[(long long)bh * pn + e] = S;
}

// Outputs of one 64-row tile of one (b, c, h). Grid (b·c·h, Q/64).
template <class T>
__global__ void __launch_bounds__(kThreads)
fwd_out_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ sb, T* __restrict__ y,
               Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* Ct = sm;               // [NT][LD]  Ct[n][r] = C[l0+r, n]
  float* Bt = Ct + NT * LD;     // [NT][LD]  Bt[n][s] = B[s0+s, n]; first S_cᵀ
  float* Ws = Bt + NT * LD;     // [LT][LD]  Ws[s][r] = W[l0+r, s0+s]
  float* Xs = Ws + LT * LD;     // [LT][LD]  Xs[s][p] = x[s0+s, p]
  float* dt_s = Xs + LT * LD;
  float* cs_s = dt_s + d.Q;
  const Blk k(blockIdx.x, d);
  const int lt = blockIdx.y, l0 = lt * LT;
  chunk_cumsum(dt, k.row0 * d.h + k.hi, d.h, A[k.hi], d.Q, dt_s, cs_s);
  const long long xs = (long long)d.h * d.p;
  const T* xh = x + k.row0 * xs + (long long)k.hi * d.p;
  load_tile(Ct, LD, true, C + (k.row0 + l0) * d.n, d.n, LT, NT, d.n);
  // S_cᵀ: Bt[n][p] = S_c[p, n]
  load_tile(Bt, LD, true, sb + (long long)blockIdx.x * d.p * d.n, d.n, d.p, NT, d.n);
  __syncthreads();
  float acc[4][4];
  zero(acc);
  mma_tile<4>(acc, Ct, LD, Bt, LD, NT);  // C·S_cᵀ  (rows l, cols p)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float e = expf(cs_s[l0 + trow(i)]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] *= e;
  }
  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * LT;
    __syncthreads();
    load_tile(Bt, LD, true, B + (k.row0 + s0) * d.n, d.n, LT, NT, d.n);
    load_tile(Xs, LD, false, xh + s0 * xs, xs, LT, LT, d.p);
    __syncthreads();
    float g[4][4];
    zero(g);
    mma_tile<4>(g, Ct, LD, Bt, LD, NT);  // G = C·Bᵀ (rows l, cols s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = trow(i), s = tcol(j);
        const int l = l0 + r, sg = s0 + s;
        float w = 0.f;
        if (sg <= l) w = g[i][j] * expf(cs_s[l] - cs_s[sg]) * dt_s[sg];
        Ws[s * LD + r] = w;
      }
    __syncthreads();
    mma_tile<4>(acc, Ws, LD, Xs, LD, LT);  // += W·x
  }
  T* yh = y + (k.row0 + l0) * xs + (long long)k.hi * d.p;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = trow(i), pi = tcol(j);
      if (pi < d.p) yh[r * xs + pi] = from_f32<T>(acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// Backward
// ---------------------------------------------------------------------------

// Reverse scan over chunks, in place, one block per (b, h): buf[c] holds
// ∂/∂S_c from y_off on entry and E_c = ∂/∂S_{c+1} on exit;
// ddecay[b,c,h] = Σ E_c ⊙ S_c; ds0 = ∂/∂S_0.
__global__ void __launch_bounds__(kThreads)
state_rscan_kernel(float* __restrict__ buf, const float* __restrict__ sb,
                   const float* __restrict__ decay, const float* __restrict__ dfinal,
                   float* __restrict__ ddecay, float* __restrict__ ds0, Dims d) {
  constexpr int kPer = 32;  // p·n ≤ 64·128 = 32·256
  __shared__ float red[kThreads / 32];
  const int bh = blockIdx.x, bi = bh / d.h, hi = bh % d.h;
  const int pn = d.p * d.n;
  float D[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    D[k] = (dfinal && e < pn) ? dfinal[(long long)bh * pn + e] : 0.f;
  }
  for (int c = d.nc - 1; c >= 0; --c) {
    const long long blk = ((long long)bi * d.nc + c) * d.h + hi;
    const float dec = decay[blk];
    float dd = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = threadIdx.x + k * kThreads;
      if (e < pn) {
        const long long at = blk * pn + e;
        dd += D[k] * sb[at];
        const float g = buf[at];
        buf[at] = D[k];
        D[k] = D[k] * dec + g;
      }
    }
    dd = block_sum(dd, red);
    if (threadIdx.x == 0) ddecay[blk] = dd;
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (e < pn) ds0[(long long)bh * pn + e] = D[k];
  }
}

// Row pass over one 64-row tile l of one (b, c, h). Grid (b·c·h, Q/64).
//   dC_part[l,n] = e^{cs_l}·(dy·S_c)[l,n] + Σ_s dG[l,s]·B[s,n]
//   dcs_row[l]   = Σ_n C⊙dC_off + Σ_s M[l,s]
template <class T>
__global__ void __launch_bounds__(kThreads)
bwd_row_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ sb,
               const T* __restrict__ dy, float* __restrict__ dC_part,
               float* __restrict__ dcs_row, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* Ct = sm;              // [NT][LD]   Ct[n][r]  = C[l0+r, n]
  float* Bt = Ct + NT * LD;    // [NT][LD]   Bt[n][s]  = B[s0+s, n]
  float* Bn = Bt + NT * LD;    // [LT][LDN]  Bn[s][n]  = B[s0+s, n]; first S_c[p][n]
  float* Dyt = Bn + LT * LDN;  // [LT][LD]   Dyt[p][r] = dy[l0+r, p]
  float* Xt = Dyt + LT * LD;   // [LT][LD]   Xt[p][s]  = x[s0+s, p]
  float* DGs = Xt + LT * LD;   // [LT][LD]   DGs[s][r] = dG[l0+r, s0+s]
  float* dt_s = DGs + LT * LD;
  float* cs_s = dt_s + d.Q;
  const Blk k(blockIdx.x, d);
  const int lt = blockIdx.y, l0 = lt * LT;
  const int tx = threadIdx.x & 15;
  chunk_cumsum(dt, k.row0 * d.h + k.hi, d.h, A[k.hi], d.Q, dt_s, cs_s);
  const long long xs = (long long)d.h * d.p;
  const T* xh = x + k.row0 * xs + (long long)k.hi * d.p;
  const T* dyh = dy + k.row0 * xs + (long long)k.hi * d.p;
  load_tile(Ct, LD, true, C + (k.row0 + l0) * d.n, d.n, LT, NT, d.n);
  load_tile(Dyt, LD, true, dyh + l0 * xs, xs, LT, LT, d.p);
  load_tile(Bn, LDN, false, sb + (long long)blockIdx.x * d.p * d.n, d.n, d.p, NT, d.n);
  __syncthreads();
  float acc[4][8];
  zero(acc);
  mma_tile<8>(acc, Dyt, LD, Bn, LDN, LT);  // dy·S_c (rows l, cols n)
  float rowp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = trow(i);
    const float e = expf(cs_s[l0 + r]);
    rowp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[i][j] *= e;
      rowp[i] += acc[i][j] * Ct[tcol(j) * LD + r];
    }
  }
  for (int st = 0; st <= lt; ++st) {
    const int s0 = st * LT;
    __syncthreads();
    load_tile(Bt, LD, true, B + (k.row0 + s0) * d.n, d.n, LT, NT, d.n);
    load_tile(Bn, LDN, false, B + (k.row0 + s0) * d.n, d.n, LT, NT, d.n);
    load_tile(Xt, LD, true, xh + s0 * xs, xs, LT, LT, d.p);
    __syncthreads();
    float g[4][4], dw[4][4];
    zero(g);
    zero(dw);
    mma_tile<4>(g, Ct, LD, Bt, LD, NT);    // G  = C·Bᵀ  (rows l, cols s)
    mma_tile<4>(dw, Dyt, LD, Xt, LD, LT);  // dW = dy·xᵀ (rows l, cols s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = trow(i), s = tcol(j);
        const int l = l0 + r, sg = s0 + s;
        float dg = 0.f;
        if (sg <= l) {
          const float Lf = expf(cs_s[l] - cs_s[sg]) * dt_s[sg];
          dg = dw[i][j] * Lf;
          rowp[i] += dg * g[i][j];  // M = dW·W = dW·G·L·dt
        }
        DGs[s * LD + r] = dg;
      }
    __syncthreads();
    mma_tile<8>(acc, DGs, LD, Bn, LDN, LT);  // += dG·B
  }
  float* out = dC_part + ((long long)blockIdx.x * d.Q + l0) * d.n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = trow(i);
    const float rs = row_sum16(rowp[i]);
    if (tx == 0) dcs_row[(long long)blockIdx.x * d.Q + l0 + r] = rs;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ni = tcol(j);
      if (ni < d.n) out[r * d.n + ni] = acc[i][j];
    }
  }
}

// Column pass over one 64-position tile s of one (b, c, h). Grid (b·c·h, Q/64).
//   dx[s,p]      = u_s·(B·Eᵀ)[s,p] + Σ_l W[l,s]·dy[l,p]
//   dB_part[s,n] = u_s·(x·E)[s,n] + Σ_l dG[l,s]·C[l,n]
//   dcs_col[s]   = −Σ_l M[l,s] − du_s·u_s;  uu[s] = du_s·u_s
//   ddt_part[s]  = Σ_l dW·G·L + du_s·e^{cs_end−cs_s}
template <class T>
__global__ void __launch_bounds__(kThreads)
bwd_col_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const T* __restrict__ B,
               const T* __restrict__ C, const float* __restrict__ E,
               const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dB_part,
               float* __restrict__ dcs_col, float* __restrict__ uu,
               float* __restrict__ ddt_part, Dims d) {
  extern __shared__ __align__(16) float sm[];
  float* Bt = sm;              // [NT][LD]   Bt[n][s]  = B[s0+s, n]
  float* Xt = Bt + NT * LD;    // [LT][LD]   Xt[p][s]  = x[s0+s, p]
  float* Ct = Xt + LT * LD;    // [NT][LD]   Ct[n][l]  = C[l0+l, n]; first Eᵀ[n][p]
  float* Cn = Ct + NT * LD;    // [LT][LDN]  Cn[l][n]  = C[l0+l, n]; first E[p][n]
  float* Dyt = Cn + LT * LDN;  // [LT][LD]   Dyt[p][l] = dy[l0+l, p]
  float* Dyn = Dyt + LT * LD;  // [LT][LD]   Dyn[l][p] = dy[l0+l, p]
  float* WS = Dyn + LT * LD;   // [LT][LD]   WS[l][s]  = W[l0+l, s0+s]
  float* DGS = WS + LT * LD;   // [LT][LD]   DGS[l][s] = dG[l0+l, s0+s]
  float* dt_s = DGS + LT * LD;
  float* cs_s = dt_s + d.Q;
  const Blk k(blockIdx.x, d);
  const int st = blockIdx.y, s0 = st * LT, nt = d.Q / LT;
  const int tx = threadIdx.x & 15;
  chunk_cumsum(dt, k.row0 * d.h + k.hi, d.h, A[k.hi], d.Q, dt_s, cs_s);
  const float cs_end = cs_s[d.Q - 1];
  const long long xs = (long long)d.h * d.p;
  const T* xh = x + k.row0 * xs + (long long)k.hi * d.p;
  const T* dyh = dy + k.row0 * xs + (long long)k.hi * d.p;
  const float* Eb = E + (long long)blockIdx.x * d.p * d.n;
  load_tile(Bt, LD, true, B + (k.row0 + s0) * d.n, d.n, LT, NT, d.n);
  load_tile(Xt, LD, true, xh + s0 * xs, xs, LT, LT, d.p);
  load_tile(Ct, LD, true, Eb, d.n, d.p, NT, d.n);
  load_tile(Cn, LDN, false, Eb, d.n, d.p, NT, d.n);
  __syncthreads();
  float ax[4][4], ab[4][8];
  zero(ax);
  zero(ab);
  mma_tile<4>(ax, Bt, LD, Ct, LD, NT);   // B·Eᵀ (rows s, cols p)
  mma_tile<8>(ab, Xt, LD, Cn, LDN, LT);  // x·E  (rows s, cols n)
  float du[4], u[4], colp[4], ddtp[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = trow(i), sg = s0 + s;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) v += Xt[tcol(j) * LD + s] * ax[i][j];
    du[i] = row_sum16(v);
    u[i] = dt_s[sg] * expf(cs_end - cs_s[sg]);
#pragma unroll
    for (int j = 0; j < 4; ++j) ax[i][j] *= u[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) ab[i][j] *= u[i];
    colp[i] = 0.f;
    ddtp[i] = 0.f;
  }
  for (int lt = st; lt < nt; ++lt) {
    const int l0 = lt * LT;
    __syncthreads();
    load_tile(Ct, LD, true, C + (k.row0 + l0) * d.n, d.n, LT, NT, d.n);
    load_tile(Cn, LDN, false, C + (k.row0 + l0) * d.n, d.n, LT, NT, d.n);
    load_tile(Dyt, LD, true, dyh + l0 * xs, xs, LT, LT, d.p);
    load_tile(Dyn, LD, false, dyh + l0 * xs, xs, LT, LT, d.p);
    __syncthreads();
    float g[4][4], dw[4][4];
    zero(g);
    zero(dw);
    mma_tile<4>(g, Bt, LD, Ct, LD, NT);    // Gᵀ  = B·Cᵀ  (rows s, cols l)
    mma_tile<4>(dw, Xt, LD, Dyt, LD, LT);  // dWᵀ = x·dyᵀ (rows s, cols l)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = trow(i), l = tcol(j);
        const int sg = s0 + s, lg = l0 + l;
        float w = 0.f, dg = 0.f;
        if (sg <= lg) {
          const float L = expf(cs_s[lg] - cs_s[sg]);
          const float gl = g[i][j] * L;
          w = gl * dt_s[sg];
          dg = dw[i][j] * L * dt_s[sg];
          colp[i] += dw[i][j] * w;
          ddtp[i] += dw[i][j] * gl;
        }
        WS[l * LD + s] = w;
        DGS[l * LD + s] = dg;
      }
    __syncthreads();
    mma_tile<4>(ax, WS, LD, Dyn, LD, LT);   // += Wᵀ·dy
    mma_tile<8>(ab, DGS, LD, Cn, LDN, LT);  // += dGᵀ·C
  }
  T* dxh = dx + (k.row0 + s0) * xs + (long long)k.hi * d.p;
  float* dbo = dB_part + ((long long)blockIdx.x * d.Q + s0) * d.n;
  const long long at = (long long)blockIdx.x * d.Q + s0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = trow(i);
    const float cp = row_sum16(colp[i]);
    const float dp = row_sum16(ddtp[i]);
    if (tx == 0) {
      const float duu = du[i] * u[i];
      dcs_col[at + s] = -cp - duu;
      uu[at + s] = duu;
      ddt_part[at + s] = dp + du[i] * expf(cs_end - cs_s[s0 + s]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int pi = tcol(j);
      if (pi < d.p) dxh[s * xs + pi] = from_f32<T>(ax[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ni = tcol(j);
      if (ni < d.n) dbo[s * d.n + ni] = ab[i][j];
    }
  }
}

// ∂cs → ∂a (reverse cumsum) → ddt and the per-chunk dA partial, one block
// per (b, c, h).
__global__ void __launch_bounds__(kThreads)
bwd_dt_kernel(const float* __restrict__ dt, const float* __restrict__ A,
              const float* __restrict__ dcs_row, const float* __restrict__ dcs_col,
              const float* __restrict__ uu, const float* __restrict__ ddt_part,
              const float* __restrict__ ddecay, float* __restrict__ ddt,
              float* __restrict__ dA_part, Dims d) {
  __shared__ float dt_s[kMaxQ], cs_s[kMaxQ], g_s[kMaxQ], red[kThreads / 32];
  const Blk k(blockIdx.x, d);
  const float a = A[k.hi];
  chunk_cumsum(dt, k.row0 * d.h + k.hi, d.h, a, d.Q, dt_s, cs_s);
  const long long at = (long long)blockIdx.x * d.Q;
  float su = 0.f;
  for (int i = threadIdx.x; i < d.Q; i += blockDim.x) {
    g_s[i] = dcs_row[at + i] + dcs_col[at + i];
    su += uu[at + i];
  }
  su = block_sum(su, red);  // ends with thread 0 holding Σ du·u
  if (threadIdx.x == 0)
    g_s[d.Q - 1] += su + ddecay[blockIdx.x] * expf(cs_s[d.Q - 1]);
  __syncthreads();
  if (threadIdx.x < 32) {  // reverse inclusive cumsum, in place
    const int lane = threadIdx.x, per = d.Q / 32;
    float run = 0.f;
    for (int kk = per - 1; kk >= 0; --kk) {
      run += g_s[lane * per + kk];
      g_s[lane * per + kk] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, incl, off);
      if (lane + off < 32) incl += v;
    }
    float after = __shfl_down_sync(0xffffffffu, incl, 1);
    if (lane == 31) after = 0.f;
    for (int kk = 0; kk < per; ++kk) g_s[lane * per + kk] += after;
  }
  __syncthreads();
  float da = 0.f;
  for (int i = threadIdx.x; i < d.Q; i += blockDim.x) {
    ddt[(k.row0 + i) * d.h + k.hi] = ddt_part[at + i] + a * g_s[i];
    da += dt_s[i] * g_s[i];
  }
  da = block_sum(da, red);
  if (threadIdx.x == 0) dA_part[blockIdx.x] = da;
}

// out[o][i] = Σ_m in[(o·M + m)·I + i], m in order.
template <class TO>
__global__ void __launch_bounds__(kThreads)
sum_mid_kernel(const float* __restrict__ in, TO* __restrict__ out, long long O, int M,
               long long I) {
  const long long total = O * I;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long o = e / I, i = e % I;
    float s = 0.f;
    for (int m = 0; m < M; ++m) s += in[(o * M + m) * I + i];
    out[e] = from_f32<TO>(s);
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 4096) blocks = 4096;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

size_t fwd_out_smem(int Q) { return sizeof(float) * (2 * NT * LD + 2 * LT * LD + 2 * Q); }
size_t bwd_row_smem(int Q) {
  return sizeof(float) * (2 * NT * LD + LT * LDN + 3 * LT * LD + 2 * Q);
}
size_t bwd_col_smem(int Q) {
  return sizeof(float) * (2 * NT * LD + LT * LDN + 5 * LT * LD + 2 * Q);
}

// Workspace slices (floats), laid out by carve() for the entry points and
// for ferret_ssd_workspace_len.
struct Work {
  float *decay, *ddecay, *E, *dC_part, *dB_part, *dcs_row, *dcs_col, *uu, *ddt_part,
      *dA_part;
};

// Carves `base` (null: only counts) into the slices; returns the floats
// the workspace needs.
long long carve(const Dims& d, int backward, float* base, Work& w) {
  const long long bch = (long long)d.b * d.nc * d.h;
  long long off = 0;
  auto take = [&](float*& slot, long long n) {
    slot = base ? base + off : nullptr;
    off += (n + 63) / 64 * 64;  // 256-byte aligned slices
  };
  take(w.decay, bch);
  if (backward) {
    take(w.ddecay, bch);
    take(w.E, bch * d.p * d.n);
    take(w.dC_part, bch * d.Q * d.n);
    take(w.dB_part, bch * d.Q * d.n);
    take(w.dcs_row, bch * d.Q);
    take(w.dcs_col, bch * d.Q);
    take(w.uu, bch * d.Q);
    take(w.ddt_part, bch * d.Q);
    take(w.dA_part, bch);
  }
  return off;
}

Dims make_dims(int b, int l, int h, int p, int n, int Q) { return Dims{b, l, h, p, n, Q, l / Q}; }

template <class T>
int fwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
        const void* s0, void* y, void* final_state, void* sb, void* work, Dims d,
        cudaStream_t st) {
  Work w;
  carve(d, 0, static_cast<float*>(work), w);
  const int bch = d.b * d.nc * d.h;
  const T* xp = static_cast<const T*>(x);
  const T* Bp = static_cast<const T*>(B);
  const T* Cp = static_cast<const T*>(C);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  float* sbp = static_cast<float*>(sb);
  chunk_outer_kernel<T><<<bch, kThreads, 0, st>>>(xp, Bp, dtp, Ap, d, 0, sbp, w.decay);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  state_scan_kernel<<<dim3(d.b * d.h, (d.p * d.n + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      sbp, w.decay, static_cast<const float*>(s0), static_cast<float*>(final_state), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = fwd_out_smem(d.Q);
  cudaFuncSetAttribute(fwd_out_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  fwd_out_kernel<T><<<dim3(bch, d.Q / LT), kThreads, smem, st>>>(
      xp, dtp, Ap, Bp, Cp, sbp, static_cast<T*>(y), d);
  return static_cast<int>(cudaGetLastError());
}

template <class T>
int bwd(const void* x, const void* dt, const void* A, const void* B, const void* C,
        const void* sb, const void* dy, const void* dfinal, void* dx, void* ddt, void* dA,
        void* dB, void* dC, void* ds0, void* work, Dims d, cudaStream_t st) {
  Work w;
  carve(d, 1, static_cast<float*>(work), w);
  const int bch = d.b * d.nc * d.h;
  const T* xp = static_cast<const T*>(x);
  const T* Bp = static_cast<const T*>(B);
  const T* Cp = static_cast<const T*>(C);
  const T* dyp = static_cast<const T*>(dy);
  const float* dtp = static_cast<const float*>(dt);
  const float* Ap = static_cast<const float*>(A);
  const float* sbp = static_cast<const float*>(sb);
  cudaError_t err;
#define SSD_CHECK()                               \
  err = cudaGetLastError();                       \
  if (err != cudaSuccess) return static_cast<int>(err)
  chunk_outer_kernel<T><<<bch, kThreads, 0, st>>>(dyp, Cp, dtp, Ap, d, 1, w.E, w.decay);
  SSD_CHECK();
  state_rscan_kernel<<<d.b * d.h, kThreads, 0, st>>>(
      w.E, sbp, w.decay, static_cast<const float*>(dfinal), w.ddecay,
      static_cast<float*>(ds0), d);
  SSD_CHECK();
  const size_t rs = bwd_row_smem(d.Q), cs = bwd_col_smem(d.Q);
  cudaFuncSetAttribute(bwd_row_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rs);
  cudaFuncSetAttribute(bwd_col_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cs);
  bwd_row_kernel<T><<<dim3(bch, d.Q / LT), kThreads, rs, st>>>(
      xp, dtp, Ap, Bp, Cp, sbp, dyp, w.dC_part, w.dcs_row, d);
  SSD_CHECK();
  bwd_col_kernel<T><<<dim3(bch, d.Q / LT), kThreads, cs, st>>>(
      xp, dtp, Ap, Bp, Cp, w.E, dyp, static_cast<T*>(dx), w.dB_part, w.dcs_col, w.uu,
      w.ddt_part, d);
  SSD_CHECK();
  bwd_dt_kernel<<<bch, kThreads, 0, st>>>(dtp, Ap, w.dcs_row, w.dcs_col, w.uu, w.ddt_part,
                                          w.ddecay, static_cast<float*>(ddt), w.dA_part, d);
  SSD_CHECK();
  // dB, dC: (b·c, h, Q·n) summed over h; dA: (b·c, h) summed over b·c
  const long long qn = (long long)d.Q * d.n, oc = (long long)d.b * d.nc;
  sum_mid_kernel<T><<<grid_for(oc * qn), kThreads, 0, st>>>(w.dB_part, static_cast<T*>(dB),
                                                            oc, d.h, qn);
  SSD_CHECK();
  sum_mid_kernel<T><<<grid_for(oc * qn), kThreads, 0, st>>>(w.dC_part, static_cast<T*>(dC),
                                                            oc, d.h, qn);
  SSD_CHECK();
  sum_mid_kernel<float><<<1, kThreads, 0, st>>>(w.dA_part, static_cast<float*>(dA), 1,
                                                 (int)oc, d.h);
  SSD_CHECK();
#undef SSD_CHECK
  return 0;
}

}  // namespace

extern "C" {

// Floats of workspace the forward (backward = 0) or backward (1) needs.
long long ferret_ssd_workspace_len(int b, int l, int h, int p, int n, int Q, int backward) {
  Work w;
  return carve(make_dims(b, l, h, p, n, Q), backward, nullptr, w);
}

// y (x's type), final state f32, states before each chunk (b,c,h,p,n) f32.
// bf16 = 1: x, B, C, y are bfloat16; 0: float32. s0 may be null (zeros).
int ferret_ssd_fwd(int bf16, const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* s0, void* y, void* final_state, void* sb,
                   void* work, int b, int l, int h, int p, int n, int Q, void* stream) {
  const Dims d = make_dims(b, l, h, p, n, Q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? fwd<__nv_bfloat16>(x, dt, A, B, C, s0, y, final_state, sb, work, d, st)
              : fwd<float>(x, dt, A, B, C, s0, y, final_state, sb, work, d, st);
}

// dx, dB, dC in x's type; ddt, dA, ds0 f32. dfinal may be null (zeros).
int ferret_ssd_bwd(int bf16, const void* x, const void* dt, const void* A, const void* B,
                   const void* C, const void* sb, const void* dy, const void* dfinal,
                   void* dx, void* ddt, void* dA, void* dB, void* dC, void* ds0, void* work,
                   int b, int l, int h, int p, int n, int Q, void* stream) {
  const Dims d = make_dims(b, l, h, p, n, Q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? bwd<__nv_bfloat16>(x, dt, A, B, C, sb, dy, dfinal, dx, ddt, dA, dB, dC, ds0,
                                   work, d, st)
              : bwd<float>(x, dt, A, B, C, sb, dy, dfinal, dx, ddt, dA, dB, dC, ds0, work, d,
                           st);
}

}  // extern "C"
