// The fast binomial sampler of the engine step, for Hopper (sm_90a).
//
// Replaces the XLA-fused _binom(mode="fast") of the JAX package
// (pednstream_tpu/engine.py:109, not a Pallas kernel), whose plain PyTorch
// version is pednstream_tpu_torch/ops/binom.py::binom_fast_plain.  Given
// whole trial counts nf, success probabilities p, one uniform u and one
// standard normal z per element (all float32), it returns
//
//   n <= 16: the inverse CDF of u, walking the pmf by its term recursion
//            pmf_0 = (1 - p)^n, pmf_{k+1} = pmf_k * ((n - k) * r_k) * ratio,
//            r_k = float32(1 / (k + 1)), ratio = p / max(1 - p, 1e-12),
//            counting the k with u >= P[X <= k] and k < n;
//   n > 16:  min(max(rint(n p + sqrt(max(n p (1 - p), 0)) z), 0), n).
//
// with p clamped to [0, 1].  The division by k + 1 is a multiply by its
// float32 reciprocal, as XLA compiles the JAX sampler's division by a
// constant, and the walk's subnormal values (ratio, pmf_0, each product)
// are flushed to zero, as the JAX package's runtime flushes them.  Every
// rounding is an _rn intrinsic, so no fused multiply-add forms; powf is the
// CUDA function torch.pow calls, sqrt and rint are exact roundings.  So the
// result equals the plain version on the card bit for bit.  p may be
// broadcast: element i reads p[i % p_period].
//
// What bounds it.  Per element it reads nf, p, u, z and writes the sample:
// 20 B, or 19.2 MB at the main path's [1024, 938] (5.7 microseconds at
// 3.35 TB/s); the walk is about 200 float operations (3 microseconds at
// the card's float32 rate).  Bytes bound it.
//
// What the design does about it.  The plain version is the 16-term walk
// unrolled into about 130 eager elementwise launches, each reading and
// writing whole [B, E] tensors.  Here one thread owns one element and keeps
// the walk in registers: each input is read once and the sample written
// once.

#include <cuda_runtime.h>

namespace {

constexpr int kExactN = 16;

// torch.clamp and torch.minimum as PyTorch's CUDA kernels compute them: a
// NaN operand gives NaN, else fmaxf / fminf (so max(-0.0, 0.0) is +0.0)
__device__ __forceinline__ float max_nan(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float min_nan(float x, float hi) {
    return x != x ? x : hi != hi ? hi : fminf(x, hi);
}
// a non-negative x with its subnormal values flushed to zero
__device__ __forceinline__ float ftz(float x) { return x < 1.1754943508222875e-38f ? 0.0f : x; }

__global__ void binom_fast_kernel(const float* __restrict__ nf, const float* __restrict__ p,
                                  long long p_period, const float* __restrict__ u,
                                  const float* __restrict__ z, float* __restrict__ out,
                                  long long n) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
        const float nn = __ldg(nf + i);
        const float pc = min_nan(max_nan(__ldg(p + (p_period == 1 ? 0 : i % p_period)), 0.0f),
                                 1.0f);
        float out_i;
        if (nn <= (float)kExactN) {
            const float uu = __ldg(u + i);
            const float q = __fsub_rn(1.0f, pc);
            const float ratio = ftz(__fdiv_rn(pc, max_nan(q, 1e-12f)));
            float pmf = ftz(powf(q, nn));  // P[X = 0]
            float cdf = pmf;
            float cnt = 0.0f;
#pragma unroll
            for (int k = 0; k < kExactN; ++k) {
                // u >= P[X <= k]  =>  the sample exceeds k
                cnt = __fadd_rn(cnt, (uu >= cdf && nn > (float)k) ? 1.0f : 0.0f);
                const float step = __fmul_rn(__fsub_rn(nn, (float)k),
                                             __fdiv_rn(1.0f, (float)(k + 1)));
                pmf = ftz(__fmul_rn(ftz(__fmul_rn(pmf, step)), ratio));
                pmf = nn >= (float)(k + 1) ? pmf : 0.0f;
                cdf = __fadd_rn(cdf, pmf);
            }
            out_i = cnt;
        } else {
            const float mu = __fmul_rn(nn, pc);
            const float sigma = __fsqrt_rn(max_nan(__fmul_rn(mu, __fsub_rn(1.0f, pc)), 0.0f));
            const float g = rintf(__fadd_rn(mu, __fmul_rn(sigma, __ldg(z + i))));
            out_i = min_nan(max_nan(g, 0.0f), nn);
        }
        out[i] = out_i;
    }
}

}  // namespace

// nf, u, z and out dense float32 of n elements, p dense float32 of
// p_period elements (n a multiple of it); launches on `stream` (a
// cudaStream_t) and returns cudaGetLastError(): 0 when the launch was
// accepted.
extern "C" int binom_fast(const void* nf, const void* p, long long p_period, const void* u,
                          const void* z, void* out, long long n, void* stream) {
    if (n == 0) return 0;
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
    binom_fast_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        (const float*)nf, (const float*)p, p_period, (const float*)u, (const float*)z,
        (float*)out, n);
    return (int)cudaGetLastError();
}
