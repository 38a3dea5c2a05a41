// Fused N-curve history reads for the LTM engine step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pednstream_tpu/ops/ncurve.py::fused_history_reads
// (pl.pallas_call in that file).  For every replica b and link e, over the
// time-major rings [B, H, E] (time index i lives at row i mod H):
//
//   ci[b,e]   = cum_in_ring [b, idx_ci[b,e] mod H, e]      (0 if idx_ci < 0)
//   co[b,e]   = cum_out_ring[b, idx_co[b,e] mod H, e]      (0 if idx_co < 0)
//   diff[b,e] = ((t0 + t1) + t2) + t3,  tk = coefs[b,k,e] * inflow_ring[b, (base[b,e]-k) mod H, e]
//               and tk = 0 where base-k < 0.
//
// Two instantiations of one body: float rings (the batched fast path) and
// double rings (the exact-parity anchor).  Coefs are float32 in both: the
// JAX exact path multiplies a float32 F*(1-F)^k into a float64 inflow
// (pednstream_tpu/engine.py:307-314), so the double kernel widens each coef
// exactly before its product.  Outputs take the rings' type, as the Pallas
// kernel's do.
//
// The TPU kernel reads each [H, tile] ring block whole and reduces it
// against one-hot masks, because per-lane dynamic gathers serialise on the
// TPU.  Here each thread owns one (replica, link) and makes at most six
// direct loads from the rings (ci, co and four inflow lags, 24 bytes in
// float, 48 in double), plus 28 bytes of indices and coefs and 12 (24) bytes
// of output, against the 3*H*4 ring bytes a link costs the TPU kernel.
// Neighbouring threads take neighbouring links, so each ring-row access of a
// warp is one coalesced segment.  At melbourne size (B=1024, E=938) the
// float kernel moves about 61 MB per call, under 20 microseconds at the
// card's 3.35 TB/s, so it is bound by launch and memory latency rather than
// by bytes; the double kernel on the exact path (B=1, E=938) is bound by
// its launch alone.
//
// Indices are reduced mod H only when non-negative (C's % truncates towards
// zero where jnp.mod floors).  The products and sums use the _rn intrinsics
// so no fused multiply-add is formed: the result then equals the plain
// PyTorch version (ops/ncurve.py::fused_history_reads_ref), which
// multiplies and adds in separate rounded steps in the same order, bit for
// bit.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T ring_at(const T* __restrict__ col, int idx, int H, long long E) {
    return idx >= 0 ? __ldg(col + (long long)(idx % H) * E) : T(0);
}

template <typename T>
__global__ void fused_history_reads_kernel(
    const T* __restrict__ cum_in_ring, const T* __restrict__ cum_out_ring,
    const T* __restrict__ inflow_ring, const int* __restrict__ idx_ci,
    const int* __restrict__ idx_co, const int* __restrict__ base,
    const float* __restrict__ coefs, T* __restrict__ ci_out,
    T* __restrict__ co_out, T* __restrict__ diff_out, int B, int H, int E) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (long long)B * E) return;
    const long long b = i / E;
    const long long e = i - b * E;
    const long long ring_off = b * H * (long long)E + e;

    ci_out[i] = ring_at(cum_in_ring + ring_off, __ldg(idx_ci + i), H, E);
    co_out[i] = ring_at(cum_out_ring + ring_off, __ldg(idx_co + i), H, E);

    const int bs = __ldg(base + i);
    const float* c = coefs + b * 4 * (long long)E + e;
    const T* in_col = inflow_ring + ring_off;
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int s = bs - k;
        const T term =
            s >= 0 ? mul_rn(T(__ldg(c + k * (long long)E)), ring_at(in_col, s, H, E)) : T(0);
        acc = k == 0 ? term : add_rn(acc, term);
    }
    diff_out[i] = acc;
}

template <typename T>
int launch(const void* cum_in_ring, const void* cum_out_ring, const void* inflow_ring,
           const void* idx_ci, const void* idx_co, const void* base, const void* coefs,
           void* ci_out, void* co_out, void* diff_out, int B, int H, int E, void* stream) {
    const long long n = (long long)B * E;
    if (n == 0) return 0;
    const int threads = 256;
    const unsigned int blocks = (unsigned int)((n + threads - 1) / threads);
    fused_history_reads_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)cum_in_ring, (const T*)cum_out_ring, (const T*)inflow_ring,
        (const int*)idx_ci, (const int*)idx_co, (const int*)base, (const float*)coefs,
        (T*)ci_out, (T*)co_out, (T*)diff_out, B, H, E);
    return (int)cudaGetLastError();
}

}  // namespace

// Every operand is dense and row-major: rings [B, H, E] (float in the first
// entry point, double in the second), indices [B, E] int32, coefs
// [B, 4, E] float32, outputs [B, E] of the rings' type.  Each launches on
// `stream` (a cudaStream_t) and returns cudaGetLastError(): 0 when the
// launch was accepted.
extern "C" int ncurve_fused_history_reads(
    const void* cum_in_ring, const void* cum_out_ring, const void* inflow_ring,
    const void* idx_ci, const void* idx_co, const void* base, const void* coefs,
    void* ci_out, void* co_out, void* diff_out, int B, int H, int E, void* stream) {
    return launch<float>(cum_in_ring, cum_out_ring, inflow_ring, idx_ci, idx_co, base,
                         coefs, ci_out, co_out, diff_out, B, H, E, stream);
}

extern "C" int ncurve_fused_history_reads_f64(
    const void* cum_in_ring, const void* cum_out_ring, const void* inflow_ring,
    const void* idx_ci, const void* idx_co, const void* base, const void* coefs,
    void* ci_out, void* co_out, void* diff_out, int B, int H, int E, void* stream) {
    return launch<double>(cum_in_ring, cum_out_ring, inflow_ring, idx_ci, idx_co, base,
                          coefs, ci_out, co_out, diff_out, B, H, E, stream);
}
