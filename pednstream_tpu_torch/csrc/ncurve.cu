// Fused N-curve history reads for the LTM engine step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fused_history_reads
// (pednstream_tpu/ops/ncurve.py:152-195, pl.pallas_call at :180) together
// with the lookback that feeds it (pednstream_tpu/engine.py:155-197,
// _lookback_state and _fused_hist).  For every replica b and link e, over
// the time-major rings [B, H, E] (time index i lives at row i mod H):
//
//   tau    = rint(avg_tt / unit_time)         (clamped to H - 6 when windowed;
//            float rings: rint(avg_tt * r), r = 1 / unit_time in float32,
//            as XLA compiles the JAX step's division by a constant)
//   tau_s  = tau_shockwave                    (clamped to H - 1 when windowed)
//   F      = 1 / (1 + gamma * avg_tt),  m = 1 - F,  q = m * m
//   coefs  = (F, F*m, F*q, F*(q*m))           all float32
//   ci     = cum_in_ring [b, max(t - tau, 0) mod H, e]
//   co     = cum_out_ring[b, max(t - tau_s, 0) mod H, e]
//   diff   = t0 + t1 + t2 + t3,  tk = coefs[k] * inflow_ring[b, (base-k) mod H, e],
//            base = t - 1 - tau, and tk = 0 where base - k < 0.
//
// The float instantiation adds the four terms in the order the JAX package's
// float32 read does on the CPU (a sum over the ring's rows, which XLA splits
// into windows of 32 rows: ascending slot order within a window, then the
// window sums; ops/ncurve.py::_slot_order_sum); the double one in the
// reference's lag order ((t0 + t1) + t2) + t3, which the golden fixtures hold.
//
// t is the step being executed: one int for a lockstep batch, or one int
// per replica (t_vec, [B]) where the replicas sit at different times, as
// under the JAX package's vmap over a per-replica t.  blockIdx.y is the
// replica, so the per-replica read is uniform over the block and costs
// 4 B per replica, not per link.
//
// Two instantiations of one body: float rings (the batched fast path) and
// double rings (the exact-parity anchor, where each float32 coef is widened
// exactly before its product, as pednstream_tpu/engine.py:307-314 does).
// Outputs take the rings' type.  Every rounding step is an _rn intrinsic,
// so no fused multiply-add forms and the result equals the plain PyTorch
// version (ops/ncurve.py::fused_history_reads_plain) bit for bit.
//
// What bounds it.  Counting each byte once, a (replica, link) needs six
// ring values (24 B in float), avg_tt (4 B) and three outputs (12 B):
// 40 B, or 38 MB at melbourne size (B=1024, E=938), 11.5 microseconds at
// the card's 3.35 TB/s.  gamma and tau_shockwave are per link, shared by
// the replicas (or one row each for randomized worlds).  The ring reads
// land on per-link rows, so a warp's read of one ring touches up to 32
// different 32-byte sectors for 128 useful bytes: where neighbouring links
// have different lags, the sector traffic, not the useful bytes, sets the
// time.  The integer work per link is two reductions mod H.
//
// What the design does about it.  The TPU kernel reduced each whole
// [H, tile] ring block against one-hot masks because per-lane gathers
// serialise there; here a thread owns one (replica, link) and loads only
// the rows it needs.  The lookback that used to take about twenty eager
// kernels and a 28 B/link round trip through device memory (indices and
// coefs) is computed in registers.  A 2-D grid (link tile, replica) needs
// no division to find the replica; the four diffusion lags are consecutive
// rows below base, so the slot steps down with a wrap instead of a
// reduction mod H each.
//
// A dense form for H = 16 rings, which loaded every row of a link's inflow
// column (coalesced across the warp, 64 B per link) and picked the four
// lags in registers, was slower than these direct loads at the main path's
// real and random operands on the H100 (PERF.md) and is not kept:
// neighbouring links share enough lag rows that the scattered sectors cost
// less than the whole column.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(double x) { return __double2float_rn(x); }

template <typename T>
struct HistoryArgs {
    const T* cum_in_ring;  // [B, H, E]
    const T* cum_out_ring;
    const T* inflow_ring;
    const float* avg_tt;  // [B, E], replica stride avg_tt_stride (0 or E)
    const T* gamma;       // [E] or [B, E], replica stride gamma_stride
    const int* tau_shockwave;
    long long avg_tt_stride, gamma_stride, tau_stride;
    const int* t_vec;  // [B] per-replica step, or null: every replica is at t
    T* out;  // [3, B, E]: ci, co, diff
    int B, H, E, t, windowed;
    float unit_time;  // float rings: its float32 reciprocal
};

// rows per window of XLA's CPU tree reduction (ops/ncurve.py SLOT_WINDOW)
constexpr int kSlotWindow = 32;

// v[k] for a k known only at run time, as selects: indexing the array with
// it would put the array in local memory
template <typename T>
__device__ __forceinline__ T pick4(const T (&v)[4], int k) {
    return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}

template <typename T>
__global__ void history_reads_kernel(const HistoryArgs<T> a) {
    constexpr bool kLagOrder = sizeof(T) == sizeof(double);
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= a.E) return;
    const int b = blockIdx.y;
    const int H = a.H;
    const long long E = a.E;
    const long long be = b * E + e;
    const int t = a.t_vec ? __ldg(a.t_vec + b) : a.t;

    const float tt = __ldg(a.avg_tt + b * a.avg_tt_stride + e);
    const float g = to_f32(__ldg(a.gamma + b * a.gamma_stride + e));
    int tau_s = __ldg(a.tau_shockwave + b * a.tau_stride + e);
    // round half to even
    int tau = __float2int_rn(kLagOrder ? __fdiv_rn(tt, a.unit_time) : __fmul_rn(tt, a.unit_time));
    if (a.windowed) {
        tau = min(tau, H - 6);
        tau_s = min(tau_s, H - 1);
    }
    const int base = t - 1 - tau;
    // idx_ci = max(t - tau, 0) = base + 1 when base >= 0, else 0
    const int base_slot = base >= 0 ? base % H : 0;
    const int ci_slot = base >= 0 ? (base_slot + 1 == H ? 0 : base_slot + 1) : 0;
    const int co_slot = max(t - tau_s, 0) % H;

    const long long col = (long long)b * H * E + e;
    const T ci = __ldg(a.cum_in_ring + col + ci_slot * E);
    const T co = __ldg(a.cum_out_ring + col + co_slot * E);

    const float F = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(g, tt)));
    const float m = __fsub_rn(1.0f, F);
    const float q = __fmul_rn(m, m);
    const float coef[4] = {F, __fmul_rn(F, m), __fmul_rn(F, q), __fmul_rn(F, __fmul_rn(q, m))};

    // the four lags are the rows base, base-1, base-2, base-3: step the
    // slot down with a wrap; a lag before time 0 adds nothing
    const T* in_col = a.inflow_ring + col;
    T term[4];
    int slot = base_slot;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        term[k] = base - k >= 0 ? mul_rn(T(coef[k]), __ldg(in_col + slot * E)) : T(0);
        slot = slot == 0 ? H - 1 : slot - 1;
    }
    T acc;
    if (kLagOrder) {
        acc = add_rn(add_rn(add_rn(term[0], term[1]), term[2]), term[3]);
    } else {
        // ascending slots hold lags 3, 2, 1, 0, rotated where they wrap past
        // row 0; a window boundary after the first or second of them splits
        // the sum in two runs (after the third it is the plain sum again)
        const int rot = base_slot >= 3 ? 0 : 3 - base_slot;
        const int pad_low = (kSlotWindow - H % kSlotWindow) % kSlotWindow / 2;
        T s[4];
        int run = 4, w0 = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = 3 - ((j + rot) & 3);  // the lag in the j-th slot, ascending
            s[j] = pick4(term, k);
            const int slot_j = base_slot - k < 0 ? base_slot - k + H : base_slot - k;
            const int w = H > kSlotWindow ? (slot_j + pad_low) / kSlotWindow : 0;
            if (j == 0) w0 = w;
            else if (w != w0 && run == 4) run = j;
        }
        if (run == 1) {
            acc = add_rn(s[0], add_rn(add_rn(s[1], s[2]), s[3]));
        } else if (run == 2) {
            acc = add_rn(add_rn(s[0], s[1]), add_rn(s[2], s[3]));
        } else {
            acc = add_rn(add_rn(add_rn(s[0], s[1]), s[2]), s[3]);
        }
    }

    const long long plane = (long long)a.B * E;
    a.out[be] = ci;
    a.out[plane + be] = co;
    a.out[2 * plane + be] = acc;
}

template <typename T>
int launch_history(const void* cum_in_ring, const void* cum_out_ring, const void* inflow_ring,
                   const void* avg_tt, long long avg_tt_stride, const void* gamma,
                   long long gamma_stride, const void* tau_shockwave, long long tau_stride,
                   void* out, int B, int H, int E, int t, const void* t_vec, float unit_time,
                   int windowed, void* stream) {
    if (B == 0 || E == 0) return 0;
    HistoryArgs<T> a{(const T*)cum_in_ring, (const T*)cum_out_ring, (const T*)inflow_ring,
                     (const float*)avg_tt, (const T*)gamma, (const int*)tau_shockwave,
                     avg_tt_stride, gamma_stride, tau_stride, (const int*)t_vec, (T*)out,
                     B, H, E, t, windowed, unit_time};
    // one warp-aligned tile of links per block, one block row per replica
    const int threads = E >= 256 ? 256 : (E + 31) / 32 * 32;
    const dim3 grid((E + threads - 1) / threads, B);
    history_reads_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Rings [B, H, E] dense and row-major, float in the first entry point and
// double in the second; avg_tt float32, gamma of the rings' type and
// tau_shockwave int32, each [E] or [B, E] with unit stride along the links
// and the given replica stride (0 or E); out [3, B, E] of the rings' type
// (ci, co, diff).  t_vec is null (every replica at step t) or int32 [B] on
// the device (t is then ignored).  unit_time is the step's length for
// double rings and its float32 reciprocal for float rings.  windowed is 0
// or 1.  Each launches on
// `stream` (a cudaStream_t) and returns cudaGetLastError(): 0 when the
// launch was accepted.
extern "C" int ncurve_history_reads(
    const void* cum_in_ring, const void* cum_out_ring, const void* inflow_ring,
    const void* avg_tt, long long avg_tt_stride, const void* gamma, long long gamma_stride,
    const void* tau_shockwave, long long tau_stride, void* out, int B, int H, int E, int t,
    const void* t_vec, float unit_time, int windowed, void* stream) {
    return launch_history<float>(cum_in_ring, cum_out_ring, inflow_ring, avg_tt, avg_tt_stride,
                                 gamma, gamma_stride, tau_shockwave, tau_stride, out, B, H, E,
                                 t, t_vec, unit_time, windowed, stream);
}

extern "C" int ncurve_history_reads_f64(
    const void* cum_in_ring, const void* cum_out_ring, const void* inflow_ring,
    const void* avg_tt, long long avg_tt_stride, const void* gamma, long long gamma_stride,
    const void* tau_shockwave, long long tau_stride, void* out, int B, int H, int E, int t,
    const void* t_vec, float unit_time, int windowed, void* stream) {
    return launch_history<double>(cum_in_ring, cum_out_ring, inflow_ring, avg_tt,
                                  avg_tt_stride, gamma, gamma_stride, tau_shockwave,
                                  tau_stride, out, B, H, E, t, t_vec, unit_time, windowed,
                                  stream);
}
