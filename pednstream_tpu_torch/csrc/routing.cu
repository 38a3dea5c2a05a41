// The routed turning fractions of one engine step, for Hopper (sm_90a).
//
// Replaces the XLA-fused routing.turning_fractions_step of the JAX package
// (pednstream_tpu/routing.py:405, the compact fast path and the exact
// path's routed rows; not a Pallas kernel), whose plain PyTorch version is
// pednstream_tpu_torch/routing.py::turning_fractions_step_plain.  For every
// replica b and routed node r it computes, in the tables' flow type T:
//
//   w[u]      = od_flow[b, uo_od[u]]                       uo entries of r
//   tot[ug]   = sum of w over the (node, up) group's members
//   p_uo[u]   = tot > 0 ? w / tot : uo_inv_count[u]
//   cap[k]    = down link real ? (recv_prev >= 0 ? recv_prev : cap_default) : 100
//   bn[k]     = T(beta * max(density - 2, 0) / 8)           (float32 product)
//   cap_sum[g]= sum of cap over the softmax group's members
//   util[k]   = (dist_util + bn) - omega * cap / (cap_sum + 1e-6)
//   z[k]      = exp(-temp * util)                           (XLA's float32 exp)
//   c[k]      = (z / zsum[g]) * p_uo[uo_idx]
//   phi[slot] = sum of c over the slot's members, then the row guard
//
// giving phi_c [B, NR, M, M].  Every sum walks a member table [S, Q, L]
// (entry ids ascending per row, -1 padding): each of the Q rows left to
// right, then the rows combined in XLA's CPU GEMV order,
// ((l0 + l2) + (l1 + l3)) + l4 for Q = 5 (float32), (l0 + l1) + l2 for Q = 3
// (float64), the row itself for Q = 1 (the exact-parity tables).  A row
// shorter than L adds +0.0 once more, as the plain version's padded
// columns do (it turns a -0.0 into +0.0 and changes nothing else).  The
// guard's row sum is left to right.  Every rounding is an _rn intrinsic, so
// no fused multiply-add forms; float32 exp is the polynomial of
// routing.exp_like_xla step for step, float64 exp the CUDA exp() that
// torch.exp calls.  So the result equals the plain version bit for bit.
//
// What bounds it.  A step needs, per replica, the node's density, recv_prev
// and cap_default of each distinct down link and od flow of each uo entry,
// and writes NR * M * M values: a few KB per replica.  The tables (member
// rows, entry tables, int64) are shared by the replicas and read once from
// device memory, then from L2.  The float work is about 50 operations per
// turn entry.  At these sizes neither bound is near: the step is launch-
// and latency-bound (a chain of dependent shared-memory phases per block).
//
// What the design does about it.  The plain version runs one eager
// where+gather+add per padded member column (about 2,000 launches per env
// step); here one block owns one (routed node, replica), so every segment
// of the node lies in the block and no sum crosses blocks or needs an
// atomic.  The build emits each node's entries, softmax groups, uo entries
// and (node, up) groups contiguously (node_offsets), so the block stages
// its node's values in shared memory and the member rows index them.  Each
// (segment, lane) is walked by one thread, which stops at the first -1
// instead of reading the padding; the lanes are then combined by one
// thread per segment.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// torch.clamp as PyTorch's CUDA kernels compute it: a NaN operand gives
// NaN, else fmaxf / fminf (so max(-0.0, 0.0) is +0.0)
__device__ __forceinline__ float max_nan(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
    return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// routing.exp_like_xla: XLA's CPU float32 exp (the Cephes polynomial, each
// step rounded on its own, results below the smallest normal flushed to 0)
__device__ __forceinline__ float exp_like_xla(float x) {
    x = clamp_nan(x, -87.80000305175781f, 88.80000305175781f);
    float n = clamp_nan(floorf(add_rn(mul_rn(x, 1.4426950216293335f), 0.5f)), -127.0f, 127.0f);
    const float r = sub_rn(sub_rn(x, mul_rn(0.693359375f, n)),
                           mul_rn(-0.00021219444170128554f, n));
    float y = add_rn(mul_rn(r, 0.00019875691214110702f), 0.001398199936375022f);
    y = add_rn(mul_rn(y, r), 0.008333452045917511f);
    y = add_rn(mul_rn(y, r), 0.04166579619050026f);
    y = add_rn(mul_rn(y, r), 0.1666666567325592f);
    y = add_rn(mul_rn(y, r), 0.5f);
    y = add_rn(add_rn(mul_rn(y, mul_rn(r, r)), r), 1.0f);
    y = mul_rn(y, __int_as_float(((int)n + 127) << 23));
    return y < 1.1754943508222875e-38f ? 0.0f : y;
}
__device__ __forceinline__ double exp_like_xla(double x) { return exp(x); }

// Every field 8 bytes wide: the layout of ops/routing.py::KernelArgs.
struct RoutingArgs {
    const void* density;  // [B, E] float32, strides (density_sb, density_se)
    long long density_sb, density_se;
    const void* recv_prev;  // [B, E] T
    long long recv_prev_sb, recv_prev_se;
    const void* cap_default;  // [B, E] T
    long long cap_default_sb, cap_default_se;
    const void* od_flow;  // [P] or [B, P] T
    long long od_flow_sb, od_flow_sp;
    const long long* te_down_link;  // [K]
    const long long* te_group;      // [K]
    const long long* te_uo_idx;     // [K]
    const void* dist_util;          // [K] T
    const long long* uo_od;         // [U]
    const long long* uo_group;      // [U]
    const void* uo_inv_count;       // [U] T
    const long long* group_members;     // [G, Q, Lg]
    const long long* uo_group_members;  // [UG, Q, Lu]
    const long long* phi_c_members;     // [NR * M * M, Q, Lp]
    const long long* node_offsets;  // [NR + 1, 4]: entry, group, uo entry, uo group
    const void* offdiag_uniform;    // [NR, M, M] T
    void* out;                      // [B, NR, M, M] T
    long long B, NR, M, Q, Lg, Lu, Lp;
    long long max_entries, max_groups, max_uo_entries, max_uo_groups;
    long long threads, shared_bytes;
    double beta, neg_temp, omega;
};

// Sums of vals over the members of segments [s0, s0 + S) of a table
// [*, Q, L] whose ids start at id0, into out[S]; lane holds Q * S partials.
// Ends with the block synchronised.
template <typename T>
__device__ void segment_sums(const long long* members, long long s0, int S, int Q, int L,
                             long long id0, const T* vals, T* lane, T* out) {
    for (int i = threadIdx.x; i < S * Q; i += blockDim.x) {
        const long long* row = members + ((s0 + i / Q) * Q + i % Q) * L;
        T acc = T(0);
        int c = 0;
        for (; c < L; ++c) {
            const long long m = __ldg(row + c);
            if (m < 0) break;
            const T v = vals[m - id0];
            acc = c == 0 ? v : add_rn(acc, v);
        }
        if (c > 0 && c < L) acc = add_rn(acc, T(0));
        lane[i] = acc;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const T* l = lane + s * Q;
        out[s] = Q == 5 ? add_rn(add_rn(add_rn(l[0], l[2]), add_rn(l[1], l[3])), l[4])
                 : Q == 3 ? add_rn(add_rn(l[0], l[1]), l[2])
                 : l[0];
    }
    __syncthreads();
}

template <typename T>
__global__ void turning_fractions_kernel(const RoutingArgs a) {
    const int r = blockIdx.x;
    const long long b = blockIdx.y;
    const int M = (int)a.M, Q = (int)a.Q, MM = M * M;
    const long long* off = a.node_offsets + 4 * r;
    const long long k0 = off[0], g0 = off[1], u0 = off[2], ug0 = off[3];
    const int nk = (int)(off[4] - k0), ng = (int)(off[5] - g0);
    const int nu = (int)(off[6] - u0), nug = (int)(off[7] - ug0);

    extern __shared__ unsigned char smem_raw[];
    T* s_uo = reinterpret_cast<T*>(smem_raw);  // w, then P(od | up)
    T* s_tot = s_uo + a.max_uo_entries;        // (node, up) sums
    T* s_ent_a = s_tot + a.max_uo_groups;      // capacity, then contribution
    T* s_ent_b = s_ent_a + a.max_entries;      // utility term bn, then z
    T* s_grp = s_ent_b + a.max_entries;        // capacity sums, then exp sums
    T* s_phi = s_grp + a.max_groups;           // the node's M x M slots
    T* s_lane = s_phi + MM;                    // per (segment, lane) partials

    const float* density = static_cast<const float*>(a.density);
    const T* recv_prev = static_cast<const T*>(a.recv_prev);
    const T* cap_default = static_cast<const T*>(a.cap_default);
    const T* od_flow = static_cast<const T*>(a.od_flow);
    const T* dist_util = static_cast<const T*>(a.dist_util);
    const T* uo_inv_count = static_cast<const T*>(a.uo_inv_count);

    // stage the node's od flows, capacities and density terms
    for (int i = threadIdx.x; i < nu; i += blockDim.x) {
        const long long p = __ldg(a.uo_od + u0 + i);
        s_uo[i] = od_flow[b * a.od_flow_sb + p * a.od_flow_sp];
    }
    const float beta = (float)a.beta;
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
        const long long l = __ldg(a.te_down_link + k0 + i);
        T cap = T(100);
        float dens = 0.0f;
        if (l >= 0) {
            const T rp = recv_prev[b * a.recv_prev_sb + l * a.recv_prev_se];
            cap = rp >= T(0) ? rp : cap_default[b * a.cap_default_sb + l * a.cap_default_se];
            dens = density[b * a.density_sb + l * a.density_se];
        }
        // torch.clamp(dens - 2, min=0) / (10 - 2): the division by 8 is exact
        const float nd = div_rn(max_nan(sub_rn(dens, 2.0f), 0.0f), 8.0f);
        s_ent_a[i] = cap;
        s_ent_b[i] = T(mul_rn(beta, nd));
    }
    __syncthreads();

    // P(od | up) and the capacity sums of the softmax groups
    segment_sums(a.uo_group_members, ug0, nug, Q, (int)a.Lu, u0, s_uo, s_lane, s_tot);
    for (int i = threadIdx.x; i < nu; i += blockDim.x) {
        const T tot = s_tot[__ldg(a.uo_group + u0 + i) - ug0];
        s_uo[i] = tot > T(0) ? div_rn(s_uo[i], tot) : uo_inv_count[u0 + i];
    }
    segment_sums(a.group_members, g0, ng, Q, (int)a.Lg, k0, s_ent_a, s_lane, s_grp);

    // the logit's numerators
    const T neg_temp = T(a.neg_temp), omega = T(a.omega);
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
        const T cap_sum = s_grp[__ldg(a.te_group + k0 + i) - g0];
        const T util = sub_rn(add_rn(dist_util[k0 + i], s_ent_b[i]),
                              div_rn(mul_rn(omega, s_ent_a[i]), add_rn(cap_sum, T(1e-6))));
        s_ent_b[i] = exp_like_xla(mul_rn(neg_temp, util));
    }
    __syncthreads();
    segment_sums(a.group_members, g0, ng, Q, (int)a.Lg, k0, s_ent_b, s_lane, s_grp);

    // each turn's share of its phi slot
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
        const T p_turn = div_rn(s_ent_b[i], s_grp[__ldg(a.te_group + k0 + i) - g0]);
        s_ent_a[i] = mul_rn(p_turn, s_uo[__ldg(a.te_uo_idx + k0 + i) - u0]);
    }
    __syncthreads();
    segment_sums(a.phi_c_members, (long long)r * MM, MM, Q, (int)a.Lp, k0, s_ent_a, s_lane,
                 s_phi);

    // the row guard (check_fractions): one thread per incoming slot
    const T* offdiag = static_cast<const T*>(a.offdiag_uniform) + (long long)r * MM;
    T* out = static_cast<T*>(a.out) + (b * a.NR + r) * MM;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
        const T* row = s_phi + i * M;
        T rowsum = row[0];
        for (int j = 1; j < M; ++j) rowsum = add_rn(rowsum, row[j]);
        T d = sub_rn(rowsum, T(1));
        d = d < T(0) ? -d : d;
        const bool need_fix = d > T(1e-3);
        const bool pos = rowsum > T(1e-6);
        for (int j = 0; j < M; ++j) {
            const T phi = row[j];
            out[i * M + j] = need_fix && pos ? div_rn(phi, rowsum)
                             : need_fix ? offdiag[i * M + j]
                             : phi;
        }
    }
}

template <typename T>
int launch(const RoutingArgs* args, void* stream) {
    if (args->B == 0 || args->NR == 0) return 0;
    const size_t smem = (size_t)args->shared_bytes;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            turning_fractions_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)args->NR, (unsigned)args->B);
    turning_fractions_kernel<T><<<grid, (unsigned)args->threads, smem, (cudaStream_t)stream>>>(
        *args);
    return (int)cudaGetLastError();
}

}  // namespace

// One launch for the whole batch: a block per (routed node, replica), on
// `stream` (a cudaStream_t).  float tables in the first entry point, double
// in the second; `args` points to a RoutingArgs block describing the
// operands.  Returns
// cudaGetLastError() after the launch: 0 when it was accepted.
extern "C" int routing_turning_fractions(const void* args, void* stream) {
    return launch<float>(static_cast<const RoutingArgs*>(args), stream);
}

extern "C" int routing_turning_fractions_f64(const void* args, void* stream) {
    return launch<double>(static_cast<const RoutingArgs*>(args), stream);
}
