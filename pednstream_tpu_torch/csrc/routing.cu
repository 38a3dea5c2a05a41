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
// Two designs compute this function; the wrapper (ops/routing.py) takes
// one by the number of replicas B alone: the streamed design from B = 32,
// a warp of replicas, and the walk below it.
//
// The walk (turning_fractions_kernel, B < 32: the served and golden paths
// at B = 1, hetero, delft).  One block of 128 threads per (routed node,
// replica), so every segment of the node lies in the block and no sum
// crosses blocks or needs an atomic.  The build emits each node's entries,
// softmax groups, uo entries and (node, up) groups contiguously
// (node_offsets), so the block stages its node's values in shared memory
// and the member rows index them.  Each (segment, lane) is walked by one
// thread, which stops at the first -1 instead of reading the padding; the
// lanes are then combined by one thread per segment.  What bounds it: a
// chain of dependent phases per block (member ids from L2, a shared read,
// an add, nine barriers), and every block re-reads the tables its replica
// shares with the others.  At a few replicas that chain is the whole
// step, and lanes without a replica would idle in the streamed design.
//
// The streamed design (turning_fractions_kernel_lanes, B >= 32: the env,
// the trainers, the main path, the sweeps).  A lane holds one replica, and
// a block holds one unit, a routed node's up slot, for 32 replicas: every
// sum splits by up slot (a softmax group is (node, od, up), the P(od | up)
// sum is per (node, up), a phi row and the guard's row are the up slot's).
// The grid runs tile by tile of replicas, and within a tile over the
// units, those with the most entries first so that their blocks do not
// form the tail: the blocks in flight then gather their link terms and od
// flows from a few tiles' rows, which stay in L2, where unit by unit every
// block would sweep all the replicas' rows (that alone halved delft's
// time).  The unit's groups and entries stream past once per block in
// ascending id, read through warp-uniform loads of int32 codes listed unit
// by unit (routing.py::_lane_tables).  Every sum keeps the member tables'
// order: the rule by which the build gives an id its GEMV row, id % W
// below total - total % W and the epilogue above, is the one the tables
// hold, and row accumulators start at -0.0 (so the first member is taken
// as it is) and add +0.0 once when their row is shorter than the table's
// width (the codes' "short" bits).  A softmax group of up to four entries
// sums by its plan instead (routing.py::_sum_plan): its record lists its
// entries in the order in which the row accumulators, combined, add them,
// with the shape of that tree, so its two sums are a few adds and no row
// is selected at run time; longer groups keep the accumulators.  The
// (node, up) sum comes first; then group by group the capacity sum, z and
// its sum, each entry's c = (z / zsum) * P(od | up); each c into its phi
// slot's accumulator; then the guard.  A block has W warps
// (ops/routing.py::lane_warps: at least two where a unit has the groups,
// more where the batch alone leaves SMs idle), so an SM holds 40 warps at
// the kernel's 48 registers a thread, where one-warp blocks stop at its 32
// blocks.  The warps share a unit's groups out chunk by chunk and work
// them on their own, each writing its contributions to the chunk's shared
// buffer; after a barrier the contributions are added into the phi
// accumulators in ascending id, so the order and the bits do not depend
// on W.  A zero dividend, common among od flows and capacities, skips the
// correctly rounded division, which would take its slow path.
// Per-replica od flows (the env passes a strided column of its [B, P, T+1]
// table, each flow in its own 32-byte sector) are first copied to a [P, B]
// buffer (turning_fractions_kernel_od_by_pair), so a warp reads the flows
// of its 32 replicas as one 128-byte line.  What bounds it: each group's
// chain of about 100 instructions with two or three correctly rounded
// divisions and the exp polynomial, the (node, up) sum's od reads and the
// ordered adds into phi, no one of them above a tenth of the time; more
// warps an SM (40 registers, 48 warps) or two groups side by side in a
// warp did not help.  The tables are read once per 32 replicas.  Below
// about 64 replicas on large tables, and on tiny ones, the walk is a few
// microseconds faster; the threshold stays at a full warp of replicas.

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
    // the streamed design (routing.py::_lane_tables): its warps per block,
    // or 0 for the walk
    long long lanes;
    const int* lane_entry;      // [K] by unit
    const int* lane_group;      // [G, 4] by unit: od pair, code, first entry, entry codes
    const int* lane_unit;       // [NR * M + 1, 3]
    const int* lane_order;      // [NR * M]
    const int* lane_down_link;  // [NR, M]
    const int* lane_uo_short;   // [UG]
    const int* lane_phi_short;  // [NR * M * M]
    const void* lane_dist_util;  // [K] T by unit
    long long P;                // od pairs
    void* od_by_pair;           // [P, B] T scratch for per-replica od flows
};

// Replica b's capacity of down link l and its density term beta * bn,
// the second in float32 as the plain version stages it (l < 0: no link).
template <typename T>
__device__ __forceinline__ void link_terms(const RoutingArgs& a, long long b, long long l,
                                           T& cap, T& bn) {
    cap = T(100);
    float dens = 0.0f;
    if (l >= 0) {
        const T rp = static_cast<const T*>(a.recv_prev)[b * a.recv_prev_sb + l * a.recv_prev_se];
        cap = rp >= T(0) ? rp
              : static_cast<const T*>(a.cap_default)[b * a.cap_default_sb + l * a.cap_default_se];
        dens = static_cast<const float*>(a.density)[b * a.density_sb + l * a.density_se];
    }
    // torch.clamp(dens - 2, min=0) / (10 - 2): the division by 8 is exact
    const float nd = div_rn(max_nan(sub_rn(dens, 2.0f), 0.0f), 8.0f);
    bn = T(mul_rn((float)a.beta, nd));
}

// The row guard (check_fractions) of one phi row, phi[j * stride], into
// out[j]: renormalised when its sum is off 1 and positive, the uniform
// fallback when off 1 and not positive.  The row sum is left to right.
template <typename T>
__device__ __forceinline__ void guard_row(const T* phi, int stride, int M, const T* offdiag,
                                          T* out) {
    T rowsum = phi[0];
    for (int j = 1; j < M; ++j) rowsum = add_rn(rowsum, phi[j * stride]);
    T d = sub_rn(rowsum, T(1));
    d = d < T(0) ? -d : d;
    const bool need_fix = d > T(1e-3);
    const bool pos = rowsum > T(1e-6);
    for (int j = 0; j < M; ++j) {
        const T v = phi[j * stride];
        out[j] = need_fix && pos ? div_rn(v, rowsum) : need_fix ? offdiag[j] : v;
    }
}

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

    const T* od_flow = static_cast<const T*>(a.od_flow);
    const T* dist_util = static_cast<const T*>(a.dist_util);
    const T* uo_inv_count = static_cast<const T*>(a.uo_inv_count);

    // stage the node's od flows, capacities and density terms
    for (int i = threadIdx.x; i < nu; i += blockDim.x) {
        const long long p = __ldg(a.uo_od + u0 + i);
        s_uo[i] = od_flow[b * a.od_flow_sb + p * a.od_flow_sp];
    }
    for (int i = threadIdx.x; i < nk; i += blockDim.x)
        link_terms(a, b, __ldg(a.te_down_link + k0 + i), s_ent_a[i], s_ent_b[i]);
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

    // the row guard: one thread per incoming slot
    const T* offdiag = static_cast<const T*>(a.offdiag_uniform) + (long long)r * MM;
    T* out = static_cast<T*>(a.out) + (b * a.NR + r) * MM;
    for (int i = threadIdx.x; i < M; i += blockDim.x)
        guard_row(s_phi + i * M, 1, M, offdiag + i * M, out + i * M);
}

// ---- the streamed design: a block per (routed node's up slot, 32 replicas) ----

constexpr int LANE_TILE = 32;  // a block's replicas, a replica a lane of each warp
// the most entries a chunk of a unit's groups holds: one entry code a lane
// (ops/routing.py::LANE_CHUNK)
constexpr int LANE_CHUNK = 32;
// the most warps a block has (ops/routing.py::LANE_WARPS_MAX), and the
// blocks of that size an SM holds at the register budget this asks for:
// at most 48 registers a thread, so that an SM holds 40 warps (at 40 it
// held 48, but spilled in the group loop and ran slower)
constexpr int LANE_WARPS_MAX = 8;
constexpr int LANE_MIN_BLOCKS = 5;

// a / b as div_rn gives it, but a zero a where b > 0 is the quotient itself
// (with a's sign) and skips the division, whose correctly rounded form
// takes its slow path on a zero dividend: most od flows are zero (99.3 % at
// the env benchmark's step 300)
template <typename T>
__device__ __forceinline__ T div_zero(T a, T b) {
    if (a == T(0) && b > T(0)) return a;
    return div_rn(a, b);
}

// element i of a per-replica shared array whose lane's first element is p
#define AT(p, i) (p)[(i) * LANE_TILE]

// The sum of one segment from its Q row accumulators: +0.0 added to the
// rows shorter than the table's width (bit q of `short_rows`), then the
// rows in XLA's GEMV order.
template <typename T, int Q>
__device__ __forceinline__ T rows_sum(const T (&l)[Q], int short_rows) {
    T v[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) v[q] = (short_rows >> q) & 1 ? add_rn(l[q], T(0)) : l[q];
    if constexpr (Q == 5) {
        return add_rn(add_rn(add_rn(v[0], v[2]), add_rn(v[1], v[3])), v[4]);
    } else if constexpr (Q == 3) {
        return add_rn(add_rn(v[0], v[1]), v[2]);
    } else {
        return v[0];
    }
}

// v added into row `row` of the Q register accumulators (row is the same
// on every lane, so the unrolled selects cost no divergence; a row out of
// range adds nothing)
template <typename T, int Q>
__device__ __forceinline__ void add_row(T (&l)[Q], int row, T v) {
#pragma unroll
    for (int q = 0; q < Q; ++q) l[q] = q == row ? add_rn(l[q], v) : l[q];
}

template <typename T, int Q>
__device__ __forceinline__ void fresh(T (&l)[Q]) {
#pragma unroll
    for (int q = 0; q < Q; ++q) l[q] = T(-0.0);
}

// The per-replica od flows of a [B, P] operand (any strides) as a [P, B]
// buffer: 32 x 32 tiles through shared memory, so that both the reads
// along a replica's pairs and the writes along a pair's replicas coalesce
// where the operand's layout lets them.
template <typename T>
__global__ void turning_fractions_kernel_od_by_pair(const RoutingArgs a) {
    __shared__ T tile[32][33];
    const T* od = static_cast<const T*>(a.od_flow);
    T* out = static_cast<T*>(a.od_by_pair);
    const long long b0 = (long long)blockIdx.x * 32, p0 = (long long)blockIdx.y * 32;
    for (int i = threadIdx.y; i < 32; i += blockDim.y) {
        const long long b = b0 + i, p = p0 + threadIdx.x;
        if (b < a.B && p < a.P) tile[i][threadIdx.x] = od[b * a.od_flow_sb + p * a.od_flow_sp];
    }
    __syncthreads();
    for (int i = threadIdx.y; i < 32; i += blockDim.y) {
        const long long p = p0 + i, b = b0 + threadIdx.x;
        if (b < a.B && p < a.P) out[p * a.B + b] = tile[threadIdx.x][i];
    }
}

// The sum of a group's N values in the order and shape of its plan
// (ops/routing.py::_sum_plan): the bits of its Q row accumulators combined
// in XLA's order, with no row selected at run time.  `zero` is +0.0 where
// a row of the group is short, else -0.0 (which changes nothing).
template <typename T, int N>
__device__ __forceinline__ T plan_sum(const T (&v)[N], bool balanced, T zero) {
    T s = v[0];
    if constexpr (N == 2) {
        s = add_rn(v[0], v[1]);
    } else if constexpr (N == 3) {
        s = add_rn(add_rn(v[0], v[1]), v[2]);
    } else if constexpr (N == 4) {
        const T ab = add_rn(v[0], v[1]);
        s = balanced ? add_rn(ab, add_rn(v[2], v[3])) : add_rn(add_rn(ab, v[2]), v[3]);
    }
    return add_rn(s, zero);
}

// One softmax group of N entries for a warp's 32 replicas: its capacity
// sum, each entry's z and their sum, then each entry's contribution
// c = (z / zsum) * pu into cbuf at the entry's place in the group.  The
// bytes of `codes` give the entries in the order the group's sums take
// them, each its down slot and its place; so nothing waits on a table
// read, both sums are a few adds, and the entries' loads, divisions and
// exps are independent of each other.
template <typename T, int Q, int N>
__device__ __forceinline__ void group_chain(const T* cap, const T* bn, const T* dist_util,
                                            unsigned codes, int gcode, T pu, T neg_temp,
                                            T omega, T* cbuf) {
    const bool balanced = (gcode >> 16) & 1;
    const T zero = (gcode >> 17) & 1 ? T(0) : T(-0.0);
    T c[N], z[N];
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = AT(cap, (codes >> 8 * i) & 31);
    const T cap_eps = add_rn(plan_sum(c, balanced, zero), T(1e-6));
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int at = (codes >> (8 * i + 5)) & 3;
        const T util = sub_rn(add_rn(__ldg(dist_util + at), AT(bn, (codes >> 8 * i) & 31)),
                              div_zero(mul_rn(omega, c[i]), cap_eps));
        z[i] = exp_like_xla(mul_rn(neg_temp, util));
    }
    const T zsum = plan_sum(z, balanced, zero);
#pragma unroll
    for (int i = 0; i < N; ++i)
        AT(cbuf, (codes >> (8 * i + 5)) & 3) = mul_rn(div_rn(z[i], zsum), pu);
}

// group_chain for a group of any size n, its codes read from `entry`, its
// sums in Q row accumulators and its z kept in cbuf: the groups of more
// than four entries.
template <typename T, int Q>
__device__ __forceinline__ void group_chain_long(const T* cap, const T* bn, const T* dist_util,
                                                 const int* entry, int n, int short_rows, T pu,
                                                 T neg_temp, T omega, T* cbuf) {
    T acc[Q];
    fresh(acc);
    for (int i = 0; i < n; ++i) {
        const int e = __ldg(entry + i);
        add_row(acc, (e >> 5) & 7, AT(cap, e & 31));
    }
    const T cap_eps = add_rn(rows_sum(acc, short_rows), T(1e-6));
    fresh(acc);
    for (int i = 0; i < n; ++i) {
        const int e = __ldg(entry + i), d = e & 31;
        const T util = sub_rn(add_rn(__ldg(dist_util + i), AT(bn, d)),
                              div_zero(mul_rn(omega, AT(cap, d)), cap_eps));
        const T z = exp_like_xla(mul_rn(neg_temp, util));
        AT(cbuf, i) = z;
        add_row(acc, (e >> 5) & 7, z);
    }
    const T zsum = rows_sum(acc, short_rows);
    for (int i = 0; i < n; ++i) AT(cbuf, i) = mul_rn(div_rn(AT(cbuf, i), zsum), pu);
}

// One unit, a routed node's up slot u, for 32 replicas (a replica a
// lane), by W warps (blockDim.y, a power of two).  The warps stage the
// down slots' capacity and density terms, and add the (node, up) sum's
// GEMV rows among them (warp w the rows q with q % W == w), so every od
// flow is read once a block.  Then chunk by chunk of the unit's groups in
// ascending id, a chunk the groups whose entries fit in LANE_CHUNK: warp w
// works the chunk's groups w, w + W, ... on its own, each group one
// dependent chain (P(od | up), the capacity sum, z and its sum, each
// entry's contribution: group_chain by the group's plan, or
// group_chain_long), and writes each contribution to the chunk's
// buffer at its entry; after a barrier the warps add the buffer into the
// phi accumulators in ascending entry id (warp w those (down slot, GEMV
// row) accumulators s with s % W == w), so each accumulator takes its
// members in the order the member tables give, whatever warp worked them;
// a barrier, and the next chunk.  The (node, up) sum's rows, each
// replica's down slots' capacity and density terms, the phi row's
// accumulators [M][Q] and the chunk's buffer live in shared memory,
// LANE_TILE words apart (ops/routing.py::lane_bytes); the groups' sums in
// registers.  A lane past the batch reads the last replica's operands and
// writes nothing.
template <typename T, int Q>
__global__ void __launch_bounds__(LANE_TILE * LANE_WARPS_MAX, LANE_MIN_BLOCKS)
turning_fractions_kernel_lanes(const RoutingArgs a) {
    constexpr unsigned ALL = 0xffffffffu;
    const int M = (int)a.M, W = blockDim.y, w = threadIdx.y, lane = threadIdx.x;
    const int units = (int)a.NR * M;
    const int unit = a.lane_order[blockIdx.x % units];
    const int r = unit / M, u = unit - r * M;
    const long long b_live = (long long)(blockIdx.x / units) * LANE_TILE + lane;
    const long long b = min(b_live, a.B - 1);

    extern __shared__ unsigned char smem_raw[];
    T* cap = reinterpret_cast<T*>(smem_raw) + lane;  // [M]
    T* bn = cap + M * LANE_TILE;                      // [M]
    T* phi = bn + M * LANE_TILE;                      // [M][Q]
    T* tot_rows = phi + M * Q * LANE_TILE;            // [Q]
    T* cbuf = tot_rows + Q * LANE_TILE;               // [LANE_CHUNK]

    // this lane's od flow of pair p: od[p * od_sp], from the [P, B] copy of
    // per-replica flows or the shared [P] column
    const T* dist_util = static_cast<const T*>(a.lane_dist_util);
    const bool per_replica = a.od_by_pair != nullptr;
    const T* od = per_replica ? static_cast<const T*>(a.od_by_pair) + b
                              : static_cast<const T*>(a.od_flow);
    const long long od_sp = per_replica ? a.B : a.od_flow_sp;
    auto od_flow = [&](int p) { return od[p * od_sp]; };

    // each down slot's capacity and density term, where the unit has a
    // group to read them (a unit with none writes its guard's fallback row,
    // the same for every replica); the accumulators at -0.0
    const int* row = a.lane_unit + 3 * unit;
    const int4* groups = reinterpret_cast<const int4*>(a.lane_group);
    const int g0 = __ldg(row), g1 = __ldg(row + 3), ug = __ldg(row + 2);
    for (int d = w; d < M && g0 < g1; d += W)
        link_terms(a, b, __ldg(a.lane_down_link + r * M + d), AT(cap, d), AT(bn, d));
    for (int i = w; i < M * Q; i += W) AT(phi, i) = T(-0.0);

    // the (node, up) sum of the groups' od flows: this warp's GEMV rows,
    // eight flows in flight
    T acc[Q];
    fresh(acc);
    for (int c = g0; c < g1; c += 32) {
        const int m = min(32, g1 - c);
        const int4 rec = lane < m ? __ldg(groups + c + lane) : make_int4(0, 0, 0, 0);
        const int q = (rec.y >> 8) & 7;
        unsigned todo = __ballot_sync(ALL, lane < m && (q & (W - 1)) == w);
        while (todo) {
            T flow[8];
            int rows[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const int s = todo ? __ffs(todo) - 1 : 0;
                const int p = __shfl_sync(ALL, rec.x, s), qs = __shfl_sync(ALL, q, s);
                flow[j] = todo ? od_flow(p) : T(0);
                rows[j] = todo ? qs : -1;
                todo &= todo - 1;
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) add_row(acc, rows[j], flow[j]);
        }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
        if ((q & (W - 1)) == w) AT(tot_rows, q) = acc[q];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = AT(tot_rows, q);
    const T tot = ug >= 0 ? rows_sum(acc, __ldg(a.lane_uo_short + ug)) : T(0);
    const T inv = div_rn(T(1), T(g1 - g0));

    // chunk by chunk: this warp's groups into the chunk's buffer, then the
    // buffer into the phi accumulators in ascending id
    const T neg_temp = T(a.neg_temp), omega = T(a.omega);
    const int k_unit = __ldg(row + 1);
    for (int c = g0; c < g1;) {
        const int m = min(32, g1 - c);
        const int4 rec = lane < m ? __ldg(groups + c + lane) : make_int4(0, 0, 0, 0);
        // each group's first entry in the chunk; the chunk, the groups
        // that end within LANE_CHUNK entries of its first
        const int first = __shfl_sync(ALL, rec.z, 0);
        const int at = rec.z - first, end = at + (rec.y & 255);
        const int mc = __popc(__ballot_sync(ALL, lane < m && end <= LANE_CHUNK));
        const int chunk = __shfl_sync(ALL, end, mc - 1);
        const int k0 = k_unit + first;
        const int code = lane < chunk ? __ldg(a.lane_entry + k0 + lane) : 0;

        // the groups w, w + W, ... of the chunk, each group's od flow loaded
        // a group ahead
        int j = w;
        const int p0 = __shfl_sync(ALL, rec.x, j);
        T w_od = j < mc ? od_flow(p0) : T(0);
        for (; j < mc; j += W) {
            const int pn = __shfl_sync(ALL, rec.x, min(j + W, 31));
            const T w_next = j + W < mc ? od_flow(pn) : T(0);
            const int gcode = __shfl_sync(ALL, rec.y, j), g_at = __shfl_sync(ALL, at, j);
            const unsigned codes = (unsigned)__shfl_sync(ALL, rec.w, j);
            const int n = gcode & 255;
            const T pu = tot > T(0) ? div_zero(w_od, tot) : inv;
            T* cb = cbuf + g_at * LANE_TILE;
            const T* du = dist_util + k0 + g_at;
            switch (n) {
                case 1:
                    group_chain<T, Q, 1>(cap, bn, du, codes, gcode, pu, neg_temp, omega, cb);
                    break;
                case 2:
                    group_chain<T, Q, 2>(cap, bn, du, codes, gcode, pu, neg_temp, omega, cb);
                    break;
                case 3:
                    group_chain<T, Q, 3>(cap, bn, du, codes, gcode, pu, neg_temp, omega, cb);
                    break;
                case 4:
                    group_chain<T, Q, 4>(cap, bn, du, codes, gcode, pu, neg_temp, omega, cb);
                    break;
                default:
                    group_chain_long<T, Q>(cap, bn, du, a.lane_entry + k0 + g_at, n,
                                           (gcode >> 11) & 31, pu, neg_temp, omega, cb);
            }
            w_od = w_next;
        }
        __syncthreads();

        // the chunk's contributions in ascending id, each into its (down
        // slot, GEMV row) accumulator: this warp's accumulators
        const int slot = (code & 31) * Q + ((code >> 5) & 7);
        unsigned todo = __ballot_sync(ALL, lane < chunk && (slot & (W - 1)) == w);
        while (todo) {
            const int e = __ffs(todo) - 1;
            todo &= todo - 1;
            T* x = &AT(phi, __shfl_sync(ALL, slot, e));
            *x = add_rn(*x, AT(cbuf, e));
        }
        __syncthreads();
        c += mc;
    }

    // the unit's phi row, then its guard (check_fractions)
    if (w != 0 || b_live >= a.B) return;
    const int MM = M * M;
    const int* phi_short = a.lane_phi_short + r * MM + u * M;
    for (int d = 0; d < M; ++d) {
        T l[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) l[q] = AT(phi, d * Q + q);
        AT(phi, d * Q) = rows_sum(l, __ldg(phi_short + d));
    }
    guard_row(phi, Q * LANE_TILE, M,
              static_cast<const T*>(a.offdiag_uniform) + (long long)r * MM + u * M,
              static_cast<T*>(a.out) + (b * a.NR + r) * MM + u * M);
}

// The streamed kernel's attributes set as its launches need them: the most
// shared memory an SM can give (its blocks are few warps each, and an SM
// should hold as many as its registers allow), and `smem` bytes a block.
template <typename T, int Q>
cudaError_t prepare_lanes(size_t smem) {
    cudaError_t err = cudaFuncSetAttribute(turning_fractions_kernel_lanes<T, Q>,
                                           cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && smem > 48 * 1024)
        err = cudaFuncSetAttribute(turning_fractions_kernel_lanes<T, Q>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return err;
}

template <typename T, int Q>
int launch_lanes(const RoutingArgs* args, cudaStream_t stream) {
    if (args->od_by_pair) {
        const dim3 grid((unsigned)((args->B + 31) / 32), (unsigned)((args->P + 31) / 32));
        turning_fractions_kernel_od_by_pair<T><<<grid, dim3(32, 8), 0, stream>>>(*args);
    }
    const size_t smem = (size_t)args->shared_bytes;
    const cudaError_t err = prepare_lanes<T, Q>(smem);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (args->B + LANE_TILE - 1) / LANE_TILE;
    turning_fractions_kernel_lanes<T, Q><<<(unsigned)(args->NR * args->M * tiles),
                                           dim3(LANE_TILE, (unsigned)args->lanes), smem,
                                           stream>>>(*args);
    return (int)cudaGetLastError();
}

// The streamed kernel's registers a thread, its local (spilled) bytes a
// thread and the blocks of args->lanes warps and args->shared_bytes an SM
// holds, into out[0..2].
template <typename T, int Q>
int occupancy_lanes(const RoutingArgs* args, int* out) {
    cudaFuncAttributes attr = {};
    cudaError_t err = cudaFuncGetAttributes(&attr, turning_fractions_kernel_lanes<T, Q>);
    if (err == cudaSuccess) err = prepare_lanes<T, Q>((size_t)args->shared_bytes);
    int blocks = 0;
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, turning_fractions_kernel_lanes<T, Q>, LANE_TILE * (int)args->lanes,
            (size_t)args->shared_bytes);
    out[0] = attr.numRegs;
    out[1] = (int)attr.localSizeBytes;
    out[2] = blocks;
    return (int)err;
}

template <typename T>
int launch(const RoutingArgs* args, void* stream) {
    if (args->B == 0 || args->NR == 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (args->lanes) {
        switch (args->Q) {
            case 5: return launch_lanes<T, 5>(args, s);
            case 3: return launch_lanes<T, 3>(args, s);
            case 1: return launch_lanes<T, 1>(args, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    const size_t smem = (size_t)args->shared_bytes;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            turning_fractions_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const dim3 grid((unsigned)args->NR, (unsigned)args->B);
    turning_fractions_kernel<T><<<grid, (unsigned)args->threads, smem, s>>>(*args);
    return (int)cudaGetLastError();
}

template <typename T>
int occupancy(const RoutingArgs* args, void* out) {
    switch (args->Q) {
        case 5: return occupancy_lanes<T, 5>(args, static_cast<int*>(out));
        case 3: return occupancy_lanes<T, 3>(args, static_cast<int*>(out));
        case 1: return occupancy_lanes<T, 1>(args, static_cast<int*>(out));
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// The whole batch on `stream` (a cudaStream_t), by the design args->lanes
// names: 0, the walk, a block per (routed node, replica); else the
// streamed design, a block of args->lanes warps per (routed node's up
// slot, 32 replicas), after the copy of per-replica od flows to [P, B]
// where od_by_pair is set.  float tables in
// the first entry point, double in the second; `args` points to a
// RoutingArgs block describing the operands.  Returns cudaGetLastError()
// after the launches: 0 when they were accepted.
extern "C" int routing_turning_fractions(const void* args, void* stream) {
    return launch<float>(static_cast<const RoutingArgs*>(args), stream);
}

extern "C" int routing_turning_fractions_f64(const void* args, void* stream) {
    return launch<double>(static_cast<const RoutingArgs*>(args), stream);
}

// The streamed kernel for the tables `args` describes (Q, the flow type of
// the entry point), at its args->lanes warps and args->shared_bytes a
// block: registers a thread, local bytes a thread and resident blocks an
// SM, into the three ints at `out`.  Launches nothing; `stream` is unused.
extern "C" int routing_lanes_occupancy(const void* args, void* out, void* stream) {
    return occupancy<float>(static_cast<const RoutingArgs*>(args), out);
}

extern "C" int routing_lanes_occupancy_f64(const void* args, void* out, void* stream) {
    return occupancy<double>(static_cast<const RoutingArgs*>(args), out);
}
