// The node merge/diverge solve of one engine step, for Hopper (sm_90a).
//
// Replaces the XLA-fused _classic_solve and _node_solve of the JAX package
// (pednstream_tpu/engine.py:446 and :458, not Pallas kernels), whose plain
// PyTorch version is pednstream_tpu_torch/ops/node_solve.py::
// node_solve_plain, on every classic solve: the fast path (compact turning
// fractions) and the dense phi of exact parity, in the flow type T (float
// or double).  For every replica b and node n, over the node's m slots (the
// first m of M):
//
//   s[i] = demand_t[b, n]           i = 0 of a node with a virtual pair
//        = S[b, in_link[n, i]]      a link's slot
//   r[j] = virt_recv[b, n]          j = 0 of a node with a virtual pair
//        = R[b, out_link[n, j]]     a link's slot
//
// A OneToOne node crosses: q_in[k] = min(s[k], r[1-k]), q_out[k] =
// min(s[1-k], r[k]) for k < 2.  Every other node takes the classic
// allocation on phi = phi_c[b, pos] where the node is routed (pos its row of
// the compact turning fractions), else phi_base[b, n] (the dense phi, one
// per replica, or phi_base shared by all):
//
//   dem[i, j]  = phi[i, j] * s[i]
//   col[j]     = sum over i of dem[i, j]
//   share      = dem / (col != 0 ? col : 1e-5)
//   supply     = r[j] * share
//   g          = floor(min(dem, supply))
//   q_in[i]    = max(sum over j of g, 0)     outflow of in-link i
//   q_out[j]   = max(sum over i of g, 0)     inflow of out-link j
//
// and the step takes outflow[b, e] = q_in at link e's (end node, slot),
// inflow[b, e] = q_out at its (start node, slot), virt_dep[b, n] and
// virt_arr[b, n] = q_in[0] and q_out[0] of a node with a virtual pair (else
// 0).  The plain version pads every node to M slots; a padded slot adds
// nothing (its s and r are 0, and so are phi's rows and columns of it), so
// the kernel skips them.  Every product, quotient and sum is its own _rn
// intrinsic, so no fused multiply-add forms.  col[j] adds in the plain
// version's order: on the fast path that of PyTorch's CUDA reduction over a
// dimension that is not the fastest (Reduce.cuh's thread_reduce: one thread
// per output, four accumulators, element i into accumulator i % 4, combined
// as ((a0 + a1) + a2) + a3), for exact parity left to right (SEQ,
// routing.seq_sum).  col enters only through col != 0 and the quotient, so
// the sign of a zero sum, the one thing the first add from 0 could change,
// never shows.  The sums of g are of whole numbers, exact in any order; min
// and max propagate NaN as torch.minimum and torch.clamp do.  Where a
// column's supply covers its demand (r >= 2 col, below) the division is
// skipped: g is floor(dem) there either way.  So the result equals the
// plain version on the card bit for bit.
//
// What bounds it.  Per replica it must read the S and R rows and the routed
// nodes' phi_c rows and write the inflow and outflow rows and the two [N]
// virtual vectors; phi_base, the tables, the shared demand column and
// virt_recv are read once for all replicas (they stay in L1 and L2).  At
// melbourne's B = 16384 that is about 0.29 GB a step, 87 microseconds at
// 3.35 TB/s; the float work is a division and a few roundings per (node,
// in slot, out slot), a fraction of that.  Bytes bound it; what the kernel
// does not hide is the latency of each node's chain (table reads, then the
// rows, then divisions one after another).
//
// What the design does about it.  The plain version is about 56 eager
// launches over [B, N, M, M] temporaries (0.8 GB each at melbourne's
// 16384 x 341 x 6 x 6) and solves every node with phi_base before it
// writes the routed and OneToOne nodes over.  Here one thread solves one
// (replica, node) once, over its own slots, in one launch over all B x N:
// the nodes of a replica are taken in the build's order
// (ops/node_solve.py::NodeTables: the classic nodes by arity, largest
// first, then the OneToOne ones), so that a warp's threads do alike work
// and read nearby words of the same rows.  A thread reads its slots' S and
// R words and phi rows through the read-only cache and writes its results
// at its node's own links: each link ends at exactly one node and starts at
// exactly one, so no two threads write one word (the tables' build checks
// it).  Nothing is staged, so every E takes the same path (grid_50x50's
// 9,800 links, the 108,240-link grid).  A block per replica that staged
// its rows in shared memory by cp.async, with this walk reading the rows
// in place where they did not fit, measured 3 % faster than this on
// melbourne and 6 % and 37 % slower on delft and the env (PERF.md), and
// was dropped.
//
// The node's slots are kept in registers: on the float fast path one
// instantiation per max degree M from 1 to 8 (every shipped network), with
// its loops unrolled; otherwise (double flows, exact parity, M > 8) up to 8
// or 32 slots with the loops kept as loops.  Larger M raises in the
// wrapper.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSlots = 32;

// the _rn arithmetic and the rest of what the solve needs, by flow type
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float floor_of(float x) { return floorf(x); }
__device__ __forceinline__ double floor_of(double x) { return floor(x); }
__device__ __forceinline__ float largest(float) { return FLT_MAX; }
__device__ __forceinline__ double largest(double) { return DBL_MAX; }
// torch.minimum and torch.clamp(min=) as PyTorch's CUDA kernels compute
// them: a NaN operand gives NaN, else fmin / fmax
__device__ __forceinline__ float min_nan(float a, float b) {
    return a != a ? a : b != b ? b : fminf(a, b);
}
__device__ __forceinline__ double min_nan(double a, double b) {
    return a != a ? a : b != b ? b : fmin(a, b);
}
__device__ __forceinline__ float max_nan(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ double max_nan(double x, double lo) { return x != x ? x : fmax(x, lo); }

// Every field 8 bytes wide: the layout of ops/node_solve.py::KernelArgs.
// The float operands and outputs are of the flow type T of the entry point.
struct NodeSolveArgs {
    const void* S;  // [B, E], strides (S_sb, S_se)
    long long S_sb, S_se;
    const void* R;  // [B, E]
    long long R_sb, R_se;
    const void* demand;  // demand_t [B, N] (demand_sb 0 when shared)
    long long demand_sb, demand_sn;
    const void* virt_recv;  // [B, N] (virt_recv_sb 0 when shared)
    long long virt_recv_sb, virt_recv_sn;
    const void* phi_base;  // [B, N, M, M], rows dense (phi_base_sb 0 when shared)
    long long phi_base_sb;
    const void* phi_c;  // [B, NR, M, M], rows dense; null when no node takes it
    long long phi_c_sb;
    const int* order;       // [N] the node ids in the order a replica's threads take them
    const int* node_flags;  // [N] bit 0 OneToOne, bit 1 a virtual pair, arity from bit 2
    const int* routed_pos;  // [N] row of phi_c, -1 where not routed
    const int* in_link;     // [N, M] the link ending at each slot, -1 for none
    const int* out_link;    // [N, M] the link starting at each slot, -1 for none
    void* inflow;    // [B, E] dense
    void* outflow;   // [B, E] dense
    void* virt_dep;  // [B, N] dense
    void* virt_arr;  // [B, N] dense
    long long B, E, N, M, NR;
    long long seq_sum;  // 1: the column sums left to right (exact parity)
};

template <typename T, int MAXM, bool FIXED, bool SEQ>
__global__ void __launch_bounds__(kThreads) node_solve_kernel(const NodeSolveArgs a) {
    // the slot loops unrolled where MAXM is the scenario's M, else kept as
    // loops (the slot arrays then live in local memory)
    constexpr int UNROLL = FIXED ? MAXM : 1;
    const int M = FIXED ? MAXM : (int)a.M;
    const int MM = M * M;
    const long long N = a.N, E = a.E;
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= a.B * N) return;
    const long long b = k / N;
    const int n = __ldg(a.order + (int)(k - b * N));
    const T* S = static_cast<const T*>(a.S) + b * a.S_sb;
    const T* R = static_cast<const T*>(a.R) + b * a.R_sb;
    const int flags = __ldg(a.node_flags + n);
    const bool virt = (flags & 2) != 0;
    const int m = flags >> 2;  // the node's slots, the first m of its M

    // each loop runs over all MAXM slots, the node's own guarded, so that
    // the trip counts stay constant and the slot arrays in registers
    int lin[MAXM], lout[MAXM];
    T s[MAXM], rv[MAXM], q_in[MAXM], q_out[MAXM];
#pragma unroll(UNROLL)
    for (int i = 0; i < MAXM; ++i) {
        if (i < m) {
            lin[i] = __ldg(a.in_link + n * M + i);
            lout[i] = __ldg(a.out_link + n * M + i);
            s[i] = lin[i] < 0 ? T(0) : __ldg(S + lin[i] * a.S_se);
            rv[i] = lout[i] < 0 ? T(0) : __ldg(R + lout[i] * a.R_se);
        }
        q_in[i] = T(0);
        q_out[i] = T(0);
    }
    if (virt) {
        s[0] = __ldg(static_cast<const T*>(a.demand) + b * a.demand_sb + n * a.demand_sn);
        rv[0] = __ldg(static_cast<const T*>(a.virt_recv) + b * a.virt_recv_sb +
                      n * a.virt_recv_sn);
    }

    if (flags & 1) {
        if constexpr (MAXM >= 2) {  // a OneToOne node has two slots
            q_in[0] = min_nan(s[0], rv[1]);
            q_in[1] = min_nan(s[1], rv[0]);
            q_out[0] = min_nan(s[1], rv[0]);
            q_out[1] = min_nan(s[0], rv[1]);
        }
    } else {
        const int pos = a.phi_c ? __ldg(a.routed_pos + n) : -1;
        const T* phi = pos >= 0
                           ? static_cast<const T*>(a.phi_c) + b * a.phi_c_sb + (long long)pos * MM
                           : static_cast<const T*>(a.phi_base) + b * a.phi_base_sb +
                                 (long long)n * MM;
        // the padded slots (from m on) add nothing: s and r are 0 there
        // and phi's rows and columns of them are 0
        T den[MAXM];
#pragma unroll(UNROLL)
        for (int j = 0; j < MAXM; ++j) {
            T col;
            if constexpr (SEQ) {
                col = T(0);
#pragma unroll(UNROLL)
                for (int i = 0; i < MAXM; ++i)
                    if (i < m && j < m) col = add_rn(col, mul_rn(__ldg(phi + i * M + j), s[i]));
            } else {
                T acc[4] = {T(0), T(0), T(0), T(0)};
#pragma unroll(UNROLL)
                for (int i = 0; i < MAXM; ++i)
                    if (i < m && j < m)
                        acc[i & 3] = add_rn(acc[i & 3], mul_rn(__ldg(phi + i * M + j), s[i]));
                col = add_rn(add_rn(add_rn(acc[0], acc[1]), acc[2]), acc[3]);
            }
            den[j] = col != T(0) ? col : T(1e-5);
        }
        // where the supply covers the demand, g = floor(dem) with no
        // division: r * (dem / den) >= dem for dem >= 0 whenever den > 0
        // and r is finite and at least 2 den, since the two roundings
        // lose less than that factor 2 (for dem >= 1 the quotient is at
        // least the reciprocal of the largest finite value, so even below
        // the normal range it keeps most of its bits; below 1 both floors
        // are 0)
        bool wide[MAXM];
#pragma unroll(UNROLL)
        for (int j = 0; j < MAXM; ++j)
            wide[j] = den[j] > T(0) && rv[j] <= largest(T(0)) && rv[j] >= T(2) * den[j];
#pragma unroll(UNROLL)
        for (int i = 0; i < MAXM; ++i) {
#pragma unroll(UNROLL)
            for (int j = 0; j < MAXM; ++j) {
                if (i < m && j < m) {
                    const T dem = mul_rn(__ldg(phi + i * M + j), s[i]);
                    const T g = (wide[j] && dem >= T(0))
                                    ? floor_of(dem)
                                    : floor_of(min_nan(dem, mul_rn(rv[j], div_rn(dem, den[j]))));
                    q_in[i] = add_rn(q_in[i], g);
                    q_out[j] = add_rn(q_out[j], g);
                }
            }
        }
#pragma unroll(UNROLL)
        for (int i = 0; i < MAXM; ++i) {
            q_in[i] = max_nan(q_in[i], T(0));
            q_out[i] = max_nan(q_out[i], T(0));
        }
    }

    // the node's results at its own links (each link ends at one node and
    // starts at one, so no other thread writes these words)
    T* outflow = static_cast<T*>(a.outflow) + b * E;
    T* inflow = static_cast<T*>(a.inflow) + b * E;
#pragma unroll(UNROLL)
    for (int i = 0; i < MAXM; ++i) {
        if (i < m && lin[i] >= 0) outflow[lin[i]] = q_in[i];
        if (i < m && lout[i] >= 0) inflow[lout[i]] = q_out[i];
    }
    static_cast<T*>(a.virt_dep)[b * N + n] = virt ? q_in[0] : T(0);
    static_cast<T*>(a.virt_arr)[b * N + n] = virt ? q_out[0] : T(0);
}

template <typename T, int MAXM, bool FIXED, bool SEQ>
int launch(const NodeSolveArgs& a, cudaStream_t stream) {
    const unsigned grid = (unsigned)((a.B * a.N + kThreads - 1) / kThreads);
    node_solve_kernel<T, MAXM, FIXED, SEQ><<<grid, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// the slots kept as loops: up to 8, else up to kMaxSlots
template <typename T, bool SEQ>
int launch_loops(const NodeSolveArgs& a, cudaStream_t s) {
    return a.M <= 8 ? launch<T, 8, false, SEQ>(a, s) : launch<T, kMaxSlots, false, SEQ>(a, s);
}

template <typename T>
int run(const void* args, void* stream) {
    const NodeSolveArgs& a = *static_cast<const NodeSolveArgs*>(args);
    if (a.B == 0 || a.N == 0) return 0;
    if (a.M < 1 || a.M > kMaxSlots || (a.B * a.N + kThreads - 1) / kThreads > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (a.seq_sum) return launch_loops<T, true>(a, s);
    if constexpr (sizeof(T) == sizeof(float)) {
        switch (a.M) {
            case 1: return launch<T, 1, true, false>(a, s);
            case 2: return launch<T, 2, true, false>(a, s);
            case 3: return launch<T, 3, true, false>(a, s);
            case 4: return launch<T, 4, true, false>(a, s);
            case 5: return launch<T, 5, true, false>(a, s);
            case 6: return launch<T, 6, true, false>(a, s);
            case 7: return launch<T, 7, true, false>(a, s);
            case 8: return launch<T, 8, true, false>(a, s);
            default: break;
        }
    }
    return launch_loops<T, false>(a, s);
}

}  // namespace

// One launch over the batch; the wrapper (ops/node_solve.py) checks the
// operands.  Returns cudaGetLastError(): 0 when the launch was accepted.
extern "C" int node_solve(const void* args, void* stream) { return run<float>(args, stream); }
extern "C" int node_solve_f64(const void* args, void* stream) {
    return run<double>(args, stream);
}
