// Batched complex128 solve X = psi^-1 U for Wilson's spectral matrix
// factorization on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the step's inverse to
// XLA (syncopy_tpu/ops/connectivity.py, wilson_sf's complex128 route). On
// the card the port's step g = inv(psi) @ U went to torch.linalg.inv_ex,
// a batched LU whose host work between its many small launches left the
// card idle for longer than the LU, the triangular solves and the product
// took together (about 5 ms of a 10.7 ms step at 501 bins of 128
// channels). This kernel does the same work in one launch: for every bin
// b of a (bins, N, N) batch, LU with partial pivoting of psi_b applied to
// U_b (getrf plus getrs on N right-hand sides), in FP64 throughout, for
// every N from 1 to 256. A bin with an exactly zero pivot writes NaN into
// its whole X, as the port's inv_ex route does where info != 0.
//
// Pivoting is partial (row) pivoting on |Re| + |Im|, as LAPACK's and
// MAGMA's izamax choose, the first largest of the candidate rows winning
// a tie. Rows are never moved: a pivot row is marked, the rows left keep
// their places in a scratch copy of [psi | U] (bins, N, 2N) that the
// wrapper allocates, and the back substitution reads each logical row from
// its physical place and writes X in logical order.
//
// Bound, per bin: about 4/3 N^3 complex multiply-adds (N^3 / 3 for the LU,
// N^3 / 2 each for applying L^-1 and U^-1 to N columns), 8 FP64 operations
// each: 22.4 MFLOP at N = 128, 11.2 GFLOP over 501 bins, 0.33 ms on the
// FP64 pipes (34 TFLOP/s), 0.17 ms at the FP64 tensor-core peak; against
// psi and U read and X written once, 786 KB a bin, 0.12 ms over 501 bins at
// 3.35 TB/s. So the pipes bound it, at about 28 FP64 operations a byte.
//
// Design. One bin of [psi | U] at N = 128 is 512 KB, more than a block's
// shared memory, so one block of 256 threads takes one bin through a
// right-looking blocked LU over the scratch copy, which stays in L2 and
// device memory; copies between it and shared memory keep four loads a
// thread in flight:
// - panels of PW = 32 columns: the panel's rows still unpivoted are loaded
//   into shared memory and factorized there, one thread a row, one block
//   barrier a column (the pivot search is fused into the previous column's
//   update: each thread offers its row's next magnitude as an integer key,
//   a warp shuffle and a pass over the eight warps' winners pick the
//   pivot); a row's update reads four columns before it writes them, with
//   no branch between, so that the loads issue together;
// - the rows right of the panel, in chunks of 64 columns: the pivot rows
//   by L11^-1 (each warp solves 8 columns at once, lanes on rows, the
//   finished value passed down by shuffles), then the trailing rows by
//   the rank-32 product L21 U12, a 4 x 4 tile of complex accumulators a
//   thread, its operands read from shared memory;
// - the back substitution in blocks of 32 rows from the bottom: the
//   block's right-hand sides less the product of its U row block with the
//   rows of X already solved (32-row tiles staged in shared memory), then
//   the 32 x 32 triangle solved by warps as above, with reciprocals of its
//   diagonal.
// Two blocks fit an SM up to N = 128 (104 KB of shared memory each, at
// most 128 registers a thread), so one block's barriers and shuffle chains
// hide under the other's products. For N <= 16 one warp takes a bin and a
// block packs eight bins (no trailing product at all): 3 to 6 times faster
// than a block a bin at N = 2 to 16, where a block a bin runs slower than
// the library's inverse (PERF.md section 6). Measured at (501,
// 128) on the H100 (PERF.md section 6): 1.79 ms, 18% of the FP64 pipes'
// bound; of a block's cycles the panels take about a fifth, the two warp
// solves a third, the products the rest. Designs that held the panel in
// registers, applied inverted triangles as products or kept the
// coefficients of the pivot rows in the panel ran slower here: each needs
// more than 128 registers a thread, and spilling or one block an SM cost
// more than it saved.
//
// One writer per element and a fixed order of every sum: two launches are
// bitwise equal. No atomics, no allocation, no host sync.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int PW = 32;        // panel width; rows of a back-substitution block
constexpr int PWP = PW + 1;   // padded row stride of panel-shaped tiles
constexpr int CPW = 8;        // columns a warp solves at once
constexpr int MAX_N = 256;
constexpr int SMALL_N = 16;   // N <= SMALL_N: one warp a bin
constexpr int BLOCK = 256;    // threads a block, both instances
constexpr int MIN_BLOCKS = 2;
constexpr int RT = 4;         // rows of a thread's tile in the trailing product
constexpr int CT = 4;         // columns of a thread's tile in both products
constexpr int UNROLL = 4;     // loads in flight a thread in a copy

__device__ __forceinline__ double2 czero() { return make_double2(0.0, 0.0); }

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
    return make_double2(fma(a.x, b.x, -a.y * b.y), fma(a.x, b.y, a.y * b.x));
}

// c - a b
__device__ __forceinline__ double2 csubmul(double2 c, double2 a, double2 b) {
    double re = fma(-a.x, b.x, c.x);
    re = fma(a.y, b.y, re);
    double im = fma(-a.x, b.y, c.y);
    im = fma(-a.y, b.x, im);
    return make_double2(re, im);
}

// 1 / a by Smith's algorithm (no overflow for large |a|); NaN for a = 0
__device__ __forceinline__ double2 crecip(double2 a) {
    if (fabs(a.x) >= fabs(a.y)) {
        const double r = a.y / a.x, d = 1.0 / (a.x + a.y * r);
        return make_double2(d, -r * d);
    }
    const double r = a.x / a.y, d = 1.0 / (a.y + a.x * r);
    return make_double2(r * d, -d);
}

// izamax's magnitude |Re| + |Im| as an integer key that orders as the
// magnitude does (the bits of a non-negative double); NaN reads as 0, so a
// NaN entry is a pivot only where every other candidate is 0 (and then
// spreads its NaN through X). No candidate: -1.
__device__ __forceinline__ long long mag_key(double2 a) {
    const double v = fabs(a.x) + fabs(a.y);
    return __double_as_longlong(v == v ? v : 0.0);
}

__device__ __forceinline__ double2 shfl(double2 v, int src) {
    return make_double2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
}

__device__ __forceinline__ bool ahead(long long v, int i, long long w, int j) {
    return v > w || (v == w && i < j);
}

// An augmented (N, 2N) matrix [lo | hi] read by row and column: the input
// pair (psi, U), each (N, N), or the scratch, one (N, 2N) row-major array.
struct Aug {
    const double2* lo;
    const double2* hi;
    int ld;
    int n;
    __device__ __forceinline__ double2 at(int r, int c) const {
        return c < n ? lo[r * ld + c] : hi[r * ld + (c - n)];
    }
};

// Shared memory of one bin, in double2 then double then int words; the
// same sums on the host and the device.
template <int CW>
struct Layout {
    static constexpr int CWP = CW + 1;
    int a, uc, ints;
    size_t bytes;
    __host__ __device__ explicit Layout(int N) {
        const int hm = N < PW ? N : PW;
        // the panel (N rows); in the back substitution the diagonal block,
        // and, where there are rows below it, the staged U and X tiles
        const int back = hm * PWP + (N > PW ? PW * PWP + PW * CWP : 0);
        a = N * PWP > back ? N * PWP : back;
        uc = hm * CWP;
        ints = 16 + 4 * N + PW + 8;  // ri, live, live2, P, rem, piv, cnt
        const size_t words = (size_t)(a + uc + PW) * 16 + 16 * 8 + (size_t)ints * 4;
        bytes = (words + 15) / 16 * 16;
    }
};

template <int TB>
__device__ __forceinline__ void group_sync() {
    if constexpr (TB == 32) {
        __syncwarp();
    } else {
        __syncthreads();
    }
}

// st(r, c, ld(r, c)) for r < rows, c < cols <= CS: a thread takes column
// tid % CS of every (TB / CS)-th row, UNROLL loads in flight at a time
template <int TB, int CS, class Ld, class St>
__device__ __forceinline__ void copy(int rows, int cols, int tid, Ld ld, St st) {
    constexpr int RS = TB / CS > 1 ? TB / CS : 1;
    const int c = tid % CS;
    if (c >= cols) return;
    for (int base = tid / CS; base < rows; base += RS * UNROLL) {
        double2 v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int r = base + u * RS;
            if (r < rows) v[u] = ld(r, c);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const int r = base + u * RS;
            if (r < rows) st(r, c, v[u]);
        }
    }
}

// The largest (v, i) of the group, ties to the lower i, in every thread.
template <int TB>
__device__ __forceinline__ void argmax(long long& v, int& i, long long* rv, int* ri, int buf,
                                       int lane, int warp) {
#pragma unroll
    for (int off = 16; off; off >>= 1) {
        const long long w = __shfl_xor_sync(0xffffffffu, v, off);
        const int j = __shfl_xor_sync(0xffffffffu, i, off);
        if (ahead(w, j, v, i)) {
            v = w;
            i = j;
        }
    }
    if constexpr (TB > 32) {
        constexpr int NW = TB / 32;
        if (lane == 0) {
            rv[buf * NW + warp] = v;
            ri[buf * NW + warp] = i;
        }
        __syncthreads();
        v = rv[buf * NW];
        i = ri[buf * NW];
#pragma unroll
        for (int w = 1; w < NW; ++w) {
            if (ahead(rv[buf * NW + w], ri[buf * NW + w], v, i)) {
                v = rv[buf * NW + w];
                i = ri[buf * NW + w];
            }
        }
    } else {
        __syncwarp();
    }
}

// Solve a (rows, <= CW) block of Uc in place by a triangle held in
// `tri` (stride PWP), each warp CPW columns at once, lanes on rows:
// unit lower (forward, L11) or upper with reciprocals `rdiag` (backward).
template <int TB, int CW, bool UPPER>
__device__ __forceinline__ void warp_solve(double2* Uc, const double2* tri, const int* tri_rows,
                                           const double2* rdiag, int rows, int w, int lane,
                                           int warp) {
    constexpr int NW = TB / 32, CWP = CW + 1;
    double2 x[CPW];
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
        const int c = warp + q * NW;
        x[q] = (lane < rows && c < w) ? Uc[lane * CWP + c] : czero();
    }
    if constexpr (UPPER) {
        for (int k = rows - 1; k >= 0; --k) {
            const double2 rk = rdiag[k];
            const double2 uk = lane < k ? tri[lane * PWP + k] : czero();
#pragma unroll
            for (int q = 0; q < CPW; ++q) {
                const double2 xk = cmul(shfl(x[q], k), rk);
                if (lane == k) {
                    x[q] = xk;
                } else if (lane < k) {
                    x[q] = csubmul(x[q], uk, xk);
                }
            }
        }
    } else {
        const int trow = lane < rows ? tri_rows[lane] : 0;
        for (int k = 0; k < rows - 1; ++k) {
            const double2 lk = (lane > k && lane < rows) ? tri[trow * PWP + k] : czero();
#pragma unroll
            for (int q = 0; q < CPW; ++q) {
                const double2 xk = shfl(x[q], k);
                if (lane > k) x[q] = csubmul(x[q], lk, xk);
            }
        }
    }
#pragma unroll
    for (int q = 0; q < CPW; ++q) {
        const int c = warp + q * NW;
        if (lane < rows && c < w) Uc[lane * CWP + c] = x[q];
    }
}

// TB threads take one bin; a block of BLOCK threads holds BLOCK / TB bins.
// CW = CPW * TB / 32 columns a chunk.
template <int TB>
__global__ void __launch_bounds__(BLOCK, MIN_BLOCKS)
wilson_solve_kernel(const double2* __restrict__ psi, const double2* __restrict__ U, double2* X,
                    double2* S, int64_t bins, int N) {
    constexpr int NW = TB / 32, CW = CPW * NW, CWP = CW + 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int g = threadIdx.x / TB, tid = threadIdx.x % TB;
    const int lane = threadIdx.x % 32, warp = tid / 32;
    const int64_t bin = (int64_t)blockIdx.x * (BLOCK / TB) + g;
    if (bin >= bins) return;  // a whole group: the groups never sync together

    const Layout<CW> lay(N);
    double2* A = reinterpret_cast<double2*>(smem_raw + (size_t)g * lay.bytes);
    double2* Uc = A + lay.a;
    double2* rdiag = Uc + lay.uc;
    long long* rv = reinterpret_cast<long long*>(rdiag + PW);
    int* ri = reinterpret_cast<int*>(rv + 16);
    int* live = ri + 16;   // physical rows still unpivoted, by slot
    int* live2 = live + N;
    int* P = live2 + N;    // logical row -> physical row
    int* rem = P + N;      // slots left after a panel
    int* piv = rem + N;    // the panel's pivot slots, in order
    int* cnt = piv + PW;   // per-warp counts (8)

    const int64_t nn = (int64_t)N * N;
    const Aug in{psi + bin * nn, U + bin * nn, N, N};
    double2* Sb = S + bin * 2 * nn;
    const Aug sc{Sb, Sb + N, 2 * N, N};
    double2* Xb = X + bin * nn;
    const int N2 = 2 * N;

    for (int s = tid; s < N; s += TB) live[s] = s;
    bool fail = false;
    group_sync<TB>();

    // forward: LU of psi's panels, the same row operations on U
    for (int k0 = 0; k0 < N; k0 += PW) {
        const int pw = min(PW, N - k0), m = N - k0;
        const Aug src = k0 == 0 ? in : sc;
        copy<TB, PW>(m, pw, tid, [&](int r, int c) { return src.at(live[r], k0 + c); },
                     [&](int r, int c, double2 v) { A[r * PWP + c] = v; });
        group_sync<TB>();

        // the panel, one thread a slot (m <= TB)
        const int s = tid;
        bool mine = s < m;
        long long v = mine ? mag_key(A[s * PWP]) : -1;
        int vi = mine ? s : INT_MAX;
        argmax<TB>(v, vi, rv, ri, 0, lane, warp);
        for (int j = 0; j < pw; ++j) {
            const int p = vi;
            if (tid == 0) piv[j] = p;
            const double2 pv = A[p * PWP + j];
            fail |= pv.x == 0.0 && pv.y == 0.0;
            if (s == p) mine = false;
            long long cand = -1;
            if (mine) {
                double2* row = A + s * PWP;
                const double2* prow = A + p * PWP;
                const double2 l = cmul(row[j], crecip(pv));
                row[j] = l;
                // four columns at a time, loads first, so that they issue
                // together (a group may read columns past pw, never store them)
                for (int xg = (j + 1) & ~3; xg < pw; xg += 4) {
                    double2 a[4], b[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
                        a[u] = row[xg + u];
                        b[u] = prow[xg + u];
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (xg + u > j && xg + u < pw) row[xg + u] = csubmul(a[u], l, b[u]);
                }
                if (j + 1 < pw) cand = mag_key(A[s * PWP + j + 1]);
            }
            if (j + 1 < pw) {
                v = cand;
                vi = mine ? s : INT_MAX;
                argmax<TB>(v, vi, rv, ri, (j + 1) & 1, lane, warp);
            }
        }
        group_sync<TB>();

        // the slots left, in slot order; the pivots' physical rows
        {
            const bool left = mine;
            const unsigned b = __ballot_sync(0xffffffffu, left);
            const int pos = __popc(b & ((1u << lane) - 1u));
            int off = 0;
            if constexpr (NW > 1) {
                if (lane == 0) cnt[warp] = __popc(b);
                __syncthreads();
                for (int w = 0; w < warp; ++w) off += cnt[w];
            }
            if (left) {
                rem[off + pos] = s;
                live2[off + pos] = live[s];
            }
            if (tid < pw) P[k0 + tid] = live[piv[tid]];
        }
        for (int idx = tid; idx < pw * pw; idx += TB) {
            const int i = idx / pw, j = idx - i * pw;
            Sb[(int64_t)live[piv[i]] * N2 + k0 + j] = A[piv[i] * PWP + j];
        }
        group_sync<TB>();

        const int mr = m - pw;
        for (int c0 = k0 + pw; c0 < N2; c0 += CW) {
            const int w = min(CW, N2 - c0);
            copy<TB, CW>(pw, w, tid, [&](int r, int c) { return src.at(P[k0 + r], c0 + c); },
                         [&](int r, int c, double2 v) { Uc[r * CWP + c] = v; });
            group_sync<TB>();
            warp_solve<TB, CW, false>(Uc, A, piv, nullptr, pw, w, lane, warp);
            group_sync<TB>();
            for (int idx = tid; idx < pw * w; idx += TB) {
                const int i = idx / w, c = idx - i * w;
                Sb[(int64_t)P[k0 + i] * N2 + c0 + c] = Uc[i * CWP + c];
            }
            if constexpr (TB == BLOCK) {
                // trailing rows -= L21 U12, a RT x CT tile a thread
                const int cg = tid % 16, rg = tid / 16;
                for (int rb = 0; rb < mr; rb += 16 * RT) {
                    int slot[RT], prow[RT];
                    bool rok[RT];
#pragma unroll
                    for (int p = 0; p < RT; ++p) {
                        const int r = rb + rg + 16 * p;
                        rok[p] = r < mr;
                        slot[p] = rem[rok[p] ? r : 0];
                        prow[p] = live[slot[p]];
                    }
                    double2 acc[RT][CT];
#pragma unroll
                    for (int p = 0; p < RT; ++p)
#pragma unroll
                        for (int q = 0; q < CT; ++q) {
                            const int c = cg + 16 * q;
                            acc[p][q] = (rok[p] && c < w) ? src.at(prow[p], c0 + c) : czero();
                        }
                    for (int k = 0; k < pw; ++k) {
                        double2 l[RT], u[CT];
#pragma unroll
                        for (int p = 0; p < RT; ++p) l[p] = A[slot[p] * PWP + k];
#pragma unroll
                        for (int q = 0; q < CT; ++q) u[q] = Uc[k * CWP + cg + 16 * q];
#pragma unroll
                        for (int p = 0; p < RT; ++p)
#pragma unroll
                            for (int q = 0; q < CT; ++q) acc[p][q] = csubmul(acc[p][q], l[p], u[q]);
                    }
#pragma unroll
                    for (int p = 0; p < RT; ++p)
#pragma unroll
                        for (int q = 0; q < CT; ++q) {
                            const int c = cg + 16 * q;
                            if (rok[p] && c < w) Sb[(int64_t)prow[p] * N2 + c0 + c] = acc[p][q];
                        }
                }
            }
            group_sync<TB>();
        }
        int* t = live;
        live = live2;
        live2 = t;
    }

    if (fail) {
        for (int64_t idx = tid; idx < nn; idx += TB)
            Xb[idx] = make_double2(__longlong_as_double(0x7ff8000000000000ll),
                                   __longlong_as_double(0x7ff8000000000000ll));
        return;
    }

    // backward: U X = the transformed U, 32-row blocks from the bottom
    double2* Ubb = A;
    double2* Ut = A + PW * PWP;
    double2* Xt = Ut + PW * PWP;
    for (int r0 = (N - 1) / PW * PW; r0 >= 0; r0 -= PW) {
        const int h = min(PW, N - r0), kb = r0 + h;
        copy<TB, PW>(h, h, tid, [&](int r, int c) { return sc.at(P[r0 + r], r0 + c); },
                     [&](int r, int c, double2 v) { Ubb[r * PWP + c] = v; });
        group_sync<TB>();
        if (tid < h) rdiag[tid] = crecip(Ubb[tid * PWP + tid]);
        for (int c0 = 0; c0 < N; c0 += CW) {
            const int w = min(CW, N - c0);
            if (TB == BLOCK && kb < N) {
                // right-hand sides less U[block, kb:] X[kb:], 2 x CT a thread
                const int cg = tid % 16, rg = tid / 16;
                double2 acc[2][CT];
#pragma unroll
                for (int p = 0; p < 2; ++p)
#pragma unroll
                    for (int q = 0; q < CT; ++q) {
                        const int i = rg + 16 * p, c = cg + 16 * q;
                        acc[p][q] = (i < h && c < w) ? sc.at(P[r0 + i], N + c0 + c) : czero();
                    }
                for (int kt = kb; kt < N; kt += PW) {
                    const int kw = min(PW, N - kt);
                    copy<TB, PW>(h, kw, tid, [&](int r, int c) { return sc.at(P[r0 + r], kt + c); },
                                 [&](int r, int c, double2 v) { Ut[r * PWP + c] = v; });
                    copy<TB, CW>(kw, w, tid,
                                 [&](int r, int c) { return Xb[(int64_t)(kt + r) * N + c0 + c]; },
                                 [&](int r, int c, double2 v) { Xt[r * CWP + c] = v; });
                    group_sync<TB>();
                    for (int kk = 0; kk < kw; ++kk) {
                        double2 l[2], u[CT];
#pragma unroll
                        for (int p = 0; p < 2; ++p) l[p] = Ut[(rg + 16 * p) * PWP + kk];
#pragma unroll
                        for (int q = 0; q < CT; ++q) u[q] = Xt[kk * CWP + cg + 16 * q];
#pragma unroll
                        for (int p = 0; p < 2; ++p)
#pragma unroll
                            for (int q = 0; q < CT; ++q) acc[p][q] = csubmul(acc[p][q], l[p], u[q]);
                    }
                    group_sync<TB>();
                }
#pragma unroll
                for (int p = 0; p < 2; ++p)
#pragma unroll
                    for (int q = 0; q < CT; ++q) {
                        const int i = rg + 16 * p, c = cg + 16 * q;
                        if (i < h && c < w) Uc[i * CWP + c] = acc[p][q];
                    }
            } else {
                copy<TB, CW>(h, w, tid, [&](int r, int c) { return sc.at(P[r0 + r], N + c0 + c); },
                             [&](int r, int c, double2 v) { Uc[r * CWP + c] = v; });
            }
            group_sync<TB>();
            warp_solve<TB, CW, true>(Uc, Ubb, nullptr, rdiag, h, w, lane, warp);
            group_sync<TB>();
            for (int idx = tid; idx < h * w; idx += TB) {
                const int i = idx / w, c = idx - i * w;
                Xb[(int64_t)(r0 + i) * N + c0 + c] = Uc[i * CWP + c];
            }
            group_sync<TB>();
        }
    }
}

template <int TB>
size_t smem_bytes(int N) {
    return Layout<CPW * TB / 32>(N).bytes * (BLOCK / TB);
}

template <int TB>
int configure() {
    // the most dynamic shared memory any N takes; set before every launch,
    // since the attribute holds for the current device only
    const int most = (int)smem_bytes<TB>(TB == 32 ? SMALL_N : MAX_N);
    return (int)cudaFuncSetAttribute(wilson_solve_kernel<TB>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, most);
}

}  // namespace

// X = psi^-1 U for `bins` (N, N) complex128 matrices, row-major and
// contiguous; S is scratch of bins * N * 2N complex128. Returns the
// launch's cudaError (0 on success).
extern "C" int wilson_solve_launch(const void* psi, const void* U, void* X, void* S, int64_t bins,
                                   int64_t N, void* stream) {
    if (N < 1 || N > MAX_N || bins < 0) return (int)cudaErrorInvalidValue;
    if (bins == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const double2* p = static_cast<const double2*>(psi);
    const double2* u = static_cast<const double2*>(U);
    double2* x = static_cast<double2*>(X);
    double2* s = static_cast<double2*>(S);
    if (N <= SMALL_N) {
        const int rc = configure<32>();
        if (rc) return rc;
        const int64_t per = BLOCK / 32;
        wilson_solve_kernel<32><<<(unsigned)((bins + per - 1) / per), BLOCK, smem_bytes<32>((int)N),
                                  st>>>(p, u, x, s, bins, (int)N);
    } else {
        const int rc = configure<BLOCK>();
        if (rc) return rc;
        wilson_solve_kernel<BLOCK><<<(unsigned)bins, BLOCK, smem_bytes<BLOCK>((int)N), st>>>(
            p, u, x, s, bins, (int)N);
    }
    return (int)cudaGetLastError();
}

// Threads a block and resident blocks per SM that the runtime grants the
// instance that takes N; 0 or the query's cudaError.
extern "C" int wilson_solve_occupancy(int64_t N, int* threads, int* blocks) {
    if (N < 1 || N > MAX_N) return (int)cudaErrorInvalidValue;
    const bool small = N <= SMALL_N;
    const int rc = small ? configure<32>() : configure<BLOCK>();
    if (rc) return rc;
    *threads = BLOCK;
    return small ? (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks, wilson_solve_kernel<32>, BLOCK, smem_bytes<32>((int)N))
                 : (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                       blocks, wilson_solve_kernel<BLOCK>, BLOCK, smem_bytes<BLOCK>((int)N));
}
