// Cross-spectral density accumulation for Hopper (sm_90a): the tiled and
// the untiled form, one kernel body.
//
// Replaces the Pallas TPU kernels in syncopy_tpu/ops/pallas_kernels.py:
//   csd_accumulate_tiled (body _csd_tiled_kernel): a complex64 (N, F, C)
//     spectrum read in place as float2, rows n < n_valid, complex64 out;
//   csd_accumulate (body _csd_kernel): two float32 (F, N, C) planes (real,
//     imaginary), all N rows, two float32 (F, C, C) planes out.
// Both form, for every frequency f, the Hermitian Gram
//
//     cs[f, i, j] = sum_{n < n_valid} s[n, f, i] * conj(s[n, f, j])
//
// The body is a template over how a row is loaded (RowLoader) and how a
// result is written (OutWriter); the arithmetic is shared.
//
// Numerics: rows are taken in groups of 256 (GROUP_ROWS); inside a group
// the products accumulate in plain float32 FMA with the JAX sign
// convention (Re += ar_i ar_j + ai_i ai_j, Im += ai_i ar_j - ar_i ai_j);
// after each group the partial is added into a (hi, lo) pair by TwoSum,
// written with __fadd_rn/__fsub_rn so the compiler can neither contract
// nor reorder it. That is at least as accurate as the TPU's single
// HIGHEST-precision contraction of the untiled kernel. The file must not
// be built with --use_fast_math. Rows at or past n_valid are never read,
// which keeps NaN padding out exactly as the TPU kernel's where-mask does;
// n_valid = 0 writes exact zeros. Every output element has one writer: no
// atomics, so results are deterministic.
//
// Layout: one block per (frequency, 32x32 output tile with i-tile <= j-tile),
// the tile pairs of a frequency in consecutive blocks.
// 64 threads; each owns a 4x4 micro-tile (i = i0 + ty + 8a, j = j0 + tx + 8b).
// Rows are staged through shared memory STAGE_ROWS at a time for both
// channel tiles. The block writes hi + lo at (f, i, j) and its conjugate at
// (f, j, i); on diagonal tiles only the thread with i <= j writes.
//
// What bounds it: 8*F*N*C^2 FP32 operations (~49 GFLOP at N=3000, F=501,
// C=64; the i<=j tiles do 3/4 of that at C=64) over a 0.77 GB spectrum, so
// the FP32 FMA pipes and the shared-memory loads that feed them, not HBM
// (an estimate from shapes). Tensor cores stay unused: TF32 keeps ~10
// mantissa bits and would break the 1e-5 relative bar. The untiled form
// at its bench shape (F, N, C) = (501, 3000, 64) does the same work; its
// planar rows are C contiguous floats per plane, read as two loads.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;          // output tile edge (channels)
constexpr int THREADS_X = 8;      // threads along j
constexpr int THREADS_Y = 8;      // threads along i
constexpr int MICRO = TILE / THREADS_X;  // 4 outputs per thread per axis
constexpr int STAGE_ROWS = 32;    // rows staged in shared memory at a time
constexpr int GROUP_ROWS = 256;   // TwoSum group (the TPU kernel's row_block)
constexpr int NTHREADS = THREADS_X * THREADS_Y;

static_assert(GROUP_ROWS % STAGE_ROWS == 0, "stages must tile a group");

// A row loader gives the view of one frequency, at(f), and a row of that
// view, row(n), whose operator[] loads channel c as float2. The kernel
// takes both once per block and per staged row, so the staging loop does
// no 64-bit index arithmetic per element: a loader that computed
// (n * F + f) * C + c per element made the tiled kernel 1.3x slower on an
// H100 at the bench shape; with the views it is bitwise the same and
// faster than the untemplated kernel it replaced.

// complex64 (N, F, C), interleaved (re, im)
struct InterleavedRows {
    const float2* spec;
    int64_t freq_stride;  // C
    int64_t row_stride;   // F * C
    struct Row {
        const float2* p;
        __device__ __forceinline__ float2 operator[](int64_t c) const { return p[c]; }
    };
    __device__ __forceinline__ InterleavedRows at(int64_t f) const {
        return {spec + f * freq_stride, freq_stride, row_stride};
    }
    __device__ __forceinline__ Row row(int64_t n) const { return {spec + n * row_stride}; }
};

// two float32 (F, N, C) planes
struct PlanarRows {
    const float* re;
    const float* im;
    int64_t freq_stride;  // N * C
    int64_t row_stride;   // C
    struct Row {
        const float* re;
        const float* im;
        __device__ __forceinline__ float2 operator[](int64_t c) const {
            return make_float2(re[c], im[c]);
        }
    };
    __device__ __forceinline__ PlanarRows at(int64_t f) const {
        return {re + f * freq_stride, im + f * freq_stride, freq_stride, row_stride};
    }
    __device__ __forceinline__ Row row(int64_t n) const {
        return {re + n * row_stride, im + n * row_stride};
    }
};

// complex64 (F, C, C)
struct InterleavedOut {
    float2* out;
    __device__ __forceinline__ void store(int64_t o, float re, float im) const {
        out[o] = make_float2(re, im);
    }
};

// two float32 (F, C, C) planes
struct PlanarOut {
    float* re;
    float* im;
    __device__ __forceinline__ void store(int64_t o, float r, float i) const {
        re[o] = r;
        im[o] = i;
    }
};

__device__ __forceinline__ void two_sum_into(float& hi, float& lo, float p) {
    // Knuth TwoSum: s + e == hi + p exactly; e folds into lo
    float s = __fadd_rn(hi, p);
    float bb = __fsub_rn(s, hi);
    float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(p, bb));
    hi = s;
    lo = __fadd_rn(lo, e);
}

template <class RowLoader, class OutWriter>
__global__ void __launch_bounds__(NTHREADS)
csd_accumulate_kernel(RowLoader rows, OutWriter out, int64_t C, int64_t n_valid,
                      int n_tiles, int n_pairs) {
    // the tile pairs of one frequency are consecutive blocks, so they run
    // together and share that frequency's rows through L2
    const int64_t f = blockIdx.x / n_pairs;
    int p = blockIdx.x % n_pairs;

    // tile pair p -> (ti, tj), ti <= tj, row-major over the upper triangle
    int ti = 0;
    while (p >= n_tiles - ti) {
        p -= n_tiles - ti;
        ++ti;
    }
    const int tj = ti + p;
    const int64_t i0 = static_cast<int64_t>(ti) * TILE;
    const int64_t j0 = static_cast<int64_t>(tj) * TILE;

    const int tx = threadIdx.x % THREADS_X;
    const int ty = threadIdx.x / THREADS_X;

    __shared__ float2 sa[STAGE_ROWS][TILE];
    __shared__ float2 sb[STAGE_ROWS][TILE];

    float acc_r[MICRO][MICRO], acc_i[MICRO][MICRO];
    float hi_r[MICRO][MICRO], lo_r[MICRO][MICRO];
    float hi_i[MICRO][MICRO], lo_i[MICRO][MICRO];
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            hi_r[a][b] = lo_r[a][b] = hi_i[a][b] = lo_i[a][b] = 0.f;
        }
    }

    const RowLoader frows = rows.at(f);
    const float2 zero = make_float2(0.f, 0.f);

    for (int64_t g0 = 0; g0 < n_valid; g0 += GROUP_ROWS) {
        const int64_t g1 = (g0 + GROUP_ROWS < n_valid) ? g0 + GROUP_ROWS : n_valid;
#pragma unroll
        for (int a = 0; a < MICRO; ++a) {
#pragma unroll
            for (int b = 0; b < MICRO; ++b) {
                acc_r[a][b] = 0.f;
                acc_i[a][b] = 0.f;
            }
        }

        for (int64_t s0 = g0; s0 < g1; s0 += STAGE_ROWS) {
            // stage rows [s0, s0 + STAGE_ROWS) of both channel tiles;
            // rows >= g1 (hence >= n_valid) and channels >= C become zeros
            // without touching device memory
            for (int e = threadIdx.x; e < STAGE_ROWS * TILE; e += NTHREADS) {
                const int r = e / TILE;
                const int c = e % TILE;
                const int64_t n = s0 + r;
                const auto row = frows.row(n);
                const bool row_ok = n < g1;
                sa[r][c] = (row_ok && i0 + c < C) ? row[i0 + c] : zero;
                sb[r][c] = (row_ok && j0 + c < C) ? row[j0 + c] : zero;
            }
            __syncthreads();

#pragma unroll 4
            for (int r = 0; r < STAGE_ROWS; ++r) {
                float2 va[MICRO], vb[MICRO];
#pragma unroll
                for (int a = 0; a < MICRO; ++a) va[a] = sa[r][ty + THREADS_Y * a];
#pragma unroll
                for (int b = 0; b < MICRO; ++b) vb[b] = sb[r][tx + THREADS_X * b];
#pragma unroll
                for (int a = 0; a < MICRO; ++a) {
#pragma unroll
                    for (int b = 0; b < MICRO; ++b) {
                        // s_i * conj(s_j)
                        acc_r[a][b] = fmaf(va[a].x, vb[b].x, acc_r[a][b]);
                        acc_r[a][b] = fmaf(va[a].y, vb[b].y, acc_r[a][b]);
                        acc_i[a][b] = fmaf(va[a].y, vb[b].x, acc_i[a][b]);
                        acc_i[a][b] = fmaf(-va[a].x, vb[b].y, acc_i[a][b]);
                    }
                }
            }
            __syncthreads();
        }

#pragma unroll
        for (int a = 0; a < MICRO; ++a) {
#pragma unroll
            for (int b = 0; b < MICRO; ++b) {
                two_sum_into(hi_r[a][b], lo_r[a][b], acc_r[a][b]);
                two_sum_into(hi_i[a][b], lo_i[a][b], acc_i[a][b]);
            }
        }
    }

    const int64_t base = f * C * C;
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            const int64_t i = i0 + ty + THREADS_Y * a;
            const int64_t j = j0 + tx + THREADS_X * b;
            if (i >= C || j >= C || (ti == tj && i > j)) continue;
            const float re = hi_r[a][b] + lo_r[a][b];
            if (i == j) {
                // the diagonal of a Hermitian Gram is real
                out.store(base + i * C + i, re, 0.f);
            } else {
                const float im = hi_i[a][b] + lo_i[a][b];
                out.store(base + i * C + j, re, im);
                out.store(base + j * C + i, re, -im);
            }
        }
    }
}

template <class RowLoader, class OutWriter>
int launch(RowLoader rows, OutWriter out, int64_t F, int64_t C, int64_t n_valid,
           void* stream) {
    if (F == 0 || C == 0) return static_cast<int>(cudaSuccess);
    const int64_t n_tiles = (C + TILE - 1) / TILE;
    const int64_t n_pairs = n_tiles * (n_tiles + 1) / 2;
    if (F * n_pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    csd_accumulate_kernel<<<static_cast<unsigned>(F * n_pairs), NTHREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        rows, out, C, n_valid, static_cast<int>(n_tiles), static_cast<int>(n_pairs));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// complex64 (N, F, C) in, rows n < n_valid, complex64 (F, C, C) out
extern "C" int csd_accumulate_tiled_launch(const void* spec, void* out, int64_t N,
                                           int64_t F, int64_t C, int64_t n_valid,
                                           void* stream) {
    (void)N;  // rows >= n_valid are never read; the wrapper checks n_valid <= N
    return launch(InterleavedRows{static_cast<const float2*>(spec), C, F * C},
                  InterleavedOut{static_cast<float2*>(out)}, F, C, n_valid, stream);
}

// float32 (F, N, C) real and imaginary planes in, all N rows, float32
// (F, C, C) real and imaginary planes out
extern "C" int csd_accumulate_launch(const void* spec_re, const void* spec_im, void* out_re,
                                     void* out_im, int64_t F, int64_t N, int64_t C,
                                     void* stream) {
    return launch(PlanarRows{static_cast<const float*>(spec_re),
                             static_cast<const float*>(spec_im), N * C, C},
                  PlanarOut{static_cast<float*>(out_re), static_cast<float*>(out_im)},
                  F, C, N, stream);
}
