// Pairwise phase consistency resultant for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel syncopy_tpu/ops/pallas_kernels.py::
// ppc_accumulate_tiled (body _ppc_tiled_kernel). From a complex64
// (N, K, F, C) spectrum of N trials and K tapers, read in place as float2,
// it forms for every trial n < n_valid and frequency f the taper-summed
// Gram and adds its unit phasor into the resultant:
//
//     csd_n[f, i, j] = sum_k s[n, k, f, i] * conj(s[n, k, f, j])
//     mag            = sqrtf(re * re + im * im)
//     U[f, i, j]    += mag > 0 ? csd_n * (1 / max(mag, 1e-37)) : 0
//
// The 1/K taper mean cancels in the unit phasor, as on the TPU. Per-trial
// products accumulate in float32 FMA with the JAX sign convention
// (Re += ar_i ar_j + ai_i ai_j, Im += ai_i ar_j - ar_i ai_j); the
// resultant accumulates in plain float32, as on the TPU: each term has
// magnitude <= 1 and PPC subtracts n at the end. sqrtf and the reciprocal
// are IEEE (the file must not be built with --use_fast_math; no rsqrtf,
// no __fdividef), so zero-magnitude and tiny bins behave as in the JAX
// formula. On the diagonal the per-trial imaginary part is 0 in exact
// arithmetic; FMA contraction can leave one rounding of residue, so it is
// taken as 0 there.
//
// Trials at or past n_valid are never read (the TPU kernel's input
// where-mask keeps NaN padding out the same way); n_valid = 0 writes exact
// zeros. U is Hermitian: the block writes U[f, i, j] and its conjugate at
// (f, j, i), one writer per element, no atomics.
//
// Layout: one block per (frequency, 32x32 output tile pair with i-tile <=
// j-tile), the pairs of one frequency in consecutive blocks so they share
// its rows through L2. The TPU's sequential trial-group grid axis becomes
// an in-block loop. For a fixed f the rows (n, k) lie F*C elements apart
// in n*K + k order, so the block walks the flat row index r = n*K + k
// < n_valid*K, staging STAGE_ROWS rows of both channel tiles at a time in
// shared memory (a stage may split a trial); when r closes a trial
// (r % K == K - 1) the per-trial Gram in registers is normalized into the
// running U, also in registers, and reset. 64 threads, each with a 4x4
// micro-tile of both. Rows of the last stage past n_valid*K are staged as
// zeros; they form all-zero "trials" whose magnitude is 0, so they add
// nothing. Any C >= 1 and K >= 1.
//
// What bounds it (an estimate from shapes): at the bench chunk
// (N, K, F, C) = (1024, 3, 501, 64) with n_valid = 1000 there are about
// 1.04e9 upper-triangle (n, f, i, j) terms (the i <= j tiles compute
// 1.5e9 at C = 64). Each costs ~12 FMAs for the K = 3 Gram, the
// magnitude, a square root and a division, so the FP32 and SFU pipes
// bound it, not HBM: the 0.79 GB spectrum is read once per tile pair,
// three times in all, most of it through L2.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;          // output tile edge (channels)
constexpr int THREADS_X = 8;      // threads along j
constexpr int THREADS_Y = 8;      // threads along i
constexpr int MICRO = TILE / THREADS_X;  // 4 outputs per thread per axis
constexpr int STAGE_ROWS = 32;    // (trial, taper) rows staged at a time
constexpr int NTHREADS = THREADS_X * THREADS_Y;

__global__ void __launch_bounds__(NTHREADS)
ppc_accumulate_kernel(const float2* __restrict__ spec, float2* __restrict__ out,
                      int64_t K, int64_t F, int64_t C, int64_t n_valid, int n_tiles,
                      int n_pairs) {
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

    // per-trial Gram and running resultant
    float g_r[MICRO][MICRO], g_i[MICRO][MICRO];
    float u_r[MICRO][MICRO], u_i[MICRO][MICRO];
    bool diag[MICRO][MICRO];
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            g_r[a][b] = g_i[a][b] = u_r[a][b] = u_i[a][b] = 0.f;
            diag[a][b] = (i0 + ty + THREADS_Y * a) == (j0 + tx + THREADS_X * b);
        }
    }

    const int64_t row_stride = F * C;  // elements between rows r and r+1
    const int64_t n_rows = n_valid * K;
    const float2* base = spec + f * C;
    const float2 zero = make_float2(0.f, 0.f);
    int64_t k = 0;  // taper index of the next row

    for (int64_t s0 = 0; s0 < n_rows; s0 += STAGE_ROWS) {
        // stage rows [s0, s0 + STAGE_ROWS) of both channel tiles; rows
        // >= n_rows (trials >= n_valid) and channels >= C become zeros
        // without touching device memory
        for (int e = threadIdx.x; e < STAGE_ROWS * TILE; e += NTHREADS) {
            const int r = e / TILE;
            const int c = e % TILE;
            const int64_t row = s0 + r;
            const float2* src = base + row * row_stride;
            const bool row_ok = row < n_rows;
            sa[r][c] = (row_ok && i0 + c < C) ? src[i0 + c] : zero;
            sb[r][c] = (row_ok && j0 + c < C) ? src[j0 + c] : zero;
        }
        __syncthreads();

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
                    g_r[a][b] = fmaf(va[a].x, vb[b].x, g_r[a][b]);
                    g_r[a][b] = fmaf(va[a].y, vb[b].y, g_r[a][b]);
                    g_i[a][b] = fmaf(va[a].y, vb[b].x, g_i[a][b]);
                    g_i[a][b] = fmaf(-va[a].x, vb[b].y, g_i[a][b]);
                }
            }
            if (++k == K) {
                // the row closed a trial: add its unit phasor, start the next
                k = 0;
#pragma unroll
                for (int a = 0; a < MICRO; ++a) {
#pragma unroll
                    for (int b = 0; b < MICRO; ++b) {
                        const float re = g_r[a][b];
                        const float im = diag[a][b] ? 0.f : g_i[a][b];
                        const float mag = sqrtf(re * re + im * im);
                        const float scale = mag > 0.f ? 1.f / fmaxf(mag, 1e-37f) : 0.f;
                        u_r[a][b] += re * scale;
                        u_i[a][b] += im * scale;
                        g_r[a][b] = 0.f;
                        g_i[a][b] = 0.f;
                    }
                }
            }
        }
        __syncthreads();
    }

    float2* out_f = out + f * C * C;
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            const int64_t i = i0 + ty + THREADS_Y * a;
            const int64_t j = j0 + tx + THREADS_X * b;
            if (i >= C || j >= C || (ti == tj && i > j)) continue;
            if (i == j) {
                out_f[i * C + i] = make_float2(u_r[a][b], 0.f);
            } else {
                out_f[i * C + j] = make_float2(u_r[a][b], u_i[a][b]);
                out_f[j * C + i] = make_float2(u_r[a][b], -u_i[a][b]);
            }
        }
    }
}

}  // namespace

// complex64 (N, K, F, C) in, trials n < n_valid, complex64 (F, C, C) out
extern "C" int ppc_accumulate_tiled_launch(const void* spec, void* out, int64_t N,
                                           int64_t K, int64_t F, int64_t C,
                                           int64_t n_valid, void* stream) {
    (void)N;  // trials >= n_valid are never read; the wrapper checks n_valid <= N
    if (F == 0 || C == 0) return static_cast<int>(cudaSuccess);
    const int64_t n_tiles = (C + TILE - 1) / TILE;
    const int64_t n_pairs = n_tiles * (n_tiles + 1) / 2;
    if (F * n_pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ppc_accumulate_kernel<<<static_cast<unsigned>(F * n_pairs), NTHREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(spec), static_cast<float2*>(out), K, F, C, n_valid,
        static_cast<int>(n_tiles), static_cast<int>(n_pairs));
    return static_cast<int>(cudaGetLastError());
}
