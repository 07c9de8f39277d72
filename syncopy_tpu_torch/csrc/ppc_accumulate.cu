// Pairwise phase consistency resultant for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel syncopy_tpu/ops/pallas_kernels.py::
// ppc_accumulate_tiled (body _ppc_tiled_kernel). From a complex64
// (N, K, F, C) spectrum of N trials and K tapers, read in place as float2,
// it forms for every trial n < n_valid and frequency f the taper-summed
// Gram and adds its unit phasor into the resultant:
//
//     csd_n[f, i, j] = sum_k s[n, k, f, i] * conj(s[n, k, f, j])
//     U[f, i, j]    += csd_n / |csd_n|      (0 where csd_n = 0)
//
// The 1/K taper mean cancels in the unit phasor, as on the TPU. Per-trial
// products accumulate in float32 FMA with the JAX sign convention
// (Re += ar_i ar_j + ai_i ai_j, Im += ai_i ar_j - ar_i ai_j); the
// resultant accumulates in plain float32: each term has magnitude <= 1 and
// PPC subtracts n at the end.
//
// The unit phasor, exact at every magnitude, one transcendental a term:
// (re, im) is scaled by an exact power of two s read, with one logic
// operation, off the exponent of t = (|re| + |im|) / 2 + 2^-126, which is
// normal and finite for all finite parts (add_unit). The square sum q of
// the scaled parts then lies in [2^-44, 128) for every nonzero term, so
// it can neither underflow nor overflow, and the phasor is (re s, im s) *
// rsqrt(q). rsqrt.approx.ftz.f32 has a relative error below 2^-22 on
// normal inputs, so each phasor is within ~2e-7 of unit length and U
// within ~2e-7 * n_valid of the exact sum plus float32 rounding of the
// sum: far inside the 1e-5 * n_valid bar, with no Newton step. A 2^-80
// under the square sum keeps an exact zero off the rsqrt's infinity: it
// adds 0 * 2^40 = 0. The JAX body
// squares the unscaled parts (pallas_kernels.py:228), which underflows
// below |csd| ~ 3.7e-23 and overflows above ~1.8e19: it drops every term
// of such data. Diagonal outputs use no phasor: U_ii counts the trials
// whose power (a sum of squares, >= 0) is > 0, which is n_valid + 0j on
// real spectra. The file must not be built with --use_fast_math.
//
// Trials at or past n_valid are never read; n_valid = 0 writes exact
// zeros. U is Hermitian: the block writes U[f, i, j] and its conjugate at
// (f, j, i), one writer per element, no atomics, and the order of every
// sum is fixed, so two launches are bitwise equal.
//
// Layout: one block per (frequency, 32x32 output tile pair with i-tile <=
// j-tile), the pairs of one frequency in consecutive blocks so they share
// its rows through L2. 128 threads in KSPLIT = 2 slices of 64; slice 0
// takes the first ceil(n_valid / 2) trials and slice 1 the rest, each as a
// stream of contiguous (trial, taper) rows, and each thread keeps a 4x4
// micro-tile (i = i0 + 2ty + 16h + u, j = j0 + 2tx + 16h' + v) of the
// per-trial Gram and of its slice's resultant in registers. At the end the
// slices swap the partial resultants of the micro-tile rows the other owns
// through shared memory and each writes the sum of its own rows.
//
// Staging: a ring of STAGES = 3 buffers, each holding slice_rows(K) rows of
// both slices' streams for both channel tiles, filled with cp.async while
// the block computes on an earlier buffer; one barrier per stage. A thread
// copies 16-byte chunks (2 complex values) of rows 8 apart; the src-size
// operand zero-fills channels at or past C, a chunk whose source is not
// 16-byte aligned (odd C on some rows) is copied one element at a time,
// and a chunk with no valid element (a row past the slice's trials, or
// channels all at or past C) is zeroed by a shared store, so no copy
// touches a trial at or past n_valid and NaN padding is never loaded. A
// diagonal tile pair stages its rows once and skips the micro-tile quarter
// wholly below the diagonal.
//
// Compile-time K: for K = 1..8 (K = 3 is tapsmofrq = 2 on 1 s trials, K =
// 7 the same on 2 s trials or tapsmofrq = 4 on 1 s) a stage holds whole
// trials (slice_rows = K * floor(16 / K) rows a slice), so a trial closes
// at a fixed point after its K unrolled rows and its first row multiplies
// instead of adding to a reset Gram. Every other K runs the same kernel
// with K read at run time: 16 rows a slice a stage, a trial closing where
// a row counter reaches K (a trial may span stages; the Gram lives in
// registers across them).
//
// Occupancy: 48 KB of ring a block and __launch_bounds__(128, 4): four
// blocks (16 warps) are resident on an SM, with 123-128 registers; the K
// = 4 and 5 instances spill 4 bytes. ppc_accumulate_occupancy reports what
// the runtime grants.
//
// What bounds it: at the bench chunk (N, K, F, C) = (1024, 3, 501, 64)
// with n_valid = 1000 the diagonal tiles' skipped quarter leaves 2560
// computed (i, j) terms a (trial, frequency) for 2016 off-diagonal ones,
// 1.28e9 in all, each 12 FMAs of the Gram, 10 instructions of the phasor
// (one of them MUFU, one integer) and 0.75 shared loads: ~0.9 ms of
// instruction issue at one a clock on each of the 528 schedulers. Not HBM
// (the 0.79 GB spectrum is read twice, most of it through L2: 0.24 ms)
// and not the SFU (0.3 ms). On an H100 (700 W; scripts/ppc_kernel_ab.py
// --diagnostics) the kernel takes ~1.5 ms: the Gram, loads and copies
// alone ~1.08 ms, where each thread-row loads 64 bytes from shared memory
// for 64 FMAs, as many bytes a clock as the SM's shared memory delivers
// for as many FMAs a clock as its FP32 pipes issue, so the two pipes bound
// the Gram together; the phasor adds ~0.43 ms (its exact scaling ~0.24),
// the cp.async copies ~0.23 ms (more at larger K: ~0.8 ms at K = 7) and
// the barrier nothing measurable. A fully unrolled stage ran 19% slower,
// likely from its larger body in the instruction cache.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;                  // output tile edge (channels)
constexpr int THREADS_X = 8;              // threads along j in a slice
constexpr int THREADS_Y = 8;              // threads along i in a slice
constexpr int SLICE_THREADS = THREADS_X * THREADS_Y;
constexpr int MICRO = TILE / THREADS_X;   // 4 outputs per thread per axis
constexpr int KSPLIT = 2;                 // slices, each taking half the trials
constexpr int NTHREADS = SLICE_THREADS * KSPLIT;
constexpr int SLICE_ROWS = 16;            // ring rows a slice a stage (at most)
constexpr int STAGES = 3;                 // ring buffers
constexpr int MIN_BLOCKS = 4;             // resident blocks per SM asked of ptxas
constexpr int TRIAL_UNROLL = 1;           // trials of a stage unrolled together (compile-time K)
constexpr int CHUNK_BYTES = 16;           // one cp.async
constexpr int ROW_BYTES = TILE * 8;       // one staged tile row: 32 complex values
constexpr int CHUNKS_PER_ROW = ROW_BYTES / CHUNK_BYTES;
constexpr int TILE_BYTES = KSPLIT * SLICE_ROWS * ROW_BYTES;  // one tile of a stage
constexpr int STAGE_BYTES = 2 * TILE_BYTES;
constexpr int COPY_ROW_STEP = NTHREADS / CHUNKS_PER_ROW;     // rows between a thread's chunks
constexpr int HALF = MICRO / KSPLIT;      // micro-tile rows whose sum a slice writes
// floats one slice publishes at the end: the other slice's rows, re and im
constexpr int XCH_FLOATS = 2 * HALF * MICRO * SLICE_THREADS;

static_assert(MICRO * THREADS_X == TILE && MICRO * THREADS_Y == TILE, "micro-tiles cover a tile");
static_assert(NTHREADS % CHUNKS_PER_ROW == 0, "threads cover a stage in whole rows");
static_assert(STAGES >= 2, "the ring needs a buffer in flight");
static_assert(KSPLIT == 2 && MICRO % (2 * KSPLIT) == 0, "two slices own whole pair rows");
static_assert(KSPLIT * XCH_FLOATS * 4 <= STAGE_BYTES, "the exchange fits in one stage buffer");

// rows a slice stages a stage: whole trials for a compile-time K, else 16
template <int KC>
__host__ __device__ constexpr int slice_rows() {
    return KC == 0 ? SLICE_ROWS : SLICE_ROWS / KC * KC;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void st_shared_zero16(uint32_t dst) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(dst), "r"(0) : "memory");
}

__device__ __forceinline__ void st_shared_zero8(uint32_t dst) {
    asm volatile("st.shared.v2.u32 [%0], {%1, %1};\n" :: "r"(dst), "r"(0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Copy the `elems` (1 or 2) valid complex values at `src` into the 16-byte
// chunk at `dst` and zero the rest: one 16-byte cp.async whose src-size
// zero-fills past the valid values where `src` is 16-byte aligned, else
// one 8-byte cp.async per valid value. No byte past them is read.
__device__ __forceinline__ void copy_chunk(uint32_t dst, const float2* src, int elems) {
    if ((reinterpret_cast<uintptr_t>(src) & (CHUNK_BYTES - 1)) == 0) {
        cp_async16(dst, src, elems * 8);
    } else {
        cp_async8(dst, src);
        if (elems == 2) {
            cp_async8(dst + 8, src + 1);
        } else {
            st_shared_zero8(dst + 8);
        }
    }
}

__device__ __forceinline__ float rsqrt_approx(float q) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(q));
    return r;
}

// Add the unit phasor of (re, im), or 0 where both are 0, into (ur, ui).
// t = (|re| + |im|) / 2 + 2^-126 is normal and finite for all finite
// parts; the scale s = 2^(128 - e), e the biased exponent of t, is its
// exponent field flipped (one LOP3, no MUFU) and exact, so (re s, im s)
// has the phase of (re, im), and its square sum lies in [1, 128) for t >=
// 2^-125 and in [2^-44, 128) below. The 2^-80 under the sum changes no
// nonzero q by more than 2^-36 of itself and keeps q = 0 off the rsqrt's
// infinity: a zero part adds 0 * 2^40 = 0. An inf or NaN part gives NaN.
__device__ __forceinline__ void add_unit(float re, float im, float& ur, float& ui) {
    const float t = fmaf(fabsf(re), 0.5f, fmaf(fabsf(im), 0.5f, 0x1p-126f));
    const float s = __int_as_float((__float_as_int(t) & 0x7f800000) ^ 0x7f800000);
    const float rs = re * s;
    const float is = im * s;
    const float r = rsqrt_approx(fmaf(rs, rs, fmaf(is, is, 0x1p-80f)));
    ur = fmaf(rs, r, ur);
    ui = fmaf(is, r, ui);
}

// Thread (tx, ty) owns the element pairs i = 2 ty + 2 THREADS_Y h + u and
// j = 2 tx + 2 THREADS_X h' + v (u, v in {0, 1}): micro-tile index a =
// 2 h + u along i, b = 2 h' + v along j. Every pair is one staged read.
__device__ __forceinline__ int micro_i(int ty, int a) { return 2 * ty + 2 * THREADS_Y * (a / 2) + a % 2; }
__device__ __forceinline__ int micro_j(int tx, int b) { return 2 * tx + 2 * THREADS_X * (b / 2) + b % 2; }

// On a diagonal tile, the pair block (h, h') whose least i exceeds the
// greatest j of every thread lies wholly below the diagonal
__host__ __device__ constexpr bool below_diagonal(int a, int b) {
    return 2 * THREADS_Y * (a / 2) >= 2 * THREADS_X * (b / 2 + 1);
}

// Close a trial: add the unit phasor of every computed Gram element into
// the resultant. On a diagonal tile, element (a, a) of a thread with tx ==
// ty is a diagonal output (i == j): it counts the trial if its power is > 0.
template <bool DIAG>
__device__ __forceinline__ void close_trial(bool diag_thread, const float (&g_r)[MICRO][MICRO],
                                            const float (&g_i)[MICRO][MICRO],
                                            float (&u_r)[MICRO][MICRO],
                                            float (&u_i)[MICRO][MICRO]) {
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            if (DIAG && below_diagonal(a, b)) continue;
            if (DIAG && a == b) {
                float ur = u_r[a][b];
                add_unit(g_r[a][b], g_i[a][b], ur, u_i[a][b]);
                u_r[a][b] = diag_thread ? u_r[a][b] + (g_r[a][b] > 0.f ? 1.f : 0.f) : ur;
            } else {
                add_unit(g_r[a][b], g_i[a][b], u_r[a][b], u_i[a][b]);
            }
        }
    }
}

// One staged row r into the per-trial Gram; `first` (a trial's first row,
// known at compile time) multiplies instead of adding. DIAG skips the pair
// blocks below the diagonal.
template <bool DIAG>
__device__ __forceinline__ void gram_row(const char* sa, const char* sb, int r, int tx, int ty,
                                         bool first, float (&g_r)[MICRO][MICRO],
                                         float (&g_i)[MICRO][MICRO]) {
    float2 va[MICRO], vb[MICRO];
#pragma unroll
    for (int a = 0; a < MICRO; a += 2) {
        const float4 v = *reinterpret_cast<const float4*>(sa + r * ROW_BYTES + micro_i(ty, a) * 8);
        va[a] = make_float2(v.x, v.y);
        va[a + 1] = make_float2(v.z, v.w);
    }
#pragma unroll
    for (int b = 0; b < MICRO; b += 2) {
        const float4 v = *reinterpret_cast<const float4*>(sb + r * ROW_BYTES + micro_j(tx, b) * 8);
        vb[b] = make_float2(v.x, v.y);
        vb[b + 1] = make_float2(v.z, v.w);
    }
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            if (DIAG && below_diagonal(a, b)) continue;
            // s_i * conj(s_j)
            if (first) {
                g_r[a][b] = fmaf(va[a].y, vb[b].y, va[a].x * vb[b].x);
                g_i[a][b] = fmaf(-va[a].x, vb[b].y, va[a].y * vb[b].x);
            } else {
                g_r[a][b] = fmaf(va[a].x, vb[b].x, g_r[a][b]);
                g_r[a][b] = fmaf(va[a].y, vb[b].y, g_r[a][b]);
                g_i[a][b] = fmaf(va[a].y, vb[b].x, g_i[a][b]);
                g_i[a][b] = fmaf(-va[a].x, vb[b].y, g_i[a][b]);
            }
        }
    }
}

// This slice's rows of one staged buffer into the per-trial Gram, closing
// each trial as its last row is consumed. For a compile-time K (KC > 0) a
// stage holds whole trials: the loop runs over them, TRIAL_UNROLL at a
// time, with the K rows of a trial unrolled and the close after them. For
// KC = 0 the row counter kk runs across stages and the Gram is reset at a
// close. The loops are not unrolled further: a fully unrolled stage ran
// 19% slower on an H100 (PERF.md section 6).
template <int KC, bool DIAG>
__device__ __forceinline__ void consume_stage(const char* sa, const char* sb, int tx, int ty,
                                              bool diag_thread, int64_t K, int64_t& kk,
                                              float (&g_r)[MICRO][MICRO],
                                              float (&g_i)[MICRO][MICRO],
                                              float (&u_r)[MICRO][MICRO],
                                              float (&u_i)[MICRO][MICRO]) {
    if constexpr (KC > 0) {
#pragma unroll TRIAL_UNROLL
        for (int t = 0; t < slice_rows<KC>() / KC; ++t) {
#pragma unroll
            for (int k = 0; k < KC; ++k) gram_row<DIAG>(sa, sb, t * KC + k, tx, ty, k == 0, g_r, g_i);
            close_trial<DIAG>(diag_thread, g_r, g_i, u_r, u_i);
        }
    } else {
#pragma unroll 1
        for (int r = 0; r < SLICE_ROWS; ++r) {
            gram_row<DIAG>(sa, sb, r, tx, ty, false, g_r, g_i);
            if (++kk == K) {
                kk = 0;
                close_trial<DIAG>(diag_thread, g_r, g_i, u_r, u_i);
#pragma unroll
                for (int a = 0; a < MICRO; ++a) {
#pragma unroll
                    for (int b = 0; b < MICRO; ++b) g_r[a][b] = g_i[a][b] = 0.f;
                }
            }
        }
    }
}

// At the end: publish this slice's partial resultant of the micro-tile rows
// [A0, A0 + HALF), which the other slice owns, at x ([re|im][row][col][thread])
template <int A0>
__device__ __forceinline__ void publish(float* x, int lt, const float (&u_r)[MICRO][MICRO],
                                        const float (&u_i)[MICRO][MICRO]) {
#pragma unroll
    for (int h = 0; h < HALF; ++h) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            const int o = (h * MICRO + b) * SLICE_THREADS + lt;
            x[o] = u_r[A0 + h][b];
            x[XCH_FLOATS / 2 + o] = u_i[A0 + h][b];
        }
    }
}

// At the end: add the other slice's partial resultant of the owned rows
// [A0, A0 + HALF) from x to this slice's and write the sums and their
// mirror images. The rows are a template parameter: a runtime index would
// put the resultant into local memory.
template <int A0>
__device__ __forceinline__ void write_owned(float2* out_f, const float* x, int lt, int tx, int ty,
                                            int64_t i0, int64_t j0, int64_t C, bool diag,
                                            const float (&u_r)[MICRO][MICRO],
                                            const float (&u_i)[MICRO][MICRO]) {
#pragma unroll
    for (int h = 0; h < HALF; ++h) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) {
            const int64_t i = i0 + micro_i(ty, A0 + h);
            const int64_t j = j0 + micro_j(tx, b);
            if (i >= C || j >= C || (diag && i > j)) continue;
            const int o = (h * MICRO + b) * SLICE_THREADS + lt;
            const float re = u_r[A0 + h][b] + x[o];
            if (i == j) {
                out_f[i * C + i] = make_float2(re, 0.f);
            } else {
                const float im = u_i[A0 + h][b] + x[XCH_FLOATS / 2 + o];
                out_f[i * C + j] = make_float2(re, im);
                out_f[j * C + i] = make_float2(re, -im);
            }
        }
    }
}

template <int KC>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
ppc_accumulate_kernel(const float2* __restrict__ spec, float2* __restrict__ out, int64_t K_run,
                      int64_t F, int64_t C, int64_t n_valid, int n_tiles, int n_pairs) {
    static_assert(KC >= 0 && KC <= SLICE_ROWS, "a stage holds a whole trial");
    constexpr int RS = slice_rows<KC>();
    constexpr int COPIES = (KSPLIT * RS + COPY_ROW_STEP - 1) / COPY_ROW_STEP;
    const int64_t K = KC > 0 ? KC : K_run;
    const int64_t f = blockIdx.x / n_pairs;
    int p = blockIdx.x % n_pairs;

    // tile pair p -> (ti, tj), ti <= tj, row-major over the upper triangle
    int ti = 0;
    while (p >= n_tiles - ti) {
        p -= n_tiles - ti;
        ++ti;
    }
    const int tj = ti + p;
    const bool diag = ti == tj;
    const int64_t i0 = static_cast<int64_t>(ti) * TILE;
    const int64_t j0 = static_cast<int64_t>(tj) * TILE;

    const int tid = threadIdx.x;
    const int slice = tid / SLICE_THREADS;
    const int lt = tid % SLICE_THREADS;
    const int tx = lt % THREADS_X;
    const int ty = lt / THREADS_X;
    const bool diag_thread = diag && tx == ty;

    __shared__ __align__(16) char ring[STAGES][STAGE_BYTES];

    // the two slices' row streams: slice 0 the trials [0, h), slice 1 the
    // trials [h, n_valid), each K contiguous rows a trial
    const int64_t h_trials = (n_valid + 1) / 2;
    const int64_t len0 = h_trials * K;
    const int64_t len1 = (n_valid - h_trials) * K;
    const int64_t row_stride = F * C;  // elements between rows r and r+1

    // this thread's copy plan: chunk q of the stage rows rl + COPY_ROW_STEP * c
    const int q = tid % CHUNKS_PER_ROW;
    const int rl = tid / CHUNKS_PER_ROW;
    const int64_t ca = i0 + 2 * q;
    const int64_t cb = j0 + 2 * q;
    const int elems_a = static_cast<int>(C - ca <= 0 ? 0 : (C - ca < 2 ? 1 : 2));
    const int elems_b = static_cast<int>(C - cb <= 0 ? 0 : (C - cb < 2 ? 1 : 2));
    const float2* const base = spec + f * C;
    const uint32_t ring0 = static_cast<uint32_t>(__cvta_generic_to_shared(&ring[0][0])) +
                           q * CHUNK_BYTES;

    auto issue = [&](int64_t s, int buf) {
#pragma unroll
        for (int c = 0; c < COPIES; ++c) {
            const int cr = rl + COPY_ROW_STEP * c;  // 0 .. 2 RS - 1 over both slices
            if (KSPLIT * RS % COPY_ROW_STEP != 0 && cr >= KSPLIT * RS) break;
            const int sl = cr >= RS;
            const int r = cr - sl * RS;
            const int64_t row = s * RS + r;  // in the slice's stream
            const bool row_ok = row < (sl ? len1 : len0);
            const uint32_t d = ring0 + buf * STAGE_BYTES + (sl * SLICE_ROWS + r) * ROW_BYTES;
            const float2* src = nullptr;
            if (row_ok) src = base + (sl ? len0 + row : row) * row_stride;
            if (row_ok && elems_a > 0) {
                copy_chunk(d, src + ca, elems_a);
            } else {
                st_shared_zero16(d);
            }
            if (!diag) {
                if (row_ok && elems_b > 0) {
                    copy_chunk(d + TILE_BYTES, src + cb, elems_b);
                } else {
                    st_shared_zero16(d + TILE_BYTES);
                }
            }
        }
    };

    float g_r[MICRO][MICRO], g_i[MICRO][MICRO];
    float u_r[MICRO][MICRO], u_i[MICRO][MICRO];
#pragma unroll
    for (int a = 0; a < MICRO; ++a) {
#pragma unroll
        for (int b = 0; b < MICRO; ++b) g_r[a][b] = g_i[a][b] = u_r[a][b] = u_i[a][b] = 0.f;
    }
    int64_t kk = 0;
    const int64_t n_stages = (len0 + RS - 1) / RS;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < n_stages) issue(s, s);
        cp_async_commit();
    }

    int buf = 0;
    for (int64_t s = 0; s < n_stages; ++s) {
        // stage s has landed for every thread, and every thread is done
        // with the buffer the next issue overwrites (stage s - 1's)
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        if (s + STAGES - 1 < n_stages) issue(s + STAGES - 1, buf == 0 ? STAGES - 1 : buf - 1);
        cp_async_commit();

        const char* sa = ring[buf] + slice * SLICE_ROWS * ROW_BYTES;
        if (diag) {
            consume_stage<KC, true>(sa, sa, tx, ty, diag_thread, K, kk, g_r, g_i, u_r, u_i);
        } else {
            consume_stage<KC, false>(sa, sa + TILE_BYTES, tx, ty, diag_thread, K, kk,
                                     g_r, g_i, u_r, u_i);
        }
        buf = buf + 1 == STAGES ? 0 : buf + 1;
    }
    cp_async_wait<0>();

    // the slices swap the partial resultants of each other's rows through
    // the first ring buffer and each writes the sum of the rows it owns
    float* xch = reinterpret_cast<float*>(ring[0]);
    __syncthreads();
    if (slice == 0) {
        publish<HALF>(xch, lt, u_r, u_i);
    } else {
        publish<0>(xch + XCH_FLOATS, lt, u_r, u_i);
    }
    __syncthreads();
    float2* out_f = out + f * C * C;
    if (slice == 0) {
        write_owned<0>(out_f, xch + XCH_FLOATS, lt, tx, ty, i0, j0, C, diag, u_r, u_i);
    } else {
        write_owned<HALF>(out_f, xch, lt, tx, ty, i0, j0, C, diag, u_r, u_i);
    }
}

// the instance for K: compile-time K = 1..8, else K read at run time
using KernelFn = void (*)(const float2*, float2*, int64_t, int64_t, int64_t, int64_t, int, int);

KernelFn kernel_for(int64_t K) {
    switch (K) {
        case 1: return ppc_accumulate_kernel<1>;
        case 2: return ppc_accumulate_kernel<2>;
        case 3: return ppc_accumulate_kernel<3>;
        case 4: return ppc_accumulate_kernel<4>;
        case 5: return ppc_accumulate_kernel<5>;
        case 6: return ppc_accumulate_kernel<6>;
        case 7: return ppc_accumulate_kernel<7>;
        case 8: return ppc_accumulate_kernel<8>;
        default: return ppc_accumulate_kernel<0>;
    }
}

}  // namespace

// complex64 (N, K, F, C) in, trials n < n_valid, complex64 (F, C, C) out
extern "C" int ppc_accumulate_tiled_launch(const void* spec, void* out, int64_t N,
                                           int64_t K, int64_t F, int64_t C,
                                           int64_t n_valid, void* stream) {
    (void)N;  // trials >= n_valid are never read; the wrapper checks n_valid <= N
    if (F == 0 || C == 0) return static_cast<int>(cudaSuccess);
    if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_tiles = (C + TILE - 1) / TILE;
    const int64_t n_pairs = n_tiles * (n_tiles + 1) / 2;
    if (F * n_pairs > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel_for(K)<<<static_cast<unsigned>(F * n_pairs), NTHREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(spec), static_cast<float2*>(out), K, F, C, n_valid,
        static_cast<int>(n_tiles), static_cast<int>(n_pairs));
    return static_cast<int>(cudaGetLastError());
}

// Threads per block and resident blocks per SM that the runtime grants the
// instance that runs K tapers
extern "C" int ppc_accumulate_occupancy(int64_t K, int* threads, int* blocks) {
    *threads = NTHREADS;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel_for(K), NTHREADS, 0));
}
