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
// The body is a template over the row loader (RowLoader: the asynchronous
// copy of a staged row and the read of a staged element pair, per layout)
// and the result writer (OutWriter); the arithmetic is shared.
//
// Layout: one block per (frequency, 32x32 output tile with i-tile <=
// j-tile), the tile pairs of a frequency in consecutive blocks so they
// share its rows through L2. 128 threads in KSPLIT = 2 slices of 64; each
// slice covers the whole tile, a thread a 4x4 micro-tile (i = i0 + 2ty +
// 16h + u, j = j0 + 2tx + 16h' + v, h, h', u, v in {0, 1}), and the two
// slices take the two halves of every staged block of rows.
//
// Staging: a ring of STAGES = 3 buffers in shared memory, each STAGE_ROWS
// = 32 rows of both channel tiles, filled with cp.async while the block
// computes on an earlier buffer: two stages are in flight at any time and
// one barrier per stage guards the ring. A thread copies 16-byte chunks (2
// complex or 4 planar floats; 16 consecutive threads cover a 256-byte tile
// row) of rows 8 apart, so a chunk's alignment is the same in every stage
// and is tested once per block: an aligned chunk is one 16-byte cp.async,
// another (odd C, some rows) one cp.async per element, so one code path
// serves every C and layout. The src-size operand zero-fills a chunk's part
// at or past C, and a chunk with no valid element (a row at or past n_valid
// or channels all at or past C) is zeroed by a shared store: no byte at or
// past n_valid or C is read, so NaN padding is never loaded. The per-thread
// copy addresses are computed once per block; a stage adds one offset. On a
// diagonal tile (i-tile == j-tile) the rows are staged once and both
// operands read that buffer, and the micro-tile quarter with i >= 16 > j,
// wholly below the diagonal, is skipped.
//
// Numerics: rows are taken in groups of 256 (GROUP_ROWS); inside a group
// each slice accumulates its rows in plain float32 FMA with the JAX sign
// convention (Re += ar_i ar_j + ai_i ai_j, Im += ai_i ar_j - ar_i ai_j).
// After each group the two slices swap, through the stage buffer they just
// read, the partials of the micro-tile rows the other owns; each adds the
// two (one float addition, commutative, so both slices form the same group
// partial) and folds the sum into its own (hi, lo) registers by TwoSum,
// written with __fadd_rn/__fsub_rn so the compiler can neither contract
// nor reorder it; the folds run in parallel. The file must not be built
// with --use_fast_math; no TF32 and no tensor cores. n_valid = 0 writes
// exact zeros; the output is exactly Hermitian with a real diagonal. Every
// output element has one writer (the slice that owns it) and the order of
// every sum is fixed: no atomics, two launches are bitwise equal.
//
// Occupancy: 48 KB of ring per block and __launch_bounds__(128, 4), so
// four blocks (16 warps) are resident on an SM, with 127 registers (128
// planar) and no spills; csd_accumulate_occupancy reports what the runtime
// grants.
//
// What bounds it: the useful work is 8*F*n*C(C+1)/2 FP32 operations (the
// upper triangle; 25.0 GFLOP at F = 501, n = 3000, C = 64, 0.373 ms at the
// 67 TFLOP/s FP32 peak) against 0.79 GB of input and output (0.235 ms at
// 3.35 TB/s), so the FP32 pipes, not HBM. At C = 64 the kernel computes
// 1.23x the useful work (30.8 GFLOP: the diagonal tiles' kept part below
// the diagonal) and issues 4 shared loads per 64 FMAs (8 for the planar
// layout). On an H100 (700 W, SM clock ~1.96 GHz under this kernel),
// builds that leave parts out (scripts/csd_kernel_ab.py --diagnostics)
// put the FMAs, folds and stores alone at ~70% of the FP32 pipe; the staged
// loads and, more, the cp.async copies sharing the load/store path with
// them take the rest: the load/store pipe, not the wait for memory (a
// fourth stage or a second buffer fewer change nothing).

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 32;                // output tile edge (channels)
constexpr int THREADS_X = 8;            // threads along j in a slice
constexpr int THREADS_Y = 8;            // threads along i in a slice
constexpr int SLICE_THREADS = THREADS_X * THREADS_Y;
constexpr int MICRO_I = TILE / THREADS_Y;  // outputs per thread along i
constexpr int MICRO_J = TILE / THREADS_X;  // outputs per thread along j
constexpr int KSPLIT = 2;               // slices splitting each stage's rows
constexpr int NTHREADS = SLICE_THREADS * KSPLIT;
constexpr int STAGE_ROWS = 32;          // rows per ring buffer
constexpr int STAGES = 3;               // ring buffers
constexpr int MIN_BLOCKS = 4;           // resident blocks per SM asked of ptxas
constexpr int GROUP_ROWS = 256;         // TwoSum group (the TPU kernel's row_block)
constexpr int ROWS_PER_SLICE = STAGE_ROWS / KSPLIT;
constexpr int STAGES_PER_GROUP = GROUP_ROWS / STAGE_ROWS;
constexpr int CHUNK_BYTES = 16;         // one cp.async
constexpr int ROW_BYTES = TILE * 8;     // one staged tile row: 32 complex values
constexpr int CHUNKS_PER_ROW = ROW_BYTES / CHUNK_BYTES;
constexpr int TILE_STAGE_BYTES = STAGE_ROWS * ROW_BYTES;
constexpr int COPY_ROW_STEP = NTHREADS / CHUNKS_PER_ROW;  // rows between a thread's chunks
constexpr int COPIES = STAGE_ROWS / COPY_ROW_STEP;        // chunks per thread, tile and stage
constexpr int HALF = MICRO_I / KSPLIT;  // micro-tile rows whose (hi, lo) a slice owns
// floats one slice publishes per group: the other slice's rows, re and im
constexpr int XCH_FLOATS = 2 * HALF * MICRO_J * SLICE_THREADS;

static_assert(MICRO_I * THREADS_Y == TILE && MICRO_J * THREADS_X == TILE &&
              MICRO_I % 2 == 0 && MICRO_J % 2 == 0, "micro-tiles of element pairs cover a tile");
static_assert(GROUP_ROWS % STAGE_ROWS == 0, "stages must tile a group");
static_assert(STAGE_ROWS % KSPLIT == 0, "slices split a stage evenly");
static_assert(NTHREADS % CHUNKS_PER_ROW == 0 && STAGE_ROWS % COPY_ROW_STEP == 0,
              "threads cover a stage in whole rows");
static_assert(STAGES >= 2, "the ring needs a buffer in flight");
static_assert(COPY_ROW_STEP * 4 % CHUNK_BYTES == 0,
              "a thread's rows keep one 16-byte alignment (elements are 4 or 8 bytes)");
static_assert(KSPLIT == 2 && MICRO_I % (2 * KSPLIT) == 0, "two slices own whole pair rows");
static_assert(KSPLIT * XCH_FLOATS * 4 <= 2 * TILE_STAGE_BYTES,
              "the exchange fits in one stage buffer");

// A row loader stages 256-byte tile rows as 16 chunks of 16 bytes:
// chunk q holds SUB elements of SUB_BYTES each, from channel
// chunk_channel(q) of the tile on. addr(f, n, c, q) is the global address
// of chunk q's first element (channel c) in row n of frequency f;
// row_bytes() is the distance between rows; pair(tile, r, c) reads the
// staged channels c, c + 1 (c even) of row r as (re_c, im_c, re_c1,
// im_c1). The kernel computes the addresses once per block, so the
// staging loop does no per-element index arithmetic (a loader that
// computed (n * F + f) * C + c per element was 1.3x slower on an H100).

// complex64 (N, F, C), interleaved (re, im): a staged row is the tile's 32
// values as float2
struct InterleavedRows {
    const float2* spec;
    int64_t freq_stride;  // C
    int64_t row_stride;   // F * C
    static constexpr int SUB = 2;
    static constexpr int SUB_BYTES = 8;
    __device__ __forceinline__ static int chunk_channel(int q) { return SUB * q; }
    __device__ __forceinline__ const char* addr(int64_t f, int64_t n, int64_t c, int) const {
        return reinterpret_cast<const char*>(spec + (n * row_stride + f * freq_stride + c));
    }
    __device__ __forceinline__ int64_t row_bytes() const { return row_stride * 8; }
    __device__ __forceinline__ static float4 pair(const char* tile, int r, int c) {
        return *reinterpret_cast<const float4*>(tile + r * ROW_BYTES + c * 8);
    }
};

// two float32 (F, N, C) planes: a staged row is 32 real parts, then 32
// imaginary parts
struct PlanarRows {
    const float* re;
    const float* im;
    int64_t freq_stride;  // N * C
    int64_t row_stride;   // C
    static constexpr int SUB = 4;
    static constexpr int SUB_BYTES = 4;
    __device__ __forceinline__ static int chunk_channel(int q) {
        return SUB * (q % (CHUNKS_PER_ROW / 2));
    }
    __device__ __forceinline__ const char* addr(int64_t f, int64_t n, int64_t c, int q) const {
        const float* plane = q < CHUNKS_PER_ROW / 2 ? re : im;
        return reinterpret_cast<const char*>(plane + (f * freq_stride + n * row_stride + c));
    }
    __device__ __forceinline__ int64_t row_bytes() const { return row_stride * 4; }
    __device__ __forceinline__ static float4 pair(const char* tile, int r, int c) {
        const float2 a = *reinterpret_cast<const float2*>(tile + r * ROW_BYTES + c * 4);
        const float2 b = *reinterpret_cast<const float2*>(tile + r * ROW_BYTES + TILE * 4 + c * 4);
        return make_float4(a.x, b.x, a.y, b.y);
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(uint32_t dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 :: "r"(dst), "l"(src), "n"(BYTES) : "memory");
}

// zeros into BYTES (4, 8 or 16) of shared memory, reading no device memory
template <int BYTES>
__device__ __forceinline__ void st_shared_zero(uint32_t dst) {
    if constexpr (BYTES == 16) {
        asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" :: "r"(dst), "r"(0) : "memory");
    } else if constexpr (BYTES == 8) {
        asm volatile("st.shared.v2.u32 [%0], {%1, %1};\n" :: "r"(dst), "r"(0) : "memory");
    } else {
        static_assert(BYTES == 4, "4, 8 or 16 bytes");
        asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(dst), "r"(0) : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

// Copy one chunk of `elems` valid elements (0..SUB) into shared memory at
// `dst` and zero the rest. An `aligned` chunk is one 16-byte cp.async whose
// src-size operand zero-fills past the valid elements; otherwise each valid
// element is its own cp.async. No byte at or past the valid elements is
// read, and a chunk with none is zeroed by a plain shared store.
template <class RowLoader>
__device__ __forceinline__ void copy_chunk(uint32_t dst, const char* src, int elems,
                                           bool aligned) {
    constexpr int SB = RowLoader::SUB_BYTES;
    if (elems == 0) {
        st_shared_zero<CHUNK_BYTES>(dst);
    } else if (aligned) {
        cp_async16(dst, src, elems * SB);
    } else {
#pragma unroll
        for (int u = 0; u < RowLoader::SUB; ++u) {
            if (u < elems) {
                cp_async_small<SB>(dst + u * SB, src + u * SB);
            } else {
                st_shared_zero<SB>(dst + u * SB);
            }
        }
    }
}

__device__ __forceinline__ void two_sum_into(float& hi, float& lo, float p) {
    // Knuth TwoSum: s + e == hi + p exactly; e folds into lo
    float s = __fadd_rn(hi, p);
    float bb = __fsub_rn(s, hi);
    float e = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)), __fsub_rn(p, bb));
    hi = s;
    lo = __fadd_rn(lo, e);
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

// This slice's rows of one staged buffer into the thread's micro-tile.
// DIAG skips the pair blocks below the diagonal.
template <class RowLoader, bool DIAG>
__device__ __forceinline__ void accumulate_stage(const char* sa, const char* sb, int slice,
                                                 int tx, int ty,
                                                 float (&acc_r)[MICRO_I][MICRO_J],
                                                 float (&acc_i)[MICRO_I][MICRO_J]) {
#pragma unroll
    for (int k = 0; k < ROWS_PER_SLICE; ++k) {
        const int r = slice * ROWS_PER_SLICE + k;
        float2 va[MICRO_I], vb[MICRO_J];
#pragma unroll
        for (int a = 0; a < MICRO_I; a += 2) {
            const float4 v = RowLoader::pair(sa, r, micro_i(ty, a));
            va[a] = make_float2(v.x, v.y);
            va[a + 1] = make_float2(v.z, v.w);
        }
#pragma unroll
        for (int b = 0; b < MICRO_J; b += 2) {
            const float4 v = RowLoader::pair(sb, r, micro_j(tx, b));
            vb[b] = make_float2(v.x, v.y);
            vb[b + 1] = make_float2(v.z, v.w);
        }
#pragma unroll
        for (int a = 0; a < MICRO_I; ++a) {
#pragma unroll
            for (int b = 0; b < MICRO_J; ++b) {
                if (DIAG && below_diagonal(a, b)) continue;
                // s_i * conj(s_j)
                acc_r[a][b] = fmaf(va[a].x, vb[b].x, acc_r[a][b]);
                acc_r[a][b] = fmaf(va[a].y, vb[b].y, acc_r[a][b]);
                acc_i[a][b] = fmaf(va[a].y, vb[b].x, acc_i[a][b]);
                acc_i[a][b] = fmaf(-va[a].x, vb[b].y, acc_i[a][b]);
            }
        }
    }
}

// Group end, step 1: publish this slice's partials of the rows
// [A0, A0 + HALF), which the other slice owns, at x ([re|im][row][col][thread])
template <int A0>
__device__ __forceinline__ void publish(float* x, int lt, const float (&acc_r)[MICRO_I][MICRO_J],
                                        const float (&acc_i)[MICRO_I][MICRO_J]) {
#pragma unroll
    for (int h = 0; h < HALF; ++h) {
#pragma unroll
        for (int b = 0; b < MICRO_J; ++b) {
            const int o = (h * MICRO_J + b) * SLICE_THREADS + lt;
            x[o] = acc_r[A0 + h][b];
            x[XCH_FLOATS / 2 + o] = acc_i[A0 + h][b];
        }
    }
}

// Group end, step 2: add the other slice's partials of the owned rows
// [A0, A0 + HALF) from x to this slice's (float addition of two terms is
// commutative, so both slices form the same group partial) and fold the
// sum into (hi, lo) by TwoSum
template <int A0>
__device__ __forceinline__ void fold_owned(const float* x, int lt,
                                           const float (&acc_r)[MICRO_I][MICRO_J],
                                           const float (&acc_i)[MICRO_I][MICRO_J],
                                           float (&hi_r)[HALF][MICRO_J], float (&lo_r)[HALF][MICRO_J],
                                           float (&hi_i)[HALF][MICRO_J], float (&lo_i)[HALF][MICRO_J]) {
#pragma unroll
    for (int h = 0; h < HALF; ++h) {
#pragma unroll
        for (int b = 0; b < MICRO_J; ++b) {
            const int o = (h * MICRO_J + b) * SLICE_THREADS + lt;
            two_sum_into(hi_r[h][b], lo_r[h][b], acc_r[A0 + h][b] + x[o]);
            two_sum_into(hi_i[h][b], lo_i[h][b], acc_i[A0 + h][b] + x[XCH_FLOATS / 2 + o]);
        }
    }
}

template <class RowLoader, class OutWriter>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
csd_accumulate_kernel(RowLoader rows, OutWriter out, int64_t C, int64_t n_valid,
                      int n_tiles, int n_pairs) {
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

    __shared__ __align__(16) char ring[STAGES][2][TILE_STAGE_BYTES];

    // this thread's copy plan: chunk q of rows r_first + COPY_ROW_STEP * k
    const int q = tid % CHUNKS_PER_ROW;
    const int r_first = tid / CHUNKS_PER_ROW;
    const int64_t ca = i0 + RowLoader::chunk_channel(q);
    const int64_t cb = j0 + RowLoader::chunk_channel(q);
    const int64_t sub = RowLoader::SUB;
    const int elems_a = static_cast<int>(C - ca < 0 ? 0 : (C - ca < sub ? C - ca : sub));
    const int elems_b = static_cast<int>(C - cb < 0 ? 0 : (C - cb < sub ? C - cb : sub));
    const char* const src_a = rows.addr(f, r_first, ca, q);
    const char* const src_b = rows.addr(f, r_first, cb, q);
    // the rows a thread copies lie COPY_ROW_STEP rows apart, a multiple of
    // 16 bytes in every layout, so a chunk's alignment is the same in every
    // stage: tested once here
    const bool aligned_a = (reinterpret_cast<uintptr_t>(src_a) & (CHUNK_BYTES - 1)) == 0;
    const bool aligned_b = (reinterpret_cast<uintptr_t>(src_b) & (CHUNK_BYTES - 1)) == 0;
    const int64_t copy_step = COPY_ROW_STEP * rows.row_bytes();
    const int64_t stage_bytes = STAGE_ROWS * rows.row_bytes();
    const uint32_t dst_first = static_cast<uint32_t>(__cvta_generic_to_shared(&ring[0][0][0])) +
                               r_first * ROW_BYTES + q * CHUNK_BYTES;

    auto issue = [&](int64_t s, int buf) {
        const int64_t n = s * STAGE_ROWS + r_first;
        const int64_t off = s * stage_bytes;
        const uint32_t dst = dst_first + buf * 2 * TILE_STAGE_BYTES;
#pragma unroll
        for (int k = 0; k < COPIES; ++k) {
            const bool row_ok = n + k * COPY_ROW_STEP < n_valid;
            const uint32_t d = dst + k * COPY_ROW_STEP * ROW_BYTES;
            copy_chunk<RowLoader>(d, src_a + off + k * copy_step, row_ok ? elems_a : 0,
                                  aligned_a);
            if (!diag) {
                copy_chunk<RowLoader>(d + TILE_STAGE_BYTES, src_b + off + k * copy_step,
                                      row_ok ? elems_b : 0, aligned_b);
            }
        }
    };

    float acc_r[MICRO_I][MICRO_J], acc_i[MICRO_I][MICRO_J];
    // (hi, lo) of the HALF micro-tile rows this slice owns
    float hi_r[HALF][MICRO_J], lo_r[HALF][MICRO_J], hi_i[HALF][MICRO_J], lo_i[HALF][MICRO_J];
#pragma unroll
    for (int h = 0; h < HALF; ++h) {
#pragma unroll
        for (int b = 0; b < MICRO_J; ++b) hi_r[h][b] = lo_r[h][b] = hi_i[h][b] = lo_i[h][b] = 0.f;
    }
    const int64_t n_stages = (n_valid + STAGE_ROWS - 1) / STAGE_ROWS;

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

        if (s % STAGES_PER_GROUP == 0) {
#pragma unroll
            for (int a = 0; a < MICRO_I; ++a) {
#pragma unroll
                for (int b = 0; b < MICRO_J; ++b) acc_r[a][b] = acc_i[a][b] = 0.f;
            }
        }
        const char* sa = ring[buf][0];
        if (diag) {
            accumulate_stage<RowLoader, true>(sa, sa, slice, tx, ty, acc_r, acc_i);
        } else {
            accumulate_stage<RowLoader, false>(sa, ring[buf][1], slice, tx, ty, acc_r, acc_i);
        }

        if ((s + 1) % STAGES_PER_GROUP == 0 || s + 1 == n_stages) {
            // group end: the slices swap the partials of each other's rows
            // through this stage's buffer, which no copy targets before the
            // next iteration's barrier, and fold in parallel
            float* xch = reinterpret_cast<float*>(ring[buf][0]);
            __syncthreads();
            if (slice == 0) {
                publish<HALF>(xch, lt, acc_r, acc_i);
            } else {
                publish<0>(xch + XCH_FLOATS, lt, acc_r, acc_i);
            }
            __syncthreads();
            if (slice == 0) {
                fold_owned<0>(xch + XCH_FLOATS, lt, acc_r, acc_i, hi_r, lo_r, hi_i, lo_i);
            } else {
                fold_owned<HALF>(xch, lt, acc_r, acc_i, hi_r, lo_r, hi_i, lo_i);
            }
        }
        buf = buf + 1 == STAGES ? 0 : buf + 1;
    }
    cp_async_wait<0>();

    // each slice writes the rows it owns
    const int64_t base = f * C * C;
#pragma unroll
    for (int h = 0; h < HALF; ++h) {
#pragma unroll
        for (int b = 0; b < MICRO_J; ++b) {
            const int64_t i = i0 + micro_i(ty, slice * HALF + h);
            const int64_t j = j0 + micro_j(tx, b);
            if (i >= C || j >= C || (diag && i > j)) continue;
            const float re = hi_r[h][b] + lo_r[h][b];
            if (i == j) {
                // the diagonal of a Hermitian Gram is real
                out.store(base + i * C + i, re, 0.f);
            } else {
                const float im = hi_i[h][b] + lo_i[h][b];
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

// Threads per block and resident blocks per SM that the runtime grants the
// interleaved (planar = 0) or planar (planar = 1) instance
extern "C" int csd_accumulate_occupancy(int planar, int* threads, int* blocks) {
    *threads = NTHREADS;
    if (planar) {
        return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, csd_accumulate_kernel<PlanarRows, PlanarOut>, NTHREADS, 0));
    }
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, csd_accumulate_kernel<InterleavedRows, InterleavedOut>, NTHREADS, 0));
}
