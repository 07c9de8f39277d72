// Butterworth biquad cascade (scipy's sosfilt and sosfiltfilt) for Hopper
// (sm_90a).
//
// Replaces syncopy_tpu/ops/filtering.py::_biquad, sosfilt and sosfiltfilt
// (:181-258), which run the recurrence as a lax.associative_scan over 2x2
// affine state maps: plain XLA, no Pallas kernel, and no PyTorch call
// computes an IIR recurrence. Data float32 (N, T, C), channels last as the
// engine's batch is; second-order sections float64 (S, 6) as scipy's
// butter(..., output="sos") gives them; output float32 (N, T, C).
//
// Section s maps its input w to y in direct form I, in float64:
//
//     y[n] = ((b0 w[n] + b1 w[n-1]) + b2 w[n-2] - a1 y[n-1]) - a2 y[n-2]
//
// and y is the input of section s + 1. The histories before the first
// sample are primed with a constant x0 (the steady state of every section
// for a constant input x0, as the JAX package's _biquad does): w[-1] =
// w[-2] = x0_s, y[-1] = y[-2] = x0_s (b0 + b1 + b2) / (1 + a1 + a2), which
// is x0_{s+1}. twopass (sosfiltfilt, one launch): the odd extension of
// padlen samples at both ends, read by index arithmetic (no extended copy),
// the forward cascade primed with its first sample into a float64 scratch
// (N, T + 2 padlen, C), then the backward cascade over the scratch primed
// with the forward output's last sample, of which only the cropped window
// [padlen, padlen + T) is written, rounded once to float32. onepass
// (sosfilt): the forward cascade primed with x[0] * 0, so a NaN first
// sample stays NaN.
//
// Every product and sum is rounded on its own (__dmul_rn, __dadd_rn,
// __dsub_rn: no contraction into FMAs), in the order above, so the plain
// PyTorch version in ops/iir_kernels.py, which evaluates the same
// expressions one tensor operation at a time, gives the same bits.
//
// Layout: one thread per (trial, channel) sequence, neighbouring threads on
// neighbouring channels, so every step's load and store of a warp is one
// coalesced 128-byte line at C >= 32. The whole cascade (all S sections)
// runs per sample in registers: 2 (S + 1) float64 histories, the
// coefficients in shared memory (broadcast reads). The time loop loads
// UNROLL samples before it runs their recurrence, which does not depend on
// them. S = 1..8 are compile-time instances (orders up to 8 band-pass and
// 16 low-pass); any other S up to MAX_SECTIONS runs the run-time instance,
// whose histories live in local memory.
//
// Bound on the H100 at the main-path shape (1000, 1000, 64), S = 4, padlen
// 27: the function moves 256 MB in and 256 MB out, ~0.15 ms at 3.35 TB/s;
// this design also writes and reads its 540 MB scratch, ~0.48 ms in all.
// Its 9 FP64 operations per sample and section are issued one by one, and
// only N x C = 64,000 threads (~15 warps an SM) hide the latency of the
// serial chain: see PERF.md section 6 for the measured time. A one-trial
// recording gives C threads and a long serial chain; a time-split scan is
// the cure, not taken here. Two launches are bitwise equal: each thread's
// arithmetic is fixed and no sum crosses threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
constexpr int UNROLL = 8;
constexpr int MAX_SECTIONS = 64;
// per section in shared memory: b0, b1, b2, a1, a2, b0 + b1 + b2, 1 + a1 + a2
constexpr int NCOEF = 7;

struct Coef {
    double b0, b1, b2, a1, a2, bsum, asum;
};

__device__ __forceinline__ Coef coef_at(const double* c, int s) {
    const double* p = c + NCOEF * s;
    return Coef{p[0], p[1], p[2], p[3], p[4], p[5], p[6]};
}

// histories h1[s] = w_s[n-1], h2[s] = w_s[n-2] of the section boundaries
// s = 0..S: w_0 is the input, w_S the output, w_{s+1} = y of section s
template <int S>
struct Cascade {
    static constexpr int NH = (S > 0 ? S : MAX_SECTIONS) + 1;
    double h1[NH], h2[NH];

    __device__ __forceinline__ void prime(const double* coef, int ns, double x0) {
        double h = x0;
        if constexpr (S > 0) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
                const Coef k = coef_at(coef, s);
                h1[s] = h;
                h2[s] = h;
                h = __ddiv_rn(__dmul_rn(h, k.bsum), k.asum);
            }
            h1[S] = h;
            h2[S] = h;
        } else {
            for (int s = 0; s < ns; ++s) {
                const Coef k = coef_at(coef, s);
                h1[s] = h;
                h2[s] = h;
                h = __ddiv_rn(__dmul_rn(h, k.bsum), k.asum);
            }
            h1[ns] = h;
            h2[ns] = h;
        }
    }

    __device__ __forceinline__ double section(const double* coef, int s, double w) {
        const Coef k = coef_at(coef, s);
        const double u = __dadd_rn(__dadd_rn(__dmul_rn(k.b0, w), __dmul_rn(k.b1, h1[s])),
                                   __dmul_rn(k.b2, h2[s]));
        const double y = __dsub_rn(__dsub_rn(u, __dmul_rn(k.a1, h1[s + 1])),
                                   __dmul_rn(k.a2, h2[s + 1]));
        h2[s] = h1[s];
        h1[s] = w;
        return y;
    }

    __device__ __forceinline__ double step(const double* coef, int ns, double w) {
        if constexpr (S > 0) {
#pragma unroll
            for (int s = 0; s < S; ++s) w = section(coef, s, w);
            h2[S] = h1[S];
            h1[S] = w;
        } else {
            for (int s = 0; s < ns; ++s) w = section(coef, s, w);
            h2[ns] = h1[ns];
            h1[ns] = w;
        }
        return w;
    }
};

// sample e of the odd extension of one sequence (stride C) by `pad`
// samples at both ends: 2 x[0] - x[pad - e] before, 2 x[T-1] - x[2T - 2 -
// (e - pad)] after
__device__ __forceinline__ double extended(const float* xs, int64_t C, int64_t T, int64_t pad,
                                           double x_first, double x_last, int64_t e) {
    if (e < pad) return __dsub_rn(2.0 * x_first, static_cast<double>(xs[(pad - e) * C]));
    const int64_t t = e - pad;
    if (t < T) return static_cast<double>(xs[t * C]);
    return __dsub_rn(2.0 * x_last, static_cast<double>(xs[(2 * T - 2 - t) * C]));
}

template <int S, bool TWOPASS>
__global__ void __launch_bounds__(NTHREADS)
sosfilt_kernel(const float* __restrict__ x, const double* __restrict__ sos,
               double* __restrict__ scratch, float* __restrict__ out, int64_t N, int64_t T,
               int64_t C, int ns, int64_t pad) {
    __shared__ double coef[NCOEF * MAX_SECTIONS];
    for (int i = threadIdx.x; i < ns; i += blockDim.x) {
        const double* r = sos + 6 * i;
        double* c = coef + NCOEF * i;
        c[0] = r[0];
        c[1] = r[1];
        c[2] = r[2];
        c[3] = r[4];
        c[4] = r[5];
        c[5] = __dadd_rn(__dadd_rn(r[0], r[1]), r[2]);
        c[6] = __dadd_rn(__dadd_rn(1.0, r[4]), r[5]);
    }
    __syncthreads();

    const int64_t g = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x;
    if (g >= N * C) return;
    const int64_t n = g / C, c = g - n * C;
    const float* xs = x + n * T * C + c;
    Cascade<S> cas;

    if (!TWOPASS) {
        float* os = out + n * T * C + c;
        const double x0 = static_cast<double>(xs[0]);
        cas.prime(coef, ns, __dmul_rn(x0, 0.0));
        for (int64_t t0 = 0; t0 < T; t0 += UNROLL) {
            double v[UNROLL];
#pragma unroll
            for (int k = 0; k < UNROLL; ++k)
                v[k] = t0 + k < T ? static_cast<double>(xs[(t0 + k) * C]) : 0.0;
#pragma unroll
            for (int k = 0; k < UNROLL; ++k)
                if (t0 + k < T) os[(t0 + k) * C] = __double2float_rn(cas.step(coef, ns, v[k]));
        }
        return;
    }

    const int64_t E = T + 2 * pad;
    double* ys = scratch + n * E * C + c;
    const double x_first = static_cast<double>(xs[0]);
    const double x_last = static_cast<double>(xs[(T - 1) * C]);

    // forward cascade over the extended sequence into the scratch
    cas.prime(coef, ns, extended(xs, C, T, pad, x_first, x_last, 0));
    for (int64_t e0 = 0; e0 < E; e0 += UNROLL) {
        double v[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
            v[k] = e0 + k < E ? extended(xs, C, T, pad, x_first, x_last, e0 + k) : 0.0;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k)
            if (e0 + k < E) ys[(e0 + k) * C] = cas.step(coef, ns, v[k]);
    }

    // backward cascade over the scratch; only the cropped window is written
    float* os = out + n * T * C + c;
    cas.prime(coef, ns, ys[(E - 1) * C]);
    for (int64_t e0 = E - 1; e0 >= 0; e0 -= UNROLL) {
        double v[UNROLL];
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) v[k] = e0 - k >= 0 ? ys[(e0 - k) * C] : 0.0;
#pragma unroll
        for (int k = 0; k < UNROLL; ++k) {
            const int64_t e = e0 - k;
            if (e >= 0) {
                const double y = cas.step(coef, ns, v[k]);
                if (e >= pad && e < pad + T) os[(e - pad) * C] = __double2float_rn(y);
            }
        }
    }
}

template <bool TWOPASS>
using KernelFn = void (*)(const float*, const double*, double*, float*, int64_t, int64_t,
                          int64_t, int, int64_t);

template <bool TWOPASS>
KernelFn<TWOPASS> kernel_for(int64_t S) {
    switch (S) {
        case 1: return sosfilt_kernel<1, TWOPASS>;
        case 2: return sosfilt_kernel<2, TWOPASS>;
        case 3: return sosfilt_kernel<3, TWOPASS>;
        case 4: return sosfilt_kernel<4, TWOPASS>;
        case 5: return sosfilt_kernel<5, TWOPASS>;
        case 6: return sosfilt_kernel<6, TWOPASS>;
        case 7: return sosfilt_kernel<7, TWOPASS>;
        case 8: return sosfilt_kernel<8, TWOPASS>;
        default: return sosfilt_kernel<0, TWOPASS>;
    }
}

}  // namespace

// x (N, T, C) float32, sos (S, 6) float64, out (N, T, C) float32, all
// contiguous on the device; scratch (N, T + 2 pad, C) float64 for twopass
// (unused for onepass). Returns the cudaError_t of the launch.
extern "C" int sosfilt_launch(const void* x, const void* sos, void* scratch, void* out,
                              int64_t N, int64_t T, int64_t C, int64_t S, int64_t pad,
                              int twopass, void* stream) {
    if (N == 0 || T == 0 || C == 0) return static_cast<int>(cudaSuccess);
    if (S < 1 || S > MAX_SECTIONS || pad < 0 || pad > T - 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (N * C + NTHREADS - 1) / NTHREADS;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const double* sd = static_cast<const double*>(sos);
    if (twopass) {
        kernel_for<true>(S)<<<static_cast<unsigned>(blocks), NTHREADS, 0, st>>>(
            xf, sd, static_cast<double*>(scratch), static_cast<float*>(out), N, T, C,
            static_cast<int>(S), pad);
    } else {
        kernel_for<false>(S)<<<static_cast<unsigned>(blocks), NTHREADS, 0, st>>>(
            xf, sd, nullptr, static_cast<float*>(out), N, T, C, static_cast<int>(S), 0);
    }
    return static_cast<int>(cudaGetLastError());
}

// Threads per block and resident blocks per SM that the runtime grants the
// twopass instance that runs S sections
extern "C" int sosfilt_occupancy(int64_t S, int* threads, int* blocks) {
    *threads = NTHREADS;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel_for<true>(S), NTHREADS, 0));
}
