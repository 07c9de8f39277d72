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
// Section s maps its input w to y in direct form I, in float64, the terms
// that do not depend on this sample's input first and the newest feedback
// term last:
//
//     p    = ((b1 w[n-1] + b2 w[n-2]) - a2 y[n-2]) - a1 y[n-1]
//     y[n] = b0 w[n] + p
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
// Layout: one thread per (trial, channel) sequence, neighbouring threads on
// neighbouring channels, so every step's load and store of a warp is one
// coalesced line at C >= 32. The coefficients sit in shared memory
// (broadcast reads, off the dependent chain), -a1 and -a2 stored negated.
// S = 1..8 are compile-time instances (orders up to 8 band-pass and 16
// low-pass), their histories in registers; any other S up to MAX_SECTIONS
// runs the run-time instance, whose histories live in local memory.
//
// What bounds it on the H100, and what the design does about it. One
// thread's recurrence is a serial chain, and the card has too few threads
// to hide a long one (64,000 at the main-path shape (1000, 1000, 64), about
// 15 warps an SM; 64 on one long recording). So:
// - feedback off the chain: p is formed from the previous steps' values,
//   so a section's input reaches its output through one product and one
//   sum, and the section's own loop y[n-1] -> y[n] is a product and two
//   sums;
// - sections pipelined across samples (a wavefront): at step t section s
//   runs sample t - s on the value section s - 1 produced at step t - 1,
//   so the S sections of a step are independent and issue back to back; a
//   masked prologue and epilogue of S - 1 steps run no section on a sample
//   outside the sequence. Boundary b keeps the last three values of the
//   input of section b (b = 0: the sequence, b = s + 1: the output of
//   section s), newest first;
// - loads a block ahead: the next UNROLL samples (float32 input or odd
//   extension forward, float64 scratch read backwards) are loaded into a
//   register double buffer while the current block runs; stores stay one
//   coalesced line a step. (At the main-path shape an L2 prefetch two
//   blocks further on cost 6% and blocks of 16 samples 9%, which on one
//   long recording gained 1% and 18%: PERF.md section 6.)
// - FMAs: b0 w + p and the feedback terms are fused (FMA = 1), 5 FP64
//   instructions per sample, section and pass instead of 9, and the loop
//   y[n-1] -> y[n] is two FMAs. Taken because the A/B of the two builds
//   (scripts/sosfilt_kernel_ab.py, PERF.md section 6) showed them ahead at
//   both shapes by more than the spread of its rounds. The plain PyTorch
//   version in ops/iir_kernels.py rounds every product and sum on its own
//   in the same order (the FMA = 0 build gives its bits), so the two agree
//   within 2 float32 ulps of the maximum, not bitwise.
// What is left is the bytes of the float64 scratch (the design's floor,
// ~0.48 ms at the main-path shape against 0.15 ms for the input and output
// alone) and, on one long recording, one warp per sub-partition waiting on
// its FP64 issue and its loads. Two launches are bitwise equal: each
// thread's arithmetic is fixed and no sum crosses threads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;
// resident blocks per SM every instance is built for: 4 x 128 threads is
// 16 warps, the main-path shape's one wave, at 128 registers a thread
constexpr int MIN_BLOCKS = 4;
// samples per block of loads (the register double buffer)
constexpr int UNROLL = 8;
// 1: fused multiply-adds; 0: every product and sum rounded on its own
constexpr int FMA = 1;
constexpr int MAX_SECTIONS = 64;
// per section in shared memory: b0, b1, b2, -a1, -a2, b0 + b1 + b2, 1 + a1 + a2
constexpr int NCOEF = 7;

__device__ __forceinline__ double mul_add(double a, double b, double c) {
    if constexpr (FMA != 0) return __fma_rn(a, b, c);
    else return __dadd_rn(__dmul_rn(a, b), c);
}

template <int S>
struct Wavefront {
    static constexpr int NB = (S > 0 ? S : MAX_SECTIONS) + 1;
    // boundary b: h1[b], h2[b], h3[b], the last three values of the input
    // of section b (b = 0 the sequence, b = s + 1 the output of section s)
    double h1[NB], h2[NB], h3[NB];

    __device__ __forceinline__ void prime(const double* coef, int ns, double x0) {
        double h = x0;
        if constexpr (S > 0) {
#pragma unroll
            for (int s = 0; s < S; ++s) {
                h1[s] = h2[s] = h3[s] = h;
                h = __ddiv_rn(__dmul_rn(h, coef[NCOEF * s + 5]), coef[NCOEF * s + 6]);
            }
            h1[S] = h2[S] = h3[S] = h;
        } else {
            for (int s = 0; s < ns; ++s) {
                h1[s] = h2[s] = h3[s] = h;
                h = __ddiv_rn(__dmul_rn(h, coef[NCOEF * s + 5]), coef[NCOEF * s + 6]);
            }
            h1[ns] = h2[ns] = h3[ns] = h;
        }
    }

    // section s on boundary s's newest value; shifts its output into
    // boundary s + 1, which section s + 1 has read already this step
    __device__ __forceinline__ void section(const double* coef, int s) {
        const double* k = coef + NCOEF * s;
        double p = __dmul_rn(k[1], h2[s]);
        p = mul_add(k[2], h3[s], p);
        p = mul_add(k[4], h2[s + 1], p);
        p = mul_add(k[3], h1[s + 1], p);
        const double y = mul_add(k[0], h1[s], p);
        h3[s + 1] = h2[s + 1];
        h2[s + 1] = h1[s + 1];
        h1[s + 1] = y;
    }

    // step t: boundary 0 takes sample t (if t < E), then section s runs
    // sample t - s, last section first; MASKED runs only the sections whose
    // sample lies in [0, E)
    template <bool MASKED>
    __device__ __forceinline__ void step(const double* coef, int ns, int64_t t, int64_t E,
                                         double v) {
        if (!MASKED || t < E) {
            h3[0] = h2[0];
            h2[0] = h1[0];
            h1[0] = v;
        }
        if constexpr (S > 0) {
#pragma unroll
            for (int s = S - 1; s >= 0; --s)
                if (!MASKED || (t - s >= 0 && t - s < E)) section(coef, s);
        } else {
            for (int s = ns - 1; s >= 0; --s)
                if (!MASKED || (t - s >= 0 && t - s < E)) section(coef, s);
        }
    }

    // the last section's newest output
    __device__ __forceinline__ double out(int ns) const {
        if constexpr (S > 0) return h1[S];
        else return h1[ns];
    }

    // the whole cascade over the E samples of `src`: `sink(e, y)` gets
    // output sample e of the last section, e = 0 .. E - 1 in order
    template <class Src, class Sink>
    __device__ __forceinline__ void run(const double* coef, int ns, int64_t E, const Src& src,
                                        Sink& sink) {
        using Raw = typename Src::Raw;
        const int64_t lag = (S > 0 ? S : ns) - 1;
        // prologue: steps 0 .. lag - 1 emit nothing
#pragma unroll 1
        for (int64_t t = 0; t < lag; ++t)
            step<true>(coef, ns, t, E, t < E ? src.value(t, src.load(t)) : 0.0);
        // steady steps lag .. E - 1, every section live, in blocks of UNROLL
        // loaded a block ahead
        const int64_t blocks = E > lag ? (E - lag) / UNROLL : 0;
        Raw cur[UNROLL], nxt[UNROLL];
        if (blocks > 0) {
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) cur[k] = src.load(lag + k);
        }
#pragma unroll 1
        for (int64_t b = 0; b < blocks; ++b) {
            const int64_t t0 = lag + b * UNROLL;
            // the last block loads itself again: no branch, no address past E
            const int64_t t1 = b + 1 < blocks ? t0 + UNROLL : t0;
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) nxt[k] = src.load(t1 + k);
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) {
                step<false>(coef, ns, t0 + k, E, src.value(t0 + k, cur[k]));
                sink(t0 + k - lag, out(ns));
            }
#pragma unroll
            for (int k = 0; k < UNROLL; ++k) cur[k] = nxt[k];
        }
        // the rest of the steady steps, fewer than UNROLL
#pragma unroll 1
        for (int64_t t = lag + blocks * UNROLL; t < E; ++t) {
            step<false>(coef, ns, t, E, src.value(t, src.load(t)));
            sink(t - lag, out(ns));
        }
        // epilogue: the sections drain, no input
#pragma unroll 1
        for (int64_t t = E > lag ? E : lag; t < E + lag; ++t) {
            step<true>(coef, ns, t, E, 0.0);
            sink(t - lag, out(ns));
        }
    }
};

// one sequence (stride C) as it is
struct Plain {
    using Raw = float;
    const float* xs;
    int64_t C;
    __device__ __forceinline__ float load(int64_t e) const { return xs[e * C]; }
    __device__ __forceinline__ double value(int64_t, float r) const {
        return static_cast<double>(r);
    }
};

// the odd extension of one sequence by `pad` samples at both ends: 2 x[0]
// - x[pad - e] before, 2 x[T-1] - x[2T - 2 - (e - pad)] after
struct OddExtension {
    using Raw = float;
    const float* xs;
    int64_t C, T, pad;
    double first2, last2;  // 2 x[0], 2 x[T-1]
    __device__ __forceinline__ int64_t index(int64_t e) const {
        const int64_t t = e - pad;
        return t < 0 ? -t : (t < T ? t : 2 * T - 2 - t);
    }
    __device__ __forceinline__ float load(int64_t e) const { return xs[index(e) * C]; }
    __device__ __forceinline__ double value(int64_t e, float r) const {
        const double v = static_cast<double>(r);
        const int64_t t = e - pad;
        return t < 0 ? __dsub_rn(first2, v) : (t < T ? v : __dsub_rn(last2, v));
    }
};

// one float64 scratch sequence of E samples read backwards
struct Reversed {
    using Raw = double;
    const double* ys;
    int64_t C, E;
    __device__ __forceinline__ double load(int64_t e) const { return ys[(E - 1 - e) * C]; }
    __device__ __forceinline__ double value(int64_t, double r) const { return r; }
};

// forward twopass output: the float64 scratch, and its last sample
struct ToScratch {
    double* ys;
    int64_t C;
    double last;
    __device__ __forceinline__ void operator()(int64_t e, double y) {
        ys[e * C] = y;
        last = y;
    }
};

// onepass output, rounded to float32
struct ToOutput {
    float* os;
    int64_t C;
    __device__ __forceinline__ void operator()(int64_t e, double y) {
        os[e * C] = __double2float_rn(y);
    }
};

// backward twopass output: reversed sample e is extended sample E - 1 - e;
// only the window [pad, pad + T) is written, rounded to float32
struct ToCroppedOutput {
    float* os;
    int64_t C, E, pad, T;
    __device__ __forceinline__ void operator()(int64_t e, double y) {
        const int64_t t = E - 1 - e - pad;
        if (t >= 0 && t < T) os[t * C] = __double2float_rn(y);
    }
};

template <int S, bool TWOPASS>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
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
        c[3] = -r[4];
        c[4] = -r[5];
        c[5] = __dadd_rn(__dadd_rn(r[0], r[1]), r[2]);
        c[6] = __dadd_rn(__dadd_rn(1.0, r[4]), r[5]);
    }
    __syncthreads();

    const int64_t g = static_cast<int64_t>(blockIdx.x) * NTHREADS + threadIdx.x;
    if (g >= N * C) return;
    const int64_t n = g / C, c = g - n * C;
    const float* xs = x + n * T * C + c;
    float* os = out + n * T * C + c;
    Wavefront<S> wf;

    if (!TWOPASS) {
        wf.prime(coef, ns, __dmul_rn(static_cast<double>(xs[0]), 0.0));
        ToOutput sink{os, C};
        wf.run(coef, ns, T, Plain{xs, C}, sink);
        return;
    }

    const int64_t E = T + 2 * pad;
    const double first2 = 2.0 * static_cast<double>(xs[0]);
    const double last2 = 2.0 * static_cast<double>(xs[(T - 1) * C]);
    const OddExtension ext{xs, C, T, pad, first2, last2};
    ToScratch fwd{scratch + n * E * C + c, C, 0.0};
    wf.prime(coef, ns, ext.value(0, ext.load(0)));
    wf.run(coef, ns, E, ext, fwd);

    ToCroppedOutput bwd{os, C, E, pad, T};
    wf.prime(coef, ns, fwd.last);
    wf.run(coef, ns, E, Reversed{fwd.ys, C, E}, bwd);
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

// Registers a thread and local memory bytes a thread (spills, and the
// run-time instance's histories) of the instance that runs S sections
extern "C" int sosfilt_attributes(int64_t S, int twopass, int* registers, int* local_bytes) {
    cudaFuncAttributes attr{};
    const cudaError_t rc = twopass ? cudaFuncGetAttributes(&attr, kernel_for<true>(S))
                                   : cudaFuncGetAttributes(&attr, kernel_for<false>(S));
    *registers = attr.numRegs;
    *local_bytes = static_cast<int>(attr.localSizeBytes);
    return static_cast<int>(rc);
}
