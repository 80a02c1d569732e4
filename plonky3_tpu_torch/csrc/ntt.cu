// Four-step DIF NTT over a 31-bit Montgomery field, for Hopper (sm_90a).
//
// Replaces the TPU kernels of plonky3_tpu/ops/ntt_pallas.py: `_k1_kernel`
// (step 1, with `_dif_slices_axis0`) and `_k2_kernel` (step 2, with
// `_dif_sublane`), launched by `dif_fused`. Contract: the same bits as the
// radix-2 DIF network `_dif` (natural rows in, bit-reversed rows out) on an
// (n, w) matrix of u32 Montgomery words, transformed along axis 0.
//
// The matrix is viewed as x[(a, b), c] with n = A·B rows, row = a·B + b.
//   k1: for each b, a size-A DIF along a; then row (a, b) is multiplied by
//       the four-step correction w_n^{rev_A(a)·b}. With zero_top the input
//       holds only the rows a < A/2 (the coset-LDE zero pad is implicit) and
//       stage 0 becomes [x, x·tw].
//   k2: for each a, a size-B DIF along b (B contiguous rows).
// Both take `batch` independent matrices `stride` rows apart (the launch
// plan of ops/ntt_cuda.py runs transforms above 2^20 rows that way).
// Twiddles are constants, so every product is a Shoup multiply with a
// host-built table of standard-form twiddles and floor(w·2^32/P): for a
// Montgomery-form input it gives the same canonical word as the Montgomery
// product with the Montgomery-form twiddle.
//
// Bound (as chip_smoke.py counts it): bytes for both kernels at the main
// path's 2^18 × 1312 — k2 reads and writes the matrix once (2 × 1.38 GB),
// k1 reads the zero_top half and the correction table and writes the
// matrix. The operations stay below that: 5 ALU + 3 multiply instructions
// per butterfly, 1 + 3 per lone Shoup product (the correction, the
// zero_top stage 0), at SMs × 64 lanes per clock. Design: one kernel template
// serves both; a block owns one sub-transform of M = 2^m ≤ 1024 rows over a
// tile of 32 consecutive columns, so a warp moves one 128-byte row segment.
// Registers are the working store: a thread holds groups of R = 8 elements
// of one column, rows base + k·Q, and runs three radix-2 stages on them in
// registers (the same butterflies and twiddles tw[j << st] as the
// stage-by-stage network, so the same bits). Shared memory only carries the
// exchange between passes: ⌈m/3⌉ passes, one barrier each between them
// (2 at m = 9, where a stage-per-barrier design pays 9). The first pass
// loads straight from device memory, every load of the thread issued before
// the first butterfly; the last pass stores straight out (k1 multiplies by
// its correction there). A pass's 7 twiddle pairs come once per group, or
// once per thread when all its groups share them, through the read-only
// cache. 512 threads with at most 64 registers and 64 KB of shared memory
// at m = 9 keep two blocks (32 warps) resident per SM.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TC = 32;  // columns per block tile: one warp per row segment

// The reductions are unsigned minima: x − p wraps above x when x < p, so
// min(x, x − p) is x mod p for x < 2p (one VIADDMNMX with the add), the same
// words as a compare and select in fewer instructions.
__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t s = a + b;  // a, b < p < 2^31: no overflow
    return min(s, s - p);
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t d = a - b;  // wraps above 2^31 when a < b; then d + p < p
    return min(d, d + p);
}

// Shoup: a·w mod p for a constant w (standard form) with wsh = floor(w·2^32/p).
// q is floor(a·w/p) or one less, so r = a·w − q·p lies in [0, 2p).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w, uint32_t wsh,
                                              uint32_t p) {
    const uint32_t q = __umulhi(a, wsh);
    const uint32_t r = a * w - q * p;
    return min(r, r - p);
}

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

// A size-2^LOG_M sub-transform on one column tile. Its rows form GROUPS
// groups of R; a thread owns G of them (u = t + i·RT, i < G).
template <int LOG_M>
struct Shape {
    static constexpr int LOG_R = cmin(LOG_M, 3);
    static constexpr int R = 1 << LOG_R;
    static constexpr int GROUPS = (1 << LOG_M) / R;
    static constexpr int G = cmin(GROUPS, 4);
    static constexpr int RT = GROUPS / G;  // threads per column
    static constexpr int THREADS = RT * TC;
    static constexpr int MIN_BLOCKS = cmax(1, 1024 / THREADS);  // ≤ 64 registers
    static constexpr int PASSES = LOG_M == 0 ? 0 : (LOG_M + LOG_R - 1) / LOG_R;
    static constexpr int SMEM = PASSES > 1 ? (1 << LOG_M) * TC * 4 : 0;
};

// Pass P runs stages [S0, S0 + STAGES) on groups of rows base(u) + k·Q,
// k < R; the last pass has Q = 1. The group's stage st has pairs
// (k, k + 2^e) for e = LOG_M − 1 − st − LOG_Q and bit e of k clear, with
// twiddle tw[(j + (k mod 2^e)·Q) << st], j = u mod Q.
template <int LOG_M, int P>
struct Pass {
    using S = Shape<LOG_M>;
    static constexpr int S0 = S::LOG_R * P;
    static constexpr int STAGES = cmin(S::LOG_R, LOG_M - S0);
    static constexpr int LOG_Q = cmax(0, LOG_M - S0 - S::LOG_R);
    static constexpr int Q = 1 << LOG_Q;
    static constexpr bool LAST = P + 1 >= S::PASSES;
    // j is the same for all of a thread's groups when Q divides RT
    static constexpr bool TW_PER_THREAD = Q <= S::RT;
    __device__ static __forceinline__ int base(int u) {
        return ((u >> LOG_Q) << (LOG_Q + S::LOG_R)) | (u & (Q - 1));
    }
};

// The pass's twiddles for j: slot 2^e − 1 + kk holds tw[(j + kk·Q) << st].
template <int LOG_M, int P>
__device__ __forceinline__ void load_twiddles(const uint32_t* __restrict__ tw, int j,
                                              uint32_t (&w)[8], uint32_t (&wsh)[8]) {
    using T = Pass<LOG_M, P>;
    constexpr int HALF_M = (1 << LOG_M) >> 1;
#pragma unroll
    for (int e = 0; e < T::STAGES; ++e) {
        const int st = LOG_M - 1 - e - T::LOG_Q;
#pragma unroll
        for (int kk = 0; kk < (1 << e); ++kk) {
            const int idx = (j + (kk << T::LOG_Q)) << st;
            w[(1 << e) - 1 + kk] = __ldg(tw + idx);
            wsh[(1 << e) - 1 + kk] = __ldg(tw + HALF_M + idx);
        }
    }
}

// The pass's stages on one group in registers. With zero_top, stage 0
// (the first of pass 0) sees v[k + R/2] = 0: top x, bottom x·tw.
template <int LOG_M, int P>
__device__ __forceinline__ void butterflies(uint32_t (&v)[8], const uint32_t (&w)[8],
                                            const uint32_t (&wsh)[8], bool zero_top,
                                            uint32_t p) {
    using T = Pass<LOG_M, P>;
#pragma unroll
    for (int e = T::STAGES - 1; e >= 0; --e) {
        const int h = 1 << e;
#pragma unroll
        for (int k = 0; k < Shape<LOG_M>::R; ++k) {
            if (k & h) continue;
            const int slot = h - 1 + (k & (h - 1));
            if (P == 0 && e == T::STAGES - 1 && zero_top) {
                v[k + h] = mul_shoup(v[k], w[slot], wsh[slot], p);
            } else {
                const uint32_t a = v[k], b = v[k + h];
                v[k] = add_mod(a, b, p);
                v[k + h] = mul_shoup(sub_mod(a, b, p), w[slot], wsh[slot], p);
            }
        }
    }
}

// Where a block's sub-transform lives: element i of column c is
// io[i·step + c]; k1 also multiplies row i by corr[i·B + b].
struct Io {
    const uint32_t* src;
    uint32_t* dst;
    const uint32_t* corr;  // k1 only: std words, then Shoup at +n
    size_t step;
    int b, log_b, n;
};

// Passes P.. of one block; v holds pass P's operands for P = 0.
template <int LOG_M, bool K1, int P>
__device__ __forceinline__ void run(uint32_t (&v)[Shape<LOG_M>::G][8], uint32_t* tile,
                                    const uint32_t* __restrict__ tw, const Io& io,
                                    int t, int tc, bool live, bool zero_top, uint32_t p) {
    using S = Shape<LOG_M>;
    using T = Pass<LOG_M, P>;
    uint32_t w[8], wsh[8];
    if constexpr (T::TW_PER_THREAD) load_twiddles<LOG_M, P>(tw, t & (T::Q - 1), w, wsh);
#pragma unroll
    for (int i = 0; i < S::G; ++i) {
        const int u = t + i * S::RT;
        const int base = T::base(u);
        if constexpr (P > 0) {
#pragma unroll
            for (int k = 0; k < S::R; ++k) v[i][k] = tile[(base + k * T::Q) * TC + tc];
        }
        if constexpr (!T::TW_PER_THREAD) load_twiddles<LOG_M, P>(tw, u & (T::Q - 1), w, wsh);
        butterflies<LOG_M, P>(v[i], w, wsh, zero_top, p);
        if constexpr (T::LAST) {  // Q = 1: rows base .. base + R − 1
            if (live) {
#pragma unroll
                for (int k = 0; k < S::R; ++k) {
                    uint32_t out = v[i][k];
                    if constexpr (K1) {
                        const int r = ((base + k) << io.log_b) + io.b;
                        out = mul_shoup(out, __ldg(io.corr + r), __ldg(io.corr + io.n + r), p);
                    }
                    io.dst[(size_t)(base + k) * io.step] = out;
                }
            }
        } else {
#pragma unroll
            for (int k = 0; k < S::R; ++k) tile[(base + k * T::Q) * TC + tc] = v[i][k];
        }
    }
    if constexpr (!T::LAST) {
        __syncthreads();
        run<LOG_M, K1, P + 1>(v, tile, tw, io, t, tc, live, zero_top, p);
    }
}

// One block: sub-transform blockIdx.y of matrix blockIdx.z, columns
// blockIdx.x·32 + [0, 32). k1: sub-transform b has rows a·B + b;
// k2: sub-transform a has rows a·M + [0, M).
template <int LOG_M, bool K1>
__global__ void __launch_bounds__(Shape<LOG_M>::THREADS, Shape<LOG_M>::MIN_BLOCKS)
ntt_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
           const uint32_t* __restrict__ tw, const uint32_t* __restrict__ corr,
           int log_other, int w, int zero_top, long long stride, uint32_t p) {
    using S = Shape<LOG_M>;
    extern __shared__ uint32_t tile[];
    const int tc = threadIdx.x % TC, t = threadIdx.x / TC;
    const int c = blockIdx.x * TC + tc;
    const bool live = c < w;
    const int sub = blockIdx.y;
    size_t row0, step;
    if (K1) {
        row0 = sub;
        step = (size_t)w << log_other;
    } else {
        row0 = (size_t)sub << LOG_M;
        step = w;
    }
    const size_t in0 = (size_t)blockIdx.z * (zero_top ? stride / 2 : stride);
    const size_t out0 = (size_t)blockIdx.z * stride;
    const Io io{x + (in0 + row0) * w + c, y + (out0 + row0) * w + c, corr, step,
                sub, log_other, (1 << LOG_M) << log_other};
    // pass 0's operands straight from device memory, all loads issued first
    using T0 = Pass<LOG_M, 0>;
    const int k_in = zero_top ? S::R / 2 : S::R;
    uint32_t v[S::G][8];
#pragma unroll
    for (int i = 0; i < S::G; ++i) {
        const int base = T0::base(t + i * S::RT);
#pragma unroll
        for (int k = 0; k < 8; ++k)
            v[i][k] = (k < k_in && live) ? io.src[(size_t)(base + k * T0::Q) * step] : 0u;
    }
    run<LOG_M, K1, 0>(v, tile, tw, io, t, tc, live, zero_top != 0, p);
}

template <int LOG_M, bool K1>
int launch(const void* x, void* y, const void* tw, const void* corr, int log_other, int w,
           int zero_top, int batch, long long stride, uint32_t p, cudaStream_t s) {
    using S = Shape<LOG_M>;
    if (S::SMEM > 48 * 1024)
        cudaFuncSetAttribute(ntt_kernel<LOG_M, K1>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    const dim3 grid((w + TC - 1) / TC, 1u << log_other, batch);
    ntt_kernel<LOG_M, K1><<<grid, S::THREADS, S::SMEM, s>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)corr,
        log_other, w, zero_top, stride, p);
    return (int)cudaGetLastError();
}

template <bool K1>
int dispatch(int log_m, const void* x, void* y, const void* tw, const void* corr,
             int log_other, int w, int zero_top, int batch, long long stride, uint32_t p,
             void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
#define NTT_CASE(m) \
    case m: return launch<m, K1>(x, y, tw, corr, log_other, w, zero_top, batch, stride, p, s);
    switch (log_m) {
        NTT_CASE(0) NTT_CASE(1) NTT_CASE(2) NTT_CASE(3) NTT_CASE(4) NTT_CASE(5)
        NTT_CASE(6) NTT_CASE(7) NTT_CASE(8) NTT_CASE(9) NTT_CASE(10)
    }
#undef NTT_CASE
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: batch matrices of (a_in·B, w) u32, a_in = A/2 if zero_top else A, at
// stride/2 or stride rows; y: batch × (A·B, w) at stride rows.
// tw: 2·(A/2) words; corr: 2·A·B words.
int ntt_k1(const void* x, void* y, const void* tw, const void* corr, int log_a,
           int log_b, int w, int zero_top, int batch, long long stride, uint32_t P,
           void* stream) {
    return dispatch<true>(log_a, x, y, tw, corr, log_b, w, zero_top, batch, stride, P,
                          stream);
}

// y, out: batch × (A·B, w) u32 at stride rows; tw: 2·(B/2) words.
int ntt_k2(const void* y, void* out, const void* tw, int log_a, int log_b, int w,
           int batch, long long stride, uint32_t P, void* stream) {
    return dispatch<false>(log_b, y, out, tw, nullptr, log_a, w, 0, batch, stride, P,
                           stream);
}

}  // extern "C"
