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
// Twiddles are constants, so every product is a Shoup multiply with a
// host-built table of standard-form twiddles and floor(w·2^32/P): for a
// Montgomery-form input it gives the same canonical word as the Montgomery
// product with the Montgomery-form twiddle.
//
// Bound: bytes. Each kernel reads and writes the whole matrix once (about
// 2 × 1.38 GB at 2^18 × 1312), against ~9 integer ops per element per
// stage. Design: a block owns one sub-transform (one b for k1, one a for
// k2) over a tile of 32 consecutive columns, so every row segment is one
// 128-byte load or store. The sub-transform runs entirely in shared memory
// (A·32 words, 64 KB at A = 512); only the first load and the last store
// touch device memory. The k1 loads are strided by B rows; the tile width
// keeps each of them a whole cache line.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;       // columns per block tile
constexpr int THREADS = 256; // 8 row lanes × 32 columns
constexpr int RS = THREADS / TW;

__device__ __forceinline__ uint32_t add_mod(uint32_t a, uint32_t b, uint32_t P) {
    uint32_t s = a + b;  // a, b < P < 2^31: no overflow
    return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t sub_mod(uint32_t a, uint32_t b, uint32_t P) {
    return a >= b ? a - b : a - b + P;
}

// Shoup: a·w mod P for a constant w (standard form) with wsh = floor(w·2^32/P).
// q is floor(a·w/P) or one less, so r = a·w − q·P lies in [0, 2P).
__device__ __forceinline__ uint32_t mul_shoup(uint32_t a, uint32_t w, uint32_t wsh,
                                              uint32_t P) {
    uint32_t q = __umulhi(a, wsh);
    uint32_t r = a * w - q * P;
    return r >= P ? r - P : r;
}

// DIF of size 2^log_m over the rows of the shared tile s[m][TW], stages
// [first, log_m). tw: std[M/2] then Shoup[M/2]; stage st uses tw[j << st].
__device__ __forceinline__ void dif_shared(uint32_t* s, int log_m, int first,
                                           const uint32_t* __restrict__ tw,
                                           uint32_t P, int tr, int tc) {
    const int half_m = (1 << log_m) >> 1;
    for (int st = first; st < log_m; ++st) {
        const int lg_half = log_m - st - 1;
        const int half = 1 << lg_half;
        for (int p = tr; p < half_m; p += RS) {
            const int g = p >> lg_half;
            const int j = p & (half - 1);
            const int i0 = (g << (lg_half + 1)) + j;
            const int i1 = i0 + half;
            const uint32_t t = s[i0 * TW + tc];
            const uint32_t u = s[i1 * TW + tc];
            const int k = j << st;
            s[i0 * TW + tc] = add_mod(t, u, P);
            s[i1 * TW + tc] = mul_shoup(sub_mod(t, u, P), tw[k], tw[half_m + k], P);
        }
        __syncthreads();
    }
}

__global__ void __launch_bounds__(THREADS)
k1_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y,
          const uint32_t* __restrict__ tw, const uint32_t* __restrict__ corr,
          int log_a, int log_b, int w, int zero_top, uint32_t P) {
    extern __shared__ uint32_t s[];
    const int A = 1 << log_a, B = 1 << log_b;
    const int b = blockIdx.x;
    const int tc = threadIdx.x % TW, tr = threadIdx.x / TW;
    const int c = blockIdx.y * TW + tc;
    const bool live = c < w;
    const int a_in = zero_top ? A >> 1 : A;
    for (int a = tr; a < a_in; a += RS)
        s[a * TW + tc] = live ? x[((size_t)a * B + b) * w + c] : 0u;
    int first = 0;
    if (zero_top) {
        // stage 0 of [x; 0]: top = x, bottom = x·tw[a]
        const int h = A >> 1;
        for (int a = tr; a < h; a += RS)
            s[(a + h) * TW + tc] = mul_shoup(s[a * TW + tc], tw[a], tw[h + a], P);
        first = 1;
    }
    __syncthreads();
    dif_shared(s, log_a, first, tw, P, tr, tc);
    if (!live) return;
    const size_t n = (size_t)A * B;
    for (int a = tr; a < A; a += RS) {
        const size_t r = (size_t)a * B + b;
        y[r * w + c] = mul_shoup(s[a * TW + tc], corr[r], corr[n + r], P);
    }
}

__global__ void __launch_bounds__(THREADS)
k2_kernel(const uint32_t* __restrict__ y, uint32_t* __restrict__ out,
          const uint32_t* __restrict__ tw, int log_b, int w, uint32_t P) {
    extern __shared__ uint32_t s[];
    const int B = 1 << log_b;
    const size_t a = blockIdx.x;
    const int tc = threadIdx.x % TW, tr = threadIdx.x / TW;
    const int c = blockIdx.y * TW + tc;
    const bool live = c < w;
    for (int b = tr; b < B; b += RS)
        s[b * TW + tc] = live ? y[(a * B + b) * w + c] : 0u;
    __syncthreads();
    dif_shared(s, log_b, 0, tw, P, tr, tc);
    if (!live) return;
    for (int b = tr; b < B; b += RS) out[(a * B + b) * w + c] = s[b * TW + tc];
}

int smem_bytes(int log_m) { return (1 << log_m) * TW * (int)sizeof(uint32_t); }

}  // namespace

extern "C" {

// x: (a_in·B, w) u32, a_in = A/2 if zero_top else A; y: (A·B, w).
// tw: 2·(A/2) words; corr: 2·A·B words.
int ntt_k1(const void* x, void* y, const void* tw, const void* corr, int log_a,
           int log_b, int w, int zero_top, uint32_t P, void* stream) {
    const int smem = smem_bytes(log_a);
    cudaFuncSetAttribute(k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dim3 grid(1u << log_b, (w + TW - 1) / TW);
    k1_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)y, (const uint32_t*)tw, (const uint32_t*)corr,
        log_a, log_b, w, zero_top, P);
    return (int)cudaGetLastError();
}

// y, out: (A·B, w) u32; tw: 2·(B/2) words.
int ntt_k2(const void* y, void* out, const void* tw, int log_a, int log_b, int w,
           uint32_t P, void* stream) {
    const int smem = smem_bytes(log_b);
    cudaFuncSetAttribute(k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dim3 grid(1u << log_a, (w + TW - 1) / TW);
    k2_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)y, (uint32_t*)out, (const uint32_t*)tw, log_b, w, P);
    return (int)cudaGetLastError();
}

}  // extern "C"
