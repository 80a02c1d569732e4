// Poseidon2 over Goldilocks (P = 2^64 - 2^32 + 1), width 8, for Hopper
// (sm_90a): the Merkle leaf sponge, the 2-to-1 compression and the bare
// permutation of the Goldilocks STARK (plonky3_tpu_torch/gl/).
//
// None replaces a TPU kernel: the JAX package computes all three in jnp on
// (lo, hi) u32 pairs (plonky3_tpu/gl/merkle.py:55 GLPoseidonSponge.
// hash_rows_device, a `lax.scan` of the jitted permutation over the rate
// blocks; :125 GLCompressor.compress_device; plonky3_tpu/gl/stark.py:62
// GLDuplexChallenger.grind's candidate batches; the permutation itself is
// plonky3_tpu/fields/goldilocks_device.py:233). They are kernels here
// because in plain PyTorch one permutation is about 10^4 launches (one
// product of two elements some 50 tensor ops, 520 products a
// permutation): a leaf layer of 3,536 columns, 884 permutations a row
// one after another, would be about 9 million launches.
//
// The permutation (goldilocks/src/poseidon2.rs; hashes/
// poseidon2_goldilocks.py): the external light layer (two MDSMat4 of four
// lanes, then each lane plus the sum of its position in both halves,
// poseidon2/src/external.rs:96-170), 4 full rounds (constant and x^7 on
// every lane, external layer), 22 partial rounds (constant and x^7 on lane
// 0, then out_i = sum + diag_i·s_i), 4 full rounds. A product is the
// 128-bit product (a·b and __umul64hi) reduced as lo + w2·(2^32 - 1) - w3
// with w2, w3 the high product's 32-bit halves (2^64 = 2^32 - 1 and
// 2^96 = -1 mod P); an add adds 2^32 - 1 on a carry out of 2^64, a sub
// subtracts it on a borrow; every result is canonical, so the bits are
// those of any exact evaluation (the plain versions in
// fields/goldilocks_device.py, the JAX package's pair arithmetic).
//
// Bound: the integer pipes. A permutation is 722 field adds and 520
// products (chip_smoke.py gl_perm_ops); a row of w elements takes
// ceil(w / 4) permutations one after another, so the leaf layer of the
// 2^17 x 3,536 LDE is 1.2 x 10^8 permutations against 3.7 GB read.
// Design, simple first: one thread a row (sponge), a node (compression)
// or a state (permutation), the state in eight 64-bit registers, rounds
// unrolled, the 94 constants staged once a block in shared memory (every
// thread reads the same word: a broadcast). A sponge thread reads its
// row's block of four words, 32 contiguous bytes, per permutation.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

typedef unsigned long long u64;

constexpr u64 GL_P = 0xFFFFFFFF00000001ULL;
constexpr u64 GL_EPS = 0xFFFFFFFFULL;  // 2^64 mod P
constexpr int WIDTH = 8;
constexpr int RATE = 4;
constexpr int OUT = 4;
constexpr int FULL = 4;  // full rounds each side
constexpr int PARTIAL = 22;
// table layout (hashes/poseidon2_goldilocks_cuda.py::kernel_table): the
// initial full rounds' constants, the partial rounds', the final full
// rounds', the internal diagonal
constexpr int T_INIT = 0;
constexpr int T_PART = T_INIT + FULL * WIDTH;
constexpr int T_FINAL = T_PART + PARTIAL;
constexpr int T_DIAG = T_FINAL + FULL * WIDTH;
constexpr int TABLE_WORDS = T_DIAG + WIDTH;
constexpr int THREADS = 128;

__device__ __forceinline__ u64 gl_add(u64 a, u64 b) {
    u64 s = a + b;
    if (s < a) s += GL_EPS;
    return s >= GL_P ? s - GL_P : s;
}

__device__ __forceinline__ u64 gl_sub(u64 a, u64 b) {
    u64 d = a - b;
    return a < b ? d - GL_EPS : d;
}

__device__ __forceinline__ u64 gl_mul(u64 a, u64 b) {
    u64 lo = a * b, hi = __umul64hi(a, b);
    u64 w2 = hi & GL_EPS, w3 = hi >> 32;
    u64 r = lo + w2 * GL_EPS;  // w2·(2^32 - 1) < 2^64
    if (r < lo) r += GL_EPS;
    u64 d = gl_sub(r, w3);
    return d >= GL_P ? d - GL_P : d;
}

__device__ __forceinline__ u64 sbox7(u64 x) {
    u64 x2 = gl_mul(x, x);
    u64 x4 = gl_mul(x2, x2);
    return gl_mul(gl_mul(x4, x2), x);
}

// MDSMat4 with the reference's add/double schedule
__device__ __forceinline__ void mat4(u64* x) {
    u64 t01 = gl_add(x[0], x[1]);
    u64 t23 = gl_add(x[2], x[3]);
    u64 t0123 = gl_add(t01, t23);
    u64 t01123 = gl_add(t0123, x[1]);
    u64 t01233 = gl_add(t0123, x[3]);
    u64 o0 = gl_add(t01123, t01);
    u64 o1 = gl_add(t01123, gl_add(x[2], x[2]));
    u64 o2 = gl_add(t01233, t23);
    u64 o3 = gl_add(t01233, gl_add(x[0], x[0]));
    x[0] = o0; x[1] = o1; x[2] = o2; x[3] = o3;
}

__device__ __forceinline__ void mds_light(u64* s) {
    mat4(s);
    mat4(s + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        u64 tot = gl_add(s[i], s[i + 4]);
        s[i] = gl_add(s[i], tot);
        s[i + 4] = gl_add(s[i + 4], tot);
    }
}

__device__ __forceinline__ void full_round(u64* s, const u64* rc) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) s[i] = sbox7(gl_add(s[i], rc[i]));
    mds_light(s);
}

__device__ __forceinline__ void permute(u64* s, const u64* c) {
    mds_light(s);
#pragma unroll
    for (int r = 0; r < FULL; ++r) full_round(s, c + T_INIT + r * WIDTH);
#pragma unroll
    for (int r = 0; r < PARTIAL; ++r) {
        s[0] = sbox7(gl_add(s[0], c[T_PART + r]));
        u64 sum = gl_add(gl_add(gl_add(s[0], s[1]), gl_add(s[2], s[3])),
                         gl_add(gl_add(s[4], s[5]), gl_add(s[6], s[7])));
#pragma unroll
        for (int i = 0; i < WIDTH; ++i)
            s[i] = gl_add(sum, gl_mul(c[T_DIAG + i], s[i]));
    }
#pragma unroll
    for (int r = 0; r < FULL; ++r) full_round(s, c + T_FINAL + r * WIDTH);
}

__device__ __forceinline__ void stage_table(u64* c, const u64* table) {
    for (int i = threadIdx.x; i < TABLE_WORDS; i += blockDim.x) c[i] = table[i];
    __syncthreads();
}

// PaddingFreeSponge(rate 4, out 4) of each row of an (h, w) matrix: each
// block of four elements overwrites lanes 0..3, the last block (w mod 4
// elements) its first lanes only; then the permutation.
__global__ void __launch_bounds__(THREADS)
gl_sponge_rows_kernel(const u64* __restrict__ mat, long long h, int w,
                      u64* __restrict__ out, const u64* __restrict__ table) {
    __shared__ u64 c[TABLE_WORDS];
    stage_table(c, table);
    long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= h) return;
    const u64* p = mat + row * (long long)w;
    u64 s[WIDTH] = {0, 0, 0, 0, 0, 0, 0, 0};
    int full = w / RATE * RATE;
    for (int k = 0; k < full; k += RATE) {
#pragma unroll
        for (int i = 0; i < RATE; ++i) s[i] = __ldg(p + k + i);
        permute(s, c);
    }
    int rem = w - full;
    if (rem) {
        s[0] = __ldg(p + full);
        if (rem > 1) s[1] = __ldg(p + full + 1);
        if (rem > 2) s[2] = __ldg(p + full + 2);
        permute(s, c);
    }
#pragma unroll
    for (int i = 0; i < OUT; ++i) out[row * OUT + i] = s[i];
}

// node i: the first four lanes of the permuted [left_i | right_i]; left
// and right rows are four elements, `ls` and `rs` elements apart.
__global__ void __launch_bounds__(THREADS)
gl_compress_kernel(const u64* __restrict__ left, long long ls,
                   const u64* __restrict__ right, long long rs, long long n,
                   u64* __restrict__ out, const u64* __restrict__ table) {
    __shared__ u64 c[TABLE_WORDS];
    stage_table(c, table);
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u64 s[WIDTH];
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
        s[j] = __ldg(left + i * ls + j);
        s[OUT + j] = __ldg(right + i * rs + j);
    }
    permute(s, c);
#pragma unroll
    for (int j = 0; j < OUT; ++j) out[i * OUT + j] = s[j];
}

// each (8,) row of `states` permuted in place
__global__ void __launch_bounds__(THREADS)
gl_permute_kernel(u64* __restrict__ states, long long n,
                  const u64* __restrict__ table) {
    __shared__ u64 c[TABLE_WORDS];
    stage_table(c, table);
    long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    u64 s[WIDTH];
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) s[j] = states[i * WIDTH + j];
    permute(s, c);
#pragma unroll
    for (int j = 0; j < WIDTH; ++j) states[i * WIDTH + j] = s[j];
}

unsigned blocks_for(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// mat: (h, w) u64 canonical elements; out: (h, 4) digests.
int gl_sponge_rows(const void* mat, long long h, int w, void* out,
                   const void* table, void* stream) {
    gl_sponge_rows_kernel<<<blocks_for(h), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)mat, h, w, (u64*)out, (const u64*)table);
    return (int)cudaGetLastError();
}

// left, right: n rows of 4 elements, ls and rs elements apart; out (n, 4).
int gl_compress(const void* left, long long ls, const void* right,
                long long rs, long long n, void* out, const void* table,
                void* stream) {
    gl_compress_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)left, ls, (const u64*)right, rs, n, (u64*)out,
        (const u64*)table);
    return (int)cudaGetLastError();
}

// states: (n, 8), permuted in place.
int gl_permute(void* states, long long n, const void* table, void* stream) {
    gl_permute_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
        (u64*)states, n, (const u64*)table);
    return (int)cudaGetLastError();
}

}  // extern "C"
