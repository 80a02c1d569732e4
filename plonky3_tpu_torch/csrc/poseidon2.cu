// The Poseidon2 duplex transcript's two kernels for Hopper (sm_90a): the
// duplex chain and the proof-of-work grind of the Poseidon2 config's
// DuplexChallenger<F, Perm24, 24, 16> (challenger/src/duplex_challenger.rs:33),
// over a 31-bit Montgomery field (KoalaBear).
//
// Neither replaces a TPU kernel: the JAX package computes both in jnp
// (plonky3_tpu/challenger/device_duplex.py: the `lax.scan` absorb of
// `observe_words`, :58, and the `while_loop` search of `grind_field`, :146;
// its host replay is native/poseidon2.c::p3_p2_duplex_chain, :109). They
// are kernels here because a width-24 permutation in plain PyTorch is some
// 450 launches: the transcript's longest absorb (the opened values before
// alpha2, about 660 blocks) would take some 300,000 launches one after
// another, and a search would synchronize the host for every batch.
//
// The permutation (poseidon2/src/lib.rs:139): the external layer (MDS-light,
// circ(2M4, M4, ...), external.rs:113), 4 external rounds (round constants,
// s-box x^3 on every lane, external layer), 23 internal rounds (constant and
// s-box on lane 0, then sum + V_i·s_i, monty-31/src/poseidon2.rs:77-90),
// 4 external rounds. State words are Montgomery-form u32 in [0, p); a
// product is a 64-bit product and its Montgomery reduction, an add a
// conditional subtraction. The table (hashes/poseidon2_cuda.py::kernel_table)
// holds the round constants and the diagonal in Montgomery form and is
// staged in shared memory.
//
// Bound: integer operations, and for the chain latency. A permutation is
// 8 external and 23 internal rounds of dependent field ops: about 5,550
// ALU and 2,950 multiply instructions (the derivation is next to
// POSEIDON2_24_ALU in chip_smoke.py). The chain is serial by definition
// (each block absorbs into the state the previous block left): one thread
// holds the 24 lanes in registers for the whole absorb, and prefetches the
// next block's words while it permutes, so device memory sees each word
// once. The grind runs one candidate a thread, from the staged base state
// in shared memory; threads stop at their first pass (atomicMin) or at
// their first candidate above the best found so far.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIDTH = 24;
constexpr int RATE = 16;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 23;
// the constant table: rc_ei (4 x 24), rc_int (23), rc_ef (4 x 24), diag (24)
constexpr int OFF_EI = 0;
constexpr int OFF_INT = HALF_FULL * WIDTH;
constexpr int OFF_EF = OFF_INT + PARTIAL;
constexpr int OFF_DIAG = OFF_EF + HALF_FULL * WIDTH;
constexpr int TABLE = OFF_DIAG + WIDTH;
constexpr int GRIND_THREADS = 128;

struct Field {
    uint32_t p;   // the prime, < 2^31
    uint32_t mu;  // p^-1 mod 2^32
    uint32_t r2;  // 2^64 mod p: mmul(x, r2) is x's Montgomery form
};

__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t s = a + b;
    return s >= p ? s - p : s;
}

// a·b·2^-32 mod p for a, b < p: t = lo(ab)·p^-1 makes t·p agree with ab in
// the low word, so ab - t·p = (hi(ab) - hi(t·p))·2^32 exactly.
__device__ __forceinline__ uint32_t mmul(uint32_t a, uint32_t b, Field f) {
    const uint64_t x = (uint64_t)a * b;
    const uint32_t t = (uint32_t)x * f.mu;
    const uint64_t u = (uint64_t)t * f.p;
    const uint32_t hi = (uint32_t)(x >> 32), uhi = (uint32_t)(u >> 32);
    return hi >= uhi ? hi - uhi : hi - uhi + f.p;
}

__device__ __forceinline__ uint32_t sbox(uint32_t x, Field f) {
    return mmul(mmul(x, x, f), x, f);
}

// M4 on each block of four, then each lane plus the sum of its position
// across the blocks (external.rs:54-75, 113).
__device__ __forceinline__ void mds_light(uint32_t (&st)[WIDTH], uint32_t p) {
#pragma unroll
    for (int c = 0; c < WIDTH; c += 4) {
        const uint32_t x0 = st[c], x1 = st[c + 1], x2 = st[c + 2], x3 = st[c + 3];
        const uint32_t t01 = madd(x0, x1, p), t23 = madd(x2, x3, p);
        const uint32_t t0123 = madd(t01, t23, p);
        const uint32_t t01123 = madd(t0123, x1, p), t01233 = madd(t0123, x3, p);
        st[c] = madd(t01123, t01, p);
        st[c + 1] = madd(t01123, madd(x2, x2, p), p);
        st[c + 2] = madd(t01233, t23, p);
        st[c + 3] = madd(t01233, madd(x0, x0, p), p);
    }
    uint32_t s[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        s[k] = st[k];
#pragma unroll
        for (int c = 4; c < WIDTH; c += 4) s[k] = madd(s[k], st[c + k], p);
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = madd(st[i], s[i & 3], p);
}

__device__ __forceinline__ void external_round(uint32_t (&st)[WIDTH],
                                               const uint32_t* rc, Field f) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = sbox(madd(st[i], rc[i], f.p), f);
    mds_light(st, f.p);
}

__device__ __forceinline__ void internal_round(uint32_t (&st)[WIDTH], uint32_t rc,
                                               const uint32_t (&diag)[WIDTH],
                                               Field f) {
    st[0] = sbox(madd(st[0], rc, f.p), f);
    // the lane sum as four interleaved partial sums (a shorter chain)
    uint32_t s0 = st[0], s1 = st[1], s2 = st[2], s3 = st[3];
#pragma unroll
    for (int i = 4; i < WIDTH; i += 4) {
        s0 = madd(s0, st[i], f.p);
        s1 = madd(s1, st[i + 1], f.p);
        s2 = madd(s2, st[i + 2], f.p);
        s3 = madd(s3, st[i + 3], f.p);
    }
    const uint32_t sum = madd(madd(s0, s1, f.p), madd(s2, s3, f.p), f.p);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = madd(sum, mmul(st[i], diag[i], f), f.p);
}

// c: the constant table (in shared memory)
__device__ void permute(uint32_t (&st)[WIDTH], const uint32_t* c, Field f) {
    mds_light(st, f.p);
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) external_round(st, c + OFF_EI + r * WIDTH, f);
    uint32_t diag[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) diag[i] = c[OFF_DIAG + i];
#pragma unroll 1
    for (int r = 0; r < PARTIAL; ++r) internal_round(st, c[OFF_INT + r], diag, f);
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) external_round(st, c + OFF_EF + r * WIDTH, f);
}

// The state after absorbing n words (duplex_challenger.rs:92-117): blocks of
// RATE words, the last one of k = n - RATE·(nb - 1) words; a block of k > 0
// words overwrites lanes 0..k-1, zeroes lanes k..RATE-1 and adds k to lane
// RATE, then the state is permuted. n = 0 is one bare permutation (a
// duplexing with an empty input buffer). One thread of the warp computes;
// the warp stages the table.
__global__ void __launch_bounds__(32)
duplex_chain_kernel(const uint32_t* __restrict__ state, const uint32_t* __restrict__ words,
                    long long n, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ table, Field f) {
    __shared__ uint32_t c[TABLE];
    for (int i = threadIdx.x; i < TABLE; i += 32) c[i] = table[i];
    __syncthreads();
    if (threadIdx.x != 0) return;
    uint32_t st[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = state[i];
    const long long nb = n > 0 ? (n + RATE - 1) / RATE : 1;
    uint32_t nxt[RATE];
#pragma unroll
    for (int i = 0; i < RATE; ++i) {
        uint32_t v = 0;
        if (i < n) v = words[i];
        nxt[i] = v;
    }
    for (long long b = 0; b < nb; ++b) {
        const long long left = n - b * RATE;
        const int k = left < RATE ? (int)left : RATE;
        if (k > 0) {
#pragma unroll
            for (int i = 0; i < RATE; ++i) st[i] = nxt[i];
            st[RATE] = madd(st[RATE], mmul((uint32_t)k, f.r2, f), f.p);
        }
        if (b + 1 < nb) {  // the next block's words, loaded during the permutation
            const uint32_t* w = words + (b + 1) * RATE;
            const long long next_left = left - RATE;
#pragma unroll
            for (int i = 0; i < RATE; ++i) {
                uint32_t v = 0;
                if (i < next_left) v = w[i];
                nxt[i] = v;
            }
        }
        permute(st, c, f);
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) out[i] = st[i];
}

// The smallest witness w in [0, p) for which the permutation of `base` with
// lane `lane` set to mont(w) gives a lane RATE - 1 (the first sample, popped
// from the end of the rate) whose standard form has the low bits of `mask`
// zero. *best holds 0xFFFFFFFF on entry and the witness on exit (still
// 0xFFFFFFFF if none exists). Thread s of the S launched takes candidates
// s, s + S, ... in order and stops at its first pass or at its first
// candidate above *best: *best only falls and is always a passing candidate
// or 0xFFFFFFFF, so every candidate below the final *best was tried and
// failed, whatever the order of the blocks.
__global__ void __launch_bounds__(GRIND_THREADS)
duplex_grind_kernel(const uint32_t* __restrict__ base, int lane, uint32_t mask,
                    const uint32_t* __restrict__ table, Field f,
                    uint32_t* __restrict__ best) {
    __shared__ uint32_t c[TABLE];
    __shared__ uint32_t b0[WIDTH];
    for (int i = threadIdx.x; i < TABLE; i += GRIND_THREADS) c[i] = table[i];
    if (threadIdx.x < WIDTH) b0[threadIdx.x] = base[threadIdx.x];
    __syncthreads();
    const uint32_t stride = gridDim.x * GRIND_THREADS;
    const volatile uint32_t* seen = best;
    for (uint32_t cand = blockIdx.x * GRIND_THREADS + threadIdx.x; cand < f.p;
         cand += stride) {
        if (cand > *seen) break;
        const uint32_t wm = mmul(cand, f.r2, f);
        uint32_t st[WIDTH];
#pragma unroll
        for (int i = 0; i < WIDTH; ++i) st[i] = i == lane ? wm : b0[i];
        permute(st, c, f);
        if ((mmul(st[RATE - 1], 1u, f) & mask) == 0) {
            atomicMin(best, cand);
            break;
        }
    }
}

bool field_ok(unsigned p, unsigned mu) {
    return p > 2 && p < (1u << 31) && (uint32_t)(p * mu) == 1u;
}

}  // namespace

extern "C" {

// state: (24,) u32 Montgomery words; words: n >= 0 of them; out: (24,), the
// state after the absorb; table: the constant table; stream: a cudaStream_t.
int poseidon2_duplex_chain(const void* state, const void* words, long long n, void* out,
                           const void* table, unsigned p, unsigned mu, unsigned r2,
                           void* stream) {
    if (n < 0 || !field_ok(p, mu)) return (int)cudaErrorInvalidValue;
    duplex_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)state, (const uint32_t*)words, n, (uint32_t*)out,
        (const uint32_t*)table, Field{p, mu, r2});
    return (int)cudaGetLastError();
}

// base: (24,) u32 Montgomery words, the staged state; best: one u32 holding
// 0xFFFFFFFF, gets the witness. About `threads` threads search,
// 0 <= lane < 16, 1 <= pow_bits <= 30.
int poseidon2_grind(const void* base, int lane, int pow_bits, int threads,
                    const void* table, unsigned p, unsigned mu, unsigned r2, void* best,
                    void* stream) {
    if (lane < 0 || lane >= RATE || pow_bits < 1 || pow_bits > 30 || threads < 1 ||
        !field_ok(p, mu))
        return (int)cudaErrorInvalidValue;
    const uint32_t mask = (1u << pow_bits) - 1;
    duplex_grind_kernel<<<(unsigned)((threads + GRIND_THREADS - 1) / GRIND_THREADS),
                          GRIND_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)base, lane, mask, (const uint32_t*)table, Field{p, mu, r2},
        (uint32_t*)best);
    return (int)cudaGetLastError();
}

}  // extern "C"
