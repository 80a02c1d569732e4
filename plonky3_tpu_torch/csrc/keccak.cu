// Keccak-f[1600] Merkle leaf sponge, 2-to-1 compressor and Merkle ladder,
// and the transcript's keccak-256 chain and proof-of-work grind, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of plonky3_tpu/hashes/keccak_pallas.py:
// `_sponge_kernel` (with `_keccakf`, `_round`, `_rotl64`), launched by
// `_sponge_call` for `keccak_sponge_rows_pallas` and `keccak_compress_pallas`.
// Contract (PaddingFreeSponge<KeccakF, 25, 17, 4> over SerializingHasher):
// a row of w u32 words pairs into ceil(w/2) u64 lanes (lo = word 2j,
// hi = word 2j+1, an odd tail zero-padded); the lanes are absorbed in blocks
// of 17 in overwrite mode (a block of k lanes overwrites state lanes 0..k-1
// and keeps the rest), each block followed by keccak-f; the digest is state
// lanes 0..3 as 8 u32 words (lo, hi). Compression absorbs the 8 lanes of
// (left || right) as one block.
//
// Bound: integer operations. At the bench size the trace leaves alone are
// 2^18 rows × 39 permutations (~10^7 keccak-f of ~4,300 32-bit
// instructions each); the matrix is read once (1.38 GB). Design: one
// thread per row or node, the 25-lane state in 64-bit registers across
// all blocks and all 24 unrolled rounds, so device memory sees only the
// row words and the 32-byte digest. Rows are strided by 4·w bytes, so the
// sponge's loads are not coalesced across a warp; staging row tiles
// through shared memory is later work.
//
// Three Merkle kernels (the transcript's two are described further down):
// - `sponge_rows_kernel`: the leaf hash, one thread per row.
// - `compress_kernel`: one tree level, compress(left[i], right[i]); kept
//   for the level where a shorter matrix is injected.
// - `merkle_ladder_kernel` (replaces `keccak_compress_pallas`, launched
//   once per tree level): several levels of a tree in one launch. A block
//   owns a subtree of 2 × LADDER_NODES children. At a level of more
//   nodes than the block has warps, each of its LADDER_THREADS threads
//   compresses nodes t, t + LADDER_THREADS, ... (the two children of a
//   node are 64 contiguous bytes, four 16-byte loads) and writes each
//   digest to its level in device memory and to shared memory; after a
//   barrier the next level reads its children from shared memory. One
//   launch writes up to log2(LADDER_NODES) + 1 = 10 levels, so a
//   2^18-leaf tree takes two launches where `compress_kernel` took 18,
//   and its first launch (256 blocks) fits the card in one wave.
//   Every level waits for the one below, so the levels near the root run
//   on one SM with a few nodes each: a node in one thread costs one
//   warp's ALU issue of a whole keccak-f (about 4,550 SASS instructions at
//   16 lanes a clock, 4.6 µs). A level of at most LADDER_WARPS nodes
//   therefore runs a node per warp (`keccak_f_warp`, one state lane per
//   thread, shuffles between them).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int RATE = 17;
// A ladder block owns a subtree of 2 * LADDER_NODES children
// (hashes/keccak_cuda.py LADDER_LOG_NODES is log2 LADDER_NODES).
constexpr int LADDER_NODES = 512;
constexpr int LADDER_THREADS = 256;
constexpr int LADDER_WARPS = LADDER_THREADS / 32;

__constant__ uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808AULL,
    0x8000000080008000ULL, 0x000000000000808BULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008AULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000AULL,
    0x000000008000808BULL, 0x800000000000008BULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800AULL, 0x800000008000000AULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL,
};

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
    return (x << r) | (x >> (64 - r));
}

// One round of keccak-f, the same structure as hashes/keccak.py::keccak_f:
// theta, the rho-pi cycle from lane 1, chi, iota with constant rc. Every
// loop is unrolled with constant indices so the state stays in registers.
__device__ __forceinline__ void keccak_round(uint64_t st[25], uint64_t rc) {
    constexpr int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
    constexpr int PILN[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                              15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
    uint64_t bc[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
        bc[i] = st[i] ^ st[i + 5] ^ st[i + 10] ^ st[i + 15] ^ st[i + 20];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
        const uint64_t t = bc[(i + 4) % 5] ^ rotl(bc[(i + 1) % 5], 1);
#pragma unroll
        for (int j = 0; j < 25; j += 5) st[j + i] ^= t;
    }
    uint64_t t = st[1];
#pragma unroll
    for (int i = 0; i < 24; ++i) {
        const int j = PILN[i];
        const uint64_t nxt = st[j];
        st[j] = rotl(t, ROTC[i]);
        t = nxt;
    }
#pragma unroll
    for (int j = 0; j < 25; j += 5) {
        uint64_t row[5];
#pragma unroll
        for (int i = 0; i < 5; ++i) row[i] = st[j + i];
#pragma unroll
        for (int i = 0; i < 5; ++i)
            st[j + i] = row[i] ^ (~row[(i + 1) % 5] & row[(i + 2) % 5]);
    }
    st[0] ^= rc;
}

// keccak-f[1600], the 24 rounds unrolled.
__device__ __forceinline__ void keccak_f(uint64_t st[25]) {
#pragma unroll
    for (int r = 0; r < 24; ++r) keccak_round(st, RC[r]);
}

__device__ __forceinline__ void write_digest(uint32_t* out, const uint64_t st[25]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = (uint32_t)st[i];
        out[2 * i + 1] = (uint32_t)(st[i] >> 32);
    }
}

__global__ void __launch_bounds__(THREADS)
sponge_rows_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                   long long h, int w) {
    const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (row >= h) return;
    const uint32_t* r = in + row * w;
    uint64_t st[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) st[i] = 0;
    const int nl = (w + 1) >> 1;
    for (int start = 0; start < nl; start += RATE) {
        const int k = min(RATE, nl - start);
#pragma unroll
        for (int i = 0; i < RATE; ++i) {
            if (i < k) {
                const int c = 2 * (start + i);
                const uint64_t lo = r[c];
                const uint64_t hi = c + 1 < w ? r[c + 1] : 0u;
                st[i] = lo | (hi << 32);
            }
        }
        keccak_f(st);
    }
    write_digest(out + row * 8, st);
}

__global__ void __launch_bounds__(THREADS)
compress_kernel(const uint32_t* __restrict__ left, const uint32_t* __restrict__ right,
                uint32_t* __restrict__ out, long long h) {
    const long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
    if (row >= h) return;
    const uint32_t* l = left + row * 8;
    const uint32_t* rr = right + row * 8;
    uint64_t st[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) st[i] = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        st[i] = (uint64_t)l[2 * i] | ((uint64_t)l[2 * i + 1] << 32);
        st[4 + i] = (uint64_t)rr[2 * i] | ((uint64_t)rr[2 * i + 1] << 32);
    }
    keccak_f(st);
    write_digest(out + row * 8, st);
}

// rho rotation of state lane x + 5y
__constant__ int RHO[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};

// One warp lane's share of `keccak_f_warp`, computed once a launch. Lane
// l = x + 5y < 25 holds state lane l; lanes 25..31 shadow lanes 0..6 (no
// lane reads them).
struct WarpLane {
    int col[4];         // its column-mates x + 5·((y + j) % 5), j = 1..4
    int xm1, xp1;       // lanes of columns x - 1 and x + 1 (its row)
    int pi0, pi1, pi2;  // the lanes pi moves to (x, y), (x + 1, y), (x + 2, y)
    int rho;            // its rho rotation mod 32
    bool rho_swap;      // rotation >= 32: the halves swap first
    uint64_t iota;      // all ones in lane 0, where iota's constant goes
};

__device__ __forceinline__ WarpLane warp_lane(int lane) {
    WarpLane w;
    const int l = lane < 25 ? lane : lane - 25;
    const int x = l % 5, y = l / 5;
#pragma unroll
    for (int j = 0; j < 4; ++j) w.col[j] = x + 5 * ((y + 1 + j) % 5);
    const int xm1 = (x + 4) % 5, xp1 = (x + 1) % 5, xp2 = (x + 2) % 5;
    w.xm1 = xm1 + 5 * y;
    w.xp1 = xp1 + 5 * y;
    // pi: B[X][Y] = rot(A[x'][y']) with (X, Y) = (y', 2x' + 3y')
    w.pi0 = (x + 3 * y) % 5 + 5 * x;
    w.pi1 = (xp1 + 3 * y) % 5 + 5 * xp1;
    w.pi2 = (xp2 + 3 * y) % 5 + 5 * xp2;
    w.rho = RHO[l] & 31;
    w.rho_swap = RHO[l] & 32;
    w.iota = lane == 0 ? ~0ULL : 0ULL;
    return w;
}

// keccak-f with the state spread over a warp (`WarpLane`). A round is three
// stages of 64-bit shuffles (two SHFL each): theta's column parity from the
// lane's four column-mates, then the parities of columns x - 1 and x + 1
// from two lanes, then, after each lane applies its own rho rotation (two
// funnel shifts after a select of the halves: no branch), the three lanes
// that pi moves to (x, y), (x + 1, y) and (x + 2, y), which chi combines:
// 9 shuffles, 18 SHFL, where gathering both parities' ten lanes at once
// would take 13. The 24 rounds are unrolled, so iota's constants, masked
// to lane 0, are constant-bank operands, not loads. A lane issues about
// 50 instructions a round where one thread with the whole state issues
// about 190, so a node takes a fraction of the time on an otherwise idle
// SM.
// Bound: latency; the function's shortest graph is 5 instructions a round
// (KECCAK_F_DEPTH in chip_smoke.py). This round's own is 7 (theta's
// rotate, rho and iota each a step of its own), and its shuffle stages
// add theirs.
__device__ __forceinline__ uint64_t keccak_f_warp(uint64_t a, const WarpLane& w) {
    constexpr unsigned ALL = 0xffffffffu;
#pragma unroll
    for (int r = 0; r < 24; ++r) {
        uint64_t c = a;
#pragma unroll
        for (int j = 0; j < 4; ++j) c ^= __shfl_sync(ALL, a, w.col[j]);
        const uint64_t cm = __shfl_sync(ALL, c, w.xm1), cp = __shfl_sync(ALL, c, w.xp1);
        const uint64_t t = a ^ cm ^ rotl(cp, 1);
        const uint32_t lo = (uint32_t)t, hi = (uint32_t)(t >> 32);
        const uint32_t l2 = w.rho_swap ? hi : lo, h2 = w.rho_swap ? lo : hi;
        const uint64_t ra = ((uint64_t)__funnelshift_l(l2, h2, w.rho) << 32) |
                            __funnelshift_l(h2, l2, w.rho);
        const uint64_t b0 = __shfl_sync(ALL, ra, w.pi0), b1 = __shfl_sync(ALL, ra, w.pi1),
                       b2 = __shfl_sync(ALL, ra, w.pi2);
        a = b0 ^ (~b1 & b2) ^ (RC[r] & w.iota);
    }
    return a;
}

// One tree node: keccak-f over the 8 lanes of its two children's 16
// words c (lane k = words 2k, 2k+1) and 17 zero lanes; d gets the digest.
__device__ __forceinline__ void compress_node(const uint4 (&c)[4], uint4 (&d)[2]) {
    uint64_t st[25];
#pragma unroll
    for (int i = 0; i < 25; ++i) st[i] = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        st[2 * k] = (uint64_t)c[k].x | ((uint64_t)c[k].y << 32);
        st[2 * k + 1] = (uint64_t)c[k].z | ((uint64_t)c[k].w << 32);
    }
    keccak_f(st);
    d[0] = make_uint4((uint32_t)st[0], (uint32_t)(st[0] >> 32), (uint32_t)st[1],
                      (uint32_t)(st[1] >> 32));
    d[1] = make_uint4((uint32_t)st[2], (uint32_t)(st[2] >> 32), (uint32_t)st[3],
                      (uint32_t)(st[3] >> 32));
}

// src: m digests (2 uint4 each), m a power of two >= 2. dst: the next
// `levels` levels, bottom-up and contiguous (m/2 nodes, then m/4, ...).
// Block b owns children [2·b·cnt0, 2·(b+1)·cnt0), cnt0 = min(LADDER_NODES,
// m/2); at level j its cnt0 >> j nodes start at node b·(cnt0 >> j) of the
// level. A level of more nodes than the block has warps runs one node a
// thread (thread t: nodes t, t + LADDER_THREADS, ...); a smaller one runs
// one node a warp (keccak_f_warp). Every thread reaches every barrier.
// at most 128 registers: two blocks an SM hold a 2^18-leaf tree's first
// launch (256 blocks) in one wave
__global__ void __launch_bounds__(LADDER_THREADS, 2)
merkle_ladder_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                     long long m, int levels) {
    // ping-pong: level j writes sh[j & 1], level j + 1 reads it
    __shared__ uint4 sh[2][LADDER_NODES][2];
    const int t = threadIdx.x;
    const int cnt0 = (int)min((long long)LADDER_NODES, m >> 1);
    const long long b = blockIdx.x;
    long long level_off = 0;  // nodes of dst before level j
    long long level_nodes = m >> 1;
    int cnt = cnt0;
    for (int j = 0; j < levels; ++j) {
        // the children of node i: 16 words, src or the previous level's sh
        const uint4* kids = j == 0 ? src + b * cnt0 * 4 : &sh[(j - 1) & 1][0][0];
        uint4* out = dst + (level_off + b * cnt) * 2;
        if (cnt <= LADDER_WARPS) {
            const int w = t >> 5, lane = t & 31;
            if (w < cnt) {  // whole warps: the shuffles see all 32 lanes
                uint64_t a = 0;
                if (lane < 8) {  // state lane `lane`: words 2·lane, 2·lane + 1
                    const uint2 v = ((const uint2*)(kids + w * 4))[lane];
                    a = (uint64_t)v.x | ((uint64_t)v.y << 32);
                }
                a = keccak_f_warp(a, warp_lane(lane));
                if (lane < 4) {
                    const uint2 d = make_uint2((uint32_t)a, (uint32_t)(a >> 32));
                    ((uint2*)(out + w * 2))[lane] = d;
                    ((uint2*)&sh[j & 1][w][0])[lane] = d;
                }
            }
        } else {
            for (int i = t; i < cnt; i += LADDER_THREADS) {
                uint4 c[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) c[k] = kids[i * 4 + k];
                uint4 d[2];
                compress_node(c, d);
                out[i * 2] = d[0];
                out[i * 2 + 1] = d[1];
                sh[j & 1][i][0] = d[0];
                sh[j & 1][i][1] = d[1];
            }
        }
        __syncthreads();
        level_off += level_nodes;
        level_nodes >>= 1;
        cnt >>= 1;
    }
}

// ---- The Fiat-Shamir transcript's keccak-256 (SerializingChallenger32) ----
//
// Not TPU kernels: their JAX counterparts are jnp code in
// plonky3_tpu/challenger/device_serializing.py (`_keccak256_words` +
// `_flush_chain`, and `_grind_search`). Keccak-256 absorbs a u32 word stream
// by xor in blocks of RATE_WORDS words (17 lanes, lane j = words 2j, 2j + 1);
// the padding is 0x01 in the word after the message and 0x80000000 xored
// into the last word of the last block (both in one word when the message
// ends one word short of a block, a fresh block when it ends on one).
//
// - `keccak256_chain_kernel`: d1 = keccak256(words), d_{i+1} = keccak256(d_i).
//   A chain is serial, so its bound is latency: n/34 + k keccak-f one
//   after another, each 24 rounds of 5 dependent instructions in the
//   function's shortest graph (KECCAK_F_DEPTH in chip_smoke.py) at the
//   card's latency of a dependent instruction. One warp, one state lane a thread
//   (`keccak_f_warp`: three shuffle stages a round, no branch, unrolled),
//   the next block's 17 lanes loaded while the current block permutes.
//   The longest call of a proof absorbs the opened values, about 310
//   blocks.
// - `keccak_grind_kernel`: the proof-of-work search, see below.

constexpr int RATE_WORDS = 34;
// the grind's blocks: GRIND_THREADS threads, at most GRIND_BLOCKS_PER_SM
// resident on each SM (the round size R in the note on the grind)
constexpr int GRIND_THREADS = 128;
constexpr int GRIND_BLOCKS_PER_SM = 1;
constexpr int MAX_DEVICES = 64;
// rounds between two looks at *best inside a candidate's keccak-f
constexpr int GRIND_CHECK_ROUNDS = 4;

// x·2^32 mod p for x < p, p < 2^31 odd: the Montgomery product of x and
// r2 = 2^64 mod p (t = lo(x·r2)·(-p^-1) makes x·r2 + t·p a multiple of
// 2^32; the quotient lies in [0, 2p)).
__device__ __forceinline__ uint32_t mont(uint32_t x, uint32_t p, uint32_t nmu, uint32_t r2) {
    const uint64_t y = (uint64_t)x * r2;
    const uint32_t t = (uint32_t)y * nmu;
    const uint32_t r = (uint32_t)(((uint64_t)t * p + y) >> 32);
    return min(r, r - p);
}

// Padding of word i of a message of n words in nb blocks.
__device__ __forceinline__ uint32_t pad_word(long long i, long long n, long long nb) {
    uint32_t v = i == n ? 1u : 0u;
    if (i == nb * RATE_WORDS - 1) v ^= 0x80000000u;
    return v;
}

// Rate lane `lane` (< RATE) of block b of the padded message: words i, i + 1
// with i = b·RATE_WORDS + 2·lane; message word `wit` (if >= 0) is `wval`.
__device__ __forceinline__ uint64_t rate_lane(const uint32_t* words, long long n,
                                              long long nb, long long b, int lane,
                                              long long wit, uint32_t wval) {
    const long long i = b * RATE_WORDS + 2 * lane;
    uint32_t lo = i < n ? (i == wit ? wval : words[i]) : 0u;
    uint32_t hi = i + 1 < n ? (i + 1 == wit ? wval : words[i + 1]) : 0u;
    lo ^= pad_word(i, n, nb);
    hi ^= pad_word(i + 1, n, nb);
    return (uint64_t)lo | ((uint64_t)hi << 32);
}

__global__ void __launch_bounds__(32)
keccak256_chain_kernel(const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
                       long long n, int k) {
    const int lane = threadIdx.x;
    const WarpLane wl = warp_lane(lane);
    const long long nb = n / RATE_WORDS + 1;
    uint64_t a = 0;
    uint64_t next = lane < RATE ? rate_lane(words, n, nb, 0, lane, -1, 0) : 0;
    for (long long b = 0; b < nb; ++b) {
        a ^= next;
        if (lane < RATE && b + 1 < nb) next = rate_lane(words, n, nb, b + 1, lane, -1, 0);
        a = keccak_f_warp(a, wl);
    }
    for (int j = 0; j < k; ++j) {
        if (lane < 4) {
            out[j * 8 + 2 * lane] = (uint32_t)a;
            out[j * 8 + 2 * lane + 1] = (uint32_t)(a >> 32);
        }
        if (j + 1 < k) {
            // keccak256 of the 8-word digest, one block: the digest in lanes
            // 0..3 where it already is, 0x01 in word 8 (lane 4), 0x80000000
            // in word 33 (lane 16)
            a = lane < 4 ? a : 0;
            if (lane == 4) a = 1;
            if (lane == 16) a = 0x8000000000000000ULL;
            a = keccak_f_warp(a, wl);
        }
    }
}

// keccak-f as the grind runs it for candidate c: a rolled loop over groups
// of GRIND_CHECK_ROUNDS unrolled rounds, so the code in flight stays in the
// instruction cache (the 24 rounds unrolled are some 4,500 instructions).
// Each group starts by giving the candidate up if it is above `last`, a
// value that *best held (*best only falls, so the candidate is then above
// the final *best), and reads *best into `last` halfway through, so the
// load's latency hides under the group's second half. Returns false if
// the candidate was given up.
__device__ __forceinline__ bool keccak_f_open(uint64_t st[25], uint32_t c, uint32_t& last,
                                              const volatile uint32_t* seen) {
    constexpr int HALF = GRIND_CHECK_ROUNDS / 2;
#pragma unroll 1
    for (int g = 0; g < 24; g += GRIND_CHECK_ROUNDS) {
        if (c > last) return false;
#pragma unroll
        for (int r = g; r < g + HALF; ++r) keccak_round(st, RC[r]);
        last = *seen;
#pragma unroll
        for (int r = g + HALF; r < g + GRIND_CHECK_ROUNDS; ++r) keccak_round(st, RC[r]);
    }
    return true;
}

// The smallest witness w in [0, p) for which keccak256(words ++ [monty(w)]),
// monty(w) = w·2^32 mod p, pops a first u32 (the byte swap of digest word 7)
// whose low pow_bits bits are zero. *best holds 0xFFFFFFFF on entry and the
// witness on exit (still 0xFFFFFFFF if none exists).
//
// Bound: integer operations, the blocks before the witness's once and w + 1
// candidates of 1 block (2 when the padding opens one; grind_bound in
// chip_smoke.py). What the kernel pays beyond it is the candidates past w
// that it tries before it can stop, so the grid is persistent and sized
// to the card: GRIND_BLOCKS_PER_SM blocks an SM, all resident at once,
// each of whose first warp absorbs the blocks before the witness's once
// and stages the tail block(s) without the witness in shared memory. A
// thread then permutes 1 or 2 blocks per candidate (25 lanes in registers:
// enough independent instructions that one warp a scheduler keeps the
// pipe busy), and forms the witness's Montgomery form by a Montgomery
// product with 2^64 mod p.
//
// Candidates go in ascending rounds of R = gridDim.x · GRIND_THREADS: round
// r covers [r·R, (r + 1)·R), thread s taking r·R + s. Before each round a
// thread stops if its candidate exceeds *best as it last read it. The
// witness's round ends when the thread that found it does, so the next
// round has started everywhere else: a candidate therefore also looks at
// *best every GRIND_CHECK_ROUNDS rounds of its keccak-f (`keccak_f_open`;
// no look waits for a load) and is given up once it is above it. A thread
// whose candidate passes atomicMins it into *best and stops. Why the smallest passing witness
// wins whatever the order of the blocks: *best only falls, and always
// holds a passing candidate or 0xFFFFFFFF; a thread skips or gives up a
// candidate only when it exceeds a value that *best held, and so exceeds
// the final *best, and a thread that stops at a pass skips only
// candidates above that pass; so every candidate below the final *best
// was tried and failed. Once *best holds a pass of round r, no thread
// starts a candidate of a later round.
__global__ void __launch_bounds__(GRIND_THREADS)
keccak_grind_kernel(const uint32_t* __restrict__ words, long long m, uint32_t mask,
                    uint32_t p, uint32_t nmu, uint32_t r2, uint32_t* __restrict__ best) {
    __shared__ uint64_t pre[25];
    __shared__ uint64_t tail[2][RATE];
    const long long n = m + 1;  // words ++ [witness]
    const long long nb = n / RATE_WORDS + 1, wb = m / RATE_WORDS;
    const int ntail = (int)(nb - wb);  // 2 when the 0x01 pad opens a block
    const int t = threadIdx.x;
    if (t < 32) {
        const WarpLane wl = warp_lane(t);
        uint64_t a = 0;
        for (long long b = 0; b < wb; ++b) {
            if (t < RATE) a ^= rate_lane(words, n, nb, b, t, m, 0);
            a = keccak_f_warp(a, wl);
        }
        if (t < 25) pre[t] = a;
        if (t < RATE)
            for (int j = 0; j < ntail; ++j) tail[j][t] = rate_lane(words, n, nb, wb + j, t, m, 0);
    }
    __syncthreads();
    const int wlane = (int)(m % RATE_WORDS) >> 1;  // the witness word's lane
    const int wshift = (int)(m & 1) * 32;          // and half
    const uint32_t in_flight = gridDim.x * GRIND_THREADS;  // R, below 2^31
    const volatile uint32_t* seen = best;
    uint32_t last = *seen;  // a value *best held, read inside the last candidate
    for (uint32_t c = blockIdx.x * GRIND_THREADS + t; c < p && c <= last; c += in_flight) {
        const uint64_t wm = (uint64_t)mont(c, p, nmu, r2) << wshift;
        uint64_t st[25];
#pragma unroll
        for (int i = 0; i < 25; ++i) st[i] = pre[i];
        bool open = true;
#pragma unroll 1
        for (int j = 0; j < ntail && open; ++j) {
#pragma unroll
            for (int i = 0; i < RATE; ++i)
                st[i] ^= tail[j][i] ^ (j == 0 && i == wlane ? wm : 0);
            open = keccak_f_open(st, c, last, seen);
        }
        if (!open) break;
        const uint32_t v = __byte_perm((uint32_t)(st[3] >> 32), 0, 0x0123);
        if ((v & mask) == 0) {
            atomicMin(best, c);
            break;
        }
    }
}

// The grind's grid on the current device: its resident blocks an SM (the
// occupancy, at most GRIND_BLOCKS_PER_SM) times the SMs, queried once a
// device.
cudaError_t grind_grid(unsigned* grid) {
    static unsigned cached[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (cached[dev] == 0) {
        int per_sm = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, keccak_grind_kernel,
                                                          GRIND_THREADS, 0);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        const int blocks = per_sm < GRIND_BLOCKS_PER_SM ? per_sm : GRIND_BLOCKS_PER_SM;
        cached[dev] = (unsigned)(blocks * sms);
    }
    *grid = cached[dev];
    return cudaSuccess;
}

unsigned blocks_for(long long h) { return (unsigned)((h + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// in: (h, w) u32 rows; out: (h, 8) u32 digests.
int keccak_sponge_rows(const void* in, void* out, long long h, int w, void* stream) {
    sponge_rows_kernel<<<blocks_for(h), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)in, (uint32_t*)out, h, w);
    return (int)cudaGetLastError();
}

// left, right, out: (h, 8) u32 digests.
int keccak_compress(const void* left, const void* right, void* out, long long h,
                    void* stream) {
    compress_kernel<<<blocks_for(h), THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)left, (const uint32_t*)right, (uint32_t*)out, h);
    return (int)cudaGetLastError();
}

// src: (m, 8) u32 digests, 16-byte aligned; dst: the next `levels` levels,
// (m - (m >> levels), 8) u32. m is a power of two; a block covers at most
// log2(LADDER_NODES) + 1 levels.
int keccak_merkle_ladder(const void* src, void* dst, long long m, int levels,
                         void* stream) {
    const long long cnt0 = m / 2 < LADDER_NODES ? m / 2 : LADDER_NODES;
    if (m < 2 || levels < 1 || levels > 31 || (cnt0 >> (levels - 1)) < 1)
        return (int)cudaErrorInvalidValue;
    merkle_ladder_kernel<<<(unsigned)(m / 2 / cnt0), LADDER_THREADS, 0,
                           (cudaStream_t)stream>>>((const uint4*)src, (uint4*)dst,
                                                   m, levels);
    return (int)cudaGetLastError();
}

// words: n >= 0 u32 words; out: (k, 8) u32, the chain of k >= 1 digests.
int keccak256_chain(const void* words, void* out, long long n, int k, void* stream) {
    if (n < 0 || k < 1) return (int)cudaErrorInvalidValue;
    keccak256_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const uint32_t*)words,
                                                             (uint32_t*)out, n, k);
    return (int)cudaGetLastError();
}

// words: m >= 0 u32 words; best: one u32 holding 0xFFFFFFFF, gets the
// witness. 1 <= pow_bits <= 31, p < 2^31 odd.
int keccak_grind(const void* words, long long m, int pow_bits, unsigned p, void* best,
                 void* stream) {
    if (m < 0 || pow_bits < 1 || pow_bits > 31 || p >= (1u << 31) || p < 3 || !(p & 1))
        return (int)cudaErrorInvalidValue;
    unsigned grid = 0;
    const cudaError_t e = grind_grid(&grid);
    if (e != cudaSuccess) return (int)e;
    const uint32_t mask = (uint32_t)((1ULL << pow_bits) - 1);
    uint32_t inv = p;  // p^-1 mod 2^32 by Newton's iteration (3, 6, 12, 24, 48 bits)
    for (int i = 0; i < 4; ++i) inv *= 2u - p * inv;
    const uint32_t r = (uint32_t)((1ULL << 32) % p);
    const uint32_t r2 = (uint32_t)((uint64_t)r * r % p);
    keccak_grind_kernel<<<grid, GRIND_THREADS, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)words, m, mask, p, 0u - inv, r2, (uint32_t*)best);
    return (int)cudaGetLastError();
}

}  // extern "C"
