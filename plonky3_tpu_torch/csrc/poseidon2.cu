// The Poseidon2 duplex transcript's two kernels for Hopper (sm_90a): the
// duplex chain and the proof-of-work grind of the Poseidon2 config's
// DuplexChallenger<F, Perm24, 24, 16> (challenger/src/duplex_challenger.rs:33),
// over a 31-bit Montgomery field: KoalaBear (23 internal rounds, s-box x^3)
// or BabyBear (21 internal rounds, s-box x^7). Every kernel is a template
// on the internal rounds R and the s-box degree D; the C entries take the
// pair and launch <23, 3> or <21, 7>, and refuse any other.
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
// s-box x^D on every lane, external layer), R internal rounds (constant and
// s-box on lane 0, then sum + V_i·s_i, monty-31/src/poseidon2.rs:77-90),
// 4 external rounds. x^3 is x2·x; x^7 is x4·x3 with x2 = x·x, x3 = x2·x,
// x4 = x2·x2: four products, three deep. State words are Montgomery-form
// u32 in [0, p); a product is a 64-bit product and its Montgomery
// reduction, an add a conditional subtraction. Every result is the canonical field element,
// so any order of exact field operations gives the same bits. The table
// (hashes/poseidon2_cuda.py::kernel_table) holds the round constants and
// the diagonal in Montgomery form, then the chain's internal-round tables.
//
// The chain (`duplex_chain_kernel`) is serial by definition: each block
// absorbs into the state the previous block left. Its bound is latency:
// the depth of the function's shortest dependency graph, 402 dependent
// 32-bit instructions a KoalaBear permutation (p2_counts in chip_smoke.py,
// 392 each after the first in a chain; BabyBear's 498), times the card's
// latency of a dependent instruction. KoalaBear's graph in this kernel is
// 574 deep before its shuffles: M4, the position sum and its add (7 adds a layer, where 6
// suffice), each round constant's add on the path, and lane 0's product
// by V_0 where V_0 = -2 makes it a subtraction. One
// thread holding all 24 words would issue some 8,500 instructions a
// permutation, 31 lanes idle beside each. The design is one warp a
// chain, lane i < 24 holding state word i, so a round issues one
// instruction where a thread would issue 24:
// - an external round: each lane adds its constant and raises its word to
//   the D-th power;
//   M4 inside each group of four lanes as out_k = (x0+x1+x2+x3) + x_k +
//   2·x_{k+1} (M4 is circulant), from five shuffles; then each lane adds
//   the sum of its position over the six groups, six shuffles and a
//   tree of adds. Two dependent shuffle stages a layer.
// - the internal rounds carry no warp reduction on their critical path.
//   For i >= 1 the update x_i' = S + d_i·x_i is linear, so
//   Q_k = sum_{i>=1} d_i^k·x_i follows Q_k' = c_k·S + Q_{k+1} with
//   c_k = sum_{i>=1} d_i^k. When the internal rounds start, lane i forms
//   d_i^k·x_i for k = 0..R-1 and a reduce-scatter over the warp (31
//   shuffles) leaves Q_k in lane k. A round then is lane 0's s-box and
//   S = s + Q_0, one broadcast of S, and in every lane x' = S + d·x (lane
//   0: S + d_0·s) and Q' = c·S + (the next lane's Q); the shift of Q runs
//   a round ahead of its use, off lane 0's path. Exact field arithmetic,
//   the same bits as the sum. (Summing the 24 words by two redux.sync a
//   round instead took 10% longer.)
// - adds and products are written for latency: a + b reduced by an
//   unsigned min with a + b - p (two instructions), a Montgomery product
//   as REDC with -p^-1, whose add rides in the second wide multiply.
// - rounds are unrolled; the round constants sit in shared memory, each
//   read a round before its use.
// - the next block's words are loaded into registers (lane i < 16: word
//   i) a whole permutation before they are absorbed, so device memory
//   sees each word once and its latency hides under the permutation.
// The grind (`duplex_grind_kernel`) is throughput work, bound by the
// integer pipes: w + 1 permutations find witness w (p2_grind_bound in
// chip_smoke.py). One candidate a thread, each running the whole-state
// permutation `permute_open` from the staged base state. What it pays
// beyond the bound is the candidates past w that it tries before it can
// stop, so the grid is persistent and sized to the card
// (GRIND_BLOCKS_PER_SM blocks an SM, each staging the table once), and the
// candidates go in ascending rounds of one a thread, a round holding the
// fewest candidates that keep the pipes busy: two warps a scheduler (one
// leaves them idle between a thread's dependent instructions, more make a
// round longer than the candidates it saves). The witness's round ends
// when the thread that found it does, so the next round has started
// everywhere else: a candidate therefore also looks at *best inside its
// permutation (11 times; no look waits for a load) and is given up once it
// is above it. The internal rounds' products by the diagonal are Shoup
// products (`shoup`), lighter on the multiply pipe than `mmul`'s two wide
// products.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WIDTH = 24;
constexpr int RATE = 16;
constexpr int HALF_FULL = 4;

// The constant table of R internal rounds: rc_ei (4 x 24), rc_int (R),
// rc_ef (4 x 24), diag (24), then the chain's: d_i^k (R x 24, row k; 0 in
// column 0), c_k (24, 0 from c_R on), then the grind's: d_i in standard
// form (24) and floor(d_i·2^32 / p) (24).
template <int R>
struct Table {
    static constexpr int EI = 0;
    static constexpr int INT = HALF_FULL * WIDTH;
    static constexpr int EF = INT + R;
    static constexpr int DIAG = EF + HALF_FULL * WIDTH;
    static constexpr int POW = DIAG + WIDTH;
    static constexpr int CSUM = POW + R * WIDTH;
    static constexpr int SHOUP = CSUM + WIDTH;
    // the grind's table in shared memory: the round constants (the
    // table's first DIAG words), then the SHOUP words
    static constexpr int GRIND = DIAG + 2 * WIDTH;
};
// the grind's blocks: GRIND_THREADS threads, at most GRIND_BLOCKS_PER_SM
// resident on each SM (N, the round's size, in the note on the grind)
constexpr int GRIND_THREADS = 128;
constexpr int GRIND_BLOCKS_PER_SM = 2;
constexpr int MAX_DEVICES = 64;
// internal rounds between two looks at *best inside a candidate
constexpr int GRIND_CHECK_INTERNAL = 8;
constexpr unsigned ALL = 0xffffffffu;

struct Field {
    uint32_t p;    // the prime, < 2^31
    uint32_t nmu;  // -p^-1 mod 2^32
    uint32_t r2;   // 2^64 mod p: mmul(x, r2) is x's Montgomery form
};

// a + b mod p for a, b < p < 2^31: s - p wraps above s unless s >= p, so
// the unsigned min is the reduced sum: an add and a fused add-min, two
// dependent instructions (a compare and a select would make four).
__device__ __forceinline__ uint32_t madd(uint32_t a, uint32_t b, uint32_t p) {
    const uint32_t s = a + b;
    return min(s, s - p);
}

// a·b·2^-32 mod p for a, b < p: t = lo(ab)·(-p^-1) makes ab + t·p a
// multiple of 2^32 below 2^64, and r = (ab + t·p)/2^32 lies in [0, 2p):
// three multiplies (the add rides in the second wide one) and a min.
__device__ __forceinline__ uint32_t mmul(uint32_t a, uint32_t b, Field f) {
    const uint64_t x = (uint64_t)a * b;
    const uint32_t t = (uint32_t)x * f.nmu;
    const uint32_t r = (uint32_t)(((uint64_t)t * f.p + x) >> 32);
    return min(r, r - f.p);
}

// x·d mod p for a constant d < p (Shoup): dq = floor(d·2^32 / p) makes
// q = hi(x·dq) the quotient of x·d by p or one less, so x·d - q·p lies in
// [0, 2p). A high product and two low ones: cheaper on the multiply pipe
// than `mmul`'s two wide products. The product of a Montgomery form x and
// the standard-form d is the Montgomery form of their product.
__device__ __forceinline__ uint32_t shoup(uint32_t x, uint32_t d, uint32_t dq, uint32_t p) {
    const uint32_t q = __umulhi(x, dq);
    const uint32_t r = x * d - q * p;
    return min(r, r - p);
}

template <int D>
__device__ __forceinline__ uint32_t sbox(uint32_t x, Field f) {
    static_assert(D == 3 || D == 7, "the s-box degrees are 3 and 7");
    const uint32_t x2 = mmul(x, x, f), x3 = mmul(x2, x, f);
    if (D == 3) return x3;
    return mmul(mmul(x2, x2, f), x3, f);
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

template <int D>
__device__ __forceinline__ void external_round(uint32_t (&st)[WIDTH],
                                               const uint32_t* rc, Field f) {
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = sbox<D>(madd(st[i], rc[i], f.p), f);
    mds_light(st, f.p);
}

// Words 1..23's sum (four interleaved partial sums) and their products by
// the diagonal (d: standard form, dq: its Shoup quotients) do not wait for
// word 0's s-box: only the last add of the sum and the adds after it do.
template <int D>
__device__ __forceinline__ void internal_round(uint32_t (&st)[WIDTH], uint32_t rc,
                                               const uint32_t (&d)[WIDTH],
                                               const uint32_t (&dq)[WIDTH], Field f) {
    uint32_t s0 = st[1], s1 = st[2], s2 = st[3], s3 = st[4];
#pragma unroll
    for (int i = 5; i < WIDTH; i += 4) {
        s0 = madd(s0, st[i], f.p);
        s1 = madd(s1, st[i + 1], f.p);
        s2 = madd(s2, st[i + 2], f.p);
        if (i + 3 < WIDTH) s3 = madd(s3, st[i + 3], f.p);
    }
    const uint32_t rest = madd(madd(s0, s1, f.p), madd(s2, s3, f.p), f.p);
    st[0] = sbox<D>(madd(st[0], rc, f.p), f);
    const uint32_t sum = madd(st[0], rest, f.p);
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) st[i] = madd(sum, shoup(st[i], d[i], dq[i], f.p), f.p);
}

// The whole-state permutation in one thread, as the grind runs it for
// candidate `cand` (c: the grind's table in shared memory, laid out by
// Table<R>). Before each
// external round and every GRIND_CHECK_INTERNAL internal rounds it gives
// the candidate up if it is above `last`, a value that *best held (*best
// only falls, so the candidate is then above the final *best), and reads
// *best into `last` for the next look, so no look waits for a load.
// Returns false if the candidate was given up.
template <int R, int D>
__device__ bool permute_open(uint32_t (&st)[WIDTH], const uint32_t* c, Field f,
                             uint32_t cand, uint32_t& last, const volatile uint32_t* seen) {
    using T = Table<R>;
    mds_light(st, f.p);
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
        if (cand > last) return false;
        last = *seen;
        external_round<D>(st, c + T::EI + r * WIDTH, f);
    }
    uint32_t d[WIDTH], dq[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
        d[i] = c[T::DIAG + i];
        dq[i] = c[T::DIAG + WIDTH + i];
    }
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
        if (r % GRIND_CHECK_INTERNAL == 0) {
            if (cand > last) return false;
            last = *seen;
        }
        internal_round<D>(st, c[T::INT + r], d, dq, f);
    }
#pragma unroll 1
    for (int r = 0; r < HALF_FULL; ++r) {
        if (cand > last) return false;
        last = *seen;
        external_round<D>(st, c + T::EF + r * WIDTH, f);
    }
    return true;
}

// ---- The warp permutation: lane i < 24 holds state word i ----
//
// Lanes 24..31 compute on words no lane < 24 reads: every shuffle source
// below is a lane < 24. Their constants are 0.

// One lane's constants, loaded once a launch.
template <int R>
struct WarpConsts {
    uint32_t pow_diag[R];        // d_i^k (0 in lane 0 and lanes >= 24)
    uint32_t diag;               // d_i
    uint32_t c_lane;             // c_i: the shift register's constant
    int group, next, pos;        // the lane's group of four, x_{k+1}'s lane, k
};

// The round constants in shared memory, each row with a spare one after
// it: a round reads the next round's constant while it runs.
template <int R>
struct WarpTables {
    uint32_t rc_ext[2 * HALF_FULL + 1][32];  // [round][lane], 0 in lanes >= 24
    uint32_t rc_int[R + 1];
};

template <int R>
__device__ __forceinline__ void load_consts(WarpConsts<R>& c, WarpTables<R>& s,
                                            const uint32_t* __restrict__ t, int lane) {
    using T = Table<R>;
    static_assert(R < 32, "lane k < R holds the shift register's Q_k");
    const bool word = lane < WIDTH;
#pragma unroll
    for (int r = 0; r < HALF_FULL; ++r) {
        s.rc_ext[r][lane] = word ? t[T::EI + r * WIDTH + lane] : 0u;
        s.rc_ext[HALF_FULL + r][lane] = word ? t[T::EF + r * WIDTH + lane] : 0u;
    }
    s.rc_ext[2 * HALF_FULL][lane] = 0u;
    if (lane <= R) s.rc_int[lane] = lane < R ? t[T::INT + lane] : 0u;
#pragma unroll
    for (int k = 0; k < R; ++k) c.pow_diag[k] = word ? t[T::POW + k * WIDTH + lane] : 0u;
    c.diag = word ? t[T::DIAG + lane] : 0u;
    c.c_lane = word ? t[T::CSUM + lane] : 0u;
    c.pos = lane & 3;
    c.group = lane & ~3;
    c.next = c.group | ((lane + 1) & 3);
}

// The external layer on the lane's word.
template <int R>
__device__ __forceinline__ uint32_t layer_warp(uint32_t x, const WarpConsts<R>& c, uint32_t p) {
    const uint32_t a0 = __shfl_sync(ALL, x, c.group), a1 = __shfl_sync(ALL, x, c.group + 1),
                   a2 = __shfl_sync(ALL, x, c.group + 2), a3 = __shfl_sync(ALL, x, c.group + 3),
                   y = __shfl_sync(ALL, x, c.next);
    const uint32_t o = madd(madd(madd(a0, a1, p), madd(a2, a3, p), p),
                            madd(madd(x, y, p), y, p), p);
    uint32_t q[6];
#pragma unroll
    for (int g = 0; g < 6; ++g) q[g] = __shfl_sync(ALL, o, 4 * g + c.pos);
    const uint32_t s = madd(madd(madd(q[0], q[1], p), madd(q[2], q[3], p), p),
                            madd(q[4], q[5], p), p);
    return madd(o, s, p);
}

// HALF_FULL external rounds from row r0 of the constants.
template <int R, int D>
__device__ __forceinline__ uint32_t external_warp(uint32_t x, const WarpTables<R>& s, int r0,
                                                  const WarpConsts<R>& c, int lane, Field f) {
    uint32_t k = s.rc_ext[r0][lane];
#pragma unroll
    for (int r = r0; r < r0 + HALF_FULL; ++r) {
        const uint32_t kr = k;
        k = s.rc_ext[r + 1][lane];
        x = layer_warp(sbox<D>(madd(x, kr, f.p), f), c, f.p);
    }
    return x;
}

// One step of the reduce-scatter over v[0..2·O): a lane keeps the half of
// the indices whose bit O matches its own and adds the partner's copy.
template <int O>
__device__ __forceinline__ void scatter_step(uint32_t (&v)[32], int lane, uint32_t p) {
    const bool up = lane & O;
#pragma unroll
    for (int j = 0; j < O; ++j) {
        const uint32_t keep = up ? v[O + j] : v[j], send = up ? v[j] : v[O + j];
        v[j] = madd(keep, __shfl_xor_sync(ALL, send, O), p);
    }
}

// The R internal rounds (see the note at the top); returns the lane's word.
template <int R, int D>
__device__ __forceinline__ uint32_t internal_warp(uint32_t x, const WarpTables<R>& st,
                                                  const WarpConsts<R>& c, int lane, Field f) {
    const uint32_t p = f.p;
    // reduce-scatter of v[k] = d_i^k·x_i: lane k ends with Q_k (k < R; 0
    // above)
    uint32_t v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) v[k] = k < R ? mmul(c.pow_diag[k], x, f) : 0u;
    scatter_step<16>(v, lane, p);
    scatter_step<8>(v, lane, p);
    scatter_step<4>(v, lane, p);
    scatter_step<2>(v, lane, p);
    scatter_step<1>(v, lane, p);
    uint32_t q = v[0];  // Q_lane
    uint32_t k = st.rc_int[0];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const uint32_t kr = k;
        k = st.rc_int[r + 1];
        const uint32_t s = sbox<D>(madd(x, kr, p), f);  // lane 0: s_r
        const uint32_t S = madd(s, q, p);            // lane 0: S_r = s_r + Q_0
        const uint32_t qn = __shfl_down_sync(ALL, q, 1), Sb = __shfl_sync(ALL, S, 0);
        // lane 0 takes its own S and s: x_0' = S + d_0·s
        const uint32_t Su = lane == 0 ? S : Sb, y = lane == 0 ? s : x;
        x = madd(Su, mmul(c.diag, y, f), p);
        q = madd(mmul(c.c_lane, Su, f), qn, p);  // Q_lane' = c_lane·S + Q_{lane+1}
    }
    return x;
}

template <int R, int D>
__device__ __forceinline__ uint32_t permute_warp(uint32_t x, const WarpTables<R>& s,
                                                 const WarpConsts<R>& c, int lane, Field f) {
    x = layer_warp(x, c, f.p);
    x = external_warp<R, D>(x, s, 0, c, lane, f);
    x = internal_warp<R, D>(x, s, c, lane, f);
    return external_warp<R, D>(x, s, HALF_FULL, c, lane, f);
}

// The state after absorbing n words (duplex_challenger.rs:92-117): blocks of
// RATE words, the last one of k = n - RATE·(nb - 1) words; a block of k > 0
// words overwrites lanes 0..k-1, zeroes lanes k..RATE-1 and adds k to lane
// RATE, then the state is permuted. n = 0 is one bare permutation (a
// duplexing with an empty input buffer). One warp, lane i < 24 state word i.
template <int R, int D>
__global__ void __launch_bounds__(32)
duplex_chain_kernel(const uint32_t* __restrict__ state, const uint32_t* __restrict__ words,
                    long long n, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ table, Field f) {
    __shared__ WarpTables<R> s;
    const int lane = threadIdx.x;
    WarpConsts<R> c;
    load_consts(c, s, table, lane);
    __syncwarp();
    uint32_t x = lane < WIDTH ? state[lane] : 0u;
    const long long nb = n > 0 ? (n + RATE - 1) / RATE : 1;
    uint32_t nxt = lane < RATE && lane < n ? words[lane] : 0u;
    for (long long b = 0; b < nb; ++b) {
        const long long left = n - b * RATE;
        const int k = left < RATE ? (int)left : RATE;
        if (k > 0) {
            if (lane < RATE) x = nxt;
            if (lane == RATE) x = madd(x, mmul((uint32_t)k, f.r2, f), f.p);
        }
        if (b + 1 < nb) {  // the next block's word, loaded during the permutation
            const long long i = (b + 1) * RATE + lane;
            nxt = lane < RATE && i < n ? words[i] : 0u;
        }
        x = permute_warp<R, D>(x, s, c, lane, f);
    }
    if (lane < WIDTH) out[lane] = x;
}

// The smallest witness w in [0, p) for which the permutation of `base` with
// lane `lane` set to mont(w) gives a lane RATE - 1 (the first sample, popped
// from the end of the rate) whose standard form has the low bits of `mask`
// zero. *best holds 0xFFFFFFFF on entry and the witness on exit (still
// 0xFFFFFFFF if none exists).
//
// The grid is persistent: N = gridDim.x · GRIND_THREADS threads, all
// resident at once. Round r covers candidates [r·N, (r + 1)·N), thread s
// taking r·N + s; before each round, and at each look inside the
// permutation, a thread stops if its candidate exceeds *best as it last
// read it, and a thread whose candidate passes atomicMins it into *best
// and stops. Why the smallest passing witness wins whatever the order of
// the blocks: *best only falls, and always holds a passing candidate or
// 0xFFFFFFFF; a thread skips or gives up a candidate only when it exceeds
// a value that *best held, and so exceeds the final *best, and a thread
// that stops at a pass skips only candidates above that pass; so every
// candidate below the final *best was tried and failed. Once *best holds
// a pass of round r, no thread starts a candidate of a later round.
template <int R, int D>
__global__ void __launch_bounds__(GRIND_THREADS)
duplex_grind_kernel(const uint32_t* __restrict__ base, int lane, uint32_t mask,
                    const uint32_t* __restrict__ table, Field f,
                    uint32_t* __restrict__ best) {
    using T = Table<R>;
    __shared__ uint32_t c[T::GRIND];
    __shared__ uint32_t b0[WIDTH];
    for (int i = threadIdx.x; i < T::GRIND; i += GRIND_THREADS)
        c[i] = table[i < T::DIAG ? i : T::SHOUP + i - T::DIAG];
    if (threadIdx.x < WIDTH) b0[threadIdx.x] = base[threadIdx.x];
    __syncthreads();
    const uint32_t in_flight = gridDim.x * GRIND_THREADS;  // N, below 2^31
    const volatile uint32_t* seen = best;
    uint32_t last = *seen;  // a value *best held, read inside the last candidate
    for (uint32_t cand = blockIdx.x * GRIND_THREADS + threadIdx.x;
         cand < f.p && cand <= last; cand += in_flight) {
        const uint32_t wm = mmul(cand, f.r2, f);
        uint32_t st[WIDTH];
#pragma unroll
        for (int i = 0; i < WIDTH; ++i) st[i] = i == lane ? wm : b0[i];
        if (!permute_open<R, D>(st, c, f, cand, last, seen)) break;
        if ((mmul(st[RATE - 1], 1u, f) & mask) == 0) {
            atomicMin(best, cand);
            break;
        }
    }
}

// The grind's grid on the current device: its resident blocks an SM (the
// occupancy, at most GRIND_BLOCKS_PER_SM) times the SMs, queried once a
// device and instantiation.
template <int R, int D>
cudaError_t grind_grid(unsigned* grid) {
    static unsigned cached[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
    if (cached[dev] == 0) {
        int per_sm = 0, sms = 0;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, duplex_grind_kernel<R, D>,
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

bool field_ok(unsigned p, unsigned mu) {
    return p > 2 && p < (1u << 31) && (uint32_t)(p * mu) == 1u;
}

template <int R, int D>
int launch_chain(const void* state, const void* words, long long n, void* out,
                 const void* table, Field f, cudaStream_t stream) {
    duplex_chain_kernel<R, D><<<1, 32, 0, stream>>>(
        (const uint32_t*)state, (const uint32_t*)words, n, (uint32_t*)out,
        (const uint32_t*)table, f);
    return (int)cudaGetLastError();
}

template <int R, int D>
int launch_grind(const void* base, int lane, uint32_t mask, const void* table, Field f,
                 void* best, cudaStream_t stream) {
    unsigned grid = 0;
    const cudaError_t e = grind_grid<R, D>(&grid);
    if (e != cudaSuccess) return (int)e;
    duplex_grind_kernel<R, D><<<grid, GRIND_THREADS, 0, stream>>>(
        (const uint32_t*)base, lane, mask, (const uint32_t*)table, f, (uint32_t*)best);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// state: (24,) u32 Montgomery words; words: n >= 0 of them; out: (24,), the
// state after the absorb; table: the constant table of `rounds` internal
// rounds; (rounds, degree): (23, 3) KoalaBear or (21, 7) BabyBear; stream:
// a cudaStream_t.
int poseidon2_duplex_chain(const void* state, const void* words, long long n, void* out,
                           const void* table, unsigned p, unsigned mu, unsigned r2,
                           int rounds, int degree, void* stream) {
    if (n < 0 || !field_ok(p, mu)) return (int)cudaErrorInvalidValue;
    const Field f{p, 0u - mu, r2};
    const cudaStream_t st = (cudaStream_t)stream;
    if (rounds == 23 && degree == 3) return launch_chain<23, 3>(state, words, n, out, table, f, st);
    if (rounds == 21 && degree == 7) return launch_chain<21, 7>(state, words, n, out, table, f, st);
    return (int)cudaErrorInvalidValue;
}

// base: (24,) u32 Montgomery words, the staged state; best: one u32 holding
// 0xFFFFFFFF, gets the witness. 0 <= lane < 16, 1 <= pow_bits <= 30;
// (rounds, degree) as for the chain.
int poseidon2_grind(const void* base, int lane, int pow_bits, const void* table,
                    unsigned p, unsigned mu, unsigned r2, int rounds, int degree,
                    void* best, void* stream) {
    if (lane < 0 || lane >= RATE || pow_bits < 1 || pow_bits > 30 || !field_ok(p, mu))
        return (int)cudaErrorInvalidValue;
    const uint32_t mask = (1u << pow_bits) - 1;
    const Field f{p, 0u - mu, r2};
    const cudaStream_t st = (cudaStream_t)stream;
    if (rounds == 23 && degree == 3) return launch_grind<23, 3>(base, lane, mask, table, f, best, st);
    if (rounds == 21 && degree == 7) return launch_grind<21, 7>(base, lane, mask, table, f, best, st);
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
