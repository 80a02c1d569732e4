/* Poseidon2 permutation over a 31-bit prime field, standard-form u32
 * lanes: the host transcript's hot path (a duplex Fiat-Shamir absorb
 * chain is sequential, one permutation after another).
 *
 * A copy of plonky3_tpu/native/poseidon2.c, the same computation as
 * hashes/poseidon2.py::_permute_std (poseidon2/src/lib.rs:139 external
 * initial -> internal -> external terminal; external.rs:113 MDS-light
 * circ(2*M4, M4, ...); monty-31/src/poseidon2.rs:77-90 internal
 * J + Diag(V) with V[0] = -2 realized as part_sum - s0).
 *
 * The width must be a multiple of 4 and the s-box degree d in {3, 5, 7}.
 * Round constants and the internal diagonal come with each call in
 * standard form, so one library serves every (field, width) instance.
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static inline uint32_t addm(uint32_t a, uint32_t b, uint32_t P) {
    uint32_t s = a + b; /* a, b < P < 2^31: no u32 overflow */
    return s >= P ? s - P : s;
}

static inline uint32_t subm(uint32_t a, uint32_t b, uint32_t P) {
    return a >= b ? a - b : a + (P - b);
}

static inline uint32_t mulm(uint32_t a, uint32_t b, uint32_t P) {
    return (uint32_t)(((uint64_t)a * b) % P);
}

static inline uint32_t sbox(uint32_t x, int d, uint32_t P) {
    uint32_t x2 = mulm(x, x, P);
    if (d == 3) return mulm(x2, x, P);
    uint32_t x4 = mulm(x2, x2, P);
    if (d == 5) return mulm(x4, x, P);
    return mulm(mulm(x4, x2, P), x, P); /* d == 7 */
}

/* External linear layer: per-4-block M4 (add/double chain, Poseidon2
 * paper Appendix B) then the outer block-circulant sums. */
static void mds_light(uint32_t *st, int w, uint32_t P) {
    for (int c = 0; c < w; c += 4) {
        uint32_t x0 = st[c], x1 = st[c + 1], x2 = st[c + 2],
                 x3 = st[c + 3];
        uint32_t t01 = addm(x0, x1, P), t23 = addm(x2, x3, P);
        uint32_t t0123 = addm(t01, t23, P);
        uint32_t t01123 = addm(t0123, x1, P);
        uint32_t t01233 = addm(t0123, x3, P);
        st[c] = addm(t01123, t01, P);
        st[c + 1] = addm(t01123, addm(x2, x2, P), P);
        st[c + 2] = addm(t01233, t23, P);
        st[c + 3] = addm(t01233, addm(x0, x0, P), P);
    }
    uint32_t sums[4];
    for (int k = 0; k < 4; k++) {
        uint32_t acc = st[k];
        for (int j = 4 + k; j < w; j += 4) acc = addm(acc, st[j], P);
        sums[k] = acc;
    }
    for (int i = 0; i < w; i++) st[i] = addm(st[i], sums[i & 3], P);
}

static void permute(uint32_t *st, uint32_t P, int w, int d,
                    const uint32_t *rc_ei, int n_ei,
                    const uint32_t *rc_int, int n_int,
                    const uint32_t *rc_ef, int n_ef,
                    const uint32_t *diag) {
    mds_light(st, w, P);
    for (int r = 0; r < n_ei; r++) {
        const uint32_t *rc = rc_ei + (size_t)r * w;
        for (int i = 0; i < w; i++)
            st[i] = sbox(addm(st[i], rc[i], P), d, P);
        mds_light(st, w, P);
    }
    for (int r = 0; r < n_int; r++) {
        uint32_t s0 = sbox(addm(st[0], rc_int[r], P), d, P);
        uint64_t part = 0;
        for (int i = 1; i < w; i++) part += st[i];
        uint32_t partm = (uint32_t)(part % P);
        uint32_t full = addm(partm, s0, P);
        for (int i = 1; i < w; i++)
            st[i] = addm(full, mulm(st[i], diag[i], P), P);
        st[0] = subm(partm, s0, P); /* V[0] = -2: full - 2*s0 */
    }
    for (int r = 0; r < n_ef; r++) {
        const uint32_t *rc = rc_ef + (size_t)r * w;
        for (int i = 0; i < w; i++)
            st[i] = sbox(addm(st[i], rc[i], P), d, P);
        mds_light(st, w, P);
    }
}

/* One permutation in place. */
void p3_p2_permute(uint32_t *state, uint32_t P, int w, int d,
                   const uint32_t *rc_ei, int n_ei,
                   const uint32_t *rc_int, int n_int,
                   const uint32_t *rc_ef, int n_ef,
                   const uint32_t *diag) {
    permute(state, P, w, d, rc_ei, n_ei, rc_int, n_int, rc_ef, n_ef,
            diag);
}

/* Duplex-sponge absorb of `nblocks` FULL rate-blocks in place
 * (duplex_challenger.rs:92-117 with k == rate: overwrite the rate
 * lanes, add the length tag `rate` to state[rate], permute). */
void p3_p2_duplex_chain(uint32_t *state, const uint32_t *words,
                        size_t nblocks, uint32_t P, int w, int rate,
                        int d, const uint32_t *rc_ei, int n_ei,
                        const uint32_t *rc_int, int n_int,
                        const uint32_t *rc_ef, int n_ef,
                        const uint32_t *diag) {
    for (size_t b = 0; b < nblocks; b++) {
        memcpy(state, words + b * (size_t)rate,
               (size_t)rate * sizeof(uint32_t));
        state[rate] = addm(state[rate], (uint32_t)rate % P, P);
        permute(state, P, w, d, rc_ei, n_ei, rc_int, n_int, rc_ef,
                n_ef, diag);
    }
}
