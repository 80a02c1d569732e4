/* keccak-f[1600] and Keccak-256 for the host paths of plonky3_tpu_torch.
 *
 * A copy of plonky3_tpu/native/keccak.c. The card runs the wide batched
 * keccak (csrc/keccak.cu); this library serves the host tails where
 * Python and numpy per-call overhead dominates: the Fiat-Shamir
 * challenger's keccak-256 (challenger/serializing.py) and its
 * proof-of-work grind, the host keccak-f batches of the keccak sponge
 * (hashes/keccak.py), and the byte hashers' rows
 * (hashes/keccak256_mmcs.py). The byte semantics are those of the
 * reference's Keccak256Hash and PaddingFreeSponge<KeccakF, 25, 17, 4>
 * (keccak/src/lib.rs; symmetric/src/sponge.rs).
 *
 * native/__init__.py builds it with the system C compiler:
 *   cc -O3 -shared -fPIC keccak.c poseidon2.c -o <lib>.so
 */

#include <stddef.h>
#include <stdint.h>
#include <string.h>

static const uint64_t RC[24] = {
    0x0000000000000001ULL, 0x0000000000008082ULL, 0x800000000000808aULL,
    0x8000000080008000ULL, 0x000000000000808bULL, 0x0000000080000001ULL,
    0x8000000080008081ULL, 0x8000000000008009ULL, 0x000000000000008aULL,
    0x0000000000000088ULL, 0x0000000080008009ULL, 0x000000008000000aULL,
    0x000000008000808bULL, 0x800000000000008bULL, 0x8000000000008089ULL,
    0x8000000000008003ULL, 0x8000000000008002ULL, 0x8000000000000080ULL,
    0x000000000000800aULL, 0x800000008000000aULL, 0x8000000080008081ULL,
    0x8000000000008080ULL, 0x0000000080000001ULL, 0x8000000080008008ULL};

#define ROTL(x, n) (((x) << (n)) | ((x) >> (64 - (n))))

static void keccakf(uint64_t s[25]) {
  uint64_t bc[5], t;
  for (int r = 0; r < 24; r++) {
    /* theta */
    for (int i = 0; i < 5; i++)
      bc[i] = s[i] ^ s[i + 5] ^ s[i + 10] ^ s[i + 15] ^ s[i + 20];
    for (int i = 0; i < 5; i++) {
      t = bc[(i + 4) % 5] ^ ROTL(bc[(i + 1) % 5], 1);
      for (int j = 0; j < 25; j += 5) s[j + i] ^= t;
    }
    /* rho + pi */
    static const int rho[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                                45, 55, 2,  14, 27, 41, 56, 8,
                                25, 43, 62, 18, 39, 61, 20, 44};
    static const int pi[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                               8,  21, 24, 4,  15, 23, 19, 13,
                               12, 2,  20, 14, 22, 9,  6,  1};
    t = s[1];
    for (int i = 0; i < 24; i++) {
      uint64_t tmp = s[pi[i]];
      s[pi[i]] = ROTL(t, rho[i]);
      t = tmp;
    }
    /* chi */
    for (int j = 0; j < 25; j += 5) {
      uint64_t a0 = s[j], a1 = s[j + 1], a2 = s[j + 2], a3 = s[j + 3],
               a4 = s[j + 4];
      s[j] = a0 ^ (~a1 & a2);
      s[j + 1] = a1 ^ (~a2 & a3);
      s[j + 2] = a2 ^ (~a3 & a4);
      s[j + 3] = a3 ^ (~a4 & a0);
      s[j + 4] = a4 ^ (~a0 & a1);
    }
    /* iota */
    s[0] ^= RC[r];
  }
}

/* Apply keccak-f[1600] in place to n contiguous 25-lane u64 states. */
void p3_keccakf_batch(uint64_t *states, size_t n) {
  for (size_t i = 0; i < n; i++) keccakf(states + 25 * i);
}

/* Keccak-256 one-shot (original 0x01 padding, NOT sha3). */
void p3_keccak256(const uint8_t *msg, size_t len, uint8_t *out32) {
  const size_t rate = 136;
  uint64_t s[25];
  memset(s, 0, sizeof(s));
  size_t off = 0;
  while (len - off >= rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      uint64_t w;
      memcpy(&w, msg + off + 8 * i, 8);
      s[i] ^= w;
    }
    keccakf(s);
    off += rate;
  }
  uint8_t block[136];
  memset(block, 0, rate);
  memcpy(block, msg + off, len - off);
  block[len - off] ^= 0x01;
  block[rate - 1] ^= 0x80;
  for (size_t i = 0; i < rate / 8; i++) {
    uint64_t w;
    memcpy(&w, block + 8 * i, 8);
    s[i] ^= w;
  }
  keccakf(s);
  memcpy(out32, s, 32);
}

/* Keccak-256 of n equal-length rows laid out contiguously. */
void p3_keccak256_rows(const uint8_t *rows, size_t n, size_t row_len,
                       uint8_t *out) {
  for (size_t i = 0; i < n; i++)
    p3_keccak256(rows + i * row_len, row_len, out + 32 * i);
}

/* 4-way interleaved keccak-f: state laid out lane-major (S[25][4]) so
 * -O3 auto-vectorizes every op over 4 independent states. The PoW grind
 * is the hot caller. */
static void keccakf4(uint64_t S[25][4]) {
  uint64_t bc[5][4], t[4], tmp[4];
  static const int rho[24] = {1,  3,  6,  10, 15, 21, 28, 36,
                              45, 55, 2,  14, 27, 41, 56, 8,
                              25, 43, 62, 18, 39, 61, 20, 44};
  static const int pi[24] = {10, 7,  11, 17, 18, 3,  5,  16,
                             8,  21, 24, 4,  15, 23, 19, 13,
                             12, 2,  20, 14, 22, 9,  6,  1};
  for (int r = 0; r < 24; r++) {
    for (int i = 0; i < 5; i++)
      for (int j = 0; j < 4; j++)
        bc[i][j] = S[i][j] ^ S[i + 5][j] ^ S[i + 10][j] ^ S[i + 15][j] ^
                   S[i + 20][j];
    for (int i = 0; i < 5; i++) {
      for (int j = 0; j < 4; j++)
        t[j] = bc[(i + 4) % 5][j] ^ ROTL(bc[(i + 1) % 5][j], 1);
      for (int k = 0; k < 25; k += 5)
        for (int j = 0; j < 4; j++) S[k + i][j] ^= t[j];
    }
    for (int j = 0; j < 4; j++) t[j] = S[1][j];
    for (int i = 0; i < 24; i++) {
      for (int j = 0; j < 4; j++) {
        tmp[j] = S[pi[i]][j];
        S[pi[i]][j] = ROTL(t[j], rho[i]);
        t[j] = tmp[j];
      }
    }
    for (int k = 0; k < 25; k += 5) {
      uint64_t a[5][4];
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 4; j++) a[i][j] = S[k + i][j];
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 4; j++)
          S[k + i][j] = a[i][j] ^ (~a[(i + 1) % 5][j] & a[(i + 2) % 5][j]);
    }
    for (int j = 0; j < 4; j++) S[0][j] ^= RC[r];
  }
}

/* Proof-of-work grind for SerializingChallenger32 (keccak digest chain):
 * find smallest i in [0, count) with
 *   sample_bits(bits) == 0  after  keccak256(prefix || wire[i]_le)
 * where sample_bits pops bytes 31..28 of the digest as a LE u32 and masks.
 * Returns i or -1. */
static int64_t grind_scalar(const uint8_t *prefix, size_t prefix_len,
                            const uint32_t *wire, size_t count,
                            uint32_t mask);

int64_t p3_keccak256_grind(const uint8_t *prefix, size_t prefix_len,
                           const uint32_t *wire, size_t count,
                           uint32_t mask) {
  const size_t rate = 136;
  /* fast path: prefix + candidate fits one block with room for padding
   * (the Fiat-Shamir transcript case) — 4-way interleaved keccak-f */
  if (prefix_len + 4 < rate) {
    uint64_t base[17];
    memset(base, 0, sizeof(base));
    uint8_t block0[136];
    memset(block0, 0, rate);
    memcpy(block0, prefix, prefix_len);
    block0[prefix_len + 4] ^= 0x01;
    block0[rate - 1] ^= 0x80;
    memcpy(base, block0, rate);
    size_t i = 0;
    for (; i + 4 <= count; i += 4) {
      uint64_t S[25][4];
      memset(S, 0, sizeof(S));
      for (int k = 0; k < 17; k++)
        for (int j = 0; j < 4; j++) S[k][j] = base[k];
      for (int j = 0; j < 4; j++) {
        uint64_t w = (uint64_t)wire[i + j];
        size_t lane = prefix_len / 8, sh = (prefix_len % 8) * 8;
        S[lane][j] ^= w << sh;
        if (sh > 32 && lane + 1 < 17) S[lane + 1][j] ^= w >> (64 - sh);
      }
      keccakf4(S);
      for (int j = 0; j < 4; j++) {
        uint8_t d[32];
        for (int k = 0; k < 4; k++) memcpy(d + 8 * k, &S[k][j], 8);
        uint32_t v = (uint32_t)d[31] | ((uint32_t)d[30] << 8) |
                     ((uint32_t)d[29] << 16) | ((uint32_t)d[28] << 24);
        if ((v & mask) == 0) return (int64_t)(i + j);
      }
    }
    if (i < count)
      {
        int64_t r = grind_scalar(prefix, prefix_len, wire + i, count - i,
                                 mask);
        return r < 0 ? -1 : (int64_t)i + r;
      }
    return -1;
  }
  return grind_scalar(prefix, prefix_len, wire, count, mask);
}

static int64_t grind_scalar(const uint8_t *prefix, size_t prefix_len,
                            const uint32_t *wire, size_t count,
                            uint32_t mask) {
  const size_t rate = 136;
  size_t len = prefix_len + 4;
  /* precompute the state after all full blocks of the prefix */
  uint64_t base[25];
  memset(base, 0, sizeof(base));
  size_t off = 0;
  while (prefix_len - off >= rate) {
    for (size_t i = 0; i < rate / 8; i++) {
      uint64_t w;
      memcpy(&w, prefix + off + 8 * i, 8);
      base[i] ^= w;
    }
    keccakf(base);
    off += rate;
  }
  size_t tail = prefix_len - off; /* bytes of prefix in the final block */
  uint8_t block0[136];
  for (size_t i = 0; i < count; i++) {
    uint64_t s[25];
    memcpy(s, base, sizeof(s));
    memset(block0, 0, rate);
    memcpy(block0, prefix + off, tail);
    size_t p = tail;
    uint32_t w = wire[i];
    /* candidate bytes may straddle into a second block when
     * tail + 4 > rate; handle the common single-block case fast */
    if (p + 4 <= rate) {
      memcpy(block0 + p, &w, 4);
      p += 4;
      if (p < rate) {
        block0[p] ^= 0x01;
        block0[rate - 1] ^= 0x80;
        for (size_t k = 0; k < rate / 8; k++) {
          uint64_t x;
          memcpy(&x, block0 + 8 * k, 8);
          s[k] ^= x;
        }
        keccakf(s);
      } else {
        for (size_t k = 0; k < rate / 8; k++) {
          uint64_t x;
          memcpy(&x, block0 + 8 * k, 8);
          s[k] ^= x;
        }
        keccakf(s);
        uint8_t blk[136];
        memset(blk, 0, rate);
        blk[0] ^= 0x01;
        blk[rate - 1] ^= 0x80;
        for (size_t k = 0; k < rate / 8; k++) {
          uint64_t x;
          memcpy(&x, blk + 8 * k, 8);
          s[k] ^= x;
        }
        keccakf(s);
      }
    } else {
      size_t first = rate - p;
      memcpy(block0 + p, &w, first);
      for (size_t k = 0; k < rate / 8; k++) {
        uint64_t x;
        memcpy(&x, block0 + 8 * k, 8);
        s[k] ^= x;
      }
      keccakf(s);
      uint8_t blk[136];
      memset(blk, 0, rate);
      memcpy(blk, ((const uint8_t *)&w) + first, 4 - first);
      blk[4 - first] ^= 0x01;
      blk[rate - 1] ^= 0x80;
      for (size_t k = 0; k < rate / 8; k++) {
        uint64_t x;
        memcpy(&x, blk + 8 * k, 8);
        s[k] ^= x;
      }
      keccakf(s);
    }
    uint8_t d[32];
    memcpy(d, s, 32);
    uint32_t v = (uint32_t)d[31] | ((uint32_t)d[30] << 8) |
                 ((uint32_t)d[29] << 16) | ((uint32_t)d[28] << 24);
    if ((v & mask) == 0) return (int64_t)i;
  }
  return -1;
}
