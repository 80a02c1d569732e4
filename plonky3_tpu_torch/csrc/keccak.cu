// Keccak-f[1600] Merkle leaf sponge and 2-to-1 compressor, for Hopper (sm_90a).
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
// 2^18 rows × 39 permutations (~10^7 keccak-f of ~3,700 64-bit ops each);
// the matrix is read once (1.38 GB). Design: one thread per row, the
// 25-lane state in 64-bit registers across all blocks and all 24 unrolled
// rounds, so device memory sees only the row words and the 32-byte digest.
// Rows are strided by 4·w bytes, so this first version's loads are not
// coalesced across a warp; staging row tiles through shared memory is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int RATE = 17;

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

// The same round structure as hashes/keccak.py::keccak_f: theta, the rho-pi
// cycle from lane 1, chi, iota. Every loop is unrolled with constant
// indices so the state stays in registers.
__device__ __forceinline__ void keccak_f(uint64_t st[25]) {
    constexpr int ROTC[24] = {1,  3,  6,  10, 15, 21, 28, 36, 45, 55, 2,  14,
                              27, 41, 56, 8,  25, 43, 62, 18, 39, 61, 20, 44};
    constexpr int PILN[24] = {10, 7,  11, 17, 18, 3, 5,  16, 8,  21, 24, 4,
                              15, 23, 19, 13, 12, 2, 20, 14, 22, 9,  6,  1};
#pragma unroll
    for (int r = 0; r < 24; ++r) {
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
        st[0] ^= RC[r];
    }
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

}  // extern "C"
