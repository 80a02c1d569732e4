// The latency of a dependent instruction on this card, for the latency
// bound of the transcript's serial chains (chip_smoke.py, phase `card`,
// builds and runs it). Not a port kernel: no path of the port launches it.
//
// One warp runs two chains of dependent instructions, each timed by
// clock64() (SM cycles) and %globaltimer (nanoseconds): an add then an
// xor with the sum (an IADD3 and a LOP3 a step) and a 32 x 32 + 64-bit
// multiply-add of the previous result (one IMAD.WIDE.U32 a step). Cycles
// over steps give the cycles a dependent instruction takes; cycles over
// nanoseconds the SM clock one busy warp sees.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int UNROLL = 64;

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

// out: [cycles, ns] of the add-xor and the multiply-add chains, then one
// word a lane (the chains' results, so that nothing is dropped).
__global__ void __launch_bounds__(32)
latency_probe_kernel(uint32_t y, uint32_t z, long long reps,
                     unsigned long long* __restrict__ out) {
    uint32_t x = threadIdx.x;
    const long long c0 = clock64();
    const unsigned long long g0 = globaltimer();
    for (long long i = 0; i < reps; ++i) {
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) x = (x + y) ^ z;
    }
    const long long c1 = clock64();
    const unsigned long long g1 = globaltimer();
    uint64_t w = x;
    for (long long i = 0; i < reps; ++i) {
#pragma unroll
        for (int j = 0; j < UNROLL; ++j) w = (uint64_t)(uint32_t)w * y + w;
    }
    const long long c2 = clock64();
    const unsigned long long g2 = globaltimer();
    if (threadIdx.x == 0) {
        out[0] = c1 - c0;
        out[1] = g1 - g0;
        out[2] = c2 - c1;
        out[3] = g2 - g1;
    }
    out[4 + threadIdx.x] = w;
}

}  // namespace

extern "C" {

// out: (36,) u64 on the device; each chain runs reps·64 steps.
int latency_probe(unsigned y, unsigned z, long long reps, void* out, void* stream) {
    if (reps < 1) return (int)cudaErrorInvalidValue;
    latency_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(
        y, z, reps, (unsigned long long*)out);
    return (int)cudaGetLastError();
}

}  // extern "C"
