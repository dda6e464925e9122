// Device helpers of K3 (ragged_fused.cu) -- the 16-byte loads and the
// accumulator transpose of its table GF(2^8) product -- and the launch-time
// queries that K2 (gf_bitplane.cu) shares with it.  Each .cu is its own
// shared library, so everything here lives in an anonymous namespace and is
// compiled into both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// 16 bytes at p into four little-endian words: one 16-byte load when VEC
// (p 16-byte aligned), else byte loads of the first `left` bytes (the rest 0)
template <bool VEC>
__device__ __forceinline__ void load16(const uint8_t* p, long long left,
                                       uint32_t (&w)[4]) {
    if constexpr (VEC) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            uint32_t x = 0;
#pragma unroll
            for (int s = 0; s < 4; ++s) {
                const int p4 = 4 * q + s;
                if (p4 < left) x |= static_cast<uint32_t>(__ldg(p + p4)) << (8 * s);
            }
            w[q] = x;
        }
    }
}

// Packed-table accumulators acc[p] hold output rows 0..3 of column byte p in
// their four bytes; bytes `row` of acc[4q .. 4q+3] -> one word (row < 4)
__device__ __forceinline__ uint32_t gather_row(const uint32_t (&acc)[16],
                                               int q, int row) {
    const uint32_t sel = static_cast<uint32_t>(row) |
                         (static_cast<uint32_t>(row + 4) << 4);
    const uint32_t lo = __byte_perm(acc[4 * q + 0], acc[4 * q + 1], sel);
    const uint32_t hi = __byte_perm(acc[4 * q + 2], acc[4 * q + 3], sel);
    return __byte_perm(lo, hi, 0x5410);
}

inline int device_attr(cudaDeviceAttr attr, int fallback) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return fallback;
    if (cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess) return fallback;
    return v;
}

inline int smem_limit() {
    return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
}

inline bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace
