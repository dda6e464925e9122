// K2 on Hopper: the byte-layout GF(2^8) matrix product of the erasure codec.
//
//     out[b, i, :] = XOR_j  T_ij[ data[b, j, :] ]        i < m, j < k
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/gf_pallas.py:_kernel (launched
// by _bitplane_matmul_pallas), which computes out = pack((bitmat @
// unpack(data)) & 1) for bitmat [8m, 8k] and data [B, k, L] uint8.  On the TPU
// that product rides the matrix unit; here an [8m, 8k] product is far too
// small for tensor cores, so the kernel uses lookup tables instead.  Each 8x8
// block B_ij of bitmat is a GF(2)-linear map on bytes, so T_ij[v] =
// pack(B_ij . bits(v)) is a byte table, and being linear it splits by nibble:
// T_ij[v] = T_ij[v & 15] ^ T_ij[v & 0xF0].  The wrapper
// (ceph_tpu_torch/ops/gf_pallas.py) builds those tables exactly on the host
// with four output rows per 32-bit entry (a row group), split into 16-entry
// nibble tables [ceil(m/4), k, 32] (gf_pallas.nibble_tables, the tables K3
// reads), so one lookup per nibble serves up to four parity rows.
//
// What bounds it on an H100 SXM (bytes at 3.35 TB/s, HBM3, NVIDIA data
// sheet; one 32-lane shared-memory wavefront per clock per SM at 1.98 GHz,
// 8.36e12 lookups/s, H100 white paper), counting one lookup per GF(2^8)
// byte product (B*m*k*L):
//   * the byte pool's put, data [4, 8, 131072] -> out [4, 3, 131072]:
//     5,768,704 B = 1.72 us; 12,582,912 lookups = 1.50 us; bound by bytes;
//   * the batched encode [128, 8, 131072]: 184,550,912 B = 55.1 us;
//     402,653,184 lookups = 48.2 us; bound by bytes.
// At the put shape the work is a few microseconds of latency, not a stream:
// the card must be filled at once, every load in flight before the first
// lookup, and the lookups must not queue on shared-memory bank conflicts.
//
// The design, one answer per cause:
//   * tables: the 16-entry nibble tables, 1 KiB to copy at RS(8,3) instead
//     of the byte tables' 8 KiB, laid out 256 B per data row and pair of
//     row groups in shared memory.  A warp reading one touches at most 16
//     words in 16 banks (equal words broadcast): one wavefront per lookup.  Where a pass
//     has two row groups they are paired in one 64-bit entry, so one load
//     serves eight parity rows.  A lookup's address is one byte permute: the
//     nibble, pre-shifted in its byte of the data word, replaces the low byte
//     of the row's 256-aligned table base; the table's offset rides the
//     load's immediate;
//   * loads: the block's table copy into shared memory goes out first, as
//     asynchronous copies (cp.async), then each thread issues the 8- or
//     16-byte loads of a batch of data rows (8 rows, 4 from three row groups
//     up) before its first lookup: the tables arrive ahead of the data and
//     the lookups of the first rows overlap the loads of the later ones;
//   * grid: one column tile of 128 threads per block, 8 bytes per thread
//     when 16 would leave fewer than two blocks per SM (the put shape: 512
//     blocks instead of the byte-table kernel's 128 of 256 threads), else 16
//     (the batched shape).  With 1 KiB of tables to copy a block has little
//     to amortise: one tile per block beat a wave of blocks striding over
//     the tiles at the batched shape;
//   * rows: passes of up to four row groups (16 parity rows) for any m, and
//     any k, the data walked in row batches; 64-bit offsets; the ragged edge
//     masked in the kernel (nothing is padded); vector loads and stores only
//     where L and both pointers are aligned, byte loads otherwise.
//
// Plain C interface, bound with ctypes.  The launch goes on the caller's
// stream and never synchronizes; the SM count and the shared-memory limit
// are asked once per device, so a call captured into a CUDA graph queries
// nothing.  The return value is cudaGetLastError()
// after the launches (0 = launched).  ceph_gf_bitplane_floor launches an
// empty kernel with K2's grid, block and shared memory for the same shape:
// the launch floor K2's time is measured against.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kNibWords = 32;       // per (row group, data row): lo 16, hi 16
constexpr int kSlot = 256;          // smem bytes per (pair or single, data row)
constexpr int kAlign = 256;         // table base: its low byte is the index
constexpr int kMaxDevices = 64;

int smem_bytes(int G, int k) { return kAlign + k * kSlot * ((G + 1) / 2); }

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

// 4 bytes from global memory to the shared address a, asynchronously
__device__ __forceinline__ void cp_async4(uint32_t a, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "r"(a));
    return v;
}

// BPT bytes at p into BPT/4 little-endian words: one vector load when VEC,
// else byte loads of the first `left` bytes (the rest 0)
template <int BPT, bool VEC>
__device__ __forceinline__ void load_cols(const uint8_t* p, long long left,
                                          uint32_t (&w)[BPT / 4]) {
    if constexpr (VEC && BPT == 16) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (VEC) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
        w[0] = v.x; w[1] = v.y;
    } else {
#pragma unroll
        for (int q = 0; q < BPT / 4; ++q) {
            uint32_t x = 0;
#pragma unroll
            for (int s = 0; s < 4; ++s)
                if (4 * q + s < left)
                    x |= static_cast<uint32_t>(__ldg(p + 4 * q + s)) << (8 * s);
            w[q] = x;
        }
    }
}

template <int BPT, bool VEC>
__device__ __forceinline__ void store_cols(uint8_t* o, long long left,
                                           const uint32_t (&w)[BPT / 4]) {
    if constexpr (VEC && BPT == 16) {
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else if constexpr (VEC) {
        *reinterpret_cast<uint2*>(o) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
        for (int p = 0; p < BPT; ++p)
            if (p < left)
                o[p] = static_cast<uint8_t>(w[p >> 2] >> (8 * (p & 3)));
    }
}

// acc[p] holds output rows 0..3 of column byte p in its four bytes; bytes
// `row` of acc[4q .. 4q+3] -> one word
template <int BPT>
__device__ __forceinline__ uint32_t row_word(const uint32_t (&acc)[BPT],
                                             int q, int row) {
    const uint32_t sel = static_cast<uint32_t>(row) |
                         (static_cast<uint32_t>(row + 4) << 4);
    const uint32_t lo = __byte_perm(acc[4 * q + 0], acc[4 * q + 1], sel);
    const uint32_t hi = __byte_perm(acc[4 * q + 2], acc[4 * q + 3], sel);
    return __byte_perm(lo, hi, 0x5410);
}

// One data row's words through its tables at `rb` (256-aligned shared
// address): pair q at rb + 256q, lo-nibble entry n at +8n, hi at +128 + 8n
// (64-bit: groups 2q, 2q+1); a single last group likewise at rb + 256P
// (32-bit entries, 8 bytes apart).
template <int G, int BPT>
__device__ __forceinline__ void row_lookups(uint32_t (&acc)[G][BPT],
                                            const uint32_t (&w)[BPT / 4],
                                            uint32_t rb) {
    constexpr int P = G / 2;
#pragma unroll
    for (int q = 0; q < BPT / 4; ++q) {
        // each byte's nibble times 8, in place
        const uint32_t lo = (w[q] << 3) & 0x78787878u;
        const uint32_t hi = (w[q] >> 1) & 0x78787878u;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
            const int p = 4 * q + s;
            // byte s of lo / hi as the low byte of the table base
            const uint32_t alo = __byte_perm(lo, rb, 0x7650u | s);
            const uint32_t ahi = __byte_perm(hi, rb, 0x7650u | s);
#pragma unroll
            for (int pq = 0; pq < P; ++pq) {
                const uint2 a = lds64(alo + kSlot * pq);
                const uint2 c = lds64(ahi + kSlot * pq + 128);
                acc[2 * pq][p] ^= a.x ^ c.x;
                acc[2 * pq + 1][p] ^= a.y ^ c.y;
            }
            if constexpr (G % 2)
                acc[G - 1][p] ^= lds32(alo + kSlot * P) ^
                                 lds32(ahi + kSlot * P + 128);
        }
    }
}

// G row groups in this pass; BPT column bytes per thread and data row
template <int G, int BPT, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_bitplane_kernel(const uint32_t* __restrict__ tab,   // [G][k][32] this pass
                   const uint8_t* __restrict__ data,   // [B][k][L]
                   uint8_t* __restrict__ out,          // [B][m][L]
                   int k, int m, int row0, int rows, long long L,
                   long long tiles) {
    constexpr int W = BPT / 4;
    // data rows per load batch: 8 rows of words in registers, 4 where three
    // or four row groups of accumulators already take 48-64 registers
    constexpr int RB = G <= 2 ? 8 : 4;
    constexpr int ROW = kSlot * ((G + 1) / 2);      // smem bytes per data row
    constexpr long long kTile = static_cast<long long>(kThreads) * BPT;
    extern __shared__ uint4 smem4[];
    const uint32_t raw =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
    const uint32_t base =
        (raw + kAlign - 1) & ~static_cast<uint32_t>(kAlign - 1);
    const int tid = threadIdx.x;

    // the tables go to shared memory by asynchronous copies issued before
    // the data loads, so both are in flight together: group g of row j to
    // slot g/2, half g%2 of its entries
    for (int i = tid; i < G * k * kNibWords; i += kThreads) {
        const int e = i & (kNibWords - 1);
        const int gj = i / kNibWords;
        const int g = gj / k, j = gj - g * k;
        cp_async4(base + j * ROW + (g >> 1) * kSlot + ((e & 16) << 3) +
                      8 * (e & 15) + 4 * (g & 1),
                  tab + i);
    }

    const long long b = blockIdx.x / tiles;
    const long long c0 = (blockIdx.x - b * tiles) * kTile +
                         static_cast<long long>(tid) * BPT;
    const bool live = c0 < L;
    const long long left = L - c0;
    const uint8_t* src = data + b * k * L + c0;

    uint32_t acc[G][BPT];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int p = 0; p < BPT; ++p) acc[g][p] = 0;

    for (int j0 = 0; j0 < k; j0 += RB) {
        uint32_t w[RB][W];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            if (live && j0 + r < k) {
                load_cols<BPT, VEC>(src + (j0 + r) * L, left, w[r]);
            } else {
#pragma unroll
                for (int q = 0; q < W; ++q) w[r][q] = 0;
            }
        }
        if (j0 == 0) {
            cp_async_wait_all();
            __syncthreads();
        }
        const uint32_t rb = base + static_cast<uint32_t>(j0 * ROW);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
            if (j0 + r >= k) break;
            row_lookups<G, BPT>(acc, w[r], rb + r * ROW);
        }
    }

    if (!live) return;
    uint8_t* dst = out + (b * m + row0) * L + c0;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            const int row = 4 * g + r;
            if (row >= rows) break;
            uint32_t ws[W];
#pragma unroll
            for (int q = 0; q < W; ++q) ws[q] = row_word<BPT>(acc[g], q, r);
            store_cols<BPT, VEC>(dst + row * L, left, ws);
        }
    }
}

// The launch floor: K2's grid, block and shared memory, no work.
__global__ void __launch_bounds__(kThreads) gf_bitplane_floor_kernel() {}

// the current device's SM count and shared-memory opt-in limit, asked once
struct DeviceInfo {
    int dev = -1, sms = 0, limit = 0;
};

DeviceInfo device_info() {
    static DeviceInfo cache[kMaxDevices];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) dev = 0;
    if (dev < 0 || dev >= kMaxDevices)
        return {dev, device_attr(cudaDevAttrMultiProcessorCount, 132),
                smem_limit()};
    DeviceInfo& d = cache[dev];
    if (d.sms == 0) {
        d.limit = smem_limit();
        d.dev = dev;
        d.sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
    }
    return d;
}

// 8 bytes per thread when 16 would leave fewer than two blocks per SM
int bytes_per_thread(long long B, long long L, int sms) {
    const long long tiles16 = (L + 16LL * kThreads - 1) / (16LL * kThreads);
    return B * tiles16 < 2LL * sms ? 8 : 16;
}

template <int G, int BPT, bool VEC>
cudaError_t launch_pass(bool floor, const DeviceInfo& di, const uint32_t* tab,
                        const uint8_t* data, uint8_t* out, long long B, int k,
                        int m, int row0, int rows, long long L,
                        cudaStream_t stream) {
    auto kernel = gf_bitplane_kernel<G, BPT, VEC>;
    const int smem = smem_bytes(G, k);
    // per device, the largest shared-memory size opted in so far
    static int allowed[kMaxDevices];
    const bool cached = di.dev >= 0 && di.dev < kMaxDevices;
    if (smem > 48 * 1024 && (!cached || smem > allowed[di.dev])) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                gf_bitplane_floor_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        if (cached) allowed[di.dev] = smem;
    }
    const long long tile = static_cast<long long>(kThreads) * BPT;
    const long long tiles = (L + tile - 1) / tile;
    if (B * tiles > INT_MAX) return cudaErrorInvalidConfiguration;
    const unsigned grid = static_cast<unsigned>(B * tiles);   // one tile each
    if (floor) {
        gf_bitplane_floor_kernel<<<grid, kThreads, smem, stream>>>();
    } else {
        kernel<<<grid, kThreads, smem, stream>>>(tab, data, out, k, m, row0,
                                                 rows, L, tiles);
    }
    return cudaGetLastError();
}

template <int BPT, bool VEC>
cudaError_t launch(int G, bool floor, const DeviceInfo& di,
                   const uint32_t* tab, const uint8_t* data, uint8_t* out,
                   long long B, int k, int m, int row0, int rows, long long L,
                   cudaStream_t s) {
#define K2_PASS(GG) launch_pass<GG, BPT, VEC>(floor, di, tab, data, out, B, \
                                              k, m, row0, rows, L, s)
    switch (G) {
        case 1: return K2_PASS(1);
        case 2: return K2_PASS(2);
        case 3: return K2_PASS(3);
        default: return K2_PASS(4);
    }
#undef K2_PASS
}

bool aligned(const void* p, int n) {
    return (reinterpret_cast<uintptr_t>(p) &
            static_cast<uintptr_t>(n - 1)) == 0;
}

// K2's passes (or, with floor, the empty kernel at the same launches)
int run(bool floor, const void* tab, const void* data, void* out, long long B,
        int k, int m, long long L, void* stream) {
    if (B <= 0 || k <= 0 || m <= 0 || L <= 0) return cudaErrorInvalidValue;
    if (!floor && (tab == nullptr || data == nullptr || out == nullptr))
        return cudaErrorInvalidValue;
    const DeviceInfo di = device_info();
    const int groups = (m + 3) / 4;
    const int bpt = bytes_per_thread(B, L, di.sms);
    const bool vec = L % bpt == 0 && aligned(data, bpt) && aligned(out, bpt);
    const uint32_t* t = static_cast<const uint32_t*>(tab);
    const uint8_t* d = static_cast<const uint8_t*>(data);
    uint8_t* o = static_cast<uint8_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int g0 = 0; g0 < groups;) {
        int G = groups - g0 < 4 ? groups - g0 : 4;
        while (G > 1 && smem_bytes(G, k) > di.limit) --G;
        if (smem_bytes(G, k) > di.limit) return cudaErrorInvalidValue;
        const int row0 = 4 * g0;
        const int rows = m - row0 < 4 * G ? m - row0 : 4 * G;
        const uint32_t* tp =
            floor ? nullptr : t + static_cast<long long>(g0) * k * kNibWords;
        cudaError_t e;
        if (bpt == 8)
            e = vec ? launch<8, true>(G, floor, di, tp, d, o, B, k, m, row0,
                                      rows, L, s)
                    : launch<8, false>(G, floor, di, tp, d, o, B, k, m, row0,
                                       rows, L, s);
        else
            e = vec ? launch<16, true>(G, floor, di, tp, d, o, B, k, m, row0,
                                       rows, L, s)
                    : launch<16, false>(G, floor, di, tp, d, o, B, k, m, row0,
                                        rows, L, s);
        if (e != cudaSuccess) return static_cast<int>(e);
        g0 += G;
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one pass over G row groups takes for k data rows, and the
// most a block may take on the current device (the opt-in limit).
int ceph_gf_bitplane_smem_bytes(int G, int k) { return smem_bytes(G, k); }

int ceph_gf_bitplane_smem_limit(void) { return device_info().limit; }

// tab [ceil(m/4), k, 32] uint32 (the packed tables split by nibble), data
// [B, k, L] uint8, out [B, m, L] uint8, all contiguous on the current
// device.  Row groups go in passes of up to four groups (16 rows) that fit
// in shared memory; each pass reads the data once more.
int ceph_gf_bitplane(const void* tab, const void* data, void* out,
                     long long B, int k, int m, long long L, void* stream) {
    return run(false, tab, data, out, B, k, m, L, stream);
}

// The empty kernel launched as ceph_gf_bitplane would launch K2 for data
// [B, k, L] and m output rows (data and out assumed 16-byte aligned).
int ceph_gf_bitplane_floor(long long B, int k, int m, long long L,
                           void* stream) {
    return run(true, nullptr, nullptr, nullptr, B, k, m, L, stream);
}

}  // extern "C"
