// K3 on Hopper: the fused ragged encode of the wire tier — GF(2^8) parity AND
// the zlib crc32 of every data and parity row of every staged block, in one
// pass over the bytes.
//
//     parity[g, i, :] = XOR_j T_ij[ pool[g, j, :] ]                 i < m
//     dcrc[g, j]      = crc32(pool[g, j, :])                         j < k
//     pcrc[g, i]      = crc32(parity[g, i, :])   (before it is stored)
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/gf_pallas.py:_fused_kernel
// (launched by fused_ragged_matmul), which unpacks each [k, T] block to bit
// planes once and feeds both the GF(2^8) matmul and the crc's GF(2)
// contraction (crc32_gf2.crc_matrix) on the matrix unit.  Neither product
// suits tensor cores at these shapes, so K3 keeps the math but changes the
// engine: the parity is K2's byte-table product (gf_bitplane.cu, packed
// tables of four output rows per 32-bit entry, shared code in
// gf_common.cuh), and the crc is zlib's own table-driven register walk.
// The crc is affine over GF(2) for a fixed length T:
//
//     crc32(row) = L(row) ^ crc32(0^T),   L(a || b) = Z^|b|(L(a)) ^ L(b)
//
// with L the register walk from 0 without the final inversion and Z^n the
// 32x32 GF(2) operator that advances a register through n zero bytes
// (ops/crc32_gf2.py and common/crcutil.py hold the same algebra).  So each
// lane of a warp walks its own contiguous 1/32 of the row, the host hands
// every lane the operator Z^n that carries its partial crc past the bytes
// after its segment, and the warp XOR-reduces with shuffles.
//
// The design: one warp per staged block g (grid-stride over the pool); lane
// p owns columns [pS, pS + S) of every row, S = ceil(T/32), and walks them
// 16 bytes at a time.  For each 16 bytes it loads the k data rows (one
// 16-byte load each where T % 512 == 0 and the pointers are aligned, byte
// loads otherwise), advances each data row's crc register, XORs the parity
// tables into G x 16 accumulators, then transposes the accumulators to the
// parity rows' bytes, advances each parity row's crc register from those
// bytes (the parity never leaves registers before its crc is taken), and
// stores them.  The crc registers live in shared memory, one word per
// (row, thread), so any k + m up to 20 fits without spilling.  The crc walk
// is slicing-by-4 over four 1 KiB tables built in shared memory at block
// start; a lane's final shift is 32 conditional XORs of its operator's
// columns, also in shared memory (column-major by lane: conflict-free).
// More than 16 parity rows go in passes of up to four row groups; data crcs
// are taken in the first pass.  m = 0 is the crc leg alone, which serves the
// wire's receive verify (crc32_gf2.crc32_blocks, blocks viewed as an
// [N, 1, T] pool) at any block size T >= 1.  Offsets are 64-bit.
//
// What bounds it on an H100 SXM, at the smoke's main-path pool (41,093
// blocks of RS(4,2), T = 4096):
//   * bytes: 41,093 x 6 x 4096 B (each data byte read once, each parity byte
//     written once) + 8 B of crc per row = 1.01e9 B, 0.30 ms at 3.35 TB/s;
//   * shared-memory lookups: parity 41,093 x 4096 x k x ceil(m/4) = 0.67e9
//     (one lookup per data byte serves up to four parity rows) and crc
//     41,093 x 6 x 4096 = 1.01e9 (one per byte, slicing or not), 1.68e9 at
//     the 8.36e12 lookups/s of one 32-lane wavefront per clock per SM:
//     0.20 ms;
//   * bound: the larger, 0.30 ms, set by the bytes.
// Random table indices hit random banks (several wavefronts per warp
// lookup), and a lane's 16-byte loads touch 32 lines per warp instruction
// (its neighbours' segments lie S bytes away; L1 serves the rest of each
// line).  Conflict-free table layouts and staged coalesced loads are later
// work.
//
// Plain C interface, bound with ctypes.  The launch goes on the caller's
// stream and never synchronizes; the return value is cudaGetLastError() after
// the launches (0 = launched).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kWarps = 8;                          // warps (blocks g) per block
constexpr int kThreads = 32 * kWarps;
constexpr uint32_t kPoly = 0xEDB88320u;            // reflected CRC-32 (zlib)
constexpr int kCrcWords = 4 * 256;                 // slicing-by-4 tables

// one register step over a whole little-endian word (slicing-by-4)
__device__ __forceinline__ uint32_t crc_word(uint32_t c, uint32_t w,
                                             const uint32_t* t) {
    c ^= w;
    return t[768 + (c & 0xFFu)] ^ t[512 + ((c >> 8) & 0xFFu)] ^
           t[256 + ((c >> 16) & 0xFFu)] ^ t[c >> 24];
}

// advance register c over the first n (<= 16) bytes of w[0..3]
template <bool VEC>
__device__ __forceinline__ uint32_t crc16(uint32_t c, const uint32_t (&w)[4],
                                          long long n, const uint32_t* t) {
    if constexpr (VEC) {
#pragma unroll
        for (int q = 0; q < 4; ++q) c = crc_word(c, w[q], t);
    } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (4 * q + 4 <= n) {
                c = crc_word(c, w[q], t);
            } else {
#pragma unroll
                for (int s = 0; s < 4; ++s)
                    if (4 * q + s < n)
                        c = t[(c ^ (w[q] >> (8 * s))) & 0xFFu] ^ (c >> 8);
            }
        }
    }
    return c;
}

// G packed parity row groups in this pass (0 = the crc leg alone)
template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
ragged_fused_kernel(const uint32_t* __restrict__ tab,     // [G][k][256]
                    const uint32_t* __restrict__ lanemat, // [32 col][32 lane]
                    const uint8_t* __restrict__ pool,     // [NG][k][T]
                    uint8_t* __restrict__ parity,         // [NG][m][T]
                    uint32_t* __restrict__ dcrc,          // [NG][k]
                    uint32_t* __restrict__ pcrc,          // [NG][m]
                    long long NG, int k, int m, int row0, int rows,
                    long long T, uint32_t crc0, int do_dcrc) {
    extern __shared__ uint32_t smem[];
    uint32_t* stab = smem;                                // G * k * 256
    uint32_t* ctab = stab + G * k * kTableWords;          // 4 * 256
    uint32_t* smat = ctab + kCrcWords;                    // 32 * 32
    uint32_t* state = smat + 32 * 32;                     // (k + rows) * kThreads

    const int tid = threadIdx.x;
    for (int i = tid; i < G * k * kTableWords; i += kThreads) stab[i] = tab[i];
    for (int i = tid; i < 32 * 32; i += kThreads) smat[i] = lanemat[i];
    for (int v = tid; v < 256; v += kThreads) {
        uint32_t c = static_cast<uint32_t>(v);
#pragma unroll
        for (int b = 0; b < 8; ++b) c = (c >> 1) ^ (kPoly & (0u - (c & 1u)));
        ctab[v] = c;
    }
    __syncthreads();
    for (int s = 1; s < 4; ++s) {
        for (int v = tid; v < 256; v += kThreads) {
            const uint32_t c = ctab[(s - 1) * 256 + v];
            ctab[s * 256 + v] = (c >> 8) ^ ctab[c & 0xFFu];
        }
        __syncthreads();
    }

    const int lane = tid & 31;
    const int warp = tid >> 5;
    const long long S = (T + 31) / 32;
    const long long seg0 = lane * S < T ? lane * S : T;
    const long long seg1 = seg0 + S < T ? seg0 + S : T;
    const int tstride = k * kTableWords;
    const int nrows = k + rows;                  // crc registers: data, parity
    uint32_t* st = state + tid;

    for (long long g = static_cast<long long>(blockIdx.x) * kWarps + warp;
         g < NG; g += static_cast<long long>(gridDim.x) * kWarps) {
        const uint8_t* src = pool + g * k * T;
        uint8_t* dst = parity + (g * m + row0) * T;
        for (int r = 0; r < nrows; ++r) st[r * kThreads] = 0;

        for (long long c0 = seg0; c0 < seg1; c0 += 16) {
            const long long n = seg1 - c0 < 16 ? seg1 - c0 : 16;
            uint32_t acc[G > 0 ? G : 1][16];
#pragma unroll
            for (int gg = 0; gg < G; ++gg)
#pragma unroll
                for (int p = 0; p < 16; ++p) acc[gg][p] = 0;

            uint32_t nxt[4];
            load16<VEC>(src + c0, n, nxt);
            for (int j = 0; j < k; ++j) {
                const uint32_t w[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
                if (j + 1 < k) load16<VEC>(src + (j + 1) * T + c0, n, nxt);
                if (do_dcrc)
                    st[j * kThreads] = crc16<VEC>(st[j * kThreads], w, n, ctab);
                if constexpr (G > 0)
                    table_xor<G>(acc, w, stab + j * kTableWords, tstride);
            }

            if constexpr (G > 0) {
#pragma unroll
                for (int gg = 0; gg < G; ++gg) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int row = 4 * gg + r;
                        if (row >= rows) break;
                        const uint32_t ws[4] = {
                            gather_row(acc[gg], 0, r), gather_row(acc[gg], 1, r),
                            gather_row(acc[gg], 2, r), gather_row(acc[gg], 3, r)};
                        uint32_t* sr = st + (k + row) * kThreads;
                        *sr = crc16<VEC>(*sr, ws, n, ctab);
                        uint8_t* o = dst + row * T + c0;
                        if constexpr (VEC) {
                            *reinterpret_cast<uint4*>(o) =
                                make_uint4(ws[0], ws[1], ws[2], ws[3]);
                        } else {
#pragma unroll
                            for (int p = 0; p < 16; ++p)
                                if (p < n)
                                    o[p] = static_cast<uint8_t>(
                                        ws[p >> 2] >> (8 * (p & 3)));
                        }
                    }
                }
            }
        }

        // carry each lane's register past the bytes after its segment, then
        // fold the warp's 32 partial crcs into the row's crc
        for (int r = do_dcrc ? 0 : k; r < nrows; ++r) {
            const uint32_t c = st[r * kThreads];
            uint32_t v = 0;
#pragma unroll
            for (int i = 0; i < 32; ++i)
                v ^= smat[i * 32 + lane] & (0u - ((c >> i) & 1u));
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v ^= __shfl_xor_sync(0xFFFFFFFFu, v, off);
            if (lane == 0) {
                if (r < k) dcrc[g * k + r] = v ^ crc0;
                else pcrc[g * m + row0 + (r - k)] = v ^ crc0;
            }
        }
    }
}

int smem_bytes(int G, int k, int rows) {
    return (G * k * kTableWords + kCrcWords + 32 * 32 + (k + rows) * kThreads) *
           static_cast<int>(sizeof(uint32_t));
}

template <int G, bool VEC>
cudaError_t launch_pass(const uint32_t* tab, const uint32_t* lanemat,
                        const uint8_t* pool, uint8_t* parity, uint32_t* dcrc,
                        uint32_t* pcrc, long long NG, int k, int m, int row0,
                        int rows, long long T, uint32_t crc0, int do_dcrc,
                        cudaStream_t stream) {
    const int smem = smem_bytes(G, k, rows);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            ragged_fused_kernel<G, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
    }
    // resident blocks per SM, asked once per (variant, shared memory) so
    // that a call captured into a CUDA graph queries nothing
    static int cached_smem = -1, cached_per_sm = 0;
    if (cached_smem != smem) {
        int per_sm = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, ragged_fused_kernel<G, VEC>, kThreads, smem);
        if (e != cudaSuccess) return e;
        cached_smem = smem;
        cached_per_sm = per_sm;
    }
    const int per_sm = cached_per_sm;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
    const long long want = (NG + kWarps - 1) / kWarps;
    long long grid = sms * per_sm;
    if (grid > want) grid = want;
    if (grid > INT_MAX) grid = INT_MAX;
    ragged_fused_kernel<G, VEC><<<static_cast<unsigned>(grid), kThreads, smem,
                                  stream>>>(
        tab, lanemat, pool, parity, dcrc, pcrc, NG, k, m, row0, rows, T, crc0,
        do_dcrc);
    return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch(int G, const uint32_t* tab, const uint32_t* lanemat,
                   const uint8_t* pool, uint8_t* parity, uint32_t* dcrc,
                   uint32_t* pcrc, long long NG, int k, int m, int row0,
                   int rows, long long T, uint32_t crc0, int do_dcrc,
                   cudaStream_t s) {
#define K3_PASS(GG)                                                           \
    launch_pass<GG, VEC>(tab, lanemat, pool, parity, dcrc, pcrc, NG, k, m,  \
                         row0, rows, T, crc0, do_dcrc, s)
    switch (G) {
        case 0: return K3_PASS(0);
        case 1: return K3_PASS(1);
        case 2: return K3_PASS(2);
        case 3: return K3_PASS(3);
        default: return K3_PASS(4);
    }
#undef K3_PASS
}

}  // namespace

extern "C" {

// Shared memory one pass over G row groups (`rows` parity rows) takes for k
// data rows, and the most a block may take on the current device.
int ceph_ragged_fused_smem_bytes(int G, int k, int rows) {
    return smem_bytes(G, k, rows);
}

int ceph_ragged_fused_smem_limit(void) { return smem_limit(); }

// tab [ceil(m/4), k, 256] uint32 (K2's packed tables; unused when m = 0),
// lanemat [32, 32] uint32 (column i of lane p's operator Z^(T - end_p) at
// [i][p]), pool [NG, k, T] uint8, parity [NG, m, T] uint8, dcrc [NG, k] and
// pcrc [NG, m] uint32, all contiguous on the current device; crc0 =
// crc32(0^T).  Parity row groups go in passes of up to four (16 rows); the
// data crcs are taken in the first.
int ceph_ragged_fused(const void* tab, const void* lanemat, const void* pool,
                      void* parity, void* dcrc, void* pcrc, long long NG,
                      int k, int m, long long T, unsigned int crc0,
                      void* stream) {
    if (NG <= 0 || k <= 0 || m < 0 || T <= 0) return cudaErrorInvalidValue;
    const int groups = (m + 3) / 4;
    const bool vec = (T % 512 == 0) && aligned16(pool) &&
                     (m == 0 || aligned16(parity));
    const uint32_t* t = static_cast<const uint32_t*>(tab);
    const uint32_t* lm = static_cast<const uint32_t*>(lanemat);
    const uint8_t* d = static_cast<const uint8_t*>(pool);
    uint8_t* o = static_cast<uint8_t*>(parity);
    uint32_t* dc = static_cast<uint32_t*>(dcrc);
    uint32_t* pc = static_cast<uint32_t*>(pcrc);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int limit = smem_limit();
    int g0 = 0;
    do {
        int G = groups - g0 < 4 ? groups - g0 : 4;
        int rows = m - 4 * g0 < 4 * G ? m - 4 * g0 : 4 * G;
        while (G > 1 && smem_bytes(G, k, rows) > limit) {
            --G;
            rows = 4 * G;
        }
        if (smem_bytes(G, k, rows) > limit) return cudaErrorInvalidValue;
        const uint32_t* tp = t + static_cast<long long>(g0) * k * kTableWords;
        const int do_dcrc = g0 == 0;
        const cudaError_t e =
            vec ? launch<true>(G, tp, lm, d, o, dc, pc, NG, k, m, 4 * g0, rows,
                               T, crc0, do_dcrc, s)
                : launch<false>(G, tp, lm, d, o, dc, pc, NG, k, m, 4 * g0, rows,
                                T, crc0, do_dcrc, s);
        if (e != cudaSuccess) return static_cast<int>(e);
        g0 += G;
    } while (g0 < groups);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
