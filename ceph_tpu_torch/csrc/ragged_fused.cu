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
// engine to table lookups.  The crc is affine over GF(2) for a fixed T:
//
//     crc32(row) = L(row) ^ crc32(0^T),   L(a || b) = Z^|b|(L(a)) ^ L(b)
//
// with L the register walk from 0 without the final inversion and Z^n the
// 32x32 GF(2) operator that advances a register through n zero bytes
// (ops/gf_pallas.py builds every table below from common/crcutil.py).
//
// The design.  A block of 256 threads takes one staged block g at a time
// (grid-stride over the pool, one block per staged block while the pool is
// small) and covers each row 4096 bytes (a chunk) at a time: thread t owns
// bytes [16t, 16t + 16) of the chunk, so every warp load is 512 contiguous
// bytes.  For each data row the thread walks its 16 bytes from 0 through the
// slicing tables (Z^(15-i) L(byte i): 32 independent lookups, no serial
// chain) and XORs K2's packed parity tables (four parity rows per 32-bit
// entry) into G x 16 accumulators.  Then it transposes the accumulators to
// the parity rows' bytes, walks them the same way (the parity never leaves
// registers before its crc is taken) and stores them.  At a row's last
// chunk each thread carries its crc to the end of its warp's 512 bytes (its
// lane operator Z^(16(31-lane))), the warp XORs its lanes with shuffles, and
// eight threads per row carry the eight warp crcs to the row's end (warp
// operators, which also undo the zero padding past T) and XOR them.  A row
// longer than one chunk keeps a running crc per thread in shared memory,
// rolled over each chunk by Z^4096.
//
// Every table is GF(2)-linear in its index, so each is split into 16-entry
// nibble tables: a warp reading one touches at most 16 words in 16 banks
// (equal words broadcast), free of bank conflicts; the lane operators are
// stored lane-major, one bank per lane.  A data row's slicing entry and its
// first parity group's entry share the nibble index, so they are paired in
// one 64-bit entry and one load fetches both.  The tables are built once on
// the host and cached on the card; each block copies them into shared
// memory after issuing its first data load, at a 2 KiB-aligned base, so that
// a lookup's address is its nibble shifted and ORed into the table's base.
//
// What bounds it on an H100 SXM, at the smoke's main-path pool (41,670
// blocks of RS(4,2), T = 4096):
//   * bytes: 41,670 x 6 x 4096 B (each data byte read once, each parity byte
//     written once) + 8 B of crc per row = 1.03e9 B, 0.31 ms at 3.35 TB/s;
//   * table lookups, counted as the work needs them (one per data byte per
//     group of four parity rows, one per crc'd byte): 1.71e9 at one 32-lane
//     wavefront per clock per SM, 0.20 ms;
//   * bound: the larger, 0.31 ms, set by the bytes.
// The kernel issues more than that: two nibble lookups per byte, eight more
// per row and thread for the lane operator, a shuffle fold per row, and the
// index arithmetic of each lookup.  Issue, not bytes, sets its time
// (PERF.md has the measurements).
//
// Any T >= 1, k + m up to 20 in shared memory (passes of up to four parity
// row groups, data crcs in the first), 64-bit offsets, 16-byte loads where
// T % 16 == 0 and the pointers are aligned (byte loads otherwise), m = 0 as
// the wire's receive verify (crc32_gf2.crc32_blocks).  Plain C interface,
// bound with ctypes.  The launch goes on the caller's stream and never
// synchronizes; the occupancy, SM count and shared-memory limit are asked
// once, so a call captured into a CUDA graph queries nothing.  The return
// value is cudaGetLastError() after the launches (0 = launched).
// ceph_ragged_fused_floor launches an empty kernel with K3's grid, block
// and shared memory for the same shape: the launch floor K3's time is
// measured against.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kChunk = 16LL * kThreads;     // row bytes per step
// the host's crc tables (gf_pallas.crc_tables), in this order
constexpr int kSliceWords = 16 * 2 * 16;          // [byte i][nibble h][n]
constexpr int kLaneWords = 8 * 16 * 32;           // [nibble j][n][lane]
constexpr int kRollWords = 8 * 16;                // [nibble j][n]: Z^4096
constexpr int kCrcWords = kSliceWords + kLaneWords + kRollWords;
constexpr int kWarpOpWords = 32 * kWarps;         // [bit][warp]
constexpr int kNibWords = 32;                     // per (group, data row)
constexpr int kPairWords = 2 * kSliceWords;       // per data row, uint2
constexpr int kAlign = 2048;                      // table base alignment

__device__ __forceinline__ void copy_words(uint32_t* dst, const uint32_t* src,
                                           int n, int tid) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n / 4; i += kThreads) d[i] = __ldg(s + i);
}

// bytes [pos, pos + 16) of a T-byte row (zeros past T)
template <bool VEC>
__device__ __forceinline__ void load_piece(const uint8_t* row, long long pos,
                                           long long T, uint32_t (&w)[4]) {
    if (VEC && pos >= T) {
        w[0] = w[1] = w[2] = w[3] = 0;
        return;
    }
    load16<VEC>(row + pos, T - pos, w);
}

template <bool VEC>
__device__ __forceinline__ void store_piece(uint8_t* o, long long left,
                                            const uint32_t (&w)[4]) {
    if constexpr (VEC) {
        *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
        for (int p = 0; p < 16; ++p)
            if (p < left)
                o[p] = static_cast<uint8_t>(w[p >> 2] >> (8 * (p & 3)));
    }
}

// Table lookups on 32-bit shared-memory addresses.  Every table base is
// aligned so that a nibble index, shifted to its scale, ORs into the base:
// one shift, one AND-OR and the load, with the table's offset folded into
// the load's immediate.
__device__ __forceinline__ uint32_t lds32(uint32_t a) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
    return v;
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
    uint2 v;
    asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];"
                 : "=r"(v.x), "=r"(v.y) : "r"(a));
    return v;
}

// bits [lo, lo + 4) of v moved to bits [at, at + 4), the rest cleared
__device__ __forceinline__ uint32_t nib_at(uint32_t v, int lo, int at) {
    return (lo >= at ? v >> (lo - at) : v << (at - lo)) & (15u << at);
}

// the walk from 0 over 16 bytes: XOR of 32 nibble lookups of the slicing
// tables at sl ([byte][nibble][16] words)
__device__ __forceinline__ uint32_t seg_crc(const uint32_t (&w)[4],
                                            uint32_t sl) {
    uint32_t c = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
        const uint32_t x = w[p >> 2];
        const int b = 8 * (p & 3);
        c ^= lds32((sl | nib_at(x, b, 2)) + 128 * p) ^
             lds32((sl | nib_at(x, b + 4, 2)) + 128 * p + 64);
    }
    return c;
}

// a 32x32 GF(2) operator as eight nibble tables at t, nibble j's 16
// entries 16 x (4 << AT) bytes apart, entry n at n << AT
template <int AT>
__device__ __forceinline__ uint32_t nib_apply(uint32_t v, uint32_t t) {
    uint32_t out = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
        out ^= lds32((t | nib_at(v, 4 * j, AT)) + (16 << AT) * j);
    return out;
}

// one data row's 16 bytes: its walk from 0 (returned) and the parity tables
// XORed into acc.  The slicing entry and group 0's parity entry share each
// nibble index, so one 64-bit lookup of the row's paired table pj
// ([byte][nibble][16] x 8 bytes) fetches both; groups 1.. read their nibble
// tables at tj, gstride bytes apart.
template <int G>
__device__ __forceinline__ uint32_t crc_and_parity(
        uint32_t (&acc)[G][16], const uint32_t (&w)[4], uint32_t pj,
        uint32_t tj, int gstride) {
    uint32_t c = 0;
#pragma unroll
    for (int p = 0; p < 16; ++p) {
        const uint32_t x = w[p >> 2];
        const int b = 8 * (p & 3);
        const uint2 lo = lds64((pj | nib_at(x, b, 3)) + 256 * p);
        const uint2 hi = lds64((pj | nib_at(x, b + 4, 3)) + 256 * p + 128);
        c ^= lo.x ^ hi.x;
        acc[0][p] ^= lo.y ^ hi.y;
#pragma unroll
        for (int g = 1; g < G; ++g) {
            const uint32_t t = tj + g * gstride;
            acc[g][p] ^= lds32(t | nib_at(x, b, 2)) ^
                         lds32((t | nib_at(x, b + 4, 2)) + 64);
        }
    }
    return c;
}

// G packed parity row groups in this pass (0 = the crc leg alone)
template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
ragged_fused_kernel(const uint32_t* __restrict__ ptab,     // [G][k][32]
                    const uint32_t* __restrict__ crc_tab,  // kCrcWords
                    const uint32_t* __restrict__ warp_op,  // [32][8]
                    const uint8_t* __restrict__ pool,      // [NG][k][T]
                    uint8_t* __restrict__ parity,          // [NG][m][T]
                    long long* __restrict__ dcrc,          // [NG][k]
                    long long* __restrict__ pcrc,          // [NG][m]
                    long long NG, int k, int m, int row0, int rows,
                    long long T, uint32_t crc0, int do_dcrc) {
    extern __shared__ uint4 smem4[];
    // the tables start kAlign-aligned (smem_bytes reserves the slack), so
    // that every table base below takes its nibble index by an OR
    const uint32_t raw =
        static_cast<uint32_t>(__cvta_generic_to_shared(smem4));
    const uint32_t pad = (kAlign - (raw & (kAlign - 1))) & (kAlign - 1);
    uint32_t* smem =
        reinterpret_cast<uint32_t*>(reinterpret_cast<char*>(smem4) + pad);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int pair_words = G > 0 ? k * kPairWords : 0;
    // generic pointers, for the prologue and the per-block scratch
    uint32_t* wop = smem + kCrcWords;
    uint2* pair = reinterpret_cast<uint2*>(wop + kWarpOpWords);  // [k][512]
    uint32_t* stab = wop + kWarpOpWords + pair_words;
    const int nrows = k + rows;              // crc'd rows: data, then parity
    uint32_t* part = stab + G * k * kNibWords;      // [nrows][warp]
    uint32_t* state = part + nrows * kWarps;        // [nrows][thread]
    // shared addresses of the tables read in the loop
    const uint32_t sl = raw + pad;
    const uint32_t lop = sl + 4 * kSliceWords + 4 * lane;
    const uint32_t roll = sl + 4 * (kSliceWords + kLaneWords);
    const uint32_t pair_s = sl + 4 * (kCrcWords + kWarpOpWords);
    const uint32_t stab_s = pair_s + 4 * pair_words;
    const long long nc = (T + kChunk - 1) / kChunk;
    const long long off = 16LL * tid;
    const long long stride = gridDim.x;

    // the first piece is in flight while the tables are copied
    long long g = blockIdx.x;
    uint32_t nxt[4] = {0, 0, 0, 0};
    if (g < NG) load_piece<VEC>(pool + g * k * T, off, T, nxt);
    copy_words(smem, crc_tab, kCrcWords, tid);
    copy_words(wop, warp_op, kWarpOpWords, tid);
    if constexpr (G > 0) copy_words(stab, ptab, G * k * kNibWords, tid);
    __syncthreads();
    if constexpr (G > 0) {
        // pair[j][q] = (slicing entry q, group 0's entry of row j at the
        // same nibble index), q = 32 x byte + 16 x nibble + n
        for (int i = tid; i < k * kSliceWords; i += kThreads) {
            const int j = i / kSliceWords, q = i % kSliceWords;
            pair[i] = make_uint2(smem[q], stab[j * kNibWords + (q & 31)]);
        }
        __syncthreads();
    }

    // thread's crc v of row r at chunk c: roll it into the running crc, and
    // at the row's last chunk carry it to its warp's end and fold the warp
    auto crc_row = [&](int r, uint32_t v, long long c) {
        if (nc > 1) {
            uint32_t* st = state + r * kThreads + tid;
            if (c > 0) v ^= nib_apply<2>(*st, roll);
            if (c + 1 < nc) {
                *st = v;
                return;
            }
        }
        v = nib_apply<7>(v, lop);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
        if (lane == 0) part[r * kWarps + warp] = v;
    };

    for (; g < NG; g += stride) {
        const uint8_t* src = pool + g * k * T;
        for (long long c = 0; c < nc; ++c) {
            const long long pos = c * kChunk + off;
            uint32_t acc[G > 0 ? G : 1][16];
#pragma unroll
            for (int gg = 0; gg < G; ++gg)
#pragma unroll
                for (int p = 0; p < 16; ++p) acc[gg][p] = 0;

            for (int j = 0; j < k; ++j) {
                const uint32_t w[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
                // the next piece: the next row, the next chunk's first row,
                // or the next staged block's first row
                if (j + 1 < k)
                    load_piece<VEC>(src + (j + 1) * T, pos, T, nxt);
                else if (c + 1 < nc)
                    load_piece<VEC>(src, pos + kChunk, T, nxt);
                else if (g + stride < NG)
                    load_piece<VEC>(pool + (g + stride) * k * T, off, T, nxt);
                if constexpr (G > 0) {
                    const uint32_t s = crc_and_parity<G>(
                        acc, w, pair_s + 8 * kSliceWords * j,
                        stab_s + 4 * kNibWords * j, 4 * kNibWords * k);
                    if (do_dcrc) crc_row(j, s, c);
                } else {
                    crc_row(j, seg_crc(w, sl), c);
                }
            }

            if constexpr (G > 0) {
                uint8_t* dst = parity + (g * m + row0) * T + pos;
#pragma unroll
                for (int gg = 0; gg < G; ++gg) {
#pragma unroll
                    for (int r = 0; r < 4; ++r) {
                        const int row = 4 * gg + r;
                        if (row >= rows) break;
                        const uint32_t ws[4] = {
                            gather_row(acc[gg], 0, r), gather_row(acc[gg], 1, r),
                            gather_row(acc[gg], 2, r), gather_row(acc[gg], 3, r)};
                        crc_row(k + row, seg_crc(ws, sl), c);
                        if (pos < T) store_piece<VEC>(dst + row * T, T - pos, ws);
                    }
                }
            }
        }
        __syncthreads();

        // eight threads per row: warp w's crc through its operator, folded
        const int first = do_dcrc ? 0 : k;
        const int nwork = (nrows - first) * kWarps;
        for (int base = 0; base + (tid & ~31) < nwork; base += kThreads) {
            const int i = base + tid;
            const int r = first + i / kWarps;
            const int w = i % kWarps;
            uint32_t v = 0;
            if (i < nwork) {
                const uint32_t s = part[r * kWarps + w];
#pragma unroll
                for (int b = 0; b < 32; ++b)
                    v ^= wop[b * kWarps + w] & (0u - ((s >> b) & 1u));
            }
#pragma unroll
            for (int o = kWarps / 2; o > 0; o >>= 1)
                v ^= __shfl_xor_sync(0xFFFFFFFFu, v, o);
            if (i < nwork && w == 0) {
                const long long crc = static_cast<long long>(v ^ crc0);
                if (r < k) dcrc[g * k + r] = crc;
                else pcrc[g * m + row0 + (r - k)] = crc;
            }
        }
        __syncthreads();
    }
}

// The launch floor: K3's grid, block and shared memory, no work.
__global__ void __launch_bounds__(kThreads) ragged_fused_floor_kernel() {}

// the largest shared-memory size the floor kernel was opted in to so far
int floor_allowed = 48 * 1024;

int smem_bytes(int G, int k, int rows, long long T) {
    const int nrows = k + rows;
    return kAlign +
           (kCrcWords + kWarpOpWords + (G > 0 ? k * kPairWords : 0) +
            G * k * kNibWords + nrows * kWarps +
            (T > kChunk ? nrows * kThreads : 0)) *
               static_cast<int>(sizeof(uint32_t));
}

int cached_smem_limit() {
    static int limit = 0;
    if (limit == 0) limit = smem_limit();
    return limit;
}

// one pass of K3 (or, with floor, the empty kernel at the same grid)
template <int G, bool VEC>
cudaError_t launch_pass(bool floor, const uint32_t* ptab,
                        const uint32_t* crc_tab, const uint32_t* warp_op,
                        const uint8_t* pool,
                        uint8_t* parity, long long* dcrc, long long* pcrc,
                        long long NG, int k, int m, int row0, int rows,
                        long long T, uint32_t crc0, int do_dcrc,
                        cudaStream_t stream) {
    auto kernel = ragged_fused_kernel<G, VEC>;
    const int smem = smem_bytes(G, k, rows, T);
    // asked once per variant (and again only for a larger shared-memory
    // size), so that a call captured into a CUDA graph queries nothing
    static int allowed = 48 * 1024, cached_smem = -1, cached_per_sm = 0;
    static long long sms = 0;
    if (smem > allowed) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        allowed = smem;
    }
    if (cached_smem != smem) {
        int per_sm = 0;
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, kThreads, smem);
        if (e != cudaSuccess) return e;
        cached_smem = smem;
        cached_per_sm = per_sm;
    }
    if (sms == 0) sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
    if (cached_per_sm < 1) return cudaErrorInvalidConfiguration;
    // one block per staged block up to a full wave, then grid-stride
    long long grid = sms * cached_per_sm;
    if (grid > NG) grid = NG;
    if (grid > INT_MAX) grid = INT_MAX;
    if (floor) {
        if (smem > floor_allowed) {
            const cudaError_t e = cudaFuncSetAttribute(
                ragged_fused_floor_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess) return e;
            floor_allowed = smem;
        }
        ragged_fused_floor_kernel<<<static_cast<unsigned>(grid), kThreads,
                                    smem, stream>>>();
    } else {
        kernel<<<static_cast<unsigned>(grid), kThreads, smem, stream>>>(
            ptab, crc_tab, warp_op, pool, parity, dcrc, pcrc, NG, k, m, row0,
            rows, T, crc0, do_dcrc);
    }
    return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch(int G, bool floor, const uint32_t* ptab,
                   const uint32_t* crc_tab, const uint32_t* warp_op,
                   const uint8_t* pool,
                   uint8_t* parity, long long* dcrc, long long* pcrc,
                   long long NG, int k, int m, int row0, int rows, long long T,
                   uint32_t crc0, int do_dcrc, cudaStream_t s) {
#define K3_PASS(GG)                                                        \
    launch_pass<GG, VEC>(floor, ptab, crc_tab, warp_op, pool, parity, dcrc, \
                         pcrc, NG, k, m, row0, rows, T, crc0, do_dcrc, s)
    switch (G) {
        case 0: return K3_PASS(0);
        case 1: return K3_PASS(1);
        case 2: return K3_PASS(2);
        case 3: return K3_PASS(3);
        default: return K3_PASS(4);
    }
#undef K3_PASS
}

// K3's passes (or, with floor, the empty kernel at the same launches)
int run(bool floor, const void* ptab, const void* crc_tab,
        const void* warp_op, const void* pool, void* parity, void* dcrc,
        void* pcrc, long long NG, int k, int m, long long T,
        unsigned int crc0, void* stream) {
    if (NG <= 0 || k <= 0 || m < 0 || T <= 0) return cudaErrorInvalidValue;
    if (!floor &&
        (crc_tab == nullptr || warp_op == nullptr || pool == nullptr ||
         dcrc == nullptr ||
         (m > 0 && (ptab == nullptr || parity == nullptr || pcrc == nullptr))))
        return cudaErrorInvalidValue;
    const int groups = (m + 3) / 4;
    const bool vec = (T % 16 == 0) &&
                     (floor || (aligned16(pool) &&
                                (m == 0 || aligned16(parity))));
    const uint32_t* t = static_cast<const uint32_t*>(ptab);
    const uint32_t* ct = static_cast<const uint32_t*>(crc_tab);
    const uint32_t* wo = static_cast<const uint32_t*>(warp_op);
    const uint8_t* d = static_cast<const uint8_t*>(pool);
    uint8_t* o = static_cast<uint8_t*>(parity);
    long long* dc = static_cast<long long*>(dcrc);
    long long* pc = static_cast<long long*>(pcrc);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int limit = cached_smem_limit();
    int g0 = 0;
    do {
        int G = groups - g0 < 4 ? groups - g0 : 4;
        int rows = m - 4 * g0 < 4 * G ? m - 4 * g0 : 4 * G;
        while (G > 1 && smem_bytes(G, k, rows, T) > limit) {
            --G;
            rows = 4 * G;
        }
        if (smem_bytes(G, k, rows, T) > limit) return cudaErrorInvalidValue;
        const uint32_t* tp =
            G && !floor ? t + static_cast<long long>(g0) * k * kNibWords
                        : nullptr;
        const int do_dcrc = g0 == 0;
        const cudaError_t e =
            vec ? launch<true>(G, floor, tp, ct, wo, d, o, dc, pc, NG, k, m,
                               4 * g0, rows, T, crc0, do_dcrc, s)
                : launch<false>(G, floor, tp, ct, wo, d, o, dc, pc, NG, k, m,
                                4 * g0, rows, T, crc0, do_dcrc, s);
        if (e != cudaSuccess) return static_cast<int>(e);
        g0 += G;
    } while (g0 < groups);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one pass over G row groups (`rows` parity rows) takes for k
// data rows of T bytes, and the most a block may take on the current device.
int ceph_ragged_fused_smem_bytes(int G, int k, int rows, long long T) {
    return smem_bytes(G, k, rows, T);
}

int ceph_ragged_fused_smem_limit(void) { return cached_smem_limit(); }

// ptab [ceil(m/4), k, 32] uint32 (K2's packed tables split by nibble; NULL
// when m = 0), crc_tab [kCrcWords] and warp_op [32, 8] uint32 (the host's
// crc tables and T's warp operators), pool [NG, k, T] uint8, parity
// [NG, m, T] uint8, dcrc [NG, k] and pcrc [NG, m] int64 (NULL when m = 0),
// all contiguous on the current device; crc0 = crc32(0^T).  Parity row
// groups go in passes of up to four (16 rows); the data crcs are taken in
// the first.
int ceph_ragged_fused(const void* ptab, const void* crc_tab,
                      const void* warp_op, const void* pool, void* parity,
                      void* dcrc, void* pcrc, long long NG, int k, int m,
                      long long T, unsigned int crc0, void* stream) {
    return run(false, ptab, crc_tab, warp_op, pool, parity, dcrc, pcrc, NG,
               k, m, T, crc0, stream);
}

// The empty kernel launched as ceph_ragged_fused would launch K3 for a pool
// [NG, k, T] and m parity rows (pool and parity assumed 16-byte aligned).
int ceph_ragged_fused_floor(long long NG, int k, int m, long long T,
                            void* stream) {
    return run(true, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, NG, k, m, T, 0, stream);
}

}  // extern "C"
