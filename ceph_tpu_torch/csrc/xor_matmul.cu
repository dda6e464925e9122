// K1 on Hopper: the batched masked region-XOR, a GF(2) bit-matrix product
// over int32 plane words.
//
//     out[b, r, w] = XOR_c ( masks[b or 0, r, c] & words[b, c, w] )
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/xor_kernel.py:76 (_kernel, body
// _combine, launched by _xor_matmul_pallas).  Every int32 word carries 32
// independent GF(2) lanes; the masks are data (0 or -1, one per bit-matrix
// entry), so a new erasure signature reuses the same kernel, and a mask batch
// of B gives every stripe of a recovery batch its own signature.  XOR is
// exact and associative: any order of the contraction gives the same bits.
//
// What bounds it on an H100 SXM:
//   * wide shapes, bytes.  The RS(8,3) encode [512, 64, 4096] -> 24 rows
//     moves 738,197,504 B, 0.220 ms at 3.35 TB/s (HBM3, NVIDIA data sheet);
//     its R*C*W*B = 3.22e9 mask-AND-XOR steps are one LOP3 each, 0.193 ms at
//     132 SMs x 64 INT32 lanes x 1.98 GHz (H100 white paper, data sheet), so
//     the copies and the LOP3 pipe must both stay near full at once;
//   * 4 KiB stripe units ([1..256, 64 or 88, 128]), latency over the launch
//     floor: an empty kernel at this kernel's grid and shared memory takes
//     1.2-1.4 us by graph replay (kernel_timing.py --kernel k1), against a
//     byte bound of 0.02-3.4 us.  Above the floor sit a block's entry, the
//     copy of its slab and masks, its contraction on one SM, and the store.
// Staging the words with cp.async copies issued by every thread lost to the
// first port's direct 16-byte loads at wide W: the warps that contract also
// issued the copies, and the copies' issue stalled their LOP3 stream; at
// 4 KiB units the issue of a thread's slab and mask copies, not their
// flight, kept the first XOR waiting (clock64 stamps in a development
// build).
//
// The design, one answer per cause:
//   * the TMA unit moves the words.  On the 16-byte path thread 0 issues a
//     stage as cp.async.bulk copies, one a plane segment, or one for the
//     whole slab where a tile is the whole row (a 4 KiB stripe unit's
//     [C, 128] slab, 32 KiB at C = 64, is one copy), counted on the slot's
//     mbarrier.  No other thread issues a copy: the warps wait on the
//     mbarrier and contract.  At wide W a ring of two 32 KiB stages (16 KiB
//     per stripe; three 16 KiB ones where two would keep an SM from its
//     three or four blocks) keeps the next chunk in flight while one is
//     contracted, and a block barrier frees a slot before its refill;
//   * masks staged cheaply, once.  A block needs its row group's RG rows
//     of its masks, [RG, C] and contiguous: a few 16-byte cp.async copies
//     put them in scratch that is free until then (the fold's buffer, or the
//     ring's last slot, whose stage is issued after), and the block
//     transposes them to [C][RG] in shared memory by a 2-D warp x lane
//     mapping with no division.  Elsewhere (the scalar path, rows off 16
//     bytes) 4-byte copies transpose them on the way, 8 rows x 4 planes a
//     warp instruction, distinct banks at RG = 8 or 24.  A 16-byte
//     broadcast load of a mask row feeds four output rows;
//   * every thread at work at narrow W.  A block is four warps; a tile is 1,
//     2 or 4 warps wide (32 lanes x 4 words each).  Where W leaves warps
//     over, they split the contraction: warp ks XORs planes ks, ks + KS, ...
//     for the same words; the partial sums meet in shared memory after one
//     barrier, and each warp folds and stores its share of the rows;
//   * a grid that fills the card.  One block contracts one work item (b,
//     tile, row group), so a block's masks are staged once and its item
//     needs no bookkeeping; a batch too small to fill half the SMs is cut
//     into row groups of 8, so one stripe spreads over three SMs.  (A
//     persistent grid walking items, with shared masks staged once per
//     block, measured no faster at wide W and slower per stripe.);
//   * registers do the arithmetic: RG rows x VEC words of accumulators, one
//     LOP3 per mask-AND-XOR, the stage read with 16-byte shared loads; the
//     block's bookkeeping stays in 32-bit scalars, or the accumulators spill.
// Kept from the first port: the scalar path for a words or out pointer off
// 16-byte alignment or W % 4 != 0 (jerasure's w = 7 and 6 give planes of 37
// and 43 words; there every thread copies, 4 bytes at a time, exactly the
// words it contracts, zero past the edge), 64-bit offsets, the ragged edge
// masked in the kernel, the launch on the caller's stream with no
// synchronize.  Skipping all-zero mask entries is later work.
//
// The launch plan (VEC, RG, tile width, planes a stage, stages; the grid is
// one block an item) is chosen by the wrapper,
// ceph_tpu_torch/ops/xor_kernel.py:plan; this file checks it, lays out
// shared memory from it (ceph_xor_matmul_smem_bytes) and refuses a plan that
// does not fit.  Plain C interface, bound with ctypes; the return value is
// cudaGetLastError() after the launch (0 = launched).  ceph_xor_matmul_floor
// launches an empty kernel at the same grid, block and shared memory: the
// launch floor K1's time is measured against.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // four warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDevices = 64;
constexpr int kMaxStages = 4;
constexpr int kBarInts = 16;         // the ring's mbarriers, 64 bytes

// blocks an SM must hold at once: caps the registers per thread
constexpr int min_blocks(int RG, int VEC) { return RG * VEC >= 96 ? 3 : 4; }

// A plan the wrapper chose, with what follows from it.  Shared memory, in
// ints: the ring's mbarriers, the item's masks transposed [C][RG], the ring
// of stages [stages][cc][tw], and the four warps' partial sums [4][RG][32]
// [VEC] where the warps split the contraction (ks > 1).
struct Layout {
    int vec, rg, ctw, cc, stages;
    int groups, tw, ks;
    long long tiles, items;
    int mask_ints, data_ints, red_ints;
    int smem() const {
        return 4 * (kBarInts + mask_ints + data_ints + red_ints);
    }
};

bool valid_rg(int rg) { return rg == 8 || rg == 16 || rg == 24 || rg == 32; }

bool layout(long long B, int R, int C, long long W, int vec, int rg,
            int ctw, int cc, int stages, Layout& L) {
    if (B <= 0 || R <= 0 || C < 0 || W <= 0) return false;
    if ((vec != 1 && vec != 4) || !valid_rg(rg)) return false;
    if ((ctw != 1 && ctw != 2 && ctw != 4) || cc < 1 || stages < 1 ||
        stages > kMaxStages)
        return false;
    L.vec = vec; L.rg = rg; L.ctw = ctw; L.cc = cc; L.stages = stages;
    L.groups = (R + rg - 1) / rg;
    L.tw = ctw * 32 * vec;
    L.ks = kWarps / ctw;
    L.tiles = (W + L.tw - 1) / L.tw;
    L.items = B * L.tiles * L.groups;
    const long long mask = (long long)C * rg;
    const long long data = (long long)stages * cc * L.tw;
    const long long red = L.ks > 1 ? (long long)kWarps * 32 * rg * vec : 0;
    if (4 * (kBarInts + mask + data + red) > INT_MAX || L.items > INT_MAX)
        return false;
    L.mask_ints = static_cast<int>(mask);
    L.data_ints = static_cast<int>(data);
    L.red_ints = static_cast<int>(red);
    return true;
}

int device_attr(cudaDeviceAttr a, int fallback) {
    int dev = 0, v = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return fallback;
    if (cudaDeviceGetAttribute(&v, a, dev) != cudaSuccess) return fallback;
    return v;
}

// the most dynamic shared memory a block may opt in to, asked once a device
int smem_limit() {
    static int cache[kMaxDevices];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
        return device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 48 * 1024);
    if (cache[dev] == 0)
        cache[dev] = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 48 * 1024);
    return cache[dev];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// n bytes (16 or 4) from global src to shared dst, asynchronously; zero
// filled when !in (src is then any valid address and is not read)
template <int VEC>
__device__ __forceinline__ void cp_async(int* dst, const int* src, bool in) {
    if constexpr (VEC == 4) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                     :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 16 : 0)
                     : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                     :: "r"(smem_addr(dst)), "l"(src), "r"(in ? 4 : 0)
                     : "memory");
    }
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
    switch (n) {
        case 0: asm volatile("cp.async.wait_group 0;" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;" ::: "memory"); break;
    }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" :: "r"(bar), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both ends 16-byte aligned) from global src to
// shared dst by the TMA unit, counted on the mbarrier bar
__device__ __forceinline__ void bulk_copy(int* dst, const int* src,
                                          uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

template <int VEC>
__device__ __forceinline__ void load_vec(const int* p, int (&d)[VEC]) {
    if constexpr (VEC == 4) {
        const int4 v = *reinterpret_cast<const int4*>(p);
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    } else {
        d[0] = *p;
    }
}

template <int VEC>
__device__ __forceinline__ void store_vec(int* p, const int (&a)[VEC]) {
    if constexpr (VEC == 4) {
        *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
    } else {
        p[0] = a[0];
    }
}

// acc[r] ^= mrow[r] & d for one plane; mrow is 16-byte aligned in shared
// memory, so four rows come in one broadcast load
template <int RG, int VEC>
__device__ __forceinline__ void accumulate(int (&acc)[RG][VEC],
                                           const int* mrow,
                                           const int (&d)[VEC]) {
#pragma unroll
    for (int r = 0; r < RG; r += 4) {
        const int4 m = *reinterpret_cast<const int4*>(mrow + r);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
            acc[r + 0][v] ^= m.x & d[v];
            acc[r + 1][v] ^= m.y & d[v];
            acc[r + 2][v] ^= m.z & d[v];
            acc[r + 3][v] ^= m.w & d[v];
        }
    }
}

// acc += the stage's planes c = ks, ks + ks_n, ... < nc for this thread's
// words d (row stride tw), under the mask rows m (row stride RG)
template <int RG, int VEC>
__device__ __forceinline__ void contract(int (&acc)[RG][VEC], const int* d,
                                         int tw, const int* m, int ks,
                                         int ks_n, int nc) {
#pragma unroll 2
    for (int c = ks; c < nc; c += ks_n) {
        int dv[VEC];
        load_vec<VEC>(d + c * tw, dv);
        accumulate<RG, VEC>(acc, m + c * RG, dv);
    }
}

// The item's mask rows [0, RG) (live ones from src, row stride C, the rest
// zero) into dst as [C][RG], one 4-byte copy a word: each warp instruction
// takes 8 rows x 4 planes, which meet in distinct banks at RG = 8 or 24,
// with no division.  The scalar path's staging, and the fallback of the
// 16-byte one where the row block is not 16-byte aligned or does not fit.
template <int RG>
__device__ __forceinline__ void stage_masks_t(int* dst, const int* src,
                                              int live, int C, int warp,
                                              int lane) {
    const int r_lo = lane & 7, c_lo = lane >> 3;
    for (int r0 = 0; r0 < RG; r0 += 8)
        for (int c0 = 4 * warp; c0 < C; c0 += 4 * kWarps) {
            const int r = r0 + r_lo, c = c0 + c_lo;
            if (c < C)
                cp_async<1>(dst + c * RG + r,
                            r < live ? src + (long long)r * C + c : src,
                            r < live);
        }
}

// The item is contracted.  With the contraction split (ks_n > 1) every
// warp puts its partial sums in sred ([warp][RG][32][VEC]), and warp ks
// folds the ks_n partials of rows [ks, ks + 1) x RG / ks_n and stores
// them; else each thread stores its rows.
template <int RG, int VEC>
__device__ __forceinline__ void store_item(const int (&acc)[RG][VEC],
                                           int* sred, int ks, int ks_n,
                                           int ct, int ctw, int lane,
                                           bool live, int* dst, int rows,
                                           long long W) {
    if (ks_n == 1) {
        if (live) {
#pragma unroll
            for (int r = 0; r < RG; ++r)
                if (r < rows) store_vec<VEC>(dst + r * W, acc[r]);
        }
        return;
    }
    int* mine = sred + (ks * ctw + ct) * (RG * 32 * VEC) + lane * VEC;
#pragma unroll
    for (int r = 0; r < RG; ++r) store_vec<VEC>(mine + r * 32 * VEC, acc[r]);
    __syncthreads();
    const int per = RG / ks_n;
    const int* col0 = sred + ct * (RG * 32 * VEC) + lane * VEC;
    const int part = ctw * RG * 32 * VEC;       // one warp's partials
#pragma unroll 2
    for (int r = ks * per; r < (ks + 1) * per; ++r) {
        int v[kWarps][VEC];
#pragma unroll
        for (int j = 0; j < kWarps; ++j)
            if (j < ks_n) load_vec<VEC>(col0 + j * part + r * 32 * VEC, v[j]);
#pragma unroll
        for (int j = 1; j < kWarps; ++j)
            if (j < ks_n)
#pragma unroll
                for (int e = 0; e < VEC; ++e) v[0][e] ^= v[j][e];
        if (live && r < rows) store_vec<VEC>(dst + r * W, v[0]);
    }
}

// One block contracts one item: batch row b, tile `tile` (words
// [tile * tw, +tw)), row group g (rows [g * RG, +RG)), over the C planes
// in chunks of cc, a ring of `stages` chunks in shared memory.
template <int RG, int VEC>
__global__ void __launch_bounds__(kThreads, min_blocks(RG, VEC))
xor_matmul_kernel(const int* __restrict__ masks,
                  const int* __restrict__ words, int* __restrict__ out,
                  int per_batch, int tiles, int groups, int R, int C,
                  long long W, int ctw_log2, int cc, int stages,
                  int data_ints) {
    extern __shared__ int4 smem_raw[];
    uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
    int* mT = reinterpret_cast<int*>(smem_raw) + kBarInts;     // [C][RG]
    int* sdata = mT + C * RG;
    int* sred = sdata + data_ints;

    const int tw = (32 * VEC) << ctw_log2;      // words of a tile
    const int ctw = 1 << ctw_log2;
    const int ks_n = kWarps >> ctw_log2;        // warps splitting C
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ks = warp & (ks_n - 1);
    const int ct = warp >> (2 - ctw_log2);
    const int col = (ct * 32 + lane) * VEC;
    const int nchunks = C > 0 ? (C + cc - 1) / cc : 1;

    const int bt = blockIdx.x / groups;
    const int b = bt / tiles;
    const long long w0 = (long long)(bt - b * tiles) * tw;
    const int g0 = (blockIdx.x - bt * groups) * RG;
    const int rows = min(RG, R - g0);
    // this item's mask rows, [rows][C], contiguous
    const int* mb = masks + ((per_batch ? (long long)b * R : 0LL) + g0) * C;
    const int* src0 = words + (long long)b * C * W + w0;   // plane 0

    int acc[RG][VEC];
#pragma unroll
    for (int r = 0; r < RG; ++r)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[r][v] = 0;

    if constexpr (VEC == 4) {
        // The TMA unit stages the planes: thread 0 issues a stage as one
        // bulk copy (the planes are contiguous where the tile is the whole
        // row) or one a plane, counted on the slot's mbarrier.
        const uint32_t bar0 = smem_addr(bars);
        const uint32_t seg =
            static_cast<uint32_t>(min((long long)tw, W - w0)) * 4;
        auto issue = [&](int t) {
            const int c0 = t * cc;
            const int nc = min(cc, C - c0);
            const int slot = t % stages;
            const uint32_t bar = bar0 + 8 * slot;
            int* dst = sdata + slot * cc * tw;
            const int* src = src0 + (long long)c0 * W;
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            mbar_expect(bar, nc * seg);
            if (W == tw) {
                if (nc > 0) bulk_copy(dst, src, nc * seg, bar);
            } else {
                for (int c = 0; c < nc; ++c)
                    bulk_copy(dst + c * tw, src + c * W, seg, bar);
            }
        };
        // The masks: the item's row block in a few 16-byte copies into
        // scratch free until they are transposed (the fold's buffer, or the
        // ring's last slot, whose stage is issued after the transpose).
        int* raw = ks_n > 1 ? sred : sdata + (stages - 1) * cc * tw;
        const int raw_ints = ks_n > 1 ? kWarps * 32 * RG * VEC : cc * tw;
        const bool rowcopy = (ks_n > 1 || stages > 1) &&
                             rows * C <= raw_ints && (rows * C) % 4 == 0 &&
                             (reinterpret_cast<uintptr_t>(mb) & 15) == 0;
        if (tid == 0) {
            for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s, 1);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        __syncthreads();
        if (rowcopy) {
            for (int i = 4 * tid; i < rows * C; i += 4 * kThreads)
                cp_async<4>(raw + i, mb + i, true);
        } else {
            stage_masks_t<RG>(mT, mb, rows, C, warp, lane);
        }
        cp_async_commit();
        const int early = min(rowcopy && ks_n == 1 ? stages - 1 : stages,
                              nchunks);
        if (tid == 0)
            for (int t = 0; t < early; ++t) issue(t);
        cp_async_wait(0);
        __syncthreads();            // the masks landed for every thread
        if (rowcopy) {
            for (int r = warp; r < RG; r += kWarps)
                for (int c = lane; c < C; c += 32)
                    mT[c * RG + r] = r < rows ? raw[r * C + c] : 0;
            __syncthreads();
            if (tid == 0)
                for (int t = early; t < min(stages, nchunks); ++t) issue(t);
        }
        uint32_t phases = 0;        // bit s: the parity slot s waits for
        for (int t = 0; t < nchunks; ++t) {
            const int slot = t % stages;
            mbar_wait(bar0 + 8 * slot, (phases >> slot) & 1);
            phases ^= 1u << slot;
            contract<RG, VEC>(acc, sdata + slot * cc * tw + col, tw,
                              mT + t * cc * RG, ks, ks_n,
                              min(cc, C - t * cc));
            if (t + stages < nchunks) {
                __syncthreads();    // every warp is done with the slot
                if (tid == 0) issue(t + stages);
            }
        }
    } else {
        // The scalar path: every thread copies, 4 bytes at a time, exactly
        // the words it contracts (zero past the ragged edge), so its own
        // cp.async.wait_group makes a stage visible to it; the masks come
        // in the first group, and one barrier makes them visible to all.
        stage_masks_t<RG>(mT, mb, rows, C, warp, lane);
        const bool ok = w0 + col < W;
        auto issue = [&](int t) {
            if (t < nchunks) {
                const int c0 = t * cc;
                const int nc = min(cc, C - c0);
                const int* src = src0 + (long long)c0 * W + col;
                int* dst = sdata + (t % stages) * cc * tw + col;
                for (int c = ks; c < nc; c += ks_n)
                    cp_async<1>(dst + c * tw, ok ? src + c * W : words, ok);
            }
            cp_async_commit();
        };
        for (int t = 0; t + 1 < stages; ++t) issue(t);
        for (int t = 0; t < nchunks; ++t) {
            issue(t + stages - 1);
            cp_async_wait(stages - 1);
            if (t == 0) __syncthreads();
            contract<RG, VEC>(acc, sdata + (t % stages) * cc * tw + col, tw,
                              mT + t * cc * RG, ks, ks_n,
                              min(cc, C - t * cc));
        }
        cp_async_wait(0);
    }
    store_item<RG, VEC>(acc, sred, ks, ks_n, ct, ctw, lane, w0 + col < W,
                        out + ((long long)b * R + g0) * W + w0 + col, rows,
                        W);
}

// The launch floor: K1's grid, block and shared memory, no work.
__global__ void __launch_bounds__(kThreads) xor_matmul_floor_kernel() {}

// Opts a kernel in to the device's shared-memory limit, once a device (a
// call captured into a CUDA graph then asks nothing).
template <typename K>
cudaError_t allow_smem(K kernel, int smem, bool (&done)[kMaxDevices]) {
    if (smem <= 48 * 1024) return cudaSuccess;
    int dev = 0;
    const bool cached = cudaGetDevice(&dev) == cudaSuccess && dev >= 0 &&
                        dev < kMaxDevices;
    if (cached && done[dev]) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_limit());
    if (e == cudaSuccess && cached) done[dev] = true;
    return e;
}

bool floor_allowed[kMaxDevices];

template <int RG, int VEC>
cudaError_t launch(bool floor, const Layout& L, const int* masks,
                   const int* words, int* out, int per_batch, int R, int C,
                   long long W, cudaStream_t stream) {
    auto kernel = xor_matmul_kernel<RG, VEC>;
    static bool allowed[kMaxDevices];
    const int smem = L.smem();
    const cudaError_t e = floor
        ? allow_smem(xor_matmul_floor_kernel, smem, floor_allowed)
        : allow_smem(kernel, smem, allowed);
    if (e != cudaSuccess) return e;
    int ctw_log2 = 0;
    while ((1 << ctw_log2) < L.ctw) ++ctw_log2;
    const unsigned grid = static_cast<unsigned>(L.items);     // an item each
    if (floor)
        xor_matmul_floor_kernel<<<grid, kThreads, smem, stream>>>();
    else
        kernel<<<grid, kThreads, smem, stream>>>(
            masks, words, out, per_batch, static_cast<int>(L.tiles),
            L.groups, R, C, W, ctw_log2, L.cc, L.stages, L.data_ints);
    return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_rg(bool floor, const Layout& L, const int* m,
                      const int* w, int* o, int pb, int R, int C,
                      long long W, cudaStream_t s) {
    switch (L.rg) {
        case 8:  return launch<8, VEC>(floor, L, m, w, o, pb, R, C, W, s);
        case 16: return launch<16, VEC>(floor, L, m, w, o, pb, R, C, W, s);
        case 24: return launch<24, VEC>(floor, L, m, w, o, pb, R, C, W, s);
        default: return launch<32, VEC>(floor, L, m, w, o, pb, R, C, W, s);
    }
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// K1 (or, with floor, the empty kernel at the same launch) under a plan
int run(bool floor, const void* masks, const void* words, void* out,
        long long B, int per_batch, int R, int C, long long W, int vec,
        int rg, int ctw, int cc, int stages, void* stream) {
    Layout L;
    if (!layout(B, R, C, W, vec, rg, ctw, cc, stages, L) ||
        L.smem() > smem_limit())
        return cudaErrorInvalidValue;
    if (vec == 4 && (W % 4 != 0 ||
                     (!floor && !(aligned16(words) && aligned16(out)))))
        return cudaErrorInvalidValue;
    if (!floor && (masks == nullptr || words == nullptr || out == nullptr))
        return cudaErrorInvalidValue;
    const int* m = static_cast<const int*>(masks);
    const int* w = static_cast<const int*>(words);
    int* o = static_cast<int*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int pb = per_batch ? 1 : 0;
    return static_cast<int>(
        vec == 4 ? launch_rg<4>(floor, L, m, w, o, pb, R, C, W, s)
                 : launch_rg<1>(floor, L, m, w, o, pb, R, C, W, s));
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes under a plan (-1 for a plan the
// kernel refuses), and the most a block may take on the current device.
int ceph_xor_matmul_smem_bytes(int R, int C, int vec, int rg, int ctw,
                               int cc, int stages) {
    Layout L;
    return layout(1, R, C, 1, vec, rg, ctw, cc, stages, L) ? L.smem() : -1;
}

int ceph_xor_matmul_smem_limit(void) { return smem_limit(); }

// masks [Bm, R, C] int32 (Bm = B when per_batch, else 1), words [B, C, W]
// int32, out [B, R, W] int32, all contiguous on the current device; the
// plan (vec, rg, ctw, cc, stages) from ops/xor_kernel.py:plan.
int ceph_xor_matmul_w32(const void* masks, const void* words, void* out,
                        long long B, int per_batch, int R, int C,
                        long long W, int vec, int rg, int ctw, int cc,
                        int stages, void* stream) {
    return run(false, masks, words, out, B, per_batch, R, C, W, vec, rg, ctw,
               cc, stages, stream);
}

// The empty kernel launched as ceph_xor_matmul_w32 would launch K1.
int ceph_xor_matmul_floor(long long B, int per_batch, int R, int C,
                          long long W, int vec, int rg, int ctw, int cc,
                          int stages, void* stream) {
    return run(true, nullptr, nullptr, nullptr, B, per_batch, R, C, W, vec,
               rg, ctw, cc, stages, stream);
}

}  // extern "C"
