// The fast mapper's straw2 descent on Hopper: one launch walks every level
// of a candidate grid's descents.
//
//     for each row i of the grid (lane n = i / K, candidate r[i]):
//       for each level, from row row0[i] of the first:
//         j = argmin_s  floor(numer[hash3(x[n], id[s], r[i]) & 0xFFFF] / w[s])
//         take child s = j: descend, stop at the target type, or reject/skip
//     -> item[i], status[i], leafrow[i]
//
// Replaces the plain version, ceph_tpu_torch/placement/fast_mapper.py
// _descend_batch, which runs each level as some 140 int64 torch passes over a
// [rows, width] grid (the rjenkins chain masked back to 32 bits after every
// add and shift, the numerator gather, the float64 quotient, the argmin, the
// bookkeeping's where-chain), each pass a round trip through device memory.
// Here a row's whole walk stays in registers and only its three results are
// written.
//
// The arithmetic, exact for every (u, weight) a map can hold:
//   * hash3 is crush_hash32_rjenkins1_3 in 32-bit registers (IADD3, SHF,
//     LOP3);
//   * numer[u] = 2^48 - crush_ln(u), the float64 table of the plain version
//     (DeviceTables.numer_lut, 512 KiB), read through L1 and L2;
//   * the quotient q = floor(numer / w) for a weight 0 < w < 2^31: q0 =
//     floor(numer * rcp(w)) with rcp(w) the correctly rounded 1/w, made when
//     the tables are packed, is within one of q (numer <= 2^48, so the two
//     roundings move the product by at most 2^48 * 2^-52 = 1/16), and one
//     step each way, q0 * w > numer and (q0 + 1) * w <= numer, tested in
//     float64 where every product is below 2^53 and exact, lands on q: the
//     plain version's own corrections;
//   * the argmin takes the first least q, the plain version's torch.argmin;
//     an item past the row's size or of weight <= 0 never wins, and a row
//     with no valid item takes item 0 (the plain version's argmin over
//     +inf).
//
// The design.  A group of G lanes of a warp walks one row, G chosen at launch
// from the row count and the widest level (group_size below):
//   * G = 1, a thread a row, when the grid has rows enough to fill the card
//     (the remap sweep: 262,144 lanes x 7 candidates).  Each thread loops
//     over its level's items and needs no reduction;
//   * G = 4, or 32 over a wide level, when rows are fewer (a pool of some
//     thousands of PGs): the group's lanes stride over the items and reduce
//     (q, j) by shuffles, so a level spreads over lanes instead of leaving
//     SMs idle.  Every lane of a warp reaches every shuffle: a lane whose
//     row is done, or past the grid, walks an empty level.
// Timed on an H100 (chip_smoke.py phase 9, PERF.md's kernel table): a
// 4,096-PG pool's root launch on the 1,000-host map, [4096, 7] x 1,000
// items, takes 0.708 ms at G = 1, 0.315 at 4 and 0.277 at 32; a 32,768-PG
// pool's 2.33 / 1.98 / 2.09 ms; at 65,536 PGs (rows that fill the card)
// the three lie within 6%; over the 32 x 4 map's 32-host root (a 2,048-PG
// 3-replica and a 512-PG RS(8,3) pool) G = 4 beats both 1 and 32, and so
// over every host level of 4 or 10 OSDs.
// A first level with one row (every TAKE root) of at most kSmemItems items is
// staged in shared memory by the block (16 bytes an item: hash id, weight,
// reciprocal); a thread-a-row warp then reads each item as one broadcast.
// Deeper levels (a host's 10 OSDs, a rack's hosts) read the same records from
// global memory through L1.  The record of the chosen child (id, type and
// escape flag, next-level row, leaf-class row) is read once a level.
//
// What bounds it: the draws.  Each costs the hash (137 integer instructions,
// portbench/arith.py), one random 8-byte gather from the numerator table and
// about eight float64 operations; the remap sweep's 1.85 G draws take some
// 15 ms at the integer rate (132 SMs x 64 lanes x 1.98 GHz).  The gathers
// run beside them: the table is larger than L1, so most are L2 sectors.
// On an H100 the root level's launch takes 15.4 ms, 97% of that bound
// (PERF.md, the kernel table).  ptxas (`_build.build_log`, sm_90a, CUDA
// 12.8): 40 registers a thread for each G, no spills, no static shared
// memory; a 512-thread block takes 20,480 of an SM's 65,536 registers, so
// three blocks (1,536 threads, 75% occupancy) fit, registers bounding it
// before the 16 KiB of staged root items a block.
//
// Plain C interface, bound with ctypes.  The launch goes on the caller's
// stream and never synchronizes; the level descriptors travel by value in the
// kernel's parameters, so a launch captured into a CUDA graph reads no host
// memory at replay.  The return value is cudaGetLastError() after the launch
// (0 = launched).  ceph_crush_descend_floor launches an empty kernel with the
// same grid, block and shared memory: the launch floor.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxLevels = 16;
constexpr int kSmemItems = 3072;          // 48 KiB of 16-byte item records
constexpr int kMaxDevices = 64;
constexpr int kWideLevel = 256;           // 32 lanes a row from this width
constexpr long long kItemNone = 0x7FFFFFFF;
constexpr long long kOk = 0, kReject = 1, kSkip = 2;
constexpr int kEscape = 1 << 30;          // set in Child::type_esc

// the hot record of one item: read for every draw
struct Item {
    int32_t hash_id;
    int32_t weight;                       // 16.16; <= 0 never wins
    double rcp;                           // 1.0 / weight (0 when weight <= 0)
};

// the cold record of one item: read once a level, for the chosen child
struct Child {
    int32_t id;
    int32_t type_esc;                     // child's type | kEscape
    int32_t row;                          // row in the next level (-1)
    int32_t leafrow;                      // row in the leaf class (-1)
};

struct LevelDesc {
    long long item_off;                   // [rows, width] records from here
    long long size_off;                   // [rows] sizes from here
    int rows;
    int width;
};

struct Params {
    const Item* items;
    const Child* children;
    const int32_t* sizes;
    const double* numer;
    const long long* x;                   // [N]
    const long long* row0;                // [N * K]
    const long long* r;                   // [N * K]
    long long* item_out;
    long long* status_out;
    long long* leafrow_out;
    long long rows;                       // N * K
    int K;
    int n_levels;
    int target_type;
    int want_leafrow;
    int stage0;                           // level 0 staged in shared memory
    LevelDesc lv[kMaxLevels];
};

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
    a -= b; a -= c; a ^= c >> 13;
    b -= c; b -= a; b ^= a << 8;
    c -= a; c -= b; c ^= b >> 13;
    a -= b; a -= c; a ^= c >> 12;
    b -= c; b -= a; b ^= a << 16;
    c -= a; c -= b; c ^= b >> 5;
    a -= b; a -= c; a ^= c >> 3;
    b -= c; b -= a; b ^= a << 10;
    c -= a; c -= b; c ^= b >> 15;
}

// crush_hash32_rjenkins1_3 (src/crush/hash.c)
__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
    uint32_t h = 1315423911u ^ a ^ b ^ c;
    uint32_t x = 231232u, y = 1232u;
    mix(a, b, h);
    mix(c, x, h);
    mix(y, a, h);
    mix(b, x, h);
    mix(y, c, h);
    return h;
}

// floor(numer / w) for 0 < w < 2^31, numer a float64 integer <= 2^48
__device__ __forceinline__ double quotient(double numer, double wf,
                                           double rcp) {
    double q = floor(numer * rcp);
    if (q * wf > numer) q -= 1.0;
    if ((q + 1.0) * wf <= numer) q += 1.0;
    return q;
}

// this lane's first least quotient over items sub, sub + G, ... < size
template <int G>
__device__ __forceinline__ void scan(const Item* __restrict__ it,
                                     const double* __restrict__ numer,
                                     uint32_t x, uint32_t r, int sub, int size,
                                     double& best, int& bj) {
#pragma unroll 2
    for (int s = sub; s < size; s += G) {
        const Item rec = it[s];
        if (rec.weight <= 0) continue;
        const uint32_t u =
            hash3(x, static_cast<uint32_t>(rec.hash_id), r) & 0xFFFFu;
        const double q = quotient(__ldg(numer + u),
                                  static_cast<double>(rec.weight), rec.rcp);
        if (q < best) {
            best = q;
            bj = s;
        }
    }
}

template <int G>
__global__ void __launch_bounds__(kThreads)
crush_descend_kernel(const Params p) {
    extern __shared__ Item s_items[];
    if (p.stage0) {
        const Item* src = p.items + p.lv[0].item_off;
        for (int s = threadIdx.x; s < p.lv[0].width; s += kThreads)
            s_items[s] = src[s];
        __syncthreads();
    }
    const long long gid =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
    const int sub = static_cast<int>(threadIdx.x % G);
    const bool live = gid < p.rows;
    const long long i = live ? gid : 0;
    const uint32_t x = static_cast<uint32_t>(p.x[i / p.K]);
    const uint32_t r = static_cast<uint32_t>(p.r[i]);
    const long long r0 = p.row0[i];
    bool done = !live || r0 < 0;
    long long cur = r0 < 0 ? 0 : r0;
    long long status = r0 < 0 ? kSkip : kReject;
    long long result = kItemNone;
    long long leafrow = -1;
    for (int l = 0; l < p.n_levels; ++l) {
        const LevelDesc lv = p.lv[l];
        const long long row = cur < lv.rows ? cur : lv.rows - 1;
        const int size = done ? 0 : __ldg(p.sizes + lv.size_off + row);
        const long long base = lv.item_off + row * lv.width;
        double best = INFINITY;
        int bj = 0;
        // two copies, so that each load names its memory (LDS or LDG)
        if (l == 0 && p.stage0)
            scan<G>(s_items, p.numer, x, r, sub, size, best, bj);
        else
            scan<G>(p.items + base, p.numer, x, r, sub, size, best, bj);
        if constexpr (G > 1) {
#pragma unroll
            for (int off = G / 2; off > 0; off >>= 1) {
                const double ob = __shfl_xor_sync(0xffffffffu, best, off);
                const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
                if (ob < best || (ob == best && oj < bj)) {
                    best = ob;
                    bj = oj;
                }
            }
        }
        if (done) continue;
        const bool empty = size == 0;
        const Child c = p.children[base + bj];
        const bool esc = (c.type_esc & kEscape) != 0;
        const bool match = (c.type_esc & ~kEscape) == p.target_type;
        const bool is_dev = c.id >= 0;
        const bool skip = !empty && (esc || (!match && is_dev));
        if (empty)
            status = kReject;
        else if (skip)
            status = kSkip;
        else if (match)
            status = kOk;
        if (match && !empty && !esc) {
            result = c.id;
            if (p.want_leafrow) leafrow = c.leafrow;
        }
        done = empty || skip || (match && !esc);
        if (!done) cur = c.row < 0 ? 0 : c.row;
    }
    if (!live || sub != 0) return;
    if (!done) status = kSkip;
    p.item_out[i] = result;
    p.status_out[i] = status;
    p.leafrow_out[i] = leafrow;
}

__global__ void __launch_bounds__(kThreads) crush_descend_floor_kernel() {}

// the descent's quotient alone, for the tests: out[k] = floor(numer[u[k]] /
// w[k]) through quotient(), -1 where w[k] <= 0
__global__ void crush_quotient_kernel(const double* __restrict__ numer,
                                      const long long* __restrict__ u,
                                      const long long* __restrict__ w,
                                      const double* __restrict__ rcp,
                                      long long* __restrict__ out,
                                      long long n) {
    const long long k = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
    if (k >= n) return;
    const long long wk = w[k];
    out[k] = wk <= 0 ? -1
                     : static_cast<long long>(quotient(
                           __ldg(numer + (u[k] & 0xFFFF)),
                           static_cast<double>(wk), rcp[k]));
}

int sm_count() {
    static int cached[kMaxDevices];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) return 132;
    if (dev >= 0 && dev < kMaxDevices && cached[dev]) return cached[dev];
    int v = 132;
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < kMaxDevices) cached[dev] = v;
    return v;
}

// Lanes a row: one when the rows fill the card (2,048 threads an SM), else
// 4, or 32 over a level of kWideLevel items or more while 4 a row would
// still leave the card short of threads.
int group_size(long long rows, int max_width) {
    const long long fill = 2048LL * sm_count();
    if (rows >= fill) return 1;
    if (rows * 4 >= fill || max_width < kWideLevel) return 4;
    return 32;
}

template <int G>
cudaError_t launch_g(bool floor, const Params& p, int smem,
                     cudaStream_t stream) {
    const long long threads = p.rows * G;
    const long long blocks = (threads + kThreads - 1) / kThreads;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    const unsigned grid = static_cast<unsigned>(blocks);
    if (floor)
        crush_descend_floor_kernel<<<grid, kThreads, smem, stream>>>();
    else
        crush_descend_kernel<G><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

int run(bool floor, Params& p, const long long* desc, int group,
        void* stream) {
    if (p.rows <= 0 || p.K <= 0 || p.n_levels <= 0 ||
        p.n_levels > kMaxLevels || desc == nullptr)
        return cudaErrorInvalidValue;
    int max_width = 1;
    for (int l = 0; l < p.n_levels; ++l) {
        LevelDesc& lv = p.lv[l];
        lv.item_off = desc[4 * l + 0];
        lv.size_off = desc[4 * l + 1];
        lv.rows = static_cast<int>(desc[4 * l + 2]);
        lv.width = static_cast<int>(desc[4 * l + 3]);
        if (lv.rows <= 0 || lv.width <= 0) return cudaErrorInvalidValue;
        if (lv.width > max_width) max_width = lv.width;
    }
    p.stage0 = p.lv[0].rows == 1 && p.lv[0].width <= kSmemItems;
    const int smem = p.stage0 ? p.lv[0].width * static_cast<int>(sizeof(Item))
                              : 0;
    const int G = group > 0 ? group : group_size(p.rows, max_width);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (G) {
        case 1: return launch_g<1>(floor, p, smem, s);
        case 4: return launch_g<4>(floor, p, smem, s);
        case 32: return launch_g<32>(floor, p, smem, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

extern "C" {

// The lanes a row the launch would take for `rows` rows whose widest level
// is `max_width` items (1, 4 or 32).
int ceph_crush_descend_group(long long rows, int max_width) {
    return group_size(rows, max_width);
}

// items [T] 16-byte item records, children [T] 16-byte child records, sizes
// [Tb] int32, numer [65536] float64; x [N], row0 and r [N, K], item, status
// and leafrow [N, K], all int64; every pointer contiguous on the current
// device.  desc [n_levels, 4] int64 on the host: each level's first item
// record, first size, rows and width.  group: lanes a row (1, 4 or 32), or 0
// for group_size's choice.
int ceph_crush_descend(const void* items, const void* children,
                       const void* sizes, const void* numer,
                       const long long* desc, int n_levels, const void* x,
                       const void* row0, const void* r, long long N, int K,
                       int target_type, int want_leafrow, int group,
                       void* item_out, void* status_out, void* leafrow_out,
                       void* stream) {
    if (!items || !children || !sizes || !numer || !x || !row0 || !r ||
        !item_out || !status_out || !leafrow_out)
        return cudaErrorInvalidValue;
    Params p{};
    p.items = static_cast<const Item*>(items);
    p.children = static_cast<const Child*>(children);
    p.sizes = static_cast<const int32_t*>(sizes);
    p.numer = static_cast<const double*>(numer);
    p.x = static_cast<const long long*>(x);
    p.row0 = static_cast<const long long*>(row0);
    p.r = static_cast<const long long*>(r);
    p.item_out = static_cast<long long*>(item_out);
    p.status_out = static_cast<long long*>(status_out);
    p.leafrow_out = static_cast<long long*>(leafrow_out);
    p.rows = N * K;
    p.K = K;
    p.n_levels = n_levels;
    p.target_type = target_type;
    p.want_leafrow = want_leafrow;
    return run(false, p, desc, group, stream);
}

// The descent's quotient over n (u, w, rcp) triples, all contiguous on the
// current device (u, w and out int64, rcp float64).
int ceph_crush_descend_quotients(const void* numer, const void* u,
                                 const void* w, const void* rcp, void* out,
                                 long long n, void* stream) {
    if (n <= 0 || !numer || !u || !w || !rcp || !out)
        return cudaErrorInvalidValue;
    const long long blocks = (n + 255) / 256;
    if (blocks > 0x7FFFFFFFLL) return cudaErrorInvalidConfiguration;
    crush_quotient_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(numer), static_cast<const long long*>(u),
        static_cast<const long long*>(w), static_cast<const double*>(rcp),
        static_cast<long long*>(out), n);
    return static_cast<int>(cudaGetLastError());
}

// The empty kernel launched as ceph_crush_descend would launch the descent
// for the same levels and grid.
int ceph_crush_descend_floor(const long long* desc, int n_levels, long long N,
                             int K, int group, void* stream) {
    Params p{};
    p.rows = N * K;
    p.K = K;
    p.n_levels = n_levels;
    return run(true, p, desc, group, stream);
}

}  // extern "C"
