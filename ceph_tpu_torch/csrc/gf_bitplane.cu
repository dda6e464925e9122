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
// pack(B_ij . bits(v)) is a 256-entry byte table and out_i = XOR_j
// T_ij[data_j].  That holds for ANY bitmat, not only one built from a GF(2^8)
// matrix.  The wrapper (ceph_tpu_torch/ops/gf_pallas.py) builds T [m, k, 256]
// exactly on the host and packs four output rows into one 32-bit entry:
// tab[g, j, v] = T[4g..4g+3, j, v] as the bytes of a word, so one shared-memory
// lookup per input byte serves up to four parity rows (RS(8,3): 3 in 1).
//
// What bounds it on an H100 SXM, at the batched encode shape of the smoke
// (data [128, 8, 131072] -> out [128, 3, 131072] uint8):
//   * bytes: 134,217,728 B read + 50,331,648 B written + 1,536 B of bitmat =
//     184,550,912 B, 55.1 us at 3.35 TB/s (HBM3, NVIDIA data sheet);
//   * table lookups: B*m*k*L = 402,653,184 GF(2^8) byte products.  Shared
//     memory serves one 32-lane wavefront per clock per SM (32 banks of 4 B,
//     128 B/clock/SM: H100 architecture white paper), so at most 32 lookups
//     per clock per SM; 132 SMs at the 1.98 GHz the data sheet's 67 TFLOP/s
//     FP32 implies give 132 x 32 x 1.98e9 = 8.36e12 lookups/s: 48.2 us;
//   * bound: the larger, 55.1 us, set by the bytes.
// Random bytes hit random banks, so a warp's lookup takes several wavefronts
// (bank conflicts); packing four rows per word cuts the lookups m-fold for
// m <= 4.  Bank-conflict-free layouts, table replication and TMA staging are
// later work.
//
// The design: each block copies its tables into shared memory (G x k x 1 KiB,
// G = output row groups of four in this pass), then walks column tiles of one
// batch row b; each thread takes 16 bytes of one column from each of the k
// data rows (one 16-byte load where L % 16 == 0 and the pointers are aligned,
// byte loads otherwise), keeps G x 16 32-bit accumulators, and transposes
// them to output bytes with byte permutes at the end.  The ragged edge is
// masked in the kernel (nothing is padded); offsets are 64-bit.
//
// Plain C interface, bound with ctypes.  The launch goes on the caller's
// stream and never synchronizes; the return value is cudaGetLastError() after
// the launches (0 = launched).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "gf_common.cuh"

namespace {

constexpr int kThreads = 256;              // threads per block
constexpr int kBytes = 16;                 // column bytes per thread per row
constexpr long long kTile = kThreads * kBytes;

template <int G, bool VEC>
__global__ void __launch_bounds__(kThreads)
gf_bitplane_kernel(const uint32_t* __restrict__ tab,  // [G][k][256]
                   const uint8_t* __restrict__ data,  // [B][k][L]
                   uint8_t* __restrict__ out,         // [B][m][L]
                   int k, int m, int row0, int rows, long long L,
                   long long chunks, int tpb) {
    extern __shared__ uint32_t stab[];
    const int n = G * k * kTableWords;
    for (int i = threadIdx.x; i < n; i += kThreads) stab[i] = tab[i];
    __syncthreads();

    const long long b = blockIdx.x / chunks;
    const long long chunk = blockIdx.x - b * chunks;
    const uint8_t* src = data + b * k * L;
    uint8_t* dst = out + (b * m + row0) * L;
    const int tstride = k * kTableWords;

    for (int t = 0; t < tpb; ++t) {
        const long long c0 = (chunk * tpb + t) * kTile +
                             static_cast<long long>(threadIdx.x) * kBytes;
        if (c0 >= L) break;
        const long long left = L - c0;

        uint32_t acc[G][16];
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
            for (int p = 0; p < 16; ++p) acc[g][p] = 0;

        uint32_t nxt[4];
        load16<VEC>(src + c0, left, nxt);
        for (int j = 0; j < k; ++j) {
            uint32_t w[4] = {nxt[0], nxt[1], nxt[2], nxt[3]};
            if (j + 1 < k) load16<VEC>(src + (j + 1) * L + c0, left, nxt);
            table_xor<G>(acc, w, stab + j * kTableWords, tstride);
        }

#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                const int row = 4 * g + r;
                if (row >= rows) break;
                uint8_t* o = dst + row * L + c0;
                const uint32_t w0 = gather_row(acc[g], 0, r);
                const uint32_t w1 = gather_row(acc[g], 1, r);
                const uint32_t w2 = gather_row(acc[g], 2, r);
                const uint32_t w3 = gather_row(acc[g], 3, r);
                if constexpr (VEC) {
                    *reinterpret_cast<uint4*>(o) = make_uint4(w0, w1, w2, w3);
                } else {
                    const uint32_t ws[4] = {w0, w1, w2, w3};
#pragma unroll
                    for (int p = 0; p < 16; ++p)
                        if (p < left)
                            o[p] = static_cast<uint8_t>(ws[p >> 2] >> (8 * (p & 3)));
                }
            }
        }
    }
}

template <int G, bool VEC>
cudaError_t launch_pass(const uint32_t* tab, const uint8_t* data, uint8_t* out,
                        long long B, int k, int m, int row0, int rows,
                        long long L, cudaStream_t stream) {
    const long long tiles = (L + kTile - 1) / kTile;
    // a few tiles per block when the grid has many waves, so the table copy
    // into shared memory is amortized over more columns
    const long long sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
    long long tpb = (B * tiles) / (sms * 8);
    tpb = tpb < 1 ? 1 : (tpb > 8 ? 8 : tpb);
    const long long chunks = (tiles + tpb - 1) / tpb;
    if (B * chunks > INT_MAX) return cudaErrorInvalidConfiguration;
    const size_t smem = static_cast<size_t>(G) * k * kTableWords *
                        sizeof(uint32_t);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            gf_bitplane_kernel<G, VEC>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    gf_bitplane_kernel<G, VEC>
        <<<static_cast<unsigned>(B * chunks), kThreads, smem, stream>>>(
        tab, data, out, k, m, row0, rows, L, chunks, static_cast<int>(tpb));
    return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch(int G, const uint32_t* tab, const uint8_t* data,
                   uint8_t* out, long long B, int k, int m, int row0, int rows,
                   long long L, cudaStream_t s) {
    switch (G) {
        case 1: return launch_pass<1, VEC>(tab, data, out, B, k, m, row0, rows, L, s);
        case 2: return launch_pass<2, VEC>(tab, data, out, B, k, m, row0, rows, L, s);
        case 3: return launch_pass<3, VEC>(tab, data, out, B, k, m, row0, rows, L, s);
        default: return launch_pass<4, VEC>(tab, data, out, B, k, m, row0, rows, L, s);
    }
}

}  // namespace

extern "C" {

// Shared memory one pass over G row groups takes for k data rows, and the
// most a block may take on the current device (the opt-in limit).
int ceph_gf_bitplane_smem_bytes(int G, int k) {
    return G * k * kTableWords * static_cast<int>(sizeof(uint32_t));
}

int ceph_gf_bitplane_smem_limit(void) { return smem_limit(); }

// tab [ceil(m/4), k, 256] uint32 (packed tables), data [B, k, L] uint8,
// out [B, m, L] uint8, all contiguous on the current device.  Row groups go
// in passes of up to four groups (16 rows) that fit in shared memory; each
// pass reads the data once more.
int ceph_gf_bitplane(const void* tab, const void* data, void* out,
                     long long B, int k, int m, long long L, void* stream) {
    if (B <= 0 || k <= 0 || m <= 0 || L <= 0) return cudaErrorInvalidValue;
    const int limit = smem_limit();
    int gmax = limit / ceph_gf_bitplane_smem_bytes(1, k);
    if (gmax < 1) return cudaErrorInvalidValue;
    if (gmax > 4) gmax = 4;
    const int groups = (m + 3) / 4;
    const bool vec = (L % 16 == 0) && aligned16(data) && aligned16(out);
    const uint32_t* t = static_cast<const uint32_t*>(tab);
    const uint8_t* d = static_cast<const uint8_t*>(data);
    uint8_t* o = static_cast<uint8_t*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    for (int g0 = 0; g0 < groups; g0 += gmax) {
        const int G = groups - g0 < gmax ? groups - g0 : gmax;
        const int row0 = 4 * g0;
        const int rows = m - row0 < 4 * G ? m - row0 : 4 * G;
        const uint32_t* tp = t + static_cast<long long>(g0) * k * kTableWords;
        const cudaError_t e =
            vec ? launch<true>(G, tp, d, o, B, k, m, row0, rows, L, s)
                : launch<false>(G, tp, d, o, B, k, m, row0, rows, L, s);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
