// K1 on Hopper: the batched masked region-XOR, a GF(2) bit-matrix product
// over int32 plane words.
//
//     out[b, r, w] = XOR_c ( masks[b or 0, r, c] & words[b, c, w] )
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/xor_kernel.py:_kernel (body
// _combine, launched by _xor_matmul_pallas).  Every int32 word carries 32
// independent GF(2) lanes; the masks are data (0 or -1, one per bit-matrix
// entry), so a new erasure signature reuses the same kernel, and a mask batch
// of B gives every stripe of a recovery batch its own signature.
//
// What bounds it on an H100 SXM, at the RS(8,3) encode shape of the smoke
// (words [512, 64, 4096] -> out [512, 24, 4096] int32):
//   * bytes: each input word read once, each output word written once:
//     738,197,504 B, 0.220 ms at 3.35 TB/s (HBM3, NVIDIA data sheet);
//   * integer work: R*C*W*B = 3.22e9 mask-AND-XOR steps, one LOP3 each.  A
//     GH100 SM has 64 INT32 lanes (H100 architecture white paper); the data
//     sheet's 67 TFLOP/s FP32 = 132 SMs x 128 lanes x 2 x 1.98 GHz gives the
//     clock, so 132 x 64 x 1.98e9 = 16.7e12 32-bit logic ops/s: 0.193 ms.
// The bytes bound it, but the integer work sits only ~15% below, so a kernel
// that ANDs every mask entry is close to both.  The design: each block owns
// one batch row b and a tile of words; its [R, C] masks live in shared memory
// transposed ([C][Rp]), so one 16-byte broadcast load feeds four rows; every
// thread streams its word column with 16-byte loads (four in flight) and keeps
// the R accumulators in registers, so each data word leaves device memory once
// per group of <= 32 rows.  Skipping all-zero mask entries (about half of a
// Cauchy or Vandermonde bit-matrix) and TMA/cp.async staging are later work.
//
// Plain C interface, bound with ctypes (ceph_tpu_torch/ops/xor_kernel.py).
// The launch goes on the caller's stream and never synchronizes; the return
// value is cudaGetLastError() after the launch (0 = launched).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // threads per block
constexpr int kUnroll = 4;           // data loads in flight per thread
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory without opt-in

// Rows held in registers at once: the smallest group that covers R, capped
// at 32; R is padded with zero mask rows up to a multiple of the group.
int row_group(int R) { return R <= 8 ? 8 : R <= 16 ? 16 : R <= 24 ? 24 : 32; }
int padded_rows(int R) { int g = row_group(R); return (R + g - 1) / g * g; }

template <int VEC>
__device__ __forceinline__ void load_words(const int* p, int (&d)[VEC]) {
    if constexpr (VEC == 4) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(p));
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
    } else {
        d[0] = __ldg(p);
    }
}

template <int VEC>
__device__ __forceinline__ void store_words(int* p, const int (&a)[VEC]) {
    if constexpr (VEC == 4) {
        *reinterpret_cast<int4*>(p) = make_int4(a[0], a[1], a[2], a[3]);
    } else {
        p[0] = a[0];
    }
}

// acc[r] ^= mask[c][g0 + r] & d for one column c; mrow = &smask[c * Rp + g0]
// is 16-byte aligned, so four rows come in one shared-memory broadcast.
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

template <int RG, int VEC>
__global__ void __launch_bounds__(kThreads)
xor_matmul_kernel(const int* __restrict__ masks,
                  const int* __restrict__ words, int* __restrict__ out,
                  long long tiles, int per_batch, int R, int Rp, int C,
                  long long W) {
    extern __shared__ int4 smem_raw[];
    int* smask = reinterpret_cast<int*>(smem_raw);  // [C][Rp], transposed

    const long long b = blockIdx.x / tiles;
    const long long tile = blockIdx.x - b * tiles;
    const int* mb = masks + (per_batch ? b * R * (long long)C : 0LL);
    for (int i = threadIdx.x; i < C * Rp; i += kThreads) {
        const int c = i / Rp;
        const int r = i - c * Rp;
        smask[i] = r < R ? mb[(long long)r * C + c] : 0;
    }
    __syncthreads();

    // the ragged edge is masked here: W % VEC == 0, so a thread whose
    // first word is in range owns VEC words in range
    const long long w0 = (tile * kThreads + threadIdx.x) * VEC;
    if (w0 >= W) return;
    const int* src = words + b * C * W + w0;
    int* dst = out + b * (long long)R * W + w0;

    for (int g0 = 0; g0 < Rp; g0 += RG) {
        int acc[RG][VEC];
#pragma unroll
        for (int r = 0; r < RG; ++r)
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[r][v] = 0;

        int c = 0;
        for (; c + kUnroll <= C; c += kUnroll) {
            int d[kUnroll][VEC];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                load_words<VEC>(src + (c + u) * W, d[u]);
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                accumulate<RG, VEC>(acc, smask + (c + u) * Rp + g0, d[u]);
        }
        for (; c < C; ++c) {
            int d[VEC];
            load_words<VEC>(src + c * W, d);
            accumulate<RG, VEC>(acc, smask + c * Rp + g0, d);
        }
#pragma unroll
        for (int r = 0; r < RG; ++r)
            if (g0 + r < R) store_words<VEC>(dst + (g0 + r) * W, acc[r]);
    }
}

template <int RG>
cudaError_t launch(int vec, const int* masks, const int* words, int* out,
                   long long B, int per_batch, int R, int Rp, int C,
                   long long W, cudaStream_t stream) {
    const long long tiles = (W + (long long)kThreads * vec - 1) /
                            ((long long)kThreads * vec);
    if (B * tiles > INT_MAX) return cudaErrorInvalidConfiguration;
    const dim3 grid(static_cast<unsigned>(B * tiles));
    const size_t smem = static_cast<size_t>(C) * Rp * sizeof(int);
    if (vec == 4)
        xor_matmul_kernel<RG, 4><<<grid, kThreads, smem, stream>>>(
            masks, words, out, tiles, per_batch, R, Rp, C, W);
    else
        xor_matmul_kernel<RG, 1><<<grid, kThreads, smem, stream>>>(
            masks, words, out, tiles, per_batch, R, Rp, C, W);
    return cudaGetLastError();
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// Shared memory the kernel needs for an [R, C] mask matrix, and the most it
// takes; the wrapper refuses larger matrices before launching.
int ceph_xor_matmul_smem_bytes(int R, int C) {
    return padded_rows(R) * C * static_cast<int>(sizeof(int));
}

int ceph_xor_matmul_smem_limit(void) { return kMaxSmem; }

// masks [Bm, R, C] int32 (Bm = B when per_batch, else 1), words [B, C, W]
// int32, out [B, R, W] int32, all contiguous on the current device.
int ceph_xor_matmul_w32(const void* masks, const void* words, void* out,
                        long long B, int per_batch, int R, int C,
                        long long W, void* stream) {
    if (B <= 0 || R <= 0 || C < 0 || W <= 0)
        return cudaErrorInvalidValue;
    if (ceph_xor_matmul_smem_bytes(R, C) > kMaxSmem)
        return cudaErrorInvalidValue;
    const int Rp = padded_rows(R);
    const int vec = (W % 4 == 0 && aligned16(words) && aligned16(out)) ? 4 : 1;
    const int* m = static_cast<const int*>(masks);
    const int* w = static_cast<const int*>(words);
    int* o = static_cast<int*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (row_group(R)) {
        case 8:  err = launch<8>(vec, m, w, o, B, per_batch, R, Rp, C, W, s); break;
        case 16: err = launch<16>(vec, m, w, o, B, per_batch, R, Rp, C, W, s); break;
        case 24: err = launch<24>(vec, m, w, o, B, per_batch, R, Rp, C, W, s); break;
        default: err = launch<32>(vec, m, w, o, B, per_batch, R, Rp, C, W, s); break;
    }
    return static_cast<int>(err);
}

}  // extern "C"
