// K5-K8: the gather microbenchmark kernels (ops/gather.py wraps them).
// They replace the six Pallas kernels of tools/microbench_gather.py and
// tools/microbench_gather2.py, which measured what a per-lane random row
// fetch costs on a TPU:
//
//   K5 gather_chain         pallas_take (:92), pallas_tala (gather2 :69);
//                           the table stays in device memory (L2)
//   K6 gather_chain_shared  pallas_vreg (:133); the table in shared memory
//   K7 gather_onehot_mma    pallas_onehot (:177), pallas_onehot (gather2
//                           :112); the one-hot product on the tensor cores
//   K8 gather_rows          pallas_scalar (:228), un-chained; a thread
//                           or a warp moves rows as 16-, 8- or 4-byte
//                           vectors
//
// K5-K7 run the reference's chain of kChain dependent gathers per lane:
// r = T[idx, 0]; acc += r; idx = (int32(r) ^ idx) mod rows, with a floor
// mod as jnp's `%`. The starting index is taken mod rows the same way, so
// no input reads outside the table (an index already in [0, rows) is
// unchanged). K5-K7 take a runtime flag `keep` and a sink: the wrapper
// passes 0, but the compiler cannot know it, so the whole-row loads (K5,
// K6) and every tile's product (K7) are not dropped although only word 0
// feeds the chain. What bounds each kernel and what its design does about
// it: ops/gather.py.
#include "common.cuh"

namespace {

constexpr int kChain = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ int floor_mod(int x, int rows) {
    const int m = x % rows;
    return m < 0 ? m + rows : m;
}

// the chain's next index: (int32(r) ^ idx) mod rows, floor mod
__device__ __forceinline__ int next_index(uint32_t r, int idx, int rows) {
    return floor_mod((int)r ^ idx, rows);
}

// One whole table row of `cols` words, fetched as the TPU kernel's row take
// does: 16-byte loads where cols is a multiple of 4, 8-byte where it is
// even. Returns word 0 and folds every word into `fold`.
__device__ __forceinline__ uint32_t fetch_row(const uint32_t* row, int cols,
                                              uint32_t& fold) {
    uint32_t w0, f;
    if ((cols & 3) == 0) {
        const uint4* v = reinterpret_cast<const uint4*>(row);
        uint4 q = v[0];
        w0 = q.x;
        f = q.x ^ q.y ^ q.z ^ q.w;
#pragma unroll 4
        for (int j = 1; j < cols / 4; ++j) {
            q = v[j];
            f ^= q.x ^ q.y ^ q.z ^ q.w;
        }
    } else if ((cols & 1) == 0) {
        const uint2* v = reinterpret_cast<const uint2*>(row);
        uint2 q = v[0];
        w0 = q.x;
        f = q.x ^ q.y;
        for (int j = 1; j < cols / 2; ++j) {
            q = v[j];
            f ^= q.x ^ q.y;
        }
    } else {
        w0 = row[0];
        f = w0;
        for (int j = 1; j < cols; ++j) f ^= row[j];
    }
    fold ^= f;
    return w0;
}

__device__ __forceinline__ uint32_t chain(const uint32_t* table, int rows,
                                          int cols, int idx,
                                          uint32_t& fold) {
    idx = floor_mod(idx, rows);
    uint32_t acc = 0;
#pragma unroll
    for (int s = 0; s < kChain; ++s) {
        const uint32_t r = fetch_row(table + (size_t)idx * cols, cols, fold);
        acc += r;
        idx = next_index(r, idx, rows);
    }
    return acc;
}

// K5: one thread per lane, the table in device memory
__global__ void __launch_bounds__(kThreads)
chain_kernel(const uint32_t* __restrict__ table, int rows, int cols,
             const int* __restrict__ idx0, int n, uint32_t* __restrict__ out,
             int keep, uint32_t* __restrict__ sink) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    uint32_t fold = 0;
    out[i] = chain(table, rows, cols, idx0[i], fold);
    if (keep) sink[i] = fold;
}

// K6: each block copies the table into shared memory once, then walks the
// lanes with a grid-stride loop (the grid is a few blocks per SM, so the
// copies stay few)
__global__ void __launch_bounds__(kThreads)
chain_shared_kernel(const uint32_t* __restrict__ table, int rows, int cols,
                    const int* __restrict__ idx0, int n,
                    uint32_t* __restrict__ out, int keep,
                    uint32_t* __restrict__ sink) {
    extern __shared__ uint4 smem4[];
    uint32_t* t = reinterpret_cast<uint32_t*>(smem4);
    const int words = rows * cols;
    if ((words & 3) == 0) {
        const uint4* src = reinterpret_cast<const uint4*>(table);
        for (int w = threadIdx.x; w < words / 4; w += blockDim.x)
            smem4[w] = src[w];
    } else {
        for (int w = threadIdx.x; w < words; w += blockDim.x) t[w] = table[w];
    }
    __syncthreads();
    uint32_t fold = 0;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        out[i] = chain(t, rows, cols, idx0[i], fold);
    }
    if (keep) sink[blockIdx.x * blockDim.x + threadIdx.x] = fold;
}

// ---- K7: the one-hot product on the tensor cores ----
//
// Per chain step, G = onehot(idx) (lanes x rows, bf16) . P (rows x 4*cols,
// bf16 u8 planes) in f32 with mma.sync m16n8k16: M = 16 lanes, K = 16
// table rows, N = 8 plane columns. Every k tile and every n tile is
// multiplied, as the MXU product is. A warp holds kMT M tiles, so each B
// fragment read from shared memory feeds kMT products.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): with g = lane / 4 and
// q = lane % 4, a thread's A registers hold rows g and g + 8 at k = 2q,
// 2q + 1 (and + 8); its B registers hold column g at k = 2q, 2q + 1 (and
// + 8); its C registers hold rows g and g + 8 at columns 2q, 2q + 1. So
// the thread that builds a lane's one-hot row also receives that lane's
// product row: plane columns 0-3, the bytes of table word 0, sit in the
// C registers of q = 0 (bytes 0, 1) and q = 1 (bytes 2, 3) of the
// n tile 0, and two shuffles give all four threads of the group the
// decoded word for the next step.
constexpr int kMT = 2;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kBf16One = 0x3F80u;

// bf16x2 register of a one-hot row: 1.0 in the half at k offset d (0 is
// the low half), or 0 when d is not 0 or 1
__device__ __forceinline__ uint32_t onehot_pair(int d) {
    return (unsigned)d < 2u ? (kBf16One << (16 * d)) : 0u;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// NT = n tiles = 4*cols / 8. Shared memory holds P once per block in B
// fragment order: [k tile][n tile][lane][2 registers] of bf16x2, so a warp
// reads each fragment as one conflict-free 8-byte load per thread.
template <int NT>
__global__ void __launch_bounds__(kThreads)
onehot_kernel(const uint16_t* __restrict__ planes, int rows,
              const int* __restrict__ idx0, int n, uint32_t* __restrict__ out,
              int keep, uint32_t* __restrict__ sink) {
    extern __shared__ uint4 smem4[];
    uint16_t* b16 = reinterpret_cast<uint16_t*>(smem4);
    const uint2* bfrag = reinterpret_cast<const uint2*>(smem4);
    constexpr int C4 = NT * 8;
    for (int e = threadIdx.x; e < rows * C4; e += blockDim.x) {
        const int k = e / C4, col = e % C4;
        const int kk = k & 15;
        const int lane = (col & 7) * 4 + ((kk & 7) >> 1);
        const int slot = (((k >> 4) * NT + (col >> 3)) * 32 + lane) * 2
                         + (kk >> 3);
        b16[slot * 2 + (kk & 1)] = planes[e];
    }
    __syncthreads();

    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int nwarps = (gridDim.x * blockDim.x) >> 5;
    const int kt_count = rows >> 4;
    const int tiles = (n + 16 * kMT - 1) / (16 * kMT);
    uint32_t fold = 0;
    for (int tile = warp; tile < tiles; tile += nwarps) {
        // this thread's lanes: rows g (h = 0) and g + 8 (h = 1) of each
        // M tile; lanes past n run index 0 and are not stored
        int idx[kMT][2];
        uint32_t acc[kMT][2];
#pragma unroll
        for (int m = 0; m < kMT; ++m) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int i = tile * 16 * kMT + m * 16 + g + 8 * h;
                idx[m][h] = i < n ? floor_mod(idx0[i], rows) : 0;
                acc[m][h] = 0;
            }
        }
        for (int s = 0; s < kChain; ++s) {
            // each row's one non-zero k tile, and its A registers there
            int hot[kMT][2];
            uint32_t lo[kMT][2], hi[kMT][2];
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    hot[m][h] = idx[m][h] >> 4;
                    const int d = (idx[m][h] & 15) - 2 * q;
                    lo[m][h] = onehot_pair(d);
                    hi[m][h] = onehot_pair(d - 8);
                }
            }
            float c[kMT][NT][4];
#pragma unroll
            for (int m = 0; m < kMT; ++m)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int j = 0; j < 4; ++j) c[m][nt][j] = 0.0f;
#pragma unroll 2
            for (int kt = 0; kt < kt_count; ++kt) {
                uint32_t a[kMT][4];
#pragma unroll
                for (int m = 0; m < kMT; ++m) {
                    const bool h0 = kt == hot[m][0], h1 = kt == hot[m][1];
                    a[m][0] = h0 ? lo[m][0] : 0u;
                    a[m][1] = h1 ? lo[m][1] : 0u;
                    a[m][2] = h0 ? hi[m][0] : 0u;
                    a[m][3] = h1 ? hi[m][1] : 0u;
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const uint2 b = bfrag[(kt * NT + nt) * 32 + lane];
#pragma unroll
                    for (int m = 0; m < kMT; ++m)
                        mma_bf16(c[m][nt], a[m], b.x, b.y);
                }
            }
            // decode word 0 of each row from plane columns 0-3 (exact:
            // each is one plane value 0-255 times 1.0), then step the chain
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t part = (uint32_t)c[m][0][2 * h]
                                    | ((uint32_t)c[m][0][2 * h + 1] << 8);
                    part = q < 2 ? part << (16 * q) : 0u;
                    part |= __shfl_xor_sync(kFull, part, 1);
                    const uint32_t r = __shfl_sync(kFull, part, lane & ~3);
                    acc[m][h] += r;
                    idx[m][h] = next_index(r, idx[m][h], rows);
                }
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        fold ^= __float_as_uint(c[m][nt][j]);
            }
        }
        if (q == 0) {
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = tile * 16 * kMT + m * 16 + g + 8 * h;
                    if (i < n) out[i] = acc[m][h];
                }
            }
        }
    }
    if (keep) sink[blockIdx.x * blockDim.x + threadIdx.x] = fold;
}

// K8: out[i, :] = T[floor_mod(idx[i], rows), :], moved as vectors V of
// 16, 8 or 4 bytes (vpr of them a row). Where a row is one vector (1, 2
// or 4 columns) a thread takes a row (rows_kernel_by_thread), in blocks
// of kRowThreads, so the grid covers the rows densely. Wider rows
// (rows_kernel_by_warp): a warp takes 32 rows at a time: lane l loads
// idx[base + l] and takes its floor mod, once per row; then the lanes walk
// the group's 32 * vpr vectors in order (vector k is vector k % vpr of row
// k / vpr, a shift where vpr is a power of two), each lane taking its
// row's offset from the row's lane by a shuffle, so neighbouring lanes
// load neighbouring pieces of a row and store neighbouring pieces of the
// output. A lane issues kRowBatch loads before its first store. All
// offsets are 32-bit: the wrapper checks rows * cols and n * cols < 2^31.
//
// What bounds it on the H100: the reference's tables (2.1 MB and 2 MB) sit
// in L2, and a call moves 0.26-2.1 MB, under 1 us at 3.35 TB/s; each warp
// waits two dependent L2 round trips (the index, then the row), so a call
// is its launch, that latency and the grid's tail (PERF.md, K8 row).
constexpr int kRowBatch = 4;
constexpr int kRowThreads = 128;

template <typename V>
__global__ void __launch_bounds__(kRowThreads)
rows_kernel_by_thread(const V* __restrict__ table, int rows,
                      const int* __restrict__ idx, int n,
                      V* __restrict__ out) {
    const int i = blockIdx.x * kRowThreads + threadIdx.x;
    if (i < n) out[i] = table[floor_mod(idx[i], rows)];
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
rows_kernel_by_warp(const V* __restrict__ table, int rows, int vpr,
                    int shift, const int* __restrict__ idx, int n,
                    V* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const int warp = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
    const int stride = gridDim.x * kThreads;
    const int per_group = 32 * vpr;
    for (long long b0 = warp * 32LL; b0 < n; b0 += stride) {
        const int base = (int)b0;
        const int left = n - base;
        const int src = lane < left ? floor_mod(idx[base + lane], rows) * vpr
                                    : 0;
        const int count = min(32, left) * vpr;
        V* dst = out + base * vpr;
        for (int k0 = lane; k0 < per_group; k0 += 32 * kRowBatch) {
            V v[kRowBatch];
#pragma unroll
            for (int b = 0; b < kRowBatch; ++b) {
                const int k = k0 + 32 * b;
                const int r = shift >= 0 ? k >> shift : k / vpr;
                const int at = __shfl_sync(kFull, src, r & 31);
                if (k < count) v[b] = table[at + (k - r * vpr)];
            }
#pragma unroll
            for (int b = 0; b < kRowBatch; ++b) {
                const int k = k0 + 32 * b;
                if (k < count) dst[k] = v[b];
            }
        }
    }
}

// SMs of the current device, read once per device
int sm_count(int* sms) {
    static int cache[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64) {
        return (int)cudaDeviceGetAttribute(
            sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (cache[dev] == 0) {
        err = cudaDeviceGetAttribute(&cache[dev],
                                     cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return (int)err;
    }
    *sms = cache[dev];
    return 0;
}

template <typename V>
int launch_rows(const void* table, int rows, int cols, const void* idx,
                int n, void* out, cudaStream_t stream) {
    constexpr int words = (int)(sizeof(V) / sizeof(uint32_t));
    const int vpr = cols / words;
    if (vpr == 1) {
        rows_kernel_by_thread<V><<<(n + kRowThreads - 1) / kRowThreads,
                                   kRowThreads, 0, stream>>>(
            (const V*)table, rows, (const int*)idx, n, (V*)out);
        return (int)cudaGetLastError();
    }
    const int shift = (vpr & (vpr - 1)) == 0 ? __builtin_ctz(vpr) : -1;
    int sms = 0;
    const int err = sm_count(&sms);
    if (err != 0) return err;
    // a warp a group of 32 rows, at most 8 blocks an SM (full occupancy
    // at 256 threads); more groups loop
    const long long groups = (n + 31LL) / 32;
    const long long need = (groups + kThreads / 32 - 1) / (kThreads / 32);
    const long long cap = 8LL * sms;
    rows_kernel_by_warp<V><<<(unsigned)(need < cap ? need : cap), kThreads,
                             0, stream>>>(
        (const V*)table, rows, vpr, shift, (const int*)idx, n, (V*)out);
    return (int)cudaGetLastError();
}

// blocks for a grid-stride kernel: as many as fit on the card at once, no
// more than the work needs
template <typename K>
cudaError_t resident_blocks(K kernel, size_t smem, long long needed,
                            unsigned* blocks) {
    cudaError_t err = cudaSuccess;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long fit = (long long)sms * per_sm;
    *blocks = (unsigned)(needed < fit ? (needed > 0 ? needed : 1) : fit);
    return cudaSuccess;
}

template <int NT>
cudaError_t launch_onehot(const void* planes, int rows, const void* idx,
                          int n, void* out, int keep, void* sink,
                          cudaStream_t stream) {
    const size_t smem = (size_t)rows * NT * 8 * sizeof(uint16_t);
    const int warps = kThreads / 32;
    const long long tiles = (n + 16LL * kMT - 1) / (16 * kMT);
    unsigned blocks = 0;
    cudaError_t err = resident_blocks(onehot_kernel<NT>, smem,
                                      (tiles + warps - 1) / warps, &blocks);
    if (err != cudaSuccess) return err;
    onehot_kernel<NT><<<blocks, kThreads, smem, stream>>>(
        (const uint16_t*)planes, rows, (const int*)idx, n, (uint32_t*)out,
        keep, (uint32_t*)sink);
    return cudaGetLastError();
}

}  // namespace

extern "C" int vvr_gather_chain(const void* table, int rows, int cols,
                                const void* idx, int n, void* out, int keep,
                                void* sink, void* stream) {
    chain_kernel<<<vvr_blocks(n, kThreads), kThreads, 0,
                   (cudaStream_t)stream>>>(
        (const uint32_t*)table, rows, cols, (const int*)idx, n,
        (uint32_t*)out, keep, (uint32_t*)sink);
    return (int)cudaGetLastError();
}

extern "C" int vvr_gather_chain_shared(const void* table, int rows, int cols,
                                       const void* idx, int n, void* out,
                                       int keep, void* sink, void* stream) {
    const size_t smem = (size_t)rows * cols * sizeof(uint32_t);
    unsigned blocks = 0;
    cudaError_t err = resident_blocks(chain_shared_kernel, smem,
                                      vvr_blocks(n, kThreads), &blocks);
    if (err != cudaSuccess) return (int)err;
    chain_shared_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)table, rows, cols, (const int*)idx, n,
        (uint32_t*)out, keep, (uint32_t*)sink);
    return (int)cudaGetLastError();
}

// cols4 = 4 * table columns = plane columns; 8, 16, 32 or 64
extern "C" int vvr_gather_onehot(const void* planes, int rows, int cols4,
                                 const void* idx, int n, void* out, int keep,
                                 void* sink, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (cols4) {
        case 8: return (int)launch_onehot<1>(planes, rows, idx, n, out, keep,
                                              sink, s);
        case 16: return (int)launch_onehot<2>(planes, rows, idx, n, out, keep,
                                               sink, s);
        case 32: return (int)launch_onehot<4>(planes, rows, idx, n, out, keep,
                                               sink, s);
        case 64: return (int)launch_onehot<8>(planes, rows, idx, n, out, keep,
                                               sink, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// table and out 16-byte aligned (the wrapper checks both); n > 0
extern "C" int vvr_gather_rows(const void* table, int rows, int cols,
                               const void* idx, int n, void* out,
                               void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if ((cols & 3) == 0)
        return launch_rows<uint4>(table, rows, cols, idx, n, out, s);
    if ((cols & 1) == 0)
        return launch_rows<uint2>(table, rows, cols, idx, n, out, s);
    return launch_rows<uint32_t>(table, rows, cols, idx, n, out, s);
}
