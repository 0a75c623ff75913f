// K5-K8: the gather microbenchmark kernels (ops/gather.py wraps them).
// They replace the six Pallas kernels of tools/microbench_gather.py and
// tools/microbench_gather2.py, which measured what a per-lane random row
// fetch costs on a TPU:
//
//   K5 gather_chain         pallas_take (:92), pallas_tala (gather2 :69);
//                           the table stays in device memory (L2)
//   K6 gather_chain_shared  pallas_vreg (:133); the table in shared memory
//   K7 gather_onehot        pallas_onehot (:177), pallas_onehot (gather2
//                           :112); the one-hot product on the tensor cores
//                           with wgmma
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
// it: ops/gather.py and the notes above K5 and K7 below.
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int kChain = 8;
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// K6 and K8: the floor mod through the compiler's 32-bit division
__device__ __forceinline__ int floor_mod(int x, int rows) {
    const int m = x % rows;
    return m < 0 ? m + rows : m;
}

// the chain's next index: (int32(r) ^ idx) mod rows, floor mod
__device__ __forceinline__ int next_index(uint32_t r, int idx, int rows) {
    return floor_mod((int)r ^ idx, rows);
}

// ---- K5 and K7: the floor mod without a division ----
//
// A power-of-two `rows` takes x & (rows - 1), exact for a negative int32 in
// two's complement. Any other `rows` in [1, 2^31) takes the direct
// remainder of Lemire, Kaser & Kurz ("Faster Remainder by Direct
// Computation", 2019, Theorem 1 with N = 32, F = 64): with M = ceil(2^64 /
// rows) (mod 2^64, from the host: ops/gather.py floor_mod_magic), a u32
// value a has a mod rows = hi64((M * a mod 2^64) * rows), exact for every
// a and rows below 2^32. The signed x is shifted to u = x + 2^31 (the sign
// bit flipped), so x mod rows = (u mod rows) - (2^31 mod rows), plus rows
// where that is negative. ops/gather.py floor_mod_twin is this arithmetic
// in numpy, held to torch.remainder in the CPU tests.
__device__ __forceinline__ uint32_t mod_u32(uint32_t a,
                                            unsigned long long magic,
                                            uint32_t rows) {
    return (uint32_t)__umul64hi(magic * a, (unsigned long long)rows);
}

template <bool kPow2>
struct FloorMod {
    int rows;
    unsigned long long magic;
    int bias;   // 2^31 mod rows

    __device__ __forceinline__ FloorMod(int rows_, unsigned long long m)
        : rows(rows_), magic(m),
          bias(kPow2 ? 0 : (int)mod_u32(0x80000000u, m, (uint32_t)rows_)) {}

    __device__ __forceinline__ int operator()(int x) const {
        if (kPow2) return x & (rows - 1);
        const int r = (int)mod_u32((uint32_t)x ^ 0x80000000u, magic,
                                   (uint32_t)rows) - bias;
        return r < 0 ? r + rows : r;
    }
};

// ---- K5: the chain with the table in device memory ----
//
// Each thread walks L lanes' chains interleaved (lanes t, t + S, ..., S the
// grid's threads), so it holds L independent row fetches in flight. Each
// step fetches every lane's whole row, as the TPU kernel's row take does,
// through the read-only path in the widest vectors the row allows (V:
// 16-, 8- or 4-byte; NV vectors a row, 0 when only the run time knows it):
// all L rows' loads issue before any is used, word 0 feeds the chain and
// the rest is folded into the sink's value. The floor mod is the
// division-free FloorMod, so nothing but the fetch is on a lane's chain.
//
// What bounds it on the H100: the dependent fetches. The reference's tables
// up to 266305 rows sit in L2; at 2 and 4 columns a step is a round trip
// to L2, and two lanes a thread keep two in flight (chain_lanes); from 8
// columns on the whole rows move 8 * lanes * 4 cols bytes through L1 and
// L2 (1.07 GB a call at 16 columns, which the HBM-bytes bound does not
// count), and one lane a thread measured fastest (PERF.md, K5 row).
template <typename V>
__device__ __forceinline__ uint32_t xor_words(V v);
template <>
__device__ __forceinline__ uint32_t xor_words(uint4 v) {
    return v.x ^ v.y ^ v.z ^ v.w;
}
template <>
__device__ __forceinline__ uint32_t xor_words(uint2 v) { return v.x ^ v.y; }
template <>
__device__ __forceinline__ uint32_t xor_words(uint32_t v) { return v; }

__device__ __forceinline__ uint32_t first_word(uint4 v) { return v.x; }
__device__ __forceinline__ uint32_t first_word(uint2 v) { return v.x; }
__device__ __forceinline__ uint32_t first_word(uint32_t v) { return v; }

template <int L, int NV, typename V, bool kPow2>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const V* __restrict__ table, int rows, int nv,
             const int* __restrict__ idx0, int n, uint32_t* __restrict__ out,
             int keep, uint32_t* __restrict__ sink,
             unsigned long long magic) {
    const FloorMod<kPow2> mod(rows, magic);
    const int vpr = NV > 0 ? NV : nv;
    const int t = blockIdx.x * kThreads + threadIdx.x;
    const int stride = gridDim.x * kThreads;
    int idx[L];
    uint32_t acc[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const long long i = t + (long long)l * stride;
        idx[l] = i < n ? mod(__ldg(idx0 + i)) : 0;
        acc[l] = 0;
    }
    uint32_t fold = 0;
#pragma unroll 1
    for (int s = 0; s < kChain; ++s) {
        V head[L];
#pragma unroll
        for (int l = 0; l < L; ++l) head[l] = __ldg(table + idx[l] * vpr);
        if (NV > 1) {
            V rest[L][NV > 1 ? NV - 1 : 1];
#pragma unroll
            for (int l = 0; l < L; ++l)
#pragma unroll
                for (int j = 1; j < NV; ++j)
                    rest[l][j - 1] = __ldg(table + idx[l] * vpr + j);
#pragma unroll
            for (int l = 0; l < L; ++l)
#pragma unroll
                for (int j = 1; j < NV; ++j) fold ^= xor_words(rest[l][j - 1]);
        } else if (NV == 0) {
#pragma unroll
            for (int l = 0; l < L; ++l) {
                const V* row = table + idx[l] * vpr;
#pragma unroll 4
                for (int j = 1; j < vpr; ++j) fold ^= xor_words(__ldg(row + j));
            }
        }
#pragma unroll
        for (int l = 0; l < L; ++l) {
            const uint32_t r = first_word(head[l]);
            fold ^= xor_words(head[l]);
            acc[l] += r;
            idx[l] = mod((int)r ^ idx[l]);
        }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
        const long long i = t + (long long)l * stride;
        if (i < n) out[i] = acc[l];
    }
    if (keep) sink[t] = fold;
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

// ---- K7: the one-hot product on the tensor cores, with wgmma ----
//
// Per chain step, G = onehot(idx) (lanes x rows, bf16) . P (rows x C4,
// bf16 u8 planes, C4 = 4 * cols = 8 NT) in f32, as wgmma.mma_async
// m64nC4k16: M = 64 lanes, K = 16 table rows, N = C4. Every k tile of
// every row is multiplied, as the MXU product is. The one-hot A comes from
// registers; P is B, read from shared memory through a matrix descriptor.
//
// The planes. One thread loads them once per CTA with TMA
// (cp.async.bulk.tensor, boxes of box_rows rows completing on one
// mbarrier) into wgmma's canonical MN-major layout: rows of C4 bf16, 8
// rows a core-matrix group; C4 = 8 is the layout without swizzle (a 16-byte
// row, core matrices of 128 contiguous bytes), C4 = 16, 32, 64 the 32-,
// 64- and 128-byte swizzled layouts that TMA writes. The k-group stride is
// 8 rows; the other stride is unused (N is one swizzle width), so both
// descriptor strides carry it. A k tile's descriptor is the first one plus
// 16 rows.
//
// The A operand. A thread's fragment (PTX ISA, wgmma .m64nNk16 A from
// registers) holds, for lanes g = lane / 4 and g + 8 of its warp's 16,
// the k pairs 2q, 2q + 1 and 2q + 8, 2q + 9 (q = lane % 4). Each lane's
// one-hot value at k tile kt is 1 where idx == 16 kt + k. With
// x = idx - 2q - (first row of the batch) packed as bf16x2 (x, x), one
// set.eq.bf16x2 against the constant pair (16 kk, 16 kk + 1) or
// (16 kk + 8, 16 kk + 9) gives a register of the fragment: 1.0 (0x3F80)
// or 0 in each half. So a fragment register is one instruction, x two a
// lane per batch of KB k tiles. The compare is exact: bf16 holds every
// integer up to 256 in magnitude, the targets are below 16 KB + 10 <= 138,
// and a larger |x| rounds to 256 or more.
//
// The pipeline. A CTA is kWarpgroups warpgroups; each walks pairs of
// 64-lane tiles (kTilesInFlight, one accumulator each). Per step, the k
// tiles go in batches of KB: the batch's fragments of both tiles are
// built, fenced (wgmma.fence), multiplied (2 KB wgmma, alternating the two
// accumulators), committed as one group and waited for before the next
// batch is built. ptxas serializes every wgmma of a kernel in which a
// fragment register is written while a wgmma is in flight (C7513), so a
// warpgroup cannot build its next batch under its own; the other
// warpgroups of the SM fill the tensor cores meanwhile. After the last
// batch the step decodes word 0 from the accumulator fragment: rows g and
// g + 8 hold plane columns 2q, 2q + 1 of n tile 0, so q = 0 has bytes 0-1
// and q = 1 bytes 2-3, and two shuffles give the quad the word (exact: each
// is one plane value 0-255 times 1.0). CTAs are persistent, as many as fit
// on the card (resident_blocks).
//
// What bounds it. At C4 = 64 a wgmma is 32 clocks of an SM's tensor cores
// and its fragment 4 instructions: the tensor cores set the pace. At C4 =
// 8 a wgmma is 4 tensor clocks, but its fragment is still 4 set.eq.bf16x2
// (HSET2, as many clocks as 4 LOP3 or more), a warpgroup waits for
// each batch before building the next, and registers leave room for 4
// warpgroups an SM: the wgmma issue and those waits, not the tensor cores,
// set K7's pace at 2 table columns (PERF.md, K7 row).
constexpr int kWarpgroups = 2;
constexpr int kOnehotThreads = 128 * kWarpgroups;
constexpr int kTilesInFlight = 2;

template <int NT>
struct Wgmma;

template <>
struct Wgmma<1> {
    static __device__ __forceinline__ void mma(
            float (&d)[4], const uint32_t (&a)[4], uint64_t desc,
            int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3}, "
            "{%4, %5, %6, %7}, %8, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d));
    }
};
template <>
struct Wgmma<2> {
    static __device__ __forceinline__ void mma(
            float (&d)[8], const uint32_t (&a)[4], uint64_t desc,
            int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7}, "
            "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d));
    }
};
template <>
struct Wgmma<4> {
    static __device__ __forceinline__ void mma(
            float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
            int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
            "%8, %9, %10, %11, %12, %13, %14, %15}, "
            "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d));
    }
};
template <>
struct Wgmma<8> {
    static __device__ __forceinline__ void mma(
            float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
            int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{%0, %1, %2, %3, %4, %5, %6, %7,\n"
            "%8, %9, %10, %11, %12, %13, %14, %15,\n"
            "%16, %17, %18, %19, %20, %21, %22, %23,\n"
            "%24, %25, %26, %27, %28, %29, %30, %31}, "
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
              "r"(scale_d));
    }
};


__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pin a register at this point of the program for the compiler: the
// fragments are defined before the fence, the accumulators read after the
// wait
__device__ __forceinline__ void pin(uint32_t& r) {
    asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void pin(float& r) {
    asm volatile("" : "+f"(r)::"memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// wgmma matrix descriptor: start address, leading and stride byte offsets
// in 16-byte units, layout (0 no swizzle, 1 128-byte, 2 64-byte, 3
// 32-byte swizzle) in bits 62-63
__device__ __forceinline__ uint64_t b_descriptor(uint32_t addr,
                                                 uint32_t stride,
                                                 uint32_t layout) {
    return (uint64_t)((addr & 0x3FFFF) >> 4)
           | ((uint64_t)(stride >> 4) << 16)
           | ((uint64_t)(stride >> 4) << 32) | ((uint64_t)layout << 62);
}

// bf16 of a small non-negative integer (exact below 256)
__host__ __device__ constexpr uint32_t bf16_int(int v) {
    int e = 0;
    while ((v >> (e + 1)) != 0) ++e;
    return v == 0 ? 0u
                  : (uint32_t)(((127 + e) << 7) | ((v << (7 - e)) & 0x7F));
}
// the pair (v, v + 1), low half first
__host__ __device__ constexpr uint32_t bf16_pair(int v) {
    return bf16_int(v) | (bf16_int(v + 1) << 16);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
    uint32_t d;
    asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
    return d;
}
__device__ __forceinline__ uint32_t eq_bf16x2(uint32_t x, uint32_t y) {
    uint32_t d;
    asm("set.eq.bf16x2.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(x), "r"(y));
    return d;
}

// the fragments of KB k tiles, for the two tiles in flight, from x of each
// (tile, row) at the batch's first table row
template <int KB>
__device__ __forceinline__ void build_a(uint32_t (&a)[kTilesInFlight][KB][4],
                                        const float (&x)[kTilesInFlight][2],
                                        float first) {
#pragma unroll
    for (int t = 0; t < kTilesInFlight; ++t) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const float v = x[t][h] - first;
            const uint32_t vv = pack_bf16x2(v, v);
#pragma unroll
            for (int kk = 0; kk < KB; ++kk) {
                a[t][kk][h] = eq_bf16x2(vv, bf16_pair(16 * kk));
                a[t][kk][h + 2] = eq_bf16x2(vv, bf16_pair(16 * kk + 8));
            }
        }
    }
#pragma unroll
    for (int t = 0; t < kTilesInFlight; ++t)
#pragma unroll
        for (int kk = 0; kk < KB; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j) pin(a[t][kk][j]);
}

// one batch: fence, the KB k tiles of both tiles, commit. The first batch
// of a step writes the accumulators (scale-d 0 at its first k tile). The
// descriptor comes as its two words: the low one (start address, leading
// offset) advances by 16 rows a k tile, the high one is constant.
template <int NT, int KB, bool kFirst>
__device__ __forceinline__ void mma_batch(
        float (&d)[kTilesInFlight][4 * NT],
        const uint32_t (&a)[kTilesInFlight][KB][4], uint32_t lo,
        uint32_t hi) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {
        // 16 rows of 16 NT bytes further, in the descriptor's 16-byte units
        const uint64_t dk = ((uint64_t)hi << 32) | (lo + kk * 16 * NT);
#pragma unroll
        for (int t = 0; t < kTilesInFlight; ++t)
            Wgmma<NT>::mma(d[t], a[t][kk], dk, kFirst && kk == 0 ? 0 : 1);
    }
    wgmma_commit();
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
                 "r"(count)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bytes)
        : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(phase)
            : "memory");
    } while (!done);
}
__device__ __forceinline__ void tma_load_rows(uint32_t dst,
                                              const CUtensorMap* map,
                                              int row, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(0), "r"(row), "r"(bar)
        : "memory");
}

// the descriptor layout of rows of 16 NT bytes: no swizzle for 16, else
// the swizzle as wide as the row (the one TMA writes)
template <int NT>
__host__ __device__ constexpr uint32_t b_layout() {
    return NT == 1 ? 0u : NT == 2 ? 3u : NT == 4 ? 2u : 1u;
}

template <int NT, int KB>
__global__ void __launch_bounds__(kOnehotThreads, 2)
onehot_kernel(const __grid_constant__ CUtensorMap planes, int rows,
              int box_rows, const int* __restrict__ idx0, int n,
              uint32_t* __restrict__ out, int keep,
              uint32_t* __restrict__ sink, unsigned long long magic) {
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    constexpr int kRowBytes = 16 * NT;
    // the planes from the first 1024-byte boundary (the 128-byte swizzle's
    // period), the mbarrier after them
    const uint32_t raw = smem_addr(smem_raw);
    const uint32_t base = (raw + 1023u) & ~1023u;
    const uint32_t bytes = (uint32_t)rows * kRowBytes;
    const uint32_t bar = base + bytes;
    if (threadIdx.x == 0) mbar_init(bar, 1);
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect(bar, bytes);
        for (int r = 0; r < rows; r += box_rows)
            tma_load_rows(base + (uint32_t)r * kRowBytes, &planes, r, bar);
    }

    const int wg = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
    const uint64_t desc = b_descriptor(base, 8 * kRowBytes, b_layout<NT>());
    const uint32_t desc_lo = (uint32_t)desc, desc_hi = (uint32_t)(desc >> 32);
    // one past the last batch: rows / 16 k tiles of 16 NT units each
    const uint32_t desc_end = desc_lo + (uint32_t)(rows >> 4) * 16 * NT;
    const bool pow2 = (rows & (rows - 1)) == 0;
    const FloorMod<false> magic_mod(rows, magic);
    auto mod = [&](int x) { return pow2 ? x & (rows - 1) : magic_mod(x); };
    const long long pairs = (n + 64LL * kTilesInFlight - 1)
                            / (64 * kTilesInFlight);
    uint32_t fold = 0;
    mbar_wait(bar, 0);

    for (long long p = (long long)blockIdx.x * kWarpgroups + wg; p < pairs;
         p += (long long)gridDim.x * kWarpgroups) {
        // this thread's lanes: rows g (h = 0) and g + 8 (h = 1) of its
        // warp's 16 in each tile; lanes past n run index 0, not stored
        int idx[kTilesInFlight][2];
        uint32_t acc[kTilesInFlight][2];
        float d[kTilesInFlight][4 * NT];
#pragma unroll
        for (int t = 0; t < kTilesInFlight; ++t) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const long long i = (p * kTilesInFlight + t) * 64
                                    + warp * 16 + g + 8 * h;
                idx[t][h] = i < n ? mod(__ldg(idx0 + i)) : 0;
                acc[t][h] = 0;
            }
#pragma unroll
            for (int j = 0; j < 4 * NT; ++j) d[t][j] = 0.0f;
        }
#pragma unroll 1
        for (int s = 0; s < kChain; ++s) {
            float x[kTilesInFlight][2];
#pragma unroll
            for (int t = 0; t < kTilesInFlight; ++t)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    x[t][h] = (float)(idx[t][h] - 2 * q);
            // each batch is built with no wgmma of this warpgroup in flight
            uint32_t a[kTilesInFlight][KB][4];
            build_a<KB>(a, x, 0.0f);
            mma_batch<NT, KB, true>(d, a, desc_lo, desc_hi);
            float first = 0.0f;
            for (uint32_t lo = desc_lo + KB * 16 * NT; lo != desc_end;
                 lo += KB * 16 * NT) {
                first += 16.0f * KB;
                wgmma_wait<0>();
                build_a<KB>(a, x, first);
                mma_batch<NT, KB, false>(d, a, lo, desc_hi);
            }
            wgmma_wait<0>();
#pragma unroll
            for (int t = 0; t < kTilesInFlight; ++t) {
#pragma unroll
                for (int j = 0; j < 4 * NT; ++j) {
                    pin(d[t][j]);
                    fold ^= __float_as_uint(d[t][j]);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t part = (uint32_t)d[t][2 * h]
                                    | ((uint32_t)d[t][2 * h + 1] << 8);
                    part = q < 2 ? part << (16 * q) : 0u;
                    part |= __shfl_xor_sync(kFull, part, 1);
                    const uint32_t r = __shfl_sync(kFull, part, lane & ~3);
                    acc[t][h] += r;
                    idx[t][h] = mod((int)r ^ idx[t][h]);
                }
            }
        }
        if (q == 0) {
#pragma unroll
            for (int t = 0; t < kTilesInFlight; ++t) {
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const long long i = (p * kTilesInFlight + t) * 64
                                        + warp * 16 + g + 8 * h;
                    if (i < n) out[i] = acc[t][h];
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

// blocks for a grid-stride kernel of `threads` threads: as many as fit on
// the card at once, no more than the work needs
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem,
                            long long needed, unsigned* blocks) {
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
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long fit = (long long)sms * per_sm;
    *blocks = (unsigned)(needed < fit ? (needed > 0 ? needed : 1) : fit);
    return cudaSuccess;
}

// K5's lanes per thread, by vectors a row: two where a row is one vector,
// one where a row is already several loads (1, 2 and 4 lanes measured on
// the H100: PERF.md, K5 row)
constexpr int chain_lanes(int nv) { return nv == 1 ? 2 : 1; }

template <int NV, typename V, bool kPow2>
cudaError_t launch_chain(const void* table, int rows, int nv,
                         const void* idx, int n, void* out, int keep,
                         void* sink, unsigned long long magic,
                         cudaStream_t stream) {
    constexpr int L = chain_lanes(NV);
    const long long threads = (n + L - 1LL) / L;
    chain_kernel<L, NV, V, kPow2>
        <<<vvr_blocks(threads, kThreads), kThreads, 0, stream>>>(
            (const V*)table, rows, nv, (const int*)idx, n, (uint32_t*)out,
            keep, (uint32_t*)sink, magic);
    return cudaGetLastError();
}

template <typename V, bool kPow2>
cudaError_t launch_chain_v(const void* table, int rows, int nv,
                           const void* idx, int n, void* out, int keep,
                           void* sink, unsigned long long magic,
                           cudaStream_t s) {
    switch (nv) {
        case 1: return launch_chain<1, V, kPow2>(table, rows, nv, idx, n,
                                                  out, keep, sink, magic, s);
        case 2: return launch_chain<2, V, kPow2>(table, rows, nv, idx, n,
                                                  out, keep, sink, magic, s);
        case 4: return launch_chain<4, V, kPow2>(table, rows, nv, idx, n,
                                                  out, keep, sink, magic, s);
        case 8: return launch_chain<8, V, kPow2>(table, rows, nv, idx, n,
                                                  out, keep, sink, magic, s);
        case 16: return launch_chain<16, V, kPow2>(table, rows, nv, idx, n,
                                                    out, keep, sink, magic,
                                                    s);
        default: return launch_chain<0, V, kPow2>(table, rows, nv, idx, n,
                                                   out, keep, sink, magic,
                                                   s);
    }
}

template <bool kPow2>
cudaError_t launch_chain_rows(const void* table, int rows, int cols,
                              const void* idx, int n, void* out, int keep,
                              void* sink, unsigned long long magic,
                              cudaStream_t s) {
    if ((cols & 3) == 0)
        return launch_chain_v<uint4, kPow2>(table, rows, cols / 4, idx, n,
                                            out, keep, sink, magic, s);
    if ((cols & 1) == 0)
        return launch_chain_v<uint2, kPow2>(table, rows, cols / 2, idx, n,
                                            out, keep, sink, magic, s);
    return launch_chain_v<uint32_t, kPow2>(table, rows, cols, idx, n, out,
                                           keep, sink, magic, s);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the
// library links the runtime only)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

cudaError_t encode_planes(CUtensorMap* map, const void* planes, int rows,
                          int cols4, int box_rows) {
    static EncodeTiled encode = nullptr;
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t err = cudaGetDriverEntryPoint(
            "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
        if (err != cudaSuccess) return err;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr)
            return cudaErrorNotSupported;
        encode = (EncodeTiled)fn;
    }
    const cuuint64_t dims[2] = {(cuuint64_t)cols4, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols4 * 2};
    const cuuint32_t box[2] = {(cuuint32_t)cols4, (cuuint32_t)box_rows};
    const cuuint32_t steps[2] = {1, 1};
    const CUtensorMapSwizzle swizzle =
        cols4 == 8 ? CU_TENSOR_MAP_SWIZZLE_NONE
        : cols4 == 16 ? CU_TENSOR_MAP_SWIZZLE_32B
        : cols4 == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                      : CU_TENSOR_MAP_SWIZZLE_128B;
    const CUresult r = encode(
        map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(planes),
        dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
        CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NT, int KB>
cudaError_t launch_onehot(const void* planes, int rows, int box_rows,
                          const void* idx, int n, void* out, int keep,
                          void* sink, int smem, unsigned long long magic,
                          cudaStream_t stream) {
    CUtensorMap map;
    cudaError_t err = encode_planes(&map, planes, rows, 8 * NT, box_rows);
    if (err != cudaSuccess) return err;
    const long long pairs = (n + 64LL * kTilesInFlight - 1)
                            / (64 * kTilesInFlight);
    unsigned blocks = 0;
    err = resident_blocks(onehot_kernel<NT, KB>, kOnehotThreads,
                          (size_t)smem,
                          (pairs + kWarpgroups - 1) / kWarpgroups, &blocks);
    if (err != cudaSuccess) return err;
    onehot_kernel<NT, KB><<<blocks, kOnehotThreads, smem, stream>>>(
        map, rows, box_rows, (const int*)idx, n, (uint32_t*)out, keep,
        (uint32_t*)sink, magic);
    return cudaGetLastError();
}

}  // namespace

// magic: ceil(2^64 / rows) mod 2^64 (ops/gather.py floor_mod_magic)
extern "C" int vvr_gather_chain(const void* table, int rows, int cols,
                                const void* idx, int n, void* out, int keep,
                                void* sink, unsigned long long magic,
                                void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    if ((rows & (rows - 1)) == 0)
        return (int)launch_chain_rows<true>(table, rows, cols, idx, n, out,
                                            keep, sink, magic, s);
    return (int)launch_chain_rows<false>(table, rows, cols, idx, n, out,
                                         keep, sink, magic, s);
}

extern "C" int vvr_gather_chain_shared(const void* table, int rows, int cols,
                                       const void* idx, int n, void* out,
                                       int keep, void* sink, void* stream) {
    const size_t smem = (size_t)rows * cols * sizeof(uint32_t);
    unsigned blocks = 0;
    cudaError_t err = resident_blocks(chain_shared_kernel, kThreads, smem,
                                      vvr_blocks(n, kThreads), &blocks);
    if (err != cudaSuccess) return (int)err;
    chain_shared_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint32_t*)table, rows, cols, (const int*)idx, n,
        (uint32_t*)out, keep, (uint32_t*)sink);
    return (int)cudaGetLastError();
}

// cols4 = 4 * table columns = plane columns: 8, 16, 32 or 64. kb (k tiles
// a batch), box_rows (rows a TMA box) and smem (bytes of shared memory)
// come from ops/gather.py onehot_plan; they are checked here.
extern "C" int vvr_gather_onehot(const void* planes, int rows, int cols4,
                                 const void* idx, int n, void* out, int keep,
                                 void* sink, int kb, int box_rows, int smem,
                                 unsigned long long magic, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int tiles = rows / 16;
    if (rows <= 0 || rows % 16 != 0 || box_rows < 16 || box_rows > 256
        || rows % box_rows != 0 || kb < 1 || tiles % kb != 0
        || (long long)smem < (long long)rows * cols4 * 2 + 1024 + 8)
        return (int)cudaErrorInvalidValue;
#define VVR_ONEHOT(NT, KB)                                                  \
    return (int)launch_onehot<NT, KB>(planes, rows, box_rows, idx, n, out,  \
                                      keep, sink, smem, magic, s)
    switch (cols4 * 16 + kb) {
        case 8 * 16 + 8: VVR_ONEHOT(1, 8);
        case 8 * 16 + 4: VVR_ONEHOT(1, 4);
        case 8 * 16 + 2: VVR_ONEHOT(1, 2);
        case 8 * 16 + 1: VVR_ONEHOT(1, 1);
        case 16 * 16 + 4: VVR_ONEHOT(2, 4);
        case 16 * 16 + 2: VVR_ONEHOT(2, 2);
        case 16 * 16 + 1: VVR_ONEHOT(2, 1);
        case 32 * 16 + 2: VVR_ONEHOT(4, 2);
        case 32 * 16 + 1: VVR_ONEHOT(4, 1);
        case 64 * 16 + 2: VVR_ONEHOT(8, 2);
        case 64 * 16 + 1: VVR_ONEHOT(8, 1);
        default: return (int)cudaErrorInvalidValue;
    }
#undef VVR_ONEHOT
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
