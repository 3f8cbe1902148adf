// Host stand-in for the CUDA runtime, for tests only: lets the package's
// .cu sources compile as host C++ (g++ -std=c++20) and run a launch as one
// std::thread per CUDA thread of a block, block after block, with std::barrier for
// __syncthreads / __syncwarp and a per-warp exchange buffer for shuffles,
// ballots and the float64 tensor cores' fragments.
// It exists to check a kernel's indexing and arithmetic where there is no
// GPU; it says nothing about speed and does not model memory ordering.
#pragma once

// the sources' host branches (#elif defined(CUDA_HOST_STUB)) take this file's stand-ins
#define CUDA_HOST_STUB 1

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

using std::max;
using std::min;

struct uint3 {
    unsigned x, y, z;
};
struct dim3 {
    unsigned x, y, z;
    dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct alignas(8) float2 {
    float x, y;
};
struct alignas(16) float4 {
    float x, y, z, w;
};
struct alignas(16) double2 {
    double x, y;
};
struct alignas(16) uint4 {
    unsigned x, y, z, w;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) { return uint4{x, y, z, w}; }

typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaFuncSetAttribute(const void*, cudaFuncAttribute, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

inline thread_local uint3 threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

namespace host_stub {

struct Warp {
    std::barrier<> bar;
    uint64_t slot[32];
    int n;  // lanes of this warp
    explicit Warp(int n_) : bar(n_), n(n_) {}
};

inline thread_local unsigned char* dyn_smem = nullptr;
inline thread_local std::barrier<>* block_bar = nullptr;
inline thread_local std::atomic<int>* block_or = nullptr;  // __syncthreads_or's accumulator
inline thread_local Warp* warp = nullptr;

// Run `body` once per thread of every block of the grid, blocks in sequence:
// one std::thread per thread of a block, each walking the blocks in turn,
// all of them done with a block before the next starts. Dynamic shared
// memory starts each block as NaN bit patterns so that a read of a cell
// nobody wrote shows up in the result.
template <class F>
void run(dim3 grid, dim3 block, size_t smem, F body) {
    const unsigned nthreads = block.x * block.y * block.z, nblocks = grid.x * grid.y * grid.z;
    std::vector<float4> mem(smem / sizeof(float4) + 2);
    auto fresh = [&]() noexcept { memset(mem.data(), 0xFF, mem.size() * sizeof(float4)); };
    fresh();
    std::barrier<> bar(nthreads);
    std::barrier<decltype(fresh)> between(nthreads, fresh);
    std::atomic<int> any(0);
    std::vector<std::unique_ptr<Warp>> warps;
    for (unsigned w = 0; w * 32 < nthreads; ++w)
        warps.push_back(std::make_unique<Warp>((int)std::min(32u, nthreads - w * 32)));
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < nthreads; ++t)
        threads.emplace_back([&, t] {
            threadIdx = uint3{t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
            blockDim = block;
            gridDim = grid;
            dyn_smem = reinterpret_cast<unsigned char*>(mem.data());
            block_bar = &bar;
            block_or = &any;
            warp = warps[t / 32].get();
            for (unsigned b = 0; b < nblocks; ++b) {
                blockIdx = uint3{b % grid.x, (b / grid.x) % grid.y, b / (grid.x * grid.y)};
                body();
                between.arrive_and_wait();
            }
        });
    for (auto& th : threads) th.join();
}

}  // namespace host_stub

inline void __syncthreads() { host_stub::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { host_stub::warp->bar.arrive_and_wait(); }

// nonzero where `pred` is nonzero for any thread of the block; a barrier too
inline int __syncthreads_or(int pred) {
    std::atomic<int>& any = *host_stub::block_or;
    host_stub::block_bar->arrive_and_wait();  // the previous call's readers are done
    if (pred) any.fetch_or(1);
    host_stub::block_bar->arrive_and_wait();
    const int r = any.load();
    host_stub::block_bar->arrive_and_wait();
    if (threadIdx.x == 0 && threadIdx.y == 0 && threadIdx.z == 0) any.store(0);
    return r;
}

template <class T>
inline T __shfl_sync(unsigned, T v, int src) {
    static_assert(sizeof(T) <= sizeof(uint64_t), "shuffle of a wide type");
    host_stub::Warp& w = *host_stub::warp;
    const unsigned lane = (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
    memcpy(&w.slot[lane], &v, sizeof(T));
    w.bar.arrive_and_wait();
    T r;
    memcpy(&r, &w.slot[src & 31], sizeof(T));
    w.bar.arrive_and_wait();
    return r;
}
template <class T>
inline T __shfl_xor_sync(unsigned m, T v, int lane_mask) {
    const unsigned lane = (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
    return __shfl_sync(m, v, (int)(lane ^ (unsigned)lane_mask));
}

template <class T>
inline T __shfl_up_sync(unsigned m, T v, unsigned delta) {
    const unsigned lane = (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
    return __shfl_sync(m, v, (int)(lane >= delta ? lane - delta : lane));
}
template <class T>
inline T __shfl_down_sync(unsigned m, T v, unsigned delta) {
    const unsigned lane = (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
    return __shfl_sync(m, v, (int)(lane + delta < 32 ? lane + delta : lane));
}

namespace host_stub {

// mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 on the host, to the PTX
// ISA's fragment layout (g = lane / 4, t = lane % 4): a[2 i] = A[g][t + 4 i],
// a[2 i + 1] = A[g + 8][t + 4 i], b[i] = B[t + 4 i][g], d = C and then D at
// [g][2 t], [g][2 t + 1], [g + 8][2 t], [g + 8][2 t + 1]; D = A B + C, each
// element's sixteen products added to C in k order by fused multiply-adds.
// The fragments go round the warp's exchange slots, a register a round;
// every lane of a full warp takes part
inline void dmma_16x8x16(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
    Warp& w = *warp;
    if (w.n != 32) std::abort();
    const unsigned lane = (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
    const unsigned g = lane / 4, t = lane % 4;
    double A[2][16], B[16][2];  // this lane's rows g and g + 8 of A; columns 2 t, 2 t + 1 of B
    for (int r = 0; r < 12; ++r) {
        const double mine = r < 8 ? a[r] : b[r - 8];
        memcpy(&w.slot[lane], &mine, sizeof mine);
        w.bar.arrive_and_wait();
        for (unsigned k = 0; k < 16; ++k) {
            if (r < 8 && k / 4 == (unsigned)r / 2)  // A[g + 8 (r % 2)][k] is lane (g, k % 4)'s a[r]
                memcpy(&A[r % 2][k], &w.slot[g * 4 + k % 4], sizeof mine);
            if (r >= 8 && k / 4 == (unsigned)r - 8)  // B[k][n] is lane (n, k % 4)'s b[k / 4]
                for (unsigned h = 0; h < 2; ++h)
                    memcpy(&B[k][h], &w.slot[(2 * t + h) * 4 + k % 4], sizeof mine);
        }
        w.bar.arrive_and_wait();
    }
    for (int q = 0; q < 4; ++q)
        for (int k = 0; k < 16; ++k) d[q] = fma(A[q >> 1][k], B[k][q & 1], d[q]);
}

}  // namespace host_stub

inline unsigned __ballot_sync(unsigned, int pred) {
    host_stub::Warp& w = *host_stub::warp;
    const unsigned lane = (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z)) % 32;
    w.slot[lane] = pred ? 1 : 0;
    w.bar.arrive_and_wait();
    unsigned bits = 0;
    for (int l = 0; l < w.n; ++l) bits |= (unsigned)w.slot[l] << l;
    w.bar.arrive_and_wait();
    return bits;
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline bool __any_sync(unsigned m, int pred) { return __ballot_sync(m, pred) != 0u; }
inline bool __all_sync(unsigned m, int pred) { return __ballot_sync(m, !pred) == 0u; }

// low 32 bits of (hi:lo) >> (shift & 31)
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
    return (unsigned)((((uint64_t)hi << 32) | lo) >> (shift & 31u));
}

template <class T>
inline T __ldg(const T* p) { return *p; }

// the old value; *p becomes min(*p, v), atomically among the emulated threads
inline int atomicMin(int* p, int v) {
    std::atomic_ref<int> a(*p);
    int old = a.load();
    while (v < old && !a.compare_exchange_weak(old, v)) {
    }
    return old;
}

// the old value; *p becomes *p | v, atomically among the emulated threads
inline unsigned atomicOr(unsigned* p, unsigned v) {
    std::atomic_ref<unsigned> a(*p);
    return a.fetch_or(v);
}

// the old value; *p becomes *p + v, atomically among the emulated threads
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
    std::atomic_ref<unsigned long long> a(*p);
    return a.fetch_add(v);
}

inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

// the CUDA math intrinsics with an explicit rounding (to nearest even, the
// host's default mode; -ffp-contract=off keeps a product a product)
inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __int_as_float(int i) {
    float f;
    memcpy(&f, &i, sizeof f);
    return f;
}
inline int __float_as_int(float f) {
    int i;
    memcpy(&i, &f, sizeof i);
    return i;
}
