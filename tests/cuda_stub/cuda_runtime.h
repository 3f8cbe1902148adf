// Host stand-in for the CUDA runtime, for tests only: lets the package's
// .cu sources compile as host C++ (g++ -std=c++20) and run a launch as one
// std::thread per CUDA thread, block after block, with std::barrier for
// __syncthreads / __syncwarp and a per-warp exchange buffer for shuffles.
// It exists to check a kernel's indexing and arithmetic where there is no
// GPU; it says nothing about speed and does not model memory ordering.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
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
inline float4 make_float4(float x, float y, float z, float w) { return float4{x, y, z, w}; }

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
    explicit Warp(int n) : bar(n) {}
};

inline thread_local unsigned char* dyn_smem = nullptr;
inline thread_local std::barrier<>* block_bar = nullptr;
inline thread_local Warp* warp = nullptr;

// Run `body` once per thread of every block of the grid, blocks in sequence.
// Dynamic shared memory starts as NaN bit patterns so that a read of a cell
// nobody wrote shows up in the result.
template <class F>
void run(dim3 grid, dim3 block, size_t smem, F body) {
    const unsigned nthreads = block.x * block.y * block.z;
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            std::vector<float4> mem(smem / sizeof(float4) + 2);
            memset(mem.data(), 0xFF, mem.size() * sizeof(float4));
            std::barrier<> bar(nthreads);
            std::vector<std::unique_ptr<Warp>> warps;
            for (unsigned w = 0; w * 32 < nthreads; ++w)
                warps.push_back(std::make_unique<Warp>((int)std::min(32u, nthreads - w * 32)));
            std::vector<std::thread> threads;
            for (unsigned t = 0; t < nthreads; ++t)
                threads.emplace_back([&, t] {
                    threadIdx = uint3{t % block.x, (t / block.x) % block.y, t / (block.x * block.y)};
                    blockIdx = uint3{bx, by, 0};
                    blockDim = block;
                    gridDim = grid;
                    dyn_smem = reinterpret_cast<unsigned char*>(mem.data());
                    block_bar = &bar;
                    warp = warps[t / 32].get();
                    body();
                });
            for (auto& th : threads) th.join();
        }
}

}  // namespace host_stub

inline void __syncthreads() { host_stub::block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { host_stub::warp->bar.arrive_and_wait(); }

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
inline T __ldg(const T* p) { return *p; }
