// GMM target refresh over a shared sample lattice, for a tile of scenarios.
//
// Device half of the batched phi_k reduction that the JAX package runs in
// Pallas twice: inside K1 (ops/solve_kernel.py::_make_kernel, "in-kernel
// target refresh") and as K2 (ops/pallas_kernels.py::phik_from_gmm_pallas).
// For RT_S scenarios at once it evaluates each scenario's Gaussian mixture
// at the lattice points n_begin <= n < n_end and accumulates
//
//     acc[s, k] = sum_n phi_s(p_n) D[n, k]      tot[s] = sum_n phi_s(p_n)
//
// over RT_N-point chunks (K1 walks the whole padded lattice in one block; K2
// splits it over a second grid dimension and adds the partial sums in a
// finishing kernel). With a free mask (S, mask_n), phi_s(p_n) is multiplied
// by mask[s, n] before both sums; points n >= mask_n (the lattice's padding)
// count as masked out, so the caller need not pad the mask. Each chunk of the
// (Npad, K^2) table D is staged in
// shared memory once and reused by all RT_S scenarios of the block (read per
// scenario, D would cost S * Npad * K^2 * 4 bytes of L2 traffic: 16 GB per
// tick at S=4096, N=10,240, K=10). Each thread keeps a 4 x 4 register tile
// (4 scenarios x 4 coefficients); chunk partial sums are added to the running
// totals once per chunk, which keeps the float32 rounding of the 10k-term
// sums at the level of a blocked reduction.
//
// phi is computed with the exact expressions of ops/target.py::gmm_eval, so
// with -fmad=false every phi value rounds as PyTorch's elementwise ops round
// it; only the order of the two sums differs from the plain version.
#pragma once

#include <cuda_runtime.h>

namespace k1 {

constexpr int RT_S = 32;        // scenarios per block
constexpr int RT_N = 64;        // lattice points per chunk (LATTICE_CHUNK in Python)
constexpr int RT_THREADS = 256; // 32 scenarios x 8 threads for phi; 4x4 tiles for acc
constexpr int RT_TILES = 2;     // accumulator tiles per thread: K^2 <= 256
constexpr int GP = 7;           // per-component constants: mx, my, a, 2b, c, 1/det, norm
constexpr float TWO_PI_F = 6.28318530717958647692f;

// Shared-memory floats used by gmm_refresh_tile for K^2 = KK and J components.
__host__ __device__ inline size_t refresh_smem_floats(int KK, int J) {
    return (size_t)RT_N * KK + (size_t)RT_S * (RT_N + 1) + (size_t)RT_S * J * GP + RT_THREADS;
}

// acc_out (RT_S x KK, in shared memory, may alias the start of `sm`) and
// tot_out (RT_S) receive the block's sums; rows of scenarios >= S are zero.
// means (S, J, 2), covs (S, J, 2, 2), weights (S, J), pts (Npad, 2),
// D (Npad, KK); n_begin and n_end are multiples of RT_N; mask (S, mask_n) or
// nullptr. Must be called by all RT_THREADS threads of the block.
__device__ inline void gmm_refresh_tile(
    int s0, int S, int J, int KK, int n_begin, int n_end,
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ weights, const float* __restrict__ pts,
    const float* __restrict__ D, const float* __restrict__ mask, int mask_n,
    float* sm, float* acc_out, float* tot_out) {
    const int tid = threadIdx.x;
    float* Ds = sm;                             // RT_N x KK
    float* phis = Ds + RT_N * KK;               // RT_S x (RT_N + 1), padded rows
    float* gp = phis + RT_S * (RT_N + 1);       // RT_S x J x GP
    float* tots = gp + RT_S * J * GP;           // RT_THREADS partial sums

    // per-component constants, with gmm_eval's expressions
    for (int i = tid; i < RT_S * J; i += RT_THREADS) {
        const int s = s0 + i / J;
        float* g = gp + i * GP;
        if (s < S) {
            const size_t sj = (size_t)s * J + i % J;
            const float a = covs[sj * 4 + 0], b = covs[sj * 4 + 1], c = covs[sj * 4 + 3];
            const float det = a * c - b * b;
            g[0] = means[sj * 2 + 0];
            g[1] = means[sj * 2 + 1];
            g[2] = a;
            g[3] = 2.0f * b;
            g[4] = c;
            g[5] = 1.0f / det;
            g[6] = weights[sj] / (TWO_PI_F * sqrtf(det));
        } else {
            for (int k = 0; k < GP; ++k) g[k] = 0.0f;
        }
    }

    const int KG = (KK + 3) / 4;      // coefficient groups of 4
    const int ntiles = (RT_S / 4) * KG;
    float acc[RT_TILES][4][4];
#pragma unroll
    for (int t = 0; t < RT_TILES; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[t][i][k] = 0.0f;
    float tot_part = 0.0f;
    const int sl = tid / 8;           // phi: scenario row of this thread
    const int n8 = tid % 8;           //      and its first point in the chunk
    __syncthreads();

    const bool live = s0 + sl < S;    // this thread's scenario row exists
    const float* mrow = mask ? mask + (size_t)(s0 + sl) * mask_n : nullptr;

    for (int n0 = n_begin; n0 < n_end; n0 += RT_N) {
        const float* Dsrc = D + (size_t)n0 * KK;
        for (int i = tid; i < RT_N * KK; i += RT_THREADS) Ds[i] = Dsrc[i];
        const float* g = gp + sl * J * GP;
        for (int q = 0; q < RT_N / 8; ++q) {
            const int n = n8 + 8 * q;
            const float px = pts[(size_t)(n0 + n) * 2 + 0];
            const float py = pts[(size_t)(n0 + n) * 2 + 1];
            float phi = 0.0f;
            for (int j = 0; j < J; ++j) {
                const float* gj = g + j * GP;
                const float dx = px - gj[0];
                const float dy = py - gj[1];
                const float qf = (gj[4] * (dx * dx) - gj[3] * dx * dy + gj[2] * (dy * dy)) * gj[5];
                phi = phi + gj[6] * expf(-0.5f * qf);
            }
            if (mask) phi = phi * ((live && n0 + n < mask_n) ? mrow[n0 + n] : 0.0f);
            phis[sl * (RT_N + 1) + n] = phi;
            tot_part = tot_part + phi;
        }
        __syncthreads();
#pragma unroll
        for (int t = 0; t < RT_TILES; ++t) {
            const int tile = tid + t * RT_THREADS;
            if (tile < ntiles) {
                const int sg = tile % 8, kg = tile / 8;
                float part[4][4];
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int k = 0; k < 4; ++k) part[i][k] = 0.0f;
                for (int n = 0; n < RT_N; ++n) {
                    float ph[4], dv[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) ph[i] = phis[(sg * 4 + i) * (RT_N + 1) + n];
#pragma unroll
                    for (int k = 0; k < 4; ++k) {
                        const int kk = kg * 4 + k;
                        dv[k] = kk < KK ? Ds[n * KK + kk] : 0.0f;
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i)
#pragma unroll
                        for (int k = 0; k < 4; ++k) part[i][k] = fmaf(ph[i], dv[k], part[i][k]);
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int k = 0; k < 4; ++k) acc[t][i][k] += part[i][k];
            }
        }
        __syncthreads();
    }

    tots[tid] = tot_part;
#pragma unroll
    for (int t = 0; t < RT_TILES; ++t) {
        const int tile = tid + t * RT_THREADS;
        if (tile < ntiles) {
            const int sg = tile % 8, kg = tile / 8;
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int kk = kg * 4 + k;
                    if (kk < KK) acc_out[(sg * 4 + i) * KK + kk] = acc[t][i][k];
                }
        }
    }
    __syncthreads();
    if (tid < RT_S) {
        float tsum = 0.0f;
        for (int l = 0; l < 8; ++l) tsum += tots[tid * 8 + l];
        tot_out[tid] = tsum;
    }
    __syncthreads();
}

}  // namespace k1
