// GMM target refresh over a shared sample lattice, for a tile of scenarios
// and a part of the lattice.
//
// Device half of the batched phi_k reduction that the JAX package runs in
// Pallas twice: inside K1 (ops/solve_kernel.py::_make_kernel, "in-kernel
// target refresh") and as K2 (ops/pallas_kernels.py::phik_from_gmm_pallas).
// One block evaluates the Gaussian mixtures of RT_S = 64 scenarios at the
// lattice points n_begin <= n < n_end and accumulates
//
//     acc[s, k] = sum_n phi_s(p_n) D[n, k]      tot[s] = sum_n phi_s(p_n)
//
// over RT_N-point chunks, then writes both sums to the caller's scratch as
// one part of the lattice split: K1 (k1_refresh) and K2 (k2_partial) launch
// it over (scenario tiles) x (lattice splits) and add the parts in split
// order in their own finishing kernels. With a free mask (S, mask_n),
// phi_s(p_n) is multiplied by mask[s, n] before both sums; points n >= mask_n
// (the lattice's padding) count as masked out, so the caller need not pad the
// mask.
//
// What bounds it on an H100: float32 multiply-adds outside the tensor cores
// (K^2 per scenario and point; exact float32 is part of the parity budget),
// then the J expf per scenario and point. In practice the shared-memory pipe
// is the scarce unit: a 128-bit shared load is served a quarter warp at a
// time, and a scheduler issues one instruction a cycle, so every load or
// index operation takes a multiply-add's slot. What the design does about it:
//   - each thread holds an 8 x 4 register tile (8 scenarios x 4
//     coefficients) fed by three 128-bit shared loads per lattice point: 32
//     multiply-adds per 3 loads. phi is stored point-major and a tile's 8
//     scenarios are two groups of 4 that lie 32 apart, so the 8 lanes of a
//     quarter warp load 32 consecutive floats (every bank once); the rows of
//     the table are padded to 4 floats and a quarter warp reads one address.
//     At K^2 = 100 that is 8 x 25 = 200 tiles on 256 threads (7 of 8 warps
//     issue); K^2 up to 256 takes two tiles a thread (the TILES = 2
//     instantiation, one block an SM);
//   - phi: a thread owns one scenario (lanes on neighbouring scenarios, so
//     the store is conflict free) and 16 points of the chunk; a component's
//     7 constants are read from shared memory once per chunk and held in
//     registers while the 16 points take them, the point as one 64-bit load;
//   - each chunk of the (Npad, K^2) table D is staged in shared memory once
//     for all 64 scenarios (read per scenario, D would cost S * Npad * K^2 * 4
//     bytes of L2 traffic: 16 GB per tick at S=4096, Npad=10,048, K=10), by
//     cp.async into the second of two buffers while the current one is
//     contracted;
//   - 73 KB of shared memory a block at K = 10, J = 2 and 128 registers, no
//     spills: two blocks share an SM (at three, 85 registers spill the tile:
//     measured slower), so one block's phi phase overlaps the other's
//     contraction;
//   - scenario groups beyond the batch are skipped, so S = 1 costs one
//     scenario's phi and 25 tiles per block;
//   - any K and J: the coefficients are cut into slabs of RT_SLAB = 256 (two
//     register tiles a thread), and a block contracts one slab at a time,
//     staging only that slab's columns of D and computing phi anew for each
//     (J Gaussians per point against 256 products); the caller puts the slabs
//     on the grid's z axis, one block a slab. The component constants are
//     staged RT_JC = 16 components at a time, so shared memory is bounded (174 KB at most) whatever K and J are. K^2 <= 256 is one
//     slab and J <= 16 one staging before the lattice loop: the arithmetic
//     and its order are then those of a single pass.
// Chunk partial sums are added to the running totals once per chunk, which
// keeps the float32 rounding of the 10k-term sums at the level of a blocked
// reduction.
//
// phi is computed with the exact expressions of ops/target.py::gmm_eval, so
// with -fmad=false every phi value rounds as PyTorch's elementwise ops round
// it; only the order of the two sums differs from the plain version.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k1 {

constexpr int RT_S = 64;         // scenarios per block (TILE_S in Python)
constexpr int RT_N = 64;         // lattice points per chunk (LATTICE_CHUNK in Python)
constexpr int RT_THREADS = 256;  // RT_S scenarios x RT_THREADS / RT_S points for phi
constexpr int RT_TS = 8, RT_TK = 4;  // the register tile: scenarios x coefficients (multiples of 4)
constexpr int RT_SG = RT_S / RT_TS;  // scenario groups
constexpr int RT_GS = 4 * RT_SG;         // scenarios between a tile's groups of 4 rows
constexpr int RT_PS = RT_S + 4;  // floats between two points' phi rows (16-byte rows, and a
                                 // transposed store of the mask conflicts 4 ways, not 32)
constexpr int RT_MIN_BLOCKS = 2;  // blocks meant to share an SM (TILES = 1; BLOCKS_PER_SM in Python)
constexpr int RT_SLAB = 256;     // coefficients a block contracts in one pass (SLAB in Python)
constexpr int RT_JC = 16;        // mixture components whose constants are staged at a time
constexpr int GP = 7;            // per-component constants: mx, my, a, 2b, c, 1/det, norm
constexpr float TWO_PI_F = 6.28318530717958647692f;
constexpr int RT_PQ = RT_THREADS / RT_S;  // phi: threads per scenario = stride of a thread's points
constexpr int RT_PPT = RT_N / RT_PQ;      // phi: points per thread and chunk
static_assert(RT_THREADS % RT_S == 0 && RT_N % RT_PQ == 0, "phi mapping");
static_assert(RT_TS % 4 == 0 && RT_TK % 4 == 0 && RT_S % RT_TS == 0, "register tile");

// Scenario (within the block) of row i of the register tiles of scenario
// group sg: rows come in groups of 4, group g at g * RT_GS + 4 sg, so that the
// 8 lanes of a quarter warp (sg = 0 .. 7) load 32 consecutive floats of a phi
// row with one 128-bit load each: every bank once.
__host__ __device__ inline int tile_row(int sg, int i) { return (i / 4) * RT_GS + 4 * sg + i % 4; }

// Slabs of at most RT_SLAB coefficients that K^2 = KK is cut into: slab l
// holds coefficients [l RT_SLAB, min(KK, (l + 1) RT_SLAB)).
__host__ __device__ inline int refresh_slabs(int KK) { return (KK + RT_SLAB - 1) / RT_SLAB; }

// n coefficients padded to whole groups of RT_TK
__host__ __device__ inline int refresh_pad(int n) { return (n + RT_TK - 1) / RT_TK * RT_TK; }

// The widest slab of K^2 = KK, padded: the columns of a staged row of D.
__host__ __device__ inline int refresh_kkp(int KK) {
    return refresh_pad(KK < RT_SLAB ? KK : RT_SLAB);
}

// True where the refresh needs more than one pass: K^2 = KK over RT_SLAB
// (more than one slab) or J over RT_JC (the constants staged in chunks).
__host__ __device__ inline bool refresh_cut(int KK, int J) {
    return refresh_slabs(KK) > 1 || J > RT_JC;
}

// Register tiles a thread needs for the widest slab of K^2 = KK (1 or 2).
__host__ __device__ inline int refresh_tiles(int KK) {
    return (RT_SG * (refresh_kkp(KK) / RT_TK) + RT_THREADS - 1) / RT_THREADS;
}

// Shared-memory floats of one block for K^2 = KK and J components.
__host__ __device__ inline size_t refresh_smem_floats(int KK, int J) {
    return (size_t)2 * RT_N * refresh_kkp(KK) + (size_t)RT_N * RT_PS +
           (size_t)GP * (J < RT_JC ? J : RT_JC) * RT_S + RT_THREADS;
}

// Asynchronous copies global -> shared (cp.async), in groups.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}
__device__ __forceinline__ void cp_async_4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// One block's part of the refresh for one slab of coefficients: scenarios
// s0 .. s0 + RT_S, lattice points n_begin .. n_end (multiples of RT_N),
// coefficients [slab RT_SLAB, min(KK, (slab + 1) RT_SLAB)). part_acc (S, KK)
// and part_tot (S) are this lattice split's rows of the scratch; the slab's
// columns of part_acc are written, part_tot by slab 0 alone; rows of
// scenarios >= S are not written. means (S, J, 2), covs (S, J, 2, 2),
// weights (S, J), pts (Npad, 2), D (Npad, KK); mask (S, mask_n) or nullptr.
// `sm` is 16-byte aligned shared memory of refresh_smem_floats(KK, J)
// floats. Must be called by all RT_THREADS threads of the block;
// TILES >= refresh_tiles(KK). CUT = refresh_cut(KK, J); without it slab is
// 0 and the block makes one pass with constant offsets (the instructions of
// a refresh that has no slabs).
template <int TILES, bool CUT>
__device__ __forceinline__ void gmm_refresh_part(
    int s0, int S, int J, int KK, int slab, int n_begin, int n_end,
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ weights, const float* __restrict__ pts,
    const float* __restrict__ D, const float* __restrict__ mask, int mask_n,
    float* sm, float* __restrict__ part_acc, float* __restrict__ part_tot) {
    const int tid = threadIdx.x;
    const int k0 = CUT ? slab * RT_SLAB : 0;                     // the slab's first coefficient
    const int KS = CUT ? (KK - k0 < RT_SLAB ? KK - k0 : RT_SLAB) : KK;  // and its width
    const int KSp = refresh_pad(KS), KG = KSp / RT_TK;
    const int JC = CUT ? (J < RT_JC ? J : RT_JC) : J;  // components staged at a time
    const bool restage = CUT && J > RT_JC;              // more than one staging per chunk
    float* Ds = sm;                                  // 2 buffers of RT_N x KSp
    float* phis = Ds + 2 * RT_N * refresh_kkp(KK);   // RT_N x RT_PS, point-major
    float* gp = phis + RT_N * RT_PS;                 // GP x JC x RT_S, component-major
    float* tots = gp + GP * JC * RT_S;               // RT_THREADS partial sums

    // constants of components j0 .. j0 + jn, with gmm_eval's expressions
    auto stage_components = [&](int j0, int jn) {
        for (int i = tid; i < RT_S * jn; i += RT_THREADS) {
            const int sl = i % RT_S, jl = i / RT_S, s = s0 + sl;
            float g[GP] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            if (s < S) {
                const size_t sj = (size_t)s * J + j0 + jl;
                const float a = covs[sj * 4 + 0], b = covs[sj * 4 + 1], c = covs[sj * 4 + 3];
                const float det = a * c - b * b;
                g[0] = means[sj * 2 + 0];
                g[1] = means[sj * 2 + 1];
                g[2] = a;
                g[3] = 2.0f * b;
                g[4] = c;
                g[5] = 1.0f / det;
                g[6] = weights[sj] / (TWO_PI_F * sqrtf(det));
            }
#pragma unroll
            for (int k = 0; k < GP; ++k) gp[(jl * GP + k) * RT_S + sl] = g[k];
        }
    };
    if (!restage) stage_components(0, J);
    // the pad columns of both table buffers stay zero (the copies never touch them)
    if (KSp != KS)
        for (int i = tid; i < 2 * RT_N; i += RT_THREADS)
            for (int k = KS; k < KSp; ++k) Ds[i * KSp + k] = 0.0f;

    // 16-byte copies where every row of the table starts on 16 bytes (a
    // slab starts on a multiple of RT_SLAB, so its rows do too)
    const bool vec = (KK & 3) == 0 && (reinterpret_cast<uintptr_t>(D) & 15) == 0;
    auto stage = [&](int n0, float* dst) {
        const float* src = D + (size_t)n0 * KK + k0;
        if (vec) {
            const int q4 = KS / 4;
            for (int i = tid; i < RT_N * q4; i += RT_THREADS) {
                const int n = i / q4, q = i % q4;
                cp_async_16(dst + n * KSp + 4 * q,
                            CUT ? src + (size_t)n * KK + 4 * q : src + 4 * i);
            }
        } else {
            for (int i = tid; i < RT_N * KS; i += RT_THREADS) {
                const int n = i / KS, k = i % KS;
                cp_async_4(dst + n * KSp + k, CUT ? src + (size_t)n * KK + k : src + i);
            }
        }
        cp_async_commit();
    };

    float acc[TILES][RT_TS][RT_TK];
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
        for (int i = 0; i < RT_TS; ++i)
#pragma unroll
            for (int k = 0; k < RT_TK; ++k) acc[t][i][k] = 0.0f;
    float tot_part = 0.0f;
    const int sl = tid % RT_S;        // phi: scenario column of this thread
    const int nq = tid / RT_S;        //      and its first point in the chunk
    const bool live = s0 + sl < S;    // this thread's scenario exists

    const int nchunks = (n_end - n_begin) / RT_N;
    if (nchunks > 0) stage(n_begin, Ds);
    __syncthreads();

    for (int c = 0; c < nchunks; ++c) {
        const int n0 = n_begin + c * RT_N;
        const float* Dc = Ds + (c & 1) * RT_N * KSp;
        if (c + 1 < nchunks) stage(n0 + RT_N, Ds + ((c + 1) & 1) * RT_N * KSp);
        if (mask) {  // the chunk's mask tile, read along the lattice, stored point-major
            for (int i = tid; i < RT_S * RT_N; i += RT_THREADS) {
                const int ms = i / RT_N, n = i % RT_N;
                phis[n * RT_PS + ms] = (s0 + ms < S && n0 + n < mask_n)
                                           ? mask[(size_t)(s0 + ms) * mask_n + n0 + n]
                                           : 0.0f;
            }
            __syncthreads();
        }
        // phi of this thread's RT_PPT points: a component's constants are read
        // once, then every point takes it (the sum over j stays in ascending
        // j); past RT_JC components the constants are staged chunk by chunk
        float phv[RT_PPT];
#pragma unroll
        for (int q = 0; q < RT_PPT; ++q) phv[q] = 0.0f;
        auto accumulate = [&](int jn) {  // the jn components staged in gp
            if (!live) return;
            const float2* pt2 = reinterpret_cast<const float2*>(pts) + n0 + nq;
            for (int j = 0; j < jn; ++j) {
                const float* gj = gp + j * GP * RT_S + sl;
                const float mx = gj[0 * RT_S], my = gj[1 * RT_S], ca = gj[2 * RT_S],
                            cb2 = gj[3 * RT_S], cc = gj[4 * RT_S], idet = gj[5 * RT_S],
                            nrm = gj[6 * RT_S];
#pragma unroll
                for (int q = 0; q < RT_PPT; ++q) {
                    const float2 pt = pt2[RT_PQ * q];
                    const float dx = pt.x - mx;
                    const float dy = pt.y - my;
                    const float qf = (cc * (dx * dx) - cb2 * dx * dy + ca * (dy * dy)) * idet;
                    phv[q] = phv[q] + nrm * expf(-0.5f * qf);
                }
            }
        };
        if (!CUT) {
            accumulate(J);
        } else {
            for (int j0 = 0; j0 < J; j0 += JC) {
                const int jn = J - j0 < JC ? J - j0 : JC;
                if (restage) {
                    if (j0 > 0) __syncthreads();  // every thread is done with the last chunk
                    stage_components(j0, jn);
                    __syncthreads();
                }
                accumulate(jn);
            }
        }
#pragma unroll
        for (int q = 0; q < RT_PPT; ++q) {
            const int n = nq + RT_PQ * q;
            float phi = phv[q];
            if (mask) phi = phi * phis[n * RT_PS + sl];
            phis[n * RT_PS + sl] = phi;
            tot_part = tot_part + phi;
        }
        if (c + 1 < nchunks) cp_async_wait<1>();
        else cp_async_wait<0>();
        __syncthreads();
#pragma unroll
        for (int t = 0; t < TILES; ++t) {
            const int tile = tid + t * RT_THREADS;
            const int sg = tile % RT_SG, kg = tile / RT_SG;
            if (kg < KG && s0 + sg * 4 < S) {
                float part[RT_TS][RT_TK];  // this chunk's sums
#pragma unroll
                for (int i = 0; i < RT_TS; ++i)
#pragma unroll
                    for (int k = 0; k < RT_TK; ++k) part[i][k] = 0.0f;
                const float* pp = phis + sg * 4;
                const float* dp = Dc + kg * RT_TK;
#pragma unroll 4
                for (int n = 0; n < RT_N; ++n) {
                    float ph[RT_TS], dv[RT_TK];
#pragma unroll
                    for (int i = 0; i < RT_TS; i += 4) {
                        const float4 v = *reinterpret_cast<const float4*>(
                            pp + n * RT_PS + (i / 4) * RT_GS);
                        ph[i] = v.x, ph[i + 1] = v.y, ph[i + 2] = v.z, ph[i + 3] = v.w;
                    }
#pragma unroll
                    for (int k = 0; k < RT_TK; k += 4) {
                        const float4 v = *reinterpret_cast<const float4*>(dp + n * KSp + k);
                        dv[k] = v.x, dv[k + 1] = v.y, dv[k + 2] = v.z, dv[k + 3] = v.w;
                    }
#pragma unroll
                    for (int i = 0; i < RT_TS; ++i)
#pragma unroll
                        for (int k = 0; k < RT_TK; ++k)
                            part[i][k] = fmaf(ph[i], dv[k], part[i][k]);
                }
#pragma unroll
                for (int i = 0; i < RT_TS; ++i)
#pragma unroll
                    for (int k = 0; k < RT_TK; ++k) acc[t][i][k] += part[i][k];
            }
        }
        __syncthreads();
    }

    tots[tid] = tot_part;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
        const int tile = tid + t * RT_THREADS;
        const int sg = tile % RT_SG, kg = tile / RT_SG;
        if (kg < KG) {
#pragma unroll
            for (int i = 0; i < RT_TS; ++i) {
                const int s = s0 + tile_row(sg, i);
#pragma unroll
                for (int k = 0; k < RT_TK; ++k) {
                    const int kk = kg * RT_TK + k;
                    if (s < S && kk < KS) part_acc[(size_t)s * KK + k0 + kk] = acc[t][i][k];
                }
            }
        }
    }
    __syncthreads();
    if (slab == 0 && tid < RT_S && s0 + tid < S) {
        float tsum = 0.0f;
        for (int l = 0; l < RT_THREADS / RT_S; ++l) tsum += tots[tid + l * RT_S];
        part_tot[s0 + tid] = tsum;
    }
}

}  // namespace k1
