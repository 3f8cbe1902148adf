// M — the dense mutual-information target for NVIDIA Hopper: phi_k of every
// scenario straight from its belief map, the batch in one call.
//
// Replaces no Pallas kernel: it is the counterpart of the XLA program that
// the JAX package compiles for ergodic_exploration_tpu/engine.py::
// _phik_grid_batch_dense_fn (:586-672), the MI target of config 4's default
// paths (explore_mapping_fused, replan_refresh_mi without K3, phik_from_grid
// on a shared domain). For every scenario, from its (h, w) belief map b
// (-1 unknown, else occupancy probability), at each point (ix, iy) of the
// nsx x nsy lattice, whose nearest cell is (cy[iy], cx[ix]):
//
//   e      = -(q log q + (1 - q) log1p(-q)),  q = clip(b < 0 ? 0.5 : b, lo, hi)
//   t      = sum over a, d in [-r, r] of e[clip(cy + d), clip(cx + a)]
//            (an edge cell counts once for each clipped offset)
//   keep   = b[cy, cx] < thr and (fc == 0 or some known-free cell,
//            0 <= b < thr, lies in the edge-clipped (2fc+1)^2 box)
//   vals   = max(t * keep, 0)
//   raw    = sum over (ix, iy) of vals Cx[ix, k1] Cy[iy, k2] / h_k
//   total  = raw[0] * h_k[0]
//   out    = total > 1e-12 ? raw / max(total, 1e-12) : fallback
//
// Cx (nsx, K) and Cy (nsy, K) are the lattice's per-axis cosine tables, h_k
// the basis normalization and fallback the uniform target (ops/
// mi_dense_kernel.py::dense_operands builds them, with cx and cy, by the
// plain version's own expressions): the plain version contracts the (S, N)
// values with the dense table D = Cx Cy / h_k, which is separable. Any K,
// any r, fc >= 0, any lattice (cells skipped or repeated), any map: as the
// JAX function's matmuls, no limit but the card's memory. Built by nvcc for
// sm_90a (utils/cuda_build.py) and called through the plain C entry point at
// the end of this file from ops/mi_dense_kernel.py.
//
// What bounds it on an H100: the beliefs, read once (164 MB at S = 4096 and
// 100 x 100 maps: 0.049 ms at 3.35 TB/s). The separable contraction is, per
// scenario and lattice row, nsx K multiply-adds of the row's projection and
// K^2 of its accumulation (~110 k a scenario at a 100 x 100 lattice, K = 10,
// against the 1 M of the dense table); the entropies, box sums and masks a
// few more per cell. In practice the latency of a lattice row's barrier-
// separated steps bounds it.
//
// What the design does about it: a block takes M_TS = 16 scenarios, a tile of
// the coefficients (k1 in [a1, a1 + T1), every k2: T1 K <= 128; past K = 128
// one k1 and k2 in [b2, b2 + 128)) and a run of lattice rows (the wrapper
// picks the runs, Z, so that the SMs are full); a thread owns one
// coefficient of 8 scenarios in registers. The block walks its lattice rows G
// at a time (a step; G = 4, 2 or 1, the most that keeps the most blocks an
// SM), so that every read of the beliefs runs along a map row, every cell a
// block needs is read once, and a step's barriers serve G rows:
//   1  rings of map rows around the step's cell rows (r > 0: the entropies of
//      the rows within r, the beliefs -1, 0 and 1, most of a map, taking
//      entropies computed once with the same expression: the same bits;
//      fc > 0: the known-free words of the rows within fc, a warp per
//      (scenario, 32 cells), __ballot_sync). A row entering a ring is read
//      once (the next step's new rows are prefetched into L2 a step ahead).
//      Rings over shared memory's room live in a workspace in device memory
//      (the _global variants: the same code, the same bits); r = 0 and
//      fc = 0 need no ring;
//   2  from the rings, for each row of the step: the y sums of the entropies
//      over [cy - r, cy + r], ascending (r > 0), and the frontier words, an
//      OR of the known-free words over [cy - fc, cy + fc] (fc > 0): an
//      edge-clipped box repeats only cells inside the clipped window, so "some
//      known-free cell in the box" needs no count and no limit on fc;
//   3  in passes of at most M_NV lattice columns: the vals of the step's rows
//      (the belief at (cy, cx) read along the row: the occupied test and, at
//      r = 0, the entropy; at r > 0 the x sum of the y sums, ascending; the
//      frontier bits of [cx - fc, cx + fc]) into shared memory, then each row's
//      projection R[s, k1] = sum over ix of vals Cx[ix, k1] (ascending ix, the
//      tile's Cx in shared memory for the block's life; a thread sums four k1
//      of one (row, scenario));
//   4  the accumulation acc[s, k1, k2] += Cy[iy, k2] R[s, k1], row after row;
//   5  the run's (16, T1 K) partial sums to device memory; m_finish, a thread
//      per (scenario, coefficient), adds the Z runs' partials in run order,
//      divides by h_k, normalizes by the mass or copies the fallback.
// Only the columns the lattice reads: where the lattice's windows, the
// edge-clipped [cx - m, cx + m] (m = max(r, fc)), cover fewer than the map's
// w columns (nsx (2m + 1) < w: a 100-column lattice on gmapping's 4000 x
// 4000 map takes 700), the rings, the y sums and the frontier words hold only
// the columns of their union, in ascending order (m_columns, one block
// before the runs, lists them and each lattice column's offset into the
// list); a window's columns are consecutive in the list, so the x sums and
// the frontier test read the same cells in the same order (the same bits).
// There, with r == fc, one read of a row's listed cells fills both rings
// (m_fill_listed). Elsewhere the tables keep every map column (the list
// would be the map).
// The values once (K > 11, more than one tile): the K <= 11 kernel does
// steps 1-5 for its one tile. Past it steps 1-3 run once, in M_VALUES mode
// (a block per 16 scenarios and run of rows), whose vals go to device memory
// ((S, nsy, nsx), the only place the sampled field is stored); then
// M_CONTRACT mode, a block per 16 scenarios, tile and run, reads them back
// in place of step 3's sampling and runs steps 3-5 for its tile. Both read
// and sum exactly what the one-kernel path would: the same bits for a given
// Z.
// Whatever else of a block's layout grows with the map or the lattice has a
// place in the workspace too, taken in this order as far as shared memory
// needs (M_SPILLS placements, m_layout): the rings; the y sums and frontier
// words (G rows of the tables' width); then the tile's Cx table (nsx rows)
// gives way to a pass's rows, staged from the cosine operand at each pass;
// then the lattice cells, the rings' row offsets (h each) and tags. The last
// keeps only a pass's Cx, R and vals in shared memory (at most 42 KB), so
// every shape launches: the same code reads each table through a pointer
// to either place, the same bits (a 4000 x 4000 map with r = fc = 3 takes
// the first past shared memory, the rings in the workspace).
// Every output is summed in a fixed order and nothing is atomic: two
// launches give the same bits (the association depends on Z, which the
// wrapper takes from S and the card, and not on G). At r = 0 vals equals the
// plain version's bit for bit (logf and log1pf without fast math, the
// clamp's float32 bounds, the threshold in float32); the sums of the box at
// r > 0 and the contraction run in another order than cuBLAS's (within rtol
// 2e-4 / atol 2e-5, the JAX package's budget for its MI kernel against this
// path).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

constexpr int M_THREADS = 256;
constexpr int M_WARPS = M_THREADS / 32;
constexpr int M_BLOCKS_PER_SM = 4;      // at most 64 registers a thread
constexpr int M_TS = 16;                // scenarios a block
constexpr int M_KC = 128;               // coefficients a block's tile holds (T1 K)
constexpr int M_HALVES = M_THREADS / M_KC;
constexpr int M_SPT = M_TS / M_HALVES;  // scenarios a thread accumulates
constexpr int M_NV = 128;               // most lattice columns of a pass of vals
constexpr int M_GMAX = 4;               // most lattice rows a step
constexpr int M_SPILLS = 5;             // placements of a block's tables (m_layout)
constexpr int M_MAX_SMEM = 232448;      // dynamic shared memory a block can have on sm_90
static_assert(M_SPT == 8 && M_TS == 16, "accumulation: two float4 of R a thread");
static_assert(M_GMAX * M_TS * 3 <= M_THREADS, "projection: a thread an item");

// what a launch of m_phik_dense does: steps 1-5 of one tile (K <= 11); steps
// 1-3 with the vals to device memory; steps 3-5 of a tile from those vals
enum { M_FUSED = 0, M_VALUES = 1, M_CONTRACT = 2 };

// Mirror of ops/mi_dense_kernel.py::_Params (same field order).
struct MParams {
    int S, h, w, nsx, nsy, K, r, fc;
    int Z, G, spill;     // the sampling kernel's runs, rows a step and placement
    int Zc, Gc, spillc;  // M_CONTRACT's (K > 11)
    int wc;              // the tables' width: w, or m_table_width's list of columns
    float thr, lo, hi;   // occupied threshold; the entropy's clamp bounds
};

// Mirror of ops/mi_dense_kernel.py::_Buffers (device pointers, same order).
struct MBuffers {
    const float* data;  // (S, h, w) beliefs
    const int* cx;      // (nsx,) nearest column of each lattice column
    const int* cy;      // (nsy,) nearest row of each lattice row
    const float *cosx, *cosy;  // (nsx, K), (nsy, K) per-axis cosine tables
    const float *hk, *fallback;  // (K^2,) each
    float* out;      // (S, K^2)
    float* part;     // (S, Z, K^2) the runs' partial sums
    uint32_t* work;  // the tables the placement moves out of shared memory, one set a block
    float* vals;     // (S, nsy, nsx) the lattice values (K > 11)
    int* cols;       // m_columns' list where wc < w: m_cols_words of them
};

// k1 of a tile: T1 K <= 128 coefficients (K <= 11: all of them; past 128 one)
__host__ __device__ inline int m_t1(int K) { return K <= 11 ? K : (K <= M_KC ? M_KC / K : 1); }
// k2 of a tile: all of them up to K = 128, else 128
__host__ __device__ inline int m_t2(int K) { return K <= M_KC ? K : M_KC; }
// tiles of the coefficients: M_CONTRACT's grid y
__host__ __device__ inline int m_tiles(int K) {
    return (K + m_t1(K) - 1) / m_t1(K) * ((K + m_t2(K) - 1) / m_t2(K));
}

__host__ __device__ inline int m_rows(int rad, int G, int h) {
    return 2 * rad + G < h ? 2 * rad + G : h;
}

// The tables' width: the map's w, or nsx (2m + 1) columns where that is fewer
// (room for the union of the lattice's windows, m = max(r, fc)).
__host__ __device__ inline int m_table_width(int w, int nsx, int r, int fc) {
    const int m = r > fc ? r : fc;
    const long long wc = (long long)nsx * (2 * m + 1);
    return m > 0 && wc < w ? (int)wc : w;
}

// Words of m_columns' list: the count, each lattice column's offset, the
// columns, then its scratch (a bit a map column, each word's rank).
__host__ __device__ inline size_t m_cols_words(int w, int nsx, int wc) {
    return 1 + (size_t)nsx + wc + 2 * (size_t)((w + 31) / 32);
}

// A block's memory, offsets in 4-byte words. Shared: the tile's Cx (nsx,
// t1p) with zero columns past T1, R (G, t1p, M_TS), vals (G, M_TS, vcp), the
// y sums P (r > 0, (G, M_TS, wp)), the frontier words F (fc > 0, (G, M_TS,
// ww)), the lattice columns and rows, the rings' row offsets and tags, then
// the rings: the entropy ring (r > 0), rows of (M_TS, wp) floats, and the
// known-free ring (fc > 0), rows of (M_TS, ww) words; wp and ww of the
// tables' width wc. M_VALUES has no Cx, R or vals, M_CONTRACT only those.
// The placement `spill` moves to the block's workspace, in the same order:
// from 1 the rings, from 2 P and F, from 4 the lattice columns and rows, the
// offsets and the tags (a block's workspace a multiple of 4 words); from 3
// the tile's Cx holds only a pass's vc rows, staged from the cosine operand
// at each pass. Mirrored by ops/mi_dense_kernel.py::smem_bytes and
// work_bytes.
struct MLayout {
    int wp, wshift;  // row stride of entropies (odd: no bank conflicts); log2 of wc's power of 2
    int ww;          // words of a bit row
    int re, rw;      // rows of the entropy ring and of the known-free ring (0: none)
    int vc, vcp;     // lattice columns a pass of vals; its row stride (odd)
    int t1p;         // the tile's k1, padded to a multiple of 4
    size_t cxq, R, vals, P, F, cxs, cys, offe, offw, tage, tagw, ering, wring;
    size_t shared_words, work_words;
    size_t erow, wrow;  // words of a ring row
};

__host__ __device__ inline MLayout m_layout(int h, int nsx, int nsy, int K, int r, int fc, int G,
                                            int spill, int mode, int wc) {
    MLayout L;
    const bool samples = mode != M_CONTRACT, projects = mode != M_VALUES;
    L.wp = wc | 1;
    L.wshift = 0;
    while ((1 << L.wshift) < wc) ++L.wshift;
    L.ww = (wc + 31) / 32;
    L.re = samples && r > 0 ? m_rows(r, G, h) : 0;
    L.rw = samples && fc > 0 ? m_rows(fc, G, h) : 0;
    const int passes = (nsx + M_NV - 1) / M_NV;
    L.vc = (nsx + passes - 1) / passes;
    L.vcp = L.vc | 1;
    L.t1p = (m_t1(K) + 3) / 4 * 4;
    L.erow = (size_t)M_TS * L.wp;
    L.wrow = (size_t)M_TS * L.ww;
    // in the workspace: the rings; P and F; Cx; the tables
    const bool ring_g = spill >= 1, sums_g = spill >= 2, cx_g = spill >= 3, tables_g = spill >= 4;
    size_t sh = 0, gl = 0;  // words taken of shared memory and of the workspace
    auto put = [&](bool global, size_t words) {
        size_t& at = global ? gl : sh;
        const size_t o = at;
        at += words;
        return o;
    };
    // Cx 16-byte aligned, as R (a multiple of 4 words on)
    L.cxq = put(false, projects ? (size_t)(cx_g ? L.vc : nsx) * L.t1p : 0);
    L.R = put(false, projects ? (size_t)G * L.t1p * M_TS : 0);
    L.vals = put(false, projects ? (size_t)G * M_TS * L.vcp : 0);
    L.P = put(sums_g, samples && r > 0 ? (size_t)G * L.erow : 0);
    L.F = put(sums_g, samples && fc > 0 ? (size_t)G * L.wrow : 0);
    L.cxs = put(tables_g, samples ? nsx : 0);
    L.cys = put(tables_g, samples ? nsy : 0);
    L.offe = put(tables_g, samples ? h : 0);
    L.offw = put(tables_g, samples ? h : 0);
    L.tage = put(tables_g, L.re);
    L.tagw = put(tables_g, L.rw);
    L.ering = put(ring_g, (size_t)L.re * L.erow);
    L.wring = put(ring_g, (size_t)L.rw * L.wrow);
    L.shared_words = sh;
    L.work_words = (gl + 3) / 4 * 4;
    return L;
}

// the sampling kernel's mode for K: one tile in one kernel, or the values once
__host__ __device__ inline int m_sampling_mode(int K) {
    return m_tiles(K) == 1 ? M_FUSED : M_VALUES;
}

__device__ __forceinline__ int m_clampi(int v, int hi) { return v < 0 ? 0 : (v > hi ? hi : v); }

// the entropy of a belief (NaN stays NaN, as torch.where and torch.clamp
// leave it)
__device__ __forceinline__ float m_entropy(float b, float lo, float hi) {
    const float q0 = b < 0.0f ? 0.5f : b;
    const float q = q0 < lo ? lo : (q0 > hi ? hi : q0);
    return -(q * logf(q) + (1.0f - q) * log1pf(-q));
}

struct MEnt3 {  // the entropies of the beliefs -1, 0 and 1
    float unknown, zero, one;
    __device__ __forceinline__ float of(float b, float lo, float hi) const {
        return b < 0.0f ? unknown : (b == 0.0f ? zero : (b == 1.0f ? one : m_entropy(b, lo, hi)));
    }
};

// whether a bit of the bit row f is set in positions [x0, x1] (0 <= x0 <= x1)
__device__ __forceinline__ bool m_any_bits(const uint32_t* f, int x0, int x1) {
    const int q0 = x0 >> 5, q1 = x1 >> 5;
    const uint32_t m0 = 0xffffffffu << (x0 & 31), m1 = 0xffffffffu >> (31 - (x1 & 31));
    if (q0 == q1) return (f[q0] & m0 & m1) != 0u;
    if (f[q0] & m0) return true;
    for (int q = q0 + 1; q < q1; ++q)
        if (f[q]) return true;
    return (f[q1] & m1) != 0u;
}

__device__ __forceinline__ void m_prefetch_l2(const float* p) {
#ifdef __CUDA_ARCH__
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
#endif
}

// The tables' columns: the map column at position u (u < nu) of the list,
// or u itself where the tables hold every map column (ucol null).
__device__ __forceinline__ int m_col(const int* ucol, int u) { return ucol ? __ldg(ucol + u) : u; }

// the entropies of map row y of the block's scenarios at the tables' nu
// columns into `row` (M_TS, wp), four loads in flight a thread
__device__ __forceinline__ void m_fill_entropy(float* row, const MLayout& L, const float* data,
                                               size_t plane, int y, int w, int nu,
                                               const int* ucol, int ns, const MParams& p,
                                               MEnt3 e3) {
    const int items = M_TS << L.wshift, um = (1 << L.wshift) - 1;
    for (int q0 = threadIdx.x; q0 < items; q0 += 4 * M_THREADS) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int q = q0 + k * M_THREADS, s = q >> L.wshift, u = q & um;
            v[k] = (q < items && s < ns && u < nu)
                       ? __ldg(data + s * plane + (size_t)y * w + m_col(ucol, u))
                       : -1.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int q = q0 + k * M_THREADS, s = q >> L.wshift, u = q & um;
            if (q < items && u < nu) row[s * L.wp + u] = e3.of(v[k], p.lo, p.hi);
        }
    }
}

// the known-free words of map row y at the tables' columns into `row`
// (M_TS, ww): a warp per (scenario, word), four at a time
__device__ __forceinline__ void m_fill_free(uint32_t* row, const MLayout& L, const float* data,
                                            size_t plane, int y, int w, int nu, const int* ucol,
                                            int ns, float thr) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, items = M_TS * L.ww;
    for (int u0 = wid; u0 < items; u0 += 4 * M_WARPS) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int u = u0 + k * M_WARPS, s = u / L.ww, c = (u - s * L.ww) * 32 + lane;
            v[k] = (u < items && s < ns && c < nu)
                       ? __ldg(data + s * plane + (size_t)y * w + m_col(ucol, c))
                       : -1.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int u = u0 + k * M_WARPS;
            if (u < items) {  // uniform in the warp
                const uint32_t kf = __ballot_sync(0xffffffffu, v[k] >= 0.0f && !(v[k] >= thr));
                if (lane == 0) row[u] = kf;
            }
        }
    }
}

// Where the rings hold the same rows (r == fc) and the tables the list of
// columns: the entropies and the known-free words of map row y in one read
// of its cells (the values m_fill_entropy and m_fill_free write), the list's
// rows padded to the ww words, so that a warp's 32 columns are one word of
// one scenario.
__device__ __forceinline__ void m_fill_listed(float* erow, uint32_t* wrow, const MLayout& L,
                                              const float* data, size_t plane, int y, int w,
                                              int nu, const int* ucol, int ns, const MParams& p,
                                              MEnt3 e3) {
    const int n32 = 32 * L.ww, items = M_TS * n32, lane = threadIdx.x & 31;
    for (int q0 = threadIdx.x; q0 < items; q0 += 4 * M_THREADS) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int q = q0 + k * M_THREADS, s = q / n32, u = q - s * n32;
            v[k] = (q < items && s < ns && u < nu)
                       ? __ldg(data + s * plane + (size_t)y * w + __ldg(ucol + u))
                       : -1.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int q = q0 + k * M_THREADS, s = q / n32, u = q - s * n32;
            if (q < items) {  // uniform in the warp: items and a warp's items are whole words
                if (u < nu) erow[s * L.wp + u] = e3.of(v[k], p.lo, p.hi);
                const uint32_t kf = __ballot_sync(0xffffffffu, v[k] >= 0.0f && !(v[k] >= p.thr));
                if (lane == 0) wrow[s * L.ww + (u >> 5)] = kf;
            }
        }
    }
}

// One block: the tables' list of columns where wc < w, in b.cols: nu, then
// each lattice column's offset xo (a map column c of its window is at
// position c - xo), then the columns in ascending order; the union of the
// edge-clipped windows [cx - m, cx + m] marked a bit a map column, the words'
// ranks by a block scan.
__global__ void __launch_bounds__(M_THREADS) m_columns(MParams p, MBuffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* scan = reinterpret_cast<int*>(smem_raw);  // M_THREADS sums, then the carry
    int& carry = scan[M_THREADS];
    const int tid = threadIdx.x, w = p.w, nsx = p.nsx, nwords = (w + 31) / 32;
    const int m = p.r > p.fc ? p.r : p.fc;
    int* xo = b.cols + 1;
    int* ucol = xo + nsx;
    uint32_t* bits = reinterpret_cast<uint32_t*>(ucol + p.wc);
    int* rank = reinterpret_cast<int*>(bits + nwords);
    for (int q = tid; q < nwords; q += M_THREADS) bits[q] = 0u;
    if (tid == 0) carry = 0;
    __syncthreads();
    for (int ix = tid; ix < nsx; ix += M_THREADS) {
        const int c = __ldg(b.cx + ix), a = max(0, c - m), z = min(w - 1, c + m);
        for (int q = a >> 5; q <= z >> 5; ++q) {
            const int lo = max(a, 32 * q) & 31, hi = min(z, 32 * q + 31) & 31;
            atomicOr(bits + q, (0xffffffffu << lo) & (0xffffffffu >> (31 - hi)));
        }
    }
    __syncthreads();
    for (int q0 = 0; q0 < nwords; q0 += M_THREADS) {
        const int q = q0 + tid, n = q < nwords ? __popc(bits[q]) : 0;
        scan[tid] = n;
        __syncthreads();
        for (int o = 1; o < M_THREADS; o <<= 1) {  // inclusive sums
            const int v = tid >= o ? scan[tid - o] : 0;
            __syncthreads();
            scan[tid] += v;
            __syncthreads();
        }
        if (q < nwords) rank[q] = carry + scan[tid] - n;
        __syncthreads();
        if (tid == M_THREADS - 1) carry += scan[tid];
        __syncthreads();
    }
    for (int q = tid; q < nwords; q += M_THREADS) {
        const uint32_t word = bits[q];
        int k = rank[q];
        for (int e = 0; e < 32; ++e)
            if (word >> e & 1u) ucol[k++] = 32 * q + e;
    }
    for (int ix = tid; ix < nsx; ix += M_THREADS) {
        const int a = max(0, __ldg(b.cx + ix) - m), q = a >> 5;
        xo[ix] = a - (rank[q] + __popc(bits[q] & ((1u << (a & 31)) - 1u)));
    }
    if (tid == 0) b.cols[0] = carry;
}

// grid (ceil(S / M_TS), tiles (M_CONTRACT; else 1), runs): the partial sums
// of a run of lattice rows (M_FUSED, M_CONTRACT) or its vals (M_VALUES), in
// placement SPILL, the tables at m_columns' list of columns where LISTED (an
// instance each, so that every table's place and width is known where the
// code is compiled)
template <int SPILL, int MODE, bool LISTED>
__global__ void __launch_bounds__(M_THREADS, M_BLOCKS_PER_SM) m_phik_dense(MParams p, MBuffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    constexpr bool SAMPLES = MODE != M_CONTRACT, PROJECTS = MODE != M_VALUES;
    const int K = p.K, T1 = m_t1(K), T2 = m_t2(K), n2 = (K + T2 - 1) / T2;
    const int G = MODE == M_CONTRACT ? p.Gc : p.G, runs = MODE == M_CONTRACT ? p.Zc : p.Z;
    const MLayout L = m_layout(p.h, p.nsx, p.nsy, K, p.r, p.fc, G, SPILL, MODE, p.wc);
    float* smf = reinterpret_cast<float*>(smem_raw);
    uint32_t* smu = reinterpret_cast<uint32_t*>(smem_raw);
    const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    uint32_t* const work = SPILL > 0 ? b.work + block * L.work_words : nullptr;
    // a table's words in the workspace or in shared memory, as the placement has it
    auto at = [&](bool global, size_t off) { return (global ? work : smu) + off; };
    float* cxq = smf + L.cxq;  // the tile's Cx: every lattice column, or a pass's (SPILL >= 3)
    float* R = smf + L.R;
    float* vals = smf + L.vals;
    float* P = reinterpret_cast<float*>(at(SPILL >= 2, L.P));
    uint32_t* F = at(SPILL >= 2, L.F);
    int* cxs = reinterpret_cast<int*>(at(SPILL >= 4, L.cxs));
    int* cys = reinterpret_cast<int*>(at(SPILL >= 4, L.cys));
    int* offe = reinterpret_cast<int*>(at(SPILL >= 4, L.offe));
    int* offw = reinterpret_cast<int*>(at(SPILL >= 4, L.offw));
    int* tage = reinterpret_cast<int*>(at(SPILL >= 4, L.tage));
    int* tagw = reinterpret_cast<int*>(at(SPILL >= 4, L.tagw));
    float* ering = reinterpret_cast<float*>(at(SPILL >= 1, L.ering));
    uint32_t* wring = at(SPILL >= 1, L.wring);
    const int h = p.h, w = p.w, r = p.r, fc = p.fc, wp = L.wp, ww = L.ww, nsx = p.nsx;
    const int nsy = p.nsy;
    const int m = r > fc ? r : fc;
    const int tid = threadIdx.x;
    const int s0 = blockIdx.x * M_TS, ns = min(M_TS, p.S - s0);
    const int a1 = blockIdx.y / n2 * T1, t1n = min(T1, K - a1), t1p = L.t1p, nq = t1p / 4;
    const int b2 = blockIdx.y % n2 * T2, t2n = min(T2, K - b2);
    const size_t plane = (size_t)h * w;
    const float* data = b.data + (size_t)s0 * plane;
    const MEnt3 e3 = {m_entropy(-1.0f, p.lo, p.hi), m_entropy(0.0f, p.lo, p.hi),
                      m_entropy(1.0f, p.lo, p.hi)};
    // the tables' columns: every map column, or m_columns' list (read where used)
    const int nu = LISTED ? __ldg(b.cols) : w;
    // this block's lattice rows [iy0, iy1)
    const int per_run = (nsy + runs - 1) / runs;
    const int iy0 = blockIdx.z * per_run, iy1 = min(nsy, iy0 + per_run);
    // the accumulation: coefficient (k1l, k2) of scenarios [half * 8, half * 8 + 8)
    const int c = tid % M_KC, half = tid / M_KC;
    const bool cv = PROJECTS && c < t1n * t2n;
    const int k1l = cv ? c / t2n : 0, k2 = cv ? b2 + c - k1l * t2n : 0;
    // the projection: row pg, scenario ps, k1 [4 pq, 4 pq + 4) of the tile
    const int ps = tid & (M_TS - 1), pq = PROJECTS ? (tid >> 4) % nq : 0,
              pg = PROJECTS ? (tid >> 4) / nq : 0;

    // the tile's Cx rows [c0, c0 + n) into cxq, zero columns past T1
    auto load_cx = [&](int c0, int n) {
        for (int q = tid; q < n * t1p; q += M_THREADS) {
            const int ix = q / t1p, k = q - ix * t1p;
            cxq[q] = k < t1n ? __ldg(b.cosx + (size_t)(c0 + ix) * K + a1 + k) : 0.0f;
        }
    };
    if (PROJECTS && SPILL < 3) load_cx(0, nsx);
    if (SAMPLES) {
        for (int q = tid; q < nsx; q += M_THREADS) cxs[q] = b.cx[q];
        for (int q = tid; q < nsy; q += M_THREADS) cys[q] = b.cy[q];
        for (int y = tid; y < h; y += M_THREADS) {
            offe[y] = L.re ? (y % L.re) * (int)L.erow : 0;
            offw[y] = L.rw ? (y % L.rw) * (int)L.wrow : 0;
        }
        for (int q = tid; q < L.re + L.rw; q += M_THREADS) tage[q] = -1;  // tagw follows tage
    }
    __syncthreads();

    float acc[M_SPT];
#pragma unroll
    for (int i = 0; i < M_SPT; ++i) acc[i] = 0.0f;
    for (int iy = iy0; iy < iy1;) {
        // 0. the step's rows [iy, iy + gn): as many (<= G) as the rings hold
        int gn = 1;
        if (!SAMPLES) {
            gn = min(G, iy1 - iy);
        } else {
            int lo = cys[iy], hi = lo;
            while (gn < G && iy + gn < iy1) {
                const int cn = cys[iy + gn], nlo = min(lo, cn), nhi = max(hi, cn);
                if ((L.re > 0 && L.re < h && nhi - nlo + 1 + 2 * r > L.re) ||
                    (L.rw > 0 && L.rw < h && nhi - nlo + 1 + 2 * fc > L.rw))
                    break;
                lo = nlo;
                hi = nhi;
                ++gn;
            }
            // the next step's new map rows on their way to L2: every map column,
            // or the first and last line of each lattice column's window
            if (iy + gn < iy1) {
                const int nb = min(h - 1, cys[min(iy1 - 1, iy + gn + G - 1)] + m);
                const int na = max(hi + m + 1, cys[iy + gn] - m);
                const int lines = LISTED ? 2 * nsx : (w + 31) / 32;
                const int items = (nb - na + 1) * M_TS * lines;
                for (int q = tid; q < items; q += M_THREADS) {
                    const int y = na + q / (M_TS * lines), u = q % (M_TS * lines);
                    const int s = u / lines, l = u - s * lines;
                    const int x = LISTED ? (l & 1 ? min(w - 1, cxs[l >> 1] + m)
                                                  : max(0, cxs[l >> 1] - m))
                                         : l * 32;
                    if (s < ns) m_prefetch_l2(data + s * plane + (size_t)y * w + x);
                }
            }
            if (r > 0 || fc > 0) {
                // 1. the rows entering the rings (tags are read here, written after the barrier)
                const int ea = max(0, lo - r), eb = min(h - 1, hi + r);
                const int fa = max(0, lo - fc), fb = min(h - 1, hi + fc);
                if (LISTED && r == fc) {  // the two rings' rows and tags are the same
                    for (int y = ea; y <= eb; ++y)
                        if (tage[y % L.re] != y)
                            m_fill_listed(ering + offe[y], wring + offw[y], L, data, plane, y, w,
                                          nu, b.cols + 1 + nsx, ns, p, e3);
                } else {
                    if (r > 0)
                        for (int y = ea; y <= eb; ++y)
                            if (tage[y % L.re] != y)
                                m_fill_entropy(ering + offe[y], L, data, plane, y, w, nu,
                                               LISTED ? b.cols + 1 + nsx : nullptr, ns, p, e3);
                    if (fc > 0)
                        for (int y = fa; y <= fb; ++y)
                            if (tagw[y % L.rw] != y)
                                m_fill_free(wring + offw[y], L, data, plane, y, w, nu,
                                            LISTED ? b.cols + 1 + nsx : nullptr, ns, p.thr);
                }
                __syncthreads();
                if (tid == 0) {
                    if (r > 0)
                        for (int y = ea; y <= eb; ++y) tage[y % L.re] = y;
                    if (fc > 0)
                        for (int y = fa; y <= fb; ++y) tagw[y % L.rw] = y;
                }
                // 2. each row's y sums of the entropies and frontier words
                if (r > 0) {
                    const int items = (gn * M_TS) << L.wshift, um = (1 << L.wshift) - 1;
                    for (int q = tid; q < items; q += M_THREADS) {
                        const int gs = q >> L.wshift, u = q & um;
                        if (u < nu) {
                            const int cyv = cys[iy + (gs >> 4)], s = gs & (M_TS - 1);
                            float v = 0.0f;
#pragma unroll 4
                            for (int d = -r; d <= r; ++d)
                                v += ering[offe[m_clampi(cyv + d, h - 1)] + s * wp + u];
                            P[gs * wp + u] = v;
                        }
                    }
                }
                if (fc > 0) {
                    const int items = gn * M_TS * ww;
                    for (int q = tid; q < items; q += M_THREADS) {
                        const int gs = q / ww, cyv = cys[iy + (gs >> 4)];
                        const int o = (gs & (M_TS - 1)) * ww;
                        const int ya = max(0, cyv - fc), yb = min(h - 1, cyv + fc);
                        uint32_t word = 0u;
#pragma unroll 4
                        for (int y = ya; y <= yb; ++y) word |= wring[offw[y] + o + (q - gs * ww)];
                        F[q] = word;
                    }
                }
                __syncthreads();
            }
        }
        // 3. in passes of at most M_NV lattice columns: vals, then the projection
        float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c0 = 0; c0 < nsx; c0 += L.vc) {
            const int vn = min(L.vc, nsx - c0), items = gn * M_TS * vn;
            // the pass's Cx rows (the last pass's projection is behind a barrier)
            if (PROJECTS && SPILL >= 3) load_cx(c0, vn);
            // item q: (row g, scenario s) = gs, column c0 + j; j runs fastest
            const int dgs = M_THREADS / vn, dj = M_THREADS - dgs * vn;
            int gs = tid / vn, j = tid - gs * vn;
            for (int q0 = tid; q0 < items; q0 += 4 * M_THREADS) {
                float bv[4];
                int gk[4], jk[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    gk[k] = gs;
                    jk[k] = j;
                    const int s = gs & (M_TS - 1);
                    const bool in = q0 + k * M_THREADS < items && s < ns;
                    if (SAMPLES)  // the belief at the lattice point
                        bv[k] = in ? __ldg(data + s * plane + (size_t)cys[iy + (gs >> 4)] * w +
                                           cxs[c0 + j])
                                   : 0.0f;
                    else  // the lattice value M_VALUES stored
                        bv[k] = in ? __ldg(b.vals + ((size_t)(s0 + s) * nsy + iy + (gs >> 4)) *
                                                        nsx + c0 + j)
                                   : 0.0f;
                    j += dj;
                    gs += dgs;
                    if (j >= vn) {
                        j -= vn;
                        ++gs;
                    }
                }
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    if (q0 + k * M_THREADS >= items) break;
                    const int s = gk[k] & (M_TS - 1);
                    float v = 0.0f;
                    if (!SAMPLES) {
                        v = bv[k];
                    } else if (s < ns) {
                        const int cxv = cxs[c0 + jk[k]];
                        // a map column c of this lattice column's window sits at c - xo
                        const int xo = LISTED ? __ldg(b.cols + 1 + c0 + jk[k]) : 0;
                        float t;
                        if (r == 0) {
                            t = e3.of(bv[k], p.lo, p.hi);
                        } else {
                            const float* pr = P + gk[k] * wp;
                            t = 0.0f;
#pragma unroll 4
                            for (int a = -r; a <= r; ++a) t += pr[m_clampi(cxv + a, w - 1) - xo];
                        }
                        bool keep = !(bv[k] >= p.thr);
                        if (fc > 0 && keep)
                            keep = m_any_bits(F + gk[k] * ww, max(0, cxv - fc) - xo,
                                              min(w - 1, cxv + fc) - xo);
                        v = t * (keep ? 1.0f : 0.0f);
                        v = v < 0.0f ? 0.0f : v;
                    }
                    if (PROJECTS)
                        vals[gk[k] * L.vcp + jk[k]] = v;
                    else if (s < ns)
                        b.vals[((size_t)(s0 + s) * nsy + iy + (gk[k] >> 4)) * nsx + c0 + jk[k]] =
                            v;
                }
            }
            if (!PROJECTS) continue;
            __syncthreads();
            if (pg < gn) {
                const float* vr = vals + (pg * M_TS + ps) * L.vcp;
                const float4* cw = reinterpret_cast<const float4*>(cxq) +
                                   (SPILL >= 3 ? 0 : (size_t)c0 * nq) + pq;
#pragma unroll 4
                for (int jj = 0; jj < vn; ++jj) {
                    const float v = vr[jj];
                    const float4 x4 = cw[jj * nq];
                    racc[0] = __fmaf_rn(v, x4.x, racc[0]);
                    racc[1] = __fmaf_rn(v, x4.y, racc[1]);
                    racc[2] = __fmaf_rn(v, x4.z, racc[2]);
                    racc[3] = __fmaf_rn(v, x4.w, racc[3]);
                }
                if (c0 + L.vc >= nsx) {  // the last pass: R of the step's rows
                    float* rr = R + ((size_t)pg * t1p + 4 * pq) * M_TS + ps;
#pragma unroll
                    for (int k = 0; k < 4; ++k) rr[k * M_TS] = racc[k];
                }
            }
            __syncthreads();
        }
        // 4. the accumulation, row after row of the step
        if (cv) {
            for (int g = 0; g < gn; ++g) {
                const float cy_k = __ldg(b.cosy + (size_t)(iy + g) * K + k2);
                const float4* rr =
                    reinterpret_cast<const float4*>(R + ((size_t)g * t1p + k1l) * M_TS + half * M_SPT);
                const float4 ra = rr[0], rb = rr[1];
                const float rv[M_SPT] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
#pragma unroll
                for (int i = 0; i < M_SPT; ++i) acc[i] = __fmaf_rn(rv[i], cy_k, acc[i]);
            }
        }
        iy += gn;
    }

    // 5. this run's partial sums
    if (cv) {
        const int k = (a1 + k1l) * K + k2, KK = K * K;
#pragma unroll
        for (int i = 0; i < M_SPT; ++i) {
            const int s = half * M_SPT + i;
            if (s < ns) b.part[((size_t)(s0 + s) * runs + blockIdx.z) * KK + k] = acc[i];
        }
    }
}

// a thread per (scenario, coefficient): the runs' partials added in run
// order and divided by h_k, normalized by the target's mass, or the fallback
__global__ void __launch_bounds__(256) m_finish(MParams p, MBuffers b) {
    const int KK = p.K * p.K;
    const size_t o = (size_t)blockIdx.x * 256 + threadIdx.x;
    if (o >= (size_t)p.S * KK) return;
    const size_t s = o / KK;
    const int k = (int)(o - s * KK);
    const float* part = b.part + s * p.Z * KK;
    float raw = 0.0f, raw00 = 0.0f;
    for (int z = 0; z < p.Z; ++z) {
        raw += part[(size_t)z * KK + k];
        raw00 += part[(size_t)z * KK];
    }
    const float t = (raw00 / b.hk[0]) * b.hk[0];
    b.out[o] = t > 1e-12f ? (raw / b.hk[k]) / fmaxf(t, 1e-12f) : b.fallback[k];
}

// Bytes of dynamic shared memory a block of M's sampling kernel uses (the
// one-tile kernel for K <= 11, else M_VALUES), and of its workspace (the
// tables placement `spill` moves out of shared memory), with the tables'
// width of m_table_width. m_mode_bytes gives either for any mode and width.
// The wrapper's smem_bytes and work_bytes mirror them; host tests hold the
// two against each other.
extern "C" size_t m_mode_bytes(int h, int w, int nsx, int nsy, int K, int r, int fc, int G,
                               int spill, int mode, int wc, int work) {
    (void)w;
    const MLayout L = m_layout(h, nsx, nsy, K, r, fc, G, spill, mode, wc);
    return 4 * (work ? L.work_words : L.shared_words);
}
extern "C" size_t m_shared_bytes(int h, int w, int nsx, int nsy, int K, int r, int fc, int G,
                                 int spill) {
    return m_mode_bytes(h, w, nsx, nsy, K, r, fc, G, spill, m_sampling_mode(K),
                        m_table_width(w, nsx, r, fc), 0);
}
extern "C" size_t m_work_bytes(int h, int w, int nsx, int nsy, int K, int r, int fc, int G,
                               int spill) {
    return m_mode_bytes(h, w, nsx, nsy, K, r, fc, G, spill, m_sampling_mode(K),
                        m_table_width(w, nsx, r, fc), 1);
}
extern "C" int m_columns_width(int w, int nsx, int r, int fc) {
    return m_table_width(w, nsx, r, fc);
}
extern "C" size_t m_columns_words(int w, int nsx, int wc) { return m_cols_words(w, nsx, wc); }

template <int MODE, bool LISTED>
static cudaError_t m_launch_mode(int spill, dim3 grid, size_t smem, cudaStream_t st, MParams& p,
                                 MBuffers& b) {
    const dim3 block(M_THREADS);
    switch (spill) {
        case 0: return launch_kernel(m_phik_dense<0, MODE, LISTED>, grid, block, smem, st, p, b);
        case 1: return launch_kernel(m_phik_dense<1, MODE, LISTED>, grid, block, smem, st, p, b);
        case 2: return launch_kernel(m_phik_dense<2, MODE, LISTED>, grid, block, smem, st, p, b);
        case 3: return launch_kernel(m_phik_dense<3, MODE, LISTED>, grid, block, smem, st, p, b);
        default: return launch_kernel(m_phik_dense<4, MODE, LISTED>, grid, block, smem, st, p, b);
    }
}

// Launch M for p->S scenarios on `stream`: m_columns where the tables hold a
// list of columns; the runs (K <= 11), or the values and then the tiles'
// contractions; then m_finish. Returns the CUDA error code (0 on success).
// Does not synchronize.
extern "C" int m_phik_dense_launch(const MParams* params, const MBuffers* buffers,
                                   void* stream) {
    MParams p = *params;
    MBuffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    const int mode = m_sampling_mode(p.K);
    if (p.h < 1 || p.w < 1 || p.nsx < 1 || p.nsy < 1 || p.K < 1 || m_tiles(p.K) > 65535 ||
        p.r < 0 || p.fc < 0 || p.Z < 1 || p.Z > 65535 || p.G < 1 || p.G > M_GMAX ||
        p.spill < 0 || p.spill >= M_SPILLS || b.part == nullptr ||
        (p.wc != p.w && p.wc != m_table_width(p.w, p.nsx, p.r, p.fc)) ||
        (p.wc < p.w && b.cols == nullptr))
        return (int)cudaErrorInvalidValue;
    if (mode == M_VALUES &&
        (b.vals == nullptr || p.Zc < 1 || p.Zc > 65535 || p.Gc < 1 || p.Gc > M_GMAX ||
         p.spillc < 0 || p.spillc >= M_SPILLS))
        return (int)cudaErrorInvalidValue;
    const MLayout L = m_layout(p.h, p.nsx, p.nsy, p.K, p.r, p.fc, p.G, p.spill, mode, p.wc);
    const size_t smem = 4 * L.shared_words;
    if (smem > (size_t)M_MAX_SMEM || (L.work_words && b.work == nullptr))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaSuccess;
    if (p.wc < p.w)
        e = launch_kernel(m_columns, dim3(1), dim3(M_THREADS), 4 * (M_THREADS + 1), st, p, b);
    if (e != cudaSuccess) return (int)e;
    const unsigned sb = (unsigned)((p.S + M_TS - 1) / M_TS);
    MParams pf = p;  // m_finish sums the runs of the kernel that made the partials
    const bool listed = p.wc < p.w;
    if (mode == M_FUSED) {
        const dim3 grid(sb, 1, p.Z);
        e = listed ? m_launch_mode<M_FUSED, true>(p.spill, grid, smem, st, p, b)
                   : m_launch_mode<M_FUSED, false>(p.spill, grid, smem, st, p, b);
    } else {
        // M_VALUES has no Cx table: placement 3 is placement 2's
        const int sv = p.spill == 3 ? 2 : p.spill;
        const dim3 grid(sb, 1, p.Z);
        e = listed ? m_launch_mode<M_VALUES, true>(sv, grid, smem, st, p, b)
                   : m_launch_mode<M_VALUES, false>(sv, grid, smem, st, p, b);
        const int sc = p.spillc >= 3 ? 3 : 0;  // M_CONTRACT's Cx: whole, or a pass's
        const MLayout C = m_layout(p.h, p.nsx, p.nsy, p.K, p.r, p.fc, p.Gc, sc, M_CONTRACT, p.wc);
        if (4 * C.shared_words > (size_t)M_MAX_SMEM || (C.work_words && b.work == nullptr))
            return (int)cudaErrorInvalidValue;
        if (e == cudaSuccess)
            e = m_launch_mode<M_CONTRACT, false>(sc, dim3(sb, m_tiles(p.K), p.Zc),
                                                 4 * C.shared_words, st, p, b);
        pf.Z = p.Zc;
    }
    if (e != cudaSuccess) return (int)e;
    const size_t outs = (size_t)p.S * p.K * p.K;
    e = launch_kernel(m_finish, dim3((unsigned)((outs + 255) / 256)), dim3(256), 0, st, pf, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
