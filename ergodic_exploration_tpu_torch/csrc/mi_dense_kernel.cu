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
// one k1 and k2 in [b2, b2 + 128)) and a run of lattice rows (grid (S / 16,
// the tiles, Z); the wrapper picks Z so that the SMs are full); a thread owns
// one coefficient of 8 scenarios in registers. The
// block walks its lattice rows G at a time (a step; G = 4, 2 or 1, the most
// that keeps the most blocks an SM), so that every read of the beliefs runs
// along a map row (coalesced), every cell a block needs is read once, and a
// step's barriers serve G rows:
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
// Whatever else of a block's layout grows with the map or the lattice has a
// place in the workspace too, taken in this order as far as shared memory
// needs (M_SPILLS placements, m_layout): the rings; the y sums and frontier
// words (G rows of the map's width); the tile's Cx table (nsx rows); the
// lattice cells, the rings' row offsets (h each) and tags. The last keeps
// only R and vals in shared memory (at most 36 KB), so every shape launches:
// the same code reads each table through a pointer to either place, the
// same bits (a 4000 x 4000 map with r = fc = 3 takes the second: 52 KB of
// shared memory, 2.6 MB of workspace a block).
// The sampled field never goes to device memory. Every output is summed in a
// fixed order and nothing is atomic: two launches give the same bits (the
// association depends on Z, which the wrapper takes from S and the card, and
// not on G). At r = 0 vals equals the plain version's bit for bit (logf and
// log1pf without fast math, the clamp's float32 bounds, the threshold in
// float32); the sums of the box at r > 0 and the contraction run in another
// order than cuBLAS's (within rtol 2e-4 / atol 2e-5, the JAX package's budget
// for its MI kernel against this path).

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

// Mirror of ops/mi_dense_kernel.py::_Params (same field order).
struct MParams {
    int S, h, w, nsx, nsy, K, r, fc, Z, G, spill;
    float thr, lo, hi;  // occupied threshold; the entropy's clamp bounds
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
};

// k1 of a tile: T1 K <= 128 coefficients (K <= 11: all of them; past 128 one)
__host__ __device__ inline int m_t1(int K) { return K <= 11 ? K : (K <= M_KC ? M_KC / K : 1); }
// k2 of a tile: all of them up to K = 128, else 128
__host__ __device__ inline int m_t2(int K) { return K <= M_KC ? K : M_KC; }
// tiles of the coefficients: the grid's y
__host__ __device__ inline int m_tiles(int K) {
    return (K + m_t1(K) - 1) / m_t1(K) * ((K + m_t2(K) - 1) / m_t2(K));
}

__host__ __device__ inline int m_rows(int rad, int G, int h) {
    return 2 * rad + G < h ? 2 * rad + G : h;
}

// A block's memory, offsets in 4-byte words. Shared: the tile's Cx (nsx,
// t1p) with zero columns past T1, R (G, t1p, M_TS), vals (G, M_TS, vcp), the
// y sums P (r > 0, (G, M_TS, wp)), the frontier words F (fc > 0, (G, M_TS,
// ww)), the lattice columns and rows, the rings' row offsets and tags, then
// the rings: the entropy ring (r > 0), rows of (M_TS, wp) floats, and the
// known-free ring (fc > 0), rows of (M_TS, ww) words. The placement `spill`
// moves to the block's workspace, in the same order: from 1 the rings, from
// 2 P and F, from 3 Cx, from 4 the lattice columns and rows, the offsets
// and the tags (Cx first there, so that it is 16-byte aligned; a block's
// workspace a multiple of 4 words). Mirrored by
// ops/mi_dense_kernel.py::smem_bytes and work_bytes.
struct MLayout {
    int wp, wshift;  // row stride of entropies (odd: no bank conflicts); log2 of w's power of 2
    int ww;          // words of a bit row
    int re, rw;      // rows of the entropy ring and of the known-free ring (0: none)
    int vc, vcp;     // lattice columns a pass of vals; its row stride (odd)
    int t1p;         // the tile's k1, padded to a multiple of 4
    size_t cxq, R, vals, P, F, cxs, cys, offe, offw, tage, tagw, ering, wring;
    size_t shared_words, work_words;
    size_t erow, wrow;  // words of a ring row
};

__host__ __device__ inline MLayout m_layout(int h, int w, int nsx, int nsy, int K, int r, int fc,
                                            int G, int spill) {
    MLayout L;
    L.wp = w | 1;
    L.wshift = 0;
    while ((1 << L.wshift) < w) ++L.wshift;
    L.ww = (w + 31) / 32;
    L.re = r > 0 ? m_rows(r, G, h) : 0;
    L.rw = fc > 0 ? m_rows(fc, G, h) : 0;
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
    L.cxq = put(cx_g, (size_t)nsx * L.t1p);  // 16-byte aligned, as R (a multiple of 4 words on)
    L.R = put(false, (size_t)G * L.t1p * M_TS);
    L.vals = put(false, (size_t)G * M_TS * L.vcp);
    L.P = put(sums_g, r > 0 ? (size_t)G * L.erow : 0);
    L.F = put(sums_g, fc > 0 ? (size_t)G * L.wrow : 0);
    L.cxs = put(tables_g, nsx);
    L.cys = put(tables_g, nsy);
    L.offe = put(tables_g, h);
    L.offw = put(tables_g, h);
    L.tage = put(tables_g, L.re);
    L.tagw = put(tables_g, L.rw);
    L.ering = put(ring_g, (size_t)L.re * L.erow);
    L.wring = put(ring_g, (size_t)L.rw * L.wrow);
    L.shared_words = sh;
    L.work_words = (gl + 3) / 4 * 4;
    return L;
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

// whether a bit of the bit row f (ww words) is set in columns [x0, x1]
__device__ __forceinline__ bool m_any_bits(const uint32_t* f, int w, int x0, int x1) {
    x0 = x0 < 0 ? 0 : x0;
    x1 = x1 > w - 1 ? w - 1 : x1;
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

// the entropies of map row y of the block's scenarios into `row` (M_TS, wp),
// four loads in flight a thread
__device__ __forceinline__ void m_fill_entropy(float* row, const MLayout& L, const float* data,
                                               size_t plane, int y, int w, int ns,
                                               const MParams& p, MEnt3 e3) {
    const int items = M_TS << L.wshift, xm = (1 << L.wshift) - 1;
    for (int q0 = threadIdx.x; q0 < items; q0 += 4 * M_THREADS) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int q = q0 + k * M_THREADS, s = q >> L.wshift, x = q & xm;
            v[k] = (q < items && s < ns && x < w) ? __ldg(data + s * plane + (size_t)y * w + x)
                                                   : -1.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int q = q0 + k * M_THREADS, s = q >> L.wshift, x = q & xm;
            if (q < items && x < w) row[s * L.wp + x] = e3.of(v[k], p.lo, p.hi);
        }
    }
}

// the known-free words of map row y into `row` (M_TS, ww): a warp per
// (scenario, word), four at a time
__device__ __forceinline__ void m_fill_free(uint32_t* row, const MLayout& L, const float* data,
                                            size_t plane, int y, int w, int ns, float thr) {
    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, items = M_TS * L.ww;
    for (int u0 = wid; u0 < items; u0 += 4 * M_WARPS) {
        float v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int u = u0 + k * M_WARPS, s = u / L.ww, x = (u - s * L.ww) * 32 + lane;
            v[k] = (u < items && s < ns && x < w) ? __ldg(data + s * plane + (size_t)y * w + x)
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

// grid (ceil(S / M_TS), the tiles, Z): the partial sums of a run of lattice
// rows, in placement SPILL (an instance each, so that every table's place is
// known where the code is compiled)
template <int SPILL>
__global__ void __launch_bounds__(M_THREADS, M_BLOCKS_PER_SM) m_phik_dense(MParams p, MBuffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int K = p.K, T1 = m_t1(K), T2 = m_t2(K), n2 = (K + T2 - 1) / T2;
    const MLayout L = m_layout(p.h, p.w, p.nsx, p.nsy, K, p.r, p.fc, p.G, SPILL);
    float* smf = reinterpret_cast<float*>(smem_raw);
    uint32_t* smu = reinterpret_cast<uint32_t*>(smem_raw);
    const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    uint32_t* const work = SPILL > 0 ? b.work + block * L.work_words : nullptr;
    // a table's words in the workspace or in shared memory, as the placement has it
    auto at = [&](bool global, size_t off) { return (global ? work : smu) + off; };
    float* cxq = reinterpret_cast<float*>(at(SPILL >= 3, L.cxq));
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
    const int m = r > fc ? r : fc;
    const int tid = threadIdx.x;
    const int s0 = blockIdx.x * M_TS, ns = min(M_TS, p.S - s0);
    const int a1 = blockIdx.y / n2 * T1, t1n = min(T1, K - a1), t1p = L.t1p, nq = t1p / 4;
    const int b2 = blockIdx.y % n2 * T2, t2n = min(T2, K - b2);
    const size_t plane = (size_t)h * w;
    const float* data = b.data + (size_t)s0 * plane;
    const MEnt3 e3 = {m_entropy(-1.0f, p.lo, p.hi), m_entropy(0.0f, p.lo, p.hi),
                      m_entropy(1.0f, p.lo, p.hi)};
    // this block's lattice rows [iy0, iy1)
    const int per_run = (p.nsy + p.Z - 1) / p.Z;
    const int iy0 = blockIdx.z * per_run, iy1 = min(p.nsy, iy0 + per_run);
    // the accumulation: coefficient (k1l, k2) of scenarios [half * 8, half * 8 + 8)
    const int c = tid % M_KC, half = tid / M_KC;
    const bool cv = c < t1n * t2n;
    const int k1l = cv ? c / t2n : 0, k2 = cv ? b2 + c - k1l * t2n : 0;
    // the projection: row pg, scenario ps, k1 [4 pq, 4 pq + 4) of the tile
    const int ps = tid & (M_TS - 1), pq = (tid >> 4) % nq, pg = (tid >> 4) / nq;

    for (int q = tid; q < nsx * t1p; q += M_THREADS) {
        const int ix = q / t1p, k = q - ix * t1p;
        cxq[q] = k < t1n ? __ldg(b.cosx + (size_t)ix * K + a1 + k) : 0.0f;
    }
    for (int q = tid; q < nsx; q += M_THREADS) cxs[q] = b.cx[q];
    for (int q = tid; q < p.nsy; q += M_THREADS) cys[q] = b.cy[q];
    for (int y = tid; y < h; y += M_THREADS) {
        offe[y] = L.re ? (y % L.re) * (int)L.erow : 0;
        offw[y] = L.rw ? (y % L.rw) * (int)L.wrow : 0;
    }
    for (int q = tid; q < L.re + L.rw; q += M_THREADS) tage[q] = -1;  // tagw follows tage
    __syncthreads();

    float acc[M_SPT];
#pragma unroll
    for (int i = 0; i < M_SPT; ++i) acc[i] = 0.0f;
    for (int iy = iy0; iy < iy1;) {
        // 0. the step's rows [iy, iy + gn): as many (<= G) as the rings hold
        int lo = cys[iy], hi = lo, gn = 1;
        while (gn < p.G && iy + gn < iy1) {
            const int cn = cys[iy + gn], nlo = min(lo, cn), nhi = max(hi, cn);
            if ((L.re > 0 && L.re < h && nhi - nlo + 1 + 2 * r > L.re) ||
                (L.rw > 0 && L.rw < h && nhi - nlo + 1 + 2 * fc > L.rw))
                break;
            lo = nlo;
            hi = nhi;
            ++gn;
        }
        // the next step's new map rows on their way to L2
        if (iy + gn < iy1) {
            const int nb = min(h - 1, cys[min(iy1 - 1, iy + gn + p.G - 1)] + m);
            const int na = max(hi + m + 1, cys[iy + gn] - m);
            const int lines = (w + 31) / 32, items = (nb - na + 1) * M_TS * lines;
            for (int q = tid; q < items; q += M_THREADS) {
                const int y = na + q / (M_TS * lines), u = q % (M_TS * lines);
                const int s = u / lines, x = (u - s * lines) * 32;
                if (s < ns) m_prefetch_l2(data + s * plane + (size_t)y * w + x);
            }
        }
        if (r > 0 || fc > 0) {
            // 1. the rows entering the rings (tags are read here, written after the barrier)
            const int ea = max(0, lo - r), eb = min(h - 1, hi + r);
            const int fa = max(0, lo - fc), fb = min(h - 1, hi + fc);
            if (r > 0)
                for (int y = ea; y <= eb; ++y)
                    if (tage[y % L.re] != y)
                        m_fill_entropy(ering + offe[y], L, data, plane, y, w, ns, p, e3);
            if (fc > 0)
                for (int y = fa; y <= fb; ++y)
                    if (tagw[y % L.rw] != y)
                        m_fill_free(wring + offw[y], L, data, plane, y, w, ns, p.thr);
            __syncthreads();
            if (tid == 0) {
                if (r > 0)
                    for (int y = ea; y <= eb; ++y) tage[y % L.re] = y;
                if (fc > 0)
                    for (int y = fa; y <= fb; ++y) tagw[y % L.rw] = y;
            }
            // 2. each row's y sums of the entropies and frontier words
            if (r > 0) {
                const int items = (gn * M_TS) << L.wshift, xm = (1 << L.wshift) - 1;
                for (int q = tid; q < items; q += M_THREADS) {
                    const int gs = q >> L.wshift, x = q & xm;
                    if (x < w) {
                        const int cyv = cys[iy + (gs >> 4)], s = gs & (M_TS - 1);
                        float v = 0.0f;
#pragma unroll 4
                        for (int d = -r; d <= r; ++d)
                            v += ering[offe[m_clampi(cyv + d, h - 1)] + s * wp + x];
                        P[gs * wp + x] = v;
                    }
                }
            }
            if (fc > 0) {
                const int items = gn * M_TS * ww;
                for (int q = tid; q < items; q += M_THREADS) {
                    const int gs = q / ww, cyv = cys[iy + (gs >> 4)], o = (gs & (M_TS - 1)) * ww;
                    const int ya = max(0, cyv - fc), yb = min(h - 1, cyv + fc);
                    uint32_t word = 0u;
#pragma unroll 4
                    for (int y = ya; y <= yb; ++y) word |= wring[offw[y] + o + (q - gs * ww)];
                    F[q] = word;
                }
            }
            __syncthreads();
        }
        // 3. in passes of at most M_NV lattice columns: vals, then the projection
        float racc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int c0 = 0; c0 < nsx; c0 += L.vc) {
            const int vn = min(L.vc, nsx - c0), items = gn * M_TS * vn;
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
                    bv[k] = (q0 + k * M_THREADS < items && s < ns)
                                ? __ldg(data + s * plane + (size_t)cys[iy + (gs >> 4)] * w +
                                        cxs[c0 + j])
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
                    const int s = gk[k] & (M_TS - 1), cxv = cxs[c0 + jk[k]];
                    float v = 0.0f;
                    if (s < ns) {
                        float t;
                        if (r == 0) {
                            t = e3.of(bv[k], p.lo, p.hi);
                        } else {
                            const float* pr = P + gk[k] * wp;
                            t = 0.0f;
#pragma unroll 4
                            for (int a = -r; a <= r; ++a) t += pr[m_clampi(cxv + a, w - 1)];
                        }
                        bool keep = !(bv[k] >= p.thr);
                        if (fc > 0 && keep) keep = m_any_bits(F + gk[k] * ww, w, cxv - fc, cxv + fc);
                        v = t * (keep ? 1.0f : 0.0f);
                        v = v < 0.0f ? 0.0f : v;
                    }
                    vals[gk[k] * L.vcp + jk[k]] = v;
                }
            }
            __syncthreads();
            if (pg < gn) {
                const float* vr = vals + (pg * M_TS + ps) * L.vcp;
                const float4* cw = reinterpret_cast<const float4*>(cxq) + (size_t)c0 * nq + pq;
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
            if (s < ns) b.part[((size_t)(s0 + s) * p.Z + blockIdx.z) * KK + k] = acc[i];
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

// Bytes of dynamic shared memory a block of M uses, and of its workspace (the
// tables placement `spill` moves out of shared memory). The wrapper's
// smem_bytes and work_bytes mirror them; a host test holds the two against
// each other.
extern "C" size_t m_shared_bytes(int h, int w, int nsx, int nsy, int K, int r, int fc, int G,
                                 int spill) {
    return 4 * m_layout(h, w, nsx, nsy, K, r, fc, G, spill).shared_words;
}
extern "C" size_t m_work_bytes(int h, int w, int nsx, int nsy, int K, int r, int fc, int G,
                               int spill) {
    return 4 * m_layout(h, w, nsx, nsy, K, r, fc, G, spill).work_words;
}

// Launch M for p->S scenarios on `stream`: the runs, then m_finish. Returns
// the CUDA error code (0 on success). Does not synchronize.
extern "C" int m_phik_dense_launch(const MParams* params, const MBuffers* buffers,
                                   void* stream) {
    MParams p = *params;
    MBuffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    if (p.h < 1 || p.w < 1 || p.nsx < 1 || p.nsy < 1 || p.K < 1 || m_tiles(p.K) > 65535 ||
        p.r < 0 || p.fc < 0 || p.Z < 1 || p.Z > 65535 || p.G < 1 || p.G > M_GMAX ||
        p.spill < 0 || p.spill >= M_SPILLS || b.part == nullptr)
        return (int)cudaErrorInvalidValue;
    const MLayout L = m_layout(p.h, p.w, p.nsx, p.nsy, p.K, p.r, p.fc, p.G, p.spill);
    const size_t smem = 4 * L.shared_words;
    if (smem > (size_t)M_MAX_SMEM || (L.work_words && b.work == nullptr))
        return (int)cudaErrorInvalidValue;
    const dim3 grid((p.S + M_TS - 1) / M_TS, m_tiles(p.K), p.Z), block(M_THREADS);
    cudaError_t e;
    switch (p.spill) {
        case 0: e = launch_kernel(m_phik_dense<0>, grid, block, smem, st, p, b); break;
        case 1: e = launch_kernel(m_phik_dense<1>, grid, block, smem, st, p, b); break;
        case 2: e = launch_kernel(m_phik_dense<2>, grid, block, smem, st, p, b); break;
        case 3: e = launch_kernel(m_phik_dense<3>, grid, block, smem, st, p, b); break;
        default: e = launch_kernel(m_phik_dense<4>, grid, block, smem, st, p, b); break;
    }
    if (e != cudaSuccess) return (int)e;
    const size_t outs = (size_t)p.S * p.K * p.K;
    e = launch_kernel(m_finish, dim3((unsigned)((outs + 255) / 256)), dim3(256), 0, st, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
