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
//   vals   = max(t * keep, 0)                       vals[s][ix * nsy + iy]
//   raw    = vals @ D                               (S, N) @ (N, K^2)
//   total  = raw[0] * hk00
//   out    = total > 1e-12 ? raw / max(total, 1e-12) : fallback
//
// D (N, K^2) is the dense basis table of the lattice and fallback its column
// means (ops/mi_dense_kernel.py::dense_operands builds them, with cx and cy,
// by the plain version's own expressions). Any K <= 128, any r, fc >= 0, any
// lattice (cells skipped or repeated), maps up to ~2,000 cells wide. Built by
// nvcc for sm_90a (utils/cuda_build.py) and called through the plain C entry
// point at the end of this file from ops/mi_dense_kernel.py.
//
// What bounds it on an H100: operations. The contraction is 2 S N K^2 flops
// (8.19 GFLOP at S = 4096, a 100 x 100 lattice, K = 10: 0.12 ms at the
// 67 TFLOP/s float32 peak), but only the lattice points whose vals are not 0
// need it; the beliefs are read once (164 MB, 0.049 ms at 3.35 TB/s). In
// practice the latency of the barrier-separated steps of a lattice row bounds
// it, not either rate.
//
// What the design does about it: a block takes M_TS = 16 scenarios, a tile of
// M_KT = 128 of the K^2 coefficients and a run of lattice rows (grid
// (S / 16, K^2 / 128, Z); the wrapper picks Z so that about four blocks an SM
// are in flight), so every lattice row of D is read from L2 once for 16
// scenarios, and the (16, 128) sums sit in registers: a thread owns one
// coefficient of 8 scenarios. The block walks its lattice rows one at a time,
// so that every read of the beliefs runs along a map row (coalesced) and
// every cell a block needs is read once:
//   1  two rings of map rows around the lattice row's cell row cy: the bit
//      ring holds the rows within m = max(r, fc), each as its occupied and
//      known-free words (a warp per (scenario, 32 cells), __ballot_sync); the
//      entropy ring the rows within r, each as its entropies (the beliefs -1,
//      0 and 1, most of a map, take entropies computed once with the same
//      expression: the same bits). A row entering a ring is read once (the
//      next lattice row's new rows are prefetched into L2 a step ahead).
//      Rings over shared memory's room live in a workspace in device memory
//      (the _global variants: the same code, the same bits);
//   2  from the rings: the y sums of the entropies over [cy - r, cy + r],
//      ascending (r > 0), and the frontier words, an OR of the known-free
//      words over [cy - fc, cy + fc] (fc > 0): an edge-clipped box repeats
//      only cells inside the clipped window, so "some known-free cell in the
//      box" needs no count and no limit on fc;
//   3  the vals of up to 128 lattice columns of the 16 scenarios (the x sum,
//      ascending; the occupied bit at (cy, cx); the frontier bits of
//      [cx - fc, cx + fc]) into shared memory, with a flag per (point, 8
//      scenarios) for "some val is not 0" (__ballot_sync);
//   4  chunk by chunk of at most M_NC points: the chunk's rows of D arrive by
//      cp.async, copied while the chunk before is contracted (two buffers);
//      each thread adds vals[s] * D[n][k] for its 8 scenarios, two points a
//      step (a broadcast float4 pair and one shared load of D a point),
//      skipping the points whose flag is clear (a warp's 8 scenarios are the
//      same 8: the branch is uniform, and adding 0 changes no bit);
//   5  its (16, 128) partial sums to device memory; m_finish, a thread per
//      (scenario, coefficient), adds the Z runs' partials in run order,
//      normalizes by raw[0] or copies the fallback.
// The sampled field never goes to device memory. Every output is summed in a
// fixed order and nothing is atomic: two launches give the same bits (the
// association depends on Z, which the wrapper takes from S and the card). At
// r = 0 vals equals the plain version's bit for bit (logf and log1pf without
// fast math, the clamp's float32 bounds, the threshold in float32); the sums
// of the box at r > 0 and of the contraction run in another order than
// cuBLAS's (within rtol 2e-4 / atol 2e-5, the JAX package's budget for its MI
// kernel against this path).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

constexpr int M_THREADS = 256;
constexpr int M_WARPS = M_THREADS / 32;
constexpr int M_BLOCKS_PER_SM = 4;      // at most 64 registers a thread
constexpr int M_TS = 16;                // scenarios a block
constexpr int M_KT = 128;               // coefficients a block (a tile of K^2)
constexpr int M_HALVES = M_THREADS / M_KT;
constexpr int M_SPT = M_TS / M_HALVES;  // scenarios a thread accumulates
constexpr int M_NC = 32;                // most lattice points a chunk of D
constexpr int M_GROUP = 4;              // chunks whose vals are formed together
constexpr int M_NV = M_NC * M_GROUP;    // most lattice points of vals
constexpr int M_KMAX = 128;
constexpr int M_MAX_SMEM = 232448;      // dynamic shared memory a block can have on sm_90
static_assert(M_SPT == 8 && M_TS == 16, "vals: two float4 a thread, two points a warp");

// Mirror of ops/mi_dense_kernel.py::_Params (same field order).
struct MParams {
    int S, h, w, nsx, nsy, KK, r, fc, Z, ring_global;
    float thr, lo, hi;  // occupied threshold; the entropy's clamp bounds
};

// Mirror of ops/mi_dense_kernel.py::_Buffers (device pointers, same order).
struct MBuffers {
    const float* data;  // (S, h, w) beliefs
    const int* cx;      // (nsx,) nearest column of each lattice column
    const int* cy;      // (nsy,) nearest row of each lattice row
    const float *D, *fallback, *hk00;
    float* out;      // (S, K^2)
    float* part;     // (S, Z, K^2) the runs' partial sums
    uint32_t* work;  // the rings of the _global variants, one set a block
};

// A block's memory, offsets in 4-byte words. Shared: two chunks of D, vals,
// the point flags, the y sums P (r > 0), the frontier words F (fc > 0), the
// lattice columns, the rings' row offsets and tags, then (unless
// ring_global) the rings: the entropy ring, rows of (M_TS, wp) floats, and
// the bit ring, rows of (M_TS, ww) occupied words and (fc > 0) as many
// known-free words. Mirrored by ops/mi_dense_kernel.py::smem_bytes.
struct MLayout {
    int wp, wshift;  // row stride of entropies (odd: no bank conflicts); log2 of w's power of 2
    int ww;          // words of a bit row
    int re, rw;      // rows of the entropy ring and of the bit ring
    size_t ds, vals, nz, P, F, cxs, offe, offw, tage, tagw, ring, shared_words;
    size_t erow, wrow, ering_words;  // words of a ring row; of the entropy ring
};

__host__ __device__ inline int m_rows(int rad, int h) {
    return rad >= h ? h : (2 * rad + 1 < h ? 2 * rad + 1 : h);
}

__host__ __device__ inline MLayout m_layout(int h, int w, int nsx, int r, int fc,
                                            int ring_global) {
    MLayout L;
    L.wp = w | 1;
    L.wshift = 0;
    while ((1 << L.wshift) < w) ++L.wshift;
    L.ww = (w + 31) / 32;
    L.re = m_rows(r, h);
    L.rw = m_rows(r > fc ? r : fc, h);
    L.erow = (size_t)M_TS * L.wp;
    L.wrow = (size_t)M_TS * L.ww * (fc > 0 ? 2 : 1);
    L.ering_words = (size_t)L.re * L.erow;
    L.ds = 0;  // (2, M_NC, M_KT), 16-byte aligned
    L.vals = L.ds + 2 * (size_t)M_NC * M_KT;  // (M_NV, M_TS), 16-byte aligned
    L.nz = L.vals + (size_t)M_NV * M_TS;      // (2, M_NV) bytes
    L.P = L.nz + M_NV / 2;
    L.F = L.P + (r > 0 ? L.erow : 0);
    L.cxs = L.F + (fc > 0 ? (size_t)M_TS * L.ww : 0);
    L.offe = L.cxs + nsx;
    L.offw = L.offe + h;
    L.tage = L.offw + h;
    L.tagw = L.tage + L.re;
    L.ring = L.tagw + L.rw;
    L.shared_words = L.ring + (ring_global ? 0 : L.ering_words + (size_t)L.rw * L.wrow);
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

// Asynchronous copies global -> shared (cp.async), committed as groups;
// m_copy_wait<N> waits until at most N of this thread's groups are pending.
__device__ __forceinline__ void m_copy16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    for (int i = 0; i < 4; ++i) dst[i] = src[i];
#endif
}
__device__ __forceinline__ void m_copy4(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
#else
    *dst = *src;
#endif
}
__device__ __forceinline__ void m_copy_commit() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.commit_group;\n" ::);
#endif
}
template <int N>
__device__ __forceinline__ void m_copy_wait() {
#ifdef __CUDA_ARCH__
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
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
            const float b = v[k];
            if (q < items && x < w)
                row[s * L.wp + x] =
                    b < 0.0f ? e3.unknown
                             : (b == 0.0f ? e3.zero
                                          : (b == 1.0f ? e3.one : m_entropy(b, p.lo, p.hi)));
        }
    }
}

// the occupied and (fc > 0) known-free words of map row y into `row`: a warp
// per (scenario, word), four at a time
__device__ __forceinline__ void m_fill_bits(uint32_t* row, const MLayout& L, const float* data,
                                            size_t plane, int y, int w, int ns, int fc,
                                            float thr) {
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
                const uint32_t occ = __ballot_sync(0xffffffffu, v[k] >= thr);
                const uint32_t kf = __ballot_sync(0xffffffffu, v[k] >= 0.0f && !(v[k] >= thr));
                if (lane == 0) {
                    row[u] = occ;
                    if (fc > 0) row[items + u] = kf;
                }
            }
        }
    }
}

// grid (ceil(S / M_TS), ceil(K^2 / M_KT), Z): the partial sums of a run of
// lattice rows
__global__ void __launch_bounds__(M_THREADS, M_BLOCKS_PER_SM) m_phik_dense(MParams p, MBuffers b) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const MLayout L = m_layout(p.h, p.w, p.nsx, p.r, p.fc, p.ring_global);
    float* smf = reinterpret_cast<float*>(smem_raw);
    uint32_t* smu = reinterpret_cast<uint32_t*>(smem_raw);
    int* smi = reinterpret_cast<int*>(smem_raw);
    float* vals = smf + L.vals;
    unsigned char* nzh = reinterpret_cast<unsigned char*>(smu + L.nz);  // (2, M_NV) point flags
    float* P = smf + L.P;
    uint32_t* F = smu + L.F;
    int* cxs = smi + L.cxs;
    int* offe = smi + L.offe;
    int* offw = smi + L.offw;
    int* tage = smi + L.tage;
    int* tagw = smi + L.tagw;
    const size_t block = ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    uint32_t* ring = p.ring_global ? b.work + block * (L.ering_words + (size_t)L.rw * L.wrow)
                                   : smu + L.ring;
    float* ering = reinterpret_cast<float*>(ring);
    uint32_t* wring = ring + L.ering_words;
    const int h = p.h, w = p.w, r = p.r, fc = p.fc, wp = L.wp, ww = L.ww;
    const int m = r > fc ? r : fc;
    const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
    const int s0 = blockIdx.x * M_TS, ns = min(M_TS, p.S - s0);
    const int c = tid % M_KT, half = tid / M_KT;
    const int kt0 = blockIdx.y * M_KT, ktn = min(M_KT, p.KK - kt0);
    const bool colv = c < ktn;
    const bool wide = (p.KK & 3) == 0 && (ktn & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(b.D) & 15u) == 0;  // 16-byte copies of D
    const size_t plane = (size_t)h * w;
    const float* data = b.data + (size_t)s0 * plane;
    const MEnt3 e3 = {m_entropy(-1.0f, p.lo, p.hi), m_entropy(0.0f, p.lo, p.hi),
                      m_entropy(1.0f, p.lo, p.hi)};
    // this block's lattice rows [iy0, iy1); each in n_ch chunks of at most
    // ch points (M_NC), M_GROUP chunks a group of vals
    const int per_run = (p.nsy + p.Z - 1) / p.Z;
    const int iy0 = blockIdx.z * per_run, iy1 = min(p.nsy, iy0 + per_run);
    const int n_ch = (p.nsx + M_NC - 1) / M_NC, ch = (p.nsx + n_ch - 1) / n_ch;
    const int n_chunks = (iy1 > iy0 ? iy1 - iy0 : 0) * n_ch;
    const size_t dstride = (size_t)p.nsy * p.KK;

    // the rows of D of chunk t (of this block's sequence) into buffer t & 1
    auto copy_chunk = [&](int t) {
        const int iy = iy0 + t / n_ch, ix0 = (t % n_ch) * ch, nc = min(ch, p.nsx - ix0);
        const float* Dc = b.D + ((size_t)ix0 * p.nsy + iy) * p.KK + kt0;
        float* dst = smf + L.ds + (size_t)(t & 1) * M_NC * M_KT;
        if (wide) {
            const int per = ktn / 4;
            for (int q = tid; q < nc * per; q += M_THREADS) {
                const int j = q / per, k = q - j * per;
                m_copy16(dst + j * M_KT + 4 * k, Dc + j * dstride + 4 * k);
            }
        } else {
            for (int q = tid; q < nc * ktn; q += M_THREADS) {
                const int j = q / ktn, k = q - j * ktn;
                m_copy4(dst + j * M_KT + k, Dc + j * dstride + k);
            }
        }
        m_copy_commit();
    };

    float acc[M_SPT];
#pragma unroll
    for (int i = 0; i < M_SPT; ++i) acc[i] = 0.0f;
    for (int q = tid; q < p.nsx; q += M_THREADS) cxs[q] = b.cx[q];
    for (int y = tid; y < h; y += M_THREADS) {
        offe[y] = (y % L.re) * (int)L.erow;
        offw[y] = (y % L.rw) * (int)L.wrow;
    }
    for (int q = tid; q < L.re + L.rw; q += M_THREADS) tage[q] = -1;  // tagw follows tage
    if (n_chunks > 0) copy_chunk(0);
    __syncthreads();

    int cyv = 0;
    for (int t = 0; t < n_chunks; ++t) {
        const int iy = iy0 + t / n_ch, k = t % n_ch, ix0 = k * ch, nc = min(ch, p.nsx - ix0);
        const int g0 = (k / M_GROUP) * M_GROUP * ch;  // first point of this chunk's vals group
        if (k == 0) {
            // 1. the rows entering the rings (tags are read here, written after the barrier)
            cyv = b.cy[iy];
            const int wa = max(0, cyv - m), wb = min(h - 1, cyv + m);
            const int ea = max(0, cyv - r), eb = min(h - 1, cyv + r);
            for (int y = wa; y <= wb; ++y)
                if (tagw[y % L.rw] != y)
                    m_fill_bits(wring + offw[y], L, data, plane, y, w, ns, fc, p.thr);
            for (int y = ea; y <= eb; ++y)
                if (tage[y % L.re] != y)
                    m_fill_entropy(ering + offe[y], L, data, plane, y, w, ns, p, e3);
            __syncthreads();
            if (tid == 0) {
                for (int y = wa; y <= wb; ++y) tagw[y % L.rw] = y;
                for (int y = ea; y <= eb; ++y) tage[y % L.re] = y;
            }
            // the next lattice row's new map rows on their way to L2
            if (iy + 1 < iy1) {
                const int nb = min(h - 1, b.cy[iy + 1] + m), na = max(wb + 1, nb - 1);
                const int lines = (w + 31) / 32, items = (nb - na + 1) * M_TS * lines;
                for (int q = tid; q < items; q += M_THREADS) {
                    const int y = na + q / (M_TS * lines), u = q % (M_TS * lines);
                    const int s = u / lines, x = (u - s * lines) * 32;
                    if (s < ns) m_prefetch_l2(data + s * plane + (size_t)y * w + x);
                }
            }
            // 2. the y sums of the entropies and the frontier words
            if (r > 0) {
                const int items = M_TS << L.wshift, xm = (1 << L.wshift) - 1;
                for (int q = tid; q < items; q += M_THREADS) {
                    const int s = q >> L.wshift, x = q & xm;
                    if (x < w) {
                        float v = 0.0f;
#pragma unroll 4
                        for (int d = -r; d <= r; ++d)
                            v += ering[offe[m_clampi(cyv + d, h - 1)] + s * wp + x];
                        P[s * wp + x] = v;
                    }
                }
            }
            if (fc > 0) {
                const int fa = max(0, cyv - fc), fb = min(h - 1, cyv + fc), items = M_TS * ww;
                for (int q = tid; q < items; q += M_THREADS) {
                    uint32_t word = 0u;
#pragma unroll 4
                    for (int y = fa; y <= fb; ++y) word |= wring[offw[y] + items + q];
                    F[q] = word;
                }
            }
        }
        if (k % M_GROUP == 0) {
            // 3. vals and the point flags of this group's points [g0, g0 + nv)
            __syncthreads();  // the rings' sums are in; the last group's contraction is done
            const int nv = min(M_GROUP * ch, p.nsx - g0);
            const float* erow = ering + offe[cyv];
            const uint32_t* occ = wring + offw[cyv];
            for (int q0 = wid * 32; q0 < M_TS * nv; q0 += M_THREADS) {
                const int q = q0 + lane, s = q & (M_TS - 1), j = q >> 4;
                float v = 0.0f;
                if (q < M_TS * nv && s < ns) {
                    const int cxv = cxs[g0 + j];
                    float t2;
                    if (r == 0) {
                        t2 = erow[s * wp + cxv];
                    } else {
                        t2 = 0.0f;
#pragma unroll 4
                        for (int a = -r; a <= r; ++a) t2 += P[s * wp + m_clampi(cxv + a, w - 1)];
                    }
                    bool keep = !((occ[s * ww + (cxv >> 5)] >> (cxv & 31)) & 1u);
                    if (fc > 0 && keep) keep = m_any_bits(F + s * ww, w, cxv - fc, cxv + fc);
                    v = t2 * (keep ? 1.0f : 0.0f);
                    v = v < 0.0f ? 0.0f : v;
                }
                if (q < M_TS * nv) vals[q] = v;
                const uint32_t any = __ballot_sync(0xffffffffu, v != 0.0f);
                if (lane == 0) {  // the flags of points q0 / 16 and q0 / 16 + 1 of each half
                    uint16_t* f = reinterpret_cast<uint16_t*>(nzh + (q0 >> 4));
                    f[0] = (uint16_t)(((any & 0xffu) ? 1u : 0u) | ((any & 0xff0000u) ? 0x100u : 0u));
                    f[M_NV / 2] = (uint16_t)(((any & 0xff00u) ? 1u : 0u) |
                                             ((any & 0xff000000u) ? 0x100u : 0u));
                }
            }
        }
        // 4. this chunk's D in (the next one on its way), the contraction
        m_copy_wait<0>();
        __syncthreads();
        if (t + 1 < n_chunks) copy_chunk(t + 1);
        const float* Db = smf + L.ds + (size_t)(t & 1) * M_NC * M_KT;
        const int jv = ix0 - g0;  // this chunk's first point in the vals group
        const float4* vv = reinterpret_cast<const float4*>(vals) + jv * (M_TS / 4) +
                           half * (M_SPT / 4);
        const unsigned char* flag = nzh + half * M_NV + jv;
        int j = 0;
        for (; j + 2 <= nc; j += 2) {  // two points a step, their loads together
            const bool f0 = flag[j] != 0, f1 = flag[j + 1] != 0;
            if (!f0 && !f1) continue;
            const float4 a0 = vv[j * (M_TS / 4)], b0 = vv[j * (M_TS / 4) + 1];
            const float4 a1 = vv[(j + 1) * (M_TS / 4)], b1 = vv[(j + 1) * (M_TS / 4) + 1];
            const float d0 = colv ? Db[j * M_KT + c] : 0.0f;
            const float d1 = colv ? Db[(j + 1) * M_KT + c] : 0.0f;
            if (f0) {
                const float v[M_SPT] = {a0.x, a0.y, a0.z, a0.w, b0.x, b0.y, b0.z, b0.w};
#pragma unroll
                for (int i = 0; i < M_SPT; ++i) acc[i] = __fmaf_rn(v[i], d0, acc[i]);
            }
            if (f1) {
                const float v[M_SPT] = {a1.x, a1.y, a1.z, a1.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < M_SPT; ++i) acc[i] = __fmaf_rn(v[i], d1, acc[i]);
            }
        }
        if (j < nc && flag[j]) {
            const float4 a0 = vv[j * (M_TS / 4)], b0 = vv[j * (M_TS / 4) + 1];
            const float v[M_SPT] = {a0.x, a0.y, a0.z, a0.w, b0.x, b0.y, b0.z, b0.w};
            const float d0 = colv ? Db[j * M_KT + c] : 0.0f;
#pragma unroll
            for (int i = 0; i < M_SPT; ++i) acc[i] = __fmaf_rn(v[i], d0, acc[i]);
        }
    }

    // 5. this run's partial sums
    if (colv) {
#pragma unroll
        for (int i = 0; i < M_SPT; ++i) {
            const int s = half * M_SPT + i;
            if (s < ns) b.part[((size_t)(s0 + s) * p.Z + blockIdx.z) * p.KK + kt0 + c] = acc[i];
        }
    }
}

// a thread per (scenario, coefficient): the runs' partials added in run
// order, normalized by the target's mass, or the fallback
__global__ void __launch_bounds__(256) m_finish(MParams p, MBuffers b) {
    const size_t o = (size_t)blockIdx.x * 256 + threadIdx.x;
    if (o >= (size_t)p.S * p.KK) return;
    const size_t s = o / p.KK;
    const int k = (int)(o - s * p.KK);
    const float* part = b.part + s * p.Z * p.KK;
    float raw = 0.0f, raw00 = 0.0f;
    for (int z = 0; z < p.Z; ++z) {
        raw += part[(size_t)z * p.KK + k];
        raw00 += part[(size_t)z * p.KK];
    }
    const float t = raw00 * b.hk00[0];
    b.out[o] = t > 1e-12f ? raw / fmaxf(t, 1e-12f) : b.fallback[k];
}

// Bytes of dynamic shared memory a block of M uses, and of its rings (the
// workspace a block of a _global variant takes). The wrapper's smem_bytes
// and ring_bytes mirror them; a host test holds the two against each other.
extern "C" size_t m_shared_bytes(int h, int w, int nsx, int r, int fc, int ring_global) {
    return 4 * m_layout(h, w, nsx, r, fc, ring_global).shared_words;
}
extern "C" size_t m_ring_bytes(int h, int w, int r, int fc) {
    const MLayout L = m_layout(h, w, 1, r, fc, 1);
    return 4 * (L.ering_words + (size_t)L.rw * L.wrow);
}

// Launch M for p->S scenarios on `stream`: the runs, then m_finish. Returns
// the CUDA error code (0 on success). Does not synchronize.
extern "C" int m_phik_dense_launch(const MParams* params, const MBuffers* buffers,
                                   void* stream) {
    MParams p = *params;
    MBuffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    if (p.h < 1 || p.w < 1 || p.nsx < 1 || p.nsy < 1 || p.KK < 1 ||
        p.KK > M_KMAX * M_KMAX || p.r < 0 || p.fc < 0 || p.Z < 1 || p.Z > 65535 ||
        b.part == nullptr || (p.ring_global && b.work == nullptr))
        return (int)cudaErrorInvalidValue;
    const size_t smem = m_shared_bytes(p.h, p.w, p.nsx, p.r, p.fc, p.ring_global);
    if (smem > (size_t)M_MAX_SMEM) return (int)cudaErrorInvalidValue;
    const dim3 grid((p.S + M_TS - 1) / M_TS, (p.KK + M_KT - 1) / M_KT, p.Z);
    cudaError_t e = launch_kernel(m_phik_dense, grid, dim3(M_THREADS), smem, st, p, b);
    if (e != cudaSuccess) return (int)e;
    const size_t outs = (size_t)p.S * p.KK;
    e = launch_kernel(m_finish, dim3((unsigned)((outs + 255) / 256)), dim3(256), 0, st, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
