// K1's GMM target refresh over the shared sample lattice, in separable form.
//
// Device half of the batched phi_k reduction that the JAX package runs in
// Pallas inside K1 (ops/solve_kernel.py::_make_kernel, "in-kernel target
// refresh"). The lattice is the tensor product of its nsx x samples (rows
// ix) and nsy y samples (columns iy), x-major as Domain.sample_lattice lays
// it out, and a basis function is a cosine in x times one in y, so the
// dense contraction with D[n, (k1, k2)] = cx[ix, k1] cy[iy, k2] / h_k m(n)
// (ops/solve_kernel.py::refresh_plain) factors. For each scenario s, with
// the shared free mask m (or 1):
//
//     R[s, ix, k2] = sum_iy phi_s(x_ix, y_iy) m(ix, iy) cy[iy, k2]     (K a point)
//     A[s, k1, k2] = sum_ix cx[ix, k1] R[s, ix, k2]                    (K^2 a row)
//     acc = A / h_k,   tot[s] = sum_n phi_s(p_n)   (unmasked)
//
// The masked normalizer h00 acc_00 reads A[s, 0, 0], the masked mass (cx and
// cy are 1 at k = 0). The dense form took K^2 multiply-adds a point (100 at
// K = 10); this one K + K^2 / nsy.
//
// What bounds it on an H100: the density. Per scenario and point, each of
// the J components takes an expf (a MUFU.EX2 and seven FP32 instructions)
// and about 8 operations more (the offset's terms, the quadratic form, the
// scale, the weight and the sum; with -fmad=false each its own instruction);
// then the mask, the tot and K multiply-adds: about 48 issue slots a
// scenario and point at K = 10, J = 2, 59-66 us at S = 4096 on 100 x 100
// points. Next comes the load path: a value a lane loads costs 4 of the
// SM's 128 bytes a clock whether or not the warp's lanes share it, so a
// broadcast table value that feeds one multiply-add costs a quarter of a
// clock. What the design does about it:
//   - lattice_rows (k1_refresh): a warp a block, its 32 lanes 32 scenarios,
//     so a lane holds its mixture's constants and every lane walks the same
//     points; a lane evaluates LR_RT = 2 rows at LR_YC = 20 points of each
//     at a time into registers, so a component's 7 constants are read once
//     for 40 values, the terms in dy are made once for both rows, and every
//     y cosine loaded feeds two multiply-adds (two rows); the y sums are made
//     two coefficients at a time (four independent chains of fmaf), the
//     rows' sums held in shared memory between chunks. 128 registers, 16
//     warps an SM: 3 rows or 12 warps, 24 warps with spills, chunks of 10
//     points were all slower on the card;
//   - the lattice's rows are cut into bands, a warp a band
//     (ops/solve_kernel.py::refresh_plan: enough warps for every SM at S =
//     4096, a row a warp at S = 1); a warp writes each row's K sums and its
//     tot to the scratch, a column a lane, so every store is 128 bytes;
//   - lattice_finish (k1_finish): a block a group of 32 scenarios and 4 k2;
//     a lane sums 16 k1 x 4 k2 of its scenario at a time, so every cx value
//     it loads feeds four multiply-adds, and loads its next rows' sums
//     before it uses them; the rows come in 4 parts whatever the batch (so
//     a scenario's sums have one order at every S), a warp a part, added in
//     part order in shared memory; the block's outputs are written a
//     scenario's row at a time;
//   - no atomics: every sum has one order, so two launches give the same
//     bits. Any K and J: the constants of LR_JC components are staged at a
//     time, and the coefficients loop.
// phi is computed with the exact expressions of ops/target.py::gmm_eval, so
// with -fmad=false every phi value rounds as PyTorch's elementwise ops round
// it; the sums are float32 (fmaf, no tensor cores) in another order than the
// plain version's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace k1 {

constexpr int LR_YC = 20;  // points of a row a lane evaluates at a time (ROW_CHUNK in Python)
constexpr int LR_RT = 2;   // rows a lane evaluates at a time
constexpr int LR_JC = 16;  // mixture components whose constants are staged at a time
constexpr int LR_GP = 7;   // per-component constants: mx, my, a, 2b, c, 1/det, norm
constexpr int LR_SM_WARPS = 16;  // warps (one a block) k1_refresh is built to hold on an SM
constexpr int LF_KT = 16;  // k1_finish: k1 a lane sums at a time (FINISH_K1 in Python)
constexpr int LF_NC = 4;   // k1_finish: k2 a block sums
constexpr int LF_RB = 4;   // k1_finish: rows a lane loads ahead
constexpr int LF_PARTS = 4;  // k1_finish: the rows' parts, a warp each, then added in order
constexpr int LF_PART = LF_KT * LF_NC + 2;  // a lane's sums: A, then the mass and the tot
static_assert(LF_KT * LF_NC % LF_PARTS == 0, "k1_finish: a warp writes as many outputs as another");
constexpr float LR_TWO_PI = 6.28318530717958647692f;
static_assert(LR_YC % 4 == 0 && LF_KT % 4 == 0, "chunks are read as float4");

// v[0 .. N) = p[0 .. N) by 16-byte loads (p 16-byte aligned)
template <int N>
__device__ __forceinline__ void lr_load(const float* __restrict__ p, float (&v)[N]) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
        const float4 w = *reinterpret_cast<const float4*>(p + q);
        v[q] = w.x, v[q + 1] = w.y, v[q + 2] = w.z, v[q + 3] = w.w;
    }
}

// K rounded up to even: the y sums are made two coefficients at a time (the
// rows of the cy table)
__host__ __device__ inline int lr_ky(int K) { return (K + 1) / 2 * 2; }

// Columns of the cx table, zero past K: a multiple of LF_KT, so that every
// load of k1_finish is in bounds
__host__ __device__ inline int lf_cx_cols(int K) { return (K + LF_KT - 1) / LF_KT * LF_KT; }

// Shared floats of a block of k1_refresh (one warp): the constants of
// min(J, LR_JC) components and LR_RT rows' y sums, a column a lane.
__host__ __device__ inline int lr_smem_floats(int K, int J) {
    return 32 * (LR_GP * (J < LR_JC ? J : LR_JC) + LR_RT * lr_ky(K));
}

// Shared floats of a block of k1_finish: every lane's sums of every warp,
// then the block's outputs.
constexpr int LF_SMEM_FLOATS = (LF_PARTS * LF_PART + LF_KT * LF_NC) * 32;

// Floats of the refresh's scratch for one group of 32 scenarios: each row's
// K y sums and its tot, a column a lane.
__host__ __device__ inline size_t lr_group_floats(int nsx, int K) {
    return (size_t)nsx * (K + 1) * 32;
}

// The constants of components j0 .. j0 + jn of scenario s, with gmm_eval's
// expressions, into gp[(jl LR_GP + c) 32] (a lane's column).
__device__ __forceinline__ void lr_stage(int s, int J, int j0, int jn,
                                         const float* __restrict__ means,
                                         const float* __restrict__ covs,
                                         const float* __restrict__ weights, float* gp) {
    for (int jl = 0; jl < jn; ++jl) {
        const size_t sj = (size_t)s * J + j0 + jl;
        const float a = covs[sj * 4 + 0], b = covs[sj * 4 + 1], c = covs[sj * 4 + 3];
        const float det = a * c - b * b;
        float* gj = gp + jl * LR_GP * 32;
        gj[0 * 32] = means[sj * 2 + 0];
        gj[1 * 32] = means[sj * 2 + 1];
        gj[2 * 32] = a;
        gj[3 * 32] = 2.0f * b;
        gj[4 * 32] = c;
        gj[5 * 32] = 1.0f / det;
        gj[6 * 32] = weights[sj] / (LR_TWO_PI * sqrtf(det));
    }
}

// Rows ix .. ix + RT of scenario s (one lane): their y sums and tots into
// rows[(row (K + 1) + k2) 32] (the lane's column; k2 = K the tot). gp holds
// the constants (staged here too past LR_JC components), Rs LR_RT ky rows of
// y sums.
template <int RT>
__device__ __forceinline__ void lr_rows(int s, int J, int K, int nsy, int ix,
                                        const float* __restrict__ means,
                                        const float* __restrict__ covs,
                                        const float* __restrict__ weights,
                                        const float* __restrict__ xs,
                                        const float* __restrict__ ys,
                                        const float* __restrict__ cy,
                                        const float* __restrict__ mask, float* gp, float* Rs,
                                        float* __restrict__ rows) {
    const int KY = lr_ky(K), JC = J < LR_JC ? J : LR_JC;
    float x[RT], tot[RT];
#pragma unroll
    for (int r = 0; r < RT; ++r) x[r] = xs[ix + r], tot[r] = 0.0f;
    for (int k = 0; k < RT * KY; ++k) Rs[k * 32] = 0.0f;
    for (int iy0 = 0; iy0 < nsy; iy0 += LR_YC) {
        float yv[LR_YC], ph[RT][LR_YC];
        lr_load(ys + iy0, yv);
#pragma unroll
        for (int r = 0; r < RT; ++r)
#pragma unroll
            for (int q = 0; q < LR_YC; ++q) ph[r][q] = 0.0f;
        // the sum over j in ascending j; past LR_JC components the constants
        // are staged chunk by chunk
        for (int j0 = 0; j0 < J; j0 += JC) {
            const int jn = J - j0 < JC ? J - j0 : JC;
            if (J > LR_JC) lr_stage(s, J, j0, jn, means, covs, weights, gp);
            for (int j = 0; j < jn; ++j) {
                const float* gj = gp + j * LR_GP * 32;
                const float mx = gj[0 * 32], my = gj[1 * 32], ca = gj[2 * 32], cb2 = gj[3 * 32],
                            cc = gj[4 * 32], idet = gj[5 * 32], nrm = gj[6 * 32];
                float t1[RT], bdx[RT];
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    const float dx = x[r] - mx;
                    t1[r] = cc * (dx * dx), bdx[r] = cb2 * dx;
                }
#pragma unroll
                for (int q = 0; q < LR_YC; ++q) {
                    const float dy = yv[q] - my;
                    const float t3 = ca * (dy * dy);
#pragma unroll
                    for (int r = 0; r < RT; ++r) {
                        const float qf = (t1[r] - bdx[r] * dy + t3) * idet;
                        ph[r][q] = ph[r][q] + nrm * expf(-0.5f * qf);
                    }
                }
            }
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
            for (int q = 0; q < LR_YC; ++q) tot[r] = tot[r] + ph[r][q];
            if (mask) {
                float mv[LR_YC];
                lr_load(mask + (size_t)(ix + r) * nsy + iy0, mv);
#pragma unroll
                for (int q = 0; q < LR_YC; ++q) ph[r][q] = ph[r][q] * mv[q];
            }
        }
        // the y sums, two coefficients at a time, in ascending iy
        for (int k = 0; k < KY; k += 2) {
            float ca_[LR_YC], cb_[LR_YC], r0[RT], r1[RT];
            lr_load(cy + (size_t)k * nsy + iy0, ca_);
            lr_load(cy + (size_t)(k + 1) * nsy + iy0, cb_);
#pragma unroll
            for (int r = 0; r < RT; ++r)
                r0[r] = Rs[(r * KY + k) * 32], r1[r] = Rs[(r * KY + k + 1) * 32];
#pragma unroll
            for (int q = 0; q < LR_YC; ++q)
#pragma unroll
                for (int r = 0; r < RT; ++r)
                    r0[r] = fmaf(ph[r][q], ca_[q], r0[r]), r1[r] = fmaf(ph[r][q], cb_[q], r1[r]);
#pragma unroll
            for (int r = 0; r < RT; ++r)
                Rs[(r * KY + k) * 32] = r0[r], Rs[(r * KY + k + 1) * 32] = r1[r];
        }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
        float* out = rows + (size_t)(ix + r) * (K + 1) * 32;
        for (int k = 0; k < K; ++k) out[k * 32] = Rs[(r * KY + k) * 32];
        out[K * 32] = tot[r];
    }
}

// One warp's part of the refresh: the 32 scenarios of group g (lanes past S
// do nothing), rows ix0 .. ix1, LR_RT at a time. means (S, J, 2), covs (S,
// J, 2, 2), weights (S, J); xs (nsx); ys (nsy, a multiple of LR_YC, padded
// with far points whose phi is exactly 0); cy (lr_ky(K), nsy); mask (nsx,
// nsy) or nullptr. `rows` is this group's lr_group_floats(nsx, K) of the
// scratch: row ix's y sum of k2 at rows[(ix (K + 1) + k2) 32 + lane], its
// tot (phi unmasked) at k2 = K. `sm` is lr_smem_floats(K, J) floats.
// Nothing here waits for the warp.
__device__ __forceinline__ void lattice_rows(
    int g, int S, int J, int K, int nsy, int ix0, int ix1,
    const float* __restrict__ means, const float* __restrict__ covs,
    const float* __restrict__ weights, const float* __restrict__ xs,
    const float* __restrict__ ys, const float* __restrict__ cy,
    const float* __restrict__ mask, float* sm, float* __restrict__ rows) {
    const int lane = threadIdx.x & 31;
    const int s = g * 32 + lane;
    if (s >= S) return;
    const int JC = J < LR_JC ? J : LR_JC;
    float* gp = sm + lane;                   // gp[(j LR_GP + c) 32]: component j's constants
    float* Rs = sm + 32 * LR_GP * JC + lane;  // Rs[(r ky + k) 32]: row r's y sum of k
    if (J <= LR_JC) lr_stage(s, J, 0, J, means, covs, weights, gp);
    int ix = ix0;
    for (; ix + LR_RT <= ix1; ix += LR_RT)
        lr_rows<LR_RT>(s, J, K, nsy, ix, means, covs, weights, xs, ys, cy, mask, gp, Rs,
                       rows + lane);
    for (; ix < ix1; ++ix)
        lr_rows<1>(s, J, K, nsy, ix, means, covs, weights, xs, ys, cy, mask, gp, Rs, rows + lane);
}

// k1_finish's part: the 32 scenarios of group g (a lane each), the
// coefficients (k1, k2) of every k1 and the LF_NC k2 from k2_0. The rows
// are cut into LF_PARTS parts whatever S is, so a scenario's sums have one
// order at every batch size; warp w of the block's LF_PARTS sums part w.
// rows (G, nsx, K + 1, 32) is the scratch of lattice_rows: a part's sums are
// added in row order (the tot, the masked mass: k2 = 0 against cx[., 0] = 1,
// A_00; and A[k1, k2] against cx (nsx, lf_cx_cols(K))), loading LF_RB rows
// ahead with no branch between the loads (rows past the part repeat its last
// row and add nothing); the parts' sums are added in part order through `sm`
// (LF_SMEM_FLOATS floats). hk (K^2); mask_ck (K^2); dlen (S, 2).
// out[s K^2 + k] = acc_k / (h00 acc_00) (masked) or acc_k / tot, acc = A /
// h_k, or mask_ck for a target with no mass, as
// ops/solve_kernel.py::refresh_plain; the block's outputs are gathered in
// shared memory and written a scenario's row at a time, runs of LF_NC floats
// a thread after another. Called by all warps of the block.
__device__ __forceinline__ void lattice_finish(
    int g, int S, int K, int k2_0, int nsx, int masked, const float* __restrict__ rows,
    const float* __restrict__ cx, const float* __restrict__ hk,
    const float* __restrict__ mask_ck, const float* __restrict__ dlen, float* sm,
    float* __restrict__ out) {
    const int lane = threadIdx.x & 31, pt = threadIdx.x / 32;
    const int s = g * 32 + lane, KK = K * K, KC = lf_cx_cols(K);
    const int per = (nsx + LF_PARTS - 1) / LF_PARTS;
    const size_t row = (size_t)(K + 1) * 32;
    const float* base = rows + (size_t)g * lr_group_floats(nsx, K) + lane;
    float* part = sm;  // (LF_PARTS, LF_PART, 32): every part's sums
    float* tile = sm + (size_t)LF_PARTS * LF_PART * 32;  // (32, LF_KT LF_NC): the outputs
    int col[LF_NC];
#pragma unroll
    for (int c = 0; c < LF_NC; ++c) col[c] = min(k2_0 + c, K) * 32;
    const float h00 = s < S ? sqrtf(dlen[s * 2 + 0] * dlen[s * 2 + 1]) : 1.0f;
    const int ixa = min(nsx, pt * per), ixb = min(nsx, ixa + per);  // this warp's part
    for (int k0 = 0; k0 < K; k0 += LF_KT) {
        float a[LF_KT][LF_NC];
#pragma unroll
        for (int i = 0; i < LF_KT; ++i)
#pragma unroll
            for (int c = 0; c < LF_NC; ++c) a[i][c] = 0.0f;
        float t = 0.0f, m = 0.0f;
        for (int ix0 = ixa; ix0 < ixb; ix0 += LF_RB) {
            float v[LF_RB][LF_NC], vm[LF_RB], vt[LF_RB];
#pragma unroll
            for (int u = 0; u < LF_RB; ++u) {
                const float* p = base + min(ix0 + u, ixb - 1) * row;
#pragma unroll
                for (int c = 0; c < LF_NC; ++c) v[u][c] = p[col[c]];
                vm[u] = p[0], vt[u] = p[K * 32];
            }
#pragma unroll
            for (int u = 0; u < LF_RB; ++u) {
                const bool in = ix0 + u < ixb;
                m = in ? m + vm[u] : m;
                t = in ? t + vt[u] : t;
                const float* cr = cx + (size_t)min(ix0 + u, ixb - 1) * KC + k0;
#pragma unroll
                for (int i = 0; i < LF_KT; i += 4) {
                    const float4 x4 = *reinterpret_cast<const float4*>(cr + i);
#pragma unroll
                    for (int c = 0; c < LF_NC; ++c) {
                        const float r = in ? v[u][c] : 0.0f;
                        a[i][c] = fmaf(x4.x, r, a[i][c]);
                        a[i + 1][c] = fmaf(x4.y, r, a[i + 1][c]);
                        a[i + 2][c] = fmaf(x4.z, r, a[i + 2][c]);
                        a[i + 3][c] = fmaf(x4.w, r, a[i + 3][c]);
                    }
                }
            }
        }
        float* mine = part + (size_t)pt * LF_PART * 32 + lane;
#pragma unroll
        for (int i = 0; i < LF_KT; ++i)
#pragma unroll
            for (int c = 0; c < LF_NC; ++c) mine[(i * LF_NC + c) * 32] = a[i][c];
        mine[(LF_PART - 2) * 32] = m;
        mine[(LF_PART - 1) * 32] = t;
        // the parts' sums, added in part order
        __syncthreads();
        float tt = 0.0f, mm = 0.0f;
        for (int v2 = 0; v2 < LF_PARTS; ++v2) {
            mm += part[((size_t)v2 * LF_PART + LF_PART - 2) * 32 + lane];
            tt += part[((size_t)v2 * LF_PART + LF_PART - 1) * 32 + lane];
        }
        // the masked normalizer h00 acc_00, acc_00 = A_00 / h_00 = mass / h_00
        const float a00 = h00 * (mm / hk[0]);
        const bool ok = masked ? (tt > 1e-12f) && (a00 / fmaxf(tt, 1e-12f) > 1e-12f) : tt > 1e-12f;
        const float norm = masked ? fmaxf(a00, 1e-30f) : fmaxf(tt, 1e-12f);
        // warp pt the outputs j = (i LF_NC + c) = pt, pt + LF_PARTS, ... of its lane's
        // scenario, each with its loads ahead of any branch (a padding k1 or k2 reads
        // the last coefficient's and writes nothing). On an H100, with the loads
        // behind the padding's branch the finish took 19 us at S = 1, ahead of it 12;
        // unrolled, it held 130 registers and took 0.160 ms at K = 32, rolled 0.118
#pragma unroll 1
        for (int jj = 0; jj < LF_KT * LF_NC / LF_PARTS; ++jj) {
            const int j = jj * LF_PARTS + pt, i = j / LF_NC, c = j % LF_NC;
            const int k = min(k0 + i, K - 1) * K + min(k2_0 + c, K - 1);
            const float h = hk[k], fb = mask_ck[k];
            float sum = 0.0f;
#pragma unroll
            for (int v2 = 0; v2 < LF_PARTS; ++v2)
                sum += part[((size_t)v2 * LF_PART + j) * 32 + lane];
            if (k0 + i < K && k2_0 + c < K)  // padding: nothing to write
                tile[lane * LF_KT * LF_NC + j] = ok ? (sum / h) / norm : fb;
        }
        __syncthreads();
        // the block's outputs, a scenario's runs of LF_NC k2 one after another
        for (int e = threadIdx.x; e < 32 * LF_KT * LF_NC; e += blockDim.x) {
            const int sl = e / (LF_KT * LF_NC), j = e % (LF_KT * LF_NC);
            const int k1 = k0 + j / LF_NC, k2 = k2_0 + j % LF_NC;
            if (g * 32 + sl < S && k1 < K && k2 < K)
                out[(size_t)(g * 32 + sl) * KK + k1 * K + k2] = tile[e];
        }
        __syncthreads();  // every warp is done with sm before the next pass writes it
    }
}

}  // namespace k1
