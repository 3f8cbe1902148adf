// K1 — the fused replan kernel (one whole tick per scenario) for NVIDIA Hopper.
//
// Replaces the TPU kernels of ergodic_exploration_tpu/ops/solve_kernel.py:
// fused_solve_safety and fused_solve (Pallas: _fused_call / _make_kernel, with
// _safety_geom, _validate_u0 and _dwa_sweep) and the standalone fused_safety
// (_make_safety_kernel / _safety_ops). Variants, all in this file:
//   - GMM target refresh in the kernel (J > 0) or phi_k as an input (J = 0);
//   - the patch read from ONE distance map shared by all scenarios
//     (map_stride = 0) or from each scenario's own map (map_stride = mh * mw,
//     the TPU kernel's map_h = 0 variant: there XLA cuts (P, P, S) patches and
//     their gradients out with one-hot matmuls because Mosaic cannot gather;
//     a GPU gathers, so the kernel reads the (S, mh, mw) maps directly with
//     the same clamped index math);
//   - safety on (fused_solve_safety) or off (fused_solve: k1_solve returns
//     before its safety stage);
//   - the history term of c_k given as (K, K) sums (nb = 0) or as the nb
//     positions drawn from the ring buffer (the TPU kernel's nb > 0 variant):
//     then their cos tables and the (K, K) sums of outer products are computed
//     in k1_solve;
//   - the safety stage alone on a (S, Pc, Pc) crop given as data (k1_safety),
//     or on the central Pc x Pc crop of the P x P patch read from the map
//     itself (k1_safety<true>, what the eager controller step launches: the
//     JAX step cuts that crop out of its patch, controller.py extract_patch
//     and center_crop, an XLA gather; here the crop's cells are read where
//     they lie, with the per-cell edge clamp of ops/patch.py gather_window).
// Built by nvcc for sm_90a (utils/cuda_build.py) and called through the plain C
// entry points at the end of this file from ops/solve_kernel.py.
//
// Launches on the caller's stream:
//   k1_refresh  (J > 0) grid (scenario tiles of 64) x (lattice splits) x
//               (slabs of 256 coefficients): a block contracts its share of
//               the padded lattice with its slab of the basis table
//               (gmm_refresh.cuh) and writes its partial (acc, tot) to the
//               wrapper's scratch. The splits are chosen as K2's are
//               (ops/solve_kernel.py::lattice_split), so S = 1 is a block per
//               chunk (157 at a 100 x 100 lattice), not one block walking
//               them all.
//   k1_finish   (J > 0) a block per scenario adds the partials in split
//               order (no atomics: two launches give the same bits) and
//               normalizes as ops/solve_kernel.py::refresh_plain does (the
//               masked normalizer h00 acc_00, the precomputed fallback). It
//               is a launch of its own, not the head of k1_solve: one warp
//               would add 157 partials for each of its 4 coefficients a lane
//               at S = 1, and k1_solve keeps one form for J = 0 and J > 0.
//   k1_solve    ONE WARP PER SCENARIO, everything else, in this order: RK4
//               rollout; cos/sin basis tables; (nb > 0) the history sums over
//               the drawn positions; c_k, metric and ergodic gradient;
//               boundary + obstacle barrier with bilinear reads of the patch
//               (values and the patch's own central-difference gradient,
//               one-sided at the PATCH edges, FAR plateau zeroed); backward
//               co-state; u = clip(-R^-1 B^T rho); ck_sum append; validation
//               of u0 over val_horizon steps and the DWA sweep over every
//               candidate and dwa_horizon steps.
//               A warp's tables (solve_warp_floats: 6.5 KB at K = 10,
//               H = 20) live in shared memory, 4 warps a block, where four
//               such blocks share an SM (56 KB a block); past that (K = 16,
//               H = 64 takes 121 KB a block) in a global workspace of
//               S x solve_warp_floats floats, carved in the same way
//               (k1_solve<true>, 4 warps a block, 126 registers: four blocks
//               an SM, the tables cached in L1 / L2), which measured faster
//               than fewer blocks an SM with shared tables
//               (ops/solve_kernel.py::global_tables).
//   k1_safety   one warp per scenario: that last stage alone, on a crop
//               given as data or read from the map.
//
// How a warp divides a scenario. Independent values go to the lanes, and
// only true recurrences stay serial on lane 0:
//   - twists, the RK4 stage angles' sin/cos and the position increments: a
//     lane per step; the heading and position recurrences (one add and a
//     wrap per step) on lane 0;
//   - the cos/sin tables of the H knots (and, 32 at a time, of the nb drawn
//     positions): a lane per (knot, k) pair, into shared memory;
//   - c_k, the history sums, metric terms, Wh and the ck_sum append: a lane
//     owns the coefficients k = lane, lane + 32, ... and adds over t, then
//     over j, in ascending order; the metric's sum over k (and the barrier's
//     over t) is lane 0's, in ascending order, up to 256 terms, and past
//     that a lane's every 32nd term added by a butterfly (warp_sum);
//   - the gradient's two contractions: a lane per (knot, k1) pair; then a
//     lane per knot for the sum over k1, the walls, the bilinear reads and
//     the patch gradient (on per-scenario maps a warp reads one scenario's
//     patch, so its reads share cache lines);
//   - the co-state recurrence on lane 0, then u = clip(-R^-1 B^T rho) a lane
//     per (step, control) pair, written with neighbouring lanes on
//     neighbouring addresses;
//   - validation: a lane per probe, a warp maximum. DWA sweep: a lane per
//     candidate (lane, lane + 32, ...), each walking its dwa_horizon probes
//     (as many lane-rounds as spreading the probes would take, and a
//     candidate's crash stays in its lane); the winner is the smallest
//     (cost, candidate index) pair of a warp reduction, which is the first
//     candidate that reaches the minimum, as the plain version's argmin.
// Every expression is the one-thread-per-scenario kernel's, and every sum
// keeps its order, so the outputs keep their bits.
//
// What it leaves behind from the TPU kernel: the scenario-on-lanes layout
// (operands are scenario-first), the bf16 hi/mid/lo map split and one-hot
// row selection (the fp32 map is read with clamped gathers), the bit-packed
// threshold planes (the crop is thresholded directly), the reach-limited
// step windows (queries clamp to the full crop, which gives the same cells
// by the config contract) and lazy_dwa (the sweep always runs).
//
// What bounds it on an H100: the refresh does K^2 * Npad multiply-adds and
// J * Npad expf per scenario (4.1 G multiply-adds at S=4096, Npad=10,048, K=10):
// float32 arithmetic fed from shared memory, bound by the shared-memory pipe
// (gmm_refresh.cuh). The solve is bound by instruction issue: at S = 4096
// an SM holds 20 warps (4 a block, 8 measured no faster; ptxas gives k1_solve
// 96 registers, 32 bytes of stack and no spills, and a warp 6.6 KB of shared
// memory at K = 10, H = 20: 122 KB a block at K = 16, H = 64 with nb > 0),
// which hide each other's latencies; what remains is the
// count of warp instructions a scenario needs: the accurate sinf / cosf of
// the tables (4 K H + 2 K nb values over 32 lanes), the K^2 (H + nb)
// multiply-adds of c_k over 32 lanes, and the serial stretches (heading,
// position and co-state recurrences, the metric's <= 256 ordered adds), which
// one lane runs while 31 idle. k1_safety: 64 registers, no shared memory.
// k1_refresh: 128 registers, no spills, two blocks an SM.
//
// Rounding contract: built with -fmad=false, so each multiply and add rounds
// on its own as in PyTorch's elementwise ops. The safety stage evaluates the
// plain version's expressions in the plain version's order (ops/integrator.py
// constant_twist_poses, ops/patch.py query_dist, models' twist/from_twist),
// so positions, cells and collision codes agree bit for bit given the same
// u0. Rounding is half-to-even (rintf), as torch.round / jnp.round. The
// heading wrap is a floor-mod (fmodf, then + 2 pi when the signs differ).
// The descent stage follows the plain version's arithmetic too (the model's
// RK4, direct cos/sin tables, co-state sums in row order), not the TPU
// kernel's Chebyshev recurrence and merged RK4 stages: the barrier's 1/d^2
// terms amplify any rounding difference in the knots, so the knots match bit
// for bit and only the order of the c_k, metric and gradient sums differs.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "gmm_refresh.cuh"
#include "launch.cuh"

namespace k1 {

constexpr int NUMAX = 4;   // controls
constexpr int SOLVE_WARPS = 4;  // warps (scenarios) per block of k1_solve / k1_safety
constexpr int HIST_CHUNK = 32;      // drawn positions whose cos tables are held at a time
constexpr int SERIES = 18;          // per-step arrays of a warp (see k1_solve)
constexpr int SERIAL_SUM = 256;     // most terms lane 0 adds alone (warp_sum)
constexpr int FIN_THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float FAR = 1.0e6f;
constexpr float INFEASIBLE = 1.0e9f;

// floats of scratch a warp of k1_solve needs: the larger of the two gradient
// contractions (2 H K), the metric terms (K^2) and a chunk of history tables
__host__ __device__ inline int solve_scratch_floats(int K, int H, int nb) {
    int n = 2 * H * K > K * K ? 2 * H * K : K * K;
    if (nb > 0 && 2 * K * HIST_CHUNK > n) n = 2 * K * HIST_CHUNK;
    return n;
}

// floats of shared memory one warp (one scenario) of k1_solve uses
__host__ __device__ inline int solve_warp_floats(int K, int H, int nb) {
    return K * K * (nb > 0 ? 2 : 1) + 4 * H * K + solve_scratch_floats(K, H, nb) + SERIES * H +
           NUMAX;
}

}  // namespace k1

using namespace k1;

// Mirror of ops/solve_kernel.py::_Params (same field order).
struct K1Params {
    int S, H, K, nu, P, Pc, J, Npad, map_h, map_w, masked, model, cost_twist;
    int val_horizon, dwa_horizon, nvx, nvy, nw;
    int map_stride;  // floats between two scenarios' maps (0: one shared map)
    int safety;      // 0: k1_solve stops before validation + DWA (fused_solve)
    int nb;          // > 0: hist holds (S, nb, 2) drawn positions, not (S, K^2) sums
    int nsplit, chunks_per_split;  // lattice splits of the refresh (J > 0)
    int global_tables;  // 1: k1_solve's tables in solve_ws; 0: in shared memory
    int crop_from_map;  // k1_safety: the crop read from dist (map_h x map_w maps), not given
    int crop_offset;    // k1_safety from the map: crop cell (0, 0) is pstart + crop_offset
    float dt, half_dt, dt6, gamma, beta, b_eps, b_weight, b_weight2, o_weight, o_weight_m2;
    float b_radius, d_safe, inv_d_safe, d_min, patch_hi, crop_hi, tw_a, tw_b, inv_a, inv_r;
    float val_dt, dwa_dt, two_pi;
    float r_inv[4], u_min[4], u_max[4];
    float acc_dt[3], vel_lim[3];
};

// Mirror of ops/solve_kernel.py::_Buffers (device pointers, same order).
struct K1Buffers {
    const float *x, *U, *hist, *nh, *phik, *means, *covs, *weights, *pts, *D, *mask_ck;
    const float* dist;
    const int* pstart;
    const float *porigin, *pres, *dorigin, *dlen, *cks, *vb;
    float *U_new, *metric, *bcost, *ck_out;
    int* code;
    float* u_dwa;
    int* feasible;
    float* phik_buf;
    float *part_acc, *part_tot;  // (nsplit, S, K^2), (nsplit, S) partial sums of the refresh
    float* solve_ws;             // (S, solve_warp_floats) tables of k1_solve (global_tables)
};

// ---------------------------------------------------------------------------
// refresh
// ---------------------------------------------------------------------------

template <int TILES, bool CUT>
__global__ void __launch_bounds__(RT_THREADS, TILES == 1 ? RT_MIN_BLOCKS : 1)
k1_refresh(K1Params p, K1Buffers b) {
    extern __shared__ __align__(16) float rsm[];
    const int KK = p.K * p.K;
    const int sp = blockIdx.y;
    const int n_begin = sp * p.chunks_per_split * RT_N;
    const int n_end = min(p.Npad, n_begin + p.chunks_per_split * RT_N);
    gmm_refresh_part<TILES, CUT>(blockIdx.x * RT_S, p.S, p.J, KK, blockIdx.z, n_begin, n_end,
                                 b.means, b.covs, b.weights, b.pts, b.D, nullptr, 0, rsm,
                                 b.part_acc + (size_t)sp * p.S * KK,
                                 b.part_tot + (size_t)sp * p.S);
}

__global__ void __launch_bounds__(FIN_THREADS) k1_finish(K1Params p, K1Buffers b) {
    const int s = blockIdx.x;
    const int KK = p.K * p.K;
    float t = 0.0f, a0 = 0.0f;
    for (int sp = 0; sp < p.nsplit; ++sp) {
        t += b.part_tot[(size_t)sp * p.S + s];
        a0 += b.part_acc[((size_t)sp * p.S + s) * KK];
    }
    for (int k = threadIdx.x; k < KK; k += FIN_THREADS) {
        float a = 0.0f;
        for (int sp = 0; sp < p.nsplit; ++sp) a += b.part_acc[((size_t)sp * p.S + s) * KK + k];
        float out;
        if (p.masked) {
            // ck = acc / (h00 acc_00): the free-mask fold's normalizer
            const float h00 = sqrtf(b.dlen[s * 2 + 0] * b.dlen[s * 2 + 1]);
            const float a00 = h00 * a0;
            const bool ok = (t > 1e-12f) && (a00 / fmaxf(t, 1e-12f) > 1e-12f);
            out = ok ? a / fmaxf(a00, 1e-30f) : b.mask_ck[k];
        } else {
            out = t > 1e-12f ? a / fmaxf(t, 1e-12f) : b.mask_ck[k];
        }
        b.phik_buf[(size_t)s * KK + k] = out;
    }
}

// ---------------------------------------------------------------------------
// solve: helpers
// ---------------------------------------------------------------------------

// pi - mod(pi - th, 2 pi), mod being the floor-mod of jnp.mod / torch.remainder
__device__ __forceinline__ float wrap_angle(float th, float two_pi) {
    float m = fmodf(PI_F - th, two_pi);
    if (m != 0.0f && ((m < 0.0f) != (two_pi < 0.0f))) m += two_pi;
    return PI_F - m;
}

// h_k = sqrt(Lx Ly c(k1) c(k2)), c(0) = 1, c(k > 0) = 1/2 (ops/basis.py hk_norm)
__device__ __forceinline__ float hk_norm(float area, int k1, int k2) {
    return sqrtf(area * (k1 ? 0.5f : 1.0f) * (k2 ? 0.5f : 1.0f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// v[0] + ... + v[n - 1] for the warp: up to SERIAL_SUM terms lane 0 adds them
// in ascending order (as the kernel always has: K <= 16, H <= 256); past
// that a lane adds every 32nd term and a butterfly adds the lanes' sums,
// whose rounding error grows with log n rather than n (the metric's K^2 =
// 1024 terms at K = 32). Called by all 32 lanes; lane 0's result is the sum.
__device__ __forceinline__ float warp_sum(const float* v, int n, int lane) {
    float acc = 0.0f;
    if (n <= SERIAL_SUM) {
        if (lane == 0)
            for (int i = 0; i < n; ++i) acc = acc + v[i];
        return acc;
    }
    for (int i = lane; i < n; i += 32) acc = acc + v[i];
    for (int o = 16; o > 0; o >>= 1) acc = acc + __shfl_xor_sync(FULL, acc, o);
    return acc;
}

struct MapView {
    const float* d;
    int mh, mw, sx, sy;  // map size, global cell of local (0, 0)
    __device__ __forceinline__ float at(int a, int c) const {
        return __ldg(d + clampi(sy + a, 0, mh - 1) * mw + clampi(sx + c, 0, mw - 1));
    }
};

// the patch's own gradient at local cell (a, c) of a P x P patch (ops/distance.py
// central_gradient on the patch: central differences / (2 res), one-sided / res
// at the patch edges, zero on the FAR plateau)
__device__ __forceinline__ void patch_grad(const MapView& m, int P, float res, int a, int c,
                                           float* gx, float* gy) {
    if (m.at(a, c) >= FAR) {
        *gx = 0.0f;
        *gy = 0.0f;
        return;
    }
    const float r2 = 2.0f * res;
    if (c == 0) *gx = (m.at(a, 1) - m.at(a, 0)) / res;
    else if (c == P - 1) *gx = (m.at(a, P - 1) - m.at(a, P - 2)) / res;
    else *gx = (m.at(a, c + 1) - m.at(a, c - 1)) / r2;
    if (a == 0) *gy = (m.at(1, c) - m.at(0, c)) / res;
    else if (a == P - 1) *gy = (m.at(P - 1, c) - m.at(P - 2, c)) / res;
    else *gy = (m.at(a + 1, c) - m.at(a - 1, c)) / r2;
}

// body twist of controls u, as the models' twist() rounds it
__device__ __forceinline__ void model_twist(const K1Params& p, const float* u, float* vx,
                                            float* vy, float* w) {
    if (p.model == 0) {  // cart: v = (r/2)(uL + uR), w = (r/b)(uR - uL)
        *vx = p.tw_a * (u[0] + u[1]);
        *vy = 0.0f;
        *w = p.tw_b * (u[1] - u[0]);
    } else {  // omni: signed sums in wheel order
        *vx = p.tw_a * (((u[0] + u[1]) + u[2]) + u[3]);
        *vy = p.tw_a * (((-u[0] + u[1]) + u[2]) + -u[3]);
        *w = p.tw_b * (((-u[0] + u[1]) + -u[2]) + u[3]);
    }
}

// controls for a body twist, as the models' from_twist() rounds them
__device__ __forceinline__ void model_from_twist(const K1Params& p, float vx, float vy, float w,
                                                 float* u) {
    if (p.model == 0) {  // cart: (vx -+ (b/2) w) / r
        u[0] = (vx - p.inv_a * w) / p.inv_r;
        u[1] = (vx + p.inv_a * w) / p.inv_r;
    } else {  // omni: L = lx + ly
        u[0] = ((vx - vy) - p.inv_a * w) / p.inv_r;
        u[1] = ((vx + vy) + p.inv_a * w) / p.inv_r;
        u[2] = ((vx + vy) - p.inv_a * w) / p.inv_r;
        u[3] = ((vx - vy) + p.inv_a * w) / p.inv_r;
    }
}

// column i of the model's B (df/du) at heading cos c, sin sn, as models' B() rounds it
__device__ __forceinline__ void model_B_col(const K1Params& p, float c, float sn, int i, float* b0,
                                            float* b1, float* b2) {
    if (p.model == 0) {  // cart: (r/2) (cos, sin) per wheel, then -+ r/b
        *b0 = p.tw_a * c;
        *b1 = p.tw_a * sn;
        *b2 = i == 0 ? -p.tw_b : p.tw_b;
    } else {  // omni: c sx - s sy, s sx + c sy, sw with sx = r/4, sy, sw = +-
        const float sy = (i == 0 || i == 3) ? -1.0f : 1.0f, sw = (i == 0 || i == 2) ? -1.0f : 1.0f;
        const float ax = p.tw_a * 1.0f, ay = p.tw_a * sy;
        *b0 = c * ax - sn * ay;
        *b1 = sn * ax + c * ay;
        *b2 = p.tw_b * sw;
    }
}

// a[i] of a 4-array held in the parameter block or in registers
__device__ __forceinline__ float pick4(const float* a, int i) {
    return i == 0 ? a[0] : (i == 1 ? a[1] : (i == 2 ? a[2] : a[3]));
}

struct Pose0 {
    float x, y, c0, s0;
};

// exact constant-twist position at time ts (ops/integrator.py constant_twist_poses)
__device__ __forceinline__ void arc(const Pose0& o, float vx, float vy, float w, float ts,
                                    float* px, float* py) {
    const float wt = w * ts;
    const float s = sinf(wt), c = cosf(wt);
    const bool small = fabsf(w) < 1e-6f;
    const float ws = small ? 1.0f : w;
    const float a = small ? ts * (1.0f - wt * wt / 6.0f) : s / ws;
    const float bb = small ? w * ts * ts * 0.5f : (1.0f - c) / ws;
    const float dxb = vx * a - vy * bb;
    const float dyb = vx * bb + vy * a;
    *px = o.x + o.c0 * dxb - o.s0 * dyb;
    *py = o.y + o.s0 * dxb + o.c0 * dyb;
}

struct Crop {
    MapView m;       // map view anchored at the CROP's cell (0, 0)
    float sxf, syf;  // that cell as floats
    float pox, poy, res, dox, doy, Lx, Ly, hi, b_radius, d_safe;
};

// collision code at a position (ops/collision.py check_pose on the crop):
// 2 crash (outside the domain or clearance <= radius), 1 warn, 0 none
__device__ __forceinline__ int pose_code(const Crop& g, float px, float py) {
    float fx = (px - g.pox) / g.res - 0.5f - g.sxf;
    float fy = (py - g.poy) / g.res - 0.5f - g.syf;
    fx = fminf(fmaxf(fx, 0.0f), g.hi);
    fy = fminf(fmaxf(fy, 0.0f), g.hi);
    const float d = g.m.at((int)rintf(fy), (int)rintf(fx)) - g.b_radius;
    const float rx = px - g.dox, ry = py - g.doy;
    const bool inside = rx >= 0.0f && rx <= g.Lx && ry >= 0.0f && ry <= g.Ly;
    if (!inside || d <= 0.0f) return 2;
    return d < g.d_safe ? 1 : 0;
}

// ---------------------------------------------------------------------------
// safety stage: validation of u0 over val_horizon steps, then the DWA sweep
// over every candidate and dwa_horizon steps (controller.py::safety)
// ---------------------------------------------------------------------------

// twist and controls of candidate c = (ia * nvy + ib) * nw + ic: each axis is
// lo + (hi - lo) * i / (n - 1) over the clipped window, through the model's
// from_twist and back through twist, as ops/dwa.py rounds them
__device__ __forceinline__ void dwa_candidate(const K1Params& p, const float* lo, const float* span,
                                              int c, float* uc, float* rvx, float* rvy,
                                              float* rw) {
    const int nax[3] = {p.nvx, p.nvy, p.nw};
    const int idx[3] = {c / (p.nvy * p.nw), (c / p.nw) % p.nvy, c % p.nw};
    float tw[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
        tw[a] = nax[a] == 1 ? 0.0f : lo[a] + span[a] * ((float)idx[a] / (float)(nax[a] - 1));
    model_from_twist(p, tw[0], tw[1], tw[2], uc);
    model_twist(p, uc, rvx, rvy, rw);
}

// Called by all 32 lanes of the scenario's warp with the same arguments
// (u0: the nu controls to validate, zeros beyond nu); lane 0 and lanes < nu
// write the outputs.
__device__ __forceinline__ void safety_stage(const K1Params& p, const Crop& g, const Pose0& pose,
                                             const float* u0, const float* vb3, int lane,
                                             int* code_out, float* u_dwa, int* feasible_out) {
    float vx0, vy0, w0;
    model_twist(p, u0, &vx0, &vy0, &w0);
    int code = 0;
    for (int t = 1 + lane; t <= p.val_horizon; t += 32) {
        float px, py;
        arc(pose, vx0, vy0, w0, p.val_dt * (float)t, &px, &py);
        code = max(code, pose_code(g, px, py));
    }
    for (int o = 16; o > 0; o >>= 1) code = max(code, __shfl_xor_sync(FULL, code, o));

    float lo[3], span[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float vb = vb3[a];
        const float l = fminf(fmaxf(vb - p.acc_dt[a], -p.vel_lim[a]), p.vel_lim[a]);
        const float h = fminf(fmaxf(vb + p.acc_dt[a], -p.vel_lim[a]), p.vel_lim[a]);
        lo[a] = l;
        span[a] = h - l;
    }
    const int C = p.nvx * p.nvy * p.nw;
    float best = INFINITY;
    int bidx = INT_MAX;
    for (int c = lane; c < C; c += 32) {
        float uc[NUMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
        float rvx, rvy, rw;
        dwa_candidate(p, lo, span, c, uc, &rvx, &rvy, &rw);
        bool crash = false;
        for (int t = 1; t <= p.dwa_horizon && !crash; ++t) {
            float px, py;
            arc(pose, rvx, rvy, rw, p.dwa_dt * (float)t, &px, &py);
            crash = pose_code(g, px, py) == 2;
        }
        float cost;
        if (crash) {
            cost = INFEASIBLE;
        } else if (p.cost_twist) {
            const float ex = rvx - vx0, ey = rvy - vy0, ew = rw - w0;
            cost = ex * ex + ey * ey + ew * ew;
        } else {
            cost = 0.0f;
#pragma unroll
            for (int i = 0; i < NUMAX; ++i) {
                if (i < p.nu) {
                    const float du = uc[i] - u0[i];
                    cost = cost + du * du;
                }
            }
        }
        if (cost < best) {  // strict: the lane's first candidate reaching its minimum
            best = cost;
            bidx = c;
        }
    }
    // the smallest (cost, index) pair: the first candidate reaching the minimum
    for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, o);
        const int oi = __shfl_xor_sync(FULL, bidx, o);
        if (ob < best || (ob == best && oi < bidx)) {
            best = ob;
            bidx = oi;
        }
    }
    const bool feasible = best < INFEASIBLE;
    if (lane == 0) {
        *code_out = code;
        *feasible_out = feasible ? 1 : 0;
    }
    if (lane < p.nu) {
        float uc[NUMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
        float rvx, rvy, rw;
        dwa_candidate(p, lo, span, feasible ? bidx : 0, uc, &rvx, &rvy, &rw);
        u_dwa[lane] = feasible ? pick4(uc, lane) : 0.0f;
    }
}

// ---------------------------------------------------------------------------
// solve
// ---------------------------------------------------------------------------

// GLOBAL_TABLES: the warps' tables lie in b.solve_ws, not in shared memory.
template <bool GLOBAL_TABLES>
__global__ void __launch_bounds__(32 * SOLVE_WARPS) k1_solve(K1Params p, K1Buffers b) {
    extern __shared__ float sm[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int s = blockIdx.x * SOLVE_WARPS + warp;
    if (s >= p.S) return;  // a whole warp: the block has no barrier
    const int H = p.H, K = p.K, KK = K * K, HK = H * K, nu = p.nu;

    // this warp's tables
    const size_t wf = solve_warp_floats(K, H, p.nb);
    float* WH = GLOBAL_TABLES ? b.solve_ws + (size_t)s * wf  // Lambda (c - phi) / h
                              : sm + (size_t)warp * wf;
    float* HS = WH + KK;                                 // history sums (nb > 0 only)
    float* CXT = HS + (p.nb > 0 ? KK : 0);               // cos, sin tables of the knots (H, K)
    float* CYT = CXT + HK;
    float* SXT = CYT + HK;
    float* SYT = SXT + HK;
    float* SCR = SYT + HK;  // history tables, then metric terms, then the contractions
    float* KX = SCR + solve_scratch_floats(K, H, p.nb);  // SERIES arrays of H
    float *KY = KX + H, *KTH = KY + H, *CT = KTH + H, *ST = CT + H, *VX = ST + H, *VY = VX + H,
          *WW = VY + H, *DX = WW + H, *DY = DX + H, *A13 = DY + H, *A23 = A13 + H, *G1 = A23 + H,
          *G2 = G1 + H, *BV = G2 + H, *R1 = BV + H, *R2 = R1 + H, *R3 = R2 + H;
    float* U0 = R3 + H;  // NUMAX

    const float x0 = b.x[s * 3 + 0], y0 = b.x[s * 3 + 1], th0 = b.x[s * 3 + 2];
    const float dox = b.dorigin[s * 2 + 0], doy = b.dorigin[s * 2 + 1];
    const float Lx = b.dlen[s * 2 + 0], Ly = b.dlen[s * 2 + 1];
    const float pox = b.porigin[s * 2 + 0], poy = b.porigin[s * 2 + 1];
    const float res = b.pres[s];
    const float* dmap = b.dist + (size_t)s * p.map_stride;
    const MapView map{dmap, p.map_h, p.map_w, b.pstart[s * 2 + 0], b.pstart[s * 2 + 1]};
    const float* U = b.U + (size_t)s * H * nu;
    const float* phik = (p.J > 0 ? b.phik_buf : b.phik) + (size_t)s * KK;
    const float* hist = b.hist + (size_t)s * (p.nb > 0 ? 2 * p.nb : KK);

    // ---- 1. RK4 rollout: knots x_0 .. x_{H-1} (ops/integrator.py rk4_step
    // on the model's f; k2 == k3 exactly since theta-dot is constant)
    for (int t = lane; t < H; t += 32) model_twist(p, U + t * nu, VX + t, VY + t, WW + t);
    if (lane < NUMAX) U0[lane] = 0.0f;
    __syncwarp();
    if (lane == 0) {  // the heading recurrence
        float th = th0;
        for (int t = 0; t < H; ++t) {
            const float w = WW[t];
            KTH[t] = th;
            th = wrap_angle(th + p.dt6 * (w + 2.0f * w + 2.0f * w + w), p.two_pi);
        }
    }
    __syncwarp();
    for (int t = lane; t < H; t += 32) {  // the stages' sin/cos and the position increments
        const float th = KTH[t], vx = VX[t], vy = VY[t], w = WW[t];
        const float c1 = cosf(th), s1 = sinf(th);
        const float a2 = th + p.half_dt * w, a4 = th + p.dt * w;
        const float c2 = cosf(a2), s2 = sinf(a2), c4 = cosf(a4), s4 = sinf(a4);
        const float d1x = vx * c1 - vy * s1, d1y = vx * s1 + vy * c1;
        const float d2x = vx * c2 - vy * s2, d2y = vx * s2 + vy * c2;
        const float d4x = vx * c4 - vy * s4, d4y = vx * s4 + vy * c4;
        DX[t] = p.dt6 * (d1x + 2.0f * d2x + 2.0f * d2x + d4x);
        DY[t] = p.dt6 * (d1y + 2.0f * d2y + 2.0f * d2y + d4y);
        CT[t] = c1;
        ST[t] = s1;
        A13[t] = -vx * s1 - vy * c1;  // the model's A^T rows at the knot (co-state)
        A23[t] = vx * c1 - vy * s1;
    }
    __syncwarp();
    if (lane == 0) {  // the position recurrence
        float px = x0, py = y0;
        for (int t = 0; t < H; ++t) {
            KX[t] = px;
            KY[t] = py;
            px = px + DX[t];
            py = py + DY[t];
        }
    }
    __syncwarp();

    // ---- 2. cos / sin tables of the knots: cos(rel * (k * a)), the direct
    // tables of ops/basis.py::tables (a = (1 / L) * pi, as PyTorch rounds pi / L)
    const float ax = (1.0f / Lx) * PI_F, ay = (1.0f / Ly) * PI_F;
    for (int i = lane; i < HK; i += 32) {
        const int t = i / K, k = i - t * K;
        const float angx = (KX[t] - dox) * ((float)k * ax);
        const float angy = (KY[t] - doy) * ((float)k * ay);
        CXT[i] = cosf(angx);
        SXT[i] = sinf(angx);
        CYT[i] = cosf(angy);
        SYT[i] = sinf(angy);
    }
    // history term from the nb drawn positions (controller.py
    // drawn_history_sums): sum_j (cos_x[j, k1] w) cos_y[j, k2], w = 0 for an
    // empty buffer, divided by h_k below; HIST_CHUNK positions' tables at a time
    if (p.nb > 0) {
        const float wgt = b.nh[s] > 0.0f ? 1.0f : 0.0f;
        float* HCX = SCR;
        float* HCY = SCR + K * HIST_CHUNK;
        for (int k = lane; k < KK; k += 32) HS[k] = 0.0f;
        for (int j0 = 0; j0 < p.nb; j0 += HIST_CHUNK) {
            const int cnt = min(HIST_CHUNK, p.nb - j0);
            for (int i = lane; i < cnt * K; i += 32) {
                const int j = i / K, k = i - j * K;
                HCX[i] = cosf((hist[2 * (j0 + j) + 0] - dox) * ((float)k * ax));
                HCY[i] = cosf((hist[2 * (j0 + j) + 1] - doy) * ((float)k * ay));
            }
            __syncwarp();
            for (int k = lane; k < KK; k += 32) {
                const int k1 = k / K, k2 = k - k1 * K;
                float acc = HS[k];
                for (int j = 0; j < cnt; ++j) acc = acc + (HCX[j * K + k1] * wgt) * HCY[j * K + k2];
                HS[k] = acc;
            }
            __syncwarp();
        }
    }
    __syncwarp();

    // ---- 3. c_k over [history || rollout], metric terms, Wh = Lambda (c - phi) / h,
    // and the running basis-sum append at the current pose (knot 0)
    const float area = Lx * Ly;
    const float M = b.nh[s] + (float)H;
    for (int k = lane; k < KK; k += 32) {
        const int k1 = k / K, k2 = k - k1 * K;
        float acc = 0.0f;
        for (int t = 0; t < H; ++t) acc = acc + CXT[t * K + k1] * CYT[t * K + k2];
        const float hk = hk_norm(area, k1, k2);
        const float lam = powf(1.0f + (float)(k1 * k1) + (float)(k2 * k2), -1.5f);
        const float hs = p.nb > 0 ? HS[k] / hk : hist[k];
        const float ck = (hs + acc / hk) / M;
        const float dkk = ck - phik[k];
        SCR[k] = lam * dkk * dkk;
        WH[k] = lam * dkk / hk;
        b.ck_out[(size_t)s * KK + k] = b.cks[(size_t)s * KK + k] + CXT[k1] * CYT[k2] / hk;
    }
    __syncwarp();
    const float metric = warp_sum(SCR, KK, lane);  // the metric: the terms in ascending k
    if (lane == 0) b.metric[s] = metric;
    __syncwarp();

    // ---- 4-5. ergodic gradient + barrier at each knot
    float* P1 = SCR;       // (Cy @ Wh^T)[t, k1]
    float* P2 = SCR + HK;  // (Cx @ Wh)[t, k1]
    for (int i = lane; i < HK; i += 32) {
        const int t = i / K, k1 = i - t * K;
        float p1 = 0.0f, p2 = 0.0f;
        for (int k2 = 0; k2 < K; ++k2) {
            p1 = p1 + CYT[t * K + k2] * WH[k1 * K + k2];
            p2 = p2 + CXT[t * K + k2] * WH[k2 * K + k1];
        }
        P1[i] = p1;
        P2[i] = p2;
    }
    __syncwarp();
    const float lox = dox + p.b_eps, hix = dox + Lx - p.b_eps;
    const float loy = doy + p.b_eps, hiy = doy + Ly - p.b_eps;
    const float sxf = (float)map.sx, syf = (float)map.sy;
    const float scale = (1.0f / M) * 2.0f;
    for (int t = lane; t < H; t += 32) {
        const float kx = KX[t], ky = KY[t];
        float ex = 0.0f, ey = 0.0f;
        for (int k1 = 0; k1 < K; ++k1) {
            ex = ex + SXT[t * K + k1] * ((float)k1 * ax) * P1[t * K + k1];
            ey = ey + SYT[t * K + k1] * ((float)k1 * ay) * P2[t * K + k1];
        }
        ex = -scale * ex;
        ey = -scale * ey;

        // boundary walls
        const float ovx = fmaxf(kx - hix, 0.0f), unx = fmaxf(lox - kx, 0.0f);
        const float ovy = fmaxf(ky - hiy, 0.0f), uny = fmaxf(loy - ky, 0.0f);
        float bval = p.b_weight * ((ovx * ovx + unx * unx) + (ovy * ovy + uny * uny));
        float bgx = p.b_weight2 * (ovx - unx);
        float bgy = p.b_weight2 * (ovy - uny);

        // obstacle: bilinear patch reads (hat weights on the 2x2 support,
        // rows contracted first as in ops/patch.py PatchField.query)
        float fx = fminf(fmaxf((kx - pox) / res - 0.5f - sxf, 0.0f), p.patch_hi);
        float fy = fminf(fmaxf((ky - poy) / res - 0.5f - syf, 0.0f), p.patch_hi);
        const float x0f = floorf(fx), y0f = floorf(fy);
        const int ix = (int)x0f, iy = (int)y0f;
        const float wx0 = 1.0f - (fx - x0f), wx1 = 1.0f - ((x0f + 1.0f) - fx);
        const float wy0 = 1.0f - (fy - y0f), wy1 = 1.0f - ((y0f + 1.0f) - fy);
        const float dv = (wy0 * map.at(iy, ix) + wy1 * map.at(iy + 1, ix)) * wx0 +
                         (wy0 * map.at(iy, ix + 1) + wy1 * map.at(iy + 1, ix + 1)) * wx1;
        float g00x, g00y, g10x, g10y, g01x, g01y, g11x, g11y;
        patch_grad(map, p.P, res, iy, ix, &g00x, &g00y);
        patch_grad(map, p.P, res, iy + 1, ix, &g10x, &g10y);
        patch_grad(map, p.P, res, iy, ix + 1, &g01x, &g01y);
        patch_grad(map, p.P, res, iy + 1, ix + 1, &g11x, &g11y);
        const float gvx = (wy0 * g00x + wy1 * g10x) * wx0 + (wy0 * g01x + wy1 * g11x) * wx1;
        const float gvy = (wy0 * g00y + wy1 * g10y) * wx0 + (wy0 * g01y + wy1 * g11y) * wx1;
        const float d = fmaxf(dv - p.b_radius, p.d_min);
        if (d < p.d_safe) {
            const float diff = 1.0f / d - p.inv_d_safe;
            bval = bval + p.o_weight * (diff * diff);
            const float dvdd = p.o_weight_m2 * diff / (d * d);
            bgx = bgx + dvdd * gvx;
            bgy = bgy + dvdd * gvy;
        }
        BV[t] = bval;
        G1[t] = p.gamma * ex + p.beta * bgx;
        G2[t] = p.gamma * ey + p.beta * bgy;
    }
    __syncwarp();

    // ---- 6. backward co-state (ops/integrator.py costate_rk4_step with the
    // model's A: A^T rho = (0, 0, a13 r1 + a23 r2), so k1 = k2 = k3 = k4 = g
    // for r1, r2 and k2 == k3 for r3) + u = clip(-(B^T rho) / r)
    const float bsum = warp_sum(BV, H, lane);
    if (lane == 0) {
        b.bcost[s] = bsum / (float)H;
        float r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
        for (int t = H - 1; t >= 0; --t) {
            const float a13 = A13[t], a23 = A23[t];
            const float j1 = G1[t], j2 = G2[t];
            const float k1 = a13 * r1 + a23 * r2;
            const float k2 = a13 * (r1 + p.half_dt * j1) + a23 * (r2 + p.half_dt * j2);
            const float k4 = a13 * (r1 + p.dt * j1) + a23 * (r2 + p.dt * j2);
            r1 = r1 + p.dt6 * (j1 + 2.0f * j1 + 2.0f * j1 + j1);
            r2 = r2 + p.dt6 * (j2 + 2.0f * j2 + 2.0f * j2 + j2);
            r3 = r3 + p.dt6 * (k1 + 2.0f * k2 + 2.0f * k2 + k4);
            R1[t] = r1;
            R2[t] = r2;
            R3[t] = r3;
        }
    }
    __syncwarp();
    float* Un = b.U_new + (size_t)s * H * nu;
    for (int i = lane; i < H * nu; i += 32) {
        const int t = i / nu, c = i - t * nu;
        float b0, b1, b2;
        model_B_col(p, CT[t], ST[t], c, &b0, &b1, &b2);
        const float bt = b0 * R1[t] + b1 * R2[t] + b2 * R3[t];
        const float un = fminf(fmaxf(-bt * pick4(p.r_inv, c), pick4(p.u_min, c)),
                               pick4(p.u_max, c));
        Un[i] = un;
        if (t == 0) U0[c] = un;
    }
    __syncwarp();

    // ---- 7. safety: validate u0, then the DWA sweep, on the central crop
    if (!p.safety) return;
    const int o = (p.P - p.Pc) / 2;
    Crop g;
    g.m = MapView{dmap, p.map_h, p.map_w, map.sx + o, map.sy + o};
    g.sxf = (float)(map.sx + o);
    g.syf = (float)(map.sy + o);
    g.pox = pox; g.poy = poy; g.res = res; g.dox = dox; g.doy = doy; g.Lx = Lx; g.Ly = Ly;
    g.hi = p.crop_hi; g.b_radius = p.b_radius; g.d_safe = p.d_safe;
    const Pose0 pose{x0, y0, cosf(th0), sinf(th0)};
    const float u0[NUMAX] = {U0[0], U0[1], U0[2], U0[3]};
    safety_stage(p, g, pose, u0, b.vb + s * 3, lane, b.code + s, b.u_dwa + (size_t)s * nu,
                 b.feasible + s);
}

// ---------------------------------------------------------------------------
// safety alone, on a crop given as data
// ---------------------------------------------------------------------------

// Operands in K1Buffers: x, vb (S, 3); dist holds the crops (S, Pc, Pc),
// U holds u0 (S, nu) and pstart (S, 2) the global cell of crop cell (0, 0);
// or (FROM_MAP) dist holds the map (map_stride 0: one shared map), U the
// descent's controls (S, H, nu), of which step 0 is u0, and pstart the
// patch starts, the crop starting crop_offset cells on (the patch's central
// crop). A crop cell past the map's edge reads the edge's cell, as the
// gathered crop holds it, so both read the same values.
template <bool FROM_MAP>
__global__ void __launch_bounds__(32 * SOLVE_WARPS) k1_safety(K1Params p, K1Buffers b) {
    const int lane = threadIdx.x & 31;
    const int s = blockIdx.x * SOLVE_WARPS + (threadIdx.x >> 5);
    if (s >= p.S) return;  // a whole warp
    const int nu = p.nu;
    const int o = FROM_MAP ? p.crop_offset : 0;
    const int cx = b.pstart[s * 2 + 0] + o, cy = b.pstart[s * 2 + 1] + o;
    Crop g;
    g.m = FROM_MAP ? MapView{b.dist + (size_t)s * p.map_stride, p.map_h, p.map_w, cx, cy}
                   : MapView{b.dist + (size_t)s * p.Pc * p.Pc, p.Pc, p.Pc, 0, 0};
    g.sxf = (float)cx;
    g.syf = (float)cy;
    g.pox = b.porigin[s * 2 + 0]; g.poy = b.porigin[s * 2 + 1]; g.res = b.pres[s];
    g.dox = b.dorigin[s * 2 + 0]; g.doy = b.dorigin[s * 2 + 1];
    g.Lx = b.dlen[s * 2 + 0]; g.Ly = b.dlen[s * 2 + 1];
    g.hi = p.crop_hi; g.b_radius = p.b_radius; g.d_safe = p.d_safe;
    const float th0 = b.x[s * 3 + 2];
    const Pose0 pose{b.x[s * 3 + 0], b.x[s * 3 + 1], cosf(th0), sinf(th0)};
    const float* U0 = b.U + (size_t)s * (FROM_MAP ? p.H : 1) * nu;
    float u0[NUMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < NUMAX; ++i)
        if (i < nu) u0[i] = U0[i];
    safety_stage(p, g, pose, u0, b.vb + s * 3, lane, b.code + s, b.u_dwa + (size_t)s * nu,
                 b.feasible + s);
}

// ---------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------

// k1_refresh + k1_finish for p.S scenarios: phik_buf (S, K^2) from the mixtures.
static cudaError_t launch_refresh(K1Params& p, K1Buffers& b, cudaStream_t st) {
    const int KK = p.K * p.K;
    const size_t smem = refresh_smem_floats(KK, p.J) * sizeof(float);
    if (p.K < 1 || p.J < 1 || p.Npad % RT_N || p.nsplit < 1 || p.nsplit > 65535 ||
        p.nsplit * p.chunks_per_split * RT_N < p.Npad || refresh_slabs(KK) > 65535 ||
        smem > (size_t)max_dynamic_smem())
        return cudaErrorInvalidValue;
    const dim3 grid((p.S + RT_S - 1) / RT_S, p.nsplit, refresh_slabs(KK));
    const bool cut = refresh_cut(KK, p.J);
    cudaError_t e = launch_kernel(
        refresh_tiles(KK) == 1 ? (cut ? k1_refresh<1, true> : k1_refresh<1, false>)
                               : (cut ? k1_refresh<2, true> : k1_refresh<2, false>),
        grid, dim3(RT_THREADS), smem, st, p, b);
    if (e != cudaSuccess) return e;
    return launch_kernel(k1_finish, dim3(p.S), dim3(FIN_THREADS), 0, st, p, b);
}

// Launch K1 for p->S scenarios on `stream` (fused_solve_safety, or fused_solve
// with p->safety = 0); returns the CUDA error code (0 on success). Does not
// synchronize.
extern "C" int k1_fused_solve_safety(const K1Params* params, const K1Buffers* buffers,
                                     void* stream) {
    K1Params p = *params;
    K1Buffers b = *buffers;
    cudaStream_t st = (cudaStream_t)stream;
    if (p.S <= 0) return 0;
    const size_t smem =
        p.global_tables ? 0 : (size_t)SOLVE_WARPS * solve_warp_floats(p.K, p.H, p.nb) * sizeof(float);
    if (p.K < 1 || p.H < 1 || p.nu < 1 || p.nu > NUMAX || p.nb < 0 ||
        (p.global_tables && b.solve_ws == nullptr) || smem > (size_t)max_dynamic_smem())
        return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (p.J > 0) {
        e = launch_refresh(p, b, st);
        if (e != cudaSuccess) return (int)e;
    }
    e = launch_kernel(p.global_tables ? k1_solve<true> : k1_solve<false>,
                      dim3((p.S + SOLVE_WARPS - 1) / SOLVE_WARPS), dim3(32 * SOLVE_WARPS), smem,
                      st, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Dynamic shared memory a block may opt in to on the current device, in
// bytes (the limit ops/solve_kernel.py::global_tables plans k1_solve against).
extern "C" int k1_smem_optin(void) { return max_dynamic_smem(); }

// Floats of one warp's tables of k1_solve (mirrored by
// ops/solve_kernel.py::solve_warp_floats; the tests hold the two equal).
extern "C" int k1_solve_warp_floats(int K, int H, int nb) { return solve_warp_floats(K, H, nb); }

// Launch the refresh alone (k1_refresh + k1_finish): phik_buf (S, K^2) from
// the mixtures, for timing and checking it apart from k1_solve. Returns the
// CUDA error code (0 on success). Does not synchronize.
extern "C" int k1_refresh_phik(const K1Params* params, const K1Buffers* buffers, void* stream) {
    K1Params p = *params;
    K1Buffers b = *buffers;
    if (p.S <= 0) return 0;
    cudaError_t e = launch_refresh(p, b, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Launch the standalone safety stage (fused_safety, or with p->crop_from_map
// fused_safety_map) for p->S scenarios on `stream`; returns the CUDA error
// code (0 on success). Does not synchronize.
extern "C" int k1_fused_safety(const K1Params* params, const K1Buffers* buffers, void* stream) {
    K1Params p = *params;
    K1Buffers b = *buffers;
    if (p.S <= 0) return 0;
    if (p.nu > NUMAX || p.Pc < 1 ||
        (p.crop_from_map && (p.map_h < 1 || p.map_w < 1 || p.H < 1 || p.crop_offset < 0)))
        return (int)cudaErrorInvalidValue;
    cudaError_t e = launch_kernel(p.crop_from_map ? k1_safety<true> : k1_safety<false>,
                                  dim3((p.S + SOLVE_WARPS - 1) / SOLVE_WARPS),
                                  dim3(32 * SOLVE_WARPS), 0, (cudaStream_t)stream, p, b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
