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
//   - the safety stage alone on a (S, Pc, Pc) crop given as data (k1_safety).
// Built by nvcc for sm_90a (utils/cuda_build.py) and called through the plain C
// entry points at the end of this file from ops/solve_kernel.py.
//
// Launches on the caller's stream:
//   k1_refresh  (J > 0) phi_k of every scenario: the mixture over the padded
//               lattice contracted with the basis table (gmm_refresh.cuh),
//               normalized as ops/solve_kernel.py::refresh_plain does.
//   k1_solve    one thread per scenario, everything else, in this order:
//               RK4 rollout; cos/sin basis tables; (nb > 0) the history
//               sums over the drawn positions; c_k, metric and
//               ergodic gradient; boundary + obstacle barrier with bilinear
//               reads of the patch (values and the patch's own central-
//               difference gradient, one-sided at the PATCH edges, FAR
//               plateau zeroed); backward co-state; u = clip(-R^-1 B^T rho);
//               ck_sum append; validation of u0 over val_horizon steps and
//               the DWA sweep over every candidate and dwa_horizon steps.
//   k1_safety   one thread per scenario: that last stage alone. The sweep
//               (samples candidates x dwa_horizon probes, each independent)
//               is the part a later change can spread over a warp.
//
// What it leaves behind from the TPU kernel: the scenario-on-lanes layout
// (operands are scenario-first), the bf16 hi/mid/lo map split and one-hot
// row selection (the fp32 map is read with clamped gathers), the bit-packed
// threshold planes (the crop is thresholded directly), the reach-limited
// step windows (queries clamp to the full crop, which gives the same cells
// by the config contract) and lazy_dwa (the sweep always runs).
//
// What bounds it on an H100: the refresh does K^2 * Npad multiply-adds and
// J * Npad expf per scenario (4.2 G multiply-adds at S=4096, N=10,240, K=10):
// arithmetic fed from shared memory, with each staged chunk of the basis
// table reused by 32 scenarios (read per scenario it would be ~16 GB of L2
// traffic per tick). The solve is latency bound: one thread per scenario
// gives S/32 warps (128 at S=4096, about one per SM), each a long chain of
// dependent float ops, sinf/cosf and map reads; its per-thread tables (Wh,
// knots, gradients) live in shared memory rather than in spilled registers.
// With nb > 0 the history adds nb * (2 K cosf + K^2 multiply-adds) to that
// chain (at nb = 100, H = 20 five times the rollout's own c_k sums), in a
// second per-thread K^2 table; its (S, nb, 2) operand is read once.
// With per-scenario maps the scenarios share no cache lines (164 MB of maps at
// S=4096, of which a tick touches about P^2 * 4 B = 2.3 KB per scenario), so
// the map reads add DRAM latency to the same dependent chain.
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
#include <math.h>
#include <stdint.h>

#include "gmm_refresh.cuh"

namespace k1 {

constexpr int KMAX = 16;   // num_basis
constexpr int HMAX = 64;   // horizon
constexpr int NUMAX = 4;   // controls
constexpr int SOLVE_THREADS = 32;
constexpr float PI_F = 3.14159265358979323846f;
constexpr float FAR = 1.0e6f;
constexpr float INFEASIBLE = 1.0e9f;

}  // namespace k1

using namespace k1;

// Mirror of ops/solve_kernel.py::_Params (same field order).
struct K1Params {
    int S, H, K, nu, P, Pc, J, Npad, map_h, map_w, masked, model, cost_twist;
    int val_horizon, dwa_horizon, nvx, nvy, nw;
    int map_stride;  // floats between two scenarios' maps (0: one shared map)
    int safety;      // 0: k1_solve stops before validation + DWA (fused_solve)
    int nb;          // > 0: hist holds (S, nb, 2) drawn positions, not (S, K^2) sums
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
};

// ---------------------------------------------------------------------------
// refresh
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(RT_THREADS) k1_refresh(K1Params p, K1Buffers b) {
    extern __shared__ float sm[];
    const int KK = p.K * p.K;
    const int s0 = blockIdx.x * RT_S;
    float* accs = sm;                       // RT_S x KK, reuses the staged-table space
    float* tot = sm + (size_t)RT_N * KK;    // RT_S, reuses the phi space
    gmm_refresh_tile(s0, p.S, p.J, KK, 0, p.Npad, b.means, b.covs, b.weights, b.pts, b.D,
                     nullptr, 0, sm, accs, tot);
    for (int i = threadIdx.x; i < RT_S * KK; i += RT_THREADS) {
        const int sl = i / KK, k = i % KK, s = s0 + sl;
        if (s >= p.S) continue;
        const float t = tot[sl], a = accs[i];
        float out;
        if (p.masked) {
            // ck = acc / (h00 acc_00): the free-mask fold's normalizer
            const float h00 = sqrtf(b.dlen[s * 2 + 0] * b.dlen[s * 2 + 1]);
            const float a00 = h00 * accs[sl * KK];
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

// cos and sin of k * ang_k for k < K, ang_k = rel * (k * a): the direct
// tables of ops/basis.py::tables (a = (1 / L) * pi, as PyTorch rounds pi / L)
__device__ __forceinline__ void basis_row(float rel, float a, int K, float* C, float* Sn) {
#pragma unroll
    for (int k = 0; k < KMAX; ++k) {
        if (k >= K) break;
        const float ang = rel * ((float)k * a);
        C[k] = cosf(ang);
        if (Sn) Sn[k] = sinf(ang);
    }
}

// h_k = sqrt(Lx Ly c(k1) c(k2)), c(0) = 1, c(k > 0) = 1/2 (ops/basis.py hk_norm)
__device__ __forceinline__ float hk_norm(float area, int k1, int k2) {
    return sqrtf(area * (k1 ? 0.5f : 1.0f) * (k2 ? 0.5f : 1.0f));
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
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

// rows of the model's B (df/du) at heading cos c, sin sn, as models' B() rounds them
__device__ __forceinline__ void model_B(const K1Params& p, float c, float sn, float* B0,
                                        float* B1, float* B2) {
    if (p.model == 0) {  // cart: (r/2) (cos, sin) per wheel, then -+ r/b
        B0[0] = B0[1] = p.tw_a * c;
        B1[0] = B1[1] = p.tw_a * sn;
        B2[0] = -p.tw_b;
        B2[1] = p.tw_b;
    } else {  // omni: c sx - s sy, s sx + c sy, sw with sx = +-r/4 ...
        const float sx[4] = {1.0f, 1.0f, 1.0f, 1.0f}, sy[4] = {-1.0f, 1.0f, 1.0f, -1.0f},
                    sw[4] = {-1.0f, 1.0f, -1.0f, 1.0f};
        for (int i = 0; i < 4; ++i) {
            const float ax = p.tw_a * sx[i], ay = p.tw_a * sy[i];
            B0[i] = c * ax - sn * ay;
            B1[i] = sn * ax + c * ay;
            B2[i] = p.tw_b * sw[i];
        }
    }
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

__device__ __forceinline__ void safety_stage(const K1Params& p, const Crop& g, const Pose0& pose,
                                             const float* u0, const float* vb3, int* code_out,
                                             float* u_dwa, int* feasible_out) {
    const int nu = p.nu;
    float vx0, vy0, w0;
    model_twist(p, u0, &vx0, &vy0, &w0);
    int code = 0;
    for (int t = 1; t <= p.val_horizon; ++t) {
        float px, py;
        arc(pose, vx0, vy0, w0, p.val_dt * (float)t, &px, &py);
        code = max(code, pose_code(g, px, py));
    }
    *code_out = code;

    // candidate axes: lo + (hi - lo) * i / (n - 1) over the clipped window
    const int nax[3] = {p.nvx, p.nvy, p.nw};
    float lo[3], span[3];
    for (int a = 0; a < 3; ++a) {
        const float vb = vb3[a];
        const float l = fminf(fmaxf(vb - p.acc_dt[a], -p.vel_lim[a]), p.vel_lim[a]);
        const float h = fminf(fmaxf(vb + p.acc_dt[a], -p.vel_lim[a]), p.vel_lim[a]);
        lo[a] = l;
        span[a] = h - l;
    }
    float best = INFINITY, ubest[NUMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ia = 0; ia < nax[0]; ++ia)
    for (int ib = 0; ib < nax[1]; ++ib)
    for (int ic = 0; ic < nax[2]; ++ic) {
        const int idx[3] = {ia, ib, ic};
        float tw[3];
        for (int a = 0; a < 3; ++a)
            tw[a] = nax[a] == 1 ? 0.0f
                                : lo[a] + span[a] * ((float)idx[a] / (float)(nax[a] - 1));
        float uc[NUMAX];
        model_from_twist(p, tw[0], tw[1], tw[2], uc);
        float rvx, rvy, rw;
        model_twist(p, uc, &rvx, &rvy, &rw);
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
            for (int i = 0; i < nu; ++i) {
                const float du = uc[i] - u0[i];
                cost = cost + du * du;
            }
        }
        if (cost < best) {  // strict: the first candidate reaching the minimum wins
            best = cost;
            for (int i = 0; i < nu; ++i) ubest[i] = uc[i];
        }
    }
    const bool feasible = best < INFEASIBLE;
    for (int i = 0; i < nu; ++i) u_dwa[i] = feasible ? ubest[i] : 0.0f;
    *feasible_out = feasible ? 1 : 0;
}

// ---------------------------------------------------------------------------
// solve
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(SOLVE_THREADS) k1_solve(K1Params p, K1Buffers b) {
    extern __shared__ float sm[];
    const int tid = threadIdx.x;
    const int s = blockIdx.x * SOLVE_THREADS + tid;
    if (s >= p.S) return;
    const int H = p.H, K = p.K, KK = K * K, nu = p.nu;
    // per-thread tables, strided by the block so a warp's accesses hit 32 banks
    auto SH = [&](int i) -> float& { return sm[i * SOLVE_THREADS + tid]; };
    const int WH = 0, KXo = KK, KYo = KK + H, KTHo = KK + 2 * H, G1o = KK + 3 * H,
              G2o = KK + 4 * H, HSo = KK + 5 * H;  // HS (K^2) only with nb > 0

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
    {
        float px = x0, py = y0, th = th0;
        for (int t = 0; t < H; ++t) {
            float vx, vy, w;
            model_twist(p, U + t * nu, &vx, &vy, &w);
            SH(KXo + t) = px;
            SH(KYo + t) = py;
            SH(KTHo + t) = th;
            const float c1 = cosf(th), s1 = sinf(th);
            const float a2 = th + p.half_dt * w, a4 = th + p.dt * w;
            const float c2 = cosf(a2), s2 = sinf(a2), c4 = cosf(a4), s4 = sinf(a4);
            const float d1x = vx * c1 - vy * s1, d1y = vx * s1 + vy * c1;
            const float d2x = vx * c2 - vy * s2, d2y = vx * s2 + vy * c2;
            const float d4x = vx * c4 - vy * s4, d4y = vx * s4 + vy * c4;
            px = px + p.dt6 * (d1x + 2.0f * d2x + 2.0f * d2x + d4x);
            py = py + p.dt6 * (d1y + 2.0f * d2y + 2.0f * d2y + d4y);
            th = wrap_angle(th + p.dt6 * (w + 2.0f * w + 2.0f * w + w), p.two_pi);
        }
    }

    // ---- 2-3. c_k over [history || rollout], metric, Wh = Lambda (c - phi) / h
    const float ax = (1.0f / Lx) * PI_F, ay = (1.0f / Ly) * PI_F;
    const float area = Lx * Ly;
    const float M = b.nh[s] + (float)H;
    float Cx[KMAX], Sx[KMAX], Cy[KMAX], Sy[KMAX];
    for (int k = 0; k < KK; ++k) SH(WH + k) = 0.0f;
    for (int t = 0; t < H; ++t) {
        basis_row(SH(KXo + t) - dox, ax, K, Cx, nullptr);
        basis_row(SH(KYo + t) - doy, ay, K, Cy, nullptr);
#pragma unroll
        for (int k1 = 0; k1 < KMAX; ++k1) {
            if (k1 >= K) break;
#pragma unroll
            for (int k2 = 0; k2 < KMAX; ++k2) {
                if (k2 >= K) break;
                SH(WH + k1 * K + k2) += Cx[k1] * Cy[k2];
            }
        }
    }
    // history term from the nb drawn positions (controller.py
    // drawn_history_sums): sum_j (cos_x[j, k1] w) cos_y[j, k2], w = 0 for an
    // empty buffer, divided by h_k below
    if (p.nb > 0) {
        const float w = b.nh[s] > 0.0f ? 1.0f : 0.0f;
        for (int k = 0; k < KK; ++k) SH(HSo + k) = 0.0f;
        for (int j = 0; j < p.nb; ++j) {
            basis_row(hist[2 * j + 0] - dox, ax, K, Cx, nullptr);
            basis_row(hist[2 * j + 1] - doy, ay, K, Cy, nullptr);
#pragma unroll
            for (int k1 = 0; k1 < KMAX; ++k1) {
                if (k1 >= K) break;
                const float cw = Cx[k1] * w;
#pragma unroll
                for (int k2 = 0; k2 < KMAX; ++k2) {
                    if (k2 >= K) break;
                    SH(HSo + k1 * K + k2) += cw * Cy[k2];
                }
            }
        }
    }
    float metric = 0.0f;
    for (int k1 = 0; k1 < K; ++k1) {
        for (int k2 = 0; k2 < K; ++k2) {
            const int k = k1 * K + k2;
            const float hk = hk_norm(area, k1, k2);
            const float lam = powf(1.0f + (float)(k1 * k1) + (float)(k2 * k2), -1.5f);
            const float hs = p.nb > 0 ? SH(HSo + k) / hk : hist[k];
            const float ck = (hs + SH(WH + k) / hk) / M;
            const float dkk = ck - phik[k];
            metric = metric + lam * dkk * dkk;
            SH(WH + k) = lam * dkk / hk;
        }
    }
    b.metric[s] = metric;

    // ---- 4-5. ergodic gradient + barrier at each knot
    const float lox = dox + p.b_eps, hix = dox + Lx - p.b_eps;
    const float loy = doy + p.b_eps, hiy = doy + Ly - p.b_eps;
    const float sxf = (float)map.sx, syf = (float)map.sy;
    const float scale = (1.0f / M) * 2.0f;
    float bsum = 0.0f;
    for (int t = 0; t < H; ++t) {
        const float kx = SH(KXo + t), ky = SH(KYo + t);
        basis_row(kx - dox, ax, K, Cx, Sx);
        basis_row(ky - doy, ay, K, Cy, Sy);
        float ex = 0.0f, ey = 0.0f;
#pragma unroll
        for (int k1 = 0; k1 < KMAX; ++k1) {
            if (k1 >= K) break;
            float p1 = 0.0f, p2 = 0.0f;
#pragma unroll
            for (int k2 = 0; k2 < KMAX; ++k2) {
                if (k2 >= K) break;
                p1 = p1 + Cy[k2] * SH(WH + k1 * K + k2);  // (Cy @ Wh^T)[k1]
                p2 = p2 + Cx[k2] * SH(WH + k2 * K + k1);  // (Cx @ Wh)[k1]
            }
            ex = ex + Sx[k1] * ((float)k1 * ax) * p1;
            ey = ey + Sy[k1] * ((float)k1 * ay) * p2;
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
        bsum = bsum + bval;
        SH(G1o + t) = p.gamma * ex + p.beta * bgx;
        SH(G2o + t) = p.gamma * ey + p.beta * bgy;
    }
    b.bcost[s] = bsum / (float)H;

    // ---- 6. backward co-state (ops/integrator.py costate_rk4_step with the
    // model's A: A^T rho = (0, 0, a13 r1 + a23 r2), so k1 = k2 = k3 = k4 = g
    // for r1, r2 and k2 == k3 for r3) + u = clip(-(B^T rho) / r)
    float u0[NUMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
    {
        float r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
        float* Un = b.U_new + (size_t)s * H * nu;
        for (int t = H - 1; t >= 0; --t) {
            float vx, vy, w;
            model_twist(p, U + t * nu, &vx, &vy, &w);
            const float th = SH(KTHo + t);
            const float c = cosf(th), sn = sinf(th);
            const float a13 = -vx * sn - vy * c;
            const float a23 = vx * c - vy * sn;
            const float j1 = SH(G1o + t), j2 = SH(G2o + t);
            const float k1 = a13 * r1 + a23 * r2;
            const float k2 = a13 * (r1 + p.half_dt * j1) + a23 * (r2 + p.half_dt * j2);
            const float k4 = a13 * (r1 + p.dt * j1) + a23 * (r2 + p.dt * j2);
            r1 = r1 + p.dt6 * (j1 + 2.0f * j1 + 2.0f * j1 + j1);
            r2 = r2 + p.dt6 * (j2 + 2.0f * j2 + 2.0f * j2 + j2);
            r3 = r3 + p.dt6 * (k1 + 2.0f * k2 + 2.0f * k2 + k4);
            float B0[NUMAX], B1[NUMAX], B2[NUMAX];
            model_B(p, c, sn, B0, B1, B2);
            for (int i = 0; i < nu; ++i) {
                const float bt = B0[i] * r1 + B1[i] * r2 + B2[i] * r3;
                const float un = fminf(fmaxf(-bt * p.r_inv[i], p.u_min[i]), p.u_max[i]);
                Un[t * nu + i] = un;
                if (t == 0) u0[i] = un;
            }
        }
    }

    // ---- 7. running basis-sum append at the current pose
    basis_row(x0 - dox, ax, K, Cx, nullptr);
    basis_row(y0 - doy, ay, K, Cy, nullptr);
#pragma unroll
    for (int k1 = 0; k1 < KMAX; ++k1) {
        if (k1 >= K) break;
#pragma unroll
        for (int k2 = 0; k2 < KMAX; ++k2) {
            if (k2 >= K) break;
            const int k = k1 * K + k2;
            b.ck_out[(size_t)s * KK + k] =
                b.cks[(size_t)s * KK + k] + Cx[k1] * Cy[k2] / hk_norm(area, k1, k2);
        }
    }

    // ---- 8. safety: validate u0, then the DWA sweep, on the central crop
    if (!p.safety) return;
    const int o = (p.P - p.Pc) / 2;
    Crop g;
    g.m = MapView{dmap, p.map_h, p.map_w, map.sx + o, map.sy + o};
    g.sxf = (float)(map.sx + o);
    g.syf = (float)(map.sy + o);
    g.pox = pox; g.poy = poy; g.res = res; g.dox = dox; g.doy = doy; g.Lx = Lx; g.Ly = Ly;
    g.hi = p.crop_hi; g.b_radius = p.b_radius; g.d_safe = p.d_safe;
    const Pose0 pose{x0, y0, cosf(th0), sinf(th0)};
    safety_stage(p, g, pose, u0, b.vb + s * 3, b.code + s, b.u_dwa + (size_t)s * nu,
                 b.feasible + s);
}

// ---------------------------------------------------------------------------
// safety alone, on a crop given as data
// ---------------------------------------------------------------------------

// Operands in K1Buffers: x, vb (S, 3); U holds u0 (S, nu); dist holds the
// crops (S, Pc, Pc); pstart (S, 2) is the global cell of crop cell (0, 0).
__global__ void __launch_bounds__(SOLVE_THREADS) k1_safety(K1Params p, K1Buffers b) {
    const int s = blockIdx.x * SOLVE_THREADS + threadIdx.x;
    if (s >= p.S) return;
    const int nu = p.nu;
    Crop g;
    g.m = MapView{b.dist + (size_t)s * p.Pc * p.Pc, p.Pc, p.Pc, 0, 0};
    g.sxf = (float)b.pstart[s * 2 + 0];
    g.syf = (float)b.pstart[s * 2 + 1];
    g.pox = b.porigin[s * 2 + 0]; g.poy = b.porigin[s * 2 + 1]; g.res = b.pres[s];
    g.dox = b.dorigin[s * 2 + 0]; g.doy = b.dorigin[s * 2 + 1];
    g.Lx = b.dlen[s * 2 + 0]; g.Ly = b.dlen[s * 2 + 1];
    g.hi = p.crop_hi; g.b_radius = p.b_radius; g.d_safe = p.d_safe;
    const float th0 = b.x[s * 3 + 2];
    const Pose0 pose{b.x[s * 3 + 0], b.x[s * 3 + 1], cosf(th0), sinf(th0)};
    float u0[NUMAX] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int i = 0; i < nu; ++i) u0[i] = b.U[(size_t)s * nu + i];
    safety_stage(p, g, pose, u0, b.vb + s * 3, b.code + s, b.u_dwa + (size_t)s * nu,
                 b.feasible + s);
}

// ---------------------------------------------------------------------------
// entry point
// ---------------------------------------------------------------------------

static cudaError_t launch(const void* fn, dim3 grid, dim3 block, size_t smem, cudaStream_t st,
                          K1Params* p, K1Buffers* b) {
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    void* args[] = {p, b};
    return cudaLaunchKernel(fn, grid, block, args, smem, st);
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
    if (p.K > KMAX || p.H > HMAX || p.nu > NUMAX || p.nb < 0) return (int)cudaErrorInvalidValue;
    cudaError_t e;
    if (p.J > 0) {
        const size_t smem = refresh_smem_floats(p.K * p.K, p.J) * sizeof(float);
        e = launch((const void*)k1_refresh, dim3((p.S + RT_S - 1) / RT_S), dim3(RT_THREADS),
                   smem, st, &p, &b);
        if (e != cudaSuccess) return (int)e;
    }
    const size_t smem = (size_t)(p.K * p.K * (p.nb > 0 ? 2 : 1) + 5 * p.H) * SOLVE_THREADS *
                        sizeof(float);
    e = launch((const void*)k1_solve, dim3((p.S + SOLVE_THREADS - 1) / SOLVE_THREADS),
               dim3(SOLVE_THREADS), smem, st, &p, &b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// Launch the standalone safety stage (fused_safety) for p->S scenarios on
// `stream`; returns the CUDA error code (0 on success). Does not synchronize.
extern "C" int k1_fused_safety(const K1Params* params, const K1Buffers* buffers, void* stream) {
    K1Params p = *params;
    K1Buffers b = *buffers;
    if (p.S <= 0) return 0;
    if (p.nu > NUMAX || p.Pc < 1) return (int)cudaErrorInvalidValue;
    cudaError_t e = launch((const void*)k1_safety,
                           dim3((p.S + SOLVE_THREADS - 1) / SOLVE_THREADS),
                           dim3(SOLVE_THREADS), 0, (cudaStream_t)stream, &p, &b);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
