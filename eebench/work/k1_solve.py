"""K1's solve and safety (``k1_solve`` or ``k1_solve_block``, and
``k1_safety`` where it runs apart), one launch a tick.

Counted from the algorithm, per scenario: the RK4 rollout (H steps: the
twist, four evaluations of the kinematics, the stage states, the update,
the heading wrap), the cos and sin tables at every knot (6 K), the
rollout's c_k (2 K^2 a knot) combined with the history and the count
(2 K^2), the metric (4 K^2), the gradient's weights (3 K^2) and its two
separable contractions a knot (4 K^2 + 4 K + 2), the barrier (70 a knot:
the four walls and the bilinear clearance and gradient), the co-state's RK4
step with A and B (120 + 20 a knot), the saturated update (9 nu a knot), the
ck_sum append (2 K^2 + 4 K) and, where the history reaches the kernel as
drawn positions, their tables and sums (nb (4 K + 2 K^2)). The safety stage:
25 operations a probe (the pose on the constant-twist arc and the
clearance test) for the validation's probes and for the DWA candidates'
probes, each candidate's probes up to its first crash, for the scenarios
whose validation crashed (the only ones whose DWA result is used); 10 nu a
candidate for its twist, its wheel speeds and its cost. ``facts`` holds
those probe and candidate counts per tick, read on the cell's inputs.
Bytes: the pose, warm start, history operand, counts, phi_k, ck_sum, twist
and geometry in, the map cells the patches cover (the shared map once, or
P^2 a scenario on per-scenario maps), and the controls, metric, barrier,
ck_sum and safety results out, once each.
"""


def count(cfg: dict, S: int, facts: dict):
    H, K = cfg["horizon"], cfg["num_basis"]
    KK = K * K
    cart = cfg["model"] == "cart"
    nu = 2 if cart else 4
    f_eval, twist = (5, 3) if cart else (8, 12)
    per = H * (twist + 4 * f_eval + 18 + 18 + 3)  # rollout
    per += H * 6 * K  # tables
    per += H * 2 * KK + 2 * KK + 4 * KK  # c_k, its combination, the metric
    per += 3 * KK + H * (4 * KK + 4 * K + 2)  # the gradient
    per += H * (70 + 140 + 9 * nu)  # barrier, co-state, update
    per += 2 * KK + 4 * K  # ck_sum append
    nb = facts["drawn_history"]
    per += nb * (4 * K + 2 * KK)
    flops = S * per + 25 * (facts["validation_probes"] + facts["dwa_probes"]) \
        + 10 * nu * facts["dwa_candidates"]
    hist = 2 * nb if nb else KK
    nbytes = 4 * (S * (3 + H * nu + hist + 1 + KK + KK + 3 + 9) + facts["map_cells"]
                  + S * (H * nu + 1 + 1 + KK + 1 + nu + 1))
    return flops, nbytes


def safety_facts(ref_cfg, model, x, vb, u, dwa_active, world) -> dict:
    """Probe and candidate counts of one tick on the reference's side:
    poses ``x``, twists ``vb``, emitted controls ``u`` (u0 where the
    validation passed), ``dwa_active`` (S,) from the reference's tick, and
    its ``world``. A scenario whose validation crashed counts all its
    validation probes (the crash's step is not kept)."""
    import torch

    from eebench.reference.ops.dwa import candidate_twists
    from eebench.reference.ops.integrator import constant_twist_poses

    dom = world.domain
    br, ds = ref_cfg.boundary_radius, ref_cfg.d_safe
    T = ref_cfg.val_horizon
    ts = ref_cfg.val_dt * torch.arange(1, T + 1, dtype=torch.float32, device=x.device)
    ok = ~dwa_active
    val = int(T * int(dwa_active.sum()))
    if ok.any():
        Xv = constant_twist_poses(x[ok], model.twist(u[ok]), ts)[:, None, :, :2]
        val += int(_first_crash(Xv, dom, world, ok, br, ds).sum())
    dwa = ref_cfg.dwa
    cands = probes = 0
    if dwa_active.any():
        tws = candidate_twists(vb[dwa_active], dwa)
        tws_real = model.twist(model.from_twist(tws))
        td = dwa.dt * torch.arange(1, dwa.horizon + 1, dtype=torch.float32, device=x.device)
        Xd = constant_twist_poses(x[dwa_active][:, None, :], tws_real, td)[..., :2]
        probes = int(_first_crash(Xd, dom, world, dwa_active, br, ds).sum())
        cands = tws.shape[0] * tws.shape[1]
    return {"validation_probes": val, "dwa_probes": probes, "dwa_candidates": cands}


def _first_crash(P, dom, world, rows, br, ds):
    """(n, C) probes each trajectory of positions P (n, C, T, 2) needs: up
    to its first crash, or all T; ``rows`` picks the n scenarios' fields."""
    import torch

    from eebench.reference.grid import Domain
    from eebench.reference.ops.collision import CRASH, check_pose
    from eebench.reference.ops.distance import DistanceField

    n, C, T, _ = P.shape
    d = world.dist
    field = DistanceField(d.dist[rows], d.grad[rows], d.origin[rows], d.resolution[rows])
    codes = check_pose(P.reshape(n, C * T, 2), Domain(dom.origin[rows], dom.lengths[rows]),
                       field, br, ds)
    crash = codes.reshape(n, C, T) >= CRASH
    return torch.where(crash.any(-1), crash.to(torch.int64).argmax(-1) + 1,
                       torch.full(crash.shape[:2], T, device=crash.device))
