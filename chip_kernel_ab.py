#!/usr/bin/env python3
"""Times K1, K2, the tick's glue G, the map kernels (the reveal R, the EDT E)
and the dense MI target (M) at the bench shape for the package of one tree,
and saves their outputs, so that two trees can be compared on one card.

    python3 chip_kernel_ab.py --root <tree> --tag <name> [--out <dir>]
    python3 chip_kernel_ab.py --compare <dir>/<tag a>.pt <dir>/<tag b>.pt

The first form imports ``ergodic_exploration_tpu_torch`` from ``<tree>``
(built into ``<tree>/build/kernels``), drives path A of ``chip_smoke.py``
(``bench.build_case`` at S = 4096: cart, K = 10, H = 20, a 100 x 100 lattice,
J = 2) for WARM_TICKS ticks, then times by CUDA events, each the median of
REPEATS runs of REPS calls:

  - the refresh alone (``k1_refresh`` + ``k1_finish``) and ``k1_solve`` (K1
    with phi_k given) on the state reached, and the whole K1 tick kernel;
    the refresh also for the first scenario alone (S = 1) and on path A's
    inputs at the four wide shapes of phase 21 (S = 4096, J = 2, masked),
    each held to ``refresh_plain`` as phase 21 of ``chip_smoke.py`` holds it
    (``refresh_errors``: ``within`` in the JSON line); two trees' refreshes
    differ by rounding where their kernels sum in another order;
  - K2 unmasked at S = 512 (path C's size) and masked at S = 4096 (path B's),
    on ``chip_smoke.distinct_case``'s mixtures and free masks;
  - G on the state reached: ``glue_pre`` on the shared draw (path A) and
    with per-scenario draws (path B's distinct maps after 3 ``explore``
    ticks), ``glue_post`` and ``glue_post`` with the advance, at S = 4096
    and on the first scenario alone (S = 1); where the tree's G has them,
    the in-place variants too, on a copy of the ring;
  - where the tree has R and E (``ops/reveal_kernel.py``, ``ops/edt_kernel.py``):
    the ray-cast reveal (sensor range 1.5 m), the EDT + gradient
    (``DistanceField.from_grid``) and the world rebuild with the free mask
    (``Engine._world_batched``: one launch of E where the tree's E computes
    the mask, else E and the mask in plain torch) on path F's beliefs after
    one reveal (``chip_smoke.mapping_case``), at S = 4096 and on the first
    scenario alone; a tree without them lists them under ``absent``;
  - the dense MI target, ``Engine._phik_grid_batch_dense_fn`` (M where the
    tree has ``ops/mi_dense_kernel.py``, else the plain torch program): on
    path F's beliefs after one reveal (r = 0) at S = 4096 and S = 1, and on
    path E's beliefs (``chip_smoke.mi_case``, r = 3) at S = 4096. Its outputs
    in a tree with M and in one without differ by rounding (within M's
    budget, rtol 2e-4 / atol 2e-5): ``--compare`` lists them;
  - the default configuration's tick (``Engine._replan_fn``, the eager
    controller step) on path C's case (S = 512) and on path Q's omni state
    (S = 256); a tree whose step runs K1 and one whose step runs the plain
    descent differ by rounding (``--compare`` lists them); the same tick of
    path C's case with the full ring (``buffer_batch`` None, on
    ``chip_smoke.full_ring``'s rings) and with the accumulate mode (after 3
    ticks), whose history sums a tree's glue kernel and the plain torch of
    another take in another order;
  - the coverage (``sensor.fraction_known``) on path F's beliefs after one
    reveal at S = 4096 and S = 1: the exact share in a tree with the
    coverage kernel, a float32 mean in one without (one rounding apart);
  - the full ring's sums (``glue_pre`` in mode "full": path A's
    configuration with ``buffer_batch`` None on ``chip_smoke.full_ring``'s
    rings of 1024) at S = 4096, 512 and 1, and that configuration's tick
    (``Engine._refresh_and_replan_fn``, eager) at S = 4096. Two trees whose
    kernels sum the full ring in another order give the same sums but for
    rare one-ulp ties (float64 sums rounded once), and so the same ticks;
  - the map sizes of ``chip_smoke.py``'s phase 28: the world rebuild with the
    free mask (``ops/edt_kernel.world_fields``) on 1400 x 1400 maps (S = 2)
    and on 4000 x 4000 maps (S = 4), the field alone there
    (``DistanceField.from_grid``), on ``chip_smoke.sparse_maps``; the dense MI
    target (``Engine._phik_grid_batch_dense_fn``) at 4000 x 4000 (S = 16,
    r = fc = 3, ``chip_smoke.ros_beliefs``), at K = 17 on path E's beliefs
    (r = 3), at K = 130 (S = 16, 100 x 100 beliefs, r = 3) and on a 4500 x
    4500 lattice of those beliefs (``phik_from_grid``, r = fc = 0). Their outputs
    are saved as SHA-256 digests of their bytes (equal digests: equal bits);
  - ``k1_solve`` (K1 with phi_k given) at the wide shapes of phase 21,
    (K, H) = (17, 65), (20, 80), (32, 128), (40, 256): path A's inputs at
    S = 4096 after one ``replan_refresh`` tick, phi_k the plain refresh's;
    and at (40, 256) on 512 distinct maps with 100 drawn history positions a
    scenario, after 5 ``explore`` ticks. Each tree runs the layout its own
    plan takes (a tree without the block form, its global tables); outputs
    as digests.

It prints one JSON line of those times with the card's name and power limit,
and saves every output it timed to ``<dir>/<name>.pt``. The second form fails
unless the outputs both files hold are equal bit for bit (an output that one
tree's kernels have and the other's lack is listed). To compare two trees,
run them in turns in one call on one card (a, b, b, a). The case is made from
this file's own copy of ``chip_smoke.py`` (the tree beside it), so both trees
get the same inputs. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
S_BIG, S_SMALL = 4096, 512
WARM_TICKS = 20
REPS, REPEATS = 20, 5
REFRESH_ATOL = 2.2e-6  # the JAX package's budget for its refresh (ops/pallas_kernels.py)


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_ab", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(root: Path, tag: str, out: Path) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_ab.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    import ergodic_exploration_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parents[1] != root:
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")
    from ergodic_exploration_tpu_torch import bench
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.ops import basis
    from ergodic_exploration_tpu_torch.ops import gmm_kernel as gk
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
    from ergodic_exploration_tpu_torch.ops import tick_glue as tg
    from ergodic_exploration_tpu_torch.utils import cuda_build

    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for name, built in cuda_build.build_all().items():
        fn = ""
        for line in built.log.splitlines():  # registers and spills of each kernel
            m = re.search(r"_Z\d+((?:k\d|glue|m|edt)_[a-z_]+|reveal_kernel|edt_kernel)"
                          r"(I(?:L[a-z]\d+E|[a-z])+E)?", line)
            fn = m.group(1) + (m.group(2) or "") if m else fn
            if "registers" in line or "spill" in line:
                print(f"{tag} {name} {fn}: {line.replace('ptxas info    :', '').strip()}")

    engine, sc, gmm, domain, world = bench.build_case(S_BIG, device=dev)
    for _ in range(WARM_TICKS):
        sc, u, _ = engine.replan_refresh(sc, gmm, domain, world)
        sc = smoke.advance(engine, sc, u)
    cfg = engine.config
    inp2, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
    inp0 = inp2._replace(refresh=None, phik=sk.refresh_plain(inp2.refresh, inp2.dlen))
    r = inp2.refresh

    cfg_b, x0_b, grids_b, gmm_b, dom_b = smoke.distinct_case(S_BIG, dev)
    K = cfg_b.num_basis
    pts = dom_b.sample_lattice(cfg_b.grid_samples)
    D = basis.dense_table(basis.tables(pts, K, dom_b), basis.hk_norm(K, dom_b.lengths))
    N = pts.shape[0]
    free = (grids_b.occupancy_at(pts.expand(S_BIG, N, 2)) < cfg_b.occupied_threshold).float()
    g_big = [t.contiguous() for t in gmm_b]
    g_small = [t[:S_SMALL].contiguous() for t in gmm_b]

    calls = {
        "refresh": lambda: sk.K1.refresh(r, inp2.dlen),
        "k1_solve": lambda: sk.K1(cfg, inp0),
        "k1_tick": lambda: sk.K1(cfg, inp2),
        "k2_unmasked_S512": lambda: gk.K2(*g_small, pts, D, None),
        "k2_masked_S4096": lambda: gk.K2(*g_big, pts, D, free),
    }
    operands = {"refresh": (r, inp2.dlen)}  # a refresh's name -> its operands
    U_new = sk.K1(cfg, inp2)
    pre_a, post_a = glue_operands(tg, cfg, sc, world, U_new)
    eng_b = Engine(cfg_b)
    world_b = eng_b.prepare_world(grids_b)
    phik_b = eng_b.phik_from_gmm(gmm_b, dom_b, world_b)
    sc_b = eng_b.explore(eng_b.init_scenarios(x0_b), phik_b, world_b, 3).scenarios
    inp_b, _ = sk.fused_tick_inputs(cfg_b, sc_b.state, sc_b.x, sc_b.vb, phik_b, world_b)
    pre_b, post_b = glue_operands(tg, cfg_b, sc_b, world_b, sk.K1(cfg_b, inp_b))
    in_place = "glue_post_inplace" in tg.TickGlue.VARIANTS
    for mode, pre, post, adv in (("sums", pre_a, post_a, False), ("nb", pre_b, post_b, True)):
        for S_, p_, q_ in ((S_BIG, pre, post), (1, first(pre), first(post))):
            calls[f"glue_pre_{mode}_S{S_}"] = lambda p_=p_: tg.G.pre(*p_)
            post_name = "glue_post_advance" if adv else "glue_post"
            calls[f"{post_name}_S{S_}"] = lambda q_=q_, adv=adv: tg.G.post(*q_, adv)
            if in_place:
                own = own_ring(q_)
                calls[f"{post_name}_inplace_S{S_}"] = (
                    lambda own=own, adv=adv: tg.G.post(*own, adv, True))
    absent = map_calls(calls, smoke, dev)
    dense_calls(calls, smoke, dev)
    step_calls(calls, smoke, dev)
    full_calls(calls, smoke, dev, engine, sc, gmm, domain, world)
    big = (big_calls(calls, smoke, dev) | wide_calls(calls, smoke, dev)
           | refresh_calls(calls, operands, smoke, dev, r, inp2.dlen))
    saved, times = {}, {}
    for name, fn in calls.items():
        res = fn()
        torch.cuda.synchronize()
        err = refresh_errors(sk, res, *operands[name]) if name in operands else None
        res = res._asdict() if hasattr(res, "_asdict") else {"out": res}
        for k, v in res.items():
            for i, t in enumerate(v if isinstance(v, tuple) else (v,)):  # the ring's three
                if t is not None:
                    t = t.cpu()
                    if name in big:  # the bytes' digest
                        t = torch.frombuffer(bytearray(hashlib.sha256(
                            t.contiguous().numpy().tobytes()).digest()), dtype=torch.uint8)
                    saved[f"{name}.{k}" + (f".{i}" if isinstance(v, tuple) else "")] = t
        runs = [smoke.events_ms(fn, REPS) for _ in range(REPEATS)]
        times[name] = {"ms": statistics.median(runs), "runs": runs}
        if err is not None:
            times[name].update(err)
    out.mkdir(parents=True, exist_ok=True)
    torch.save(saved, out / f"{tag}.pt")
    print(json.dumps({"tag": tag, "root": str(root), "card": card, "times": times,
                      "absent": absent}))
    return 0


MAP_CALLS = ("reveal_raycast_S4096", "edt_S4096", "world_S4096", "coverage_S4096",
             "reveal_raycast_S1", "edt_S1", "world_S1", "coverage_S1")


def map_calls(calls: dict, smoke, dev) -> list:
    """Add the map kernels' calls on path F's beliefs where the imported
    package has them; returns the names of those it lacks."""
    import importlib.util

    import torch

    if importlib.util.find_spec("ergodic_exploration_tpu_torch.ops.reveal_kernel") is None:
        return list(MAP_CALLS)
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.ops import sensor
    from ergodic_exploration_tpu_torch.ops.distance import DistanceField

    cfg, x0, truth = smoke.mapping_case(S_BIG, dev)
    eng = Engine(cfg)
    thr, win = cfg.occupied_threshold, sensor.raycast_window_cells(1.5, 0.05)
    x = torch.as_tensor(x0, device=dev)
    belief = sensor.reveal_raycast(truth._replace(data=torch.full_like(truth.data, -1.0)), truth,
                                   x, 1.5, win, occupied_threshold=thr)
    moved = x.clone()
    moved[:, :2] = torch.clamp(moved[:, :2] + 0.3, 0.3, 4.7)  # the next refresh's poses
    for S_ in (S_BIG, 1):
        b, t = (GridMap(*(f[:S_] for f in g)) for g in (belief, truth))
        p = moved[:S_]
        calls[f"reveal_raycast_S{S_}"] = lambda b=b, t=t, p=p: sensor.reveal_raycast(
            b, t, p, 1.5, win, occupied_threshold=thr).data
        calls[f"edt_S{S_}"] = lambda b=b: tuple(DistanceField.from_grid(b, thr)[:2])
        calls[f"world_S{S_}"] = lambda b=b: world_outputs(eng, b)
        calls[f"coverage_S{S_}"] = lambda b=b: sensor.fraction_known(b)
    return []


def dense_calls(calls: dict, smoke, dev) -> None:
    """Add the dense MI target's calls: path F's beliefs after one reveal
    (r = 0) at S = 4096 and S = 1, path E's beliefs (r = 3) at S = 4096."""
    import torch

    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops import sensor

    cfg, x0, truth = smoke.mapping_case(S_BIG, dev)
    eng = Engine(cfg)
    win = sensor.raycast_window_cells(1.5, 0.05)
    belief = sensor.reveal_raycast(truth._replace(data=torch.full_like(truth.data, -1.0)), truth,
                                   torch.as_tensor(x0, device=dev), 1.5, win,
                                   occupied_threshold=cfg.occupied_threshold)
    dom = Domain(truth.origin[0], truth.domain().lengths[0])
    for S_ in (S_BIG, 1):
        b = GridMap(*(f[:S_].contiguous() for f in belief))
        calls[f"dense_F_S{S_}"] = lambda b=b: eng._phik_grid_batch_dense_fn(b, dom, 0)
    eng_e, _, grids_e, _, _, dom_e = smoke.mi_case(S_BIG, dev)
    grids_e = grids_e._replace(data=grids_e.data.contiguous())
    calls[f"dense_E_r3_S{S_BIG}"] = lambda: eng_e._phik_grid_batch_dense_fn(
        grids_e, dom_e, smoke.MI_RADIUS)


def step_calls(calls: dict, smoke, dev) -> None:
    """Add the default configuration's tick (``ErgodicController.step``, by
    ``Engine._replan_fn``): path C's case (S = 512, after 3 ticks) and path
    Q's state (omni, S = 256, after one refresh of its loop, on that
    refresh's dense MI target). Its outputs: U, u, the metric and the codes."""
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.tools import quality

    def outputs(out):
        sc, u, diag = out
        return sc.state.U, u, diag.ergodic_metric, diag.collision_code

    cfg, x0, grids, gmm, dom = smoke.distinct_case(S_SMALL, dev, seed=3, use_fused_solve=False)
    eng = Engine(cfg)
    world = eng.prepare_world(grids)
    phik = eng.phik_from_gmm(gmm, dom)
    sc = eng.init_scenarios(x0)
    for _ in range(3):
        sc, u, _ = eng._replan_fn(sc, phik, world)
        sc = smoke.advance(eng, sc, u)
    calls[f"default_step_C_S{S_SMALL}"] = lambda: outputs(eng._replan_fn(sc, phik, world))
    for name, c in (("full_ring", cfg.replace(buffer_batch=None)),
                    ("accumulate", cfg.replace(history="accumulate"))):
        e = Engine(c)
        s = e.init_scenarios(x0)
        if name == "full_ring":
            s = s._replace(state=s.state._replace(
                buffer=smoke.full_ring(S_SMALL, c.buffer_capacity, dev, seed=28)))
        else:
            for _ in range(3):
                s, u, _ = e._replan_fn(s, phik, world)
                s = smoke.advance(e, s, u)
        calls[f"default_step_C_{name}_S{S_SMALL}"] = (
            lambda e=e, s=s: outputs(e._replan_fn(s, phik, world)))
    cfg_q = default_config("omni")
    eng_q = Engine(cfg_q)
    truth = quality.build_truth(smoke.Q_S, dev)
    sc_q, belief, _, _, _ = eng_q.explore_mapping_fused(
        eng_q.init_scenarios(quality.spawn_poses(cfg_q, truth, smoke.Q_S)), truth, 1,
        smoke.Q_EVERY)
    world_q = eng_q.prepare_world(belief)
    phik_q = eng_q._phik_grid_batch_dense_fn(belief, None, 0)
    calls[f"default_step_Q_S{smoke.Q_S}"] = lambda: outputs(eng_q._replan_fn(sc_q, phik_q,
                                                                             world_q))


def full_calls(calls: dict, smoke, dev, engine, sc, gmm, domain, world) -> None:
    """Add the full ring's calls on path A's state ``sc`` with
    ``chip_smoke.full_ring``'s rings: ``glue_pre`` in mode "full" at S =
    4096, 512 and 1, and the tick of path A's configuration with
    ``buffer_batch`` None (``Engine._refresh_and_replan_fn``) at S = 4096;
    the tick's outputs are U, u, the metric and the codes."""
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.ops import tick_glue as tg

    cfg = engine.config.replace(buffer_batch=None)
    ring = smoke.full_ring(S_BIG, cfg.buffer_capacity, dev)
    sc_full = sc._replace(state=sc.state._replace(buffer=ring))
    pre, _ = glue_operands(tg, cfg, sc_full, world, None)
    for S_ in (S_BIG, S_SMALL, 1):
        args = first(pre, S_) if S_ < S_BIG else pre
        calls[f"glue_pre_full_S{S_}"] = lambda args=args: tg.G.pre(*args)
    eng = Engine(cfg)

    def tick():
        sc_, u, diag = eng._refresh_and_replan_fn(sc_full, gmm, domain, world)
        return sc_.state.U, u, diag.ergodic_metric, diag.collision_code

    calls[f"tick_A_full_ring_S{S_BIG}"] = tick


def big_calls(calls: dict, smoke, dev) -> set:
    """Add the map sizes' calls (phase 28's shapes) of E and M; returns their
    names, whose outputs are saved as digests."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops import edt_kernel as ek
    from ergodic_exploration_tpu_torch.ops.distance import DistanceField

    cfg = default_config("cart").replace(use_fused_solve=True)
    thr, gs = cfg.occupied_threshold, cfg.grid_samples
    names = set()

    def add(name, fn):
        calls[name] = fn
        names.add(name)

    for S_, n, seed in ((2, smoke.E_MASK_CELLS, 281), (4, smoke.ROS_CELLS, 282)):
        g = smoke.sparse_maps(S_, n, seed, dev, gs)
        add(f"world_{n}_S{S_}", lambda g=g: ek.world_fields(g, g.domain(), thr, gs))
        if n == smoke.ROS_CELLS:
            add(f"edt_{n}_S{S_}", lambda g=g: tuple(DistanceField.from_grid(g, thr)[:2]))
    n = smoke.ROS_CELLS
    beliefs = GridMap(smoke.ros_beliefs(16, n, 283, dev), torch.zeros((16, 2), device=dev),
                      torch.full((16,), 0.05, device=dev))
    eng = Engine(cfg)
    add(f"dense_{n}_S16_r3", lambda: eng._phik_grid_batch_dense_fn(beliefs, None,
                                                                   smoke.MI_RADIUS))
    eng_e, _, grids_e, _, _, dom_e = smoke.mi_case(S_BIG, dev)
    grids_e = grids_e._replace(data=grids_e.data.contiguous())
    eng_17 = Engine(eng_e.config.replace(num_basis=17))
    add(f"dense_E_K17_S{S_BIG}", lambda: eng_17._phik_grid_batch_dense_fn(grids_e, dom_e,
                                                                         smoke.MI_RADIUS))
    small = GridMap(torch.from_numpy(smoke.mi_beliefs(16, 100, 100, seed=284)).to(dev),
                    torch.zeros((16, 2), device=dev), torch.full((16,), 0.05, device=dev))
    dom = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    eng_130 = Engine(cfg.replace(num_basis=130))
    add("dense_K130_S16", lambda: eng_130._phik_grid_batch_dense_fn(small, dom, smoke.MI_RADIUS))
    n = smoke.LATTICE_BIG
    eng_l = Engine(cfg.replace(grid_samples=(n, n), mi_frontier_cells=0))
    add(f"dense_lattice{n}_S16", lambda: eng_l.phik_from_grid(small, 0, domain=dom))
    return names


def wide_calls(calls: dict, smoke, dev) -> set:
    """Add ``k1_solve`` at phase 21's wide shapes (path A's inputs, S = 4096,
    phi_k given; 512 distinct maps with drawn history at the largest);
    returns their names, whose outputs are saved as digests."""
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk

    names = set()
    for K, H in smoke.WIDE_SHAPES:
        engine, sc, world, gmm, domain = smoke.wide_case(S_BIG, dev, K, H)
        cfg = engine.config
        sc, u, _ = engine.replan_refresh(sc, gmm, domain, world)
        sc = smoke.advance(engine, sc, u)
        inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
        inp = inp._replace(refresh=None, phik=sk.refresh_plain(inp.refresh, inp.dlen))
        names.add(f"k1_solve_A_K{K}_H{H}")
        calls[f"k1_solve_A_K{K}_H{H}"] = lambda cfg=cfg, inp=inp: sk.K1(cfg, inp)
    K, H = smoke.WIDE_SHAPES[-1]
    cfg, x0, grids, gmm, dom = smoke.distinct_case(smoke.WIDE_S, dev, num_basis=K, horizon=H)
    eng = Engine(cfg)
    world = eng.prepare_world(grids)
    phik = eng.phik_from_gmm(gmm, dom, world)
    sc = eng.explore(eng.init_scenarios(x0), phik, world, smoke.WIDE_TICKS).scenarios
    inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, phik, world)
    name = f"k1_solve_maps_K{K}_H{H}_S{smoke.WIDE_S}"
    calls[name] = lambda: sk.K1(cfg, inp)
    return names | {name}


def refresh_errors(sk, a, r, dlen) -> dict:
    """The refresh ``a`` of operands ``r`` against ``refresh_plain`` in
    float32 and in float64, held as phase 21 of ``chip_smoke.py`` holds it:
    within REFRESH_ATOL of the float32 plain version, or within it of the
    float64 one and no further from that than the float32 plain version is
    (at K = 32 the plain version's own float32 sums are 4.8e-6 from it)."""
    import torch

    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    ref = sk.refresh_plain(r, dlen)
    exact = sk.refresh_plain(r._replace(gmm=GaussianMixture(*(t.double() for t in r.gmm)),
                                        pts=r.pts.double(), D=r.D.double(),
                                        mask_ck=r.mask_ck.double()), dlen.double())
    torch.cuda.synchronize()
    e = (a - ref).abs().max().item()
    e_k, e_p = (a - exact).abs().max().item(), (ref - exact).abs().max().item()
    return {"err_plain": e, "err_float64": e_k, "plain_err_float64": e_p,
            "within": e <= REFRESH_ATOL or (e_k <= REFRESH_ATOL and e_k <= e_p)}


def refresh_calls(calls: dict, operands: dict, smoke, dev, r, dlen) -> set:
    """Add K1's refresh alone for the first scenario of path A's state
    (S = 1) and on path A's inputs at the wide shapes (S = 4096), each with
    its operands in ``operands``; returns the wide ones' names, whose
    outputs are saved as digests."""
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    r1 = r._replace(gmm=GaussianMixture(*(t[:1].contiguous() for t in r.gmm)))
    d1 = dlen[:1].contiguous()
    calls["refresh_S1"] = lambda: sk.K1.refresh(r1, d1)
    operands["refresh_S1"] = (r1, d1)
    names = set()
    for K, H in smoke.WIDE_SHAPES:
        engine, sc, world, gmm, domain = smoke.wide_case(S_BIG, dev, K, H)
        inp, _ = sk.fused_tick_inputs(engine.config, sc.state, sc.x, sc.vb, None, world, gmm,
                                      domain)
        name = f"refresh_K{K}_S{S_BIG}"
        calls[name] = lambda inp=inp: sk.K1.refresh(inp.refresh, inp.dlen)
        operands[name] = (inp.refresh, inp.dlen)
        names.add(name)
    return names


def world_outputs(eng, belief) -> tuple:
    """dist, grad and the free mask of ``Engine._world_batched`` on ``belief``
    over its own extent."""
    wd = eng._world_batched(belief, belief.domain())
    return wd.dist.dist, wd.dist.grad, wd.free_mask


def glue_operands(tg, cfg, sc, world, k1_out):
    """(glue_pre's operands, glue_post's operands) of the fused tick on the
    state ``sc`` with K1's outputs ``k1_out`` (chip_smoke.py's phase 23;
    glue_post's are None without them)."""
    from ergodic_exploration_tpu_torch.grid import Domain

    st, x = sc.state, sc.x.contiguous()
    dom = Domain(world.domain.origin.contiguous(), world.domain.lengths.contiguous())
    P = min(cfg.patch_cells, *world.dist.dist.shape[-2:])
    patch = tg.PatchGeometry(world.dist.origin.contiguous(), world.dist.resolution.contiguous(), P)
    pre = (cfg, tg.history_mode(cfg, True), st.rng, st.buffer, st.U, x, dom, patch)
    if k1_out is None:
        return pre, None
    safety = (k1_out.code, k1_out.u_dwa, k1_out.feasible)
    post = (cfg, cfg.shared_history_draw, k1_out.U_new, safety, st.buffer, st.hist_count, st.rng,
            x)
    return pre, post


def first(args, n: int = 1):
    """The operands of the first ``n`` scenarios alone (S = n)."""
    import torch

    def one(a):
        if isinstance(a, torch.Tensor):
            return a[:n].contiguous()
        if hasattr(a, "P"):  # a PatchGeometry: its patch size stays
            return a._replace(origin=one(a.origin), resolution=one(a.resolution))
        if hasattr(a, "_fields"):
            return type(a)(*map(one, a))
        if isinstance(a, tuple):
            return tuple(map(one, a))
        return a
    return tuple(map(one, args))


def own_ring(args):
    """glue_post's operands with a copy of the ring, which the in-place
    variant writes, call after call."""
    buf = args[4]
    return args[:4] + (buf._replace(states=buf.states.clone()),) + args[5:]


def compare(a: Path, b: Path) -> int:
    import torch

    ta, tb = torch.load(a), torch.load(b)
    both = [k for k in ta if k in tb]
    diff = [k for k in both if not torch.equal(ta[k], tb[k])]
    only = sorted(ta.keys() ^ tb.keys())
    print(f"{a.name} vs {b.name}: {len(both) - len(diff)} of {len(both)} outputs both hold "
          f"equal bit for bit" + (f"; differ: {diff}" if diff else "")
          + (f"; held by one only: {only}" if only else ""))
    return 1 if diff or not both else 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path, help="the tree whose package is timed")
    ap.add_argument("--tag", help="name of the saved outputs")
    ap.add_argument("--out", type=Path, default=HERE / "build" / "kernel_ab")
    ap.add_argument("--compare", type=Path, nargs=2, metavar=("A", "B"))
    a = ap.parse_args()
    if a.compare:
        return compare(*a.compare)
    if a.root is None or a.tag is None:
        ap.error("--root and --tag are needed to measure")
    return measure(a.root.resolve(), a.tag, a.out)


if __name__ == "__main__":
    sys.exit(main())
