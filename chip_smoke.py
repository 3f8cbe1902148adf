#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA libraries from the sources in the checkout (one
``nvcc`` per source, started together), holds every kernel and variant
against its plain PyTorch version on the card at the shapes its path gives
it, drives each path of ``ergodic_exploration_tpu_torch`` through the
engine's entry points, and checks what comes out. Any failed phase exits
non-zero. Without a CUDA device it exits non-zero before printing any result.

Phases:

 1  environment; 2  build (ptxas registers / spills of every kernel)
 3  K1 (shared map, J = 2 / J = 0) vs plain, S = 4096, after 120 ticks; the
    refresh (``k1_refresh`` + ``k1_finish``) and ``k1_solve`` timed apart at
    S = 4096 and S = 1, the refresh alone vs plain
 4  path A, the bench tick: ``Engine.replan_refresh`` (cart, K = 10, H = 20,
    100 x 100 lattice, shared map, shared history draw, safety on) at
    S = 4096 and at S = 1, on ``bench.build_case``'s inputs (their sha256
    printed)
 5  the engine on the card vs on the CPU, one bench tick, S = 64
 6  K2 vs plain: unmasked, masked, degenerate scenarios, S = 1 and S = 100
 7  path B, the quick-start loop at full width: S = 4096 scenarios with
    distinct maps, ``warmup -> prepare_world -> phik_from_gmm (K2 masked) ->
    explore (K1 on per-scenario maps, history sums in the kernel) ->
    save/load_checkpoint -> explore``
 8  K1 on per-scenario maps (history as drawn positions and as sums),
    ``fused_solve`` and ``fused_safety`` vs plain, on the state phase 7
    reached (cart, S = 4096) and for omni at S = 512
 9  path C, the default configuration (the eager controller step: ``glue_pre``,
    K1 without its safety stage on per-scenario maps with the drawn history,
    ``fused_safety_map`` (k1_safety reading the patch's central crop from the
    map), ``glue_post``; K2 unmasked), S = 512, 10 ticks; the three kernels
    vs plain on this path's own inputs, the crop read from the map bit for bit
    equal to k1_safety on the crop ``gather_window`` cuts
10  path D, the obstacle-free configuration with safety off
    (``fused_solve``), S = 4096, 20 ticks, on one shared empty map (shared
    history draw) and on per-scenario empty maps (per-scenario draws); each
    variant vs plain on this path's own inputs
11  ``explore`` on the card vs on the CPU, S = 64, distinct maps, 3 ticks
12  K3 vs plain and vs the dense path (M): S = 4096 beliefs of 100 x 100 cells that
    differ per scenario, (r, fc) in (3, 3), (0, 3), (3, 0); S = 1, S = 100; a
    40 x 40 map with a 23 x 23 lattice and K = 6; maps the TPU kernel takes
    that K3 once refused: 8 x 8 beliefs with K = 10, a 40 x 40 map with
    fc = 200, K = 20 with r = 5; 200 x 200 beliefs (S = 1024), which take the
    row-band form; two launches bit for bit
13  path E, the MI tick at full width: ``Engine.replan_refresh_mi(...,
    sensor_radius_cells=3, domain=<shared>, use_mi_kernel=True)`` (K3, then K1
    on the shared map) on beliefs that a disc sensor reveals between ticks,
    S = 4096 and S = 1; K3 alone at S = 1 and on S = 4096 continuous beliefs
    (every cell uniform in (0, 1)); the same tick with the dense path (M) in
    K3's place, one M launch a tick; a short run without the frontier mask,
    with K3 and then with M (whose entry ``phik_dense_nofc`` is timed on its
    beliefs); a short run on 200 x 200 beliefs (S = 1024), which launches the
    row-band form
14  path F, the mapping loop at full width: ``explore_mapping_fused`` (ray-cast
    reveal (R) -> dense MI target (M) -> world rebuild (E with the free mask)
    -> 10 ticks of K1 on per-scenario maps), S = 4096, 5 refreshes, two rooms
    and a pillar; one R, one M and one E launch a refresh; the split of a
    refresh, each kernel beside its plain version; M against its plain
    version on the beliefs reached, also in every placement of its
    tables past the plan's (bit for bit)
15  the MI tick (S = 64) and the mapping loop (S = 16) on the card vs on the CPU
16  the single-robot node (``ExplorationNode``, ``default_config("cart")``, a
    100 x 100 map, native EDT): 300 ticks with a plant and a map update every
    50, eager (K1 without its safety stage and ``fused_safety_map``), fused (K1 on
    the node's map, S = 1) and
    fused with pipelining, each as a node whose ``step()`` replays its graph
    and a node that takes the eager tick by name, in lockstep and equal bit
    for bit on every tick, launches exact on the tick that captures and on
    the replays, p50 / p99 of ``step()`` against the 100 ms budget and host
    runtime calls a tick, graph against eager; 300 ticks of the MI target on
    a belief a disc sensor opens, graph and eager in lockstep; the node on
    the card vs on the CPU over one odometry stream; K1 and ``fused_safety_map``
    vs plain on the node's inputs
17  scale-out (path H), on ranks spawned with ``torch.multiprocessing`` and
    joined through a file store. Leg (a), a world of one NCCL rank: path A
    (S = 4096, 10 ticks) on ``make_scenario_mesh()`` and on ``make_mesh(1,
    1)`` and path E's MI tick with K3 on the mesh, each equal bit for bit to
    the unsharded engine; a collective checkpoint loaded by the unsharded
    engine, 5 more ticks equal; ``graft_entry.dryrun_multichip(1)``; K1 and
    K3 vs plain on the rank's inputs. Leg (b), two gloo ranks sharing the
    card: path A on mesh (2,), 2048 scenarios a rank, gathered and held
    against this process's unsharded engine; on mesh (1, 2) the
    sample-sharded GMM target (unmasked, masked, fully occupied scenarios) vs
    K2 and the MI target vs the dense path, and ``replan_refresh`` for 5
    ticks vs the unsharded engine from the same state; a checkpoint of two
    ranks loaded here equal bit for bit to their gathered state;
    ``dryrun_multichip(2)`` with its 2-D leg. Tick and collective times are
    printed; two ranks on one card are no scaling figure
18  path Q, the config-4 quality run at full length: ``tools.quality.run``
    (``default_config("omni")`` untouched: the eager step, K1 without its
    safety stage and ``fused_safety_map``), S = 256, 500 refreshes of 10 ticks, sensor range
    1.5 m, its spawns equal to those drawn on the CPU's EDT, held against
    docs/quality_config4.json (refresh 1's coverage
    within 1e-3, the later ``coverage_at`` points within 0.03, the final
    per-scenario p10 and median no lower than the record's by 0.05 and
    0.02), one M launch a refresh; the multi-room floors of
    tests/test_quality.py (S = 4, 400 ticks: mean speed, coverage,
    second-half rise; the separable MI target, no M); ``fused_safety_map``
    and K1 as the step launches it vs plain on the state the run reached
19  the headline entry point, ``ergodic_exploration_tpu_torch.bench``:
    ``bench._run()`` in process at full width (S = 4096, 50 ticks each of
    ``bench_throughput`` and ``bench_throughput_mi``; ``bench_latency``'s
    24 runs of 32 replans at S = 1), the launches of each of the three
    counted apart (each times graph replays of the entry point); K1 (J = 2
    at S = 4096 and S = 1; J = 0 fed by K3) and K3 vs plain on the states
    those loops reached; the three again on the eager functions, printed
    beside the line (never in it); the line's values finite and above 0, p99
    under the 100 ms budget; this run's path A and path E ticks printed
    beside it; ``python -m ergodic_exploration_tpu_torch.bench`` once as a
    subprocess, exit 0 and a line with the same keys

20  the closed loops as CUDA graphs (``explore`` replays graphs of 10 ticks
    and of 1, ``explore_mapping_fused`` one graph a refresh) against their
    plain loops (``_explore_loop``, ``_explore_mapping_fused_loop``) from
    one state, bit for bit in every output and the final state, the run
    that captures and a run of replays only, each with exact launch counts:
    path B (S = 4096, 100 ticks), path C and phase 8's omni case with the
    eager step (S = 512, 25 ticks), path D (``fused_solve``, 25 ticks), path
    F (5 refreshes) and path Q's configuration (S = 256, 2 refreshes); then
    ms a tick (or a refresh) of both by CUDA events, and under
    ``torch.profiler`` the host's CUDA runtime calls and the device's busy
    share; at most 10 host calls a tick on path B and 20 a refresh on path F
21  K1 and K2 past K = 16, H = 64 and the mixture sizes of the other phases,
    (K, H) in (17, 65), (20, 80), (32, 128), (40, 256), each with its
    warps' tables in the global workspace: ``replan_refresh`` on path
    A's inputs (S = 4096, the refresh inside K1 in slabs of 256
    coefficients), then K1 vs plain with safety on and off (the solve fed
    the kernel's own refresh, equal bit for bit to the tick with it inside;
    U within 5e-5 of plain, or no further from it than plain with its sums
    reversed is, a kernel fed phi_k in bfloat16 rejected by that budget)
    and the refresh alone vs plain and vs the refresh in float64;
    ``phik_from_gmm`` (K2 masked) and ``explore`` on S = 512 distinct maps,
    then K1 on per-scenario maps with the drawn history vs plain; k1_solve's
    two layouts (tables in shared memory, in the global workspace) timed
    against each other and equal bit for bit at (K, H) = (20, 80), (10, 20),
    (10, 40), (12, 40), (16, 64); K2 and the refresh vs plain at
    J = 1, 3, 64 for K = 17, 20, 32, 40 (unmasked, masked, degenerate
    mixtures); then the entry points that once refused these shapes, each on
    the card vs on the CPU: ``phik_from_gmm`` masked and unmasked at K = 17,
    20, 32, ``warmup(num_basis=17)``, ``replan``, ``replan_refresh`` and
    ``explore`` at (20, 80) and (32, 128), the fused ``ExplorationNode`` at
    H = 80; launches exact throughout
22  the single-tick entry points as CUDA graphs (``replan``,
    ``replan_refresh``, ``replan_refresh_mi`` replay a 1-tick graph) against
    their eager functions called by name, from one state: path A at S = 4096
    and S = 1, path E with K3 at S = 4096 (a disc reveal between ticks) and
    S = 1, its dense path, its 200 x 200 row bands at S = 1024, path C
    (``replan`` on the eager step, S = 512), path D (``fused_solve``), K1 on
    per-scenario maps with the history summed in it (S = 4096) and
    ``replan_refresh`` with K2 ahead of K1 (S = 512). Each: 10 chained ticks
    equal bit for bit in the state, u and every diagnostic, launches exact on
    the call that captures and on the replays; a tick with the inputs
    unchanged and one after an in-place change to the world, the target or
    the beliefs, still equal; the first call's outputs unchanged after the
    later calls; then, graphs against eager with only the scenarios
    changing, ms a tick by CUDA events and by host clock, the host's CUDA
    runtime calls a tick (at most 20 on path A), the S = 1 latency p50 /
    p99, the capture's seconds and the peak device memory
23  the tick's glue (G, ``csrc/tick_glue.cu``): ``glue_pre`` and
    ``glue_post`` (copying and in place) against their plain versions on
    the states of paths A, B, D and E at S = 4096 and at S = 1 and on path
    Q's omni state, a ring that just wrapped and NaN / inf put into U_new
    and u_dwa included: keys, draws, drawn positions, orbit flags, warm and
    patch starts, codes, flags, rings and counters equal, the in-place
    kernel's ring equal to the copying kernel's and the copying kernel's
    input ring unchanged, the shared draw's sums within 1e-6 (bit for bit
    against cuBLAS at S = 4096; at S = 1, where cuBLAS sums in another
    order, against the full batch's), the advanced poses within 1e-6; one
    tick of A and of B on the glue's plain versions against the kernels (U
    within 5e-5, metric and barrier rtol 1e-5, codes and flags equal); the
    kernels and copies a tick of A's 1-tick ``replan_refresh`` graph (at
    most 20) and of B's ``explore`` graph (at most 25), with the glue's
    share of the device time
24  the map kernels against their plain versions (``csrc/reveal_kernel.cu``,
    ``csrc/edt_kernel.cu``): the reveal cell for cell on path F's beliefs
    over its five refreshes (from the poses each refresh revealed from, ending
    at path F's final belief), at S = 1 (batched and one map), on poses at the
    maps' edges and corners, at sensor ranges 0.75, 1.5 and 3.0 m, with 97
    bins, with the tables in device memory, on 40 x 40 maps under the window
    and on 200 x 200 beliefs (S = 1024); E bit for bit in dist and grad, and
    with the free mask (``world_fields``) in its mask too, on path B's 4096
    distinct maps, path F's beliefs (also on a wider domain), an empty map, a
    full one, 60 x 140 maps, 200 x 200 beliefs and 512 x 512 maps with a NaN
    cell (the global-memory form); two launches of each equal bit for bit;
    R and E with and without the mask timed and bounded on path F's inputs
25  M, the dense MI target (``csrc/mi_dense_kernel.cu``), against its plain
    version (rtol 2e-4, atol 2e-5; the fallback rows bit for bit; two
    launches bit for bit): path F's beliefs (S = 4096, r = 0, fc = 3) and
    S = 1, path E's (r = 3, fc = 3 and 0), 200 x 200 beliefs at S = 1024
    (also in every placement of its tables past the plan's, bit for bit), a
    60 x 140 map with a 48 x 64 lattice and K = 12, all-unknown beliefs
    (every scenario the fallback) and fully known maps; each with the max
    abs and relative error, M's ms beside the plain version's and the cuBLAS
    contraction's alone, and the temporaries' peak of both; K = 17 (three
    tiles of k1) on path E's beliefs
26  the default configuration's step (``ErgodicController.step``: ``glue_pre``,
    K1 without its safety stage, ``fused_safety_map``, ``glue_post``) against the
    same tick through their plain versions on the card: path C's inputs
    (S = 512) with per-scenario draws, the full ring, the accumulate mode,
    safety off and one shared map, and path Q's omni state (S = 256); U
    within 5e-5, the metric and barrier rtol 1e-5, at most 2 scenarios with
    another code; launches exact; the kernels and copies a tick of C's and
    Q's ``explore`` graphs (at most STEP_KERNELS)
27  the last XLA stages as kernels: ``glue_pre`` on the full ring
    (``buffer_batch`` None: its sums over each ring's valid entries, in
    float64) against its plain version and the float64 sums at S = 4096, cap
    1024 (rings still filling, full, just wrapped, empty; no further from
    float64 than the plain version), at S = 1 (equal to the full batch's row
    bit for bit) and at K = 17; 10 chained ticks each of path A's
    configuration with the full ring (``replan_refresh``, S = 4096), of path
    C's with the full ring and with the accumulate mode (``replan``, the
    eager step, S = 512) against their plain routes (phase 26's budgets),
    launches exact, ``explore`` on both, the full-ring tick's peak device
    memory beside its plain route's; ``fused_safety_map`` bit for bit
    against k1_safety on the gathered crop on C's, Q's and the node's
    inputs and with poses on the maps' four edges; the coverage kernel
    (``fraction_known``) bit for bit against its plain version on path F's
    beliefs, all-unknown and all-known maps, S = 1 and 200 x 200 beliefs at
    S = 1024; each new variant timed beside the route it replaces
28  the map sizes the JAX package answers: E with the free mask on 1400 x
    1400 maps (S = 2) bit for bit against ``world_plain`` map by map, and on
    gmapping's default 4000 x 4000 maps (S = 4) in dist and grad against the
    EDT alone and in the mask against the plain mask; M against its plain
    version (DENSE_TOL) at 4000 x 4000 (S = 16, r = fc = 3: the rings, y
    sums and frontier words in the workspace, ``_global_sums``), at K = 130
    (100 x 100, S = 16) and on a 4500 x 4500 lattice through
    ``phik_from_grid`` (``_global_cx``); the mapping loop
    (``explore_mapping_fused``) at 4000 x 4000, S = 16, r = fc = 3, two
    refreshes of 10 ticks: finite outputs, the coverage risen from the
    unknown start and never falling, one R, E (``world_global``) and M
    launch a refresh, M against plain on the beliefs it reached; each
    case's ms, bound and temporaries' peak

Every closed loop of phases 7-18 (``explore``, ``explore_mapping``,
``explore_mapping_fused``) and every call of a single-tick entry point
(``replan``, ``replan_refresh``, ``replan_refresh_mi``, the node's
``step``) runs as graph replays, the first call of a shape capturing its
graphs; a graph's first call is its warm-up, whose launches are real and
counted. Every path is driven with the launch counts set to 0
just before it and read just after; the glue's counts (G) are read apart
from K1, K2 and K3's (``read_glue``) and checked on paths A and B (phases 4
and 7) and in phases 16, 20, 22 and 23; the map kernels' (R, E) too
(``read_map``; the coverage among them), checked in phases 4 and 7
(``prepare_world``), 14, 18, 20, 24 and 27; M's (``read_dense``) in
phases 13, 14, 18, 20 and 22. A graph's tick appends its ring in
place (``glue_post_inplace``, ``glue_post_advance_inplace``); the copying
variants run in the eager functions and plain loops, and their launches in
the kernels line are those of phase 20's plain loop of path B and phase
22's eager function of path A. The last two lines are a JSON line describing each kernel
variant that a path launched (launches on its path; error against the plain
version, time, the plain version's time and the least time the card could
take for the same work, all on that path's own inputs) and the result line
``{"ok": true, "device": {...}}``. Comparisons at other shapes are printed
and can fail the run, but do not enter that line.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
S_MAIN = 4096
WARM_TICKS = 120  # history depth of the state the kernel is checked on
TIMED_TICKS = 50
LATENCY_TICKS = 200
SPIN_MS = 20  # events_ms: the device spins this long while the host enqueues
EXPLORE_TICKS = 100
CODE_MISMATCH_LIMIT = 2  # scenarios whose code / feasible / u_dwa may differ

# kernel vs plain tolerances (same inputs, same card): controls at the
# parity budget of tests/test_solve_kernel.py; the metric, barrier and
# ck_sum are float32 sums taken in another order (atol covers zeros)
TOL = dict(U_new=dict(rtol=0.0, atol=5e-5), metric=dict(rtol=1e-5, atol=1e-7),
           barrier=dict(rtol=1e-5, atol=1e-7), ck_sum=dict(rtol=1e-5, atol=5e-6))
K2_ATOL = 2e-5  # the JAX package's own budget for its K2 (tests/test_engine.py)
K3_TOL = dict(rtol=2e-4, atol=2e-5)  # the JAX package's own for its K3 (tests/test_mi_kernel.py)
REFRESH_ATOL = 2.2e-6  # the JAX package's own for its refresh (ops/pallas_kernels.py)
S_BIG, CELLS_BIG, T_BIG = 1024, 200, 10  # the MI tick on maps that take K3's row-band form
MI_RADIUS = 3  # sensor_radius_cells of the MI tick
DENSE_TOL = dict(rtol=2e-4, atol=2e-5)  # M vs its plain version (tests/test_mi_kernel.py's budget)
DENSE_REPLACES = "ergodic_exploration_tpu/engine.py:586"  # _phik_grid_batch_dense_fn, XLA
MAP_REFRESHES, MAP_EVERY = 5, 10  # path F: refreshes and ticks per refresh
REVEAL_PEAK_LIMIT = 8 * 2**30  # bytes reveal_raycast may hold at S_MAIN
NODE_TICKS, NODE_MAP_EVERY = 300, 50  # phase 16: ticks after one warm-up tick; map cadence
NODE_MI_TICKS, NODE_REVEAL_EVERY = 300, 10  # phase 16's MI loop
NODE_CMP_TICKS = 10  # phase 16: ticks of the node on the card vs on the CPU
BUDGET_MS = 100.0  # the 10 Hz loop's period
REVEAL_RANGE = 0.75  # m: the disc a scenario's sensor reveals around its pose each MI tick
SCALE_TICKS, SAMPLE_TICKS, RESUME_TICKS = 10, 5, 5  # phase 17: mesh ticks; (1, 2); resumed
RANK_TIMEOUT_S = 300  # phase 17: the spawned ranks of one leg together
TICK_FIELDS = ("u", "metric", "code", "dwa_active", "dwa_feasible", "U")
Q_S, Q_REFRESHES, Q_EVERY = 256, 500, 10  # phase 18 (a): the record's quality run, full length
# phase 18 (a): the gaps to the record at its nine coverage ticks and the final
# p10 / median that the same run printed as a plain Python loop (NVIDIA H100
# 80GB HBM3, 700.00 W), with the dense MI target as plain torch (before M,
# whose sums take another order: the digits moved by rounding); the graphs'
# run is printed beside them
LOOP_Q_GAPS = ("+0.00000", "+0.00483", "+0.00612", "+0.00754", "+0.00251", "+0.00084",
               "-0.00381", "-0.00165", "+0.00115")
LOOP_Q_P10_MEDIAN = ("0.8381", "0.9834")
LAT_REPS, LAT_GROUP, LAT_CHAIN = 24, 8, 32  # phase 19: bench_latency's runs, groups, replans a run
BENCH_TIMEOUT_S = 300  # phase 19: the entry point run as a subprocess
WIDE_SHAPES = ((17, 65), (20, 80), (32, 128), (40, 256))  # phase 21: (K, H)
WIDE_S, WIDE_TICKS = 512, 5  # phase 21: scenarios of all but path A's inputs; ticks driven
WIDE_J = (1, 3, 64)  # phase 21: mixture components of the refresh and K2
WIDE_CPU_SHAPES = ((20, 80), (32, 128))  # phase 21: the entry points on the card vs on the CPU
LAYOUT_SHAPES = ((10, 20), (10, 40), (12, 40), (16, 64))  # phase 21: k1_solve's layouts timed
ENTRY_TICKS = 10  # phase 22: chained ticks of each path, graphs against eager
# ticks of an eager function or plain loop under torch.profiler (phases 16,
# 20, 22): its host calls are the same every tick, and the host reads a
# profile's events one by one, thousands a tick
PROFILE_LOOP_TICKS = 3
# phase 23: the shared draw's history sums, the glue kernel's fused
# multiply-adds in ascending order against the plain version's batched
# product; the most kernels (copies included) a tick of A's 1-tick
# replan_refresh graph and of B's explore graph
GLUE_SUM_ATOL = 1e-6
GLUE_KERNELS_A, GLUE_KERNELS_B = 20, 25
# phase 26: the most kernels (copies included) a tick of C's and Q's graphs:
# 14.6 measured once the step's crop was read from the map (PR 19), with the
# margin of 5 that the limit had over PR 18's 19.9
STEP_KERNELS = 20
S_STEP = 512  # phase 27: path C's scenarios, as in phases 9 and 26
# phase 28: gmapping's default map (x, y in [-100, 100] m, delta 0.05 m) in
# cells a side; the mapping loop's refreshes there; the large lattice's side
ROS_CELLS, ROS_REFRESHES, LATTICE_BIG = 4000, 2, 4500
E_MASK_CELLS = 1400  # phase 28: maps past the whole-map bit plane E once kept in shared memory

# the profiler's name of a glue kernel: "glue_pre_kernel(...)", or with
# template arguments "void glue_post_kernel<false, true>(...)"
GLUE_KERNEL = re.compile(r"(?:void )?glue_(?:pre|post)_kernel\b")

# published peaks of one H100 SXM: float32 outside the tensor cores, HBM3
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# cases, made from a seed with numpy
# ---------------------------------------------------------------------------


def _poses_and_gmm(S, rng, clear=None):
    """Poses uniform in [0.5, 4.5]^2 x (-pi, pi) (redrawn while ``clear``
    rejects them) and a two-component GMM per scenario (means uniform in
    [1, 4], covariance 0.3 I)."""
    xy = rng.uniform(0.5, 4.5, (S, 2))
    for _ in range(64):
        bad = np.zeros(S, bool) if clear is None else ~clear(xy)
        if not bad.any():
            break
        xy[bad] = rng.uniform(0.5, 4.5, (int(bad.sum()), 2))
    x0 = np.concatenate([xy, rng.uniform(-np.pi, np.pi, (S, 1))], axis=1).astype(np.float32)
    means = rng.uniform(1.0, 4.0, (S, 2, 2)).astype(np.float32)
    covs = np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None], (S, 2, 1, 1))
    return x0, (means, covs, np.ones((S, 2), np.float32))


def bench_case(S: int, device, seed: int = 0):
    """The headline bench's inputs (``ergodic_exploration_tpu_torch.bench``):
    its configuration, poses, shared wall-and-pillar map of a 5 m domain and
    GMM."""
    from ergodic_exploration_tpu_torch import bench
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    a = bench.case_arrays(S, seed)
    return (bench.bench_config(), a.x0, bench.shared_grids(a.data, S, device),
            GaussianMixture.create(a.means, a.covs, a.weights, device=device),
            Domain.create(0.0, 0.0, 5.0, 5.0, device=device))


def distinct_case(S: int, device, model: str = "cart", seed: int = 1, clearance=0.25,
                  **overrides):
    """S scenarios with DISTINCT 100 x 100 maps of a 5 m domain: a wall
    (5 x 60 cells) and a pillar (8 x 8) at per-scenario positions, start
    poses at least ``clearance`` m clear of both (the footprint radius is
    0.2 m; None: anywhere, inside obstacles too), a two-component GMM each."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    opts = dict(use_fused_solve=True, shared_maps=False, shared_history_draw=False)
    opts.update(overrides)
    cfg = default_config(model).replace(**opts)
    rng = np.random.default_rng(seed)
    wr, wc = rng.integers(10, 85, S), rng.integers(5, 35, S)
    br, bc = rng.integers(5, 87, S), rng.integers(5, 87, S)  # the pillar's corner
    data = np.zeros((S, 100, 100), np.float32)
    for s in range(S):
        data[s, wr[s]:wr[s] + 5, wc[s]:wc[s] + 60] = 1.0
        data[s, br[s]:br[s] + 8, bc[s]:bc[s] + 8] = 1.0
    rects = [(wc * 0.05, wr * 0.05, (wc + 60) * 0.05, (wr + 5) * 0.05),
             (bc * 0.05, br * 0.05, (bc + 8) * 0.05, (br + 8) * 0.05)]

    def clear(xy):
        ok = np.ones(len(xy), bool)
        for x_lo, y_lo, x_hi, y_hi in rects:
            dx = np.maximum(np.maximum(x_lo - xy[:, 0], xy[:, 0] - x_hi), 0.0)
            dy = np.maximum(np.maximum(y_lo - xy[:, 1], xy[:, 1] - y_hi), 0.0)
            ok &= np.hypot(dx, dy) > clearance
        return ok

    x0, gmm = _poses_and_gmm(S, rng, clear if clearance is not None else None)
    grids = GridMap(torch.from_numpy(data).to(device), torch.zeros((S, 2), device=device),
                    torch.full((S,), 0.05, device=device))
    return (cfg, x0, grids, GaussianMixture.create(*gmm, device=device),
            Domain.create(0.0, 0.0, 5.0, 5.0, device=device))


def mi_beliefs(S: int, h: int, w: int, seed: int = 12) -> np.ndarray:
    """(S, h, w) beliefs that differ per scenario: a known-free region of
    per-scenario extent, the known part of a wall, a band of probabilities in
    (0, 1) on both sides of the occupied threshold, every 97th scenario fully
    unknown and every 101st fully occupied (S = 1: neither)."""
    rng = np.random.default_rng(seed)
    data = np.full((S, h, w), -1.0, np.float32)
    ext = rng.integers(w // 10, w - w // 10, S)
    known = np.arange(w)[None, :] < ext[:, None]  # (S, w)
    data[np.broadcast_to(known[:, None, :], data.shape)] = 0.0
    wall = np.zeros((h, w), bool)
    wall[int(0.45 * h):int(0.5 * h), int(0.2 * w):int(0.8 * w)] = True
    data[wall[None] & known[:, None, :]] = 1.0
    r0 = rng.integers(0, h - 6, S)
    for s in range(S):
        c0 = min(int(ext[s]), w - 8)
        data[s, r0[s]:r0[s] + 6, c0:c0 + 8] = rng.uniform(0.0, 1.0, (6, 8))
    if S > 1:
        data[96::97] = -1.0
        data[100::101] = 1.0
    return data


def mi_case(S: int, device, cells: int = 100, **overrides):
    """The case of ``bench.build_case_mi``: the bench configuration, beliefs
    of which the left 55 % of the columns are known (free, and the known part
    of the wall), the world prepared from them; beside it the true map that a
    sensor reveals. ``cells`` = 100 is the bench's 5 m map; any other size is
    the same picture (poses included) at 0.05 m a cell on a domain of
    ``cells`` * 0.05 m."""
    import torch

    from ergodic_exploration_tpu_torch import bench
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain

    cfg, x0, truth, _, domain = bench_case(S, device)
    cfg = cfg.replace(**overrides)
    c = cells
    if c == 100:
        belief = bench.belief_array()
    else:
        data = np.zeros((c, c), np.float32)
        data[int(0.45 * c):int(0.5 * c), int(0.2 * c):int(0.8 * c)] = 1.0
        data[int(0.7 * c):int(0.78 * c), int(0.6 * c):int(0.68 * c)] = 1.0
        truth = truth._replace(data=torch.from_numpy(data).to(device).expand(S, c, c))
        x0[:, :2] *= c / 100.0
        domain = Domain.create(0.0, 0.0, 0.05 * c, 0.05 * c, device=device)
        belief = np.full((c, c), -1.0, np.float32)
        belief[:, :int(0.55 * c)] = 0.0
        belief[int(0.45 * c):int(0.5 * c), int(0.2 * c):int(0.55 * c)] = 1.0
    grids = truth._replace(data=torch.from_numpy(belief).to(device).expand(S, c, c))
    engine = Engine(cfg, device=device)
    world = engine.prepare_world(grids)
    return engine, engine.init_scenarios(x0), grids, truth, world, domain


def mapping_case(S: int, device, seed: int = 14):
    """The quality run's building (``tools.quality.build_truth``: outer
    walls, two rooms with doorways and a pillar on a 5 m map of 100 x 100
    cells); S start poses at least 0.35 m clear of every occupied cell."""
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.tools.quality import build_truth, truth_data

    data = truth_data()
    occ = (np.argwhere(data > 0.5)[:, ::-1] + 0.5) * 0.05  # (n, 2) cell centres (x, y)

    def clear(xy):
        d = np.hypot(xy[:, None, 0] - occ[None, :, 0], xy[:, None, 1] - occ[None, :, 1])
        return d.min(axis=1) > 0.35

    x0, _ = _poses_and_gmm(S, np.random.default_rng(seed), clear)
    return default_config("cart").replace(use_fused_solve=True), x0, build_truth(S, device)


def node_case():
    """tools/tpu_node_loop.py's case, in numpy: a two-component GMM and a
    100 x 100 int8 map (0.05 m) with a wall; the robot starts at
    (2.5, 0.8, 1.2); the map update of tick i adds a growing block."""
    means = np.array([[1.2, 3.8], [3.8, 3.8]], np.float32)
    covs = np.tile(0.15 * np.eye(2, dtype=np.float32)[None], (2, 1, 1))
    base = np.zeros((100, 100), np.int8)
    base[45:50, 20:80] = 100

    def update(i):
        m = base.copy()
        m[70:74 + (i // NODE_MAP_EVERY) * 2, 55:65] = 100
        return m

    return (means, covs), base, update, [2.5, 0.8, 1.2]


def advance(engine, sc, u):
    """One dt of real motion through the port's rollout."""
    from ergodic_exploration_tpu_torch.ops.integrator import rollout

    x = rollout(engine.model, sc.x, u[:, None, :], engine.config.dt)[:, -1]
    return sc._replace(x=x, vb=engine.model.twist(u))


def build_engine(S: int, device):
    """``bench.build_case`` as (engine, scenarios, world, gmm, domain)."""
    from ergodic_exploration_tpu_torch import bench

    engine, sc, gmm, domain, world = bench.build_case(S, device=device)
    return engine, sc, world, gmm, domain


def digest(*tensors) -> str:
    """The first 16 hex digits of the sha256 of the tensors' bytes: shows
    that two trees hand a path bit-identical inputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


# ---------------------------------------------------------------------------
# timing, comparing, counting
# ---------------------------------------------------------------------------


def events_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, by CUDA events. The
    device first spins for ~20 ms (SPIN_MS of its clock, 1.755 GHz where the
    device properties do not give it), so that the host enqueues the calls
    ahead of it and the events bracket device time even where a call's kernels
    are shorter than its wrapper's Python."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1_755_000)
    torch.cuda._sleep(int(SPIN_MS * khz))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, k, p, tols=TOL) -> float:
    """K1 kernel vs plain outputs (with the safety outputs where the variant
    has them); fails on a breach of ``tols``, returns max |U diff|."""
    import torch

    for field, tol in tols.items():
        a, b = getattr(k, field), getattr(p, field)
        if a.shape != b.shape or not torch.isfinite(a).all():
            fail(f"{name}: {field} shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite")
        err = (a - b).abs()
        bound = tol["atol"] + tol["rtol"] * b.abs()
        bad = (err > bound).nonzero().flatten().tolist()
        print(f"  {name} {field}: max |kernel - plain| {err.max().item():.3e} "
              f"(rtol {tol['rtol']}, atol {tol['atol']}), {len(bad)} outside")
        if bad:
            fail(f"{name}: {field} outside tolerance at flat indices {bad[:10]}")
    if p.code is None:
        if k.code is not None or k.u_dwa is not None or k.feasible is not None:
            fail(f"{name}: safety outputs present with safety off")
    else:
        compare_safety(name, (k.code, k.u_dwa, k.feasible), (p.code, p.u_dwa, p.feasible))
    return (k.U_new - p.U_new).abs().max().item()


def plain_reversed(cfg, inp, enable_safety: bool = True):
    """K1's plain version with its reductions taken in reverse order: the
    refresh's lattice sum, c_k's sum over the knots and the gradient's sums
    over the coefficients. The same tick in exact arithmetic; how far it is
    from the plain version is how far float32 rounding alone moves the
    outputs on these inputs."""
    from ergodic_exploration_tpu_torch.ops import basis
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk

    cc, eg, rp = basis.coefficients_cos, basis.ergodic_gradient, sk.refresh_plain

    def cc_rev(Cx, Cy, w, hk):
        return cc(Cx.flip(-2), Cy.flip(-2), w.flip(-1), hk)

    def eg_rev(tbl, ck, phik, lam, hk, M):
        both = lambda t: t.flip(-1).flip(-2)  # noqa: E731
        return eg(type(tbl)(*(t.flip(-1) for t in tbl)), both(ck), both(phik), both(lam),
                  both(hk), M)

    def rp_rev(r, dlen):
        return rp(r._replace(pts=r.pts.flip(0), D=r.D.flip(0)), dlen)

    basis.coefficients_cos, basis.ergodic_gradient, sk.refresh_plain = cc_rev, eg_rev, rp_rev
    try:
        return sk.fused_solve_safety_plain(cfg, inp, enable_safety=enable_safety)
    finally:
        basis.coefficients_cos, basis.ergodic_gradient, sk.refresh_plain = cc, eg, rp


def u_budget(name: str, u_k, u_p, u_r) -> bool:
    """Phase 21's budget on U: within TOL's 5e-5 of the plain version
    ``u_p``, or, where float32 rounding alone moves U further than that, no
    further from it than the plain version with its sums reversed (``u_r``)
    is: no larger a maximum and no more elements over 5e-5. Prints both;
    returns whether it holds."""
    atol = TOL["U_new"]["atol"]
    d_k, d_r = (u_k - u_p).abs(), (u_r - u_p).abs()
    n_k, n_r = int((d_k > atol).sum()), int((d_r > atol).sum())
    print(f"  {name} U_new: |kernel - plain| max {d_k.max().item():.3e}, {n_k} elements over "
          f"{atol}; |plain with its sums reversed - plain| max {d_r.max().item():.3e}, {n_r} "
          f"over; of {u_k.numel()}")
    return d_k.max().item() <= atol or (d_k.max().item() <= d_r.max().item() and n_k <= n_r)


def compare_wide(name: str, k, p, rev) -> float:
    """``compare`` for phase 21's shapes: every output but U at TOL, U by
    ``u_budget`` against ``rev`` (``plain_reversed``)."""
    err = compare(name, k, p, {f: t for f, t in TOL.items() if f != "U_new"})
    if not u_budget(name, k.U_new, p.U_new, rev.U_new):
        fail(f"{name}: U_new outside phase 21's budget")
    return err


def compare_safety(name: str, k, p) -> float:
    """(code, u_dwa, feasible) of kernel and plain: at most
    CODE_MISMATCH_LIMIT scenarios may differ. Returns max |u_dwa diff| over
    the agreeing scenarios."""
    (kc, ku, kf), (pc, pu, pf) = k, p
    mism = (kc != pc) | (kf != pf) | (ku != pu).any(1)
    idx = mism.nonzero().flatten().tolist()
    for i in idx[:20]:
        print(f"  {name} mismatch at scenario {i}: code {kc[i].item()} vs {pc[i].item()}, "
              f"feasible {kf[i].item()} vs {pf[i].item()}, u_dwa {ku[i].tolist()} vs "
              f"{pu[i].tolist()}")
    print(f"  {name} code/feasible/u_dwa: {len(idx)} of {kc.shape[0]} scenarios differ "
          f"(limit {CODE_MISMATCH_LIMIT}); DWA active in {(pc >= 2).sum().item()}")
    if len(idx) > CODE_MISMATCH_LIMIT:
        fail(f"{name}: {len(idx)} scenarios differ in code / feasible / u_dwa")
    return (ku - pu).abs()[~mism].max().item() if (~mism).any() else 0.0


def reset_counts() -> None:
    from ergodic_exploration_tpu_torch.ops import gmm_kernel as gk
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
    from ergodic_exploration_tpu_torch.ops import mi_kernel as mk
    from ergodic_exploration_tpu_torch.ops import tick_glue as tg

    from ergodic_exploration_tpu_torch.ops import edt_kernel as ek
    from ergodic_exploration_tpu_torch.ops import mi_dense_kernel as md
    from ergodic_exploration_tpu_torch.ops import reveal_kernel as rk

    md.M.reset_launches()
    sk.K1.reset_launches()
    gk.K2.reset_launches()
    mk.K3.reset_launches()
    tg.G.reset_launches()
    rk.R.reset_launches()
    ek.E.reset_launches()


def read_counts() -> dict:
    from ergodic_exploration_tpu_torch.ops import gmm_kernel as gk
    from ergodic_exploration_tpu_torch.ops import mi_kernel as mk
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk

    return {**sk.K1.launches, **gk.K2.launches, **mk.K3.launches}


def read_glue() -> dict:
    """The glue's launches (G), read apart from K1, K2 and K3's: the paths
    that check them (4, 7, 16, 20, 22, 23) name them, the others check the
    solve and target kernels alone."""
    from ergodic_exploration_tpu_torch.ops import tick_glue as tg

    return dict(tg.G.launches)


def read_map() -> dict:
    """The map kernels' launches (the reveal R and the world rebuild E), read
    apart from K1, K2, K3 and the glue's: the paths that launch them (4, 7,
    14, 18, 20, 24) name them."""
    from ergodic_exploration_tpu_torch.ops import edt_kernel as ek
    from ergodic_exploration_tpu_torch.ops import reveal_kernel as rk

    return {**rk.R.launches, **ek.E.launches}


def read_dense() -> dict:
    """M's launches (the dense MI target), read apart from the other
    kernels': the paths that launch it (13, 14, 18, 20, 22, 25) name them."""
    from ergodic_exploration_tpu_torch.ops import mi_dense_kernel as md

    return dict(md.M.launches)


def dense_want(n: int, fc: bool = True) -> dict:
    """M's launches of ``n`` dense MI targets, with the frontier mask or
    without (one launch a target at any S)."""
    return {"phik_dense_fc" if fc else "phik_dense_nofc": n}


def map_want(reveals: int, worlds: int, edts: int = 0, coverages: int = None) -> dict:
    """R's and E's launches of a run: ``reveals`` ray-cast reveals,
    ``worlds`` world rebuilds (E with the free mask: ``Engine._world_batched``),
    ``edts`` distance fields alone (``DistanceField.from_grid``) and
    ``coverages`` coverages (``sensor.fraction_known``; one a reveal unless
    given), each one launch at any S."""
    return {"reveal_raycast": reveals, "world": worlds, "edt": edts,
            "coverage": reveals if coverages is None else coverages}


def glue_want(cfg, ticks: int, advance: bool = False, in_place: bool = False) -> dict:
    """G's launches over ``ticks`` ticks of ``cfg``: one glue_pre of the
    configuration's history mode and one glue_post a tick, its variant by
    ``advance`` (the closed loops) and ``in_place`` (a graph's tick, whose
    ring is its own static buffer)."""
    from ergodic_exploration_tpu_torch.ops import tick_glue as tg

    pre = tg.TickGlue.PRE_VARIANTS[tg.history_mode(cfg, fused=cfg.use_fused_solve)]
    return {pre: ticks, tg.TickGlue.POST_VARIANTS[advance, in_place]: ticks}


def step_want(cfg, ticks: int) -> dict:
    """K1's launches over ``ticks`` ticks of the eager controller step
    (``ErgodicController.step``, the default configuration's tick): one K1
    without its safety stage a tick, on per-scenario maps unless
    ``shared_maps``, summing the drawn history unless the full ring or the
    accumulate mode feed it sums; one ``fused_safety_map`` a tick with safety
    on."""
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
    from ergodic_exploration_tpu_torch.ops.tick_glue import history_mode

    k1 = sk.k1_variant(False, not cfg.shared_maps, history_mode(cfg, fused=False) == "nb")
    return {k1: ticks, **({"fused_safety_map": ticks} if cfg.enable_safety else {})}


def glue_sum(*wants: dict) -> dict:
    """The launches of several runs together (``glue_want``'s dicts added)."""
    out = {}
    for w in wants:
        for k, n in w.items():
            out[k] = out.get(k, 0) + n
    return out


# variant -> (its launches, the path): the first counted run of a path that
# launched it, for the kernels line (phases 4 and 7 the main paths; the
# copying glue_post variants from phase 20's plain loop of path B and phase
# 22's eager function of path A, since every tick of phases 4 and 7 is a
# graph's, which appends in place)
LAUNCHES = {}
# phase 16's node: (cfg, x, vb, U, world) of its eager tick, for phase 27
NODE_INPUTS = []


def note_launches(path: str, got: dict) -> None:
    for name, n in got.items():
        if n and name not in LAUNCHES:
            LAUNCHES[name] = (n, path)


def expect_counts(path: str, got: dict, want: dict) -> None:
    """Fail unless ``got`` has exactly the launches of ``want`` (variants not
    named there must be 0)."""
    for name, n in got.items():
        if n != want.get(name, 0):
            fail(f"{path}: {name} launched {n} times, expected {want.get(name, 0)}; all: {got}")
    print(f"{path}: launches {({k: v for k, v in got.items() if v})}")


# ---------------------------------------------------------------------------
# the least time the card could take (bytes moved once vs operations)
# ---------------------------------------------------------------------------


def bound(flops: float, nbytes: float):
    """(ms, what bounds it): the larger of operations over the float32 peak
    and bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def refresh_work(S, N, KK, J, masked=False, n_degenerate=0):
    """(flops, bytes) of the mixture-times-table reduction: per (scenario,
    point) 2 K^2 for the contraction, 16 per component for the density (one
    of them the exp), 1 for the mask; a degenerate scenario needs the
    fallback's contraction too. Bytes: the mixtures, lattice, table, mask
    and result once."""
    flops = S * N * (2 * KK + 16 * J + int(masked)) + n_degenerate * 2 * N * KK
    nbytes = 4 * (S * J * 7 + N * 2 + N * KK + (S * N if masked else 0) + S * KK)
    return flops, nbytes


def mi_work(S, h, w, K, r, fc):
    """(flops, bytes) of K3: per cell two logs and ~8 operations for the
    entropy and the masks, two clamped sums of 2r+1 terms (and two integer
    ones of 2fc+1 with the frontier mask), K multiply-adds of the x
    contraction; per scenario h K^2 multiply-adds of the y contraction and
    the normalization. Bytes: the beliefs, the tables and the result once."""
    cells = h * w
    per = cells * (10 + 2 * (2 * r + 1) + (2 * (2 * fc + 1) if fc else 0) + 2 * K)
    per += 2 * h * K * K + 2 * K * K
    return S * per, 4 * (S * cells + w * K + K * h + K * K + 1 + S * K * K)


def dense_work(S, h, w, nsx, nsy, KK, r, fc, nnz, cells=None):
    """(flops, bytes) of M: per cell ~10 operations for the entropy (two logs)
    and the masks; per lattice point 2 (2r+1) for the box sums, 2 (2fc+1)
    for the frontier test with the mask, 2 for the masks; the separable
    contraction (D = Cx Cy / h_k): 2 K per (scenario, lattice point) whose
    value is not 0 (``nnz`` of them: what this run's beliefs need) for the
    rows' projections, 2 K^2 per (scenario, lattice row) for their
    accumulation; the normalization. Bytes: the beliefs, the lattice cells,
    the two cosine tables, h_k, the fallback and the result once. ``cells``:
    the cells of a map that the target reads (``box_cells``: the lattice
    points' boxes), all h w when None."""
    N, K = nsx * nsy, math.isqrt(KK)
    cells = h * w if cells is None else cells
    flops = (S * cells * 10 + S * N * (2 * (2 * r + 1) + (2 * (2 * fc + 1) if fc else 0) + 2)
             + 2 * nnz * K + 2 * S * nsy * KK + 3 * S * KK)
    return flops, 4 * (S * cells + nsx + nsy + (nsx + nsy) * K + 2 * KK + S * KK)


def box_cells(ops, h: int, w: int, m: int) -> int:
    """Cells of an (h, w) map within m rows and m columns of a lattice point's
    cell (``ops.cy``, ``ops.cx``): what M's function reads of each map at
    m = max(r, fc)."""
    import torch

    def span(idx, n):
        off = torch.arange(-m, m + 1)
        return int(torch.unique((idx.cpu().long()[:, None] + off).clamp(0, n - 1)).numel())

    return span(ops.cy, h) * span(ops.cx, w)


def dense_check(name: str, data, ops, r: int, fc: int, thr: float, card: str, reps: int = 20,
                plain_reps: int = 5, placements: bool = False) -> dict:
    """M on the beliefs ``data`` (S, h, w) against its plain version on the
    card: within DENSE_TOL, the fallback taken by the same scenarios and
    equal to it bit for bit there, two launches bit for bit; then M's ms,
    the plain version's and the cuBLAS product (S, N) @ (N, K^2) alone on
    the plain version's lattice values (the library yardstick), by CUDA
    events, and the temporaries' peak of each above the inputs. With
    ``placements`` M runs again in each placement past its plan's (the
    rings, then the y sums and frontier words in the workspace, the Cx table
    a pass's rows at a time, the lattice and offset tables in the workspace:
    ``mi_dense_kernel.SPILLS``, forced
    by a ``smem_limit`` of that placement's bytes), each equal to the
    plan's bit for bit. Fails on a breach; returns the numbers."""
    import torch

    from ergodic_exploration_tpu_torch.ops import mi_dense_kernel as md

    args = (ops, r, fc, thr)
    data = data.contiguous()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = md.M(data, *args)
    torch.cuda.synchronize()
    peak_m = torch.cuda.max_memory_allocated() - base
    again = md.M(data, *args)
    torch.cuda.reset_peak_memory_stats()
    ref = md.phik_dense_plain(data, *args)
    torch.cuda.synchronize()
    peak_p = torch.cuda.max_memory_allocated() - base
    vals = md.dense_values_plain(data, ops, r, fc, thr)
    err = (got - ref).abs()
    bad = int((err > DENSE_TOL["atol"] + DENSE_TOL["rtol"] * ref.abs()).sum())
    rel = (err / ref.abs().clamp(min=DENSE_TOL["atol"])).max().item()
    fb_ref = (ref == ops.fallback).all(dim=(1, 2))
    fb_got = (got == ops.fallback).all(dim=(1, 2))
    S_, h_, w_ = data.shape
    K = ops.fallback.shape[-1]
    nnz = int((vals != 0).sum())
    print(f"  M {name} (S={S_}, {h_} x {w_}, lattice {ops.cx.shape[0]} x {ops.cy.shape[0]}, K={K}, "
          f"r={r}, fc={fc}): max |M - plain| {err.max().item():.3e}, max relative (|plain| >= "
          f"{DENSE_TOL['atol']}) {rel:.3e} (rtol {DENSE_TOL['rtol']}, atol {DENSE_TOL['atol']}), "
          f"{bad} outside; {int(fb_ref.sum())} scenarios took the fallback, bit for bit "
          f"{bool(torch.equal(fb_ref, fb_got))}; lattice values not 0: {nnz / vals.numel():.4f}")
    if (got.shape != (S_, K, K) or not torch.isfinite(got).all() or bad
            or not torch.equal(fb_ref, fb_got) or not torch.equal(got, again)):
        fail(f"M {name}: outside tolerance, another fallback, non-finite, mis-shaped or two "
             f"launches that differ")
    if placements:
        nsx, nsy = ops.cx.shape[0], ops.cy.shape[0]
        G, spill, _ = md.plan(h_, w_, nsx, nsy, K, r, fc)
        limit, forced = md.M.smem_limit, []
        try:
            for level in range(spill + 1, len(md.SPILLS)):
                md.M.smem_limit = md.smem_bytes(h_, w_, nsx, nsy, K, r, fc, G, level)
                if md.M.smem_limit == md.smem_bytes(h_, w_, nsx, nsy, K, r, fc, G, level - 1):
                    continue  # this placement moves nothing of these tables
                before = dict(md.M.launches)
                if not torch.equal(md.M(data, *args), got):
                    fail(f"M {name}: placement {md.SPILLS[level]!r} differs from "
                         f"{md.SPILLS[spill]!r}")
                forced += [v for v, n in md.M.launches.items() if n != before[v]]
        finally:
            md.M.smem_limit = limit
        print(f"  M {name} in the placements past its plan's ({forced}): equal bit for bit")
    out = dict(err=err.max().item(), rel=rel, nnz=nnz, peak_m=peak_m, peak_p=peak_p,
               fallbacks=int(fb_ref.sum()),
               ms=events_ms(lambda: md.M(data, *args), reps),
               plain_ms=events_ms(lambda: md.phik_dense_plain(data, *args), plain_reps),
               lib_ms=events_ms(lambda: torch.matmul(vals, ops.D), reps))
    print(f"  M {name}: {out['ms']:.4f} ms, plain version {out['plain_ms']:.4f} ms, the cuBLAS "
          f"contraction alone {out['lib_ms']:.4f} ms; temporaries' peak {peak_m / 2**20:.2f} MiB "
          f"(M) vs {peak_p / 2**20:.1f} MiB (plain) {card}", flush=True)
    nsx, nsy = ops.cx.shape[0], ops.cy.shape[0]
    if md.tiles(K) > 1:  # the other way to contract the values once: two float32 matmuls
        v3 = vals.view(S_, nsx, nsy)
        out["pair_ms"] = events_ms(lambda: torch.matmul(
            torch.matmul(v3.transpose(1, 2), ops.cosx).transpose(1, 2), ops.cosy), reps)
        print(f"  M {name}: the values once then a contraction a tile ({md.tiles(K)} tiles); the "
              f"separable pair of float32 matmuls on the plain version's values alone "
              f"{out['pair_ms']:.4f} ms {card}")
    if md.table_width(w_, nsx, r, fc) < w_:  # the tables at the columns the lattice reads
        md.M.compact = False
        try:
            every = md.M(data, *args)
            out["every_ms"] = events_ms(lambda: md.M(data, *args), reps)
        finally:
            md.M.compact = True
        print(f"  M {name}: the tables at the {md.table_width(w_, nsx, r, fc)} columns the "
              f"lattice reads, of {w_}; with every map column {out['every_ms']:.4f} ms, equal bit "
              f"for bit: {bool(torch.equal(every, got))} {card}", flush=True)
    return out


def solve_work(cfg, S, P, safety: bool, dwa_probes: float = 0.0, map_cells: int = 0,
               nb: int = 0):
    """(flops, bytes) of K1's solve for S scenarios, counted from the loops
    of csrc/solve_kernel.cu (a sin, cos, sqrt or pow counts as one
    operation). ``dwa_probes``: crash probes the DWA sweep needs on this
    run's data, summed over scenarios (a candidate stops at its first
    crash). ``map_cells``: map cells read once (P^2 per scenario on
    per-scenario maps, the whole map when it is shared). ``nb``: drawn
    history positions summed in the kernel (0: the sums are an input)."""
    H, K, nu = cfg.horizon, cfg.num_basis, cfg.nu
    per = H * 51  # rollout: 6 sin/cos + ~45
    per += H * (6 * K + 2 * K * K) + 16 * K * K  # c_k tables and sums; metric and Wh
    per += H * (4 * K * K + 14 * K + 125)  # gradient contraction; walls; bilinear d and grad
    per += H * (49 + 17 * nu)  # co-state step and the saturated update
    per += 6 * K + 7 * K * K  # ck_sum append
    per += nb * (7 * K + 2 * K * K) + (K * K if nb else 0)  # history tables and sums
    flops = S * per
    hist = 2 * nb if nb else K * K
    nbytes = 4 * (S * (3 + H * nu + hist + K * K + 1 + K * K + 2 + 2 + 1 + 2 + 2 + 3) + map_cells
                  + S * (H * nu + 2 + K * K))
    if safety:
        C = int(np.prod(cfg.dwa.samples))
        flops += S * (cfg.val_horizon * 38 + C * 13 * nu) + dwa_probes * 38
        nbytes += 4 * S * (2 + nu)
    return flops, nbytes


def safety_work(cfg, S, Pc, dwa_probes: float):
    """(flops, bytes) of the standalone safety stage."""
    C = int(np.prod(cfg.dwa.samples))
    flops = S * (cfg.val_horizon * 38 + C * 13 * cfg.nu) + dwa_probes * 38
    nbytes = 4 * S * (3 + 3 + cfg.nu + Pc * Pc + 2 + 2 + 1 + 2 + 2 + 2 + cfg.nu)
    return flops, nbytes


def safety_map_check(name: str, cfg, x, vb, U, world):
    """The eager step's safety stage, ``fused_safety_map`` (k1_safety reading
    the central crop of each patch from the map), on a path's inputs: poses
    x, twists vb, controls U (S, H, nu) whose step 0 is u0, the world's maps
    (shared as the step reads them under ``shared_maps``), the patch starts
    of the poses. Bit for bit equal to k1_safety on the crop that
    ``gather_window`` cuts from the same map (the step's route before it),
    held to its plain version as ``compare_safety`` holds k1_safety, one
    launch of each counted. Returns (max |u_dwa - plain|, its operands, the
    earlier route: the crop start, the gather and k1_safety)."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch.ops.patch import gather_window, patch_start

    dist = (world.dist.dist[0] if cfg.shared_maps else world.dist.dist).contiguous()
    P, Pc = sk.crop_geometry(cfg, dist)
    pstart = patch_start(world.dist, x[:, :2], P).to(torch.int32)
    geo = (world.dist.origin.contiguous(), world.dist.resolution.contiguous(),
           world.domain.origin.contiguous(), world.domain.lengths.contiguous())
    args = (x.contiguous(), vb.contiguous(), U.contiguous(), dist, pstart, *geo)

    def earlier():
        cstart = pstart + (P - Pc) // 2
        return sk.K1.safety(cfg, args[0], args[1], U[:, 0].contiguous(),
                            gather_window(dist, cstart, Pc), cstart, *geo)

    reset_counts()
    km, kb = sk.K1.safety_map(cfg, *args), earlier()
    torch.cuda.synchronize()
    expect_counts(f"{name}, the safety stage", read_counts(),
                  {"fused_safety_map": 1, "fused_safety": 1})
    if not all(torch.equal(a, b) for a, b in zip(km, kb)):
        fail(f"{name}: fused_safety_map differs from k1_safety on the gathered crop")
    e = compare_safety(f"{name} fused_safety_map", km, sk.fused_safety_map_plain(cfg, *args))
    print(f"  {name} fused_safety_map (S={x.shape[0]}): code, u_dwa and feasible equal to "
          f"k1_safety on the gathered crop bit for bit")
    return e, args, earlier


def step_k1_check(name: str, cfg, sc, phik, world, reps: int):
    """K1 as the eager step launches it (``fused_solve`` on the step's own
    inputs: per-scenario draws) against its plain version on (sc, phik,
    world): (max error, ms, plain ms, work)."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk

    inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, phik, world, fused=False)
    k = sk.K1(cfg, inp, enable_safety=False)
    p = sk.fused_solve_safety_plain(cfg, inp, enable_safety=False)
    torch.cuda.synchronize()
    e = compare(name, k, p)
    S_, P_ = inp.x.shape[0], min(cfg.patch_cells, *inp.dist.shape[-2:])
    nb = inp.hist.shape[1] if inp.hist.dim() == 3 else 0
    return (e, events_ms(lambda: sk.K1(cfg, inp, enable_safety=False), reps),
            events_ms(lambda: sk.fused_solve_safety_plain(cfg, inp, enable_safety=False), 3),
            solve_work(cfg, S_, P_, False, map_cells=P_ * P_ * (S_ if inp.dist.dim() == 3 else 1),
                       nb=nb))


def dwa_probes_needed(cfg, model, x, vb, domain, crop) -> float:
    """Crash probes the DWA sweep needs on these inputs: every candidate is
    probed step by step until its first crash (or to the horizon)."""
    import torch

    from ergodic_exploration_tpu_torch.ops.collision import CRASH, check_pose
    from ergodic_exploration_tpu_torch.ops.dwa import candidate_twists
    from ergodic_exploration_tpu_torch.ops.integrator import constant_twist_poses

    dwa = cfg.dwa
    tws = model.twist(model.from_twist(candidate_twists(vb, dwa)))
    ts = dwa.dt * torch.arange(1, dwa.horizon + 1, dtype=torch.float32, device=x.device)
    X = constant_twist_poses(x[:, None, :], tws, ts)  # (S, C, T, 3)
    S, C, T, _ = X.shape
    crash = check_pose(X[..., :2].reshape(S, C * T, 2), domain, crop, cfg.boundary_radius,
                       cfg.d_safe).reshape(S, C, T) >= CRASH
    first = torch.where(crash.any(-1), crash.to(torch.int32).argmax(-1) + 1,
                        torch.full((S, C), T, device=x.device))
    return float(first.sum().item())


def node_phase(dev, card, entry, kernels) -> None:
    """Phase 16: the single-robot node at default_config("cart") on ``dev``;
    adds the entries of the two kernels of its path through ``entry``."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch import native
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.node import ExplorationNode
    from ergodic_exploration_tpu_torch.ops import sensor
    from ergodic_exploration_tpu_torch.ops.integrator import constant_twist_poses, rollout
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    print(f"== 16. the single-robot node: ExplorationNode at default_config('cart'), "
          f"{NODE_TICKS} ticks, a map update every {NODE_MAP_EVERY}", flush=True)
    if not native.available():
        fail("the native runtime is not available (no g++) on this machine")
    gmm_np, base_map, map_update, start = node_case()

    def make_node(d, fused, pipeline=False, **kw):
        c = default_config("cart").replace(use_fused_solve=fused)
        return ExplorationNode(c, target=GaussianMixture.create(*gmm_np), use_native=True,
                               pipeline=pipeline, device=d, **kw)

    def node_pair(fused, pipeline, **kw):
        """Two nodes on the card from one configuration: the first's step()
        replays its graph, the second takes the eager tick by name."""
        pair = [make_node(None, fused, pipeline, **kw) for _ in range(2)]
        if any(n.device.type != dev.type or not n.use_native for n in pair):
            fail("the node is not on the card or not on the native runtime")
        return pair, (pair[0].step, lambda: pair[1]._step(pair[1]._eager_tick))

    def same_step(what, i, got, ref):
        """A tick of the graph node against the eager node's: bit for bit."""
        (tw_g, d_g), (tw_e, d_e) = got, ref
        if (d_g is None) != (d_e is None) or not np.array_equal(tw_g, tw_e) or d_g != d_e:
            fail(f"{what}: tick {i} of the node's graph {tw_g} {d_g} differs from its eager "
                 f"tick {tw_e} {d_e}")

    def node_loop(fused, pipeline):
        """NODE_TICKS ticks after one warm-up tick (which captures the
        graph): step(), then a plant that applies the twist through the
        port's rollout; a map update every NODE_MAP_EVERY ticks, paid by the
        next step(). The graph node and the eager node run in lockstep, each
        with its own plant, and must agree bit for bit on every tick; then
        20 steps of each are profiled."""
        what = f"node (fused={fused}, pipeline={pipeline})"
        (node, node_e), steps = node_pair(fused, pipeline)
        poses = []
        for n in (node, node_e):
            n.on_map(base_map, resolution=0.05)
            n.on_odom(start)
            poses.append(torch.tensor(start, dtype=torch.float32, device=dev))

        def plant(k, n, tw):
            u = n.model.from_twist(torch.as_tensor(tw, device=dev))
            poses[k] = rollout(n.model, poses[k], u[None], n.config.dt)[-1]
            n.on_odom(poses[k], tw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        first_ms = []
        for k, step in enumerate(steps):  # the first tick: world, target, the graph's capture
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            first_ms.append(1e3 * (time.perf_counter() - t0))
        counts = read_counts()
        want = ({"fused_solve_safety_map_h0_nb": 1} if fused else step_want(node.config, 1))
        expect_counts(f"phase 16, {what}, the first tick of each (the graph's captured)",
                      counts, {k: 2 * n for k, n in want.items()})
        expect_counts(f"phase 16, {what}, the first tick of each, the glue", read_glue(),
                      glue_sum(glue_want(node.config, 1, in_place=True),
                               glue_want(node.config, 1)))
        reset_counts()
        lat, map_lat, dwa, n_diag = ([], []), ([], []), 0, 0
        for i in range(NODE_TICKS):
            update = i > 0 and i % NODE_MAP_EVERY == 0
            outs = []
            for k, (n, step) in enumerate(zip((node, node_e), steps)):
                if update:
                    n.on_map(map_update(i), resolution=0.05)
                t0 = time.perf_counter()
                outs.append(step())
                ms = 1e3 * (time.perf_counter() - t0)
                (map_lat if update else lat)[k].append(ms)
            same_step(what, i, *outs)
            tw, diag = outs[0]
            if diag is not None:
                n_diag += 1
                dwa += int(diag.dwa_active)
                if diag.diverged or not np.isfinite(tw).all():
                    fail(f"{what}: tick {i} diverged")
            for k, n in enumerate((node, node_e)):
                plant(k, n, outs[k][0])
        if pipeline:
            tails = [node.flush(), node_e.flush()]
            if tails[0] is None:
                fail("the pipelined node had no tail to flush")
            same_step(what, NODE_TICKS, *tails)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        counts = {k: v // 2 for k, v in read_counts().items()}  # each node's
        expect_counts(f"phase 16, {what}, {NODE_TICKS} ticks of each node",
                      read_counts(), {k: 2 * NODE_TICKS * n for k, n in want.items()})
        expect_counts(f"phase 16, {what}, {NODE_TICKS} ticks of each node, the glue",
                      read_glue(), glue_sum(glue_want(node.config, NODE_TICKS, in_place=True),
                                            glue_want(node.config, NODE_TICKS)))
        final = poses[0].tolist()
        res = []
        for k, route in enumerate(("graph", "eager")):
            every = np.asarray(lat[k] + map_lat[k])
            p = {q: float(np.percentile(every, q)) for q in (50, 90, 99)}
            res.append(p)
            print(f"  fused={fused} pipeline={pipeline}, {route}: step() p50 {p[50]:.4f} ms, p90 "
                  f"{p[90]:.4f}, p99 {p[99]:.4f}, max {every.max():.4f} over {len(every)} ticks "
                  f"(budget {BUDGET_MS} ms); steady ticks p50 {np.percentile(lat[k], 50):.4f}, "
                  f"p99 {np.percentile(lat[k], 99):.4f}; the {len(map_lat[k])} map-update ticks "
                  f"{[round(v, 4) for v in map_lat[k]]} ms; the first tick {first_ms[k]:.1f} ms; "
                  f"achievable {1e3 / p[50]:.1f} Hz {card}")
            if p[99] >= BUDGET_MS:
                fail(f"{what}, {route}: p99 {p[99]:.2f} ms reaches the {BUDGET_MS} ms budget")
        prof = []
        for step, n in zip(steps, (20, PROFILE_LOOP_TICKS)):
            calls, busy, wall = runtime_profile(lambda step=step: [step() for _ in range(n)])
            prof.append((sum(calls.values()) / n, busy / n, wall / n))
        print(f"  fused={fused} pipeline={pipeline}: graph vs eager, host CUDA runtime calls a "
              f"tick {prof[0][0]:.2f} vs {prof[1][0]:.2f}, device busy {prof[0][1]:.4f} vs "
              f"{prof[1][1]:.4f} ms a tick (profiled run {prof[0][2]:.4f} vs {prof[1][2]:.4f} ms "
              f"a tick); capture {node._graph.capture_s:.3f} s; peak device memory of both "
              f"nodes above what was held before {(peak - base) / 2**20:.1f} MiB; {NODE_TICKS} "
              f"ticks equal bit for "
              f"bit; DWA rate {dwa / max(n_diag, 1):.4f}; final pose "
              f"{[round(v, 3) for v in final]} {card}", flush=True)
        if not np.isfinite(final).all():
            fail("node: non-finite final pose")
        return node, counts

    node_e, counts_e = node_loop(False, False)
    node_f, counts_f = node_loop(True, False)
    node_loop(True, True)

    # the MI target on a belief a disc sensor opens every NODE_REVEAL_EVERY
    # ticks (examples/single_robot.py's world and start), fused; a graph node
    # and an eager node fed the same map updates and odometry, in lockstep
    truth_np = np.zeros((100, 100), np.float32)
    truth_np[48:52, 10:60] = 1.0
    truth_np[48:52, 75:95] = 1.0
    truth_np[20:28, 70:78] = 1.0
    truth = GridMap.create(truth_np, 0.0, 0.0, 0.05, device=dev)
    belief = truth._replace(data=torch.full_like(truth.data, -1.0))
    pair = [ExplorationNode(default_config("cart").replace(use_fused_solve=True,
                                                           ergodic_weight=50.0), target="mi",
                            device=dev) for _ in range(2)]
    mi_steps = (pair[0].step, lambda: pair[1]._step(pair[1]._eager_tick))
    pose = torch.tensor([1.0, 1.0, 0.3], device=dev)
    for n in pair:
        n.on_odom(pose)
    step_t = torch.tensor([pair[0].config.dt], device=dev)
    reset_counts()
    lat, map_lat, poses = ([], []), ([], []), []
    for t in range(NODE_MI_TICKS):
        update = t % NODE_REVEAL_EVERY == 0
        if update:
            belief = sensor.reveal(belief, truth, pose, 1.2)
        outs = []
        for k, (n, step) in enumerate(zip(pair, mi_steps)):
            if update:
                n.on_map(belief.data, 0.0, 0.0, 0.05)
            t0 = time.perf_counter()
            outs.append(step())
            (map_lat if update else lat)[k].append(1e3 * (time.perf_counter() - t0))
        same_step("the MI node", t, *outs)
        tw = outs[0][0]
        pose = constant_twist_poses(pose, torch.as_tensor(tw, device=dev), step_t)[0]
        for n in pair:
            n.on_odom(pose, tw)
        poses.append(pose)
    poses = torch.stack(poses).cpu()
    expect_counts("phase 16, MI node (graph and eager)", read_counts(),
                  {"fused_solve_safety_map_h0_nb": 2 * NODE_MI_TICKS})
    expect_counts("phase 16, MI node (graph and eager), the glue", read_glue(),
                  glue_sum(glue_want(pair[0].config, NODE_MI_TICKS, in_place=True),
                           glue_want(pair[0].config, NODE_MI_TICKS)))
    inside = bool(((poses[:, :2] >= 0.0) & (poses[:, :2] <= 5.0)).all())
    if not torch.isfinite(poses).all() or not inside:
        fail("the MI node's poses are non-finite or left the domain")
    for k, route in enumerate(("graph", "eager")):
        print(f"  MI node, {route}, {NODE_MI_TICKS} ticks: steady step() p50 "
              f"{np.percentile(lat[k], 50):.4f} ms, p99 {np.percentile(lat[k], 99):.4f}; reveal "
              f"ticks (first excluded) p50 {np.percentile(map_lat[k][1:], 50):.4f} ms, max "
              f"{max(map_lat[k][1:]):.4f} {card}")
    print(f"  MI node: graph and eager equal bit for bit on every tick; moved "
          f"{(poses[-1, :2] - poses[0, :2]).norm().item():.3f} m; belief known "
          f"{(belief.data >= 0).float().mean().item():.4f}; the graph captured once "
          f"({pair[0]._graph.capture_s:.3f} s) {card}")

    # the node on the card against the node on the CPU, one fixed odometry
    # stream that ends inside the footprint of the wall (barrier, validation, DWA)
    stream = [[2.5 + 0.01 * i, 1.65 + 0.05 * i, 1.3] for i in range(NODE_CMP_TICKS)]

    def node_stream(d, fused, pipeline=False, with_map=True):
        node = make_node(d, fused, pipeline,
                         domain=None if with_map else Domain.create(0.0, 0.0, 5.0, 5.0))
        if with_map:
            node.on_map(base_map, resolution=0.05)
        out = []
        for p in stream:
            node.on_odom(p)
            out.append(node.step())
        if pipeline:
            out = out[1:] + [node.flush()]
        return (np.stack([o[0] for o in out]),
                np.array([[int(o[1].collision_code), int(o[1].dwa_active),
                           int(o[1].dwa_feasible)] for o in out]))

    cpu = torch.device("cpu")
    for fused, with_map in ((False, True), (True, True), (True, False)):
        (tw_d, f_d), (tw_c, f_c) = (node_stream(dev, fused, with_map=with_map),
                                    node_stream(cpu, fused, with_map=with_map))
        du = np.abs(tw_d - tw_c).max()
        world = "map" if with_map else "no map (2 x 2 world)"
        print(f"  fused={fused}, {world}: max |twist_card - twist_cpu| {du:.3e} (atol 5e-5) "
              f"over {NODE_CMP_TICKS} ticks; codes "
              f"{f_d[:, 0].tolist()} (card) {f_c[:, 0].tolist()} (CPU); DWA "
              f"{f_d[:, 1].tolist()}")
        if du > 5e-5 or not np.array_equal(f_d, f_c):
            fail("the node on the card disagrees with the node on the CPU")
        if fused and with_map:
            tw_p, f_p = node_stream(dev, True, pipeline=True)
            if np.abs(tw_p - tw_d).max() > 1e-6 or not np.array_equal(f_p, f_d):
                fail("pipelined twists are not the unpipelined ones shifted by one tick")
            print("  pipelined on the card: the unpipelined twists shifted by one tick")

    # each kernel of the node's path against its plain version on the node's inputs
    cfg_n = node_f.config
    x1, vb1 = node_f._pose[None], node_f._twist[None]
    inp, _ = sk.fused_tick_inputs(cfg_n, node_f.state, x1, vb1, node_f._phik, node_f._world)
    k, p = sk.K1(cfg_n, inp), sk.fused_solve_safety_plain(cfg_n, inp)
    torch.cuda.synchronize()
    e = compare("node fused_solve_safety_map_h0_nb (S=1)", k, p)
    w_n = node_f._world
    P_n = min(cfg_n.patch_cells, *w_n.dist.dist.shape[-2:])
    crop = extract_patch(w_n.dist, x1[:, :2], P_n).center_crop(cfg_n.safety_patch_cells)
    probes = dwa_probes_needed(cfg_n, node_f.model, x1, vb1, w_n.domain, crop)
    entry("node_fused_solve_safety_map_h0_nb", "solve_kernel.cu",
          "ergodic_exploration_tpu/ops/solve_kernel.py:345", e,
          events_ms(lambda: sk.K1(cfg_n, inp), 200),
          events_ms(lambda: sk.fused_solve_safety_plain(cfg_n, inp), 5),
          solve_work(cfg_n, 1, P_n, True, probes, map_cells=P_n * P_n,
                     nb=cfg_n.buffer_batch))
    kernels["node_fused_solve_safety_map_h0_nb"]["launches"] = \
        counts_f["fused_solve_safety_map_h0_nb"]
    cfg_e, w_e = node_e.config, node_e._world
    x1, vb1 = node_e._pose[None], node_e._twist[None]
    crop = extract_patch(w_e.dist, x1[:, :2], P_n).center_crop(cfg_e.safety_patch_cells)
    NODE_INPUTS[:] = [cfg_e, x1.clone(), vb1.clone(), node_e.state.U.clone(), w_e]
    e, args, _ = safety_map_check("node (S=1)", *NODE_INPUTS)
    probes = dwa_probes_needed(cfg_e, node_e.model, x1, vb1, w_e.domain, crop)
    entry("node_fused_safety_map", "solve_kernel.cu",
          "ergodic_exploration_tpu/ops/solve_kernel.py:1254", e,
          events_ms(lambda: sk.K1.safety_map(cfg_e, *args), 200),
          events_ms(lambda: sk.fused_safety_map_plain(cfg_e, *args), 20),
          safety_work(cfg_e, 1, crop.dist.shape[-1], probes))
    kernels["node_fused_safety_map"]["launches"] = counts_e["fused_safety_map"]


# ---------------------------------------------------------------------------
# phase 17: the scale-out path, on ranks spawned with torch.multiprocessing
# ---------------------------------------------------------------------------


def _drive(engine, sc, world, gmm, domain, n):
    """n bench ticks (``replan_refresh`` + pose advance) timed by CUDA events;
    returns (final state, per-tick (u, metric, code, DWA active, DWA
    feasible, U), ms per tick)."""
    import torch

    outs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        sc, u, dg = engine.replan_refresh(sc, gmm, domain, world)
        outs.append((u, dg.ergodic_metric, dg.collision_code, dg.dwa_active, dg.dwa_feasible,
                     sc.state.U))
        sc = advance(engine, sc, u)
    end.record()
    torch.cuda.synchronize()
    return sc, outs, start.elapsed_time(end) / n


def _mi_drive(engine, sc, belief, truth, world, domain, n):
    """n MI ticks (disc reveal + ``replan_refresh_mi`` with K3 + pose
    advance); returns (state, beliefs, per-tick (u, metric, code, DWA active,
    DWA feasible, U), ms per tick)."""
    import torch

    from ergodic_exploration_tpu_torch.ops import sensor

    outs = []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        belief = sensor.reveal(belief, truth, sc.x, REVEAL_RANGE)
        sc, u, dg = engine.replan_refresh_mi(sc, engine.shard_scenarios(belief), world,
                                             sensor_radius_cells=MI_RADIUS, domain=domain,
                                             use_mi_kernel=True)
        outs.append((u, dg.ergodic_metric, dg.collision_code, dg.dwa_active, dg.dwa_feasible,
                     sc.state.U))
        sc = advance(engine, sc, u)
    end.record()
    torch.cuda.synchronize()
    return sc, belief, outs, start.elapsed_time(end) / n


def tree_leaves(tree) -> list:
    """The leaves of a tree of NamedTuples and tuples, in order."""
    if isinstance(tree, tuple):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def _same_ticks(what: str, got, ref) -> None:
    """Fail unless every tensor of every tick is equal bit for bit."""
    import torch

    for t, (a, b) in enumerate(zip(got, ref)):
        for name, x, y in zip(TICK_FIELDS, a, b):
            if not torch.equal(x, y):
                fail(f"{what}: tick {t} {name} differs from the unsharded engine")
    print(f"  {what}: {len(got)} ticks equal to the unsharded engine bit for bit", flush=True)


def _leg_a(tmp, card):
    """Leg (a), a world of one NCCL rank: the mesh wrappers on path A and
    path E at S = 4096 against the unsharded engine in this process; the
    collective checkpoint; the dry run; K1 and K3 against their plain
    versions on this rank's inputs."""
    import torch

    import ergodic_exploration_tpu_torch.ops.mi_kernel as mk
    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch.engine import Engine, make_mesh, make_scenario_mesh
    from ergodic_exploration_tpu_torch.graft_entry import dryrun_multichip
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch

    dev = torch.device("cuda", torch.cuda.current_device())
    res = {}
    cfg, x0, grids, gmm, domain = bench_case(S_MAIN, dev)
    eng_u = Engine(cfg, device=dev)
    world_u = eng_u.prepare_world(grids)
    _, ref, _ = _drive(eng_u, eng_u.init_scenarios(x0), world_u, gmm, domain, SCALE_TICKS)
    ms = {}  # each engine timed on its second run from the start, so no first-use cost counts
    _, _, ms["unsharded"] = _drive(eng_u, eng_u.init_scenarios(x0), world_u, gmm, domain,
                                   SCALE_TICKS)
    mesh = make_scenario_mesh()
    for name, m in (("mesh (1,)", mesh), ("mesh (1, 1)", make_mesh(1, 1))):
        eng = Engine(cfg, mesh=m)
        world, gmm_l = eng.prepare_world(grids), eng.shard_scenarios(gmm)
        reset_counts()
        sc, got, _ = _drive(eng, eng.init_scenarios(x0), world, gmm_l, domain, SCALE_TICKS)
        counts = read_counts()
        expect_counts(f"phase 17 (a), path A on {name}", counts,
                      {"fused_solve_safety": SCALE_TICKS})
        _same_ticks(f"path A on {name}", got, ref)
        _, _, ms[name] = _drive(eng, eng.init_scenarios(x0), world, gmm_l, domain, SCALE_TICKS)
        if name == "mesh (1,)":
            eng_m, sc_m, world_m, gmm_m = eng, sc, world, gmm_l
            res["k1_launches"] = counts["fused_solve_safety"]
    _, _, ms["unsharded, again"] = _drive(eng_u, eng_u.init_scenarios(x0), world_u, gmm, domain,
                                          SCALE_TICKS)
    print(f"  path A tick (replan_refresh + pose advance), S={S_MAIN}, ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items()) + f" {card}", flush=True)

    # K1 against its plain version on this rank's inputs (the mesh path's state)
    inp, _ = sk.fused_tick_inputs(cfg, sc_m.state, sc_m.x, sc_m.vb, None, world_m, gmm_m,
                                     domain)
    k, p = sk.K1(cfg, inp), sk.fused_solve_safety_plain(cfg, inp)
    torch.cuda.synchronize()
    err = compare("mesh K1 (J=2)", k, p)
    P = min(cfg.patch_cells, 100)
    crop = extract_patch(world_m.dist, sc_m.x[:, :2], P).center_crop(cfg.safety_patch_cells)
    probes = dwa_probes_needed(cfg, eng_m.model, sc_m.x, sc_m.vb, world_m.domain, crop)
    rf, rb = refresh_work(S_MAIN, int(np.prod(cfg.grid_samples)), cfg.num_basis ** 2, 2)
    sf, sb = solve_work(cfg, S_MAIN, P, True, probes, map_cells=100 * 100)
    res["k1"] = dict(err=err, ms=events_ms(lambda: sk.K1(cfg, inp), 20),
                     plain_ms=events_ms(lambda: sk.fused_solve_safety_plain(cfg, inp), 3),
                     work=(rf + sf, rb + sb))
    del inp, k, p, crop

    # the collective checkpoint, loaded by the unsharded engine: 5 more ticks equal
    ck = os.path.join(tmp, "leg_a_ck.npz")
    eng_m.save_checkpoint(ck, sc_m)
    _, a, _ = _drive(eng_m, sc_m, world_m, gmm_m, domain, RESUME_TICKS)
    _, b, _ = _drive(eng_u, eng_u.load_checkpoint(ck), world_u, gmm, domain, RESUME_TICKS)
    _same_ticks("resumed from the collective checkpoint (mesh vs unsharded)", a, b)
    del eng_m, sc_m, world_m, ref, a, b
    torch.cuda.empty_cache()

    # path E, the MI tick with K3, on the mesh against the unsharded engine
    eng_e, sc_e, belief, truth, world_e, dom = mi_case(S_MAIN, dev)
    x0_e = sc_e.x.clone()
    _, _, ref, ms_u = _mi_drive(eng_e, sc_e, belief, truth, world_e, dom, SCALE_TICKS)
    eng_me = Engine(eng_e.config, mesh=mesh)
    reset_counts()
    _, belief_m, got, ms_m = _mi_drive(eng_me, eng_me.init_scenarios(x0_e), belief, truth,
                                       eng_me.prepare_world(belief), dom, SCALE_TICKS)
    counts = read_counts()
    expect_counts("phase 17 (a), path E on mesh (1,)", counts,
                  {"phik_from_grid_fc": SCALE_TICKS, "fused_solve_safety": SCALE_TICKS})
    _same_ticks("path E on mesh (1,)", got, ref)
    res["k3_launches"] = counts["phik_from_grid_fc"]
    print(f"  path E tick (reveal + replan_refresh_mi + pose advance), S={S_MAIN}: unsharded "
          f"{ms_u:.4f} ms, mesh (1,) {ms_m:.4f} ms {card}", flush=True)
    c = eng_e.config
    ops = mk.mi_operands(GridMap(belief_m.data[0], belief_m.origin[0], belief_m.resolution[0]),
                         dom, c.num_basis, c.grid_samples)
    args = (ops, MI_RADIUS, c.mi_frontier_cells, c.occupied_threshold)
    kk, pp = mk.K3(belief_m.data, *args), mk.phik_from_grid_plain(belief_m.data, *args)
    torch.cuda.synchronize()
    e3 = (kk - pp).abs()
    if bool((e3 > K3_TOL["atol"] + K3_TOL["rtol"] * pp.abs()).any()):
        fail(f"mesh K3 outside rtol {K3_TOL['rtol']} / atol {K3_TOL['atol']}: {e3.max():.3e}")
    res["k3"] = dict(err=e3.max().item(), ms=events_ms(lambda: mk.K3(belief_m.data, *args), 20),
                     plain_ms=events_ms(lambda: mk.phik_from_grid_plain(belief_m.data, *args), 3),
                     work=mi_work(S_MAIN, 100, 100, c.num_basis, MI_RADIUS, c.mi_frontier_cells))
    print(f"  mesh K3: max |kernel - plain| {res['k3']['err']:.3e}", flush=True)
    del eng_e, eng_me, belief, belief_m, truth, world_e, kk, pp
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dryrun_multichip(1)
    print(f"  dryrun_multichip(1): ok in {time.perf_counter() - t0:.2f} s", flush=True)
    return res


def _sync_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` by the host clock, the device synchronised after
    each call (for collectives, which the host waits on)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _leg_b(tmp, card):
    """Leg (b), two gloo ranks sharing the card: path A on mesh (2,), the
    sample-sharded targets and ticks on mesh (1, 2), the collective
    checkpoint, the dry run with its 2-D leg. Rank 0 writes what its group
    gathered for the parent to compare."""
    import torch
    import torch.distributed as dist

    from ergodic_exploration_tpu_torch.engine import Engine, make_mesh, make_scenario_mesh
    from ergodic_exploration_tpu_torch.graft_entry import dryrun_multichip
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.parallel import process_allgather
    from ergodic_exploration_tpu_torch.utils.interop import to_numpy

    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    out, res = {}, {}
    cfg, x0, grids, gmm, domain = bench_case(S_MAIN, dev)
    mesh = make_scenario_mesh(devices="cuda")
    eng = Engine(cfg, mesh=mesh)
    world, gmm_l = eng.prepare_world(grids), eng.shard_scenarios(gmm)
    sc, ticks, res["tick_ms"] = _drive(eng, eng.init_scenarios(x0), world, gmm_l, domain,
                                       SCALE_TICKS)
    for t, tick in enumerate(ticks):
        for name, v in zip(TICK_FIELDS, process_allgather(tick, mesh)):
            out[f"a{t}_{name}"] = v.cpu().numpy()
    res["gather_ms"] = _sync_ms(lambda: process_allgather(sc, mesh), 5)
    ck = os.path.join(tmp, "leg_b_ck.npz")
    t0 = time.perf_counter()
    eng.save_checkpoint(ck, sc)
    res["checkpoint_ms"] = 1e3 * (time.perf_counter() - t0)
    for i, leaf in enumerate(tree_leaves(to_numpy(process_allgather(sc, mesh)))):
        out[f"state_{i}"] = leaf
    del eng, sc, world, ticks
    torch.cuda.empty_cache()

    # mesh (1, 2): the lattice split over the two ranks
    mesh2 = make_mesh(1, 2, devices="cuda")
    cfg_d, _, grids_d, gmm_d, dom_d = distinct_case(S_MAIN, dev)
    eng2 = Engine(cfg_d, mesh=mesh2)
    deg = grids_d.data.clone()
    deg[::97] = 1.0  # every 97th scenario fully occupied: an empty free mask
    out["phik_unmasked"] = eng2.phik_from_gmm(gmm_d, dom_d).cpu().numpy()
    out["phik_masked"] = eng2.phik_from_gmm(gmm_d, dom_d, eng2.prepare_world(grids_d)).cpu().numpy()
    out["phik_degenerate"] = eng2.phik_from_gmm(
        gmm_d, dom_d, eng2.prepare_world(grids_d._replace(data=deg))).cpu().numpy()
    beliefs = torch.from_numpy(mi_beliefs(S_MAIN, 100, 100)).to(dev)
    bgrids = GridMap(beliefs, torch.zeros((S_MAIN, 2), device=dev),
                     torch.full((S_MAIN,), 0.05, device=dev))
    out["phik_mi"] = eng2.phik_from_grid(bgrids, MI_RADIUS).cpu().numpy()
    group = mesh2.get_group("sample")
    mass = torch.ones((S_MAIN, 2), device=dev)
    part = torch.ones((S_MAIN, cfg_d.num_basis ** 2), device=dev)
    res["all_reduce_mass_ms"] = _sync_ms(lambda: dist.all_reduce(mass, group=group), 20)
    res["all_reduce_ck_ms"] = _sync_ms(lambda: dist.all_reduce(part, group=group), 20)
    res["phik_sharded_ms"] = _sync_ms(lambda: eng2.phik_from_gmm(gmm_d, dom_d), 5)
    del eng2, beliefs, bgrids, deg
    # replan_refresh on mesh (1, 2), each tick beside the unsharded engine's
    # tick from the same state (a rank holds every scenario on this mesh)
    eng3, eng_u = Engine(cfg, mesh=mesh2), Engine(cfg, device=dev)
    world3, world_u = eng3.prepare_world(grids), eng_u.prepare_world(grids)
    sc, gmm3 = eng3.init_scenarios(x0), eng3.shard_scenarios(gmm)
    for t in range(SAMPLE_TICKS):
        for tag, (sc2, u, dg) in (("s", eng3.replan_refresh(sc, gmm3, domain, world3)),
                                  ("r", eng_u.replan_refresh(sc, gmm, domain, world_u))):
            tick = (u, dg.ergodic_metric, dg.collision_code, dg.dwa_active, dg.dwa_feasible,
                    sc2.state.U)
            for name, v in zip(TICK_FIELDS, tick):
                out[f"{tag}{t}_{name}"] = v.cpu().numpy()
            if tag == "s":
                sc_next = advance(eng3, sc2, u)
        sc = sc_next
    _, _, res["sample_tick_ms"] = _drive(eng3, sc, world3, gmm3, domain, SAMPLE_TICKS)
    del eng3, eng_u, world3, world_u, sc, sc2, sc_next
    torch.cuda.empty_cache()
    if rank == 0:
        np.savez(os.path.join(tmp, "leg_b.npz"), **out)

    t0 = time.perf_counter()
    dryrun_multichip(2)
    print(f"  [rank {rank}] dryrun_multichip(2) with its 2-D leg: ok in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return res


def _rank_main(leg: str, rank: int, world: int, tmp: str, backend: str, card: str) -> None:
    """A spawned rank: joins the group through a file store, runs its leg,
    writes ``<tmp>/<leg>_rank<r>.json`` and leaves the group."""
    import torch.distributed as dist

    from ergodic_exploration_tpu_torch.parallel import initialize_multihost

    initialize_multihost(f"file://{os.path.join(tmp, leg + '_store')}", world, rank,
                         backend=backend)
    try:
        res = {"a": _leg_a, "b": _leg_b}[leg](tmp, card)
        with open(os.path.join(tmp, f"{leg}_rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def _spawn(leg: str, world: int, backend: str, tmp: str, card: str):
    """Run the ranks of a leg to their end; fail unless every rank exits 0.
    Returns each rank's results."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(leg, r, world, tmp, backend, card))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        fail(f"phase 17 leg ({leg}): ranks exited with {codes}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"{leg}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _close_ticks(what: str, got: dict, prefix: str, ref, n: int) -> None:
    """Ticks gathered from the ranks (``got[f"{prefix}{t}_{field}"]``)
    against the unsharded ticks ``ref``, within the port's budgets: at most
    CODE_MISMATCH_LIMIT scenarios whose code or DWA flags differ (over the
    run), controls within 5e-5 and the metric within rtol 1e-5 elsewhere."""
    mism = np.zeros(S_MAIN, bool)
    du = dm = 0.0
    bad_metric = 0
    for t in range(n):
        g = {k: got[f"{prefix}{t}_{k}"] for k in TICK_FIELDS}
        r = dict(zip(TICK_FIELDS, ref[t]))
        mism |= ((g["code"] != r["code"]) | (g["dwa_active"] != r["dwa_active"])
                 | (g["dwa_feasible"] != r["dwa_feasible"]))
        ok = ~mism
        du = max(du, float(np.abs(g["u"] - r["u"])[ok].max()),
                 float(np.abs(g["U"] - r["U"])[ok].max()))
        e = np.abs(g["metric"] - r["metric"])[ok]
        dm = max(dm, float(e.max()))

        bad_metric += int((e > TOL["metric"]["atol"]
                           + TOL["metric"]["rtol"] * np.abs(r["metric"][ok])).sum())
    print(f"  {what}: max |ΔU| {du:.3e} (atol 5e-5), max |Δmetric| {dm:.3e} (rtol 1e-5: "
          f"{bad_metric} outside), {int(mism.sum())} of {S_MAIN} scenarios differ in code / "
          f"DWA flags (limit {CODE_MISMATCH_LIMIT})", flush=True)
    if du > TOL["U_new"]["atol"] or bad_metric or mism.sum() > CODE_MISMATCH_LIMIT:
        fail(f"{what}: outside the port's budgets")


def scale_out_phase(dev, card, entry, kernels) -> None:
    """Phase 17: leg (a) on one NCCL rank, leg (b) on two gloo ranks sharing
    the card, each spawned after the libraries were built; leg (b) is held
    against the unsharded engine of this process. Adds the mesh path's K1
    and K3 entries through ``entry``."""
    import torch

    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.utils.interop import to_numpy

    print("== 17. scale-out: leg (a), a world of one NCCL rank", flush=True)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        (res_a,) = _spawn("a", 1, "nccl", tmp, card)
        print(f"  leg (a) in {time.perf_counter() - t0:.1f} s", flush=True)
        k1, k3 = res_a["k1"], res_a["k3"]
        entry("mesh_fused_solve_safety", "solve_kernel.cu",
              "ergodic_exploration_tpu/ops/solve_kernel.py:602", k1["err"], k1["ms"],
              k1["plain_ms"], k1["work"])
        kernels["mesh_fused_solve_safety"]["launches"] = res_a["k1_launches"]
        entry("mesh_phik_from_grid_fc", "mi_kernel.cu", "ergodic_exploration_tpu/ops/mi_kernel.py:210",
              k3["err"], k3["ms"], k3["plain_ms"], k3["work"])
        kernels["mesh_phik_from_grid_fc"]["launches"] = res_a["k3_launches"]

        # the unsharded references of leg (b), in this process
        print("== 17. scale-out: leg (b), two gloo ranks sharing the card", flush=True)
        cfg, x0, grids, gmm, domain = bench_case(S_MAIN, dev)
        eng = Engine(cfg, device=dev)
        _, ref, _ = _drive(eng, eng.init_scenarios(x0), eng.prepare_world(grids), gmm, domain,
                           SCALE_TICKS)
        ref = [[v.cpu().numpy() for v in tick] for tick in ref]
        cfg_d, _, grids_d, gmm_d, dom_d = distinct_case(S_MAIN, dev)
        eng_d = Engine(cfg_d, device=dev)
        deg = grids_d.data.clone()
        deg[::97] = 1.0
        beliefs = torch.from_numpy(mi_beliefs(S_MAIN, 100, 100)).to(dev)
        bgrids = GridMap(beliefs, torch.zeros((S_MAIN, 2), device=dev),
                         torch.full((S_MAIN,), 0.05, device=dev))
        refs = dict(
            unmasked=eng_d.phik_from_gmm(gmm_d, dom_d),
            masked=eng_d.phik_from_gmm(gmm_d, dom_d, eng_d.prepare_world(grids_d)),
            degenerate=eng_d.phik_from_gmm(gmm_d, dom_d,
                                           eng_d.prepare_world(grids_d._replace(data=deg))),
            mi=eng_d.phik_from_grid(bgrids, MI_RADIUS, domain=dom_d))
        refs = {k: v.cpu().numpy() for k, v in refs.items()}
        del eng, eng_d, deg, beliefs, bgrids
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        res_b = _spawn("b", 2, "gloo", tmp, card)
        print(f"  leg (b) in {time.perf_counter() - t0:.1f} s", flush=True)
        for r, rb in enumerate(res_b):
            print(f"  [rank {r}] path A tick on mesh (2,), 2048 scenarios: {rb['tick_ms']:.4f} ms; "
                  f"on mesh (1, 2) (sample-sharded refresh, K1 fed phi_k): "
                  f"{rb['sample_tick_ms']:.4f} ms; sample-sharded phik_from_gmm "
                  f"{rb['phik_sharded_ms']:.4f} ms; all_reduce of the mass (4096 x 2) "
                  f"{rb['all_reduce_mass_ms']:.4f} ms, of the partial coefficients "
                  f"(4096 x 100) {rb['all_reduce_ck_ms']:.4f} ms; checkpoint gather "
                  f"{rb['gather_ms']:.4f} ms, collective save {rb['checkpoint_ms']:.1f} ms "
                  f"{card} (two ranks on one card: not a scaling figure)", flush=True)
        got = dict(np.load(os.path.join(tmp, "leg_b.npz")))
        _close_ticks("path A on mesh (2,) vs unsharded", got, "a", ref, SCALE_TICKS)
        same_state = [tuple(got[f"r{t}_{k}"] for k in TICK_FIELDS) for t in range(SAMPLE_TICKS)]
        _close_ticks("replan_refresh on mesh (1, 2) vs unsharded from the same state", got, "s",
                     same_state, SAMPLE_TICKS)
        loop = max(float(np.abs(got[f"s{t}_U"] - ref[t][5]).max()) for t in range(SAMPLE_TICKS))
        print(f"  (the two closed loops apart, {SAMPLE_TICKS} ticks: max |ΔU| {loop:.3e}: "
              f"rounding-level target differences grow along a trajectory)", flush=True)
        for name, ref_p in refs.items():
            tol = K3_TOL if name == "mi" else dict(rtol=0.0, atol=K2_ATOL)
            err = np.abs(got[f"phik_{name}"] - ref_p)
            bad = int((err > tol["atol"] + tol["rtol"] * np.abs(ref_p)).sum())
            print(f"  sample-sharded {name} target on mesh (1, 2) vs unsharded "
                  f"{'dense path' if name == 'mi' else 'K2'}: max |diff| {err.max():.3e} "
                  f"(rtol {tol['rtol']}, atol {tol['atol']}), {bad} outside", flush=True)
            if bad:
                fail(f"sample-sharded {name} target outside tolerance")
        eng = Engine(cfg, device=dev)
        back = tree_leaves(to_numpy(eng.load_checkpoint(os.path.join(tmp, "leg_b_ck.npz"))))
        for i, leaf in enumerate(back):
            if not np.array_equal(leaf, got[f"state_{i}"]):
                fail(f"the checkpoint of two ranks differs from their gathered state (leaf {i})")
        print(f"  the checkpoint of two ranks, loaded here, equals their gathered state bit for "
              f"bit ({len(back)} leaves)", flush=True)


# ---------------------------------------------------------------------------
# phase 18: path Q, the config-4 quality run at full length
# ---------------------------------------------------------------------------


def quality_phase(dev, card, entry, kernels) -> None:
    """Phase 18: (a) ``tools.quality.run`` at the record's configuration,
    held against docs/quality_config4.json; (b) the multi-room floors of
    tests/test_quality.py; (c) ``k1_safety`` against its plain version on
    the state (a) reached, added through ``entry``."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch
    from ergodic_exploration_tpu_torch.tools import quality

    n_ticks = Q_REFRESHES * Q_EVERY
    print(f"== 18. path Q: the quality run, default_config('omni'), S={Q_S}, {Q_REFRESHES} "
          f"refreshes of {Q_EVERY} ticks, sensor range {quality.SENSOR_RANGE} m", flush=True)
    cfg = default_config("omni")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    r = quality.run(Q_S, Q_REFRESHES, Q_EVERY, quality.SENSOR_RANGE, seed=0, device=dev)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_counts("phase 18 (a)", counts, step_want(cfg, n_ticks))
    # a reveal and a world rebuild a refresh; one distance field alone: the
    # spawns' (spawn_poses)
    map_q = read_map()
    expect_counts("phase 18 (a), the map kernels", map_q, map_want(Q_REFRESHES, Q_REFRESHES, 1))
    note_launches("path Q", map_q)
    expect_counts("phase 18 (a), M", read_dense(), dense_want(Q_REFRESHES))
    truth = quality.build_truth(Q_S, dev)
    # the CPU's spawns are the JAX tool's (tests/test_torch_quality.py), and
    # each lies inside the domain with an EDT above the margin by construction
    spawns_ok = np.array_equal(r.x0, quality.spawn_poses(cfg, quality.build_truth(Q_S, "cpu"),
                                                         Q_S))
    print(f"  {Q_S} spawns equal to those of the CPU's EDT element for element: {spawns_ok}")

    cov, traj, metric, belief = r.coverage, r.trajectory, r.metric, r.belief.data
    summary = quality.summarize(cov.cpu().numpy(), belief.cpu().numpy(), metric.cpu().numpy(),
                                quality.SENSOR_RANGE, r.wall_s)
    record = json.loads(quality.RECORD.read_text())
    verdict = quality.compare_to_record(summary, record)
    for i, (tick, got, ref, gap) in enumerate(verdict["coverage_at"]):
        tol = quality.FIRST_TOL if i == 0 else quality.COV_TOL
        print(f"  fleet coverage at tick {tick:4d}: port {got:.5f} | record {ref:.5f} | gap "
              f"{gap:+.5f} (limit {tol})")
    dist, rec_dist = summary["final_coverage_per_scenario"], record["final_coverage_per_scenario"]
    print("  final per-scenario coverage (port | record): " + ", ".join(
        f"{q} {dist[q]:.4f} | {rec_dist[q]:.4f}" for q in ("p10", "median", "p90", "best")) +
        f"; limits p10 >= record - {quality.P10_SLACK}, median >= record - "
        f"{quality.MEDIAN_SLACK}; final fleet coverage {summary['final_coverage']:.5f} | "
        f"{record['final_coverage']:.5f}")
    print("  ergodic metric (port | record): " + ", ".join(
        f"{k[len('ergodic_metric_'):]} {summary[k]:.6f} | {record[k]:.6f}"
        for k in ("ergodic_metric_first_tick", "ergodic_metric_last_tick",
                  "ergodic_metric_last_refresh_mean")))
    gaps = tuple(f"{gap:+.5f}" for _, _, _, gap in verdict["coverage_at"])
    p10_med = tuple(f"{dist[q]:.4f}" for q in ("p10", "median"))
    print(f"  the {len(gaps)} gaps equal the printed digits of the plain loop with the plain "
          f"dense target {LOOP_Q_GAPS}: {gaps == LOOP_Q_GAPS}; the final p10 / median equal its "
          f"{LOOP_Q_P10_MEDIAN}: {p10_med == LOOP_Q_P10_MEDIAN}")
    print(f"  wall {r.wall_s:.2f} s for {n_ticks} ticks as {Q_REFRESHES} graph replays (the "
          f"first refresh the warm-up, then {r.capture_s:.3f} s of capture): "
          f"{1e3 * r.wall_s / n_ticks:.4f} ms a tick, {1e3 * r.wall_s / Q_REFRESHES:.3f} ms a "
          f"refresh; peak device memory {peak / 2**20:.1f} MiB {card}", flush=True)

    faults = [] if spawns_ok else ["the card's spawns differ from the CPU's"]
    if (traj.shape != (Q_REFRESHES, Q_EVERY, Q_S, 3) or metric.shape != (Q_REFRESHES, Q_EVERY, Q_S)
            or not all(torch.isfinite(t).all() for t in (cov, traj, metric, r.scenarios.x))):
        faults.append("non-finite or mis-shaped outputs")
    if not ((traj[..., :2] >= 0.0) & (traj[..., :2] <= 5.0)).all():
        faults.append("a pose left the domain")
    known = belief != -1.0
    if not torch.equal(belief[known], truth.data[known]):
        faults.append("a known cell of the final belief differs from the truth")
    if not bool((cov[1:] >= cov[:-1]).all()):
        faults.append("coverage fell between refreshes")
    faults += verdict["failures"]
    if faults:
        fail(f"phase 18 (a): {faults}")
    print("  all finite; every pose inside the domain; every known cell equals the truth; "
          "coverage never fell; every gap to the record inside its limit")

    # (b) the multi-room floors at pure defaults (tests/test_quality.py)
    print(f"== 18 (b). the multi-room floors: S={len(quality.MULTIROOM_X0)}, "
          f"{quality.MULTIROOM_TICKS} ticks, a refresh every {Q_EVERY} (reveal -> phik_from_grid "
          f"-> prepare_world -> explore)", flush=True)
    eng = Engine(cfg, device=dev)
    reset_counts()
    speed, coverage, rise = quality.multiroom_floors(eng, Q_EVERY)
    expect_counts("phase 18 (b)", read_counts(), step_want(cfg, quality.MULTIROOM_TICKS))
    # explore_mapping: a reveal, prepare_world and a coverage each, and the
    # floors' own coverage of each chunk
    chunks = quality.MULTIROOM_TICKS // Q_EVERY
    expect_counts("phase 18 (b), the map kernels", read_map(),
                  map_want(chunks, chunks, coverages=2 * chunks))
    # explore_mapping's target is phik_from_grid without a domain: the separable path
    expect_counts("phase 18 (b), M", read_dense(), {})
    print(f"  mean speed {speed:.4f} m/s (floor {quality.FLOOR_SPEED}); coverage {coverage:.4f} "
          f"(floor {quality.FLOOR_COVERAGE}); second-half rise {rise:.4f} "
          f"(floor {quality.FLOOR_RISE})")
    if not (speed > quality.FLOOR_SPEED and coverage > quality.FLOOR_COVERAGE
            and rise > quality.FLOOR_RISE):
        fail("phase 18 (b): the default omni configuration fell under a multi-room floor")

    # (c) k1_safety from the map against its plain version on the state (a) reached
    sc, world = r.scenarios, eng.prepare_world(r.belief)
    P = min(cfg.patch_cells, *world.dist.dist.shape[-2:])
    crop = extract_patch(world.dist, sc.x[:, :2], P).center_crop(cfg.safety_patch_cells)
    e, args, _ = safety_map_check(f"path Q (omni, S={Q_S})", cfg, sc.x, sc.vb, sc.state.U, world)
    probes = dwa_probes_needed(cfg, eng.model, sc.x, sc.vb, world.domain, crop)
    entry("quality_fused_safety_map", "solve_kernel.cu",
          "ergodic_exploration_tpu/ops/solve_kernel.py:1254", e,
          events_ms(lambda: sk.K1.safety_map(cfg, *args), 50),
          events_ms(lambda: sk.fused_safety_map_plain(cfg, *args), 5),
          safety_work(cfg, Q_S, crop.dist.shape[-1], probes))
    kernels["quality_fused_safety_map"]["launches"] = counts["fused_safety_map"]
    k1_q = sk.k1_variant(False, True, True)
    entry(f"quality_{k1_q}", "solve_kernel.cu", "ergodic_exploration_tpu/ops/solve_kernel.py:580",
          *step_k1_check(f"path Q {k1_q} (omni, S={Q_S})", cfg, sc,
                         eng._phik_grid_batch_dense_fn(r.belief, None, 0), world, 50))
    kernels[f"quality_{k1_q}"]["launches"] = counts[k1_q]


def headline_phase(dev, card, kernels, k3_check, tick_a_ms, tick_e_ms) -> None:
    """Phase 19: ``bench._run()`` at full width with the launches of its
    three timed functions counted apart; K1 and K3 against their plain
    versions on the states those loops reached; the line's values; this
    run's path A and path E ticks beside it; the entry point run once as a
    subprocess."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch import bench

    print(f"== 19. the headline entry point: bench._run(), S={S_MAIN}", flush=True)
    reached, counts = {}, {}

    def watch(name, fn, **kw):
        reached[name] = {}
        torch.cuda.synchronize()
        reset_counts()
        out = fn(reached=reached[name], **kw)
        torch.cuda.synchronize()
        counts[name] = read_counts()
        return out

    t0 = time.perf_counter()
    line = bench._run(dev, S=S_MAIN, iters=TIMED_TICKS, reps=LAT_REPS, group=LAT_GROUP,
                      chain=LAT_CHAIN, watch=watch)
    print(f"bench._run() took {time.perf_counter() - t0:.1f} s")
    # each timed function makes one replan_refresh (its checks) and one warm
    # tick ahead of its window; bench_latency warms with one run of LAT_CHAIN
    n = TIMED_TICKS + 2
    expect_counts("headline, bench_throughput", counts["throughput"], {"fused_solve_safety": n})
    expect_counts("headline, bench_throughput_mi", counts["mi"],
                  {"phik_from_grid_fc": n, "fused_solve_safety": n})
    expect_counts("headline, bench_latency", counts["latency"],
                  {"fused_solve_safety": 1 + LAT_CHAIN * (LAT_REPS + 1)})
    for c in counts.values():
        for name, got in c.items():
            if got:
                kernels[name]["launches"] += got
    # the kernels against their plain versions on the states the timed loops reached
    for name, S_ in (("throughput", S_MAIN), ("latency", 1)):
        r = reached[name]
        cfg = r["engine"].config
        inp2, _ = sk.fused_tick_inputs(cfg, r["sc"].state, r["sc"].x, r["sc"].vb, None,
                                          r["world"], r["gmm"], r["domain"])
        compare(f"headline {name} K1 J=2 S={S_}", sk.K1(cfg, inp2),
                sk.fused_solve_safety_plain(cfg, inp2))
    r = reached["mi"]
    engine, sc, belief, domain = r["engine"], r["sc"], r["grids"], r["domain"]
    k3_check("the headline MI tick's beliefs", belief.data.contiguous(), engine, domain, MI_RADIUS)
    phik = engine._phik_grid_kernel(belief, domain, MI_RADIUS)
    inp0, _ = sk.fused_tick_inputs(engine.config, sc.state, sc.x, sc.vb, phik, r["world"])
    compare(f"headline mi K1 J=0 S={S_MAIN}", sk.K1(engine.config, inp0),
            sk.fused_solve_safety_plain(engine.config, inp0))
    del reached, r, engine, sc, belief, phik, inp0, inp2
    torch.cuda.empty_cache()
    # the same three timed functions on the eager functions (by name), for
    # the record beside the line's graph replays; launches as exact
    t0 = time.perf_counter()
    reset_counts()
    solves_e = bench.bench_throughput(S=S_MAIN, iters=TIMED_TICKS, device=dev, eager=True)
    expect_counts("headline, bench_throughput, eager", read_counts(), {"fused_solve_safety": n})
    reset_counts()
    mi_e, _ = bench.bench_throughput_mi(S=S_MAIN, iters=TIMED_TICKS, device=dev, eager=True)
    expect_counts("headline, bench_throughput_mi, eager", read_counts(),
                  {"phik_from_grid_fc": n, "fused_solve_safety": n})
    reset_counts()
    lat_e = bench.bench_latency(reps=LAT_REPS, group=LAT_GROUP, chain=LAT_CHAIN, device=dev,
                                eager=True)
    expect_counts("headline, bench_latency, eager", read_counts(),
                  {"fused_solve_safety": 1 + LAT_CHAIN * (LAT_REPS + 1)})
    print(f"  the eager functions (in {time.perf_counter() - t0:.1f} s) beside the line's graph "
          f"replays: {solves_e:.1f} vs {line['value']:.1f} solves/s (GMM), {mi_e:.1f} vs "
          f"{line['mi_solves_per_s_per_chip']:.1f} (MI); S=1 latency p50 {lat_e['p50']:.4f} vs "
          f"{line['p50_replan_latency_ms']:.4f} ms, p99 {lat_e['p99']:.4f} vs "
          f"{line['p99_replan_latency_ms']:.4f} ms, spread {lat_e['min']:.4f}-{lat_e['max']:.4f} "
          f"vs {line['latency_spread_ms'][0]:.4f}-{line['latency_spread_ms'][1]:.4f} ms {card}")
    torch.cuda.empty_cache()
    nums = [v for v in line.values() if isinstance(v, (int, float))] + line["latency_spread_ms"]
    if not all(np.isfinite(v) and v > 0 for v in nums):
        fail(f"the headline line holds a value that is not finite and above 0: {line}")
    if line["mi_frontier_cells"] != 3 or line["p99_replan_latency_ms"] >= BUDGET_MS:
        fail(f"the headline line has mi_frontier_cells != 3 or p99 over {BUDGET_MS} ms")
    print(json.dumps(line))
    print(f"  the twin's ticks: {S_MAIN * 1e3 / line['value']:.4f} ms (GMM), "
          f"{S_MAIN * 1e3 / line['mi_solves_per_s_per_chip']:.4f} ms (MI); beside them, this "
          f"run's path A tick {tick_a_ms:.4f} ms (with a pose advance) and path E tick "
          f"{tick_e_ms:.4f} ms (with a reveal and a pose advance) {card}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ergodic_exploration_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    out = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not out:
        print(proc.stderr[-4000:])
        fail(f"python -m ergodic_exploration_tpu_torch.bench exited {proc.returncode}")
    sub = json.loads(out[-1])
    if set(sub) != set(line):
        fail(f"the entry point's line has keys {sorted(sub)}, _run() gave {sorted(line)}")
    print(f"python -m ergodic_exploration_tpu_torch.bench: exit 0 in "
          f"{time.perf_counter() - t0:.1f} s; its line: {out[-1]}")


# ---------------------------------------------------------------------------
# phase 20: the closed loops as CUDA graphs against their plain loops
# ---------------------------------------------------------------------------


def runtime_profile(fn):
    """Run ``fn`` once under ``torch.profiler``: (the host's CUDA runtime
    API calls (``cuda*`` and ``cu*``) by name, the device's busy ms: the sum of its kernels',
    copies' and memsets' durations, and the run's ms by CUDA events). The
    profile's own closing ``cudaDeviceSynchronize`` and the events' calls
    are not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
    calls, busy_us = {}, 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us += e.time_range.elapsed_us()
        elif e.name.startswith("cu"):
            calls[e.name] = calls.get(e.name, 0) + 1
    calls["cudaDeviceSynchronize"] = calls.get("cudaDeviceSynchronize", 1) - 1
    for name in ("cudaEventRecord", "cudaEventRecordWithFlags"):  # the two events
        if name in calls:
            calls[name] -= 2
            break
    return {k: v for k, v in calls.items() if v}, busy_us / 1e3, start.elapsed_time(end)


def named_leaves(tree, prefix=""):
    """[(dotted name, tensor)] of a tree of NamedTuples, tuples and dicts."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (tuple, list)):
        items = enumerate(tree)
    else:
        return [(prefix, tree)]
    return [x for k, v in items for x in named_leaves(v, f"{prefix}.{k}" if prefix else str(k))]


def same_as_loop(name: str, got, ref) -> None:
    """Fail unless ``got`` (a graph run) equals ``ref`` (the plain loop) bit
    for bit; where a leaf differs, it names the leaf and the first index
    (the tick, on a per-tick leaf) where it does, and holds the budgets
    instead: controls and U 5e-5, the metric rtol 1e-5, codes and DWA flags
    equal; anything else must be equal."""
    import torch

    budgets = {"controls": 5e-5, "U": 5e-5}
    differ = []
    for (k, a), (_, b) in zip(named_leaves(got), named_leaves(ref), strict=True):
        if a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b):
            continue
        first = (a != b).nonzero()[0].tolist() if a.shape == b.shape else "shape"
        err = (a.float() - b.float()).abs().max().item() if a.shape == b.shape else float("inf")
        differ.append(k)
        leaf = k.split(".")[-1]
        ok = (err <= budgets[leaf] if leaf in budgets else
              err <= 1e-7 + 1e-5 * b.abs().max().item() if leaf == "ergodic_metric" else False)
        print(f"  {name}: {k} differs from the plain loop, first at index {first}, max |diff| "
              f"{err:.3e} ({'inside' if ok else 'outside'} its budget)")
        if not ok:
            fail(f"phase 20, {name}: {k} differs from the plain loop beyond its budget")
    print(f"  {name}: equal to the plain loop bit for bit in "
          f"{len(named_leaves(ref)) - len(differ)} of {len(named_leaves(ref))} leaves")


def graph_case(name: str, engine, graph_run, loop_run, want: dict, ticks: int,
               maps: dict = None, dense: dict = None) -> None:
    """The checks of one case of phase 20: the first graph run (which
    captures) and the second (replays only), each with exact launch counts
    (the glue's: ``ticks`` of each kernel, the ring appended in place; the
    map kernels': ``maps``, M's: ``dense``, none by default) and each against
    the plain loop bit for bit, whose launches are exact too (the ring
    copied)."""
    import torch

    glue = glue_want(engine.config, ticks, advance=True, in_place=True)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    first = graph_run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    expect_counts(f"phase 20, {name}, the run that captures", read_counts(), want)
    expect_counts(f"phase 20, {name}, the run that captures, the glue", read_glue(), glue)
    expect_counts(f"phase 20, {name}, the run that captures, the map kernels", read_map(),
                  maps or {})
    expect_counts(f"phase 20, {name}, the run that captures, M", read_dense(), dense or {})
    reset_counts()
    again = graph_run()
    torch.cuda.synchronize()
    expect_counts(f"phase 20, {name}, replays only", read_counts(), want)
    expect_counts(f"phase 20, {name}, replays only, the glue", read_glue(), glue)
    expect_counts(f"phase 20, {name}, replays only, the map kernels", read_map(), maps or {})
    expect_counts(f"phase 20, {name}, replays only, M", read_dense(), dense or {})
    captured = {n: [d for d in g.launches if d] for e in engine._graphs._entries.values()
                for n, g in e.graphs.items()}
    print(f"  {name}: launches a replay of each graph (by its ticks) {captured}; capture "
          f"{engine.graph_capture_s:.3f} s; the first run {first_s:.3f} s (warm-up and capture "
          f"included)", flush=True)
    reset_counts()
    ref = loop_run()
    torch.cuda.synchronize()
    expect_counts(f"phase 20, {name}, the plain loop", read_counts(), want)
    loop_glue = read_glue()
    expect_counts(f"phase 20, {name}, the plain loop, the glue", loop_glue,
                  glue_want(engine.config, ticks, advance=True))
    note_launches(f"phase 20, {name}, the plain loop", loop_glue)
    expect_counts(f"phase 20, {name}, the plain loop, the map kernels", read_map(), maps or {})
    expect_counts(f"phase 20, {name}, the plain loop, M", read_dense(), dense or {})
    same_as_loop(name + ", the run that captured", first, ref)
    same_as_loop(name + ", replays only", again, ref)


def wide_case(S: int, device, K: int, H: int):
    """Path A's inputs (``bench_case``) under the bench configuration with
    num_basis K and horizon H: (engine, scenarios, world, gmm, domain)."""
    from ergodic_exploration_tpu_torch.engine import Engine

    cfg, x0, grids, gmm, domain = bench_case(S, device)
    engine = Engine(cfg.replace(num_basis=K, horizon=H), device=device)
    return engine, engine.init_scenarios(x0), engine.prepare_world(grids), gmm, domain


def wide_phase(dev, card, entry, kernels) -> None:
    """Phase 21: K1 and K2 at num_basis, horizon and mixture sizes past the
    bounds they once had; adds the entries of the variants it drives."""
    import torch

    import ergodic_exploration_tpu_torch.ops.gmm_kernel as gk
    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.node import ExplorationNode
    from ergodic_exploration_tpu_torch.ops import basis
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    cpu = torch.device("cpu")
    k1_at = "ergodic_exploration_tpu/ops/solve_kernel.py"
    k2_at = "ergodic_exploration_tpu/ops/pallas_kernels.py:121"
    print(f"== 21. K1 and K2 past K = 16, H = 64: (K, H) in {WIDE_SHAPES}, J in {WIDE_J}",
          flush=True)
    optin = sk.K1.smem_optin(dev)
    plans = {(K, H): (sk.global_tables(K, H, 0, optin), sk.global_tables(K, H, 100, optin))
             for K, H in WIDE_SHAPES}
    print(f"  opt-in shared memory a block {optin} bytes; k1_solve's tables global (not in "
          f"shared memory) with the history as sums / as 100 drawn positions: {plans}; refresh "
          f"slabs {[sk.slab_blocks(K * K) for K, _ in WIDE_SHAPES]}")
    if not all(all(v) for v in plans.values()):
        fail("phase 21: k1_solve's layouts are not the planned ones")

    def ticks_of(fn, n):
        """ms a call of ``fn`` over n calls by CUDA events, and its last result."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / n, out

    def probes_of(cfg, eng, sc_, world):
        P_ = min(cfg.patch_cells, *world.dist.dist.shape[-2:])
        crop = extract_patch(world.dist, sc_.x[:, :2], P_).center_crop(
            min(cfg.safety_patch_cells, P_))
        return P_, dwa_probes_needed(cfg, eng.model, sc_.x, sc_.vb, world.domain, crop)

    def time_layouts(tag, cfg, inp, ref, S_):
        """k1_solve on ``inp`` with its tables in shared memory and in the
        global workspace, in turns, each equal to ``ref`` bit for bit."""
        plan, t = sk.global_tables, {}
        for g in (False, True, True, False):
            sk.global_tables = lambda *a, g=g: g
            try:
                got = sk.K1(cfg, inp)
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, ref) if a is not None):
                    fail(f"phase 21: k1_solve with global tables {g} differs from its planned "
                         f"layout at {tag}")
                t.setdefault(g, []).append(events_ms(lambda: sk.K1(cfg, inp), 10))
            finally:
                sk.global_tables = plan
        print(f"  K1 at {tag}, S={S_}: ms with the tables in shared memory {t[False]}, in the "
              f"global workspace {t[True]}, equal bit for bit {card}")

    def check_refresh(tag, r, dlen):
        """The refresh alone vs plain, two launches bit for bit: within
        REFRESH_ATOL of the plain version, or of the refresh in float64 and
        no further from it than the plain version is. Returns the error
        against plain."""
        a, again, ref = sk.K1.refresh(r, dlen), sk.K1.refresh(r, dlen), sk.refresh_plain(r, dlen)
        exact = sk.refresh_plain(sk.Refresh(GaussianMixture(*(t.double() for t in r.gmm)),
                                            r.pts.double(), r.D.double(), r.mask_ck.double(),
                                            r.masked), dlen.double())
        torch.cuda.synchronize()
        e = (a - ref).abs().max().item()
        e_k, e_p = (a - exact).abs().max().item(), (ref - exact).abs().max().item()
        print(f"  refresh {tag}: max |kernel - plain| {e:.3e}, |kernel - float64| {e_k:.3e}, "
              f"|plain - float64| {e_p:.3e} (atol {REFRESH_ATOL})")
        near = e <= REFRESH_ATOL or (e_k <= REFRESH_ATOL and e_k <= e_p)
        if not near or not torch.equal(a, again) or not torch.isfinite(a).all():
            fail(f"phase 21, {tag}: the refresh is outside its budget, non-finite, or two "
                 f"launches differ")
        return e

    # (a) path A's inputs at full width: replan_refresh, the refresh in slabs inside K1
    for K, H in WIDE_SHAPES:
        tag = f"K{K}_H{H}"
        engine, sc, world, gmm, domain = wide_case(S_MAIN, dev, K, H)
        cfg = engine.config
        sc, u, _ = engine.replan_refresh(sc, gmm, domain, world)  # a first tick: scratch, tables
        sc = advance(engine, sc, u)
        torch.cuda.synchronize()
        reset_counts()
        diverged = torch.zeros(S_MAIN, dtype=torch.bool, device=dev)

        def tick():
            nonlocal sc, diverged
            sc, u_, dg = engine.replan_refresh(sc, gmm, domain, world)
            sc = advance(engine, sc, u_)
            diverged |= dg.diverged
            return u_, dg

        tick_ms, (u, dg) = ticks_of(tick, WIDE_TICKS)
        counts = read_counts()
        expect_counts(f"phase 21, replan_refresh at {tag} (S={S_MAIN})", counts,
                      {"fused_solve_safety": WIDE_TICKS})
        if (u.shape != (S_MAIN, cfg.nu) or not torch.isfinite(u).all()
                or not torch.isfinite(dg.ergodic_metric).all() or not torch.isfinite(sc.x).all()):
            fail(f"phase 21, path A at {tag}: non-finite or mis-shaped outputs")
        inp2, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
        inp0 = inp2._replace(refresh=None, phik=sk.refresh_plain(inp2.refresh, inp2.dlen))
        # the refresh against its plain version; the solve against the plain
        # version fed the kernel's phi_k: the plain refresh (a float32 matmul)
        # is 4.8e-6 from the float64 one at K = 32, the kernel's 1e-7, and
        # that alone moves the plain metric by more than TOL's rtol 1e-5
        e_r = check_refresh(f"path A {tag}", inp2.refresh, inp2.dlen)
        inp_k = inp2._replace(refresh=None, phik=sk.K1.refresh(inp2.refresh, inp2.dlen))
        for safety in (False, True):  # the entry's variant last: its error
            k = sk.K1(cfg, inp2, enable_safety=safety)
            k0 = sk.K1(cfg, inp_k, enable_safety=safety)
            p = sk.fused_solve_safety_plain(cfg, inp_k, enable_safety=safety)
            rev = plain_reversed(cfg, inp_k, safety)
            p2 = sk.fused_solve_safety_plain(cfg, inp2, enable_safety=safety)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(k, k0) if a is not None):
                fail(f"phase 21, path A at {tag}: the tick with the refresh inside differs from "
                     f"the tick fed that refresh's phi_k")
            err = compare_wide(f"path A {tag} safety={safety}", k, p, rev)
            print(f"  path A {tag} safety={safety}: metric against the plain version with its own "
                  f"refresh: max rel {((k.metric - p2.metric).abs() / p2.metric).max().item():.3e}")
        # a control the budget must reject: the kernel fed phi_k rounded to bfloat16
        bad = sk.K1(cfg, inp_k._replace(phik=inp_k.phik.bfloat16().float()))
        if u_budget(f"control: path A {tag}, phi_k in bfloat16", bad.U_new, p.U_new,
                    rev.U_new):
            fail(f"phase 21, path A at {tag}: the budget on U holds a kernel fed phi_k in "
                 f"bfloat16")
        k1_ms = events_ms(lambda: sk.K1(cfg, inp2), 10)
        plain_ms = events_ms(lambda: sk.fused_solve_safety_plain(cfg, inp2), 2)
        r_ms = events_ms(lambda: sk.K1.refresh(inp2.refresh, inp2.dlen), 10)
        s_ms = events_ms(lambda: sk.K1(cfg, inp0), 10)
        N, KK = int(np.prod(cfg.grid_samples)), K * K
        P, probes = probes_of(cfg, engine, sc, world)
        rf, rb = refresh_work(S_MAIN, N, KK, 2)
        sf, sb = solve_work(cfg, S_MAIN, P, True, probes, map_cells=100 * 100)
        print(f"  path A at {tag}: replan_refresh tick {tick_ms:.4f} ms ({int(diverged.sum())} "
              f"scenarios diverged); the refresh (k1_refresh + k1_finish, "
              f"{sk.slab_blocks(KK)} slab blocks) {r_ms:.4f} ms, max |refresh - plain| "
              f"{e_r:.3e}; k1_solve (global tables) {s_ms:.4f} ms; refresh "
              f"bound {bound(rf, rb)[0]:.5f} ms, solve bound {bound(sf, sb)[0]:.5f} ms {card}")
        entry(f"fused_solve_safety_{tag}", "solve_kernel.cu", f"{k1_at}:602", err, k1_ms,
              plain_ms, (rf + sf, rb + sb))
        kernels[f"fused_solve_safety_{tag}"]["launches"] = counts["fused_solve_safety"]
        if (K, H) == (20, 80):  # the largest of these shapes where 4 warps' tables fit a block
            time_layouts(f"{tag}, path A, phi_k given", cfg, inp_k, k0, S_MAIN)
        del engine, sc, world, inp0, inp2, k, p, rev, bad
        torch.cuda.empty_cache()

    # k1_solve's two layouts where four warps' tables fit shared memory
    for K, H in LAYOUT_SHAPES:
        engine, sc, world, gmm, domain = wide_case(S_MAIN, dev, K, H)
        cfg = engine.config
        inp2, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
        inp_k = inp2._replace(refresh=None, phik=sk.K1.refresh(inp2.refresh, inp2.dlen))
        time_layouts(f"K{K}_H{H} ({4 * 4 * sk.solve_warp_floats(K, H, 0)} bytes of tables a "
                     f"block of 4), path A, phi_k given", cfg, inp_k, sk.K1(cfg, inp_k), S_MAIN)
        del engine, sc, world, inp2, inp_k
    torch.cuda.empty_cache()

    # (b) distinct maps: phik_from_gmm (K2 masked), explore (graph replays),
    # then K1 on per-scenario maps with the drawn history vs plain
    for K, H in WIDE_SHAPES:
        tag = f"K{K}_H{H}"
        cfg_b, x0_b, grids_b, gmm_b, dom_b = distinct_case(WIDE_S, dev, num_basis=K, horizon=H)
        eng = Engine(cfg_b)
        world_b = eng.prepare_world(grids_b)
        reset_counts()
        phik_b = eng.phik_from_gmm(gmm_b, dom_b, world_b)
        out = eng.explore(eng.init_scenarios(x0_b), phik_b, world_b, WIDE_TICKS)
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"phase 21, phik_from_gmm + explore at {tag} (S={WIDE_S})", counts,
                      {"phik_from_gmm_masked": 1, "fused_solve_safety_map_h0_nb": WIDE_TICKS})
        if not (torch.isfinite(out.controls).all() and torch.isfinite(out.trajectory).all()
                and torch.isfinite(phik_b).all()):
            fail(f"phase 21, explore at {tag}: non-finite outputs")
        sc_b = out.scenarios
        inp, _ = sk.fused_tick_inputs(cfg_b, sc_b.state, sc_b.x, sc_b.vb, phik_b, world_b)
        for safety in (False, True):  # the entry's variant last: its error and layout reference
            k = sk.K1(cfg_b, inp, enable_safety=safety)
            p = sk.fused_solve_safety_plain(cfg_b, inp, enable_safety=safety)
            rev = plain_reversed(cfg_b, inp, safety)
            torch.cuda.synchronize()
            err = compare_wide(f"per-scenario maps {tag} safety={safety}", k, p, rev)
        ms_ = events_ms(lambda: sk.K1(cfg_b, inp), 10)
        P, probes = probes_of(cfg_b, eng, sc_b, world_b)
        name = f"fused_solve_safety_map_h0_nb_{tag}"
        entry(name, "solve_kernel.cu", f"{k1_at}:345", err, ms_,
              events_ms(lambda: sk.fused_solve_safety_plain(cfg_b, inp), 2),
              solve_work(cfg_b, WIDE_S, P, True, probes, map_cells=WIDE_S * P * P,
                         nb=cfg_b.buffer_batch))
        kernels[name]["launches"] = counts["fused_solve_safety_map_h0_nb"]
        del eng, world_b, phik_b, out, sc_b, inp, k, p, rev
        torch.cuda.empty_cache()

    # (c) K2 and the refresh at J = 1, 3, 64
    rng = np.random.default_rng(21)
    dom = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    for K in (17, 20, 32, 40):
        cfg_k = default_config("cart").replace(num_basis=K)
        pts = dom.sample_lattice(cfg_k.grid_samples)
        D = basis.dense_table(basis.tables(pts, K, dom), basis.hk_norm(K, dom.lengths))
        N = pts.shape[0]
        mask = torch.from_numpy((rng.uniform(size=(WIDE_S, N)) > 0.3).astype(np.float32)).to(dev)
        mask[::11] = 0.0
        line = []
        for J in WIDE_J:
            means = rng.uniform(1.0, 4.0, (WIDE_S, J, 2)).astype(np.float32)
            means[::7] = 400.0  # no mass: both fallbacks
            g = GaussianMixture.create(
                means, np.tile((0.3 * np.eye(2, dtype=np.float32))[None, None],
                               (WIDE_S, J, 1, 1)),
                rng.uniform(0.5, 1.5, (WIDE_S, J)).astype(np.float32), device=dev)
            g = [t.contiguous() for t in g]
            for m in (None, mask):
                k_out, again = gk.K2(*g, pts, D, m), gk.K2(*g, pts, D, m)
                e = (k_out - gk.phik_from_gmm_plain(*g, pts, D, m)).abs().max().item()
                if (e > K2_ATOL or not torch.equal(k_out, again)
                        or not torch.isfinite(k_out).all()):
                    fail(f"phase 21: K2 at K={K}, J={J}, masked={m is not None} is {e:.3e} "
                         f"from plain (atol {K2_ATOL}), non-finite, or two launches differ")
                line.append(f"K2 J={J}{' masked' if m is not None else ''} {e:.2e} "
                            f"{events_ms(lambda: gk.K2(*g, pts, D, m), 5):.4f} ms")
            for m in (None, mask[1]):
                r = sk.refresh_operands(cfg_k, GaussianMixture(*g), dom, m)
                e = check_refresh(f"K={K}, J={J}", r, torch.full((WIDE_S, 2), 5.0, device=dev))
                line.append(f"refresh J={J}{' masked' if m is not None else ''} {e:.2e}")
        print(f"  K={K}, S={WIDE_S}: max |kernel - plain| and ms: {'; '.join(line)} {card}")

    # (d) the entry points that once refused these shapes, on the card vs on the CPU
    for K in (17, 20, 32):
        res = {}
        for d in (dev, cpu):
            c, _, g_, gm_, dm_ = distinct_case(WIDE_S, d, num_basis=K)
            e_ = Engine(c, device=d)
            w_ = e_.prepare_world(g_)
            reset_counts()
            res[d.type] = (e_.phik_from_gmm(gm_, dm_, w_).cpu(), e_.phik_from_gmm(gm_, dm_).cpu())
            if d.type == "cuda":
                counts = read_counts()
                expect_counts(f"phase 21, phik_from_gmm at K={K}", counts,
                              {"phik_from_gmm_masked": 1, "phik_from_gmm": 1})
                pts = dm_.sample_lattice(c.grid_samples)
                D = basis.dense_table(basis.tables(pts, K, dm_), basis.hk_norm(K, dm_.lengths))
                gl = [t.contiguous() for t in gm_]
                for name, m in ((f"phik_from_gmm_masked_K{K}",
                                 w_.free_mask.to(torch.float32).contiguous()),
                                (f"phik_from_gmm_K{K}", None)):
                    k_out = gk.K2(*gl, pts, D, m)
                    e = (k_out - gk.phik_from_gmm_plain(*gl, pts, D, m)).abs().max().item()
                    entry(name, "gmm_kernel.cu", k2_at, e,
                          events_ms(lambda: gk.K2(*gl, pts, D, m), 10),
                          events_ms(lambda: gk.phik_from_gmm_plain(*gl, pts, D, m), 3),
                          refresh_work(WIDE_S, pts.shape[0], K * K, gl[2].shape[1],
                                       m is not None))
                    kernels[name]["launches"] = counts[
                        "phik_from_gmm_masked" if m is not None else "phik_from_gmm"]
        dm = max((a - b).abs().max().item() for a, b in zip(res[dev.type], res["cpu"]))
        print(f"  phik_from_gmm at K={K} (masked and unmasked, S={WIDE_S}): max |card - cpu| "
              f"{dm:.3e} (atol {K2_ATOL})")
        if dm > K2_ATOL:
            fail(f"phase 21: phik_from_gmm at K={K} on the card disagrees with the CPU")

    eng17 = Engine(default_config("cart").replace(num_basis=17, use_fused_solve=True))
    reset_counts()
    warm = eng17.warmup(WIDE_S, dom, map_shape=(100, 100), gmm_components=2)
    print(f"  warmup(num_basis=17): stages (s) {warm}; launches "
          f"{ {k: v for k, v in read_counts().items() if v} }")
    if not any(read_counts().values()):
        fail("phase 21: warmup at num_basis=17 launched no kernel")
    del eng17

    def moved(tree, d):
        """``tree`` (tensors in NamedTuples) on device ``d``."""
        if isinstance(tree, torch.Tensor):
            return tree.to(d)
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(moved(v, d) for v in tree))
        return tree

    def same_tick(what, card_out, cpu_out):
        """(u, diag) of one tick on the card and on the CPU from one state:
        codes and DWA choices equal but in CODE_MISMATCH_LIMIT scenarios,
        controls within TOL's 5e-5 where they agree."""
        (u_d, dg_d), (u_c, dg_c) = card_out, cpu_out
        same = ((dg_d.dwa_active.cpu() == dg_c.dwa_active)
                & (dg_d.collision_code.cpu() == dg_c.collision_code))
        print(f"  {what}: code or DWA choice differs in {int((~same).sum())} scenarios (limit "
              f"{CODE_MISMATCH_LIMIT})")
        if int((~same).sum()) > CODE_MISMATCH_LIMIT:
            fail(f"phase 21: {what} on the card disagrees with the CPU")
        du = (u_d.cpu() - u_c).abs()[same].max().item()
        print(f"  {what}: max |u_card - u_cpu| {du:.3e} (atol {TOL['U_new']['atol']})")
        if du > TOL["U_new"]["atol"]:
            fail(f"phase 21: {what}: the controls on the card disagree with the CPU's")
        return same

    # replan, explore and replan_refresh on the card, each tick held against
    # the same entry point on the CPU from the card's state (one tick a call
    # for explore: the states of two float32 loops part by rounding, and at
    # K = 32, H = 128 that reaches 3.1e-3 in the controls by the third tick)
    for K, H in WIDE_CPU_SHAPES:
        tag = f"K{K}_H{H}"
        c, x0_, g_, gm_, dm_ = distinct_case(WIDE_S, dev, seed=5, num_basis=K, horizon=H)
        e_d, e_c = Engine(c, device=dev), Engine(c, device=cpu)
        w_d = e_d.prepare_world(g_)
        ph_d = e_d.phik_from_gmm(gm_, dm_, w_d)
        w_c, ph_c = moved(w_d, cpu), ph_d.cpu()
        sc_t = e_d.init_scenarios(x0_)
        ea, sa, wa, ga, da = wide_case(WIDE_S, dev, K, H)
        reset_counts()
        out_d = {"replan": e_d.replan(sc_t, ph_d, w_d)[1:],
                 "replan_refresh": ea.replan_refresh(sa, ga, da, wa)[1:]}
        ticks = []
        for _ in range(3):
            o_ = e_d.explore(sc_t, ph_d, w_d, 1)
            ticks.append((sc_t, o_))
            sc_t = o_.scenarios
        torch.cuda.synchronize()
        expect_counts(f"phase 21, replan + explore + replan_refresh at {tag}", read_counts(),
                      {"fused_solve_safety_map_h0_nb": 1 + 3, "fused_solve_safety": 1})
        ec = Engine(ea.config, device=cpu)
        same_tick(f"replan at {tag}", out_d["replan"],
                  e_c.replan(moved(ticks[0][0], cpu), ph_c, w_c)[1:])
        same_tick(f"replan_refresh at {tag}", out_d["replan_refresh"],
                  ec.replan_refresh(*(moved(t, cpu) for t in (sa, ga, da, wa)))[1:])
        for t, (sc_in, o_d) in enumerate(ticks):
            o_c = e_c.explore(moved(sc_in, cpu), ph_c, w_c, 1)
            same = same_tick(f"explore at {tag}, tick {t + 1} from the card's state",
                             (o_d.controls[0], o_d.diag._replace(
                                 **{f: getattr(o_d.diag, f)[0] for f in o_d.diag._fields})),
                             (o_c.controls[0], o_c.diag._replace(
                                 **{f: getattr(o_c.diag, f)[0] for f in o_c.diag._fields})))
            dx = (o_d.trajectory[0].cpu() - o_c.trajectory[0]).abs()[same].max().item()
            print(f"  explore at {tag}, tick {t + 1}: max |x_card - x_cpu| {dx:.3e} (atol 5e-5)")
            if dx > 5e-5:
                fail(f"phase 21: explore at {tag} on the card disagrees with the CPU")

    gmm_np, base_map, _, _ = node_case()
    stream = [[2.5 + 0.01 * i, 1.65 + 0.05 * i, 1.3] for i in range(NODE_CMP_TICKS)]
    out = {}
    for d in (dev, cpu):
        node = ExplorationNode(default_config("cart").replace(use_fused_solve=True, horizon=80),
                               target=GaussianMixture.create(*gmm_np), device=d)
        node.on_map(base_map, resolution=0.05)
        reset_counts()
        steps = []
        for pose in stream:
            node.on_odom(pose)
            steps.append(node.step())
        if d.type == "cuda":
            expect_counts("phase 21, the fused node at H=80", read_counts(),
                          {"fused_solve_safety_map_h0_nb": NODE_CMP_TICKS})
        out[d.type] = (np.stack([s_[0] for s_ in steps]),
                       np.array([[int(s_[1].collision_code), int(s_[1].dwa_active)]
                                 for s_ in steps]))
    du = np.abs(out[dev.type][0] - out["cpu"][0]).max()
    print(f"  the fused node at H=80: max |twist_card - twist_cpu| {du:.3e} (atol 5e-5) over "
          f"{NODE_CMP_TICKS} ticks; codes {out[dev.type][1][:, 0].tolist()} (card), "
          f"{out['cpu'][1][:, 0].tolist()} (CPU)")
    if du > 5e-5 or not np.array_equal(out[dev.type][1], out["cpu"][1]):
        fail("phase 21: the fused node at H=80 on the card disagrees with the CPU")


def graphs_phase(dev, card, S_big: int = S_MAIN, S_small: int = 512, ticks: int = EXPLORE_TICKS,
                 eager_ticks: int = 25, refreshes: int = MAP_REFRESHES) -> dict:
    """Phase 20: ``explore`` and ``explore_mapping_fused`` as graph replays
    against ``_explore_loop`` / ``_explore_mapping_fused_loop`` from one
    state: path B, path C, the omni case of phase 8 with the eager step,
    path D, path F and a short run of path Q's configuration. Fails when a
    graph run differs from the loop, a launch count is off, or the host's
    runtime calls exceed 10 a tick on path B or 20 a refresh on path F."""
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.tools import quality
    from ergodic_exploration_tpu_torch.utils import graphs

    print("== 20. the closed loops as CUDA graphs vs their plain loops", flush=True)
    # (name, graph run, plain loop, its units, unit name, a shorter plain
    # loop to profile, its units): timed and profiled at the end. The plain
    # loop's host calls are the same every tick, so its profile is kept short
    cases = []

    def explore_case(tag, cfg, x0, world_of, phik_of, n, want):
        eng = Engine(cfg, device=dev)
        world = world_of(eng)
        phik = phik_of(eng, world)
        sc = eng.init_scenarios(x0)
        runs = (lambda: eng.explore(sc, phik, world, n),
                lambda: eng._explore_loop(sc, phik, world, n))
        graph_case(tag, eng, *runs, want, n)
        (entry,) = eng._graphs._entries.values()
        nbytes = sum(t.numel() * t.element_size() for t in graphs.leaves(entry.buffers))
        full = events_ms(lambda: graphs.copy_leaves(graphs.leaves(entry.buffers),
                                                    graphs.leaves((sc, phik, world))), 5)
        print(f"  {tag}: the copy-in of (sc, phik, world) a call, {nbytes / 2**20:.1f} MiB: "
              f"{full:.4f} ms when every leaf is new; "
              f"{events_ms(lambda: entry.load((sc, phik, world)), 5):.4f} ms when none changed "
              f"(skipped by version) {card}")
        short = min(n, PROFILE_LOOP_TICKS)
        cases.append((tag, *runs, n, "tick",
                      lambda: eng._explore_loop(sc, phik, world, short), short))

    def distinct(S_, model="cart", seed=1, **kw):
        cfg, x0, grids, gmm, domain = distinct_case(S_, dev, model=model, seed=seed, **kw)
        return (cfg, x0, lambda e: e.prepare_world(grids),
                lambda e, w: e.phik_from_gmm(gmm, domain, w if cfg.use_fused_solve else None))

    explore_case(f"path B (K1 on distinct maps, S={S_big}, {ticks} ticks)", *distinct(S_big),
                 ticks, {"fused_solve_safety_map_h0_nb": ticks})
    eager_c = distinct(S_small, seed=3, use_fused_solve=False)
    explore_case(f"path C (default_config('cart'), eager, S={S_small}, {eager_ticks} ticks)",
                 *eager_c, eager_ticks, step_want(eager_c[0], eager_ticks))
    eager_o = distinct(S_small, model="omni", seed=2, use_fused_solve=False)
    explore_case(f"omni, eager, phase 8's case (S={S_small}, {eager_ticks} ticks)",
                 *eager_o, eager_ticks, step_want(eager_o[0], eager_ticks))
    rng = np.random.default_rng(4)
    x0_d = np.concatenate([rng.uniform(0.05, 4.95, (S_big, 2)),
                           rng.uniform(-np.pi, np.pi, (S_big, 1))], axis=1).astype(np.float32)
    gmm_d = GaussianMixture.create(np.full((S_big, 1, 2), 2.5, np.float32),
                                   np.tile((0.4 * np.eye(2, dtype=np.float32))[None, None],
                                           (S_big, 1, 1, 1)), device=dev)
    dom_d = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    cfg_d = default_config("cart").replace(use_fused_solve=True, enable_safety=False,
                                           shared_maps=True, shared_history_draw=True)
    explore_case(f"path D (fused_solve, empty world, S={S_big}, {eager_ticks} ticks)", cfg_d, x0_d,
                 lambda e: e.empty_world(dom_d, S_big), lambda e, w: e.phik_from_gmm(gmm_d, dom_d),
                 eager_ticks, {"fused_solve": eager_ticks})

    def mapping(tag, cfg, x0, truth, n_ref, every, want):
        eng = Engine(cfg, device=dev)
        sc = eng.init_scenarios(x0)

        def run(fn, n=n_ref):
            return lambda: dict(zip(("scenarios", "belief", "coverage", "trajectory", "metric"),
                                    fn(sc, truth, n, every, 1.5)))

        runs = (run(eng.explore_mapping_fused), run(eng._explore_mapping_fused_loop))
        graph_case(tag, eng, *runs, want, n_ref * every, maps=map_want(n_ref, n_ref),
                   dense=dense_want(n_ref))
        cases.append((tag, *runs, n_ref, "refresh", run(eng._explore_mapping_fused_loop, 1), 1))

    mapping(f"path F (explore_mapping_fused, S={S_big}, {refreshes} refreshes)",
            *mapping_case(S_big, dev), refreshes, MAP_EVERY,
            {"fused_solve_safety_map_h0_nb": refreshes * MAP_EVERY})
    cfg_q = default_config("omni")
    truth_q = quality.build_truth(Q_S, dev)
    mapping(f"path Q's configuration (default_config('omni'), S={Q_S}, 2 refreshes)", cfg_q,
            quality.spawn_poses(cfg_q, truth_q, Q_S), truth_q, 2, Q_EVERY,
            step_want(cfg_q, 2 * Q_EVERY))

    # times first, for every case, then the profiles: a profiler session
    # leaves its hooks behind, which slows the launches that follow it
    t0 = time.perf_counter()
    res = {}
    for tag, graph_run, loop_run, n, unit, _, _ in cases:
        res[tag] = {kind: dict(ms=events_ms(fn, 1) / n) for kind, fn in
                    (("graph", graph_run), ("loop", loop_run))}
    print(f"  (the cases timed in {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    for tag, graph_run, _, n_graph, unit, loop_short, n_short in cases:
        for kind, fn, n in (("graph", graph_run, n_graph), ("loop", loop_short, n_short)):
            calls, busy, wall = runtime_profile(fn)
            r = res[tag][kind]
            # busy: the profiled run's device ms a unit over the unprofiled ms
            r.update(calls=sum(calls.values()) / n, busy=busy / n / r["ms"])
            print(f"  {tag} {kind}: {r['ms']:.4f} ms a {unit}; host CUDA runtime calls "
                  f"{r['calls']:.2f} a {unit} over {n} ({calls}); device busy {busy / n:.4f} ms a "
                  f"{unit}: {100 * r['busy']:.1f} % of the unprofiled {unit}, "
                  f"{100 * busy / wall:.1f} % of the profiled run {card}", flush=True)
        g, lp = res[tag]["graph"], res[tag]["loop"]
        print(f"  {tag}: the graph's {unit} {g['ms']:.4f} ms vs the loop's {lp['ms']:.4f} ms; "
              f"host calls {g['calls']:.2f} vs {lp['calls']:.2f} a {unit}; device busy "
              f"{100 * g['busy']:.1f} % vs {100 * lp['busy']:.1f} % {card} (profiled in "
              f"{time.perf_counter() - t0:.1f} s so far)")
    b, f = res[cases[0][0]]["graph"], res[cases[4][0]]["graph"]
    if b["calls"] > 10 or f["calls"] > 20:
        fail(f"phase 20: the graphs made {b['calls']:.2f} host calls a tick on path B (limit 10) "
             f"and {f['calls']:.2f} a refresh on path F (limit 20)")
    return res


# ---------------------------------------------------------------------------
# phase 22: the single-tick entry points as CUDA graphs against their eager
# functions
# ---------------------------------------------------------------------------


def same_ticks(name: str, got, ref) -> None:
    """Fail unless the ticks ``got`` (graph route) equal ``ref`` (the eager
    function) bit for bit, leaf by leaf: the state, u and every diagnostic."""
    import torch

    for t, (g, r) in enumerate(zip(got, ref, strict=True)):
        for (k, a), (_, b) in zip(named_leaves(g), named_leaves(r), strict=True):
            if not (a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)):
                err = ((a.float() - b.float()).abs().max().item() if a.shape == b.shape
                       else float("inf"))
                fail(f"phase 22, {name}: tick {t} leaf {k} differs from the eager function "
                     f"(max |diff| {err:.3e})")
    print(f"  {name}: {len(got)} ticks equal to the eager function bit for bit in all "
          f"{len(named_leaves(got[0]))} leaves of (state, u, diagnostics) each")


def entry_case(name: str, engine, sc0, ins: dict, graph_step, eager_step, want: dict,
               mutate, card: str, evolve=None, ticks: int = ENTRY_TICKS, latency: bool = False,
               dense: dict = None):
    """One path of phase 22. ``graph_step(sc, ins)`` is the public entry
    point (a graph replay), ``eager_step(sc, ins)`` its eager function called
    by name; both return (sc, u, diag). From ``sc0``: ``ticks`` chained ticks
    of each (a pose advance between them, ``evolve(ins, sc)`` making the next
    tick's inputs when given), equal bit for bit, with exact launch counts on
    the call that captures and on the replays; a tick with the inputs
    unchanged; ``mutate(ins)``, an in-place change, and one more tick; the
    first call's outputs unchanged at the end. M's launches a tick are
    ``dense`` (none by default). Then, with only the scenarios
    changing: ms a tick by CUDA events and by host clock, the host's CUDA
    runtime calls a tick, and with ``latency`` the p50 / p99 from the call to
    the controls on the host, graphs against eager."""
    import torch

    from ergodic_exploration_tpu_torch.parallel import map_tree
    from ergodic_exploration_tpu_torch.utils import graphs

    def chain(step, n, sc, ins_):
        outs = []
        for _ in range(n):
            sc, u, d = step(sc, ins_)
            outs.append((sc, u, d))
            sc = advance(engine, sc, u)
            if evolve is not None:
                ins_ = evolve(ins_, sc)
        return outs, sc, ins_

    glue = glue_want(engine.config, 1, in_place=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    ref, sc_e, ins_e = chain(eager_step, ticks, sc0, dict(ins))
    torch.cuda.synchronize()
    dense = dense or {}
    expect_counts(f"phase 22, {name}, eager", read_counts(), {k: ticks * n for k, n in want.items()})
    expect_counts(f"phase 22, {name}, eager, M", read_dense(),
                  {k: ticks * n for k, n in dense.items()})
    eager_glue = read_glue()
    expect_counts(f"phase 22, {name}, eager, the glue", eager_glue,
                  glue_want(engine.config, ticks))
    note_launches(f"phase 22, {name}, eager", eager_glue)
    peak_e = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    captured = engine.graph_capture_s
    first, sc_g, ins_g = chain(graph_step, 1, sc0, dict(ins))
    torch.cuda.synchronize()
    capture_s = engine.graph_capture_s - captured
    expect_counts(f"phase 22, {name}, the call that captures", read_counts(), want)
    expect_counts(f"phase 22, {name}, the call that captures, M", read_dense(), dense)
    expect_counts(f"phase 22, {name}, the call that captures, the glue", read_glue(), glue)
    kept = map_tree(torch.clone, first[0])
    reset_counts()
    rest, sc_g, ins_g = chain(graph_step, ticks - 1, sc_g, ins_g)
    torch.cuda.synchronize()
    expect_counts(f"phase 22, {name}, replays only", read_counts(),
                  {k: (ticks - 1) * n for k, n in want.items()})
    expect_counts(f"phase 22, {name}, replays only, M", read_dense(),
                  {k: (ticks - 1) * n for k, n in dense.items()})
    expect_counts(f"phase 22, {name}, replays only, the glue", read_glue(),
                  {k: (ticks - 1) * n for k, n in glue.items()})
    peak_g = torch.cuda.max_memory_allocated() - base
    same_ticks(f"{name}, {ticks} chained ticks", first + rest, ref)
    # the inputs unchanged, then changed in place: each tick still equals
    # eager, and the change moved the eager tick (against the same tick on
    # the inputs before it)
    g1, e1 = graph_step(sc_g, ins_g), eager_step(sc_e, ins_e)
    same_ticks(f"{name}, one more tick, the inputs unchanged", [g1], [e1])
    before = eager_step(e1[0], ins_e)
    mutate(ins_g)
    mutate(ins_e)
    g2, e2 = graph_step(g1[0], ins_g), eager_step(e1[0], ins_e)
    same_ticks(f"{name}, one more tick after an in-place change to an input", [g2], [e2])
    if before[1].equal(e2[1]) and before[2].ergodic_metric.equal(e2[2].ergodic_metric):
        fail(f"phase 22, {name}: the in-place change moved neither u nor the metric")
    same_ticks(f"{name}, the first call's outputs after {ticks + 1} more calls", [first[0]],
               [kept])
    sc_e = e2[0]

    # only the scenarios change: timed and profiled, graphs against eager
    res = {}
    for kind, step in (("graphs", graph_step), ("eager", eager_step)):
        box = [sc_e]

        def one(step=step, box=box):
            box[0] = step(box[0], ins_e)[0]

        ev = events_ms(one, 20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            one()
        torch.cuda.synchronize()
        host = 1e3 * (time.perf_counter() - t0) / 20
        n = 10 if kind == "graphs" else PROFILE_LOOP_TICKS
        calls, busy, _ = runtime_profile(lambda: [one() for _ in range(n)])
        res[kind] = dict(ms=ev, host_ms=host, calls=sum(calls.values()) / n, busy=busy / n)
        if latency:
            lat, s = [], box[0]
            for _ in range(LATENCY_TICKS):
                t0 = time.perf_counter()
                s, u, _ = step(s, ins_e)
                u.cpu()
                lat.append(1e3 * (time.perf_counter() - t0))
            res[kind].update(p50=float(np.percentile(lat, 50)), p99=float(np.percentile(lat, 99)))
        res[kind]["by_name"] = calls
    g, e = res["graphs"], res["eager"]
    # the copy-out that keeps a call's outputs from the next replay (what a
    # second set of static buffers would save, at the cost of handing out
    # outputs that the call after next overwrites)
    copied = (g2[0].state, g2[1], g2[2])
    out_mib = sum(t.numel() * t.element_size() for t in tree_leaves(copied)) / 2**20
    g["copy_out_ms"] = events_ms(lambda: graphs.clone(copied), 20)
    print(f"  {name}: the copy-out of the state, u and diagnostics, {out_mib:.1f} MiB: "
          f"{g['copy_out_ms']:.4f} ms a tick {card}")
    print(f"  {name}: ms a tick by events {g['ms']:.4f} (graphs) vs {e['ms']:.4f} (eager), by "
          f"host clock {g['host_ms']:.4f} vs {e['host_ms']:.4f}; host CUDA runtime calls a tick "
          f"{g['calls']:.2f} vs {e['calls']:.2f} ({g['by_name']}); device busy "
          f"{g['busy']:.4f} vs {e['busy']:.4f} ms a tick (profiled); capture {capture_s:.3f} s; "
          f"peak device memory over the ticks above the inputs {peak_e / 2**20:.1f} MiB (eager) "
          f"-> {peak_g / 2**20:.1f} MiB (graphs) {card}", flush=True)
    if latency:
        print(f"  {name}: latency from the call to the controls on the host over "
              f"{LATENCY_TICKS} ticks: p50 {g['p50']:.4f} / p99 {g['p99']:.4f} ms (graphs) vs "
              f"p50 {e['p50']:.4f} / p99 {e['p99']:.4f} ms (eager) {card}")
    return res


def entry_graphs_phase(dev, card) -> dict:
    """Phase 22: ``replan``, ``replan_refresh`` and ``replan_refresh_mi`` as
    1-tick graph replays against their eager functions (``entry_case``):
    path A at S = 4096 and S = 1, path E (K3) at S = 4096 (a disc reveal
    between ticks) and S = 1, its dense path, its 200 x 200 row bands at S =
    1024, path C (``replan`` on the eager step, S = 512), path D
    (``fused_solve``), per-scenario maps with the history summed in K1
    (S = 4096) and ``replan_refresh`` with K2 ahead of K1 (S = 512). Fails
    on a difference, a launch count off, or more than 20 host runtime calls
    a tick on path A."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops import sensor
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    print("== 22. the single-tick entry points as CUDA graphs vs their eager functions",
          flush=True)
    out = {}

    def free():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

    # path A: replan_refresh, the refresh inside K1
    for S_ in (S_MAIN, 1):
        engine, sc, world, gmm, domain = build_engine(S_, dev)

        def bump(ins):  # part of the shared map's free mask closed, every row alike
            ins["world"].free_mask[:, :2000] = 0.0

        out[f"A{S_}"] = entry_case(
            f"path A (replan_refresh, S={S_})", engine, sc, dict(world=world),
            lambda s, i: engine.replan_refresh(s, gmm, domain, i["world"]),
            lambda s, i: engine._refresh_and_replan_fn(s, gmm, domain, i["world"]),
            {"fused_solve_safety": 1}, bump, card, latency=S_ == 1)
        del engine, sc, world, gmm
        free()
    for S_ in (S_MAIN, 1):
        if out[f"A{S_}"]["graphs"]["calls"] > 20:
            fail(f"phase 22: {out[f'A{S_}']['graphs']['calls']:.2f} host runtime calls a tick "
                 f"on path A at S={S_} as graphs (limit 20)")

    # path E: replan_refresh_mi with K3 (a disc reveal between ticks at S = 4096)
    def mi_path(tag, S_, cells, use_kernel, want, evolve, latency=False, dense=None):
        engine, sc, grids, truth, world, domain = mi_case(S_, dev, cells=cells)
        grids = grids._replace(data=grids.data.contiguous())
        c = cells

        def reveal(ins, s):
            return dict(belief=sensor.reveal(ins["belief"], truth, s.x, REVEAL_RANGE))

        def open_box(ins):  # a box of the unknown part becomes known free, in place
            ins["belief"].data[:, int(0.6 * c):int(0.7 * c), int(0.6 * c):int(0.7 * c)] = 0.0

        def step(fn):
            return lambda s, i: fn(s, i["belief"], world, MI_RADIUS, domain,
                                   use_mi_kernel=use_kernel)

        out[tag] = entry_case(
            f"path E ({'K3' if use_kernel else 'the dense path'}, {c} x {c}, S={S_})", engine, sc,
            dict(belief=grids), step(engine.replan_refresh_mi),
            step(engine._refresh_mi_and_replan_fn), want, open_box, card,
            evolve=reveal if evolve else None, latency=latency, dense=dense)
        free()

    k1 = {"fused_solve_safety": 1}
    mi_path(f"E{S_MAIN}", S_MAIN, 100, True, {"phik_from_grid_fc": 1, **k1}, True)
    mi_path("E1", 1, 100, True, {"phik_from_grid_fc": 1, **k1}, False, latency=True)
    mi_path("E-dense", S_MAIN, 100, False, k1, False, dense=dense_want(1))
    mi_path("E200", S_BIG, CELLS_BIG, True, {"phik_from_grid_fc_banded": 1, **k1}, False)

    # replan on given targets: C (the eager step), D (fused_solve, empty
    # world), per-scenario maps with the history summed in K1
    def replan_path(tag, name, cfg, x0, world_of, phik_of, want, mutate):
        engine = Engine(cfg, device=dev)
        world = world_of(engine)
        phik = phik_of(engine, world)
        out[tag] = entry_case(
            name, engine, engine.init_scenarios(x0), dict(world=world, phik=phik),
            lambda s, i: engine.replan(s, i["phik"], i["world"]),
            lambda s, i: engine._replan_fn(s, i["phik"], i["world"]), want, mutate, card)
        free()

    def flatten(ins):  # the target's coefficients past the first two rows zeroed
        ins["phik"][:, 2:] = 0.0

    def wall(ins):  # the target flattened and a wall more in every scenario's field
        flatten(ins)
        ins["world"].dist.dist[:, 40:46, 40:60] = 0.0

    cfg_c, x0_c, grids_c, gmm_c, dom_c = distinct_case(512, dev, seed=3, use_fused_solve=False)
    replan_path("C", "path C (replan, the eager step, S=512)", cfg_c, x0_c,
                lambda e: e.prepare_world(grids_c), lambda e, w: e.phik_from_gmm(gmm_c, dom_c),
                step_want(cfg_c, 1), wall)
    rng = np.random.default_rng(4)
    x0_d = np.concatenate([rng.uniform(0.05, 4.95, (S_MAIN, 2)),
                           rng.uniform(-np.pi, np.pi, (S_MAIN, 1))], axis=1).astype(np.float32)
    gmm_d = GaussianMixture.create(np.full((S_MAIN, 1, 2), 2.5, np.float32),
                                   np.tile((0.4 * np.eye(2, dtype=np.float32))[None, None],
                                           (S_MAIN, 1, 1, 1)), device=dev)
    dom_d = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    cfg_d = default_config("cart").replace(use_fused_solve=True, enable_safety=False,
                                           shared_maps=True, shared_history_draw=True)
    replan_path("D", f"path D (replan, fused_solve, empty world, S={S_MAIN})", cfg_d, x0_d,
                lambda e: e.empty_world(dom_d, S_MAIN), lambda e, w: e.phik_from_gmm(gmm_d, dom_d),
                {"fused_solve": 1}, flatten)
    cfg_b, x0_b, grids_b, gmm_b, dom_b = distinct_case(S_MAIN, dev)
    replan_path("B", f"per-scenario maps (replan, K1 with the history summed in it, "
                f"S={S_MAIN})", cfg_b, x0_b, lambda e: e.prepare_world(grids_b),
                lambda e, w: e.phik_from_gmm(gmm_b, dom_b, w),
                {"fused_solve_safety_map_h0_nb": 1}, wall)
    del grids_b, gmm_b

    # replan_refresh with K2 ahead of K1 (per-scenario maps: no refresh inside K1)
    cfg_k, x0_k, grids_k, gmm_k, dom_k = distinct_case(512, dev, seed=6)
    engine = Engine(cfg_k, device=dev)
    world_k = engine.prepare_world(grids_k)
    out["K2"] = entry_case(
        "replan_refresh with K2 ahead of K1 (per-scenario maps, S=512)", engine,
        engine.init_scenarios(x0_k), dict(world=world_k),
        lambda s, i: engine.replan_refresh(s, gmm_k, dom_k, i["world"]),
        lambda s, i: engine._refresh_and_replan_fn(s, gmm_k, dom_k, i["world"]),
        {"phik_from_gmm_masked": 1, "fused_solve_safety_map_h0_nb": 1},
        lambda i: i["world"].free_mask[:, :2000].zero_(), card)
    del engine, world_k
    free()
    return out


# ---------------------------------------------------------------------------
# phase 23: the tick's glue (G) against its plain versions
# ---------------------------------------------------------------------------


def with_plain_glue(fn):
    """``fn()`` with the glue's plain versions in its kernels' place: the
    tick with its glue as plain PyTorch ops (a graph captured inside it
    holds them)."""
    import ergodic_exploration_tpu_torch.ops.tick_glue as tg

    saved = tg.glue_pre, tg.glue_post
    tg.glue_pre, tg.glue_post = tg.glue_pre_plain, tg.glue_post_plain
    try:
        return fn()
    finally:
        tg.glue_pre, tg.glue_post = saved


def glue_pre_work(cfg, S: int, mode, H: int, nu: int, n_ring: int = 0):
    """(operations, bytes) of glue_pre for S scenarios: the split (20
    threefry rounds, ~100 integer operations), the guard and the warm reset
    (H nu selects); per drawn position two lowbias32 hashes and the index
    (~30); in mode "sums" per position, and in mode "full" per valid ring
    entry (``n_ring`` over the batch: what this run's counts need), 2 K
    angles and cosines (3 each) and K^2 fused multiply-adds (2 each). Bytes:
    the drawn ring entries (or the valid ones) and the guard's (2 floats),
    the pose, cursor, count (and the accumulate mode's hist_count), U, the
    domain and map geometry read once; the history, count, flag, warm start
    and patch start written once."""
    K = cfg.num_basis
    nb = (cfg.buffer_batch or 0) if mode in ("sums", "nb") else 0
    flops = S * (100 + H * nu + 30 * nb + (6 * K * nb + 2 * K * K * nb if mode == "sums" else 0))
    flops += n_ring * (6 * K + 2 * K * K) if mode == "full" else 0
    out = K * K if mode in ("sums", "full") else 2 * nb
    nbytes = S * (4 * (2 * nb + 2 + 3 + 2 + H * nu + 4 + 3) + 16)
    nbytes += 8 * n_ring if mode == "full" else 4 * S if mode == "accumulate" else 0
    nbytes += S * (4 * (out + (1 if mode else 0) + H * nu + 2) + 1)
    return flops, nbytes


def glue_post_work(cfg, S: int, H: int, nu: int, safety: bool, advance: bool,
                   in_place: bool = False):
    """(operations, bytes) of glue_post for S scenarios: the finiteness of
    U_new and the command (H nu + nu), the next key (~100 integer
    operations), the counters; with ``advance`` one RK4 step (6 sin / cos,
    ~40 more) and the twist. Bytes: U_new, the safety outputs, the ring (2
    cap floats; ``in_place``: none), its counters, the key and the pose read
    once; the shifted warm start, the new ring (``in_place``: the 2 floats of
    the cursor's slot), counters, key, command, code and flags (and the pose
    and twist) written once."""
    ring = 2 if in_place else 2 * cfg.buffer_capacity
    flops = S * (H * nu + nu + 110 + (50 if advance else 0))
    nbytes = S * (4 * (H * nu + (2 + nu if safety else 0) + (0 if in_place else ring) + 3 + 3)
                  + 16)
    nbytes += S * (4 * (H * nu + ring + 3 + nu + 1 + (6 if advance else 0)) + 16 + 3)
    return flops, nbytes


def kernel_profile(fn, units: int):
    """Run ``fn`` twice under ``torch.profiler`` and read the second run:
    (the device's operations a unit, kernels and copies alike, its busy ms a
    unit, the glue kernels' busy ms a unit, the largest items by device
    time). The first run inside the profiler is not read: the profiler was
    seen to miss device events of the first graph replays it traces (0.8 of
    a kernel a tick). A spin of the device (``torch.cuda._sleep``) between
    the two runs marks where the second starts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(dev) if "spin" in e.name or "sleep" in e.name]
    if not marks:
        fail("the profiler recorded no spin between the two runs")
    by_name = {}
    for e in dev[marks[-1] + 1:]:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    ops = sum(n for n, _ in by_name.values())
    busy = sum(us for _, us in by_name.values()) / 1e3
    glue = sum(us for k, (_, us) in by_name.items() if GLUE_KERNEL.match(k)) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return (ops / units, busy / units, glue / units,
            [(k[:60], n / units, us / 1e3 / units) for k, (n, us) in top])


def glue_phase(dev, card, entry, kernels) -> dict:
    """Phase 23: glue_pre and glue_post (G, csrc/tick_glue.cu) against their
    plain versions on the card, on the states paths A, B, D and E reach at
    S = 4096 and their first scenario (S = 1), and on path Q's omni state:
    keys, draws, drawn positions, orbit flags, warm starts, patch starts,
    codes, flags, rings, counters equal; the shared draw's sums within
    GLUE_SUM_ATOL; the advanced poses within 1e-6 and their twists equal.
    One tick of A and of B with the glue's plain versions in its place: U
    within 5e-5, metric and barrier within rtol 1e-5, the rest equal. Then
    the kernels a tick (copies included) of A's 1-tick ``replan_refresh``
    graph and of B's ``explore`` graph (fails past GLUE_KERNELS_A /
    GLUE_KERNELS_B). Adds the
    entries of the four variants those paths launch (the shared draw's sums
    with cuBLAS' bmm of their tables as the library column); returns the
    kernel counts."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    import ergodic_exploration_tpu_torch.ops.tick_glue as tg
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine, Scenarios
    from ergodic_exploration_tpu_torch.grid import Domain
    from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer
    from ergodic_exploration_tpu_torch.utils import prng
    from ergodic_exploration_tpu_torch.ops import basis
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.tools import quality

    print("== 23. the tick's glue (G) vs its plain versions; kernels a tick", flush=True)
    PRE_REPLACES = "ergodic_exploration_tpu/ops/solve_kernel.py:664"
    POST_REPLACES = "ergodic_exploration_tpu/ops/solve_kernel.py:919"

    def operands(cfg, sc, world, U_new, safety, fused=True):
        """(glue_pre's operands, glue_post's operands) on a path's state."""
        st, x = sc.state, sc.x.contiguous()
        dom = Domain(world.domain.origin.contiguous(), world.domain.lengths.contiguous())
        patch = None
        if fused:
            P = min(cfg.patch_cells, *world.dist.dist.shape[-2:])
            patch = tg.PatchGeometry(world.dist.origin.contiguous(),
                                     world.dist.resolution.contiguous(), P)
        pre = (cfg, tg.history_mode(cfg, fused), st.rng, st.buffer, st.U, x, dom, patch)
        post = (cfg, fused and cfg.shared_history_draw, U_new, safety, st.buffer, st.hist_count,
                st.rng, x)
        return pre, post

    def first(args):
        """The operands of scenario 0 alone (S = 1)."""
        def one(a):
            if isinstance(a, torch.Tensor):
                return a[:1].contiguous()
            if isinstance(a, (RingBuffer, Domain)):
                return type(a)(*(one(t) for t in a))
            if isinstance(a, tg.PatchGeometry):
                return a._replace(origin=one(a.origin), resolution=one(a.resolution))
            if isinstance(a, tuple):
                return tuple(one(t) for t in a)
            return a
        return tuple(one(a) for a in args)

    def equal(tag, what, a, b):
        if (a is None) != (b is None) or (a is not None and not (
                a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b))):
            fail(f"phase 23, {tag}: {what} of the kernel differs from the plain version")

    def check_pre(tag, args, full=None):
        """glue_pre against its plain version on ``args``. ``full``: the
        kernel's and the plain version's sums of these rows in the path's
        full batch. cuBLAS reduces a batch of one in another order than a
        batch of 4096, so the plain version's sums of a scenario move with
        the batch; the kernel's must not: at S = 1 they are held equal to the
        kernel's in the full batch and within GLUE_SUM_ATOL of the plain
        version's there, and the plain version's own move is printed."""
        k, p = tg.G.pre(*args), tg.glue_pre_plain(*args)
        torch.cuda.synchronize()
        for f in ("orbiting", "U", "pstart", "nh"):
            equal(tag, f"glue_pre {f}", getattr(k, f), getattr(p, f))
        mode, err = args[1], 0.0
        if mode == "nb":
            equal(tag, "glue_pre drawn positions", k.hist, p.hist.contiguous())
        elif mode == "sums":
            ref = p.hist if full is None else full[1]
            d = (k.hist - ref).abs()
            err = d.max().item()
            print(f"  {tag} glue_pre sums: max |kernel - plain| {err:.3e} (atol {GLUE_SUM_ATOL}), "
                  f"{int((d > 0).sum())} of {d.numel()} not bit-equal"
                  + ("" if full is None else
                     f" (the plain version in the full batch); the kernel's equal to its own in "
                     f"the full batch: {torch.equal(k.hist, full[0])}; the plain version at this "
                     f"batch moves by {(p.hist - full[1]).abs().max().item():.3e}, the kernel "
                     f"differs from it by {(k.hist - p.hist).abs().max().item():.3e}"))
            if err > GLUE_SUM_ATOL or (full is not None and not torch.equal(k.hist, full[0])):
                fail(f"phase 23, {tag}: the history sums are outside {GLUE_SUM_ATOL} or move "
                     f"with the batch")
        print(f"  {tag} glue_pre ({mode}): warm starts, patch starts, orbit flags "
              f"({int(k.orbiting.sum())} of {k.orbiting.numel()} set), counts"
              f"{', drawn positions' if mode == 'nb' else ''} equal")
        return err, k, p

    def own_ring(args):
        """``args`` with a copy of the ring in it: what the in-place append
        may write (a graph's static ring stands in for it)."""
        buf = args[4]
        return args[:4] + (buf._replace(states=buf.states.clone()),) + args[5:]

    def check_post(tag, args, advance):
        """The copying and the in-place glue_post against their plain
        versions: every output equal (the poses within 1e-6); the in-place
        kernel's ring is the copy it was given, equal to the copying
        kernel's new ring; the copying kernel leaves its input ring as it
        was."""
        ring_before = args[4].states.clone()
        k, p = tg.G.post(*args, advance), tg.glue_post_plain(*args, advance)
        ki_args, pi_args = own_ring(args), own_ring(args)
        ki = tg.G.post(*ki_args, advance, True)
        pi = tg.glue_post_plain(*pi_args, advance, True)
        torch.cuda.synchronize()
        dx = 0.0
        for what, kk, pp in (("", k, p), (" in place", ki, pi)):
            for f in ("U", "hist_count", "rng", "u", "code", "dwa_active", "feasible",
                      "diverged", "vb"):
                equal(tag, f"glue_post{what} {f}", getattr(kk, f), getattr(pp, f))
            for f, a, b in zip(RingBuffer._fields, kk.buffer, pp.buffer):
                equal(tag, f"glue_post{what} ring {f}", a, b)
            dx = max(dx, 0.0 if kk.x is None else (kk.x - pp.x).abs().max().item())
        equal(tag, "the in-place kernel's ring against the copying kernel's", ki.buffer.states,
              k.buffer.states)
        equal(tag, "the copying kernel's input ring after the call", args[4].states, ring_before)
        if ki.buffer.states is not ki_args[4].states or k.buffer.states is args[4].states:
            fail(f"phase 23, {tag}: the in-place append did not write the ring it was given, "
                 f"or the copying one did")
        if dx > 1e-6:
            fail(f"phase 23, {tag}: the advanced poses differ by {dx:.3e} (limit 1e-6)")
        print(f"  {tag} glue_post{' (advance)' if advance else ''}, copying and in place: "
              f"shifted warm starts, rings, counters, keys, commands, codes, flags "
              f"({int(k.dwa_active.sum())} DWA, {int(k.diverged.sum())} diverged) equal; the "
              f"in-place ring equal to the copy's"
              + (f"; poses max |diff| {dx:.3e}, twists equal" if advance else ""))
        return dx

    def guard_case(tag, post):
        """glue_post with NaN / inf put into a copy of U_new (and u_dwa)."""
        U_bad = post[2].clone()
        U_bad[::97, 3, 0] = float("nan")
        U_bad[5::211, 0, -1] = float("inf")
        safety = post[3]
        if safety is not None:
            u_dwa = safety[1].clone()
            u_dwa[7::101, 0] = float("-inf")
            safety = (safety[0], u_dwa, safety[2])
        return check_post(tag + ", NaN / inf injected", post[:2] + (U_bad, safety) + post[4:],
                          False)

    def wrap_case(tag, pre):
        """glue_pre on a copy of the ring that just wrapped (cursor < W, count
        = cap) with every other pose 1 cm from the pose W ticks back: the
        orbit guard's floor-mod read, and flags both set and clear."""
        cfg_, buf, x = pre[0], pre[3], pre[5]
        S_, cap = x.shape[0], buf.capacity
        W = min(cfg_.orbit_window, cap)
        cursor = (torch.arange(S_, device=x.device, dtype=torch.int32) % W).contiguous()
        back = ((cursor - W) % cap).long()
        prev = buf.states.gather(2, back[:, None, None].expand(S_, 2, 1))[..., 0]
        x2 = x.clone()
        x2[::2, :2] = prev[::2] + 0.01
        wrapped = RingBuffer(buf.states, cursor, torch.full_like(buf.count, cap))
        args = pre[:3] + (wrapped, pre[4], x2) + pre[6:]
        k = check_pre(tag + ", the ring just wrapped", args)[1]
        if not (k.orbiting[::2].all() and not k.orbiting[1::2].any()):
            fail(f"phase 23, {tag}: the orbit guard after a wrap set {int(k.orbiting.sum())} "
                 f"flags, expected every other one of {S_}")

    def k1_out(cfg, sc, world, phik=None, gmm=None, domain=None):
        inp, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, phik, world, gmm, domain)
        out = sk.K1(cfg, inp, enable_safety=cfg.enable_safety)
        return out.U_new, ((out.code, out.u_dwa, out.feasible) if cfg.enable_safety else None)

    def both(tag, pre, post, advance):
        wrap_case(f"{tag}, S={pre[5].shape[0]}", pre)
        e, k, p = check_pre(f"{tag}, S={pre[5].shape[0]}", pre)
        check_post(f"{tag}, S={pre[5].shape[0]}", post, advance)
        guard_case(f"{tag}, S={pre[5].shape[0]}", post)
        full = None if pre[1] != "sums" else (k.hist[:1], p.hist[:1])
        e1 = check_pre(f"{tag}, S=1", first(pre), full)[0]
        check_post(f"{tag}, S=1", first(post), advance)
        return max(e, e1)

    def tick_vs_plain_glue(tag, run):
        """One eager tick with the glue's kernels and with their plain versions."""
        k, p = run(), with_plain_glue(run)
        torch.cuda.synchronize()
        (ks, ku, kd), (ps, pu, pd) = k[:3], p[:3]
        dU = max((ks.state.U - ps.state.U).abs().max().item(), (ku - pu).abs().max().item())
        if dU > 5e-5:
            fail(f"phase 23, {tag}: U differs by {dU:.3e} from the tick on the plain glue")
        for f in ("ergodic_metric", "barrier_cost"):
            a, b = getattr(kd, f), getattr(pd, f)
            if not torch.allclose(a, b, rtol=1e-5, atol=1e-7):
                fail(f"phase 23, {tag}: {f} outside rtol 1e-5 of the tick on the plain glue")
        for f in ("collision_code", "dwa_active", "dwa_feasible", "diverged", "orbit_reset"):
            equal(tag, f, getattr(kd, f), getattr(pd, f))
        for f in ("rng", "hist_count"):
            equal(tag, f, getattr(ks.state, f), getattr(ps.state, f))
        bit = all(torch.equal(a, b) for a, b in zip(tree_leaves(k), tree_leaves(p)))
        print(f"  {tag}: one tick on the glue kernels vs on their plain versions: max |U diff| "
              f"{dU:.3e} (atol 5e-5); codes, flags, keys equal; "
              f"{'bit for bit in every leaf' if bit else 'not bit for bit'}")

    res = {}
    # path A: the bench tick (shared map, shared draw: the sums in glue_pre)
    engine, sc, world, gmm, domain = build_engine(S_MAIN, dev)
    for _ in range(3):
        sc, u, _ = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    cfg = engine.config
    U_new, safety = k1_out(cfg, sc, world, gmm=gmm, domain=domain)
    pre_a, post_a = operands(cfg, sc, world, U_new, safety)
    err_pre_a = both("path A", pre_a, post_a, False)
    tick_vs_plain_glue("path A tick (replan_refresh, eager)",
                       lambda: engine._refresh_and_replan_fn(sc, gmm, domain, world))
    entry("glue_pre_sums", "tick_glue.cu", PRE_REPLACES, err_pre_a,
          events_ms(lambda: tg.G.pre(*pre_a), 20), events_ms(lambda: tg.glue_pre_plain(*pre_a), 5),
          glue_pre_work(cfg, S_MAIN, "sums", cfg.horizon, cfg.nu))
    u = prng.uniform01(prng.split(pre_a[2][0])[1], cfg.buffer_batch)
    idx = torch.floor(u * torch.clamp(pre_a[3].count[0], min=1).float()).long()
    # the library column: one torch.bmm of the shared draw's (S, K, nb) x
    # (S, nb, K) cos tables, the product its sums are
    Cbx, Cby = basis.cos_tables(pre_a[3].states.index_select(2, idx).transpose(1, 2),
                                cfg.num_basis, pre_a[6])
    CbxT, Cby = Cbx.transpose(1, 2).contiguous(), Cby.contiguous()
    kernels["glue_pre_sums"]["library_ms"] = events_ms(lambda: torch.bmm(CbxT, Cby), 20)
    print(f"  glue_pre_sums: cuBLAS' bmm of the shared draw's (S, K, nb) x (S, nb, K) tables "
          f"alone {kernels['glue_pre_sums']['library_ms']:.4f} ms {card}")
    del Cbx, Cby, CbxT
    # the gather at the granularity of the memory system: the distinct
    # 32-byte sectors the shared draw reads from each ring's two rows
    sectors = 2 * int(torch.unique(idx // 8).numel())
    print(f"  glue_pre_sums: the gather reads {sectors} 32-byte sectors a scenario, "
          f"{S_MAIN * sectors * 32 / 2**20:.2f} MiB, {S_MAIN * sectors * 32 / PEAK_BYTES * 1e3:.5f} "
          f"ms at {PEAK_BYTES / 1e12:.2f} TB/s (the bound counts its 4-byte floats)")
    entry("glue_post", "tick_glue.cu", POST_REPLACES, 0.0,
          events_ms(lambda: tg.G.post(*post_a), 20),
          events_ms(lambda: tg.glue_post_plain(*post_a), 5),
          glue_post_work(cfg, S_MAIN, cfg.horizon, cfg.nu, True, False))
    own_a = own_ring(post_a)  # the in-place variant writes this copy's ring, call after call
    entry("glue_post_inplace", "tick_glue.cu", POST_REPLACES, 0.0,
          events_ms(lambda: tg.G.post(*own_a, False, True), 20),
          events_ms(lambda: tg.glue_post_plain(*own_a, False, True), 5),
          glue_post_work(cfg, S_MAIN, cfg.horizon, cfg.nu, True, False, in_place=True))
    pre1, post1 = first(pre_a), first(post_a)
    own1 = own_ring(post1)
    print(f"  glue_pre at S=1: {events_ms(lambda: tg.G.pre(*pre1), 50):.4f} ms/call; "
          f"glue_post at S=1: {events_ms(lambda: tg.G.post(*post1), 50):.4f} ms/call, in place "
          f"{events_ms(lambda: tg.G.post(*own1, False, True), 50):.4f} ms/call {card}")
    # the kernels a tick of A's 1-tick replan_refresh graph (the entry point,
    # its copies in and out included)
    box = [sc]

    def tick_a(n=10):
        for _ in range(n):
            box[0] = engine.replan_refresh(box[0], gmm, domain, world)[0]

    tick_a(3)
    res["A"] = kernel_profile(tick_a, 10)
    del engine, sc, world, pre_a, post_a, own_a, U_new, safety
    torch.cuda.empty_cache()

    # path B: explore on distinct maps (per-scenario draws, the advance)
    cfg_b, x0_b, grids_b, gmm_b, dom_b = distinct_case(S_MAIN, dev)
    eng_b = Engine(cfg_b)
    world_b = eng_b.prepare_world(grids_b)
    phik_b = eng_b.phik_from_gmm(gmm_b, dom_b, world_b)
    sc_b = eng_b.explore(eng_b.init_scenarios(x0_b), phik_b, world_b, 3).scenarios
    U_new, safety = k1_out(cfg_b, sc_b, world_b, phik=phik_b)
    pre_b, post_b = operands(cfg_b, sc_b, world_b, U_new, safety)
    err_pre_b = both("path B", pre_b, post_b, True)
    err_post_b = check_post("path B, S=4096, the entry's check", post_b, True)
    def tick_b():
        st, x1, vb1, u_, d_ = eng_b._tick_batched(sc_b.state, sc_b.x, sc_b.vb, phik_b, world_b)
        return Scenarios(st, x1, vb1), u_, d_

    tick_vs_plain_glue("path B tick (explore's tick with its advance, eager)", tick_b)
    entry("glue_pre_nb", "tick_glue.cu", PRE_REPLACES, err_pre_b,
          events_ms(lambda: tg.G.pre(*pre_b), 20), events_ms(lambda: tg.glue_pre_plain(*pre_b), 5),
          glue_pre_work(cfg_b, S_MAIN, "nb", cfg_b.horizon, cfg_b.nu))
    entry("glue_post_advance", "tick_glue.cu", POST_REPLACES, err_post_b,
          events_ms(lambda: tg.G.post(*post_b, True), 20),
          events_ms(lambda: tg.glue_post_plain(*post_b, True), 5),
          glue_post_work(cfg_b, S_MAIN, cfg_b.horizon, cfg_b.nu, True, True))
    own_b = own_ring(post_b)
    entry("glue_post_advance_inplace", "tick_glue.cu", POST_REPLACES, err_post_b,
          events_ms(lambda: tg.G.post(*own_b, True, True), 20),
          events_ms(lambda: tg.glue_post_plain(*own_b, True, True), 5),
          glue_post_work(cfg_b, S_MAIN, cfg_b.horizon, cfg_b.nu, True, True, in_place=True))
    box_b = [sc_b]

    def ticks_b():
        box_b[0] = eng_b.explore(box_b[0], phik_b, world_b, 10).scenarios

    ticks_b()
    res["B"] = kernel_profile(ticks_b, 10)
    del eng_b, world_b, phik_b, sc_b, grids_b, pre_b, post_b, own_b, U_new, safety
    torch.cuda.empty_cache()

    # path D: fused_solve on one shared empty map (the sums, safety off)
    rng = np.random.default_rng(4)
    x0_d = np.concatenate([rng.uniform(0.05, 4.95, (S_MAIN, 2)),
                           rng.uniform(-np.pi, np.pi, (S_MAIN, 1))], axis=1).astype(np.float32)
    gmm_d = GaussianMixture.create(np.full((S_MAIN, 1, 2), 2.5, np.float32),
                                   np.tile((0.4 * np.eye(2, dtype=np.float32))[None, None],
                                           (S_MAIN, 1, 1, 1)), device=dev)
    dom_d = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    cfg_d = default_config("cart").replace(use_fused_solve=True, enable_safety=False,
                                           shared_maps=True, shared_history_draw=True)
    eng_d = Engine(cfg_d)
    world_d = eng_d.empty_world(dom_d, S_MAIN)
    phik_d = eng_d.phik_from_gmm(gmm_d, dom_d)
    sc_d = eng_d.explore(eng_d.init_scenarios(x0_d), phik_d, world_d, 3).scenarios
    both("path D", *operands(cfg_d, sc_d, world_d, *k1_out(cfg_d, sc_d, world_d, phik=phik_d)),
         True)
    del eng_d, world_d, phik_d, sc_d
    torch.cuda.empty_cache()

    # path E: the MI tick (K3 ahead of K1; the sums)
    eng_e, sc_e, belief, truth, world_e, dom_e = mi_case(S_MAIN, dev)
    for _ in range(2):
        sc_e, u, _ = eng_e.replan_refresh_mi(sc_e, belief, world_e, MI_RADIUS, dom_e,
                                             use_mi_kernel=True)
        sc_e = advance(eng_e, sc_e, u)
    phik_e = eng_e._phik_grid_kernel(belief, dom_e, MI_RADIUS)
    both("path E", *operands(eng_e.config, sc_e, world_e,
                             *k1_out(eng_e.config, sc_e, world_e, phik=phik_e)), False)
    del eng_e, sc_e, belief, truth, world_e, phik_e
    torch.cuda.empty_cache()

    # path Q's state: default_config("omni"), the eager step (per-scenario
    # draws, no patch start), one refresh of its loop; the safety stage on it
    cfg_q = default_config("omni")
    eng_q = Engine(cfg_q)
    truth_q = quality.build_truth(Q_S, dev)
    sc_q, belief_q, _, _, _ = eng_q.explore_mapping_fused(
        eng_q.init_scenarios(quality.spawn_poses(cfg_q, truth_q, Q_S)), truth_q, 1, Q_EVERY)
    world_q = eng_q.prepare_world(belief_q)
    P = min(cfg_q.patch_cells, *world_q.dist.dist.shape[-2:])
    crop = extract_patch(world_q.dist, sc_q.x[:, :2], P).center_crop(cfg_q.safety_patch_cells)
    U_q = sc_q.state.U
    safety_q = sk.fused_safety(cfg_q, sc_q.x.contiguous(), sc_q.vb.contiguous(),
                               U_q[:, 0].contiguous(), crop.dist.contiguous(),
                               crop.start.to(torch.int32), crop.origin.contiguous(),
                               crop.resolution.contiguous(), world_q.domain.origin.contiguous(),
                               world_q.domain.lengths.contiguous())
    pre_q, post_q = operands(cfg_q, sc_q, world_q, U_q, safety_q, fused=False)
    check_pre(f"path Q (omni, eager), S={Q_S}", pre_q)
    check_post(f"path Q (omni, eager), S={Q_S}", post_q, True)
    guard_case(f"path Q (omni, eager), S={Q_S}", post_q)
    del eng_q, truth_q, sc_q, belief_q, world_q, crop

    for path, limit in (("A", GLUE_KERNELS_A), ("B", GLUE_KERNELS_B)):
        n, busy, glue, top = res[path]
        what = (f"A's 1-tick replan_refresh graph (copies in and out included), S={S_MAIN}"
                if path == "A" else f"B's explore graph (10 ticks a replay), S={S_MAIN}")
        print(f"  {what}: {n:.1f} kernels and copies a tick (limit {limit}), device busy "
              f"{busy:.4f} ms a tick, of which the glue {glue:.4f} ms "
              f"({100 * glue / max(busy, 1e-9):.1f} %) {card}")
        for name, cnt, ms in top:
            print(f"     {ms:9.4f} ms  x{cnt:5.1f}  {name}")
        if n > limit:
            fail(f"phase 23: {what} runs {n:.1f} kernels a tick (limit {limit})")
    return res


# ---------------------------------------------------------------------------
# phase 24: the map kernels (the reveal R and the world rebuild E) against
# their plain versions
# ---------------------------------------------------------------------------

REVEAL_RANGES = (0.75, 1.5, 3.0)  # phase 24: sensor ranges (m) of the reveal cases
MAP_BIG_S, MAP_HUGE = 1024, (4, 512, 512)  # phase 24: 200 x 200 maps; maps past shared memory


def reveal_work(belief, truth, pose, win: int, n_bins: int, thr: float, sensor_range: float):
    """(flops, bytes) of the reveal on these inputs, as any implementation
    must do it: per window cell that names a map cell of its own (an
    edge-clamped duplicate adds nothing) ~25 operations (its centre, radius,
    atan2, bin and step, each counted as one); per occupied one that can hide
    a cell in range (its step under rint(range / res) + 2) ~8 more (its
    half-width) and ~8 for each bin its interval covers (2 round(half_w /
    bin width) + 1: this run's data decides how many); per map cell 1 (the
    output's select). Bytes: the beliefs read and written once, the truth at
    those window cells, the poses, geometry and bin centres."""
    import torch

    B, h, w = belief.data.shape
    P = min(win, h, w)
    res, origin = belief.resolution, belief.origin
    start = torch.round((pose[:, :2] - origin) / res[:, None] - 0.5).long() - P // 2
    ii = torch.arange(P, device=pose.device)
    rows = torch.clamp(start[:, 1:2] + ii, 0, h - 1)
    cols = torch.clamp(start[:, 0:1] + ii, 0, w - 1)

    def firsts(idx):  # the first window index of each map index
        return torch.cat([torch.ones_like(idx[:, :1], dtype=torch.bool),
                          idx[:, 1:] != idx[:, :-1]], dim=1)

    own = firsts(rows)[:, :, None] & firsts(cols)[:, None, :]
    bi = torch.arange(B, device=pose.device)[:, None, None]
    occ = truth.data[bi, rows[:, :, None], cols[:, None, :]] >= thr
    dx = (origin[:, 0:1] + (cols.float() + 0.5) * res[:, None])[:, None, :] - pose[:, 0, None, None]
    dy = (origin[:, 1:2] + (rows.float() + 0.5) * res[:, None])[:, :, None] - pose[:, 1, None, None]
    rc = torch.sqrt(dx * dx + dy * dy) / res[:, None, None]
    near = torch.round(rc) < torch.ceil(sensor_range / res)[:, None, None] + 1
    blockers = own & occ & near
    half = torch.atan(0.55 / torch.clamp(rc, min=0.5))
    tests = torch.clamp(2 * torch.round(half * n_bins / (2 * np.pi)) + 1, max=n_bins)
    cells = own.sum().item()
    flops = cells * 25 + blockers.sum().item() * 8 + tests[blockers].sum().item() * 8 + B * h * w
    return flops, 4 * (2 * B * h * w + cells + 5 * B + n_bins)


def edt_work(S: int, h: int, w: int, n_mask: int = 0):
    """(flops, bytes) of the world rebuild of S (h, w) maps, counted as an
    exact O(h w) transform does it, whatever kernel implements it: per cell ~4
    operations to mark it, ~6 for its distance along the row (two sweeps), ~12
    for the lower envelope along its column (its parabola pushed and popped
    at most once, an intersection compared each way), ~4 to finish (sqrt,
    product, test) and ~8 for the gradient (two differences, two divisions);
    with the free mask ~8 a lattice point (its cell, the test). Bytes: the
    maps read and dist and grad written once, the resolutions; with the mask
    its S n_mask floats written, the origins and lengths."""
    cells = S * h * w
    flops = cells * 34 + S * n_mask * 8
    return flops, 4 * (4 * cells + S) + (4 * S * (n_mask + 6) if n_mask else 0)


def map_kernels_phase(dev, card, entry, f_run) -> None:
    """Phase 24: the reveal kernel cell for cell and the world-rebuild
    kernel bit for bit against their plain versions on the card; each case
    twice, the two launches equal bit for bit. The reveal: F's beliefs over
    its five refreshes (the poses each refresh revealed from, ending at F's
    final belief), S = 1 (batched and one map), poses at the maps' edges and
    corners, sensor ranges 0.75, 1.5 and 3.0 m, 97 bins, the tables in
    device memory (the layout past the shared memory's), a 40 x 40 map under
    the window, 200 x 200 beliefs (S = 1024). E, the distance field alone
    (``DistanceField.from_grid``) and with the free mask (``world_fields``,
    ``Engine._world_batched``'s): B's 4096 distinct maps, F's beliefs, a
    domain other than the maps' extent, an empty map, a full one, 60 x 140,
    200 x 200 and 512 x 512 maps (the global-memory form); the node without
    the native EDT (one E launch a map update). Adds the entries of R and of
    E with and without the mask, timed and bounded on path F's inputs."""
    import torch

    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops import edt_kernel as ek
    from ergodic_exploration_tpu_torch.ops import reveal_kernel as rk
    from ergodic_exploration_tpu_torch.ops import sensor
    from ergodic_exploration_tpu_torch.ops.distance import FAR, DistanceField

    print("== 24. the map kernels vs their plain versions: the reveal (R) cell for cell, the "
          "world rebuild (E) bit for bit", flush=True)
    truth, thr, win, gs = f_run["truth"], f_run["thr"], f_run["win"], f_run["grid_samples"]
    errs = {"reveal": 0.0, "edt": 0.0, "world": 0.0}

    def reveal_case(name, belief, truth_, pose, rng_m=1.5, n_bins=256):
        w_ = sensor.raycast_window_cells(rng_m, float(belief.resolution.min()))
        args = (belief, truth_, pose, rng_m, w_, n_bins, thr)
        k, again = sensor.reveal_raycast(*args), sensor.reveal_raycast(*args)
        p = sensor.reveal_raycast_plain(*args)
        torch.cuda.synchronize()
        n_diff = int((k.data != p.data).sum())
        seen = int(((k.data != -1.0) & (belief.data == -1.0)).sum())
        print(f"  reveal, {name}: {n_diff} of {p.data.numel()} cells differ from the plain "
              f"version; two launches equal: {torch.equal(k.data, again.data)}; "
              f"{seen} cells newly seen")
        if n_diff or not torch.equal(k.data, again.data) or seen == 0:
            fail(f"phase 24: the reveal kernel, {name}, disagrees with its plain version")
        errs["reveal"] = max(errs["reveal"], (k.data - p.data).abs().max().item())
        return k

    def edt_case(name, grid):
        k, again = DistanceField.from_grid(grid, thr), DistanceField.from_grid(grid, thr)
        d, g = ek.edt_field_plain(grid.data, grid.resolution, thr)
        torch.cuda.synchronize()
        same = torch.equal(k.dist, d) and torch.equal(k.grad, g)
        twice = torch.equal(k.dist, again.dist) and torch.equal(k.grad, again.grad)
        print(f"  EDT, {name}: dist and grad equal to the plain version bit for bit: {same}; two "
              f"launches equal: {twice}; FAR cells {int((k.dist >= FAR).sum())} of "
              f"{k.dist.numel()}")
        if not (same and twice):
            fail(f"phase 24: the EDT kernel, {name}, differs from its plain version")
        errs["edt"] = max(errs["edt"], (k.dist - d).abs().max().item(),
                          (k.grad - g).abs().max().item())
        return k

    def world_case(name, grid, dom=None):
        dom = grid.domain() if dom is None else dom
        k, again = ek.world_fields(grid, dom, thr, gs), ek.world_fields(grid, dom, thr, gs)
        p = ek.world_plain(grid, dom, thr, gs)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(k, p)]
        twice = all(torch.equal(a, b) for a, b in zip(k, again))
        print(f"  E with the free mask, {name}: dist, grad, mask equal to the plain version bit "
              f"for bit: {same}; two launches equal: {twice}; free lattice points "
              f"{int(k[2].sum())} of {k[2].numel()}")
        if not (all(same) and twice):
            fail(f"phase 24: E with the free mask, {name}, differs from its plain version")
        errs["world"] = max([errs["world"]] + [(a - b).abs().max().item() for a, b in zip(k, p)])

    ek.E.reset_launches()
    # the reveal along path F, and E on each of its beliefs
    belief = truth._replace(data=torch.full_like(truth.data, -1.0))
    for r, x in enumerate(f_run["x"]):
        prev = belief
        belief = reveal_case(f"path F refresh {r + 1}, S={S_MAIN}", belief, truth, x)
        edt_case(f"path F's belief after refresh {r + 1}", belief)
        world_case(f"path F's belief after refresh {r + 1}", belief)
    if not torch.equal(belief.data, f_run["belief"]):
        fail("phase 24: the reveals from path F's poses do not end at path F's belief")
    print("  the five reveals from path F's poses end at path F's final belief, bit for bit")
    dom_f = belief.domain()
    world_case("path F's final belief, a domain 0.37 m wider on each side (points clamp)",
               belief, Domain(dom_f.origin - 0.37, dom_f.lengths + 0.74))
    x_last = f_run["x"][-1]
    r_ms = events_ms(lambda: sensor.reveal_raycast(prev, truth, x_last, 1.5, win,
                                                   occupied_threshold=thr), 20)
    r_plain = events_ms(lambda: sensor.reveal_raycast_plain(prev, truth, x_last, 1.5, win,
                                                            occupied_threshold=thr), 2)
    entry("reveal_raycast", "reveal_kernel.cu", "ergodic_exploration_tpu/ops/sensor.py:50",
          errs["reveal"], r_ms, r_plain, reveal_work(prev, truth, x_last, win, 256, thr, 1.5))
    S_f, h_f, w_f = belief.data.shape
    n_f = int(np.prod(gs))
    w_ms = events_ms(lambda: ek.world_fields(belief, dom_f, thr, gs), 20)
    w_plain = events_ms(lambda: ek.world_plain(belief, dom_f, thr, gs), 2)
    entry("world", "edt_kernel.cu", "ergodic_exploration_tpu/engine.py:288", errs["world"],
          w_ms, w_plain, edt_work(S_f, h_f, w_f, n_f))
    e_ms = events_ms(lambda: DistanceField.from_grid(belief, thr), 20)
    e_plain = events_ms(lambda: ek.edt_field_plain(belief.data, belief.resolution, thr), 2)
    entry("edt", "edt_kernel.cu", "ergodic_exploration_tpu/ops/distance.py:43", errs["edt"],
          e_ms, e_plain, edt_work(S_f, h_f, w_f))

    # S = 1, an unknown belief: batched and one map
    t1 = GridMap(truth.data[:1], truth.origin[:1], truth.resolution[:1])
    one = t1._replace(data=torch.full_like(t1.data, -1.0))
    reveal_case("S=1", one, t1, x_last[:1])
    reveal_case("one (h, w) map", GridMap(one.data[0], one.origin[0], one.resolution[0]),
                GridMap(t1.data[0], t1.origin[0], t1.resolution[0]), x_last[0])
    f1 = GridMap(belief.data[:1], belief.origin[:1], belief.resolution[:1])
    r1_ms = events_ms(lambda: sensor.reveal_raycast(one, t1, x_last[:1], 1.5, win), 50)
    e1_ms = events_ms(lambda: DistanceField.from_grid(one, thr), 50)
    w1_ms = events_ms(lambda: ek.world_fields(f1, f1.domain(), thr, gs), 50)
    print(f"  at S=1: the reveal kernel {r1_ms:.4f} ms, E on an unknown (empty) map {e1_ms:.4f} "
          f"ms, E with the mask on F's first final belief {w1_ms:.4f} ms {card}")
    # poses on the edges and at the corners (clamped windows), some past the map
    rng = np.random.default_rng(24)
    side = rng.integers(0, 4, S_MAIN)
    along = rng.uniform(-0.2, 5.2, S_MAIN)
    off = rng.uniform(-0.1, 0.06, S_MAIN)
    edge = np.stack([np.where(side == 0, off, np.where(side == 1, 5.0 - off, along)),
                     np.where(side == 2, off, np.where(side == 3, 5.0 - off, along)),
                     rng.uniform(-np.pi, np.pi, S_MAIN)], axis=1).astype(np.float32)
    edge[:4, :2] = [[0.01, 0.01], [4.99, 0.01], [0.01, 4.99], [4.99, 4.99]]
    reveal_case("poses on the edges and corners", prev, truth, torch.from_numpy(edge).to(dev))
    for rng_m in REVEAL_RANGES:
        reveal_case(f"sensor range {rng_m} m", prev, truth, x_last, rng_m=rng_m)
    reveal_case("97 bins", prev, truth, x_last, n_bins=97)
    rk.R.smem_limit = 0  # the tables in device memory, as past the shared memory's
    try:
        rk.R.reset_launches()
        reveal_case("the tables in device memory", prev, truth, x_last)
        if rk.R.launches["reveal_raycast_global"] != 2:
            fail(f"phase 24: the reveal did not take its global tables: {rk.R.launches}")
    finally:
        rk.R.smem_limit = sk.MAX_SMEM
    n = min(512, S_MAIN)
    small = GridMap(truth.data[:n, 30:70, 30:70].contiguous(), truth.origin[:n],
                    truth.resolution[:n])
    xs = torch.from_numpy(np.concatenate([rng.uniform(0.1, 1.9, (n, 2)),
                                          rng.uniform(-3, 3, (n, 1))], 1).astype(np.float32))
    reveal_case(f"40 x 40 maps under the 63-cell window, S={n}",
                small._replace(data=torch.full_like(small.data, -1.0)), small, xs.to(dev))
    big = GridMap(truth.data[:MAP_BIG_S].repeat(1, 2, 2).contiguous(),
                  truth.origin[:MAP_BIG_S], truth.resolution[:MAP_BIG_S])
    xb = torch.from_numpy(np.concatenate([rng.uniform(0.3, 9.7, (MAP_BIG_S, 2)),
                                          rng.uniform(-3, 3, (MAP_BIG_S, 1))],
                                         1).astype(np.float32)).to(dev)
    big_belief = reveal_case(f"200 x 200 beliefs, S={MAP_BIG_S}",
                             big._replace(data=torch.full_like(big.data, -1.0)), big, xb)
    print(f"  the reveal on 200 x 200 beliefs, S={MAP_BIG_S}: "
          f"{events_ms(lambda: sensor.reveal_raycast(big_belief, big, xb, 1.5, win), 20):.4f} ms "
          f"{card}")

    # E on the other maps
    _, _, grids_b, _, _ = distinct_case(S_MAIN, dev)
    edt_case(f"path B's {S_MAIN} distinct maps", grids_b)
    world_case(f"path B's {S_MAIN} distinct maps", grids_b)
    e_b = events_ms(lambda: DistanceField.from_grid(grids_b, thr), 20)
    e_b_plain = events_ms(lambda: ek.edt_field_plain(grids_b.data, grids_b.resolution, thr), 2)
    w_b = events_ms(lambda: ek.world_fields(grids_b, grids_b.domain(), thr, gs), 20)
    print(f"  E on path B's maps {e_b:.4f} ms, plain {e_b_plain:.3f} ms; with the free mask "
          f"{w_b:.4f} ms {card}")
    z = GridMap(torch.full((16, 100, 100), -1.0, device=dev), torch.zeros(16, 2, device=dev),
                torch.full((16,), 0.05, device=dev))
    f = edt_case("an empty map", z)
    if not ((f.dist == FAR).all() and (f.grad == 0).all()):
        fail("phase 24: the EDT of an empty map is not FAR with a zero gradient")
    f = edt_case("a map that is all obstacle", z._replace(data=torch.ones_like(z.data)))
    if not (f.dist == 0).all():
        fail("phase 24: the EDT of a full map is not 0")
    wide = torch.as_tensor(rng.uniform(size=(64, 60, 140)) > 0.99, dtype=torch.float32,
                           device=dev)
    edt_case("60 x 140 maps", GridMap(wide, torch.zeros(64, 2, device=dev),
                                      torch.full((64,), 0.05, device=dev)))
    edt_case(f"200 x 200 beliefs, S={MAP_BIG_S}", big_belief)
    world_case(f"200 x 200 beliefs, S={MAP_BIG_S}", big_belief)
    e_big = events_ms(lambda: DistanceField.from_grid(big_belief, thr), 20)
    w_big = events_ms(lambda: ek.world_fields(big_belief, big_belief.domain(), thr, gs), 20)
    print(f"  E on 200 x 200 maps, S={MAP_BIG_S}: {e_big:.4f} ms, with the mask {w_big:.4f} ms "
          f"{card}")
    S_h, h_h, w_h = MAP_HUGE
    huge = torch.as_tensor(rng.uniform(size=MAP_HUGE) > 0.999, dtype=torch.float32, device=dev)
    huge[0, 5, 7] = float("nan")  # neither occupied nor free
    huge_g = GridMap(huge, torch.zeros(S_h, 2, device=dev), torch.full((S_h,), 0.05, device=dev))
    edt_case(f"{h_h} x {w_h} maps, S={S_h} (the plane in device memory)", huge_g)
    world_case(f"{h_h} x {w_h} maps, S={S_h}, a NaN cell (the plane in device memory)", huge_g)
    if ek.E.launches["edt_global"] != 2 or ek.E.launches["world_global"] != 2:
        fail(f"phase 24: the {h_h} x {w_h} maps did not take the global-memory form: "
             f"{ek.E.launches}")

    # the node without the native runtime rebuilds its field through from_grid
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.node import ExplorationNode
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture

    gmm_np, base_map, _, start = node_case()
    node = ExplorationNode(default_config("cart"), target=GaussianMixture.create(*gmm_np),
                           use_native=False)
    node.on_map(base_map)
    node.on_odom(start)
    ek.E.reset_launches()
    twist, _ = node.step()
    torch.cuda.synchronize()
    print(f"  the node without the native EDT: a map update launched {dict(ek.E.launches)}; "
          f"twist {np.round(twist, 4).tolist()}")
    if (ek.E.launches != {**dict.fromkeys(ek.E.VARIANTS, 0), "edt": 1}
            or not np.isfinite(twist).all()):
        fail("phase 24: the node's map update did not go through the EDT kernel once")


def dense_phase(dev, card, entry, kernels, e_run: dict, f_run: dict) -> None:
    """Phase 25: M against its plain version on the card (``dense_check``):
    path F's beliefs (S = 4096, r = 0, fc = 3) and their first scenario
    alone, path E's (r = 3 with fc = 3 and fc = 0), 200 x 200 beliefs at
    S = 1024 (also in every placement of its tables past the plan's), a 60 x 140 map with a
    48 x 64 lattice and K = 12 (two tiles of coefficients), K = 17 on path E's
    beliefs (three tiles: the values once, then a contraction a tile; also
    through the engine, the kernels line's entry), all-unknown
    beliefs (every scenario the fallback) and fully known maps (path F's
    true maps)."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap

    print("== 25. M, the dense MI target, vs its plain version", flush=True)

    def maps(data, res=0.05):
        S_ = data.shape[0]
        return GridMap(data, torch.zeros((S_, 2), device=dev), torch.full((S_,), res, device=dev))

    def case(name, eng, grids, dom, r, **kw):
        c = eng.config
        return dense_check(name, grids.data.contiguous(), eng._dense_ops(grids, dom), r,
                           c.mi_frontier_cells, c.occupied_threshold, card, **kw)

    rows = {}
    cfg_f, dom_f, truth_f = f_run["cfg"], f_run["dom"], f_run["truth"]
    eng_f = Engine(cfg_f)
    belief_f = truth_f._replace(data=f_run["belief"])
    rows["F, S=4096, r=0, fc=3"] = case("path F's beliefs", eng_f, belief_f, dom_f, 0)
    one = GridMap(*(t[:1].contiguous() for t in belief_f))
    rows["F, S=1"] = case("path F's first scenario", eng_f, one, dom_f, 0, reps=200)
    grids_e = GridMap(e_run["data"], e_run["origin"], e_run["resolution"])
    for fc in (3, 0):
        eng_e = Engine(e_run["cfg"].replace(mi_frontier_cells=fc))
        rows[f"E, S=4096, r=3, fc={fc}"] = case(f"path E's beliefs, fc={fc}", eng_e, grids_e,
                                                e_run["domain"], MI_RADIUS)
    eng_17 = Engine(e_run["cfg"].replace(num_basis=17))
    rows["E, K=17 (three tiles of k1)"] = d17 = case(
        "path E's beliefs, K=17", eng_17, grids_e, e_run["domain"], MI_RADIUS, reps=5)
    # K = 17 through the engine: the values once and a contraction a tile
    reset_counts()
    got = eng_17._phik_grid_batch_dense_fn(grids_e, e_run["domain"], MI_RADIUS)
    torch.cuda.synchronize()
    path = "phase 25, the dense MI target at K = 17"
    dense = read_dense()
    expect_counts(path, dense, {"phik_dense_fc_tiles": 1})
    S_e = grids_e.data.shape[0]
    if got.shape != (S_e, 17, 17) or not torch.isfinite(got).all():
        fail(f"{path}: non-finite or mis-shaped")
    nsx, nsy = eng_17.config.grid_samples
    entry("phik_dense_fc_tiles_K17", "mi_dense_kernel.cu", DENSE_REPLACES, d17["err"], d17["ms"],
          d17["plain_ms"], dense_work(S_e, 100, 100, nsx, nsy, 17 ** 2, MI_RADIUS,
                                      e_run["cfg"].mi_frontier_cells, d17["nnz"]))
    kernels["phik_dense_fc_tiles_K17"].update(library_ms=d17["lib_ms"],
                                              launches=dense["phik_dense_fc_tiles"])
    del grids_e, eng_e, eng_17, got
    big = maps(torch.from_numpy(mi_beliefs(S_BIG, CELLS_BIG, CELLS_BIG, seed=16)).to(dev))
    dom_big = Domain.create(0.0, 0.0, 0.05 * CELLS_BIG, 0.05 * CELLS_BIG, device=dev)
    rows["200 x 200, S=1024, r=3, fc=3"] = case(f"{CELLS_BIG} x {CELLS_BIG} beliefs",
                                                Engine(default_config("cart")), big, dom_big,
                                                MI_RADIUS, placements=True)
    del big
    eng_n = Engine(default_config("cart").replace(num_basis=12, grid_samples=(48, 64)))
    rows["60 x 140, lattice 48 x 64, K=12"] = case(
        "a 60 x 140 map, a 48 x 64 lattice", eng_n,
        maps(torch.from_numpy(mi_beliefs(512, 60, 140, seed=19)).to(dev)),
        Domain.create(0.0, 0.0, 7.0, 3.0, device=dev), 2)
    unknown = maps(torch.full((256, 100, 100), -1.0, device=dev))
    rows["all unknown, S=256"] = case("all-unknown beliefs", eng_f, unknown, dom_f, MI_RADIUS)
    if rows["all unknown, S=256"]["fallbacks"] != 256:
        fail("M on all-unknown beliefs: not the fallback in every scenario")
    rows["fully known (path F's true maps)"] = case("fully known maps", eng_f, truth_f, dom_f,
                                                    MI_RADIUS)
    print("  M vs plain on the card, by case (max abs error, max relative, ms of M / plain / "
          f"the cuBLAS contraction, temporaries' peak MiB of M / plain) {card}:")
    for name, d in rows.items():
        print(f"    {name}: {d['err']:.3e}, {d['rel']:.3e}; {d['ms']:.4f} / {d['plain_ms']:.4f} / "
              f"{d['lib_ms']:.4f} ms; {d['peak_m'] / 2**20:.2f} / {d['peak_p'] / 2**20:.1f} MiB")


# ---------------------------------------------------------------------------
# phase 26: the default configuration's step against its plain route
# ---------------------------------------------------------------------------


def plain_step_route(fn):
    """``fn()`` with the plain versions of the eager step's kernels in their
    place: the glue's (``with_plain_glue``), K1's without its safety stage
    and the safety stage's (``fused_safety_map_plain``: the crop gathered,
    then ``fused_safety_plain``), each run on the tensors it is given."""
    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk

    saved = sk.fused_solve, sk.fused_safety_map
    sk.fused_solve = lambda cfg, inp: sk.fused_solve_safety_plain(cfg, inp, enable_safety=False)
    sk.fused_safety_map = sk.fused_safety_map_plain
    try:
        return with_plain_glue(fn)
    finally:
        sk.fused_solve, sk.fused_safety_map = saved


def tick_budget(name: str, got, ref) -> None:
    """A tick (state, u, diag) against the same tick through plain versions:
    U within 5e-5, the metric and barrier rtol 1e-5, ck_sum rtol 1e-5 / atol
    5e-6, at most CODE_MISMATCH_LIMIT scenarios whose code, DWA flags or
    control (5e-5) differ, U finite. Prints the errors; fails on a breach."""
    import torch

    (gs, gu, gd), (rs, ru, rd) = got, ref
    dU = (gs.state.U - rs.state.U).abs().max().item()
    rel = {k: ((getattr(gd, k) - getattr(rd, k)).abs()
               / getattr(rd, k).abs().clamp(min=1e-7 / 1e-5)).max().item()
           for k in ("ergodic_metric", "barrier_cost")}
    ck = (gs.state.ck_sum - rs.state.ck_sum).abs()
    ck_bad = int((ck > 5e-6 + 1e-5 * rs.state.ck_sum.abs()).sum())
    mism = ((gd.collision_code != rd.collision_code) | (gd.dwa_active != rd.dwa_active)
            | (gd.dwa_feasible != rd.dwa_feasible) | ((gu - ru).abs() > 5e-5).any(1))
    n_mism = int(mism.sum())
    print(f"  {name} (S={gu.shape[0]}): max |U - plain| {dU:.3e} (atol 5e-5); metric, barrier "
          f"max relative {rel['ergodic_metric']:.3e}, {rel['barrier_cost']:.3e} (rtol 1e-5); "
          f"ck_sum {ck_bad} outside rtol 1e-5 / atol 5e-6; {n_mism} scenarios with another "
          f"code, DWA flag or control (limit {CODE_MISMATCH_LIMIT}); DWA active in "
          f"{int(rd.dwa_active.sum())}", flush=True)
    if (dU > 5e-5 or max(rel.values()) > 1e-5 or ck_bad or n_mism > CODE_MISMATCH_LIMIT
            or not torch.isfinite(gs.state.U).all()):
        fail(f"{name}: the tick on the card is outside its budget against its plain route")


def default_step_phase(dev, card) -> dict:
    """Phase 26: the eager controller step (``ErgodicController.step``:
    ``glue_pre``, K1 without its safety stage, ``k1_safety`` on the patch's
    central crop, ``glue_post``) on the card against the same tick through
    their plain versions on the card, from one state after 3 ticks: path C's
    inputs (S = 512) with per-scenario draws, the full ring, the accumulate
    mode, safety off and one shared map, and path Q's omni state (S = 256,
    after one refresh of its loop). U within 5e-5, the metric and barrier
    rtol 1e-5, ck_sum rtol 1e-5 / atol 5e-6, at most CODE_MISMATCH_LIMIT
    scenarios whose code, DWA flags or control (5e-5) differ; launches
    exact. Then the kernels and copies a tick of C's and Q's ``explore``
    graphs (10 ticks a replay; at most STEP_KERNELS). Fails on a breach.
    Returns the numbers, and under "states" C's and Q's (engine, scenarios,
    target, world)."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import GridMap
    from ergodic_exploration_tpu_torch.tools import quality

    print("== 26. the default configuration's step (glue_pre, K1, k1_safety, glue_post) vs its "
          "plain route on the card", flush=True)
    out = {}

    def check(name, eng, sc, phik, world):
        cfg, S_ = eng.config, sc.x.shape[0]
        for _ in range(3):  # a history to draw from
            sc, u, _ = eng._replan_fn(sc, phik, world)
            sc = advance(eng, sc, u)
        torch.cuda.synchronize()
        reset_counts()
        (gs, gu, gd) = eng._replan_fn(sc, phik, world)
        torch.cuda.synchronize()
        expect_counts(f"phase 26, {name}", read_counts(), step_want(cfg, 1))
        expect_counts(f"phase 26, {name}, the glue", read_glue(), glue_want(cfg, 1))
        reset_counts()
        (rs, ru, rd) = plain_step_route(lambda: eng._replan_fn(sc, phik, world))
        torch.cuda.synchronize()
        expect_counts(f"phase 26, {name}, the plain route", {**read_counts(), **read_glue()}, {})
        tick_budget(f"phase 26, {name}", (gs, gu, gd), (rs, ru, rd))
        ms = events_ms(lambda: eng._replan_fn(sc, phik, world), 20)
        plain_ms = events_ms(lambda: plain_step_route(lambda: eng._replan_fn(sc, phik, world)), 3)
        print(f"  {name} (S={S_}): the eager tick {ms:.4f} ms, its plain route {plain_ms:.4f} ms "
              f"{card}", flush=True)
        out[name] = dict(ms=ms, plain_ms=plain_ms, err=(gs.state.U - rs.state.U).abs().max().item())
        return sc

    cfg_c, x0_c, grids_c, gmm_c, dom = distinct_case(512, dev, seed=3, use_fused_solve=False)
    if cfg_c != default_config("cart"):
        fail("phase 26: path C is not the default configuration")
    shared = GridMap(grids_c.data[:1].expand_as(grids_c.data).contiguous(), grids_c.origin,
                     grids_c.resolution)
    graphs_of = {}
    for name, cfg, grids in (
            ("path C, per-scenario draws", cfg_c, grids_c),
            ("path C, the full ring", cfg_c.replace(buffer_batch=None), grids_c),
            ("path C, the accumulate mode", cfg_c.replace(history="accumulate"), grids_c),
            ("path C, safety off", cfg_c.replace(enable_safety=False), grids_c),
            ("path C on one shared map", cfg_c.replace(shared_maps=True), shared)):
        eng = Engine(cfg)
        world = eng.prepare_world(grids)
        phik = eng.phik_from_gmm(gmm_c, dom)
        sc = check(name, eng, eng.init_scenarios(x0_c), phik, world)
        if cfg == cfg_c:
            graphs_of["C"] = (eng, sc, phik, world)
    cfg_q = default_config("omni")
    eng_q = Engine(cfg_q)
    truth_q = quality.build_truth(Q_S, dev)
    sc_q, belief_q, _, _, _ = eng_q.explore_mapping_fused(
        eng_q.init_scenarios(quality.spawn_poses(cfg_q, truth_q, Q_S)), truth_q, 1, Q_EVERY)
    world_q = eng_q.prepare_world(belief_q)
    phik_q = eng_q._phik_grid_batch_dense_fn(belief_q, None, 0)
    sc_q = check(f"path Q's state (omni, after a refresh)", eng_q, sc_q, phik_q, world_q)
    graphs_of["Q"] = (eng_q, sc_q, phik_q, world_q)

    for path, (eng, sc, phik, world) in graphs_of.items():
        run = lambda eng=eng, sc=sc, phik=phik, world=world: eng.explore(sc, phik, world, 10)
        run()  # captures the 10-tick graph
        n, busy, _, top = kernel_profile(run, 10)
        tick_ms = events_ms(run, 5) / 10
        print(f"  {path}'s explore graph (10 ticks a replay, S={sc.x.shape[0]}): {n:.1f} kernels "
              f"and copies a tick (limit {STEP_KERNELS}), device busy {busy:.4f} ms a tick, "
              f"{tick_ms:.4f} ms a tick {card}")
        for name, cnt, ms in top:
            print(f"     {ms:9.4f} ms  x{cnt:5.1f}  {name}")
        out[path] = dict(kernels=n, busy=busy, tick_ms=tick_ms)
        if n > STEP_KERNELS:
            fail(f"phase 26: {path}'s graph runs {n:.1f} kernels a tick (limit {STEP_KERNELS})")
    out["states"] = graphs_of
    return out


# ---------------------------------------------------------------------------
# phase 27: the full ring's sums, the step's crop from the map, the coverage
# ---------------------------------------------------------------------------


def full_ring(S: int, cap: int, device, seed: int = 27):
    """Rings of ``cap`` positions on the 5 m domain: a third full with a
    cursor that just wrapped (cursor < 6), a third still filling (count =
    cursor), a third full with the cursor anywhere; scenario 1 empty."""
    import torch

    from ergodic_exploration_tpu_torch.ops.buffer import RingBuffer

    rng = np.random.default_rng(seed)
    states = rng.uniform(0.2, 4.8, (S, 2, cap)).astype(np.float32)
    cursor = rng.integers(0, cap, S).astype(np.int32)
    count = np.full(S, cap, np.int32)
    cursor[::3] = rng.integers(0, 6, len(cursor[::3]))
    count[1::3] = cursor[1::3]
    if S > 1:
        count[1] = cursor[1] = 0
    return RingBuffer(*(torch.from_numpy(a).to(device) for a in (states, cursor, count)))


def full_sums_f64(ring, K: int, domain):
    """The full ring's history sums (S, K^2) in float64 from the card's
    float32 cos tables (``basis.cos_tables``: torch.cos, whose bits the glue's
    tables have): the exact sums that the kernel's and the plain version's
    round."""
    import torch

    from ergodic_exploration_tpu_torch.ops import basis

    Cx, Cy = basis.cos_tables(ring.positions, K, domain)
    w = ring.valid_mask().double()[..., None]
    hk = basis.hk_norm(K, domain.lengths).double()
    sums = torch.bmm((Cx.double() * w).transpose(1, 2), Cy.double()) / hk
    return sums.reshape(ring.states.shape[0], K * K)


def last_stages_phase(dev, card, entry, kernels, f_run: dict, states: dict) -> None:
    """Phase 27: the three stages that ran as plain torch on the card until
    this phase's kernels took them, each against its plain version on the
    card. (a) glue_pre on the full ring (mode "full") against its plain
    version (``controller.history_sums``) and the float64 sums: S = 4096,
    cap 1024 on path A's configuration with ``buffer_batch`` None, S = 512
    and S = 1 (their rows equal to the full batch's bit for bit), K = 17 at
    S = 4096 and 512; no further from float64 than the plain version (or
    within GLUE_SUM_ATOL), the rest equal; the block and warp layouts forced
    on the same rings (``G.block_max_s``) bit for bit at K = 10 and 17;
    timed beside the plain version and the route it replaces, and alone at
    S = 4096, 512 and 1 beside cuBLAS' bmm of the masked tables; the
    accumulate mode's kernel beside an empty kernel's launch. (b) 10 chained
    ticks of path A's configuration with the full ring (``replan_refresh``)
    and of path C's with the full ring and with the accumulate mode
    (``replan``, the eager step) against their plain routes (``tick_budget``),
    launches exact, and ``explore`` on C's; the full-ring tick's peak device
    memory beside its plain route's. (c) ``fused_safety_map`` on C's and Q's
    states (``states``, phase 26's), the node's inputs (phase 16's) and
    poses on the maps' four edges (``safety_map_check``). (d) the coverage
    kernel bit for bit against its plain version on path F's beliefs
    (``f_run``), all-unknown and all-known maps, S = 1 and 200 x 200 beliefs
    at S = 1024. Adds the entries ``glue_pre_full``, ``glue_pre_accumulate``
    and ``coverage``; fails on a breach."""
    import torch

    import ergodic_exploration_tpu_torch.ops.reveal_kernel as rk
    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    import ergodic_exploration_tpu_torch.ops.tick_glue as tg
    from ergodic_exploration_tpu_torch.controller import history_sums
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops import basis, sensor
    from ergodic_exploration_tpu_torch.ops.patch import patch_start

    print("== 27. the full ring's sums (glue_pre), the step's crop read from the map "
          "(fused_safety_map), the coverage, against their plain versions", flush=True)
    HIST_REPLACES = "ergodic_exploration_tpu/ops/solve_kernel.py:845"

    def full_check(tag, cfg, st, x, dom, patch):
        args = (cfg, "full", st.rng, st.buffer, st.U, x, dom, patch)
        reset_counts()
        k = tg.G.pre(*args)
        torch.cuda.synchronize()
        expect_counts(f"phase 27, {tag}, the glue", read_glue(), {"glue_pre_full": 1})
        p = tg.glue_pre_plain(*args)
        for f in ("nh", "orbiting", "U", "pstart"):
            if not torch.equal(getattr(k, f), getattr(p, f)):
                fail(f"phase 27, {tag}: glue_pre's {f} differs from its plain version")
        f64 = full_sums_f64(st.buffer, cfg.num_basis, dom)
        err_k, err_p = ((t.double() - f64).abs().max().item() for t in (k.hist, p.hist))
        d = (k.hist - p.hist).abs()
        rel = (d / p.hist.abs().clamp(min=GLUE_SUM_ATOL)).max().item()
        print(f"  glue_pre full ring, {tag}: max |kernel - float64| {err_k:.3e}, max |plain - "
              f"float64| {err_p:.3e} (the kernel's budget: the larger of that and "
              f"{GLUE_SUM_ATOL}); max |kernel - plain| {d.max().item():.3e}, relative "
              f"{rel:.3e}; state counts, orbit flags, warm and patch starts equal", flush=True)
        if not torch.isfinite(k.hist).all() or err_k > max(err_p, GLUE_SUM_ATOL):
            fail(f"phase 27, {tag}: the full ring's sums are further from float64 than the plain "
                 f"version's")
        return k, d.max().item()

    # (a) path A's configuration with the full ring, S = 4096, cap 1024
    engine, sc_a, world_a, gmm_a, domain_a = build_engine(S_MAIN, dev)
    cfg_a = engine.config.replace(buffer_batch=None)
    eng_a = Engine(cfg_a)
    cap, K = cfg_a.buffer_capacity, cfg_a.num_basis
    ring = full_ring(S_MAIN, cap, dev)
    sc_a = sc_a._replace(state=sc_a.state._replace(buffer=ring))
    st, x = sc_a.state, sc_a.x.contiguous()
    dom = Domain(world_a.domain.origin.contiguous(), world_a.domain.lengths.contiguous())
    P = min(cfg_a.patch_cells, *world_a.dist.dist.shape[-2:])
    patch = tg.PatchGeometry(world_a.dist.origin.contiguous(),
                             world_a.dist.resolution.contiguous(), P)
    n_valid = int(ring.count.clamp(0, cap).sum())
    print(f"  rings: {int((ring.count == cap).sum())} full ({int((ring.cursor[::3] < 6).sum())} "
          f"just wrapped), {int((ring.count < cap).sum())} still filling, {n_valid} valid "
          f"entries of {S_MAIN * cap}")
    def cut(n):  # (state, poses, domain, patch geometry) of the first n scenarios
        def pk(t):
            return t[:n].contiguous()

        st_n = type(st)(*(type(v)(*map(pk, v)) if hasattr(v, "_fields") else pk(v) for v in st))
        return (st_n, pk(x), Domain(pk(dom.origin), pk(dom.lengths)),
                tg.PatchGeometry(pk(patch.origin), pk(patch.resolution), P))

    k_full, err_full = full_check(f"S={S_MAIN}, cap {cap}, K={K}", cfg_a, st, x, dom, patch)
    k_small, _ = full_check(f"S={S_STEP} (a block a scenario)", cfg_a, *cut(S_STEP))
    k1_, _ = full_check("S=1", cfg_a, *cut(1))
    if not torch.equal(k1_.hist, k_full.hist[:1]):
        fail("phase 27: the full ring's sums at S=1 differ from the full batch's row")
    if not torch.equal(k_small.hist, k_full.hist[:S_STEP]):
        fail(f"phase 27: the full ring's sums at S={S_STEP} differ from the full batch's rows")
    print(f"  S=1 and S={S_STEP} (a block a scenario): equal to the full batch's rows bit for bit")
    full_check(f"S={S_MAIN}, K=17 (2 x 3 tiles a warp, one pass)", cfg_a.replace(num_basis=17),
               st, x, dom, patch)
    full_check(f"S={S_STEP}, K=17 (a block a scenario)", cfg_a.replace(num_basis=17),
               *cut(S_STEP))

    def layout(limit, args):  # the full ring's sums with G.block_max_s = limit
        saved = tg.G.block_max_s
        tg.G.block_max_s = limit
        try:
            return tg.G.pre(*args).hist
        finally:
            tg.G.block_max_s = saved

    for K_ in (K, 17):
        for n in (S_MAIN, S_STEP):
            st_n, x_n, dom_n, patch_n = cut(n)
            args = (cfg_a.replace(num_basis=K_), "full", st_n.rng, st_n.buffer, st_n.U, x_n, dom_n,
                    patch_n)
            if not torch.equal(layout(n, args), layout(0, args)):
                fail(f"phase 27: the full ring's sums at K={K_}, S={n} differ between the block "
                     f"layout and the warp layout")
    print(f"  the block layout (a block a scenario) and the warp layout (a warp a scenario) forced "
          f"on the same rings (G.block_max_s): equal bit for bit at K={K} and K=17, S={S_MAIN} "
          f"and S={S_STEP}")
    args_a = (cfg_a, "full", st.rng, st.buffer, st.U, x, dom, patch)
    hk = basis.hk_norm(K, dom.lengths)
    ms_full = events_ms(lambda: tg.G.pre(*args_a), 20)
    plain_full = events_ms(lambda: tg.glue_pre_plain(*args_a), 5)
    earlier_full = events_ms(lambda: (tg.G.pre(cfg_a, None, *args_a[2:]),
                                      history_sums(cfg_a, st, dom, hk)), 5)
    alone, lib = {}, {}
    for n in (S_MAIN, S_STEP, 1):
        st_n, x_n, dom_n, patch_n = cut(n)
        args = (cfg_a, "full", st_n.rng, st_n.buffer, st_n.U, x_n, dom_n, patch_n)
        alone[n] = ms_full if n == S_MAIN else events_ms(lambda: tg.G.pre(*args), 50)
        Cx, Cy = basis.cos_tables(st_n.buffer.positions, K, dom_n)
        A = (Cx * st_n.buffer.valid_mask()[..., None]).transpose(1, 2).contiguous()
        lib[n] = events_ms(lambda: torch.bmm(A, Cy), 20)
        del Cx, Cy, A
    entry("glue_pre_full", "tick_glue.cu", HIST_REPLACES, err_full, ms_full, plain_full,
          glue_pre_work(cfg_a, S_MAIN, "full", cfg_a.horizon, cfg_a.nu, n_valid))
    kernels["glue_pre_full"]["library_ms"] = lib[S_MAIN]
    print(f"  glue_pre full ring at S={S_MAIN}: {ms_full:.4f} ms, its plain version "
          f"{plain_full:.4f} ms, the route it replaces (glue_pre without history, then "
          f"history_sums as plain torch) {earlier_full:.4f} ms, cuBLAS' bmm of the masked tables "
          f"alone {lib[S_MAIN]:.4f} ms {card}", flush=True)
    def full_bound(n):  # the bound of the first n scenarios' sums
        n_ring = int(ring.count[:n].clamp(0, cap).sum())
        return bound(*glue_pre_work(cfg_a, n, "full", cfg_a.horizon, cfg_a.nu, n_ring))[0]

    print("  glue_pre full ring timed alone: " + ", ".join(
        f"S={n} {alone[n]:.4f} ms (cuBLAS' bmm of its masked tables {lib[n]:.4f} ms, bound "
        f"{full_bound(n):.5f} ms)" for n in alone) + f" {card}", flush=True)

    # (b) 10 chained ticks through the entry points against the plain routes
    def chained(tag, eng, graph_tick, plain_tick, sc, want, glue):
        torch.cuda.synchronize()
        reset_counts()
        got, s_ = [], sc
        for _ in range(ENTRY_TICKS):
            out = graph_tick(s_)
            got.append((s_, out))
            s_ = advance(eng, out[0], out[1])
        torch.cuda.synchronize()
        expect_counts(f"phase 27, {tag}", read_counts(), want)
        glue_got = read_glue()
        expect_counts(f"phase 27, {tag}, the glue", glue_got, glue)
        note_launches(f"phase 27, {tag}", glue_got)
        for i, (s_in, out) in enumerate(got):
            tick_budget(f"phase 27, {tag}, tick {i + 1}", out, plain_tick(s_in))
        return s_

    T = ENTRY_TICKS
    chained(f"path A's configuration with the full ring (replan_refresh), S={S_MAIN}", eng_a,
            lambda s_: eng_a.replan_refresh(s_, gmm_a, domain_a, world_a),
            lambda s_: with_plain_glue(
                lambda: eng_a._refresh_and_replan_fn(s_, gmm_a, domain_a, world_a)),
            sc_a, {"fused_solve_safety": T}, glue_want(cfg_a, T, in_place=True))
    n, busy, _, _ = kernel_profile(lambda: eng_a.replan_refresh(sc_a, gmm_a, domain_a, world_a),
                                   1)
    print(f"  path A's configuration with the full ring, the 1-tick replan_refresh graph: "
          f"{n:.1f} kernels and copies a tick, device busy {busy:.4f} ms a tick {card}")
    peaks = {}
    for kind, tick in (("kernels", lambda: eng_a._refresh_and_replan_fn(sc_a, gmm_a, domain_a,
                                                                          world_a)),
                       ("plain route", lambda: with_plain_glue(
                           lambda: eng_a._refresh_and_replan_fn(sc_a, gmm_a, domain_a,
                                                                world_a)))):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tick()
        torch.cuda.synchronize()
        peaks[kind] = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"  the full-ring tick at S={S_MAIN} (eager, glue_pre to glue_post): peak device memory "
          f"above its inputs {peaks['kernels']:.1f} MiB with the kernel, "
          f"{peaks['plain route']:.1f} MiB on the plain route (its (S, cap, K) float32 tables: "
          f"{S_MAIN * cap * K * 4 / 2**20:.0f} MiB each) {card}", flush=True)
    del engine, eng_a, sc_a, world_a, ring, st, k_full, k1_
    torch.cuda.empty_cache()

    cfg_c, x0_c, grids_c, gmm_c, dom_c = distinct_case(S_STEP, dev, seed=3,
                                                       use_fused_solve=False)
    for name, cfg in (("the full ring", cfg_c.replace(buffer_batch=None)),
                      ("the accumulate mode", cfg_c.replace(history="accumulate"))):
        eng = Engine(cfg)
        world = eng.prepare_world(grids_c)
        phik = eng.phik_from_gmm(gmm_c, dom_c)
        sc = eng.init_scenarios(x0_c)
        if cfg.history == "ring":
            sc = sc._replace(state=sc.state._replace(buffer=full_ring(S_STEP, cap, dev, seed=28)))
        else:  # a history of 20 ticks in ck_sum
            sc = eng.explore(sc, phik, world, 20).scenarios
        tag = f"path C with {name} (replan, the eager step), S={S_STEP}"
        sc = chained(tag, eng, lambda s_: eng.replan(s_, phik, world),
                     lambda s_: plain_step_route(lambda: eng._replan_fn(s_, phik, world)), sc,
                     step_want(cfg, T), glue_want(cfg, T, in_place=True))
        reset_counts()
        eng.explore(sc, phik, world, T)
        torch.cuda.synchronize()
        expect_counts(f"phase 27, path C with {name}, explore", read_counts(), step_want(cfg, T))
        expect_counts(f"phase 27, path C with {name}, explore, the glue", read_glue(),
                      glue_want(cfg, T, advance=True, in_place=True))
        n, busy, _, _ = kernel_profile(lambda: eng.explore(sc, phik, world, T), T)
        tick_ms = events_ms(lambda: eng.explore(sc, phik, world, T), 5) / T
        print(f"  path C with {name}, its explore graph ({T} ticks a replay): {n:.1f} kernels and "
              f"copies a tick, device busy {busy:.4f} ms a tick, {tick_ms:.4f} ms a tick {card}",
              flush=True)
        if cfg.history == "accumulate":
            st, xc = sc.state, sc.x.contiguous()
            dc = Domain(world.domain.origin.contiguous(), world.domain.lengths.contiguous())
            args_c = (cfg, "accumulate", st.rng, st.buffer, st.U, xc, dc, None, st.hist_count,
                      st.ck_sum)
            k, p = tg.G.pre(*args_c), tg.glue_pre_plain(*args_c)
            for f in ("hist", "nh", "orbiting", "U"):
                if not torch.equal(getattr(k, f), getattr(p, f)):
                    fail(f"phase 27, the accumulate mode: glue_pre's {f} differs from plain")
            print("  glue_pre in the accumulate mode: state counts, ck_sum handed on, orbit flags "
                  "and warm starts equal to its plain version")
            entry("glue_pre_accumulate", "tick_glue.cu", HIST_REPLACES, 0.0,
                  events_ms(lambda: tg.G.pre(*args_c), 20),
                  events_ms(lambda: tg.glue_pre_plain(*args_c), 5),
                  glue_pre_work(cfg, S_STEP, "accumulate", cfg.horizon, cfg.nu))
            print(f"  glue_pre_accumulate {kernels['glue_pre_accumulate']['ms']:.4f} ms beside an "
                  f"empty kernel's launch (torch.cuda._sleep(0), a spin of no cycles) "
                  f"{events_ms(lambda: torch.cuda._sleep(0), 50):.4f} ms {card}")
        else:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            peaks = {}
            for kind, tick in (("kernels", lambda: eng._replan_fn(sc, phik, world)),
                               ("plain route", lambda: plain_step_route(
                                   lambda: eng._replan_fn(sc, phik, world)))):
                torch.cuda.reset_peak_memory_stats()
                tick()
                torch.cuda.synchronize()
                peaks[kind] = (torch.cuda.max_memory_allocated() - base) / 2**20
            print(f"  the full-ring eager step at S={S_STEP}: peak device memory above its inputs "
                  f"{peaks['kernels']:.1f} MiB with the kernels, {peaks['plain route']:.1f} MiB "
                  f"on the plain route {card}", flush=True)
        del eng, world, phik, sc

    # (c) the step's safety stage reading the crop from the map
    for path, (eng, sc, _, world) in states.items():
        safety_map_check(f"phase 27, path {path}'s state", eng.config, sc.x, sc.vb, sc.state.U,
                         world)
    if NODE_INPUTS:
        safety_map_check("phase 27, the node's inputs (S=1)", *NODE_INPUTS)
    eng, sc, _, world = states["C"]
    cfg = eng.config
    edge = torch.tensor([[0.0, 2.5], [5.0, 1.7], [2.5, 0.0], [1.3, 5.0], [0.0, 0.0], [5.0, 5.0],
                         [0.01, 4.99], [4.99, 0.02]], device=dev)
    x = sc.x.clone()
    x[:len(edge), :2] = edge
    P_c, Pc = sk.crop_geometry(cfg, world.dist.dist)
    cst = patch_start(world.dist, x[:, :2], P_c) + (P_c - Pc) // 2
    clamps = [int((cst[:, 0] < 0).sum()), int((cst[:, 1] < 0).sum()),
              int((cst[:, 0] + Pc > 100).sum()), int((cst[:, 1] + Pc > 100).sum())]
    if min(clamps) < 1:
        fail(f"phase 27: the edge poses' crops do not clamp at every edge: {clamps}")
    print(f"  crops past the left, bottom, right and top edges: {clamps}")
    safety_map_check("phase 27, path C's maps with poses on the four edges", cfg, x, sc.vb,
                     sc.state.U, world)

    # (d) the coverage
    def cover_check(tag, data):
        data = data.contiguous()
        reset_counts()
        k = rk.R.coverage(data)
        torch.cuda.synchronize()
        expect_counts(f"phase 27, the coverage on {tag}", read_map(), map_want(0, 0, 0, 1))
        S_ = data.shape[0]
        p = sensor.fraction_known_plain(GridMap(data, torch.zeros(S_, 2, device=dev),
                                                torch.full((S_,), 0.05, device=dev)))
        old = (data != -1.0).to(torch.float32).mean()
        n_known = int((data != -1.0).sum())
        exact = np.float32(n_known / data.numel())
        print(f"  the coverage on {tag}: kernel {k.item():.9f}, plain {p.item():.9f}, the "
              f"exact share rounded once {float(exact):.9f}; the float32 mean it replaces "
              f"{old.item():.9f} ({abs(old.item() - k.item()):.2e} apart)")
        if not torch.equal(k, p) or k.item() != exact:
            fail(f"phase 27: the coverage on {tag} differs from its plain version")
        return k

    belief_f = f_run["belief"]
    cover_check(f"path F's beliefs (S={belief_f.shape[0]}, 100 x 100)", belief_f)
    cover_check("all-unknown maps", torch.full_like(belief_f, -1.0))
    cover_check("all-known maps", torch.zeros_like(belief_f))
    cover_check("S=1", belief_f[:1])
    cover_check(f"200 x 200 beliefs (S={S_BIG})",
                torch.from_numpy(mi_beliefs(S_BIG, CELLS_BIG, CELLS_BIG)).to(dev))
    n = belief_f.numel()
    entry("coverage", "reveal_kernel.cu", "ergodic_exploration_tpu/ops/sensor.py:151",
          0.0, events_ms(lambda: rk.R.coverage(belief_f), 50),
          events_ms(lambda: sensor.fraction_known_plain(GridMap(belief_f, None, None)), 20),
          (float(n), 4.0 * n + 4))
    kernels["coverage"]["library_ms"] = events_ms(
        lambda: torch.count_nonzero(belief_f != -1.0), 20)
    print(f"  the coverage on path F's beliefs: torch.count_nonzero of the known cells (the "
          f"library column) {kernels['coverage']['library_ms']:.4f} ms, the float32 mean it "
          f"replaces {events_ms(lambda: (belief_f != -1.0).to(torch.float32).mean(), 20):.4f} "
          f"ms {card}")


# ---------------------------------------------------------------------------
# phase 28: the map sizes the JAX package answers
# ---------------------------------------------------------------------------


def ros_map_case(S: int, dev, n: int, seed: int = 28):
    """S truths of gmapping's default map (x and y in [-100, 100] m at 0.05 m:
    ``n`` = 4000 cells a side, built on the card): outer walls, walls every
    n // 4 cells (50 m rooms) with doorways of 2 m placed per scenario, a
    1 m pillar 17.5 m up and right of each room's centre; start poses within
    10 m of a room's centre, headings uniform (lengths in rooms, so that a
    smaller n is the same picture)."""
    import torch

    from ergodic_exploration_tpu_torch.grid import GridMap

    rng = np.random.default_rng(seed)
    room = n // 4
    door, half = max(2, room // 25), max(1, room // 100)  # doorway; pillar's half side
    data = torch.zeros((S, n, n), device=dev)
    for k in range(5):  # the outer walls and the rooms' walls, two cells thick
        a = min(k * room, n - 2)
        data[:, a:a + 2, :] = 1.0
        data[:, :, a:a + 2] = 1.0
    for s in range(S):
        for k in range(1, 4):
            for j in range(4):
                a, b = j * room + rng.integers(room // 10, room - room // 10 - door, 2)
                data[s, k * room:k * room + 2, a:a + door] = 0.0
                data[s, b:b + door, k * room:k * room + 2] = 0.0
    first = room // 2 + (7 * room) // 20
    for ci in range(first, n, room):
        for cj in range(first, n, room):
            data[:, ci - half:ci + half, cj - half:cj + half] = 1.0
    rooms = rng.integers(0, 4, (S, 2))
    res = 0.05
    xy = (rooms + 0.5 + rng.uniform(-0.2, 0.2, (S, 2))) * room * res
    x0 = np.concatenate([xy, rng.uniform(-np.pi, np.pi, (S, 1))], axis=1).astype(np.float32)
    truth = GridMap(data, torch.zeros((S, 2), device=dev), torch.full((S,), res, device=dev))
    return x0, truth


def sparse_maps(S: int, n: int, seed: int, dev, grid_samples):
    """S (n, n) maps on the card for E: scattered obstacles and walls, a third
    of the cells unknown, known-free cells, a NaN at the first lattice
    point's cell of the first map (a ``grid_samples`` lattice over each
    map's extent)."""
    import torch

    from ergodic_exploration_tpu_torch.grid import GridMap

    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.rand((S, n, n), generator=g, device=dev)
    data = torch.where(u < 0.33, -1.0, torch.where(u > 0.9995, 1.0, 0.2))
    data[:, n // 3, n // 8:n // 2] = 1.0
    data[:, n // 5:n - n // 5, 2 * n // 3] = 0.9
    grid = GridMap(data, torch.zeros((S, 2), device=dev), torch.full((S,), 0.05, device=dev))
    cell = grid.world_to_grid(grid.domain().sample_lattice(grid_samples))[0, 0].round().long()
    data[0, cell[1], cell[0]] = float("nan")
    return grid


def ros_beliefs(S: int, n: int, seed: int, dev):
    """S (n, n) beliefs on the card for M: a known part of random width
    (known-free, a few walls, continuous cells), the rest unknown, a wall
    across the middle, the last scenario fully occupied (the fallback)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    ext = torch.randint(n // 10, n - n // 10, (S,), generator=g, device=dev)
    known = torch.arange(n, device=dev)[None, None, :] < ext[:, None, None]
    u = torch.rand((S, n, n), generator=g, device=dev)
    data = torch.where(known, 0.0, -1.0).expand(S, n, n).clone()
    data = torch.where(u < 0.002, 1.0, torch.where((u > 0.5) & (u < 0.53), u, data))
    data[:, int(0.45 * n):int(0.5 * n), int(0.2 * n):int(0.8 * n)] = torch.where(
        known[:, :, int(0.2 * n):int(0.8 * n)], 1.0, -1.0)
    data[S - 1] = 1.0
    return data


def map_sizes_phase(dev, card, entry, kernels) -> None:
    """Phase 28: the map sizes the JAX package answers and the port once
    refused. E's many-block form forced on 100 x 100 (S = 64 and 1) and 200 x
    200 maps (S = 16) bit for bit against ``world_plain`` and the one-block
    form, both forms timed; E with the free mask on 1400 x 1400 maps (S = 2,
    the many-block form) bit for bit against ``world_plain`` map by map, and
    on gmapping's default 4000 x 4000 maps (S = 4) dist and grad bit for bit
    against the EDT alone (the plain EDT would take 256 GB a map), the mask
    against the plain mask; M at 4000 x 4000 (S = 16, r = fc = 3: the tables
    at the 700 columns the lattice reads, the rings in the workspace; also
    with every map column), at K = 130 (S = 16, 100 x 100 maps: the values
    once and a contraction a tile, also through ``phik_from_grid``) and on a
    4500 x 4500 lattice of 100 x 100 maps (``phik_from_grid`` on a shared
    domain: the Cx table a pass's rows at a time) against its plain version
    within DENSE_TOL; then the
    mapping loop at 4000 x 4000 (``explore_mapping_fused``, S = 16, r = 3,
    fc = 3, two refreshes of 10 ticks): finite outputs, the coverage risen
    from the unknown start and never falling, every known cell the truth's,
    one R, E and M launch a refresh, and M against its plain version on the
    beliefs it reached. Each case's ms, its bound and its temporaries' peak;
    the new forms' entries of the kernels line."""
    import torch

    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops import edt_kernel as ek
    from ergodic_exploration_tpu_torch.ops import mi_dense_kernel as md
    from ergodic_exploration_tpu_torch.ops import solve_kernel as sk
    from ergodic_exploration_tpu_torch.ops.distance import DistanceField

    print(f"== 28. the map sizes the JAX package answers: E and M on {E_MASK_CELLS} x "
          f"{E_MASK_CELLS}, "
          f"{ROS_CELLS} x {ROS_CELLS} maps, K = 130, a {LATTICE_BIG} x {LATTICE_BIG} lattice; the "
          f"mapping loop at "
          f"{ROS_CELLS} x {ROS_CELLS} {card}", flush=True)
    torch.cuda.empty_cache()
    cfg = default_config("cart").replace(use_fused_solve=True)
    thr, gs = cfg.occupied_threshold, cfg.grid_samples
    rng = np.random.default_rng(28)

    def e_maps(S_, n, seed):
        return sparse_maps(S_, n, seed, dev, gs)

    def world_peak(grid):
        """E with the mask on ``grid``, the temporaries' peak above its inputs."""
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = ek.world_fields(grid, grid.domain(), thr, gs)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    # (a0) E's many-block form forced on maps whose plane fits shared memory:
    # 100 x 100 (S = 64, S = 1) and 200 x 200 (S = 16) against world_plain and
    # the one-block form, bit for bit; both forms timed there and at S = 4096
    # and S = 1024
    for n, S_, S_t in ((100, 64, 4096), (100, 1, 1), (200, 16, 1024)):
        grid = e_maps(S_, n, 280 + n + S_)
        one = ek.world_fields(grid, grid.domain(), thr, gs)
        ref = ek.world_plain(grid, grid.domain(), thr, gs)
        ek.E.smem_limit = 0
        try:
            ek.E.reset_launches()
            many = ek.world_fields(grid, grid.domain(), thr, gs)
            again = ek.world_fields(grid, grid.domain(), thr, gs)
            launched = dict(ek.E.launches)
        finally:
            ek.E.smem_limit = sk.MAX_SMEM
        same = [torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, d)
                for a, b, c, d in zip(many, ref, one, again)]
        print(f"  E's many-block form forced at {n} x {n}, S={S_}: dist, grad, mask equal to "
              f"world_plain and to the one-block form bit for bit: {same}; launches {launched}")
        if not all(same) or launched["world_global"] != 2:
            fail(f"phase 28: E's many-block form at {n} x {n} differs from world_plain or the "
                 f"one-block form")
        big = e_maps(S_t, n, 290 + n) if S_t != S_ else grid
        t_one = events_ms(lambda: ek.world_fields(big, big.domain(), thr, gs), 20)
        ek.E.smem_limit = 0
        try:
            t_many = events_ms(lambda: ek.world_fields(big, big.domain(), thr, gs), 20)
        finally:
            ek.E.smem_limit = sk.MAX_SMEM
        print(f"  E with the mask at {n} x {n}, S={S_t}: the one-block form {t_one:.4f} ms, the "
              f"many-block form {t_many:.4f} ms {card}", flush=True)
        del grid, one, ref, many, again, big
    torch.cuda.empty_cache()

    # (a) E with the mask on 1400 x 1400 maps against world_plain, map by map
    grid = e_maps(2, E_MASK_CELLS, 281)
    ek.E.reset_launches()
    (dist, grad, free), peak = world_peak(grid)
    if ek.E.launches["world_global"] != 1:
        fail(f"phase 28: E on {E_MASK_CELLS} x {E_MASK_CELLS} maps did not take the global "
             f"plane: {ek.E.launches}")
    err, plain_ms = 0.0, 0.0
    for i in range(2):
        one = GridMap(*(t[i:i + 1] for t in grid))
        ref = ek.world_plain(one, one.domain(), thr, gs)
        same = [torch.equal(a[i:i + 1], b) for a, b in zip((dist, grad, free), ref)]
        err = max([err] + [(a[i:i + 1] - b).abs().max().item() for a, b in
                           zip((dist, grad, free), ref)])
        print(f"  E with the mask, {E_MASK_CELLS} x {E_MASK_CELLS} map {i}: dist, grad, mask equal to world_plain "
              f"bit for bit: {same}; free lattice points {int(free[i].sum())} of {free.shape[1]}")
        if not all(same):
            fail(f"phase 28: E with the mask on map {i} differs from world_plain")
        del ref
        torch.cuda.empty_cache()
        plain_ms += events_ms(lambda one=one: ek.world_plain(one, one.domain(), thr, gs), 1)
    if free[0, 0] != 0.0:
        fail("phase 28: the NaN cell at the first lattice point is free")
    w_ms = events_ms(lambda: ek.world_fields(grid, grid.domain(), thr, gs), 5)
    work = edt_work(2, E_MASK_CELLS, E_MASK_CELLS, gs[0] * gs[1])
    print(f"  E with the mask, {E_MASK_CELLS} x {E_MASK_CELLS}, S=2: {w_ms:.4f} ms, world_plain map by map "
          f"{plain_ms:.2f} ms, bound {bound(*work)[0]:.4f} ms ({work[1] / 1e6:.1f} MB); "
          f"temporaries' peak {peak / 2**20:.1f} MiB {card}", flush=True)
    entry("world_global", "edt_kernel.cu", "ergodic_exploration_tpu/engine.py:288", err, w_ms,
          plain_ms, work)
    del grid, dist, grad, free

    # (b) E at 4000 x 4000: the world form against the EDT alone, the mask against plain
    grid = e_maps(4, ROS_CELLS, 282)
    (dist, grad, free), peak = world_peak(grid)
    field = DistanceField.from_grid(grid, thr)
    ref_free = (grid.occupancy_at(grid.domain().sample_lattice(gs)) < thr).to(torch.float32)
    same = [torch.equal(dist, field.dist), torch.equal(grad, field.grad), torch.equal(free, ref_free)]
    print(f"  E at {ROS_CELLS} x {ROS_CELLS}, S=4: dist and grad of the world form equal to the "
          f"EDT alone, the mask to the plain mask, bit for bit: {same}; FAR cells "
          f"{int((dist >= 1e6).sum())}, free lattice points {int(free.sum())} of {free.numel()}")
    if not all(same) or not torch.isfinite(dist).all() or free[0, 0] != 0.0:
        fail(f"phase 28: E at {ROS_CELLS} x {ROS_CELLS} disagrees with the EDT alone or the mask")
    del dist, grad, free, field
    w_ms = events_ms(lambda: ek.world_fields(grid, grid.domain(), thr, gs), 3)
    e_ms = events_ms(lambda: DistanceField.from_grid(grid, thr), 3)
    work = edt_work(4, ROS_CELLS, ROS_CELLS, gs[0] * gs[1])
    work_e = edt_work(4, ROS_CELLS, ROS_CELLS)
    print(f"  E with the mask at {ROS_CELLS} x {ROS_CELLS}, S=4: {w_ms:.4f} ms, bound "
          f"{bound(*work)[0]:.4f} ms ({work[1] / 1e6:.0f} MB); the field alone (edt_global) "
          f"{e_ms:.4f} ms, bound {bound(*work_e)[0]:.4f} ms; temporaries' peak "
          f"{peak / 2**20:.0f} MiB (the planes and stacks in the workspace) {card}", flush=True)
    del grid
    torch.cuda.empty_cache()

    def m_case(name, data, ops, r, fc, **kw):
        d = dense_check(name, data, ops, r, fc, thr, card, **kw)
        S_, h_, w_ = data.shape
        nsx, nsy = ops.cx.shape[0], ops.cy.shape[0]
        KK = ops.fallback.numel()
        work_ = dense_work(S_, h_, w_, nsx, nsy, KK, r, fc, d["nnz"],
                           box_cells(ops, h_, w_, max(r, fc)))
        G, spill, smem = md.plan(h_, w_, nsx, nsy, math.isqrt(KK), r, fc)
        print(f"  M {name}: bound {bound(*work_)[0]:.4f} ms by {bound(*work_)[1]}; placement "
              f"'{md.SPILLS[spill]}' (G={G}, {smem} bytes of shared memory, "
              f"{md.work_bytes(h_, w_, nsx, nsy, math.isqrt(KK), r, fc, G, spill)} of workspace "
              f"a block) {card}", flush=True)
        return d, work_

    # (c) M at 4000 x 4000, S = 16, r = fc = 3
    n = ROS_CELLS
    data = ros_beliefs(16, n, 283, dev)
    eng = Engine(cfg)
    grid = GridMap(data, torch.zeros((16, 2), device=dev), torch.full((16,), 0.05, device=dev))
    m_case(f"{n} x {n} beliefs, S=16, r=3, fc=3", data, eng._dense_ops(grid, None), 3, 3, reps=5,
           plain_reps=2, placements=True)
    del data, grid
    torch.cuda.empty_cache()

    # (d) M at K = 130 on 100 x 100 maps, S = 16
    eng_k = Engine(cfg.replace(num_basis=130))
    small = GridMap(torch.from_numpy(mi_beliefs(16, 100, 100, seed=284)).to(dev),
                    torch.zeros((16, 2), device=dev), torch.full((16,), 0.05, device=dev))
    dom_small = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    d, work = m_case("K=130, 100 x 100 beliefs, S=16, r=3, fc=3", small.data,
                     eng_k._dense_ops(small, dom_small), 3, 3, reps=5, plain_reps=2,
                     placements=True)
    reset_counts()
    got = eng_k.phik_from_grid(small, 3, domain=dom_small)
    torch.cuda.synchronize()
    path = "phase 28, phik_from_grid at K = 130"
    dense = read_dense()
    expect_counts(path, dense, {"phik_dense_fc_tiles": 1})
    if got.shape != (16, 130, 130) or not torch.isfinite(got).all():
        fail(f"{path}: non-finite or mis-shaped")
    entry("phik_dense_fc_tiles_K130", "mi_dense_kernel.cu", DENSE_REPLACES, d["err"], d["ms"],
          d["plain_ms"], work)
    kernels["phik_dense_fc_tiles_K130"].update(library_ms=d["lib_ms"],
                                               launches=dense["phik_dense_fc_tiles"])
    del eng_k, got

    # (e) M through phik_from_grid on a shared domain with a 4500 x 4500 lattice
    eng_l = Engine(cfg.replace(grid_samples=(LATTICE_BIG, LATTICE_BIG), mi_frontier_cells=0))
    reset_counts()
    got = eng_l.phik_from_grid(small, 0, domain=dom_small)
    torch.cuda.synchronize()
    path = f"phase 28, phik_from_grid on a {LATTICE_BIG} x {LATTICE_BIG} lattice"
    dense = read_dense()
    expect_counts(path, dense, {"phik_dense_nofc_global_cx": 1})
    note_launches(path, dense)
    if got.shape != (16, 10, 10) or not torch.isfinite(got).all():
        fail("phase 28: phik_from_grid on the large lattice: non-finite or mis-shaped")
    d, work = m_case(f"a {LATTICE_BIG} x {LATTICE_BIG} lattice of 100 x 100 beliefs, S=16, r=0, "
                     "fc=0", small.data, eng_l._dense_ops(small, dom_small), 0, 0, reps=5,
                     plain_reps=1)
    entry("phik_dense_nofc_global_cx", "mi_dense_kernel.cu", DENSE_REPLACES, d["err"], d["ms"],
          d["plain_ms"], work)
    kernels["phik_dense_nofc_global_cx"]["library_ms"] = d["lib_ms"]
    del eng_l, small, got
    torch.cuda.empty_cache()

    # (f) the mapping loop at 4000 x 4000
    x0, truth = ros_map_case(16, dev, ROS_CELLS)
    eng = Engine(cfg)
    sc = eng.init_scenarios(x0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    sc, belief, cov, traj, metric = eng.explore_mapping_fused(
        sc, truth, n_refreshes=ROS_REFRESHES, refresh_every=MAP_EVERY, sensor_range=1.5,
        sensor_radius_cells=MI_RADIUS)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    path = f"phase 28, the mapping loop at {n} x {n}"
    expect_counts(path, read_counts(), {"fused_solve_safety_map_h0_nb": ROS_REFRESHES * MAP_EVERY})
    maps = read_map()
    expect_counts(f"{path}, the map kernels", maps,
                  {"reveal_raycast": ROS_REFRESHES, "world_global": ROS_REFRESHES,
                   "coverage": ROS_REFRESHES})
    note_launches(path, maps)
    dense = read_dense()
    m_variant = "phik_dense_fc" + md.SPILLS[md.plan(n, n, *gs, cfg.num_basis, MI_RADIUS,
                                                   cfg.mi_frontier_cells)[1]]
    expect_counts(f"{path}, M", dense, {m_variant: ROS_REFRESHES})
    note_launches(path, dense)
    cov_l = cov.tolist()
    moved = (traj[-1, -1, :, :2] - torch.as_tensor(x0[:, :2], device=dev)).norm(dim=1)
    print(f"  coverage per refresh {cov_l}; the robots moved {moved.min().item():.3f} - "
          f"{moved.max().item():.3f} m; {ROS_REFRESHES} refreshes in {loop_s:.2f} s (the first "
          f"the warm-up, capture included); peak device memory {peak / 2**30:.2f} GiB {card}",
          flush=True)
    if (traj.shape != (ROS_REFRESHES, MAP_EVERY, 16, 3) or not torch.isfinite(traj).all()
            or not torch.isfinite(metric).all()):
        fail(f"{path}: non-finite or mis-shaped outputs")
    # from the all-unknown start; no refresh loses a cell (over 200 m the
    # ergodic drive of 20 ticks moves a robot by less than a cell: 0.0 m in
    # the plain loop on the CPU at this extent, so a later rise is not asked)
    if cov_l[0] <= 0.0 or not all(b >= a for a, b in zip(cov_l, cov_l[1:])):
        fail(f"{path}: the coverage did not rise from the unknown start or fell: {cov_l}")
    known = belief.data != -1.0
    if not torch.equal(belief.data[known], truth.data[known]):
        fail(f"{path}: a known cell of the final belief differs from the truth")
    d, work = m_case(f"the mapping loop's beliefs at {n} x {n}, S=16, r=3, fc=3", belief.data,
                     eng._dense_ops(truth, None), MI_RADIUS, cfg.mi_frontier_cells, reps=5,
                     plain_reps=2)
    entry(m_variant, "mi_dense_kernel.cu", DENSE_REPLACES, d["err"], d["ms"], d["plain_ms"], work)
    kernels[m_variant]["library_ms"] = d["lib_ms"]
    ms = events_ms(lambda: eng.explore_mapping_fused(
        sc, truth, n_refreshes=1, refresh_every=MAP_EVERY, sensor_range=1.5,
        sensor_radius_cells=MI_RADIUS), 2)
    print(f"  one refresh of the mapping loop at {n} x {n}, S=16 (a graph replay): {ms:.2f} ms "
          f"{card}", flush=True)
    del eng, sc, belief, truth, traj, metric
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    import torch

    import ergodic_exploration_tpu_torch.ops.edt_kernel as ek
    import ergodic_exploration_tpu_torch.ops.gmm_kernel as gk
    import ergodic_exploration_tpu_torch.ops.mi_dense_kernel as md
    import ergodic_exploration_tpu_torch.ops.mi_kernel as mk
    import ergodic_exploration_tpu_torch.ops.reveal_kernel as rk
    import ergodic_exploration_tpu_torch.ops.solve_kernel as sk
    import ergodic_exploration_tpu_torch.ops.tick_glue as tg
    from ergodic_exploration_tpu_torch.config import default_config
    from ergodic_exploration_tpu_torch.engine import Engine
    from ergodic_exploration_tpu_torch.grid import Domain, GridMap
    from ergodic_exploration_tpu_torch.ops import basis, sensor
    from ergodic_exploration_tpu_torch.ops.distance import DistanceField
    from ergodic_exploration_tpu_torch.ops.patch import extract_patch
    from ergodic_exploration_tpu_torch.ops.target import GaussianMixture
    from ergodic_exploration_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    kernels = {}  # name -> the entry of the kernels line

    def entry(name, source, replaces, err, ms, plain_ms, work):
        b_ms, by = bound(*work)
        kernels[name] = {"name": name, "route": "cuda",
                         "source": f"ergodic_exploration_tpu_torch/csrc/{source}",
                         "replaces": replaces, "launches": 0, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                         "library_ms": None}
        print(f"{name}: {ms:.4f} ms/call, plain version {plain_ms:.4f} ms/call, bound "
              f"{b_ms:.4g} ms by {by} {card}")

    # ---- 1. environment
    print("== 1. environment", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    print(card_line)
    card = f"[{card_line}]"
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    nvcc = subprocess.run([cuda_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    try:
        import triton

        print("triton", triton.__version__)
    except ImportError:
        print("triton absent")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"TF32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # ---- 2. build: one nvcc per source, started together
    print("== 2. build", flush=True)
    t0 = time.perf_counter()
    for name, built in cuda_build.build_all().items():
        print(f"{name}: nvcc {built.seconds:.2f} s -> {built.path.relative_to(ROOT)}")
        fn = ""
        for line in built.log.splitlines():
            m = re.search(r"_Z\d+((?:k\d|glue|m)_[a-z_]+|reveal_kernel|edt_kernel|coverage_kernel)"
                          r"(I(?:L[a-z]\d+E)+E)?", line)
            args = re.findall(r"L[a-z](\d+)E", m.group(2) or "") if m else []
            fn = (m.group(1) + (f"<{', '.join(args)}>" if args else "")) if m else fn
            if "registers" in line or "spill" in line:
                print(f"  ptxas {fn}: {line.replace('ptxas info    :', '').strip()}")
    sk.K1.build()
    gk.K2.build()
    mk.K3.build()
    tg.G.build()
    rk.R.build()
    ek.E.build()
    md.M.build()
    print(f"all libraries built and loaded in {time.perf_counter() - t0:.2f} s")

    # ---- 3. K1 (shared map) against its plain version at path A's shapes
    print(f"== 3. K1 vs plain, S={S_MAIN}, state after {WARM_TICKS} ticks", flush=True)
    engine, sc, world, gmm, domain = build_engine(S_MAIN, dev)
    for _ in range(WARM_TICKS):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    cfg = engine.config
    inp2, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
    inp0 = inp2._replace(refresh=None, phik=sk.refresh_plain(inp2.refresh, inp2.dlen))
    err = 0.0
    for name, inp in (("J=2", inp2), ("J=0", inp0)):
        k, p = sk.K1(cfg, inp), sk.fused_solve_safety_plain(cfg, inp)
        torch.cuda.synchronize()
        err = max(err, compare(name, k, p))
    k1_ms = events_ms(lambda: sk.K1(cfg, inp2), 20)
    plain_ms = events_ms(lambda: sk.fused_solve_safety_plain(cfg, inp2), 5)

    def refresh_and_solve(tag, inp_j2, inp_j0, reps):
        """The refresh alone against its plain version (two launches bit for
        bit), and the refresh and the solve timed apart."""
        r = inp_j2.refresh
        S_ = inp_j2.x.shape[0]
        a, again = sk.K1.refresh(r, inp_j2.dlen), sk.K1.refresh(r, inp_j2.dlen)
        ref = sk.refresh_plain(r, inp_j2.dlen)
        torch.cuda.synchronize()
        e = (a - ref).abs().max().item()
        split = sk.lattice_split(S_, r.pts.shape[0] // sk.LATTICE_CHUNK,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
        r_ms = events_ms(lambda: sk.K1.refresh(r, inp_j2.dlen), reps)
        s_ms = events_ms(lambda: sk.K1(cfg, inp_j0), reps)
        rp_ms = events_ms(lambda: sk.refresh_plain(r, inp_j2.dlen), 5)
        b_ms, by = bound(*refresh_work(S_, int(np.prod(cfg.grid_samples)), KK, 2))
        print(f"{tag}: refresh (k1_refresh + k1_finish) {r_ms:.4f} ms, {split[0]} lattice splits "
              f"of {split[1]} chunks, max |refresh - plain| {e:.3e} (atol {REFRESH_ATOL}), plain "
              f"version {rp_ms:.4f} ms, bound {b_ms:.5f} ms by {by}; k1_solve {s_ms:.4f} ms {card}")
        if e > REFRESH_ATOL or not torch.equal(a, again):
            fail(f"{tag}: the refresh is outside tolerance or two launches differ")

    KK = cfg.num_basis ** 2
    refresh_and_solve(f"S={S_MAIN}", inp2, inp0, 20)
    P = min(cfg.patch_cells, 100)
    crop = extract_patch(world.dist, sc.x[:, :2], P).center_crop(cfg.safety_patch_cells)
    probes = dwa_probes_needed(cfg, engine.model, sc.x, sc.vb, world.domain, crop)
    rf, rb = refresh_work(S_MAIN, int(np.prod(cfg.grid_samples)), KK, 2)  # unpadded lattice
    sf, sb = solve_work(cfg, S_MAIN, P, True, probes, map_cells=100 * 100)
    entry("fused_solve_safety", "solve_kernel.cu",
          "ergodic_exploration_tpu/ops/solve_kernel.py:602", err, k1_ms, plain_ms,
          (rf + sf, rb + sb))

    # ---- 4. path A: the bench tick
    print(f"== 4. path A: Engine.replan_refresh, S={S_MAIN}", flush=True)
    del engine, sc, world, inp0, inp2, k, p, crop
    torch.cuda.empty_cache()
    reset_counts()
    t0 = time.perf_counter()
    engine, sc, world, gmm, domain = build_engine(S_MAIN, dev)
    torch.cuda.synchronize()
    print(f"init_scenarios + prepare_world {1e3 * (time.perf_counter() - t0):.1f} ms {card}")
    expect_counts("path A, prepare_world", read_map(), map_want(0, 1))
    print(f"path A inputs: sha256 of x0, the GMM and the map's free mask "
          f"{digest(sc.x, *gmm, world.free_mask)}")
    torch.cuda.reset_peak_memory_stats()
    for _ in range(5):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    torch.cuda.synchronize()
    reset_counts()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    diverged = torch.zeros(S_MAIN, dtype=torch.bool, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    dwa, metric = [], []
    for _ in range(TIMED_TICKS):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
        diverged |= diag.diverged
        finite &= torch.isfinite(u).all() & torch.isfinite(diag.ergodic_metric).all()
        dwa.append(diag.dwa_active.float().mean())
        metric.append(diag.ergodic_metric.mean())
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    glue_a = read_glue()
    ms = start.elapsed_time(end) / TIMED_TICKS
    expect_counts("path A", counts, {"fused_solve_safety": TIMED_TICKS})
    expect_counts("path A, the glue", glue_a, glue_want(cfg, TIMED_TICKS, in_place=True))
    note_launches("path A", glue_a)
    kernels["fused_solve_safety"]["launches"] = counts["fused_solve_safety"]
    if u.shape != (S_MAIN, cfg.nu) or not bool(finite) or not torch.isfinite(sc.x).all():
        fail("path A produced non-finite or mis-shaped outputs")
    if diverged.any():
        fail(f"{int(diverged.sum())} scenarios diverged")
    print(f"all finite; none diverged; tick (replan_refresh + pose advance): {ms:.4f} ms, "
          f"{S_MAIN * 1e3 / ms:.1f} solves/s {card}")
    print(f"peak device memory over the ticks (world, state and temporaries) "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}")
    print(f"DWA-active share {torch.stack(dwa).mean().item():.4f}, mean ergodic metric "
          f"{torch.stack(metric).mean().item():.6f}")

    # the same ticks with the plain version in K1's place (comparison only):
    # the eager function by name, since the entry point replays its graph
    sk_fn = sk.fused_solve_safety
    sk.fused_solve_safety = sk.fused_solve_safety_plain
    try:
        plain_tick_ms = events_ms(lambda: engine._refresh_and_replan_fn(sc, gmm, domain, world),
                                  5)
    finally:
        sk.fused_solve_safety = sk_fn
    print(f"tick with the plain version in K1's place: {plain_tick_ms:.4f} ms vs "
          f"{ms:.4f} ms with K1 {card}")

    # S=1: the single-robot 10 Hz loop's latency (host clock, synchronized)
    del engine, sc, world
    engine, sc, world, gmm, domain = build_engine(1, dev)
    for _ in range(5):
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        sc = advance(engine, sc, u)
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for _ in range(LATENCY_TICKS):
        t0 = time.perf_counter()
        sc, u, diag = engine.replan_refresh(sc, gmm, domain, world)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        sc = advance(engine, sc, u)
        if bool(diag.diverged.any()) or not bool(torch.isfinite(u).all()):
            fail("S=1 tick diverged or produced non-finite controls")
    expect_counts("path A, S=1", read_counts(), {"fused_solve_safety": LATENCY_TICKS})
    expect_counts("path A, S=1, the glue", read_glue(),
                  glue_want(cfg, LATENCY_TICKS, in_place=True))
    print(f"S=1 replan latency over {LATENCY_TICKS} ticks: p50 {np.percentile(lat, 50):.4f} ms, "
          f"p99 {np.percentile(lat, 99):.4f} ms (budget 100 ms) {card}")
    inp2, _ = sk.fused_tick_inputs(cfg, sc.state, sc.x, sc.vb, None, world, gmm, domain)
    inp0 = inp2._replace(refresh=None, phik=sk.refresh_plain(inp2.refresh, inp2.dlen))
    refresh_and_solve("S=1", inp2, inp0, 50)
    del inp2, inp0

    # ---- 5. the engine on the card against the engine on the CPU (whose
    # K1 is the plain version), one tick from the same state, S=64
    print("== 5. engine on the card vs engine on the CPU, S=64, one tick", flush=True)
    runs = {}
    for d in (dev, torch.device("cpu")):
        e, s_, w_, g_, dm = build_engine(64, d)
        _, u_, dg = e.replan_refresh(s_, g_, dm, w_)
        runs[d.type] = (u_.cpu(), dg.dwa_active.cpu())
    (u_d, a_d), (u_c, a_c) = runs[dev.type], runs["cpu"]
    same = a_d == a_c
    du = (u_d - u_c).abs()[same].max().item()
    print(f"  max |u_card - u_cpu| {du:.3e} (atol 5e-5) over {int(same.sum())} scenarios; "
          f"DWA choice differs in {int((~same).sum())} (limit {CODE_MISMATCH_LIMIT})")
    if du > 5e-5 or int((~same).sum()) > CODE_MISMATCH_LIMIT:
        fail("the engine on the card disagrees with the engine on the CPU")
    del engine, sc, world

    # ---- 6. K2 against its plain version
    print(f"== 6. K2 vs plain, S={S_MAIN}, J=2, 100 x 100 lattice, K=10", flush=True)
    cfg_b, x0_b, grids_b, gmm_b, domain = distinct_case(S_MAIN, dev)
    eng_b = Engine(cfg_b)  # the default device: the card
    if eng_b.device.type != "cuda":
        fail("Engine(cfg) without a device argument is not on the card")
    K = cfg_b.num_basis
    pts = domain.sample_lattice(cfg_b.grid_samples)
    D = basis.dense_table(basis.tables(pts, K, domain), basis.hk_norm(K, domain.lengths))
    N = pts.shape[0]
    free = (grids_b.occupancy_at(pts.expand(S_MAIN, N, 2)) < cfg_b.occupied_threshold).float()
    g_ok = [t.contiguous() for t in gmm_b]
    # degenerate batch: every 7th mixture far outside the domain (phi
    # underflows: both fallbacks), every 11th scenario fully occupied
    g_deg = [t.clone() for t in g_ok]
    g_deg[0][::7] = 400.0
    free_deg = free.clone()
    free_deg[::11] = 0.0
    k2_err = {}

    def k2_check(name, g, mask):
        k_out, p_out = gk.K2(*g, pts, D, mask), gk.phik_from_gmm_plain(*g, pts, D, mask)
        torch.cuda.synchronize()
        e = (k_out - p_out).abs().max().item()
        S_ = g[0].shape[0]
        print(f"  K2 {name} (S={S_}): max |kernel - plain| {e:.3e} (atol {K2_ATOL})")
        if k_out.shape != (S_, K * K) or not torch.isfinite(k_out).all() or e > K2_ATOL:
            fail(f"K2 {name}: outside tolerance, mis-shaped or non-finite")
        key = "phik_from_gmm_masked" if mask is not None else "phik_from_gmm"
        k2_err[key] = max(k2_err.get(key, 0.0), e)

    k2_check("unmasked", g_ok, None)
    k2_check("masked, distinct maps", g_ok, free)
    k2_check("unmasked, degenerate mixtures", g_deg, None)
    k2_check("masked, degenerate mixtures and occupied masks", g_deg, free_deg)
    print(f"  degenerate batch: {len(range(0, S_MAIN, 7))} mixtures moved away, "
          f"{len(range(0, S_MAIN, 11))} masks emptied")
    for S_ in (1, 100):
        k2_check("unmasked, ragged", [t[:S_].contiguous() for t in g_ok], None)
        k2_check("masked, ragged", [t[:S_].contiguous() for t in g_deg],
                 free_deg[:S_].contiguous())
    K2_REPLACES = "ergodic_exploration_tpu/ops/pallas_kernels.py:121"
    # path B gives K2 these mixtures and masks: the masked variant's entry
    entry("phik_from_gmm_masked", "gmm_kernel.cu", K2_REPLACES, k2_err["phik_from_gmm_masked"],
          events_ms(lambda: gk.K2(*g_ok, pts, D, free), 20),
          events_ms(lambda: gk.phik_from_gmm_plain(*g_ok, pts, D, free), 5),
          refresh_work(S_MAIN, N, K * K, 2, True))
    b_ms, by = bound(*refresh_work(S_MAIN, N, K * K, 2))
    print(f"  K2 unmasked at S={S_MAIN}: {events_ms(lambda: gk.K2(*g_ok, pts, D, None), 20):.4f} "
          f"ms/call, plain version "
          f"{events_ms(lambda: gk.phik_from_gmm_plain(*g_ok, pts, D, None), 5):.4f} ms/call, "
          f"bound {b_ms:.5f} ms by {by} {card}")
    s1 = [t[:1].contiguous() for t in g_ok]
    print(f"  K2 at S=1: {events_ms(lambda: gk.K2(*s1, pts, D, None), 50):.4f} ms/call {card}")
    del free, free_deg, g_deg, g_ok, s1
    torch.cuda.empty_cache()

    # ---- 7. path B: the quick-start loop at full width, distinct maps
    print(f"== 7. path B: warmup -> prepare_world -> phik_from_gmm -> explore -> checkpoint, "
          f"S={S_MAIN}, distinct maps", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    # explore of EXPLORE_TICKS captures its graphs here, on the warm-up's
    # dummy inputs of the same shapes: the timed explore below only replays
    warm = eng_b.warmup(S_MAIN, domain, map_shape=(100, 100), gmm_components=2,
                        n_ticks=(EXPLORE_TICKS,))
    print(f"warmup stages (s): {warm}")
    warm_counts = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    world_b = eng_b.prepare_world(grids_b)
    torch.cuda.synchronize()
    prep_ms = 1e3 * (time.perf_counter() - t0)
    prep_peak = torch.cuda.max_memory_allocated() / 2**20
    t0 = time.perf_counter()
    phik_b = eng_b.phik_from_gmm(gmm_b, domain, world_b)
    torch.cuda.synchronize()
    phik_ms = 1e3 * (time.perf_counter() - t0)
    sc_b = eng_b.init_scenarios(x0_b)
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = eng_b.explore(sc_b, phik_b, world_b, n_ticks=EXPLORE_TICKS)
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    glue_b = read_glue()
    ms_b = start.elapsed_time(end) / EXPLORE_TICKS
    expect_counts("path B", counts, {"phik_from_gmm_masked": 1,
                                     "fused_solve_safety_map_h0_nb": EXPLORE_TICKS})
    expect_counts("path B, the glue", glue_b,
                  glue_want(cfg_b, EXPLORE_TICKS, advance=True, in_place=True))
    note_launches("path B", glue_b)
    expect_counts("path B, the map kernels (prepare_world)", read_map(), map_want(0, 1))
    print(f"  (warmup before it launched {({k: v for k, v in warm_counts.items() if v})})")
    nu = cfg_b.nu
    shapes_ok = (out.trajectory.shape == (EXPLORE_TICKS, S_MAIN, 3)
                 and out.controls.shape == (EXPLORE_TICKS, S_MAIN, nu)
                 and all(leaf.shape == (EXPLORE_TICKS, S_MAIN) for leaf in out.diag)
                 and phik_b.shape == (S_MAIN, K, K))
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (out.trajectory, out.controls, out.ergodic_metric, out.diag.barrier_cost,
                  phik_b, out.scenarios.state.U, out.scenarios.state.ck_sum))
    if not shapes_ok or not finite:
        fail("path B produced non-finite or mis-shaped outputs")
    if out.diag.diverged.any():
        fail(f"path B: {int(out.diag.diverged.sum())} scenario-ticks diverged")
    m_first = out.ergodic_metric[:10].mean().item()
    m_last = out.ergodic_metric[-10:].mean().item()
    if not m_last < m_first:
        fail(f"path B: ergodic metric did not fall ({m_first:.6f} -> {m_last:.6f})")
    print(f"all finite; none diverged; mean ergodic metric {m_first:.6f} (first 10 ticks) -> "
          f"{m_last:.6f} (last 10)")
    print(f"explore tick (replan + pose advance, graph replays): {ms_b:.4f} ms, "
          f"{S_MAIN * 1e3 / ms_b:.1f} solves/s {card}")
    print(f"prepare_world (EDT of {S_MAIN} distinct maps) {prep_ms:.1f} ms, peak device memory "
          f"{prep_peak:.1f} MiB (the warm-up's included); phik_from_gmm {phik_ms:.2f} ms (host "
          f"clock) {card}")
    print(f"peak device memory over explore (world, state, outputs, temporaries) "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB {card}")
    print(f"DWA-active share {out.diag.dwa_active.float().mean().item():.4f}; collision codes "
          f"0/1/2: {[int((out.diag.collision_code == c).sum()) for c in (0, 1, 2)]}")
    from ergodic_exploration_tpu_torch.utils.metrics import summarize

    print(f"summarize(out.diag): {json.dumps(summarize(out.diag, EXPLORE_TICKS * ms_b / 1e3))}")

    # checkpoint: 10 more ticks from the loaded state equal 10 from memory
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        path = os.path.join(tmp, "run.npz")
        eng_b.save_checkpoint(path, out.scenarios)
        size = os.path.getsize(path)
        loaded = eng_b.load_checkpoint(path)
    a = eng_b.explore(out.scenarios, phik_b, world_b, 10)
    b = eng_b.explore(loaded, phik_b, world_b, 10)
    torch.cuda.synchronize()
    if not (torch.equal(a.trajectory, b.trajectory) and torch.equal(a.controls, b.controls)
            and torch.equal(a.scenarios.state.rng, b.scenarios.state.rng)):
        fail("explore from the loaded checkpoint differs from explore from memory")
    print(f"checkpoint ({size / 2**20:.1f} MiB) written, read back; 10 ticks from it equal "
          f"10 ticks from memory bit for bit")
    kernels["phik_from_gmm_masked"]["launches"] = counts["phik_from_gmm_masked"]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    prep_ev = events_ms(lambda: eng_b.prepare_world(grids_b), 10)
    print(f"prepare_world again, steady: {prep_ev:.4f} ms (CUDA events), its temporaries peak at "
          f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f} MiB {card}")

    # ---- 8. K1's other variants against the plain version, on that state
    print(f"== 8. K1 per-scenario maps / fused_solve / fused_safety vs plain, state after "
          f"{EXPLORE_TICKS} ticks", flush=True)

    def variants(tag, eng, sc, phik, world, reps):
        """Compare K1 on per-scenario maps (safety on and off; the history as
        drawn positions, as the path hands it over, and as sums) and the
        standalone safety stage on (sc, world); returns per-variant (err, ms,
        plain_ms, work)."""
        from ergodic_exploration_tpu_torch.controller import drawn_history_sums

        c = eng.config
        S_ = sc.x.shape[0]
        inp_nb, _ = sk.fused_tick_inputs(c, sc.state, sc.x, sc.vb, phik, world)
        nb = inp_nb.hist.shape[1]
        sums = drawn_history_sums(inp_nb.hist, inp_nb.nh, c.num_basis, world.domain,
                                  basis.hk_norm(c.num_basis, world.domain.lengths))
        inp_sums = inp_nb._replace(hist=sums.reshape(S_, -1).contiguous())
        P_ = min(c.patch_cells, *world.dist.dist.shape[-2:])
        Pc = min(c.safety_patch_cells, P_)
        crop = extract_patch(world.dist, sc.x[:, :2], P_).center_crop(Pc)
        probes = dwa_probes_needed(c, eng.model, sc.x, sc.vb, world.domain, crop)
        res = {}
        for name, safety, inp in (("fused_solve_safety_map_h0_nb", True, inp_nb),
                                  ("fused_solve_map_h0_nb", False, inp_nb),
                                  ("fused_solve_safety_map_h0", True, inp_sums),
                                  ("fused_solve_map_h0", False, inp_sums)):
            k = sk.K1(c, inp, enable_safety=safety)
            p = sk.fused_solve_safety_plain(c, inp, enable_safety=safety)
            torch.cuda.synchronize()
            e = compare(f"{tag} {name}", k, p)
            res[name] = (e, events_ms(lambda: sk.K1(c, inp, enable_safety=safety), reps),
                         events_ms(lambda: sk.fused_solve_safety_plain(
                             c, inp, enable_safety=safety), 3),
                         solve_work(c, S_, P_, safety, probes if safety else 0.0,
                                    map_cells=S_ * P_ * P_,
                                    nb=nb if name.endswith("_nb") else 0))
        args = (sc.x.contiguous(), sc.vb.contiguous(), p.U_new[:, 0].contiguous(),
                crop.dist.contiguous(), crop.start.to(torch.int32), crop.origin.contiguous(),
                crop.resolution.contiguous(), world.domain.origin.contiguous(),
                world.domain.lengths.contiguous())
        ks, ps = sk.K1.safety(c, *args), sk.fused_safety_plain(c, *args)
        torch.cuda.synchronize()
        e = compare_safety(f"{tag} fused_safety", ks, ps)
        res["fused_safety"] = (e, events_ms(lambda: sk.K1.safety(c, *args), reps),
                               events_ms(lambda: sk.fused_safety_plain(c, *args), 3),
                               safety_work(c, S_, Pc, probes))
        return res

    def show(tag, res, S_):
        for name, (e, k_ms, p_ms, work) in res.items():
            b_ms, by = bound(*work)
            print(f"{tag} {name}: {k_ms:.4f} ms/call, plain version {p_ms:.4f} ms/call, bound "
                  f"{b_ms:.5f} ms by {by}, max err {e:.3e} at S={S_} {card}")

    # path B launched the variant with per-scenario maps, safety on and the
    # history summed in the kernel: its entry, on the state path B reached
    PATH_B_VARIANT = "fused_solve_safety_map_h0_nb"
    res = variants("cart", eng_b, out.scenarios, phik_b, world_b, 20)
    entry(PATH_B_VARIANT, "solve_kernel.cu",
          "ergodic_exploration_tpu/ops/solve_kernel.py:345", *res.pop(PATH_B_VARIANT))
    kernels[PATH_B_VARIANT]["launches"] = counts[PATH_B_VARIANT]
    show("cart", res, S_MAIN)
    del out, a, b, loaded, world_b, phik_b, sc_b, grids_b
    torch.cuda.empty_cache()

    # starts anywhere (inside obstacles too), so that crash codes, the DWA
    # choice and infeasible sweeps are compared as well
    cfg_x, x0_x, grids_x, gmm_x, _ = distinct_case(S_MAIN, dev, seed=6, clearance=None)
    eng_x = Engine(cfg_x)
    world_x = eng_x.prepare_world(grids_x)
    phik_x = eng_x.phik_from_gmm(gmm_x, domain, world_x)
    out_x = eng_x.explore(eng_x.init_scenarios(x0_x), phik_x, world_x, 5)
    variants("cart, starts anywhere", eng_x, out_x.scenarios, phik_x, world_x, 5)
    del out_x, world_x, phik_x, grids_x, eng_x
    torch.cuda.empty_cache()

    S_OMNI = 512
    cfg_o, x0_o, grids_o, gmm_o, _ = distinct_case(S_OMNI, dev, model="omni", seed=2)
    eng_o = Engine(cfg_o)
    world_o = eng_o.prepare_world(grids_o)
    phik_o = eng_o.phik_from_gmm(gmm_o, domain, world_o)
    out_o = eng_o.explore(eng_o.init_scenarios(x0_o), phik_o, world_o, EXPLORE_TICKS)
    if out_o.diag.diverged.any() or not torch.isfinite(out_o.controls).all():
        fail("omni explore diverged or produced non-finite controls")
    res_o = variants(f"omni (nu={cfg_o.nu}, P={cfg_o.patch_cells}, S={S_OMNI})", eng_o,
                     out_o.scenarios, phik_o, world_o, 20)
    show("omni", res_o, S_OMNI)
    del out_o, world_o, phik_o, grids_o, eng_o

    # ---- 9. path C: the default configuration (eager step + fused_safety)
    S_C, T_C = 512, 10
    print(f"== 9. path C: default_config('cart'), S={S_C}, explore {T_C} ticks", flush=True)
    cfg_c, x0_c, grids_c, gmm_c, _ = distinct_case(S_C, dev, seed=3, use_fused_solve=False)
    if cfg_c != default_config("cart"):
        fail("path C is not the default configuration")
    eng_c = Engine(cfg_c)
    reset_counts()
    world_c = eng_c.prepare_world(grids_c)
    phik_c = eng_c.phik_from_gmm(gmm_c, domain)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out_c = eng_c.explore(eng_c.init_scenarios(x0_c), phik_c, world_c, n_ticks=T_C)
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("path C", counts, {"phik_from_gmm": 1, **step_want(cfg_c, T_C)})
    if (out_c.diag.diverged.any() or not torch.isfinite(out_c.controls).all()
            or not torch.isfinite(out_c.trajectory).all()
            or out_c.controls.shape != (T_C, S_C, cfg_c.nu)):
        fail("path C diverged or produced non-finite or mis-shaped outputs")
    print(f"all finite; none diverged; eager tick {start.elapsed_time(end) / T_C:.4f} ms (the "
          f"first call: its graph's warm-up and capture; phase 20 times the replays) at "
          f"S={S_C}; DWA-active share {out_c.diag.dwa_active.float().mean().item():.4f} {card}")
    # both kernels against their plain versions on this path's own inputs
    g_c = [t.contiguous() for t in gmm_c]
    k_out, p_out = gk.K2(*g_c, pts, D, None), gk.phik_from_gmm_plain(*g_c, pts, D, None)
    torch.cuda.synchronize()
    e = (k_out - p_out).abs().max().item()
    if e > K2_ATOL or (k_out.view(S_C, K, K) - phik_c).abs().max().item() > K2_ATOL:
        fail(f"path C: K2 is {e:.3e} from its plain version (atol {K2_ATOL}) or differs from "
             f"what phik_from_gmm returned")
    entry("phik_from_gmm", "gmm_kernel.cu", K2_REPLACES, e,
          events_ms(lambda: gk.K2(*g_c, pts, D, None), 20),
          events_ms(lambda: gk.phik_from_gmm_plain(*g_c, pts, D, None), 5),
          refresh_work(S_C, N, K * K, 2))
    sc_c = out_c.scenarios
    P_c = min(cfg_c.patch_cells, 100)
    crop = extract_patch(world_c.dist, sc_c.x[:, :2], P_c).center_crop(cfg_c.safety_patch_cells)
    e, args, earlier = safety_map_check("path C", cfg_c, sc_c.x, sc_c.vb, sc_c.state.U, world_c)
    probes = dwa_probes_needed(cfg_c, eng_c.model, sc_c.x, sc_c.vb, world_c.domain, crop)
    entry("fused_safety_map", "solve_kernel.cu",
          "ergodic_exploration_tpu/ops/solve_kernel.py:1254", e,
          events_ms(lambda: sk.K1.safety_map(cfg_c, *args), 20),
          events_ms(lambda: sk.fused_safety_map_plain(cfg_c, *args), 3),
          safety_work(cfg_c, S_C, crop.dist.shape[-1], probes))
    kernels["fused_safety_map"]["launches"] = counts["fused_safety_map"]
    print(f"  path C: the route the step took before (the crop's start, gather_window's four "
          f"operations and k1_safety) {events_ms(earlier, 20):.4f} ms/call {card}")
    kernels["phik_from_gmm"]["launches"] = counts["phik_from_gmm"]
    # K1 as the step launches it (no safety stage, per-scenario maps and draws)
    k1_c = sk.k1_variant(False, True, True)
    entry(f"step_{k1_c}", "solve_kernel.cu", "ergodic_exploration_tpu/ops/solve_kernel.py:580",
          *step_k1_check(f"path C {k1_c}", cfg_c, sc_c, phik_c, world_c, 20))
    kernels[f"step_{k1_c}"]["launches"] = counts[k1_c]
    del out_c, world_c, grids_c, sc_c, crop, args, earlier

    # ---- 10. path D: empty world, one Gaussian, safety off (fused_solve)
    T_D = 20
    print(f"== 10. path D: empty world, safety off, S={S_MAIN}, {T_D} ticks", flush=True)
    rng = np.random.default_rng(4)
    x0_d = np.concatenate([rng.uniform(0.05, 4.95, (S_MAIN, 2)),
                           rng.uniform(-np.pi, np.pi, (S_MAIN, 1))], axis=1).astype(np.float32)
    # the target and the domain are made on the CPU, as a caller following
    # the quick start would: the engine moves them to the card
    gmm_d = GaussianMixture.create(np.full((S_MAIN, 1, 2), 2.5, np.float32),
                                   np.tile((0.4 * np.eye(2, dtype=np.float32))[None, None],
                                           (S_MAIN, 1, 1, 1)))
    domain_d = Domain.create(0.0, 0.0, 5.0, 5.0)
    # one shared empty map with one shared history draw (K1 takes the sums),
    # then per-scenario empty maps with per-scenario draws (K1 sums them)
    for shared, variant in ((True, "fused_solve"), (False, "fused_solve_map_h0_nb")):
        cfg_d = default_config("cart").replace(use_fused_solve=True, enable_safety=False,
                                               shared_maps=shared, shared_history_draw=shared)
        eng_d = Engine(cfg_d)
        reset_counts()
        world_d = eng_d.empty_world(domain_d, S_MAIN)
        phik_d = eng_d.phik_from_gmm(gmm_d, domain_d)
        if phik_d.device.type != "cuda" or world_d.dist.dist.device.type != "cuda":
            fail("path D: a target made on the CPU was not moved to the card")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out_d = eng_d.explore(eng_d.init_scenarios(x0_d), phik_d, world_d, n_ticks=T_D)
        end.record()
        torch.cuda.synchronize()
        counts = read_counts()
        expect_counts(f"path D ({variant})", counts, {"phik_from_gmm": 1, variant: T_D})
        if (out_d.diag.diverged.any() or not torch.isfinite(out_d.controls).all()
                or not torch.isfinite(out_d.diag.barrier_cost).all()
                or out_d.diag.dwa_active.any()):
            fail(f"path D ({variant}): diverged, non-finite, or DWA active with safety off")
        print(f"  all finite (barrier on the FAR plateau included: max "
              f"{out_d.diag.barrier_cost.max().item():.4f}); tick "
              f"{start.elapsed_time(end) / T_D:.4f} ms (the first call, capture included) {card}")
        # the variant against its plain version on the state this path reached
        inp, _ = sk.fused_tick_inputs(cfg_d, out_d.scenarios.state, out_d.scenarios.x,
                                         out_d.scenarios.vb, phik_d, world_d)
        k = sk.K1(cfg_d, inp, enable_safety=False)
        p = sk.fused_solve_safety_plain(cfg_d, inp, enable_safety=False)
        torch.cuda.synchronize()
        e = compare(variant, k, p)
        P_d = inp.dist.shape[-1]  # the empty maps are 2 x 2 cells
        entry(variant, "solve_kernel.cu", "ergodic_exploration_tpu/ops/solve_kernel.py:580", e,
              events_ms(lambda: sk.K1(cfg_d, inp, enable_safety=False), 20),
              events_ms(lambda: sk.fused_solve_safety_plain(cfg_d, inp, enable_safety=False), 3),
              solve_work(cfg_d, S_MAIN, P_d, False,
                         map_cells=P_d * P_d * (1 if shared else S_MAIN),
                         nb=0 if shared else cfg_d.buffer_batch))
        kernels[variant]["launches"] = counts[variant]
        del out_d, world_d, inp, k, p

    # ---- 11. explore on the card against explore on the CPU
    print("== 11. explore on the card vs on the CPU, S=64, distinct maps, 3 ticks", flush=True)
    runs = {}
    for d in (dev, torch.device("cpu")):
        c, x0_, g_, gm_, dm_ = distinct_case(64, d, seed=5)
        e_ = Engine(c, device=d)
        w_ = e_.prepare_world(g_)
        o_ = e_.explore(e_.init_scenarios(x0_), e_.phik_from_gmm(gm_, dm_, w_), w_, 3)
        runs[d.type] = (o_.controls.cpu(), o_.trajectory.cpu(), o_.diag.dwa_active.cpu())
    (u_d, x_d, a_d), (u_c, x_c, a_c) = runs[dev.type], runs["cpu"]
    # a scenario counts from its first tick on while its DWA choice agrees
    same = (a_d == a_c).cumprod(0).bool()
    # Positions hold the parity budget (5e-5) at every tick; so do the
    # controls of tick 1, which start from a common state. Later ticks start
    # from states that differ by rounding, and the barrier's 1/d^2 terms
    # amplify that in the controls (PERF.md, "Stiff barrier"): 1e-3 on
    # controls of up to 6 rad/s, with the count above the budget printed.
    u_tol = (5e-5, 1e-3, 1e-3)
    for t in range(3):
        du = (u_d[t] - u_c[t]).abs()[same[t]]
        dx = (x_d[t] - x_c[t]).abs()[same[t]].max().item()
        print(f"  tick {t + 1}: max |u_card - u_cpu| {du.max().item():.3e} (atol {u_tol[t]}; "
              f"{int((du > 5e-5).any(-1).sum())} scenarios above 5e-5), max |x_card - x_cpu| "
              f"{dx:.3e} (atol 5e-5) over {int(same[t].sum())} scenarios")
        if du.max().item() > u_tol[t] or dx > 5e-5:
            fail(f"explore on the card disagrees with explore on the CPU at tick {t + 1}")
    if int((~same[-1]).sum()) > CODE_MISMATCH_LIMIT:
        fail(f"DWA choice differs in {int((~same[-1]).sum())} scenarios")

    # ---- 12. K3 against its plain version and against the dense path
    print(f"== 12. K3 vs plain and vs the dense path, S={S_MAIN}, 100 x 100 beliefs", flush=True)
    K3_REPLACES = "ergodic_exploration_tpu/ops/mi_kernel.py:210"
    fallbacks = {}

    def k3_check(name, data, eng, dom, r):
        """K3 on beliefs ``data`` against the plain version and the dense
        path of ``eng`` (whose configuration gives K, the lattice, fc and the
        threshold); two launches must give the same bits."""
        c = eng.config
        S_, h_, w_ = data.shape
        g = GridMap(data, torch.zeros((S_, 2), device=dev), torch.full((S_,), 0.05, device=dev))
        ops = mk.mi_operands(GridMap(g.data[0], g.origin[0], g.resolution[0]), dom, c.num_basis,
                             c.grid_samples)
        args = (ops, r, c.mi_frontier_cells, c.occupied_threshold)
        k_out, k_again = mk.K3(data, *args), mk.K3(data, *args)
        p_out = mk.phik_from_grid_plain(data, *args)
        d_out = eng._phik_grid_batch_dense_fn(g, dom, r)
        torch.cuda.synchronize()
        n_fb = int((k_out == ops.fallback).all(dim=(1, 2)).sum())
        fallbacks[name] = n_fb
        errs = []
        for what, ref in (("plain", p_out), ("dense path (M)", d_out)):
            err = (k_out - ref).abs()
            bad = int((err > K3_TOL["atol"] + K3_TOL["rtol"] * ref.abs()).sum())
            errs.append(err.max().item())
            print(f"  K3 {name} (S={S_}, {h_} x {w_}, K={c.num_basis}, r={r}, "
                  f"fc={c.mi_frontier_cells}): max |kernel - {what}| {errs[-1]:.3e} (rtol "
                  f"{K3_TOL['rtol']}, atol {K3_TOL['atol']}), {bad} outside; {n_fb} scenarios "
                  f"took the uniform fallback")
            if k_out.shape != (S_, c.num_basis, c.num_basis) or bad \
                    or not torch.isfinite(k_out).all():
                fail(f"K3 {name}: outside tolerance of its {what}, mis-shaped or non-finite")
        if not torch.equal(k_out, k_again):
            fail(f"K3 {name}: two launches on the same inputs differ")
        return errs[0]

    dom5 = Domain.create(0.0, 0.0, 5.0, 5.0, device=dev)
    eng_fc = {fc: Engine(default_config("cart").replace(mi_frontier_cells=fc)) for fc in (3, 0)}
    beliefs = torch.from_numpy(mi_beliefs(S_MAIN, 100, 100)).to(dev)
    for r, fc in ((3, 3), (0, 3), (3, 0)):
        k3_check("distinct beliefs", beliefs, eng_fc[fc], dom5, r)
    if not 0 < fallbacks["distinct beliefs"] < S_MAIN // 50:
        fail("the degenerate scenarios did not take the fallback")
    for S_ in (1, 100):
        k3_check("ragged", beliefs[:S_].contiguous(), eng_fc[3], dom5, 3)
    eng_small = Engine(default_config("cart").replace(num_basis=6, grid_samples=(23, 23)))
    k3_check("small map", torch.from_numpy(mi_beliefs(64, 40, 40, seed=13)).to(dev), eng_small,
             Domain.create(0.0, 0.0, 2.0, 2.0, device=dev), 2)
    # maps the TPU kernel takes (K <= 128, any fc) that K3 refused before
    for (h_, K_, ns_, r_, fc_) in ((8, 10, (10, 10), 1, 3), (40, 6, (23, 23), 2, 200),
                                   (40, 20, (23, 23), 5, 3)):
        eng_r = Engine(default_config("cart").replace(num_basis=K_, grid_samples=ns_,
                                                      mi_frontier_cells=fc_))
        k3_check("once refused", torch.from_numpy(
            mi_beliefs(64, h_, h_, seed=18)).to(dev), eng_r,
            Domain.create(0.0, 0.0, 0.05 * h_, 0.05 * h_, device=dev), r_)
    del eng_r
    print("  two launches on the same inputs gave the same bits at every shape")
    # 200 x 200 beliefs are over what each of four blocks an SM can hold: the row-band form
    dom_big = Domain.create(0.0, 0.0, 0.05 * CELLS_BIG, 0.05 * CELLS_BIG, device=dev)
    beliefs_big = torch.from_numpy(mi_beliefs(S_BIG, CELLS_BIG, CELLS_BIG, seed=16)).to(dev)
    reset_counts()
    for r, fc, S_ in ((3, 3, S_BIG), (0, 3, 128), (3, 0, 128)):
        bh, n_bands = mk.band_plan(CELLS_BIG, CELLS_BIG, 10, r, fc)
        k3_check(f"row bands ({n_bands} of {bh} rows)", beliefs_big[:S_].contiguous(), eng_fc[fc],
                 dom_big, r)
    if not 0 < fallbacks[f"row bands ({n_bands} of {bh} rows)"] < 128:
        fail("the degenerate scenarios of the banded case did not take the fallback")
    expect_counts("phase 12, 200 x 200 beliefs", read_counts(),
                  {"phik_from_grid_fc_banded": 4, "phik_from_grid_nofc_banded": 2})
    del beliefs_big
    del beliefs, eng_fc, eng_small
    torch.cuda.empty_cache()

    # ---- 13. path E: the MI tick at full width
    print(f"== 13. path E: Engine.replan_refresh_mi with K3, S={S_MAIN}", flush=True)

    def mi_ticks(engine, sc, belief, truth, world, dom, n, use_kernel, check=None):
        """n ticks: reveal a disc around each pose, replan with the MI target
        recomputed from the beliefs, advance the poses."""
        for _ in range(n):
            belief = sensor.reveal(belief, truth, sc.x, REVEAL_RANGE)
            sc, u, diag = engine.replan_refresh_mi(sc, belief, world,
                                                   sensor_radius_cells=MI_RADIUS, domain=dom,
                                                   use_mi_kernel=use_kernel)
            sc = advance(engine, sc, u)
            if check is not None:
                check(u, diag)
        return sc, belief

    engine, sc, belief, truth, world, domain = mi_case(S_MAIN, dev)
    print(f"path E inputs: sha256 of x0, the beliefs and the true map "
          f"{digest(sc.x, belief.data, truth.data)}")
    known0 = sensor.fraction_known(belief)
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, 5, True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    diverged = torch.zeros(S_MAIN, dtype=torch.bool, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    dwa = []

    def check_e(u, diag):
        nonlocal finite, diverged
        diverged |= diag.diverged
        finite &= torch.isfinite(u).all() & torch.isfinite(diag.ergodic_metric).all()
        dwa.append(diag.dwa_active.float().mean())

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, TIMED_TICKS, True, check_e)
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    ms_e = start.elapsed_time(end) / TIMED_TICKS
    expect_counts("path E", counts, {"phik_from_grid_fc": TIMED_TICKS,
                                     "fused_solve_safety": TIMED_TICKS})
    if not bool(finite) or not torch.isfinite(sc.x).all() or diverged.any():
        fail("path E diverged or produced non-finite outputs")
    known1 = sensor.fraction_known(belief)
    if not known1 > known0:
        fail("path E: the beliefs did not evolve between ticks")
    print(f"all finite; none diverged; beliefs known {known0.item():.4f} -> {known1.item():.4f}; "
          f"MI tick (reveal + replan_refresh_mi + pose advance): {ms_e:.4f} ms, "
          f"{S_MAIN * 1e3 / ms_e:.1f} solves/s {card}")
    print(f"peak device memory over the ticks {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB; "
          f"DWA-active share {torch.stack(dwa).mean().item():.4f} {card}")
    # K3 on the beliefs this path reached: the entry of the kernels line
    cfg = engine.config
    ops = mk.mi_operands(GridMap(belief.data[0], belief.origin[0], belief.resolution[0]), domain,
                         cfg.num_basis, cfg.grid_samples)
    k3_args = (ops, MI_RADIUS, cfg.mi_frontier_cells, cfg.occupied_threshold)
    err = k3_check("path E's beliefs", belief.data, engine, domain, MI_RADIUS)
    entry("phik_from_grid_fc", "mi_kernel.cu", K3_REPLACES, err,
          events_ms(lambda: mk.K3(belief.data, *k3_args), 20),
          events_ms(lambda: mk.phik_from_grid_plain(belief.data, *k3_args), 5),
          mi_work(S_MAIN, 100, 100, cfg.num_basis, MI_RADIUS, cfg.mi_frontier_cells))
    kernels["phik_from_grid_fc"]["launches"] = counts["phik_from_grid_fc"]
    one = belief.data[:1].clone()  # a copy: a view would keep all S_MAIN maps alive
    b_ms, by = bound(*mi_work(1, 100, 100, cfg.num_basis, MI_RADIUS, cfg.mi_frontier_cells))
    print(f"  K3 at S=1 on this path's beliefs: {events_ms(lambda: mk.K3(one, *k3_args), 200):.4f} "
          f"ms/call, plain version "
          f"{events_ms(lambda: mk.phik_from_grid_plain(one, *k3_args), 20):.4f} ms/call, bound "
          f"{b_ms:.4g} ms by {by} {card}")
    del one
    # continuous beliefs: no cell at -1, 0 or 1, every entropy through the logs
    cont = torch.from_numpy(np.random.default_rng(17).uniform(
        0.0, 1.0, (S_MAIN, 100, 100)).astype(np.float32)).to(dev)
    err_c = k3_check("continuous beliefs", cont, engine, domain, MI_RADIUS)
    print(f"  K3 on continuous beliefs at S={S_MAIN}: "
          f"{events_ms(lambda: mk.K3(cont, *k3_args), 20):.4f} ms/call against "
          f"{kernels['phik_from_grid_fc']['ms']:.4f} on path E's (max |kernel - plain| "
          f"{err_c:.3e}), plain version "
          f"{events_ms(lambda: mk.phik_from_grid_plain(cont, *k3_args), 3):.4f} ms/call {card}")
    del cont
    dense_ms = events_ms(lambda: engine._phik_grid_batch_dense_fn(belief, domain, MI_RADIUS), 5)
    print(f"  the dense path on the same beliefs (M, the stand-in a faster K3 is compared with, no "
          f"library call): {dense_ms:.4f} ms/call {card}")
    # the same tick with the dense path (M) in K3's place
    reset_counts()
    start.record()
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, TIMED_TICKS, False)
    end.record()
    torch.cuda.synchronize()
    expect_counts("path E, dense refresh", read_counts(), {"fused_solve_safety": TIMED_TICKS})
    expect_counts("path E, dense refresh, M", read_dense(), dense_want(TIMED_TICKS))
    print(f"the same tick with use_mi_kernel=False (dense path, M): "
          f"{start.elapsed_time(end) / TIMED_TICKS:.4f} ms vs {ms_e:.4f} ms with K3 {card}")
    e_run = dict(data=belief.data.clone(), origin=belief.origin, resolution=belief.resolution,
                 domain=domain, cfg=engine.config)  # for phase 25
    del engine, sc, belief, truth, world
    torch.cuda.empty_cache()

    # without the frontier mask (mi_frontier_cells=0): K3's other variant
    T_NOFC = 10
    engine, sc, belief, truth, world, domain = mi_case(S_MAIN, dev, mi_frontier_cells=0)
    reset_counts()
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, T_NOFC, True)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("path E, no frontier mask", counts, {"phik_from_grid_nofc": T_NOFC,
                                                       "fused_solve_safety": T_NOFC})
    if not torch.isfinite(sc.x).all():
        fail("path E without the frontier mask produced non-finite poses")
    k3_args = (ops, MI_RADIUS, 0, cfg.occupied_threshold)
    err = k3_check("path E's beliefs, no frontier mask", belief.data, engine, domain, MI_RADIUS)
    entry("phik_from_grid_nofc", "mi_kernel.cu", K3_REPLACES, err,
          events_ms(lambda: mk.K3(belief.data, *k3_args), 20),
          events_ms(lambda: mk.phik_from_grid_plain(belief.data, *k3_args), 5),
          mi_work(S_MAIN, 100, 100, cfg.num_basis, MI_RADIUS, 0))
    kernels["phik_from_grid_nofc"]["launches"] = counts["phik_from_grid_nofc"]
    # the dense path without the frontier mask: M's other variant
    reset_counts()
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, T_NOFC, False)
    torch.cuda.synchronize()
    expect_counts("path E, dense refresh, no frontier mask", read_counts(),
                  {"fused_solve_safety": T_NOFC})
    dense_nofc = read_dense()
    expect_counts("path E, dense refresh, no frontier mask, M", dense_nofc,
                  dense_want(T_NOFC, fc=False))
    nsx, nsy = cfg.grid_samples
    d = dense_check("path E's beliefs, no frontier mask", belief.data,
                    engine._dense_ops(belief, domain), MI_RADIUS, 0, cfg.occupied_threshold, card)
    entry("phik_dense_nofc", "mi_dense_kernel.cu", DENSE_REPLACES, d["err"], d["ms"],
          d["plain_ms"], dense_work(S_MAIN, 100, 100, nsx, nsy, cfg.num_basis ** 2, MI_RADIUS, 0,
                                    d["nnz"]))
    kernels["phik_dense_nofc"].update(library_ms=d["lib_ms"],
                                      launches=dense_nofc["phik_dense_nofc"])
    del engine, sc, belief, truth, world
    torch.cuda.empty_cache()

    # 200 x 200 beliefs (a 10 m map): K3 takes its row-band form
    engine, sc, belief, truth, world, domain = mi_case(S_BIG, dev, cells=CELLS_BIG)
    known0 = sensor.fraction_known(belief)
    reset_counts()
    start.record()
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, T_BIG, True)
    end.record()
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts(f"path E, {CELLS_BIG} x {CELLS_BIG} beliefs", counts,
                  {"phik_from_grid_fc_banded": T_BIG, "fused_solve_safety": T_BIG})
    if not torch.isfinite(sc.x).all() or not sensor.fraction_known(belief) > known0:
        fail("path E on 200 x 200 beliefs: non-finite poses or beliefs that did not evolve")
    print(f"all finite; MI tick on {CELLS_BIG} x {CELLS_BIG} beliefs at S={S_BIG}: "
          f"{start.elapsed_time(end) / T_BIG:.4f} ms {card}")
    ops_big = mk.mi_operands(GridMap(belief.data[0], belief.origin[0], belief.resolution[0]),
                             domain, cfg.num_basis, cfg.grid_samples)
    k3_args = (ops_big, MI_RADIUS, cfg.mi_frontier_cells, cfg.occupied_threshold)
    err = k3_check("path E's 200 x 200 beliefs", belief.data, engine, domain, MI_RADIUS)
    entry("phik_from_grid_fc_banded", "mi_kernel.cu", K3_REPLACES, err,
          events_ms(lambda: mk.K3(belief.data, *k3_args), 20),
          events_ms(lambda: mk.phik_from_grid_plain(belief.data, *k3_args), 5),
          mi_work(S_BIG, CELLS_BIG, CELLS_BIG, cfg.num_basis, MI_RADIUS, cfg.mi_frontier_cells))
    kernels["phik_from_grid_fc_banded"]["launches"] = counts["phik_from_grid_fc_banded"]
    del engine, sc, belief, truth, world
    torch.cuda.empty_cache()

    # S=1: the single robot's MI tick latency (host clock, synchronized)
    engine, sc, belief, truth, world, domain = mi_case(1, dev)
    sc, belief = mi_ticks(engine, sc, belief, truth, world, domain, 5, True)
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for _ in range(LATENCY_TICKS):
        t0 = time.perf_counter()
        belief = sensor.reveal(belief, truth, sc.x, REVEAL_RANGE)
        sc, u, diag = engine.replan_refresh_mi(sc, belief, world, sensor_radius_cells=MI_RADIUS,
                                               domain=domain, use_mi_kernel=True)
        torch.cuda.synchronize()
        lat.append(1e3 * (time.perf_counter() - t0))
        sc = advance(engine, sc, u)
        if bool(diag.diverged.any()) or not bool(torch.isfinite(u).all()):
            fail("S=1 MI tick diverged or produced non-finite controls")
    expect_counts("path E, S=1", read_counts(), {"phik_from_grid_fc": LATENCY_TICKS,
                                                 "fused_solve_safety": LATENCY_TICKS})
    print(f"S=1 MI tick latency (reveal + replan_refresh_mi) over {LATENCY_TICKS} ticks: p50 "
          f"{np.percentile(lat, 50):.4f} ms, p99 {np.percentile(lat, 99):.4f} ms (budget 100 ms) "
          f"{card}")
    del engine, sc, belief, truth, world

    # ---- 14. path F: the mapping loop at full width
    print(f"== 14. path F: explore_mapping_fused, S={S_MAIN}, {MAP_REFRESHES} refreshes of "
          f"{MAP_EVERY} ticks, sensor range 1.5 m", flush=True)
    cfg_f, x0_f, truth_f = mapping_case(S_MAIN, dev)
    eng_f = Engine(cfg_f)
    sc_f = eng_f.init_scenarios(x0_f)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    start.record()
    sc_f, belief_f, cov, traj, metric = eng_f.explore_mapping_fused(
        sc_f, truth_f, n_refreshes=MAP_REFRESHES, refresh_every=MAP_EVERY, sensor_range=1.5)
    end.record()
    torch.cuda.synchronize()
    ms_f = start.elapsed_time(end) / MAP_REFRESHES
    peak_f = torch.cuda.max_memory_allocated()
    expect_counts("path F", read_counts(),
                  {"fused_solve_safety_map_h0_nb": MAP_REFRESHES * MAP_EVERY})
    map_f = read_map()
    expect_counts("path F, the map kernels", map_f, map_want(MAP_REFRESHES, MAP_REFRESHES))
    note_launches("path F", map_f)
    dense_f = read_dense()
    expect_counts("path F, M", dense_f, dense_want(MAP_REFRESHES))
    note_launches("path F", dense_f)
    cov_l = cov.tolist()
    print(f"coverage per refresh {[round(c, 4) for c in cov_l]}")
    if (traj.shape != (MAP_REFRESHES, MAP_EVERY, S_MAIN, 3) or cov.shape != (MAP_REFRESHES,)
            or metric.shape != (MAP_REFRESHES, MAP_EVERY, S_MAIN)
            or not torch.isfinite(traj).all() or not torch.isfinite(metric).all()):
        fail("path F produced non-finite or mis-shaped outputs")
    if not all(b > a for a, b in zip(cov_l, cov_l[1:])) or cov_l[-1] - cov_l[0] < 0.02:
        fail(f"path F: coverage did not rise by 0.02 over the refreshes: {cov_l}")
    xy = traj[..., :2]
    if not ((xy >= 0.0) & (xy <= 5.0)).all():
        fail("path F: a pose left the domain")
    known = belief_f.data != -1.0
    if not torch.equal(belief_f.data[known], truth_f.data[known]):
        fail("path F: a known cell of the final belief differs from the truth")
    field = DistanceField.from_grid(GridMap(truth_f.data[0], truth_f.origin[0],
                                            truth_f.resolution[0]))
    cell = torch.clamp(torch.round(xy / 0.05 - 0.5).long(), 0, 99)
    clearance = field.dist[cell[..., 1], cell[..., 0]]
    print(f"all finite; every pose inside the domain; every known cell equals the truth; min "
          f"clearance of the trajectories over the TRUE map {clearance.min().item():.3f} m "
          f"(reported: the robots plan on their beliefs); share of poses under the 0.2 m "
          f"footprint radius {(clearance < 0.2).float().mean().item():.5f}")
    print(f"one refresh (reveal + MI target + world + {MAP_EVERY} ticks; the first of the "
          f"{MAP_REFRESHES} the warm-up, capture included): {ms_f:.1f} ms; peak "
          f"device memory over the loop {peak_f / 2**20:.1f} MiB {card}")
    # the split of one refresh, each stage alone on the state the loop reached
    win = sensor.raycast_window_cells(1.5, 0.05)
    dom_f = Domain(truth_f.origin[0], truth_f.domain().lengths[0])
    thr_f = cfg_f.occupied_threshold
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t_reveal = events_ms(lambda: sensor.reveal_raycast(
        belief_f, truth_f, sc_f.x, 1.5, win, occupied_threshold=thr_f), 20)
    reveal_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    t_reveal_plain = events_ms(lambda: sensor.reveal_raycast_plain(
        belief_f, truth_f, sc_f.x, 1.5, win, occupied_threshold=thr_f), 2)
    plain_peak = torch.cuda.max_memory_allocated() - base
    peaks = {}

    def stage_peak(name, fn):
        torch.cuda.reset_peak_memory_stats()
        fn()
        torch.cuda.synchronize()
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**20

    stage_peak("dense MI target", lambda: eng_f._phik_grid_batch_dense_fn(belief_f, dom_f, 0))
    stage_peak("world rebuild", lambda: eng_f._world_batched(belief_f, belief_f.domain()))
    stage_peak("E without the mask", lambda: DistanceField.from_grid(belief_f, thr_f))
    t_phik = events_ms(lambda: eng_f._phik_grid_batch_dense_fn(belief_f, dom_f, 0), 20)
    t_world = events_ms(lambda: eng_f._world_batched(belief_f, belief_f.domain()), 5)
    t_edt = events_ms(lambda: DistanceField.from_grid(belief_f, thr_f), 20)
    t_edt_plain = events_ms(lambda: ek.edt_field_plain(belief_f.data, belief_f.resolution,
                                                       thr_f), 2)
    t_free = events_ms(lambda: (belief_f.occupancy_at(belief_f.domain().sample_lattice(
        cfg_f.grid_samples)) < thr_f).to(torch.float32), 20)
    phik_f = eng_f._phik_grid_batch_dense_fn(belief_f, dom_f, 0)
    world_f = eng_f._world_batched(belief_f, belief_f.domain())
    t_ticks = events_ms(lambda: eng_f.explore(sc_f, phik_f, world_f, MAP_EVERY), 2)
    print(f"  split: reveal kernel {t_reveal:.4f} ms (its plain version {t_reveal_plain:.1f} ms; "
          f"temporaries peak at {reveal_peak / 2**20:.1f} MiB, the plain version's at "
          f"{plain_peak / 2**20:.1f} MiB), dense MI target (M) {t_phik:.4f} ms, world rebuild "
          f"{t_world:.4f} ms (one launch of E with the free mask; E without the mask "
          f"{t_edt:.4f} ms, its plain version {t_edt_plain:.1f} ms; the free mask alone as plain "
          f"torch {t_free:.4f} ms), {MAP_EVERY} ticks {t_ticks:.2f} ms {card}")
    print("  the temporaries' peak of each stage alone (MiB): " + ", ".join(
        f"{k} {v:.1f}" for k, v in peaks.items()) + f" {card}")
    if reveal_peak > REVEAL_PEAK_LIMIT:
        fail(f"reveal_raycast held {reveal_peak / 2**30:.2f} GiB at S={S_MAIN}")
    # M on the beliefs path F reached: the entry of the kernels line
    nsx, nsy = cfg_f.grid_samples
    fc_f = cfg_f.mi_frontier_cells
    d = dense_check("path F's beliefs", belief_f.data, eng_f._dense_ops(belief_f, dom_f), 0, fc_f,
                    thr_f, card, placements=True)
    entry("phik_dense_fc", "mi_dense_kernel.cu", DENSE_REPLACES, d["err"], d["ms"], d["plain_ms"],
          dense_work(S_MAIN, 100, 100, nsx, nsy, cfg_f.num_basis ** 2, 0, fc_f, d["nnz"]))
    kernels["phik_dense_fc"]["library_ms"] = d["lib_ms"]
    # for phase 24: the poses each refresh revealed from, the final belief
    f_run = dict(truth=truth_f, x=[torch.as_tensor(x0_f, device=dev)] + [traj[r, -1] for r in
                                                                        range(MAP_REFRESHES - 1)],
                 belief=belief_f.data, thr=thr_f, win=win, grid_samples=cfg_f.grid_samples,
                 cfg=cfg_f, dom=dom_f)
    del sc_f, belief_f, traj, metric, phik_f, world_f, field, clearance, cell, xy, known
    torch.cuda.empty_cache()

    # ---- 15. the MI tick and the mapping loop on the card against the CPU
    print("== 15. MI tick (S=64) and mapping loop (S=16) on the card vs on the CPU", flush=True)
    runs = {}
    for d in (dev, torch.device("cpu")):
        e_, s_, b_, t_, w_, dm_ = mi_case(64, d)
        b_ = sensor.reveal(b_, t_, s_.x, REVEAL_RANGE)
        reset_counts()
        _, u_, dg = e_.replan_refresh_mi(s_, b_, w_, sensor_radius_cells=MI_RADIUS, domain=dm_,
                                         use_mi_kernel=True)
        if read_counts()["phik_from_grid_fc"] != int(d.type == "cuda"):
            fail(f"the MI tick on {d.type} launched K3 "
                 f"{read_counts()['phik_from_grid_fc']} times")
        runs[d.type] = (u_.cpu(), dg.dwa_active.cpu(), dg.collision_code.cpu())
    (u_d, a_d, c_d), (u_c, a_c, c_c) = runs[dev.type], runs["cpu"]
    same = (a_d == a_c) & (c_d == c_c)
    du = (u_d - u_c).abs()[same].max().item()
    print(f"  MI tick: max |u_card - u_cpu| {du:.3e} (atol 5e-5) over {int(same.sum())} "
          f"scenarios; code or DWA choice differs in {int((~same).sum())} (limit "
          f"{CODE_MISMATCH_LIMIT})")
    if du > 5e-5 or int((~same).sum()) > CODE_MISMATCH_LIMIT:
        fail("the MI tick on the card disagrees with the MI tick on the CPU")
    runs = {}
    for d in (dev, torch.device("cpu")):
        c, x0_, t_ = mapping_case(16, d, seed=15)
        e_ = Engine(c, device=d)
        _, b_, cov_, _, _ = e_.explore_mapping_fused(e_.init_scenarios(x0_), t_, n_refreshes=2,
                                                     refresh_every=5, sensor_range=1.5)
        runs[d.type] = (b_.data.cpu(), cov_.cpu())
    (b_d, cov_d), (b_c, cov_c) = runs[dev.type], runs["cpu"]
    n_diff, dcov = int((b_d != b_c).sum()), (cov_d - cov_c).abs().max().item()
    print(f"  mapping loop: {n_diff} of {b_d.numel()} belief cells differ (budget 0.1 %: atan2 "
          f"and atan may differ in the last bit at a bin edge); max coverage difference "
          f"{dcov:.2e} (limit 1e-3)")
    if n_diff > 1e-3 * b_d.numel() or dcov > 1e-3:
        fail("the mapping loop on the card disagrees with the mapping loop on the CPU")

    def at(phase):
        print(f"(phase {phase} starts at {time.perf_counter() - t_start:.1f} s)", flush=True)

    at(16)
    node_phase(dev, card, entry, kernels)
    at(17)
    scale_out_phase(dev, card, entry, kernels)
    at(18)
    quality_phase(dev, card, entry, kernels)
    at(19)
    headline_phase(dev, card, kernels, k3_check, ms, ms_e)
    at(20)
    graphs_phase(dev, card)
    at(21)
    wide_phase(dev, card, entry, kernels)
    at(22)
    entry_graphs_phase(dev, card)
    at(23)
    glue_phase(dev, card, entry, kernels)
    at(24)
    map_kernels_phase(dev, card, entry, f_run)
    at(25)
    dense_phase(dev, card, entry, kernels, e_run, f_run)
    at(26)
    states = default_step_phase(dev, card)["states"]
    at(27)
    last_stages_phase(dev, card, entry, kernels, f_run, states)
    del f_run, e_run, states
    at(28)
    map_sizes_phase(dev, card, entry, kernels)
    for name, (n, path) in LAUNCHES.items():
        if name in kernels:
            kernels[name]["launches"] = n
            print(f"{name}: {n} launches on {path}")

    missing = [k for k, v in kernels.items() if v["launches"] < 1]
    if missing:
        fail(f"kernels never launched on a driven path: {missing}")
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
