"""Exploration episodes on gmapping's default map: ``mapping.py``'s episodes
(one ``Engine.explore_mapping_fused`` call each, S robots spawned afresh
from the seed with unknown beliefs, ``refreshes`` refreshes of the reveal
R, the dense MI target M, the world rebuild E and ``refresh_every`` ticks)
on a (cells, cells) frame whose hidden world is the quality run's building
tiled ``building_tiles`` x ``building_tiles`` into a floor at the frame's
centre, free elsewhere. The frame is centred on the configuration's
``fleet.domain``.

Traffic parameters: those of ``mapping.py``, and ``building_tiles``. The
frame's side is the configuration's ``fleet.cells``; a test's ``scale`` may
shrink it (``cells``) and the tiles.

What differs from ``mapping.Driver`` (whose ``release`` and ``check`` these
are):

- the truth and the spawns: the floor's clearance is one building's
  (``gen.clearance``) tiled, which is exact because every tile's outer
  wall is whole (a cell's nearest wall lies in its own tile), so no
  distance transform of the frame runs on the host; the spawns are drawn
  inside the floor;
- the reference's world rebuild: ``RefEngine._world`` on
  ``reference/ops/edt_blocked.py`` (the frozen version's bits; the frozen
  passes would hold 256 GB a map at 4000 x 4000), in the check and, where
  the reference or the control stands in the program's place, in its
  episodes;
- the world E builds, read: after the window, for each compared episode,
  the program builds the world (``prepare_world``, the same world rebuild
  its refresh runs) of the checked scenarios' beliefs at the refreshes the
  check follows it to (the last refresh, from the episode's final beliefs,
  and the refresh before each rerun prefix's end, from the prefix's final
  beliefs). The check compares each with the world the reference builds
  from its own beliefs there: ``world_cells_off`` counts the elements of
  the distance, the gradient and the free mask that differ, exactly;
- the window's counts: the program's ``counters()`` are read after set-up
  and first thing in ``release``. After the check ``facts`` holds the
  window's launches of E and M, summed and by variant
  (``window_launches``, only the counts that grew); None where the program
  reports none (the reference, or a port without these counters). Standard
  error gets a line of them.
"""

from __future__ import annotations

import sys
import types

import numpy as np
import torch

from eebench import gen, program
from eebench.drivers import (Samples, abs_gap, cells_off, k1_facts, later_points, limits, mapping,
                             p99, rel_gap, ring_off, take_rows)
from eebench.reference.controller import World
from eebench.reference.engine import RefEngine
from eebench.reference.ops.distance import DistanceField
from eebench.reference.ops.edt_blocked import world_plain

TILE = 100  # cells a side of gen.building()


def tiled_floor(cells: int, tiles: int, res: float):
    """(truth (cells, cells) float32, clearance (cells, cells) in m, 0 off
    the floor, the floor's first cell, its last cell + 1): the building
    tiled ``tiles`` x ``tiles`` at the centre of a free frame."""
    side = TILE * tiles
    lo = (cells - side) // 2
    if lo < 0:
        raise ValueError(f"{tiles} x {tiles} buildings do not fit {cells} x {cells} cells")
    truth = np.zeros((cells, cells), np.float32)
    clear = np.zeros((cells, cells), np.float32)
    building = gen.building()
    truth[lo:lo + side, lo:lo + side] = np.tile(building, (tiles, tiles))
    clear[lo:lo + side, lo:lo + side] = np.tile(gen.clearance(building, res), (tiles, tiles))
    return truth, clear, lo, lo + side


def blocked_world(ref, grids, dom) -> World:
    """``RefEngine._world`` on the blocked passes (the same bits)."""
    cfg = ref.config
    d, g, free = world_plain(grids, dom, cfg.occupied_threshold, cfg.grid_samples)
    return World(domain=dom, dist=DistanceField(d, g, grids.origin, grids.resolution),
                 free_mask=free)


def _counters(prog):
    """The port's ``counters()``, or None for the reference and for a port
    without them."""
    if prog.name != "port":
        return None
    try:
        from ergodic_exploration_tpu_torch.utils.profiling import counters
    except ImportError:
        return None
    return counters()


def _off(got: torch.Tensor, want: torch.Tensor) -> int:
    """``cells_off`` where the tensors lie (a world is 3 GB at this size)."""
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want.to(got.device)).sum())


class Driver(mapping.Driver):
    def _spawns(self, episode: int):
        res = self.ctx.config["fleet"]["resolution"]
        x = gen.spawn(gen.rng(self.ctx.seed, 10, episode + 1), self.ctx.scenarios, self.clear,
                      res, self.need, self.floor[0] * res, self.floor[1] * res)
        x[:, :2] += self.origin
        return x

    def _truth(self, prog, device):
        g = super()._truth(prog, device)
        origin = torch.as_tensor(self.origin, dtype=g.origin.dtype, device=device)
        return g._replace(origin=origin.expand_as(g.origin).contiguous())

    def _rows(self):
        """The scenarios whose beliefs the check follows (``mapping.py``'s)."""
        ctx = self.ctx
        return np.sort(gen.rng(ctx.seed, 98).choice(
            ctx.scenarios, min(ctx.param("check_rows"), ctx.scenarios), replace=False))

    def _world(self, belief):
        """The program's world of the checked scenarios' ``belief``."""
        rows = torch.as_tensor(self._rows(), device=belief.data.device)
        w = self.engine.prepare_world(belief._replace(
            data=belief.data[rows], origin=belief.origin[rows],
            resolution=belief.resolution[rows]))
        return w.dist.dist, w.dist.grad, w.free_mask

    def setup(self):
        ctx = self.ctx
        self.cfg = ctx.engine_config
        f = ctx.config["fleet"]
        cells = int(ctx.scale.get("cells", f["cells"]))
        self.truth, self.clear, *self.floor = tiled_floor(cells, int(ctx.param("building_tiles")),
                                                          f["resolution"])
        dom = f["domain"]
        self.origin = np.array([(dom[0] + dom[2]) / 2, (dom[1] + dom[3]) / 2],
                               np.float32) - cells * f["resolution"] / 2
        self.need = self.cfg["boundary_radius"] + self.cfg["d_safe"]
        self.engine = ctx.program.make_engine(self.cfg, ctx.device)
        if isinstance(self.engine, RefEngine):
            self.engine._world = types.MethodType(blocked_world, self.engine)
        self.truth_grid = self._truth(ctx.program, self.engine.device)
        sc = self.engine.init_scenarios(self._spawns(-1))
        self._episode(sc)[2].cpu()  # the refresh's graph is captured and replayed
        self.samples = Samples(ctx.seed, ctx.param("samples"))
        self.i = 0
        self.before = _counters(ctx.program)

    def release(self):
        """``mapping.Driver.release``, and the program's worlds at the
        refreshes the check follows it to (module docstring)."""
        self.after = _counters(self.ctx.program)
        self.later, self.worlds = {}, {}
        for i, (x0, out) in self.samples.all():
            self.worlds[i] = {self.refreshes - 1: self._world(out[1])}
            for k in later_points(gen.rng(self.ctx.seed, 97, i), 2, self.refreshes):
                sc_k, belief_k, _, traj_k, _ = self._episode(self.engine.init_scenarios(x0), k)
                self.later.setdefault(i, {})[k] = (sc_k, cells_off(traj_k, out[3][:k]))
                self.worlds[i][k - 1] = self._world(belief_k)
        self.engine = None

    def check(self):
        """``mapping.Driver.check`` with the reference's world on the blocked
        passes, and ``world_cells_off`` (module docstring)."""
        from eebench.reference.ops import sensor
        from eebench.reference.ops.mi_dense_kernel import dense_operands, phik_dense_plain
        from eebench.work import m as m_work
        from eebench.work import reveal as reveal_work

        ctx, f = self.ctx, self.ctx.config["fleet"]
        ref = program.reference().make_engine(self.cfg, ctx.device)
        ref._world = types.MethodType(blocked_world, ref)
        truth = self._truth(program.reference(), ref.device)
        win = sensor.raycast_window_cells(f["sensor_range"], f["resolution"])
        r = ctx.param("sensor_radius_cells")
        thr = self.cfg["occupied_threshold"]
        ops = dense_operands(*ref._geometry(truth, None), ref.config.num_basis,
                             ref.config.grid_samples)
        studied = sorted({0, self.refreshes // 2, self.refreshes - 1})
        gaps = {"x": [], "metric": []}
        exact = world_off = 0
        ticks, counts = [], []
        counts_done = False  # the work counts are read on the first episode's refreshes
        rows = torch.as_tensor(self._rows(), device=ref.device)
        t_rows = truth._replace(data=truth.data[rows], origin=truth.origin[rows],
                                resolution=truth.resolution[rows])
        for i, (x0, (sc_out, belief, cov, traj, metric)) in self.samples.all():
            # the first refresh and its first tick, all the reference's own
            sc0 = ref.init_scenarios(x0)
            unknown = truth._replace(data=torch.full_like(truth.data, -1.0))
            b = sensor.reveal_raycast_plain(unknown, truth, sc0.x, f["sensor_range"], win,
                                            occupied_threshold=thr, chunk=1024)
            with ref._precision():
                phik = phik_dense_plain(b.data, ops, r, ref.config.mi_frontier_cells, thr)
                world = ref._world(b, b.domain())
            sc1, u1, d1 = ref.tick(sc0, phik, world)
            ticks.append((sc0.x, sc0.vb, u1, d1))
            gaps["x"].append(abs_gap(traj[0, 0, :, :2], sc1.x[:, :2]))
            gaps["metric"].append(rel_gap(metric[0, 0], d1.ergodic_metric, 1e-6))
            # the later refreshes, from the poses the program reached, on the
            # checked scenarios
            b = t_rows._replace(data=torch.full_like(t_rows.data, -1.0))
            for k in range(self.refreshes):
                x = sc0.x if k == 0 else traj[k - 1, -1].to(ref.device)
                b = sensor.reveal_raycast_plain(b, t_rows, x[rows], f["sensor_range"], win,
                                                occupied_threshold=thr, chunk=1024)
                world_k = None
                if k in self.worlds.get(i, {}):
                    # the world the program built from its beliefs here
                    with ref._precision():
                        world_k = ref._world(b, b.domain())
                    want = (world_k.dist.dist, world_k.dist.grad, world_k.free_mask)
                    world_off += sum(_off(g, w) for g, w in zip(self.worlds[i][k], want))
                if k in self.later.get(i, {}):
                    # the refresh's first tick, from the program's state there, on
                    # the reference's own target and world of these scenarios
                    sc_k, off = self.later[i][k]
                    exact += off
                    with ref._precision():
                        phik_k = phik_dense_plain(b.data, ops, r, ref.config.mi_frontier_cells,
                                                  thr)
                        if world_k is None:
                            world_k = ref._world(b, b.domain())
                    sc1, _, d1 = ref.tick(take_rows(program.to_ref(sc_k), rows), phik_k,
                                          world_k)
                    gaps["x"].append(abs_gap(traj[k, 0][rows][:, :2], sc1.x[:, :2]))
                    gaps["metric"].append(rel_gap(metric[k, 0][rows], d1.ergodic_metric, 1e-6))
                if k in studied and not counts_done:
                    got = m_work.facts_from(b.data, ops, self.cfg, r)
                    got.update(reveal_work.facts_from(t_rows.data, x[rows], f["resolution"],
                                                      win, 256, thr))
                    counts.append({k: v * ctx.scenarios / len(rows) if k in mapping.SUMMED else v
                                   for k, v in got.items()})
            exact += cells_off(belief.data[rows], b.data)
            exact += cells_off(cov[-1], sensor.fraction_known_plain(belief))
            counts_done = True
            ring = ref.init_scenarios(x0).state.buffer
            fed = torch.cat([sc0.x[None], traj.reshape(-1, *traj.shape[2:])[:-1].to(ref.device)])
            for p in fed:
                ring = ring.append(p[:, :2])
            exact += ring_off(sc_out.state.buffer, ring)
            exact += cells_off(sc_out.state.hist_count,
                               torch.full_like(sc_out.state.hist_count, self.ticks_per_request))
        self.worlds = {}
        self.facts = k1_facts(ctx, ref, world, ticks)
        for key in ("m_nonzero", "m_cells", "reveal_occupied", "reveal_blocked_bins"):
            self.facts[key] = sum(c[key] for c in counts) / len(counts)
        self.facts["window_cells"] = counts[0]["window_cells"]
        self.facts["sensor_radius_cells"] = r
        window = None
        if self.before is not None and self.after is not None:
            window = {k: n - self.before.get(k, 0) for k, n in self.after.items()
                      if k.startswith(("launches.E", "launches.M"))
                      and n != self.before.get(k, 0)}
        self.facts["window_launches"] = window
        print(f"the window's launches of E and M: {window}", file=sys.stderr)
        return limits(ctx, {"x_gap_p99": p99(gaps["x"]), "metric_rel_p99": p99(gaps["metric"]),
                            "state_cells_off": exact, "world_cells_off": world_off})
