"""The twins of the JAX package's entry points and scale-out examples, on
the CPU: ``graft_entry.entry`` against ``__graft_entry__.entry`` (controls
within 5e-5, the metric within rtol 1e-5), the multi-device dry run on two
gloo ranks, and the batched-fleet and scaling examples in process at tiny
sizes (their single-process path, no mesh), as tests/test_examples.py runs
the originals."""

import json

import jax
import numpy as np
import torch

torch.set_num_threads(2)


def test_entry_matches_the_jax_entry():
    import __graft_entry__ as jax_entry

    from ergodic_exploration_tpu_torch import graft_entry

    fn, args = graft_entry.entry(device="cpu")
    u, metric = fn(*args)
    assert u.shape == (8, 2) and metric.shape == (8,)
    jfn, jargs = jax_entry.entry()
    ju, jmetric = jax.tree.map(np.asarray, jax.jit(jfn)(*jargs))
    np.testing.assert_allclose(u.numpy(), ju, atol=5e-5)
    np.testing.assert_allclose(metric.numpy(), jmetric, rtol=1e-5, atol=1e-7)


def test_dryrun_multichip_on_two_cpu_ranks():
    from ergodic_exploration_tpu_torch.graft_entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")  # raises if a rank fails


def test_batched_fleet_twin(tmp_path, capsys):
    from ergodic_exploration_tpu_torch.examples import batched_fleet

    png = tmp_path / "fleet.png"
    batched_fleet.main(["--cpu", "--scenarios", "4", "--ticks", "5", "--out", str(png)])
    out = capsys.readouterr().out
    assert "4 scenarios x 5 ticks" in out and "solves/s" in out and "wrote" in out
    assert png.stat().st_size > 0


def test_scaling_twin(capsys):
    from ergodic_exploration_tpu_torch.examples import scaling

    scaling.main(["--cpu", "--batches", "8,16", "--iters", "2"])
    recs = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert [r["batch"] for r in recs] == [8, 16]
    assert all(r["devices"] == 1 and r["hosts"] == 1 and r["solves_per_s"] > 0 for r in recs)
    assert recs[0]["efficiency_vs_first_point"] == 1.0
