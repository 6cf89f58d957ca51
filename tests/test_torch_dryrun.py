"""The port's dry run (``slam_eslam_tpu_torch.dryrun``, the root
``__graft_entry__.py``) and ``tools.bench_scaling`` on the CPU.

``entry()``'s one-device step, fed the JAX package's initial normals and
random draws, against ``__graft_entry__.entry()``'s (rtol 1e-4 / atol
1e-5: the port's lookup is the contact fold, the JAX entry's the plain
gather); ``dryrun_multichip(2)`` over two gloo ranks (its four checks
raise on failure; the SLAM check holds the split pool bit for bit to a
one-process run with ``map_pool_shards = 2``, on a short drive and on one
where particles migrate between the ranks); ``bench_scaling --devices
1 2`` at 256 particles a rank, which must mark its lines as CPU ranks
(no scaling claimed).
"""

import dataclasses

import jax
import numpy as np
import torch

import __graft_entry__ as g
from slam_eslam_tpu_torch import convert, dryrun
from slam_eslam_tpu_torch.tools import bench_scaling
from torch_jax_draws import (as_dict, gaussian_normals, project_draws,
                             resample_draws)


def test_entry_matches_jax():
    jfn, (jstate, jcs, jq, gate) = g.entry()
    jout, jaux = jax.jit(jfn)(jstate, jcs, jq, gate)
    n = jstate.particles.n
    cfg, lookup, state, cs, q = dryrun._build(
        n, device="cpu", normals=gaussian_normals(jax.random.PRNGKey(0), n))
    np.testing.assert_allclose(state.particles.xy.numpy(),
                               np.asarray(jstate.particles.xy), rtol=1e-6)
    np.testing.assert_allclose(cs.position.numpy(),
                               np.asarray(jcs.position), rtol=1e-6)
    key, proj = project_draws(jstate.key, n)
    _, u = resample_draws(key, n)
    from slam_eslam_tpu_torch.filter.step import StepDraws

    fn, (state0, cs0, q0, gate0) = dryrun.entry("cpu")
    state0 = dataclasses.replace(state0, particles=state.particles)
    out, aux = fn(state0, cs0, q0, gate0, StepDraws(proj, u))
    assert bool(aux["updated"])
    np.testing.assert_allclose(float(aux["ess"]), float(jaux["ess"]),
                               rtol=1e-4)
    got = convert.to_numpy(out.particles)
    for name in ("x", "y", "yaw", "z", "weight"):
        np.testing.assert_allclose(got[name],
                                   as_dict(jout.particles)[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_dryrun_multichip_two_ranks(capsys):
    ranks = dryrun.dryrun_multichip(2, device="cpu", timeout=600)
    out = capsys.readouterr().out
    for check in ("dryrun_multichip ok", "slam ok", "ppermute-resample ok",
                  "schur ok"):
        assert check in out
    assert "backend gloo, transport gloo" in out
    assert "slam ok: migrate drive" in out
    assert [r["slam"]["rows"] for r in ranks] == [ranks[0]["slam"]["blocks"]
                                                   // 2] * 2
    # the migrating drive copied blocks from, and looked chain levels up
    # on, the other rank
    moved = dryrun.remote_rows(ranks, "migrate")
    assert moved["block copy"] > 0 and moved["chain lookup"] > 0


def test_dryrun_main_runs_entry(capsys):
    dryrun.main(["--cpu"])
    assert "entry ok" in capsys.readouterr().out


def test_bench_scaling_devices_1_2(capsys):
    line = bench_scaling.main(["--cpu", "--devices", "1", "2",
                               "--per-device", "256", "--repeats", "1"])
    rows = line["weak_scaling"]
    assert sorted(rows) == [1, 2]
    assert rows[1]["weak_scaling_eff"] == 1.0
    assert rows[2]["n"] == 512 and np.isfinite(rows[2]["sec"])
    assert {r["note"] for r in rows.values()} == {"cpu-gloo-ranks"}
    assert {r["graphed"] for r in rows.values()} == {False}
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        '{"weak_scaling"')
    fixed = bench_scaling.main(["--cpu", "--devices", "1", "2",
                                "--fixed-total", "256", "--repeats", "1"])
    assert fixed["fixed_total_scaling"][2]["n"] == 256
    assert fixed["fixed_total_scaling"][1]["partitioning_overhead"] == 1.0
    assert torch.isfinite(torch.tensor(
        fixed["fixed_total_scaling"][2]["partitioning_overhead"]))
