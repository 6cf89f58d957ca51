"""The plain reference against the port's CPU path at a tiny size, and
the harness's check on both drives: the port (eager on the CPU, the
kernels' plain versions) comes out correct."""

import pytest
import torch

from benchmark.harness import common, drive_chunks, drive_frames, port, traffic
from benchmark.reference import localization as ref
from benchmark.tests.conftest import tiny_loc, tiny_slam


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_steps_match_the_port(seed, cpu):
    """From one state and the same draws, the reference's step gives the
    port's centroid and, where neither resampled, its weights and
    heights particle by particle."""
    from slam_eslam_tpu_torch.filter import step as steplib
    from slam_eslam_tpu_torch.mapping.lookup import make_lookup

    cfg_file, mix = tiny_loc(n=512)
    r = drive_chunks.Replay(cfg_file, mix, cpu)
    r.setup(common.SetupClock())
    r.inputs(seed)
    run = steplib.make_scan_runner(r.cfg, make_lookup(r.cfg, r.grid),
                                   graph=False)
    fcfg, ocfg, grid = drive_chunks.reference_inputs(cfg_file, r.grid_arrays,
                                                     cpu)
    state, compared = r.start, 0
    for s0 in range(12):
        new, cents = run(state, *r.lap.chunk(s0, 1))
        cent = ref.step(port.plain_state(state),
                        port.plain_contacts(r.lap.host["contacts"], s0, cpu),
                        torch.from_numpy(r.lap.host["q"][s0]).double(),
                        traffic.plain_draws(r.lap.draws, s0), grid, fcfg,
                        ocfg)
        st, c, info = cent
        assert torch.allclose(cents[0].double(), c[:3], atol=1e-5)
        if not info["resampled"]:
            # a particle whose query lies on a cell edge, or whose height
            # update is at its acceptance bound, may go the other way
            p = new.particles
            w = p.weight.double() / p.weight.double().sum()
            rel = (w - st["particles"]["weight"]).abs() / st["particles"][
                "weight"]
            dz = (p.z.double() - st["particles"]["z"]).abs()
            assert int((rel > 1e-5).sum()) <= 2 and float(rel.max()) < 1e-2
            assert int((dz > 1e-6).sum()) <= 2 and float(dz.max()) < 1e-3
            compared += 1
        state = new
    assert compared >= 6


def test_replay_check_passes_on_the_cpu(cpu):
    cfg_file, mix = tiny_loc(n=2048, chunk=20, min_effective=1024)
    r = drive_chunks.Replay(cfg_file, mix, cpu)
    r.setup(common.SetupClock())
    r.inputs(2**31 + 41)
    w = r.window(1.0)
    checks = r.check(w)
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_online_check_passes_on_the_cpu(cpu):
    cfg_file, mix = tiny_slam()
    cell = drive_frames.Online(cfg_file, mix, cpu)
    cell.setup(common.SetupClock(), 3.0)
    cell.inputs(2**31 + 43)
    cell.warm_up()
    w = cell.window(4.0, expected_rate=120.0)
    checks = cell.check(w)
    assert w["snaps"], "no frame was checked"
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks


def test_windowed_chain_lookup_equals_the_whole_grids():
    """A chain lookup through windows of the blocks' cells answers as the
    whole grids do for queries inside the windows, and marks the queries
    inside a grid but beyond its window."""
    from benchmark.reference import slam as sref

    g = torch.Generator().manual_seed(5)
    b, nx, k, res = 4, 30, 4, 0.1
    whole = {"mean": torch.rand((b, nx, nx, k), generator=g, dtype=torch.float64),
             "stdev": torch.rand((b, nx, nx, k), generator=g, dtype=torch.float64),
             "valid": torch.rand((b, nx, nx, k), generator=g) < 0.5,
             "origin": torch.tensor([[0.0, 0.0], [0.5, -0.3], [-0.2, 0.4],
                                     [1.0, 1.0]], dtype=torch.float64),
             "lo": torch.zeros((b, 2), dtype=torch.long), "extent": (nx, nx),
             "chain": torch.tensor([[0, 1, -1], [2, 3, 1]])}
    lo = torch.tensor([[5, 6], [2, 9], [8, 3], [4, 4]])
    w = 12
    ix = lo[:, :1] + torch.arange(w)
    iy = lo[:, 1:] + torch.arange(w)
    cut = lambda f: f[torch.arange(b)[:, None, None], ix[:, :, None],
                      iy[:, None, :]]
    window = dict(whole, lo=lo, **{f: cut(whole[f])
                                   for f in ("mean", "stdev", "valid")})
    x = torch.rand((2, 40), generator=g, dtype=torch.float64) * 3.0
    y = torch.rand((2, 40), generator=g, dtype=torch.float64) * 3.0
    z = torch.rand((2, 40), generator=g, dtype=torch.float64)
    fa, ma, sa, oa = sref.chain_lookup(whole, x, y, z, res, 3.0)
    fb, mb, sb, ob = sref.chain_lookup(window, x, y, z, res, 3.0)
    assert not oa.any() and ob.any()
    same = ~ob
    assert torch.equal(fa[same], fb[same])
    assert torch.equal(ma[same], mb[same]) and torch.equal(sa[same], sb[same])


def test_particles_apart_counts_particles_not_slots():
    """A sound stratified resampling held in float32 is apart in no
    particle; one particle whose height went the other way, or whose
    weight differs, counts once however many slots copy it; strata given
    the next particle count by the particles they land on."""
    g = torch.Generator().manual_seed(7)
    n = 4096
    weighed = {k: torch.rand(n, generator=g, dtype=torch.float64)
               for k in ("x", "y", "yaw", "z", "z_sigma")}
    weighed["weight"] = torch.rand(n, generator=g, dtype=torch.float64) ** 40
    u = torch.rand(n, generator=g, dtype=torch.float64)
    out, ess, resampled, idx = ref.resample(weighed, u, n)
    assert resampled and float(ess) < n / 5
    held = {k: v.float() for k, v in out.items()}
    apart = lambda h, r=True: drive_chunks.particles_apart(weighed, h, u, n, r)
    assert apart(held) == 0
    heavy = int(torch.argmax(weighed["weight"]))
    copies = idx == heavy
    assert int(copies.sum()) > 1
    flipped = dict(held, z=torch.where(copies, held["z"] + 0.01, held["z"]))
    assert apart(flipped) == 1
    heavier = dict(held, weight=torch.where(copies, held["weight"] * 1.01,
                                            held["weight"]))
    assert apart(heavier) == 1
    # each stratum given the next particle, with that particle's weight
    w = weighed["weight"] / weighed["weight"].sum()
    shifted = {k: v[(idx + 1).clamp(max=n - 1)].float()
               for k, v in dict(weighed, weight=w).items()}
    assert apart(shifted) > 50
    # without a resampling slot k holds particle k
    kept = {k: v.float() for k, v in weighed.items()}
    kept["weight"] = (weighed["weight"] / weighed["weight"].sum()).float()
    assert apart(kept, False) == 0
    assert apart(dict(kept, z=kept["z"] + 0.01), False) == n
