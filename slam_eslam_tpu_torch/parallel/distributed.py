"""Multi-process runtime wiring.

Port of ``slam_eslam_tpu.parallel.distributed``.  The reference is one
process (its only parallelism an optional OpenMP loop,
``PoseEstimator.cpp:272-276``).  The JAX package spans hosts with
``jax.distributed``; the port starts a ``torch.distributed`` process
group, one process (rank) per card:

* ``initialize`` -- idempotent ``init_process_group`` from explicit
  arguments or the same ``ESLAM_COORDINATOR`` / ``ESLAM_NUM_PROCESSES``
  / ``ESLAM_PROCESS_ID`` environment variables (``ESLAM_DEVICE`` names
  the device, the card unless ``cpu``).  NCCL where each rank of the
  host has a card of its own, gloo on the CPU or where ranks share a
  card;
* ``global_mesh`` -- the 1-D ``('dp',)`` mesh over every rank;
* ``shard_host_batch`` -- each process's local particle shard, on its
  device: in the port a rank's slice is the sharded value itself;
* ``run_world`` -- start ``n`` local ranks (one process each), run a
  function on each with its mesh and return every rank's result: the
  dry run, ``tools.bench_scaling`` and the multi-rank tests use it.  A
  world that does not finish within its time limit is killed and
  raises, so a deadlock fails one caller instead of hanging it.

``python -m slam_eslam_tpu_torch.parallel.distributed`` is the worker of
the two-process test: every rank resamples its slice of one global
weight vector and prints its ESS and moved payload.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from slam_eslam_tpu_torch.parallel import sharding as shd
from slam_eslam_tpu_torch.utils.device import entry_device


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None, device=None,
               timeout=None, backend=None):
    """Start the process group (idempotent).

    Arguments come first, then ``ESLAM_COORDINATOR`` (``host:port``),
    ``ESLAM_NUM_PROCESSES`` and ``ESLAM_PROCESS_ID``.  ``device``: this
    rank's device (default ``ESLAM_DEVICE``, else the card);
    ``local_device_ids``: the card of this rank (default: its rank while
    the host has a card per rank, else card 0).  ``timeout``: seconds a
    collective may wait (default 300), so a rank that dies fails the
    others instead of hanging them.  Returns True when a multi-process
    group is active after the call, False for a single-process
    configuration (no coordinator, no process count).  ``backend``
    overrides the choice (``parallel.sharding.pick_backend``)."""
    coordinator_address = coordinator_address or os.environ.get(
        "ESLAM_COORDINATOR")
    if num_processes is None and "ESLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["ESLAM_NUM_PROCESSES"])
    if process_id is None and "ESLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["ESLAM_PROCESS_ID"])
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a process group needs the coordinator address, "
                         "the process count and this process's id")
    asked = device or os.environ.get("ESLAM_DEVICE") or None
    dev = entry_device(asked)
    if dev.type == "cuda":
        if local_device_ids is not None:
            ids = local_device_ids
            dev = torch.device("cuda", ids[0] if isinstance(ids, (list, tuple))
                               else ids)
        elif asked is None or torch.device(asked).index is None:
            count = torch.cuda.device_count()
            dev = torch.device("cuda", process_id
                               if num_processes <= count else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or shd.pick_backend(dev, num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout or 300))
    os.environ["ESLAM_RANK_DEVICE"] = str(dev)
    return dist.get_world_size() > 1


def global_mesh(axis="dp", device=None):
    """The 1-D mesh over every rank of the process group, on this rank's
    device (the one ``initialize`` chose)."""
    device = device or os.environ.get("ESLAM_RANK_DEVICE")
    return dataclasses.replace(shd.make_mesh(device=device), axis=axis)


def shard_host_batch(local_arrays, mesh, axis="dp"):
    """This process's local particle shard (a dict or dataclass of host
    arrays or tensors, leading axis the local count) -> tensors on the
    rank's device.  Ranks concatenate in rank order along ``axis``."""
    del axis
    put = lambda a: torch.as_tensor(np.asarray(a)).to(mesh.device)
    if isinstance(local_arrays, dict):
        return {k: put(v) for k, v in local_arrays.items()}
    if isinstance(local_arrays, (np.ndarray, torch.Tensor)):
        return put(local_arrays)
    from slam_eslam_tpu_torch.utils import tree

    return tree.tree_map(lambda a: a.to(mesh.device), local_arrays)


def _rank_main(blob, rank, n, port, device, results, backend, timeout):
    """One rank of ``run_world``: join the group, run ``target(mesh,
    *args)`` (both pickled in ``blob``), put ``(rank, ok, pickled result
    or traceback)`` on ``results``.  Plain pickles: tensors travel as
    bytes, not through shared memory."""
    import pickle
    import traceback

    torch.set_num_threads(1)   # the ranks of a world share the host
    try:
        target, args = pickle.loads(blob)
        initialize(f"127.0.0.1:{port}", n, rank, device=device,
                   backend=backend, timeout=timeout)
        results.put((rank, True,
                     pickle.dumps(target(global_mesh(), *args))))
    except Exception:  # the parent raises with it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(target, n, args=(), device=None, timeout=600, backend=None):
    """Run ``target(mesh, *args)`` on ``n`` local ranks, each its own
    spawned process on ``device`` (the card unless ``"cpu"``; ranks that
    outnumber the cards share card 0 over gloo, ``transport="host"``).
    ``target`` must be importable by name (a module-level function).
    Returns the ranks' results in rank order; raises with the first
    failing rank's traceback, or when the world has not finished after
    ``timeout`` seconds (every rank is then killed; a collective waits at
    most as long).  ``backend`` forces the process group's backend."""
    import multiprocessing as mp
    import pickle
    import queue
    import time

    dev = entry_device(device)   # without a card: raises here, not in ranks
    if device is None or torch.device(device).index is None:
        device = dev.type   # each rank picks its card (initialize)
    else:
        device = str(dev)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = shd.free_port()
    blob = pickle.dumps((target, args))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(blob, r, n, port, device, results, backend,
                               int(timeout)))
             for r in range(n)]
    for p in procs:
        p.start()
    out, deadline = {}, time.monotonic() + timeout
    try:
        while len(out) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n}-rank world did not finish in "
                                   f"{timeout} s")
            try:
                rank, ok, res = results.get(timeout=min(left, 5.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and len(out) < n and results.empty():
                    raise RuntimeError(f"a rank of the {n}-rank world died "
                                       f"(exit {dead[0].exitcode})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{res}")
            out[rank] = pickle.loads(res)
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(n)]


def _worker_main():
    """Worker of the two-process test.  Builds the test's deterministic
    global weights (``default_rng(7)``), takes this rank's slice,
    normalises over the mesh, reads the ESS and resamples systematically
    with the offset ``ESLAM_TEST_U``, moving the payload ``arange(N)``
    by its global ancestors; prints ``RESULT pid=.. ess=.. local=..``."""
    from slam_eslam_tpu_torch.core import filter as pf

    if not initialize():
        raise RuntimeError("the worker expects a multi-process "
                           "configuration (ESLAM_* variables)")
    mesh = global_mesh()
    n_global = int(os.environ.get("ESLAM_TEST_N", "64"))
    u = float(os.environ.get("ESLAM_TEST_U", "0.5"))
    lo, hi = mesh.bounds(n_global)
    rng = np.random.default_rng(7)
    w_global = rng.uniform(0.1, 1.0, n_global).astype(np.float32)
    payload_global = np.arange(n_global, dtype=np.int32)
    w = shard_host_batch(w_global[lo:hi], mesh)
    payload = shard_host_batch({"i": payload_global[lo:hi]}, mesh)

    wn, _ = pf.normalize_weights(mesh.all_gather(w))
    ess = pf.effective_sample_size(wn)
    idx = pf.resample_systematic(wn, torch.tensor(u, device=w.device),
                                 n_global, (lo, hi))
    out = mesh.all_gather(payload["i"]).index_select(0, idx)
    print(f"RESULT pid={mesh.rank} ess={float(ess):.6f} "
          f"local={','.join(map(str, out.cpu().tolist()))}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker_main()
