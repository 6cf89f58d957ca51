"""The port's multi-process wiring: two real processes against the oracle.

Mirrors ``tests/test_multihost.py::test_two_process_resample_matches_
oracle``: two local processes join one gloo process group through
``python -m slam_eslam_tpu_torch.parallel.distributed`` (the
``ESLAM_COORDINATOR`` / ``ESLAM_NUM_PROCESSES`` / ``ESLAM_PROCESS_ID``
variables, ``ESLAM_DEVICE=cpu``), each resamples its half of one global
weight vector with the JAX offset ``ESLAM_TEST_U``, and their ESS and
moved payloads must equal the JAX single-process oracle: ESS rtol 1e-5,
payload exact.  Each process has a collective timeout and the test a
``communicate`` timeout, so a deadlock fails the test.
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np

from slam_eslam_tpu.core import filter as pf
from slam_eslam_tpu_torch.parallel.sharding import free_port

N = 64


def _launch(pid, port, u):
    env = dict(os.environ)
    env.update({
        "ESLAM_COORDINATOR": f"127.0.0.1:{port}",
        "ESLAM_NUM_PROCESSES": "2",
        "ESLAM_PROCESS_ID": str(pid),
        "ESLAM_TEST_N": str(N),
        "ESLAM_TEST_U": repr(float(u)),
        "ESLAM_DEVICE": "cpu",
        "OMP_NUM_THREADS": "1",
    })
    return subprocess.Popen(
        [sys.executable, "-m", "slam_eslam_tpu_torch.parallel.distributed"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=os.path.dirname(os.path.dirname(__file__)))


def test_two_process_resample_matches_oracle():
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (), np.float32))
    port = free_port()
    procs = [_launch(0, port, u), _launch(1, port, u)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    results = {}
    for out in outs:
        m = re.search(r"RESULT pid=(\d+) ess=([0-9.]+) local=([0-9,]+)",
                      out)
        assert m, f"no RESULT line in: {out}"
        results[int(m.group(1))] = (
            float(m.group(2)),
            np.array([int(v) for v in m.group(3).split(",")]))
    assert set(results) == {0, 1}

    rng = np.random.default_rng(7)
    w = rng.uniform(0.1, 1.0, N).astype(np.float32)
    wn, _ = pf.normalize_weights(w)
    ess = float(pf.effective_sample_size(wn))
    idx = np.asarray(pf.resample_systematic(key, wn, N))
    payload = np.arange(N, dtype=np.int32)[idx]
    np.testing.assert_allclose(results[0][0], ess, rtol=1e-5)
    np.testing.assert_allclose(results[1][0], ess, rtol=1e-5)
    np.testing.assert_array_equal(
        np.concatenate([results[0][1], results[1][1]]), payload)
