"""The port's log runtime (``slam_eslam_tpu_torch.io.logio``) against the
JAX package's ``slam_eslam_tpu.io.logio``, on the CPU.

Every case of ``tests/test_logio.py`` runs on the port (the dataset
converter through ``python -m slam_eslam_tpu_torch.tools.convert_dataset``).
Beside them: each ``encode_*`` gives the JAX codec's bytes for the same
inputs (contact states on both sides built from the same arrays); a log
written through either package's ``LogWriter`` reads equal, record by
record and through ``load_stream``, in the other; the port's library is
its own build under ``build/torch_kernels/``, and a failed build or a
missing compiler raises.  Exact comparisons throughout (a log is bytes).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from slam_eslam_tpu.core.state import BodyContactState as JContact
from slam_eslam_tpu.io import logio as jlogio
from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.io import logio
from slam_eslam_tpu_torch.ops import _build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def log_path(tmp_path):
    return str(tmp_path / "traverse.eslg")


def contact_state(i, cls=BodyContactState):
    pos = np.arange(12, dtype=np.float32).reshape(4, 3) + i
    return cls.create(pos, contact=np.array([1, 0, 1, 0], np.float32),
                      group_id=np.array([0, 0, 1, 1], np.int32))


class TestWriterReader:
    def test_roundtrip_all_types(self, log_path):
        with logio.LogWriter(log_path) as w:
            w.write_contact_state(contact_state(0), timestamp_ns=100)
            w.write_orientation([1.0, 0, 0, 0], timestamp_ns=200)
            w.write_scan([1.0, 2.0, 3.0], -0.5, 0.1, timestamp_ns=300)
            w.write_pose([1, 2, 3], [1, 0, 0, 0], timestamp_ns=400)

        with logio.LogReader(log_path) as r:
            assert len(r) == 4
            t, ts, buf = r.get(0)
            assert t == logio.CONTACT_STATE and ts == 100
            cs = logio.decode_contact_state(buf)
            assert isinstance(cs, BodyContactState)
            np.testing.assert_array_equal(
                cs.position.numpy(),
                np.arange(12, dtype=np.float32).reshape(4, 3))
            np.testing.assert_array_equal(cs.group_id.numpy(), [0, 0, 1, 1])

            t, ts, buf = r.get(1)
            assert t == logio.ORIENTATION
            np.testing.assert_array_equal(logio.decode_orientation(buf),
                                          [1, 0, 0, 0])
            t, ts, buf = r.get(2)
            ranges, start, res = logio.decode_scan(buf)
            np.testing.assert_array_equal(ranges, [1, 2, 3])
            np.testing.assert_allclose([start, res], [-0.5, 0.1], rtol=1e-6)
            t, _, buf = r.get(3)
            pos, q = logio.decode_pose(buf)
            np.testing.assert_array_equal(pos, [1, 2, 3])

    def test_out_of_range(self, log_path):
        with logio.LogWriter(log_path) as w:
            w.write_orientation([1.0, 0, 0, 0])
        with logio.LogReader(log_path) as r:
            with pytest.raises(IndexError):
                r.get(5)

    def test_open_missing(self, tmp_path):
        with pytest.raises(OSError):
            logio.LogReader(str(tmp_path / "nope.eslg"))

    def test_large_log(self, log_path):
        with logio.LogWriter(log_path) as w:
            for i in range(500):
                w.write_contact_state(contact_state(i), timestamp_ns=i)
        with logio.LogReader(log_path) as r:
            assert len(r) == 500
            _, ts, buf = r.get(499)
            assert ts == 499
            cs = logio.decode_contact_state(buf)
            assert float(cs.position[0, 0]) == 499.0


class TestAsyncFeeder:
    def test_streams_in_order(self, log_path):
        with logio.LogWriter(log_path) as w:
            for i in range(100):
                w.write_orientation([float(i), 0, 0, 0], timestamp_ns=i)
        with logio.LogReader(log_path) as r:
            with logio.AsyncFeeder(r, slots=4) as f:
                seen = []
                for t, ts, buf in f:
                    assert t == logio.ORIENTATION
                    seen.append(float(logio.decode_orientation(buf)[0]))
        np.testing.assert_array_equal(seen, np.arange(100.0))

    def test_empty_log(self, log_path):
        with logio.LogWriter(log_path):
            pass
        with logio.LogReader(log_path) as r:
            with logio.AsyncFeeder(r) as f:
                assert list(f) == []


def write_traverse(mod, path, frames=12, scan_every=4, n_rays=8,
                   cls=BodyContactState, images=False):
    """``tests/test_logio.py``'s traverse through package ``mod``; with
    ``images`` a distance image and a texture beside every scan."""
    with mod.LogWriter(path) as w:
        for i in range(frames):
            ts = 1000 + i * 10
            w.write_contact_state(contact_state(i, cls), timestamp_ns=ts)
            w.write_orientation([1.0, 0, 0, float(i)], timestamp_ns=ts)
            w.write_pose([float(i), 0, 0], [1, 0, 0, 0], timestamp_ns=ts)
            if i % scan_every == scan_every - 1:
                w.write_scan(np.full(n_rays, 2.0 + i), -0.5, 0.1,
                             timestamp_ns=ts + 1)
                if images:
                    w.write_distance_image(np.full((3, 4), 1.0 + i), 0.1,
                                           0.2, -0.15, -0.3,
                                           timestamp_ns=ts + 1)
                    w.write_texture_image(np.full((3, 4, 3), 0.01 * i),
                                          timestamp_ns=ts + 1)


class TestBatchedAccess:
    """Native select/gather/compaction and the stacked-stream loader."""

    def test_select_and_gather(self, log_path):
        write_traverse(logio, log_path)
        with logio.LogReader(log_path) as r:
            assert r.count_type(logio.CONTACT_STATE) == 12
            idx, ts = r.select(logio.ORIENTATION)
            assert idx.size == 12
            np.testing.assert_array_equal(ts, 1000 + 10 * np.arange(12))
            raw = r.gather(idx, 16)
            quats = np.frombuffer(raw.tobytes(), np.float32).reshape(-1, 4)
            np.testing.assert_array_equal(quats[:, 3], np.arange(12.0))

    def test_compact_types_and_stride(self, log_path, tmp_path):
        write_traverse(logio, log_path)
        dst = str(tmp_path / "compacted.eslg")
        n = logio.compact(log_path, dst, types=(logio.CONTACT_STATE,
                                                logio.ORIENTATION), stride=2)
        assert n == 12  # 6 contact + 6 orientation
        with logio.LogReader(dst) as r:
            assert r.count_type(logio.CONTACT_STATE) == 6
            assert r.count_type(logio.ORIENTATION) == 6
            assert r.count_type(logio.POSE) == 0
            idx, _ = r.select(logio.CONTACT_STATE)
            _, _, buf = r.get(int(idx[1]))
            # every second record kept: record 1 is frame 2
            assert float(logio.decode_contact_state(buf).position[0, 0]) \
                == 2.0

    def test_distance_image_roundtrip(self, log_path):
        img = np.random.default_rng(0).uniform(
            0.5, 3.0, (12, 16)).astype(np.float32)
        with logio.LogWriter(log_path) as w:
            w.write_distance_image(img, 0.01, 0.02, -0.5, -0.4,
                                   timestamp_ns=7)
        with logio.LogReader(log_path) as r:
            t, ts, buf = r.get(0)
            assert t == logio.DISTANCE_IMAGE and ts == 7
            data, sx, sy, cx, cy = logio.decode_distance_image(buf)
            np.testing.assert_array_equal(data, img)
            assert (sx, sy, cx, cy) == (
                pytest.approx(0.01), pytest.approx(0.02),
                pytest.approx(-0.5), pytest.approx(-0.4))

    def test_dataset_converter(self, tmp_path):
        """The port's converter, run as a module: TUM trajectory +
        contact/scan CSVs -> a loadable .eslg stream."""
        traj = tmp_path / "tum.txt"
        traj.write_text("# ts x y z qx qy qz qw\n"
                        "0.1 0.0 0.0 0.2 0 0 0 1\n"
                        "0.2 0.1 0.0 0.2 0 0 0 1\n")
        contacts = tmp_path / "contacts.csv"
        contacts.write_text("\n".join(
            f"{ts},{i},{0.1 * i},0.0,-0.1,1.0,{i // 2}"
            for ts in (0.1, 0.2) for i in range(4)))
        scans = tmp_path / "scans.csv"
        scans.write_text("0.2,-0.5,0.1," + ",".join(["2.0"] * 8))
        out = str(tmp_path / "out.eslg")
        subprocess.run(
            [sys.executable, "-m", "slam_eslam_tpu_torch.tools."
             "convert_dataset", out, "--trajectory", str(traj),
             "--contacts", str(contacts), "--scans", str(scans)],
            check=True, cwd=REPO, capture_output=True, timeout=120)
        s = logio.load_stream(out)
        assert s["contact"].shape == (2, 4)
        assert s["orientation"].shape == (2, 4)
        np.testing.assert_array_equal(s["orientation"][0], [1, 0, 0, 0])
        assert s["pose"].shape == (2, 7)
        np.testing.assert_array_equal(np.nonzero(s["has_scan"])[0], [1])
        # the JAX package reads the converted log the same
        ref = jlogio.load_stream(out)
        for key in ("orientation", "pose", "scan_ranges", "has_scan", "ts"):
            np.testing.assert_array_equal(s[key], ref[key])

    def test_load_stream(self, log_path):
        write_traverse(logio, log_path, frames=12, scan_every=4, n_rays=8)
        s = logio.load_stream(log_path)
        assert s["contact"].shape == (12, 4)
        assert s["contact"]["position"][3, 0, 0] == 3.0
        assert s["orientation"].shape == (12, 4)
        np.testing.assert_array_equal(s["orientation"][:, 3], np.arange(12.))
        assert s["pose"].shape == (12, 7)
        # scans written at frames 3, 7, 11 attach to those frames
        np.testing.assert_array_equal(np.nonzero(s["has_scan"])[0],
                                      [3, 7, 11])
        np.testing.assert_array_equal(s["scan_ranges"][3], np.full(8, 5.0))
        np.testing.assert_array_equal(s["scan_ranges"][2], 0.0)
        assert s["scan_meta"] == (pytest.approx(-0.5), pytest.approx(0.1))


CODEC_INPUTS = {
    "contact_state": lambda cls: (contact_state(3, cls),),
    "orientation": lambda cls: (np.array([0.9, 0.1, -0.2, 0.3]),),
    "scan": lambda cls: (np.linspace(0.5, 3.0, 17), -2.356, 0.0262),
    "pose": lambda cls: ([1.5, -2.0, 0.25], [0.9, 0.0, 0.0, 0.436]),
    "distance_image": lambda cls: (
        np.random.default_rng(1).uniform(0.3, 2.8, (12, 16)),
        0.09, 0.09, -0.675, -0.495),
    "texture_image": lambda cls: (
        np.random.default_rng(2).uniform(size=(12, 16, 3)),),
}


@pytest.mark.parametrize("codec", sorted(CODEC_INPUTS))
def test_encoders_give_the_jax_codecs_bytes(codec):
    mine = getattr(logio, f"encode_{codec}")(*CODEC_INPUTS[codec](
        BodyContactState))
    ref = getattr(jlogio, f"encode_{codec}")(*CODEC_INPUTS[codec](JContact))
    assert mine == ref


def test_encoders_take_tensors():
    cs = contact_state(2)
    tensors = BodyContactState(**{f: getattr(cs, f).clone() for f in (
        "position", "contact", "slip", "group_id", "valid")})
    assert logio.encode_contact_state(tensors) == jlogio.encode_contact_state(
        contact_state(2, JContact))
    q = torch.tensor([0.9, 0.1, -0.2, 0.3])
    assert logio.encode_orientation(q) == jlogio.encode_orientation(
        q.numpy())
    with pytest.raises(ValueError):
        logio.encode_texture_image(np.zeros((2, 3, 4)))


def assert_records_equal(path):
    with logio.LogReader(path) as a, jlogio.LogReader(path) as b:
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            assert a.get(i) == b.get(i)


def assert_streams_equal(path):
    mine, ref = logio.load_stream(path), jlogio.load_stream(path)
    assert mine.keys() == ref.keys()
    for key, val in ref.items():
        if isinstance(val, np.ndarray):
            assert mine[key].dtype == val.dtype, key
            np.testing.assert_array_equal(mine[key], val, err_msg=key)
        else:
            assert mine[key] == val, key


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_log_of_either_package_reads_equal_in_the_other(writer, log_path):
    mod, cls = (jlogio, JContact) if writer == "jax" else (logio,
                                                           BodyContactState)
    write_traverse(mod, log_path, frames=16, scan_every=3, n_rays=5,
                   cls=cls, images=True)
    assert_records_equal(log_path)
    assert_streams_equal(log_path)
    with logio.LogReader(log_path) as r:
        cs = logio.decode_contact_state(r.get(0)[2])
    with jlogio.LogReader(log_path) as r:
        ref = jlogio.decode_contact_state(r.get(0)[2])
    for name in ("position", "contact", "slip", "group_id", "valid"):
        np.testing.assert_array_equal(getattr(cs, name).numpy(),
                                      np.asarray(getattr(ref, name)))


def test_the_two_writers_write_the_same_bytes(tmp_path):
    paths = [str(tmp_path / f"{name}.eslg") for name in ("jax", "port")]
    write_traverse(jlogio, paths[0], cls=JContact, images=True)
    write_traverse(logio, paths[1], images=True)
    assert Path(paths[0]).read_bytes() == Path(paths[1]).read_bytes()


def test_the_library_is_the_ports_own_build():
    path = logio.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.parent == REPO / "build" / "torch_kernels"
    assert path.name.startswith("eslam_log-")
    logio.lib()
    assert path.exists()
    jax_lib = Path(jlogio._LIB_PATH).resolve()
    assert jax_lib.parent == REPO / "slam_eslam_tpu" / "io"
    assert path.resolve() != jax_lib
    # the name follows the source and the flags
    assert _build.library_path("eslam_log", [logio.NATIVE_SOURCE],
                               logio.CXX_FLAGS[:-1]) != path


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    lib = tmp_path / "broken.so"
    with pytest.raises(RuntimeError, match="failed to build"):
        _build.build_library(lib, logio._cxx(), logio.CXX_FLAGS, bad)
    assert not lib.exists() and not list(tmp_path.glob("*.tmp"))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        logio._cxx()
