"""Python bindings of the native log runtime (ctypes over a C ABI).

Port of ``slam_eslam_tpu.io.logio``; the format and the asynchronous
feeder are ``native/eslam_log.cpp``'s, so a log written by either package
reads the same in the other.  Typed records are encoded and decoded with
NumPy structured views; the contact-state codecs build and read the
port's ``BodyContactState`` (tensors on any device in, CPU tensors out).

The port builds its own copy of the native library: ``g++`` compiles
``native/eslam_log.cpp`` with the flags of ``native/Makefile`` into
``build/torch_kernels/`` at first use, named by a hash of the source and
the flags (``ops._build.library_path``, as the CUDA kernels are).  There
is no fallback: without ``g++``, or when the build fails, the first use
raises.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import warnings
from pathlib import Path

import numpy as np
import torch

from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.ops import _build

CONTACT_STATE = 1
ORIENTATION = 2
LASER_SCAN = 3
POSE = 4
DISTANCE_IMAGE = 5
TEXTURE_IMAGE = 6

NATIVE_SOURCE = Path(__file__).resolve().parents[2] / "native" / "eslam_log.cpp"
# native/Makefile's flags
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared", "-pthread")


def library_path():
    """Where the port's build of the native log library goes."""
    return _build.library_path("eslam_log", [NATIVE_SOURCE], CXX_FLAGS)


def _cxx():
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) to build "
                           f"{NATIVE_SOURCE}")
    return found


@functools.cache
def lib():
    """The native library, built at first use and loaded with its C ABI
    declared."""
    path = library_path()
    if not path.exists():
        _build.build_library(path, _cxx(), CXX_FLAGS, NATIVE_SOURCE)
    lib = ctypes.CDLL(str(path))
    p, u32, u64, i64 = (ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64,
                        ctypes.c_int64)
    out = lambda t: ctypes.POINTER(t)
    sigs = {
        "eslam_log_writer_open": (p, [ctypes.c_char_p]),
        "eslam_log_writer_append": (ctypes.c_int, [p, u32, u64, p, u32]),
        "eslam_log_writer_close": (None, [p]),
        "eslam_log_reader_open": (p, [ctypes.c_char_p]),
        "eslam_log_reader_count": (i64, [p]),
        "eslam_log_reader_get": (p, [p, i64, out(u32), out(u64), out(u32)]),
        "eslam_log_reader_close": (None, [p]),
        "eslam_feeder_create": (p, [p, u32]),
        "eslam_feeder_next": (p, [p, out(u32), out(u64), out(u32)]),
        "eslam_feeder_destroy": (None, [p]),
        "eslam_log_reader_count_type": (i64, [p, u32]),
        "eslam_log_reader_select": (i64, [p, u32, out(i64), out(u64), i64]),
        "eslam_log_reader_gather": (ctypes.c_int, [p, out(i64), i64, u32,
                                                   out(ctypes.c_uint8)]),
        "eslam_log_compact": (i64, [ctypes.c_char_p, ctypes.c_char_p,
                                    out(u32), ctypes.c_int32, i64]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


# ------------------------------------------------------------------ codecs

_CONTACT_DT = np.dtype(
    [("position", "<f4", 3), ("contact", "<f4"), ("slip", "<f4"),
     ("group_id", "<i4")]
)


def _host(a, dtype):
    """Tensor (on any device) or array-like -> a NumPy array of ``dtype``."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def encode_contact_state(state: BodyContactState) -> bytes:
    c = state.c
    arr = np.empty(c, _CONTACT_DT)
    arr["position"] = _host(state.position, np.float32)
    arr["contact"] = _host(state.contact, np.float32)
    arr["slip"] = _host(state.slip, np.float32)
    arr["group_id"] = _host(state.group_id, np.int32)
    return np.uint32(c).tobytes() + arr.tobytes()


def decode_contact_state(buf) -> BodyContactState:
    """A ``BodyContactState`` of CPU tensors."""
    c = int(np.frombuffer(buf[:4], np.uint32)[0])
    arr = np.frombuffer(buf[4:4 + c * _CONTACT_DT.itemsize], _CONTACT_DT)
    return BodyContactState.create(
        arr["position"].copy(), contact=arr["contact"].copy(),
        slip=arr["slip"].copy(), group_id=arr["group_id"].copy(),
    )


def encode_orientation(q) -> bytes:
    return _host(q, np.float32).tobytes()


def decode_orientation(buf):
    return np.frombuffer(buf[:16], np.float32).copy()


def encode_scan(ranges, start_angle, angular_resolution) -> bytes:
    r = _host(ranges, np.float32)
    return (np.uint32(r.size).tobytes()
            + np.float32(start_angle).tobytes()
            + np.float32(angular_resolution).tobytes() + r.tobytes())


def decode_scan(buf):
    n = int(np.frombuffer(buf[:4], np.uint32)[0])
    start = float(np.frombuffer(buf[4:8], np.float32)[0])
    res = float(np.frombuffer(buf[8:12], np.float32)[0])
    ranges = np.frombuffer(buf[12:12 + 4 * n], np.float32).copy()
    return ranges, start, res


def encode_pose(position, quat) -> bytes:
    return (_host(position, np.float32).tobytes()
            + _host(quat, np.float32).tobytes())


def decode_pose(buf):
    v = np.frombuffer(buf[:28], np.float32)
    return v[:3].copy(), v[3:7].copy()


def encode_distance_image(data, scale_x, scale_y, center_x,
                          center_y) -> bytes:
    """``mapping.projection.DistanceImage`` payload: u32 H, u32 W,
    4 f32 intrinsics, then H*W f32 distances."""
    d = _host(data, np.float32)
    h, w = d.shape
    head = np.array([h, w], np.uint32).tobytes()
    intr = np.array([scale_x, scale_y, center_x, center_y],
                    np.float32).tobytes()
    return head + intr + d.tobytes()


def decode_distance_image(buf):
    """Returns ``(data [H, W], scale_x, scale_y, center_x, center_y)``."""
    h, w = (int(v) for v in np.frombuffer(buf[:8], np.uint32))
    intr = np.frombuffer(buf[8:24], np.float32)
    data = np.frombuffer(buf[24:24 + 4 * h * w], np.float32).reshape(h, w)
    return data.copy(), *(float(v) for v in intr)


def encode_texture_image(img) -> bytes:
    """RGB texture aligned with a distance image (the reference's
    ImageRGB24 camera input, ``EmbodiedSlamFilter.cpp:259-275``):
    u32 H, u32 W, then H*W*3 f32 in [0, 1]."""
    d = _host(img, np.float32)
    if d.ndim != 3 or d.shape[2] != 3:
        raise ValueError(f"texture must be [H, W, 3], got {d.shape}")
    h, w, _ = d.shape
    return np.array([h, w], np.uint32).tobytes() + d.tobytes()


def decode_texture_image(buf):
    h, w = (int(v) for v in np.frombuffer(buf[:8], np.uint32))
    return np.frombuffer(
        buf[8:8 + 12 * h * w], np.float32
    ).reshape(h, w, 3).copy()


# ------------------------------------------------------------------ API


class LogWriter:
    def __init__(self, path):
        self._h = lib().eslam_log_writer_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open log for writing: {path}")

    def append(self, rec_type, payload: bytes, timestamp_ns=0):
        rc = lib().eslam_log_writer_append(
            self._h, rec_type, timestamp_ns, payload, len(payload)
        )
        if rc != 0:
            raise OSError("log append failed")

    def write_contact_state(self, state, timestamp_ns=0):
        self.append(CONTACT_STATE, encode_contact_state(state), timestamp_ns)

    def write_orientation(self, q, timestamp_ns=0):
        self.append(ORIENTATION, encode_orientation(q), timestamp_ns)

    def write_scan(self, ranges, start_angle, angular_resolution,
                   timestamp_ns=0):
        self.append(
            LASER_SCAN, encode_scan(ranges, start_angle, angular_resolution),
            timestamp_ns,
        )

    def write_pose(self, position, quat, timestamp_ns=0):
        self.append(POSE, encode_pose(position, quat), timestamp_ns)

    def write_distance_image(self, data, scale_x, scale_y, center_x,
                             center_y, timestamp_ns=0):
        self.append(
            DISTANCE_IMAGE,
            encode_distance_image(data, scale_x, scale_y, center_x,
                                  center_y),
            timestamp_ns,
        )

    def write_texture_image(self, img, timestamp_ns=0):
        self.append(TEXTURE_IMAGE, encode_texture_image(img), timestamp_ns)

    def close(self):
        if self._h:
            lib().eslam_log_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _record(fn, handle, *args):
    """Call a native ``get``/``next`` and return ``(type, timestamp,
    payload bytes)``, or None at the end."""
    t, ts, sz = ctypes.c_uint32(), ctypes.c_uint64(), ctypes.c_uint32()
    ptr = fn(handle, *args, ctypes.byref(t), ctypes.byref(ts),
             ctypes.byref(sz))
    if not ptr:
        return None
    return t.value, ts.value, ctypes.string_at(ptr, sz.value)


class LogReader:
    def __init__(self, path):
        self._h = lib().eslam_log_reader_open(str(path).encode())
        if not self._h:
            raise OSError(f"cannot open log: {path}")

    def __len__(self):
        return int(lib().eslam_log_reader_count(self._h))

    def get(self, i):
        rec = _record(lib().eslam_log_reader_get, self._h, i)
        if rec is None:
            raise IndexError(i)
        return rec

    def count_type(self, rec_type):
        return int(lib().eslam_log_reader_count_type(self._h, rec_type))

    def select(self, rec_type):
        """Indices + timestamps of all records of one type (one native
        scan instead of a Python loop over the log)."""
        cap = len(self)
        idx = np.empty(cap, np.int64)
        ts = np.empty(cap, np.uint64)
        n = int(lib().eslam_log_reader_select(
            self._h, rec_type,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cap,
        ))
        return idx[:n], ts[:n]

    def gather(self, idx, record_bytes):
        """Native strided gather of fixed-size payloads: one contiguous
        ``[n, record_bytes]`` uint8 buffer (one allocation, and one
        host-to-device copy downstream)."""
        idx = np.ascontiguousarray(idx, np.int64)
        out = np.empty((idx.size, record_bytes), np.uint8)
        rc = lib().eslam_log_reader_gather(
            self._h,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            idx.size, record_bytes,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc != 0:
            raise ValueError("gather failed (bad record index)")
        return out

    def close(self):
        if self._h:
            lib().eslam_log_reader_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def compact(src, dst, types=(), stride=1):
    """Rewrite a log keeping only ``types`` (empty = all) and every
    ``stride``-th record per type.  Returns the record count written."""
    arr = np.asarray(list(types), np.uint32)
    n = int(lib().eslam_log_compact(
        str(src).encode(), str(dst).encode(),
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        arr.size, stride,
    ))
    if n < 0:
        raise OSError(f"compaction failed: {src} -> {dst}")
    return n


def _as(raw, dtype, shape):
    """Columns of a gathered ``[n, bytes]`` buffer as a typed array."""
    return np.frombuffer(raw.tobytes(), dtype).reshape(shape)


def _frames_of(cts, ts, t):
    """The contact frame each record attaches to: the closest preceding
    one."""
    return np.clip(np.searchsorted(cts, ts, side="right") - 1, 0, t - 1)


def _image_dims(r, idx):
    """``(h, w)`` of the first image record and ``[n, 2]`` of all."""
    dims = _as(r.gather(idx, 8), np.uint32, (-1, 2))
    return (int(dims[0, 0]), int(dims[0, 1])), dims


def load_stream(path):
    """Batch-load a whole recorded traverse as stacked arrays, the input
    of ``filter.streaming.frames_from_log``.

    Uses the native select+gather entry points: the per-record work (type
    filter, payload copy) happens in C; Python does one ``frombuffer`` +
    reshape per record type.  Frame pairing follows the recording
    convention (one contact + orientation [+ pose] per frame, equal
    timestamps; scans and images attach to the closest preceding frame).

    Returns a dict with ``contact`` (structured [T, C]), ``orientation``
    [T, 4], ``pose`` [T, 7] or None, ``scan_ranges`` [T, R],
    ``scan_meta`` (start, resolution), ``has_scan`` [T], ``dimg``
    [T, H, W] or None, ``dimg_meta`` (scale_x, scale_y, center_x,
    center_y), ``has_dimg`` [T], ``timg`` [T, H, W, 3] or None, ``ts``
    [T].
    """
    with LogReader(path) as r:
        cidx, cts = r.select(CONTACT_STATE)
        if cidx.size == 0:
            raise ValueError(f"no contact states in {path}")
        # all contact records must share C (fixed-shape trajectory): a
        # mismatched record would be silently truncated or zero-padded by
        # the fixed-stride C gather
        counts = _as(r.gather(cidx, 4), np.uint32, (-1,))
        c = int(counts[0])
        if not (counts == c).all():
            bad = int(np.nonzero(counts != c)[0][0])
            raise ValueError(
                f"contact record {bad} has {int(counts[bad])} points, "
                f"expected {c} (fixed-shape streams need a uniform count)"
            )
        raw = r.gather(cidx, 4 + c * _CONTACT_DT.itemsize)
        contact = _as(raw[:, 4:], _CONTACT_DT, (cidx.size, c))

        oidx, _ = r.select(ORIENTATION)
        if oidx.size and oidx.size != cidx.size:
            raise ValueError(
                f"log violates the one-record-per-frame convention: "
                f"{oidx.size} orientation records vs {cidx.size} contact "
                "frames (frames would silently misalign)"
            )
        orientation = (_as(r.gather(oidx, 16), np.float32, (-1, 4))
                       if oidx.size else None)
        pidx, _ = r.select(POSE)
        if pidx.size and pidx.size != cidx.size:
            raise ValueError(
                f"log violates the one-record-per-frame convention: "
                f"{pidx.size} pose records vs {cidx.size} contact frames"
            )
        pose = (_as(r.gather(pidx, 28), np.float32, (-1, 7))
                if pidx.size else None)

        t = cidx.size
        sidx, sts = r.select(LASER_SCAN)
        scan_ranges = scan_meta = None
        has_scan = np.zeros((t,), bool)
        if sidx.size:
            ray_counts = _as(r.gather(sidx, 4), np.uint32, (-1,))
            n_rays = int(ray_counts[0])
            if not (ray_counts == n_rays).all():
                bad = int(np.nonzero(ray_counts != n_rays)[0][0])
                raise ValueError(
                    f"scan record {bad} has {int(ray_counts[bad])} rays, "
                    f"expected {n_rays} (the fixed-stride gather would "
                    "silently truncate or zero-pad it)"
                )
            sraw = r.gather(sidx, 12 + 4 * n_rays)
            meta = _as(sraw[:, 4:12], np.float32, (-1, 2))
            scan_meta = (float(meta[0, 0]), float(meta[0, 1]))
            scan_ranges = np.zeros((t, n_rays), np.float32)
            fi = _frames_of(cts, sts, t)
            if np.unique(fi).size != fi.size:
                warnings.warn(
                    "multiple scans map to the same contact frame; "
                    "earlier scans of a frame are dropped "
                    "(last-writer-wins)",
                    stacklevel=2,
                )
            scan_ranges[fi] = _as(sraw[:, 12:], np.float32, (-1, n_rays))
            has_scan[fi] = True

        didx, dts = r.select(DISTANCE_IMAGE)
        dimg = dimg_meta = None
        has_dimg = np.zeros((t,), bool)
        if didx.size:
            (h, w), dims = _image_dims(r, didx)
            if not ((dims[:, 0] == h) & (dims[:, 1] == w)).all():
                bad = int(np.nonzero(
                    (dims[:, 0] != h) | (dims[:, 1] != w)
                )[0][0])
                raise ValueError(
                    f"distance image {bad} is {tuple(dims[bad])}, "
                    f"expected {(h, w)} (fixed-shape streams need one "
                    "image geometry)"
                )
            draw = r.gather(didx, 24 + 4 * h * w)
            intr = _as(draw[:, 8:24], np.float32, (-1, 4))
            dimg_meta = tuple(float(v) for v in intr[0])
            dimg = np.zeros((t, h, w), np.float32)
            fi = _frames_of(cts, dts, t)
            if np.unique(fi).size != fi.size:
                warnings.warn(
                    "multiple distance images map to the same contact "
                    "frame; earlier ones are dropped (last-writer-wins)",
                    stacklevel=2,
                )
            dimg[fi] = _as(draw[:, 24:], np.float32, (-1, h, w))
            has_dimg[fi] = True

        tidx, tts = r.select(TEXTURE_IMAGE)
        timg = None
        if tidx.size:
            (th, tw), tdims = _image_dims(r, tidx)
            if not ((tdims[:, 0] == th) & (tdims[:, 1] == tw)).all():
                raise ValueError(
                    "texture images must share one geometry "
                    "(fixed-shape streams)"
                )
            traw = r.gather(tidx, 8 + 12 * th * tw)
            timg = np.zeros((t, th, tw, 3), np.float32)
            timg[_frames_of(cts, tts, t)] = _as(traw[:, 8:], np.float32,
                                                (-1, th, tw, 3))

    return {
        "contact": contact,
        "orientation": orientation,
        "pose": pose,
        "scan_ranges": scan_ranges,
        "scan_meta": scan_meta,
        "has_scan": has_scan,
        "dimg": dimg,
        "dimg_meta": dimg_meta,
        "has_dimg": has_dimg,
        "timg": timg,
        "ts": cts,
    }


class AsyncFeeder:
    """Sequential reads prefetched by a native worker thread into
    ``slots`` host buffers (see the C side)."""

    def __init__(self, reader: LogReader, slots=8):
        self._reader = reader
        self._h = lib().eslam_feeder_create(reader._h, slots)
        if not self._h:
            raise OSError("feeder creation failed")

    def __iter__(self):
        return self

    def __next__(self):
        rec = _record(lib().eslam_feeder_next, self._h)
        if rec is None:
            raise StopIteration
        return rec

    def close(self):
        if self._h:
            lib().eslam_feeder_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
