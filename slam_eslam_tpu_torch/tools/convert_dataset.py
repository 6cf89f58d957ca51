"""Dataset conversion: text/CSV robot logs -> the native .eslg format.

Counterpart of the JAX package's ``tools/convert_dataset.py``.  The
reference ecosystem feeds eslam from Rock log streams; here the exchange
formats are plain text files, converted once into the binary log
(``native/eslam_log.cpp``) that ``streaming.frames_from_log`` batch-loads.

Inputs (all optional, merged by timestamp):

* ``--trajectory``: TUM-style ``ts x y z qx qy qz qw`` lines ->
  POSE (+ ORIENTATION) records.  ``ts`` in seconds (float).
* ``--contacts``: CSV ``ts,idx,x,y,z,contact,group``, one line per
  contact candidate; lines sharing ``ts`` form one CONTACT_STATE
  (candidates ordered by ``idx``; every state must have the same
  candidate count).
* ``--scans``: CSV ``ts,start_angle,angular_resolution,r0,r1,...`` ->
  LASER_SCAN records.

Usage:
  python -m slam_eslam_tpu_torch.tools.convert_dataset out.eslg \\
      --trajectory tum.txt --contacts contacts.csv --scans scans.csv
"""

from __future__ import annotations

import argparse

import numpy as np

from slam_eslam_tpu_torch.core.state import BodyContactState
from slam_eslam_tpu_torch.io import logio

# record order among equal timestamps
_ORDER = {"orientation": 0, "contact": 1, "pose": 2, "scan": 3}


def _lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_trajectory(path):
    rows = []
    for line in _lines(path):
        v = [float(x) for x in line.replace(",", " ").split()]
        if len(v) < 8:
            raise ValueError(f"trajectory line needs 8 fields: {line}")
        rows.append(v[:8])
    return np.asarray(rows, np.float64)


def read_contacts(path):
    frames = {}
    for line in _lines(path):
        v = line.split(",")
        frames.setdefault(float(v[0]), []).append(
            (int(v[1]), [float(v[2]), float(v[3]), float(v[4])],
             float(v[5]), int(v[6])))
    return frames


def read_scans(path):
    scans = []
    for line in _lines(path):
        v = [float(x) for x in line.split(",")]
        scans.append((v[0], v[1], v[2], np.asarray(v[3:], np.float32)))
    return scans


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("output")
    ap.add_argument("--trajectory")
    ap.add_argument("--contacts")
    ap.add_argument("--scans")
    args = ap.parse_args(argv)
    if not (args.trajectory or args.contacts or args.scans):
        ap.error("provide at least one input file")

    records = []  # (ts_ns, kind, payload_args)
    if args.trajectory:
        for row in read_trajectory(args.trajectory):
            ts = int(row[0] * 1e9)
            # TUM order qx qy qz qw -> ours (w, x, y, z)
            q = np.array([row[7], row[4], row[5], row[6]], np.float32)
            records.append((ts, "pose", (row[1:4], q)))
            records.append((ts, "orientation", (q,)))
    if args.contacts:
        frames = read_contacts(args.contacts)
        counts = {len(v) for v in frames.values()}
        if len(counts) != 1:
            raise ValueError(
                f"contact states must share a candidate count; got {counts}")
        for ts, pts in sorted(frames.items()):
            pts.sort(key=lambda p: p[0])
            cs = BodyContactState.create(
                np.asarray([p[1] for p in pts], np.float32),
                contact=np.asarray([p[2] for p in pts], np.float32),
                group_id=np.asarray([p[3] for p in pts], np.int32))
            records.append((int(ts * 1e9), "contact", (cs,)))
    if args.scans:
        for ts, start, res, ranges in read_scans(args.scans):
            records.append((int(ts * 1e9), "scan", (ranges, start, res)))

    records.sort(key=lambda r: (r[0], _ORDER[r[1]]))
    with logio.LogWriter(args.output) as w:
        write = {"pose": w.write_pose, "orientation": w.write_orientation,
                 "contact": w.write_contact_state, "scan": w.write_scan}
        for ts, kind, payload in records:
            write[kind](*payload, timestamp_ns=ts)
    print(f"wrote {len(records)} records -> {args.output}")
    return len(records)


if __name__ == "__main__":
    main()
