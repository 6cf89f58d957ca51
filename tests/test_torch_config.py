"""The port's ``config.py`` against the JAX package's.

The port keeps its own copy of the configuration dataclasses (it imports
nothing of the JAX package), and its benchmark starts from the port's
``Config()``, so a default that drifted would change what the card is
measured on.  Every dataclass of the two modules has the same fields in
the same order with equal defaults, nested dataclasses compared field by
field; ``UpdateThreshold.test`` agrees on seeded inputs (exactly: two
comparisons and an or).
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_eslam_tpu import config as jconfig
from slam_eslam_tpu_torch import config as tconfig

CLASSES = ["UpdateThreshold", "SurfaceHashConfig", "ContactModelConfig",
           "OdometryConfig", "Config"]


def as_plain(value):
    """A default with nested dataclasses turned into dicts, so that the
    two packages' objects compare by content."""
    if dataclasses.is_dataclass(value):
        return {f.name: as_plain(getattr(value, f.name))
                for f in dataclasses.fields(value)}
    return value


def test_the_modules_define_the_same_dataclasses():
    found = lambda mod: sorted(
        name for name, obj in vars(mod).items()
        if dataclasses.is_dataclass(obj) and obj.__module__ == mod.__name__)
    assert found(tconfig) == found(jconfig) == sorted(CLASSES)


@pytest.mark.parametrize("name", CLASSES)
def test_fields_and_defaults_are_equal(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jfields, tfields = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in tfields] == [f.name for f in jfields]
    jobj, tobj = jcls(), tcls()
    for f in jfields:
        assert as_plain(getattr(tobj, f.name)) == as_plain(
            getattr(jobj, f.name)), f.name
    assert (tcls.__dataclass_params__.frozen
            and jcls.__dataclass_params__.frozen)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_threshold_gate(seed):
    rng = np.random.default_rng(seed)
    distance = rng.uniform(0, 0.2, 64).astype(np.float32)
    angle = rng.uniform(0, 0.3, 64).astype(np.float32)
    for name in ("measurement_threshold", "mapping_threshold",
                 "mapping_camera_threshold"):
        jgate = getattr(jconfig.Config(), name)
        tgate = getattr(tconfig.Config(), name)
        ref = np.asarray(jgate.test(distance, angle))
        got = tgate.test(torch.from_numpy(distance), torch.from_numpy(angle))
        np.testing.assert_array_equal(got.numpy(), ref)
        # on the gate's own thresholds: strictly greater, on both sides
        assert not tgate.test(tgate.distance, tgate.angle)
        assert not jgate.test(jgate.distance, jgate.angle)
