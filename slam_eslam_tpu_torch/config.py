"""Configuration of the PyTorch/CUDA port.

The port's own copy of the JAX package's ``config.py`` (same field names
and defaults, so the parity tests can hand either package's objects to
either side).  Mirrors the reference configuration structs
(``src/Configuration.hpp:83-213``) as frozen dataclasses; defaults are
identical to the reference constructor defaults.

One intentional deviation: the reference ``UpdateThreshold::test(Affine3d)``
passes its arguments swapped (angle into the distance slot,
``Configuration.hpp:23-26``).  We implement the evidently-intended semantics
(distance compared against distance, angle against angle).
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class UpdateThreshold:
    """Distance/angle gate for triggering an update.

    Reference: ``src/Configuration.hpp:12-30``.  ``test`` returns True when
    either the travelled distance or rotated angle exceeds its threshold.
    """

    distance: float = 0.0
    angle: float = 0.0

    def test(self, distance, angle):
        """Does the motion exceed the gate?  Numbers or tensors."""
        return (distance > self.distance) | (angle > self.angle)


@dataclasses.dataclass(frozen=True)
class SurfaceHashConfig:
    """Terrain-signature hash configuration.

    Reference: ``src/Configuration.hpp:32-49``.
    """

    use_hash: bool = False
    period: int = 10            # steps between hash-based reinjections
    percentage: float = 0.05    # fraction of particles eligible for replacement
    avg_factor: float = 0.1     # weight factor (x avg weight) of respawned particles
    slope_bins: int = 20        # hash bins per slope axis
    angular_steps: int = 16     # heading discretisation of the hash
    # Health gate (deviation from the reference, which reinjects on
    # every period tick regardless of filter state,
    # PoseEstimator.cpp:130-182): when > 0, the replacement count is
    # scaled by the same collapsed-max-weight ramp that drives recovery
    # spreading (weighting_function(max_weight, 0, lost_threshold, 0)) —
    # a tracking filter (max_weight >= lost_threshold) injects nothing,
    # a lost one (max_weight -> 0) injects the full percentage.
    # Rationale: on signature-ambiguous terrain unconditional injection
    # teleports surviving candidates into the cloud and the centroid
    # walks (measured: 33.4 m vs 3-5 m ATE on the 100 m stretch route);
    # gating on the reference's own lost signal keeps the
    # kidnapped-robot insurance without the steady-state poisoning.
    # 0 = reference-faithful unconditional injection.
    lost_threshold: float = 0.0


@dataclasses.dataclass(frozen=True)
class ContactModelConfig:
    """Contact measurement-model configuration.

    Reference: ``src/Configuration.hpp:51-81``.
    """

    use_slip_update: bool = False
    use_shape_update: bool = True
    # minimum number of valid contact groups for a height measurement;
    # particles below this are "floating".
    min_contacts: int = 3
    contact_likelihood_correction: float = 0.33
    contact_point_radius: float = 0.01
    # weighting variant: "ratio" = the default ContactModel
    # (``ContactModel.cpp:262-317``); "chitta" = the literature-based
    # alternative model class (``ChittaContactModel``,
    # ``src/ContactModel.hpp:168-173``, ``ContactModel.cpp:342-361``)
    weighting: str = "ratio"
    # fold the likelihood ratio + group reductions into the contact-fold
    # kernel (``lookup.fold``, ops.contact_fold) when neither slip/terrain
    # probabilities nor debug points are requested: semantics-preserving
    # to ~5e-5 rel (the in-kernel Mills-ratio approximation)
    fold_lookup: bool = True


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """Contact-odometry noise model.

    The reference consumes the external Rock ``odometry`` package
    (``manifest.xml:9-15``); its ``Configuration`` carries a seed plus
    constant and per-distance error growth terms used by
    ``getPoseDeltaSample2D()`` (``src/PoseEstimator.cpp:198``).  We rebuild
    the capability: a Gaussian error model whose standard deviation is
    ``const_error + dist_error * |delta|`` per axis (x, y, theta), plus a
    vertical term used for the z-variance propagation
    (``src/PoseEstimator.cpp:192``).
    """

    seed: int = 42
    # standard deviations, constant part [m, m, rad]
    const_error_xy: float = 0.002
    const_error_yaw: float = 0.002
    # standard deviations, growth per metre travelled
    dist_error_xy: float = 0.05
    dist_error_yaw: float = 0.05
    # vertical error growth (feeds z variance propagation)
    const_error_z: float = 0.002
    dist_error_z: float = 0.05
    # contact probability above which a point counts as "in contact"
    contact_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class Config:
    """Top-level filter configuration.

    Reference: ``src/Configuration.hpp:83-213`` (identical defaults).
    """

    seed: int = 42
    particle_count: int = 250
    min_effective: int = 50
    # initial sampling spread: rotational (rx, ry, rz) and translational parts
    initial_rotation_error: tuple = (0.0, 0.0, 0.1)
    initial_translation_error: tuple = (0.1, 0.1, 1.0)
    measurement_error: float = 0.1
    discount_factor: float = 0.9
    spread_threshold: float = 0.9
    spread_translation_factor: float = 0.1
    spread_rotation_factor: float = 0.05
    slip_factor: float = 0.05
    max_yaw_deviation: float = 15.0 * math.pi / 180.0
    measurement_threshold: UpdateThreshold = UpdateThreshold(0.1, 10 * math.pi / 180.0)
    mapping_threshold: UpdateThreshold = UpdateThreshold(0.02, 5 * math.pi / 180.0)
    mapping_camera_threshold: UpdateThreshold = UpdateThreshold(1.0, 30 * math.pi / 180.0)
    grid_size: float = 20.0
    grid_resolution: float = 0.05
    grid_threshold: float = 0.5
    grid_patch_thickness: float = 0.1
    grid_gap_size: float = 1.5
    grid_use_negative_information: bool = False
    max_sensor_range: float = 3.0
    use_visual_update: bool = False
    contact_model: ContactModelConfig = ContactModelConfig()
    log_debug: bool = False
    log_particle_period: int = 100

    # ---- additions with no reference counterpart ----
    # wrap-safe centroid yaw: the reference's getCentroid takes a plain
    # weighted mean of yaw (``PoseEstimator.cpp:368``), which breaks at
    # the +-pi wrap; True switches to the circular mean
    # atan2(sum w sin, sum w cos).  Default False = faithful.
    wrap_safe_centroid: bool = False
    # shared-map lookup path of the JAX package ("gather", "window",
    # "auto"); the port has one full-grid lookup and accepts every value
    lookup_mode: str = "auto"
    # window size and tiers of the JAX package's windowed lookup:
    # accepted and ignored (the port gathers from the full grid)
    lookup_window: tuple = (128, 96)
    lookup_tiers: tuple = ((128, 32), (128, 64))
    # number of patch slots per MLS cell (fixed-shape patch lists)
    mls_patches_per_cell: int = 4
    # z search window (m) for MLSMap::getPatch (reference passes 3.0,
    # src/PoseEstimator.hpp:101)
    mls_z_window: float = 3.0
    # map-pool capacity for per-particle maps (copy-on-write blocks)
    map_pool_blocks: int = 8
    # carry patch colours in the per-particle map pool (needed by the
    # slip/terrain fusion and texture paths in SLAM mode; False saves
    # 1.5x patch memory + merge traffic)
    map_pool_color: bool = True
    # storage dtype of the pool's float patch fields: 'float32' (exact)
    # or 'bfloat16' (10 bytes/patch-slot instead of 16, the setting of
    # 100k-particle per-particle SLAM; all fusion arithmetic stays f32,
    # values round once on store, lookups return f32)
    map_pool_dtype: str = "float32"
    # max grids chained per particle map (MLSMap grid chain)
    map_chain_length: int = 4
    # block-allocation locality ranges for a device mesh; 1 = global
    # allocation (the port's multi-GPU slice is not written yet)
    map_pool_shards: int = 1
    # kernel selection and grouping knobs of the JAX package's map-pool
    # kernels: accepted and ignored (one CUDA kernel each serves every
    # pool, ops.block_merge and ops.chain_lookup)
    merge_kernel: str = "auto"
    merge_group: int = 1
    chain_kernel: str = "auto"
