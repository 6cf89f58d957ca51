"""Terrain classification fusion (slip update).

Port of ``slam_eslam_tpu.models.terrain`` (the ``terrain_estimator``
capability consumed by ``ContactModel.cpp:226-260``): per-wheel class
probability vectors over ``NUM_CLASSES`` classes, a visual /
proprioceptive joint probability, and an RGB encoding so class
information rides in MLS patch colours.
"""

from __future__ import annotations

import torch

NUM_CLASSES = 3


def joint_probability(visual, proprioceptive):
    """P(same class) of two independent classifications
    (``TerrainClassification::jointProbability``); broadcasts over
    leading axes."""
    num = (visual * proprioceptive).sum(-1)
    den = (torch.linalg.vector_norm(visual, dim=-1)
           * torch.linalg.vector_norm(proprioceptive, dim=-1))
    return torch.where(den > 0, num / den.clamp(min=1e-12),
                       torch.ones_like(num))


def to_rgb(classification):
    """Class probabilities -> RGB in [0, 1] (``toRGB``): the first
    ``NUM_CLASSES`` channels, the rest zero."""
    rgb = classification.new_zeros(classification.shape[:-1] + (3,))
    rgb[..., :NUM_CLASSES] = classification[..., :NUM_CLASSES]
    return rgb


def from_rgb(rgb):
    """RGB -> class probabilities (``fromRGB``); black decodes to the
    uniform distribution."""
    p = rgb[..., :NUM_CLASSES]
    s = p.sum(-1, keepdim=True)
    return torch.where(s > 0, p / s.clamp(min=1e-12),
                       torch.full_like(p, 1.0 / NUM_CLASSES))


def per_point_probability(group_id, patch_color, wheel_classifications,
                          wheel_valid, with_mask=False):
    """Slip probability per contact point: the joint probability of the
    point's wheel classification (``wheel_idx == groupId``,
    ``ContactModel.cpp:236``) and the class decoded from the queried
    patch colour; 1 for points whose wheel has none.

    ``group_id [C]``, ``patch_color [..., C, 3]``,
    ``wheel_classifications [W, NUM_CLASSES]``, ``wheel_valid [W]``.
    Returns ``prob [..., C]``, with ``with_mask`` also ``has [C]`` (the
    slip-point debug mask, ``ContactModel.cpp:248-254``)."""
    w = wheel_classifications.shape[0]
    gid = group_id.clamp(0, w - 1).long()
    prop = wheel_classifications[gid]
    prob = joint_probability(from_rgb(patch_color), prop)
    has = (group_id >= 0) & wheel_valid[gid]
    prob = torch.where(has, prob, torch.ones_like(prob))
    if with_mask:
        return prob, has
    return prob
