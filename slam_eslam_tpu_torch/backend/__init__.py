"""Loop-closure backend: the pose graph and the keyframe manager."""
