"""Core containers: boxes, bordered images, border fills, keypoint sets."""
