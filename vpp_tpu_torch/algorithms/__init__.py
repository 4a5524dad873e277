"""Algorithms: pyramids, FAST9, semi-dense flow, the video_extruder
tracker, the dense Hough transform and the Hough line tracker."""
