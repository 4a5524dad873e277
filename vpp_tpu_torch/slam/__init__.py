"""SLAM back end of the port: SE(3) maps, window BA (kernel K6) and the
tracking+BA pipeline."""
