"""The benchmark's yardstick: traffic, weights, windows, traces, checks."""
