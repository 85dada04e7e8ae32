"""The harness: cells, traffic, the window, the reference and the check."""
