"""Trajectory evaluation: ATE, RPE and dataset sweeps (numpy)."""
