"""Batched merge front ends over one device (parallel/fleet.py)."""
