"""Plate-scale execution."""
