"""Compute ops: color algebra, ray generation, intersection, shading,
acceleration structures, scans/sorts, and the Pallas sweep kernel."""
