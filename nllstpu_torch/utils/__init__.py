"""Utilities of the port: checkpoints, profiling and the native BAL parser."""
