"""Execution paths a cell's window drives, one file a path (traffic files name them)."""
