"""Framework version.

Reference parity: version/version.go:17 (reference v1.5.2).
"""

__version__ = "0.1.0"
