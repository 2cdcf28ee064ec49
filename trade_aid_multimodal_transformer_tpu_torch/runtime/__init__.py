"""Native host helpers: the C++ data transforms (native.py)."""
