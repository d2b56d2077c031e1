"""Process options (options.py)."""
