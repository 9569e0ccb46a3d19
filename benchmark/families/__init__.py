"""Decoder families, one directory each (``lib/spec.py:load_family``)."""
