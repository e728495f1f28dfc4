"""Compaction math (single device in this slice)."""
