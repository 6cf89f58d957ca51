"""Offline plots of the filter (matplotlib, imported when drawing)."""
