"""Utilities: the golden regression anchors the port can render."""
