"""Median host milliseconds a frame from the launch's return to the display
image in host memory (the program's resolve and the copy, and any of the
frame's device work still queued), over the window's frames; nothing in a
mix that does not show every frame."""

import statistics


def read(ctx):
    ms = ctx.spans.get("display_ms")
    return statistics.median(ms) if ms else None
