"""Seconds of the scene upload (accelerator build and copy to the card),
on the host clock around the program's `upload_scene`, ended by a
synchronize."""


def read(ctx):
    return ctx.spans.get("upload_s")
