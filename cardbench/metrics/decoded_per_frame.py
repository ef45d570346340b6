"""decoded_per_frame.<cell>: source frames the compressed lane
entropy-decoded in the window (`jpeg_ingest.ENTROPY_FRAMES`, a counter of
the program's) over the frames the window rendered. None where the
program has no such counter."""


def read(rec):
    n = rec.get("entropy_frames")
    return n / rec["frames"] if n is not None and rec["frames"] else None
