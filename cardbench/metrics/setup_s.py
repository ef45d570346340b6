"""setup_s: seconds from the run's start to the window's first frame
(host clock)."""


def read(rec):
    return rec["setup_s"]
