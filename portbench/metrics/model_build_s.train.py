"""model_build_s.train: Host seconds of the program's model build in set-up:
its set-up record's `build.*` phases (utils/trace.py's SETUP)."""

from harness.spans import model_build_s

UNIT = "s"


def read(r):
    return model_build_s(r, 'train')
