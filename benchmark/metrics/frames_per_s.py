"""frames_per_s: frames whose uint8 image reached the host, over the time
from the window's start to the return of the first request that ended
after ``--seconds`` (all the work over all the time: a stall counts in
full). Host clock."""


def read(run):
    return len(run.frames) / run.window_s()
