"""launches_per_frame: runs of the megakernel (``megakernel.RUNS``, one
B1 launch each on the card) over the window, divided by its frames.
Layer: the flat and staged drivers (render/renderer.py,
render/megakernel.py). A program counter."""


def read(run):
    return run.window.launches / len(run.frames) if run.frames else None
