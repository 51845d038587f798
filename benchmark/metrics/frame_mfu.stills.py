"""frame_mfu: the work of the stretch's frames (the roofline's operation
count, yardstick/roofline.py) over the stretch's wall time and the
chip's f32 peak (67e12/s, H100 SXM): the whole frame's share of the
peak, host time included, which bounds any kernel's roofline claim."""

from yardstick import roofline


def read(run):
    sm = run.summary
    if sm is None or sm.busy_s <= 0 or not run.exact_segments:
        return None
    ops = run.exact_segments * roofline.ops_per_segment(run.mesh_triangles)
    return 100.0 * ops / roofline.PEAK_F32 / sm.window_s
