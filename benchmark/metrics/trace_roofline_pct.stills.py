"""trace_roofline_pct: the least time the chip could take for the
stretch's frames over the device time of its ``megakernel`` kernels.

    bound = max(ops / 67e12, bytes / 3.35e12)      (H100 SXM peaks)
    ops   = segments * (2 * ceil(log2 N) * 55 + 3 * 21 + 25)
    bytes = frames * (T * 18 * 4 + W * H * 3 * 4)

N: the configuration's mesh triangles; T: the scene's (mesh and box);
segments: the frames' exact path segments, padding lanes excluded (the
program's count on the plain schedule less the padding slots times the
reference's count of the frame's last pixel, which they repeat). The
work counted is the frame's, whatever implements it: no box tests of
the kernel's own, no brute-force pairs. yardstick/roofline.py holds the
constants. Layer: kernels B1 / B2."""

from yardstick import roofline


def read(run):
    sm = run.summary
    frames = len(run.profiled())
    k_s = sm.by_layer.get("megakernel", 0.0) if sm else 0.0
    if not frames or k_s <= 0 or not run.exact_segments:
        return None
    bound = roofline.bound_s(run.exact_segments, frames, run.mesh_triangles,
                             run.scene_triangles, run.width, run.height)
    return 100.0 * bound / k_s
