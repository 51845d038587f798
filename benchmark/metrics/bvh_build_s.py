"""bvh_build_s: host time of the program's ``tpurt.scene.bvh`` spans
(SceneBuilder.add_triangles: the SAH build, native for large meshes) over
the whole run; the scene is built once, in set-up. Layer: scene build
(scene/builder.py, accel/bvh.py, csrc/tpurt_native.cpp). A program span;
nothing where the program has no such span."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        spans = profiling.totals()["spans"]
    except (ImportError, AttributeError):
        return None
    rec = spans.get("tpurt.scene.bvh")
    return rec["total_s"] if rec else None
