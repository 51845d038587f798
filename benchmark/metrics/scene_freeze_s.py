"""scene_freeze_s: host time of the program's ``tpurt.scene.freeze``
spans (SceneBuilder.freeze: the node rows, the megakernel's bank and the
scene's tensors on the device) over the whole run; the scene is built
once, in set-up. Layer: scene build (scene/builder.py, accel/bvh.py,
csrc/tpurt_native.cpp). A program span; nothing where the program has no
such span."""


def read(run):
    try:
        from tpurt_torch.utils import profiling

        spans = profiling.totals()["spans"]
    except (ImportError, AttributeError):
        return None
    rec = spans.get("tpurt.scene.freeze")
    return rec["total_s"] if rec else None
