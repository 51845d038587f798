"""scene_build_s: the benchmark's host span around building the scene on
the device (SceneBuilder.add_triangles, the SAH build, scene_around with
the Cornell box and the freeze), ended by a synchronise. Layer: scene
build (scene/builder.py, accel/bvh.py, csrc/tpurt_native.cpp)."""


def read(run):
    return run.scene_build_s
