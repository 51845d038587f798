"""Render configuration: tpurt_torch's own copy of tpurt/config.py.

``RenderConfig`` has tpurt's fields, defaults and refusals, so a config
written for one package means the same render in the other
(tests/test_torch_config.py holds the two equal), and after them the
port's own ``MODEL_FIELDS``: the model's material and scale, whose
defaults are the override tpurt's main program applies. The module
constants are the ones the port reads; they take tpurt's values, which
shape the bank layout and the lane trajectories. Knobs that only
schedule work on the TPU are accepted and ignored, as their docs below
say.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

#: Space between the loaded model and the Cornell-box walls
#: (ref: src/settings.hpp:52  CORNELL_BREATHING_ROOM).
CORNELL_BREATHING_ROOM = 100.0

#: Numeric epsilon used throughout the kernel (ref: src/Trace.cl:6).
EPSILON = 1e-6

#: Index of refraction of the surrounding medium (ref: src/Trace.cl:7).
IOR_AIR = 1.0

#: Chain length above which the megakernel's chain skip is off (tpurt
#: switches its parameter fetches from selects to gathers there). Lane
#: trajectories after k trips depend on it, results do not.
SELECT_GATHER_THRESHOLD = 64

#: Instanced-mesh count above which freeze routes meshes through a
#: top-level BVH of instance rows (the TLAS regime).
MEGA_TLAS_THRESHOLD = 8

#: Chain entries the enter step advances past in place when their root
#: pretests fail (the chain skip).
MEGA_SKIP_CAP = 3

#: Enter-time root expansion: an entry whose root is a node row runs its
#: child test from a precomputed table and descends at once. Off for
#: chains longer than MEGA_ROOT_EXPAND_MAX_E entries.
MEGA_ROOT_EXPAND = True
MEGA_ROOT_EXPAND_MAX_E = 4

#: Tail passes that run the root expansion (99 = every pass).
MEGA_EXPAND_PASSES = 99

#: Inline exact triangles per megakernel leaf row (read at freeze).
MEGA_LEAF_TRIS = 3

#: Children per megakernel node row (read at freeze; <= 63).
MEGA_NODE_ARITY = 8

#: bf16 node-row child bounds instead of u8 (read at freeze).
MEGA_BF16_BOUNDS = False


#: The keys a ``RenderConfig.model_material`` may give
#: (scene.builder.Material's fields).
MATERIAL_KEYS = ("type", "ior", "color", "emission_color",
                 "emission_strength", "reflectiveness", "specular_probability")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Knobs of a single render. Defaults mirror src/settings.hpp:23-50
    and the camera set-up at src/main.cpp:299-304."""

    width: int = 512
    height: int = 512
    rays_per_pixel: int = 50
    max_bounces: int = 50
    tile_size: int = 512
    object_path: str = "knight.obj"

    #: Camera start pose (ref: src/settings.hpp:23-28).
    camera_position: Tuple[float, float, float] = (0.0, 150.0, 250.0)
    camera_pitch: float = 0.0
    camera_yaw: float = 3.14
    camera_roll: float = 0.0
    fov_degrees: float = 90.0

    #: "reference": one RNG stream across all samples of a pixel (the
    #: reference's spp loop, Trace.cl:639-642). "decorrelated": each
    #: sample re-seeded with MakeSeed(pixel, frame, sample).
    seed_mode: str = "reference"

    #: Extra bounce-loop trips granted to Invisible pass-throughs, which
    #: do not count as bounces (Trace.cl:502-506); bounds the loop.
    invisible_budget: int = 32

    video_frame_count: int = 1
    video_output_dir: str = "img"

    #: Sub-pixel jitter from an auxiliary stream: each sample's primary
    #: ray moves within its pixel (the megakernel: every new sample after
    #: the lane's first, with the primary-hit cache off; the modular
    #: engine: sample 0's ray shared in reference mode, a ray a sample in
    #: decorrelated mode), as tpurt's.
    subpixel_jitter: bool = False

    #: Modular engine: meshes with at most this many triangles are swept
    #: by brute force (dense_engine), larger ones walk their BVH.
    bruteforce_threshold: int = 4096

    #: Lanes per megakernel launch on the flat path; a frame renders as
    #: ceil(W*H / (rays_per_batch * pixels_per_lane)) launches.
    rays_per_batch: int = 262144

    #: Pixels each megakernel lane renders in turn (stride: the batch).
    pixels_per_lane: int = 1

    #: One-sample passes accumulated per frame (decorrelated mode only;
    #: ROADMAP A.5).
    sample_flatten: bool = False

    #: Flat batches of at least this many lanes, and megakernel tiles of
    #: at least this many pixels, run through the staged drivers
    #: (render/renderer.py: capped stages, lane compaction, respread);
    #: 0 = the plain schedule always.
    compaction_threshold: int = 32768

    #: "mega": the persistent-lane megakernel. "modular": the nested
    #: bounce loop with scene intersection per segment, the megakernel's
    #: cross-check.
    engine: str = "mega"

    #: Megakernel backend: "auto" runs the CUDA kernel for a scene on a
    #: CUDA device and the plain torch version for a CPU scene; "xla"
    #: the plain torch version anywhere; "pallas" the CUDA kernel
    #: (raises for a CPU scene). Names kept from tpurt.
    mega_body: str = "auto"

    #: TPU gather/body overlap schedules: bitwise no-ops, ignored.
    mega_interleave: int = 1

    #: Segment-completion passes per megakernel loop trip.
    mega_tail_passes: int = 1

    #: Frames packed into one megakernel launch (ROADMAP A.3).
    mega_frames_per_batch: int = 1

    #: TPU gather/body overlap schedules: bitwise no-ops, ignored.
    mega_schedule: str = "inline"

    #: The staged drivers' steps: re-trace a quota batch's incomplete
    #: pixels as a P = 1 tail batch; as cascading list-quota levels
    #: instead; replay a recorded plan without host reads of the live
    #: counts.
    mega_tail_respread: bool = True
    mega_cascade: bool = True
    mega_speculative: bool = True

    #: Brute-force megakernel: each loop trip resolves a lane's whole
    #: chain entry with the dense Plücker sweep (render/plucker_fused.py)
    #: instead of walking the row bank. Acceptance within ~1 ulp of the
    #: sequential math, shading data exact.
    mega_dense: bool = False

    #: Modular engine's brute-force sweep: "exact" (the plain torch MT
    #: sweep), "plucker" (the Plücker form, render/plucker.py) or
    #: "pallas" (render/mt_sweep.py: the CUDA kernel on a CUDA scene, its
    #: plain version — the exact sweep — on a CPU scene).
    dense_engine: str = "exact"

    #: The port's own fields (``MODEL_FIELDS``): the model's material, a
    #: mapping of scene.builder.Material's fields (``type`` a
    #: MaterialType value, lists for colours), and the scale it is drawn
    #: at, the Cornell box sized around it. None and 0.5: the reference
    #: main program's override (main.cpp:256-266), white Solid with
    #: specularProbability 1 at scale 0.5.
    model_material: Optional[Mapping[str, object]] = None
    model_scale: float = 0.5

    def __post_init__(self) -> None:
        if self.seed_mode not in ("reference", "decorrelated"):
            raise ValueError(f"unknown seed_mode: {self.seed_mode!r}")
        if self.engine not in ("mega", "modular"):
            raise ValueError(f"unknown engine: {self.engine!r}")
        if self.dense_engine not in ("exact", "plucker", "pallas"):
            raise ValueError(f"unknown dense_engine: {self.dense_engine!r}")
        if self.mega_body not in ("auto", "xla", "pallas"):
            raise ValueError(f"unknown mega_body: {self.mega_body!r}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image dimensions must be positive")
        if self.rays_per_pixel <= 0:
            raise ValueError("rays_per_pixel must be positive")
        if self.pixels_per_lane < 1:
            raise ValueError("pixels_per_lane must be >= 1")
        if self.mega_interleave < 1:
            raise ValueError("mega_interleave must be >= 1")
        if self.mega_tail_passes < 1:
            raise ValueError("mega_tail_passes must be >= 1")
        if self.mega_schedule not in ("inline", "gfirst", "carry", "pair2"):
            raise ValueError(
                "mega_schedule must be 'inline', 'gfirst', 'carry' or"
                " 'pair2'"
            )
        if self.sample_flatten and self.seed_mode != "decorrelated":
            raise ValueError(
                "sample_flatten requires seed_mode='decorrelated' "
                "(reference mode's RNG stream is sequential across a "
                "pixel's samples)"
            )
        if self.model_material is not None:
            extra = set(self.model_material) - set(MATERIAL_KEYS)
            if extra or self.model_material.get("type") not in range(5):
                raise ValueError(
                    "model_material needs a type in 0..4 and no keys but "
                    f"{', '.join(MATERIAL_KEYS)}")
        if not self.model_scale > 0:
            raise ValueError("model_scale must be positive")
        # Reference clamps tile size into [1, min(W, H)] (src/main.cpp:230-234).
        object.__setattr__(
            self, "tile_size", max(1, min(self.tile_size, self.width, self.height))
        )

    @property
    def aspect_ratio(self) -> float:
        return float(self.width) / float(self.height)

    def tiles(self) -> Tuple[int, int]:
        """Number of tiles (x, y), ceil-divided like src/main.cpp:678-684."""
        tx = -(-self.width // self.tile_size)
        ty = -(-self.height // self.tile_size)
        return tx, ty

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


#: RenderConfig's fields that tpurt's lacks, with their defaults.
MODEL_FIELDS = {"model_material": None, "model_scale": 0.5}


def tpurt_knobs(cfg) -> dict:
    """``dataclasses.asdict(cfg)`` without the ``MODEL_FIELDS`` left at
    their defaults: for a config that tpurt's RenderConfig can state,
    the dict of tpurt's equal config (for one of tpurt's, its own)."""
    knobs = dataclasses.asdict(cfg)
    for name, default in MODEL_FIELDS.items():
        if knobs.get(name, default) == default:
            knobs.pop(name, None)
    return knobs
