#!/usr/bin/env python3
"""Time variants of the megakernel, the dense sweep and the exact sweep
against the shipped kernels on one CUDA card.

    python3 kernel_variants.py                # every kernel, one card
    python3 kernel_variants.py mt_sweep       # only csrc/mt_sweep.cu's
    python3 kernel_variants.py megakernel --only=b1-stack-local --rounds=3
                                              # named variants, 3 rounds

A variant is a copy of csrc/megakernel.cu, csrc/dense_sweep.cu or
csrc/mt_sweep.cu with one of its launch constants changed (threads a
block, the least resident blocks per SM that ``__launch_bounds__`` asks
for, a sweep's unroll factor; B3's rays a thread, rows a stage and most
threads a ray set), with the persistent grid replaced by one thread per
lane ("grid": as many blocks as the lanes need, so that each thread
runs one lane and no thread takes a second), with one element of B1's
design taken back: its lanes' cold words in the state buffer or in
registers instead of shared memory ("b1-cold-buffer", "b1-cold-regs";
the dense instantiation's in the state buffer instead of registers,
"dense-cold-buffer"), its shading and static stage compiled as calls
("b1-rare-noinline"), its bank rows read with 32-bit loads instead of
128-bit ones ("b1-scalar-rows"), its stack ring in a local-memory
array instead of shared memory ("b1-stack-local"), or with another
least count of walking lanes at which a warp keeps stepping them before
its segment completions ("b1-walkers-<k>", kMinWalkers; 33: a lane's
tail after each of its steps, as before the inner loop). Each is built
with the
package's own nvcc flags beside the shipped library and swapped in for
it while it runs, so the wrappers (``mega_cuda.launch``,
``sweep_entry_local``, ``mt_sweep.sweep``) run it unchanged. Workloads,
at full size:

- bunny-1080p-plain's batch (262,144 lanes) through megakernel<false>:
  its first 16 trips, and to completion;
- glass-final-1080p's batch (glass-cornell at 1080p, 50 spp, 50
  bounces; 262,144 lanes) through megakernel<false>: its first 64
  trips, and to completion;
- teapot-720p-bruteforce's batch (230,400 lanes) to completion through
  megakernel<true>;
- B2 alone on the teapot's 230,400 primary rays x 6,144 columns
  (chip_smoke.py's phase 6 inputs);
- B3 on the parity frame's 307,200 camera rays x the sphere's 1,280
  rows, and on one tile's 65,536 (chip_smoke.py's phase 9 inputs).

The shipped build and its variants run in turns (in order, then in
reverse, ``--rounds`` times), each timed on the card
(``chip_smoke.device_ms``), every time logged and the best kept; every
variant's results (lane words, trips,
work counts, columns and t) must equal the shipped build's word for
word, but for the megakernel's completion groups (the work count's last
row), which follow the schedule: each megakernel build's segments a
group are logged instead. ptxas's register and spill report, each megakernel build's static
memory instructions (``chip_smoke.sass_memory``: LDL, STL, LDG, LDS,
STS) and each megakernel variant's launch are printed, with every time
beside the card's name and power limit. The last line is a JSON
summary.
"""

from __future__ import annotations

import contextlib
import ctypes
import inspect
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as cs

_MK = "megakernel"
_SW = "dense_sweep"
_MT = "mt_sweep"
_GRID = ("const int blocks = per_sm * sms < needed ? per_sm * sms : needed;",
         "const int blocks = needed;")


def _const(name: str, old: int, new: int):
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};")


def _set(name: str, new) -> tuple:
    """A patch setting ``constexpr <type> name`` to ``new`` whatever its
    shipped value."""
    return (re.compile(rf"constexpr (int|bool|ColdAt) {name} = [^;]+;"),
            lambda m: f"constexpr {m.group(1)} {name} = {new};")


#: label -> (source, [(text or compiled pattern, replacement), ...]).
#: B1's variants set its constants whatever their shipped values
#: (``_set``), so "b1-min4" ... "b1-min10" (4 to 10 least resident
#: blocks: 128 down to 48 registers) apply to the source before B1's
#: redesign (kMinBlocks 9, a 64-entry stack array in local memory) and
#: after it; "b1-stack22", the stack array cut to the bunny bank's 22
#: words (the stack's footprint alone), only before. A variant whose
#: text is not in the source is skipped with a line saying so: copy this
#: file into an unpacked older tree to time that tree's variants. The
#: shipped constants of the other sources: kUnroll 4 (dense_sweep.cu) and
#: kThreads 128, kRays 4, kChunk 256, kMaxGroup 4, kUnroll 2, kMinBlocks
#: 7, kWaves 4 (mt_sweep.cu); "b3-dettest-first" puts B3's det test back
#: beside the pre-test, before the branch.
VARIANTS = {
    "grid": (_MK, [_GRID]),
    "b1-stack22": (_MK, [("constexpr int kMaxStack = 64;",
                          "constexpr int kMaxStack = 22;")]),
    "b1-min4": (_MK, [_set("kMinBlocks", 4)]),
    "b1-min5": (_MK, [_set("kMinBlocks", 5)]),
    "b1-min6": (_MK, [_set("kMinBlocks", 6)]),
    "b1-min7": (_MK, [_set("kMinBlocks", 7)]),
    "b1-min8": (_MK, [_set("kMinBlocks", 8)]),
    "b1-min10": (_MK, [_set("kMinBlocks", 10)]),
    "b1-t64": (_MK, [_set("kThreads", 64), _set("kMinBlocks", 18)]),
    "b1-t256": (_MK, [_set("kThreads", 256), _set("kMinBlocks", 4)]),
    "b1-cold-buffer": (_MK, [_set("kColdAt", "kColdInBuffer")]),
    "b1-cold-regs": (_MK, [_set("kColdAt", "kColdInRegisters")]),
    "dense-cold-buffer": (_MK, [_set("kDenseColdAt", "kColdInBuffer")]),
    "b1-rare-noinline": (_MK, [(
        "#define TPURT_MK_RARE __device__ __forceinline__",
        "#define TPURT_MK_RARE __device__ __noinline__")]),
    "b1-scalar-rows": (_MK, [(
        "{ return __ldg(p); }",
        "{\n  const float* f = reinterpret_cast<const float*>(p);\n"
        "  return make_float4(__ldg(f), __ldg(f + 1), __ldg(f + 2), __ldg(f + 3));\n}")]),
    **{f"b1-walkers-{k}": (_MK, [_set("kMinWalkers", k)]) for k in (1, 2, 4, 6, 8, 10, 12, 16, 33)},
    "b1-stack-local": (_MK, [
        ("uint32_t* ring = dyn + tid;",
         "uint32_t local_ring[kMaxSharedStack];\n  uint32_t* ring = local_ring;"),
        ("Lane<kDeep, T> L;", "Lane<kDeep, 1> L;"),
        ("return (deep ? 0 : s_depth) +", "return 0 * s_depth * deep +"),
        ("uint32_t* cold_rows = dyn + (kDeep ? 0 : c.s_depth) * T + tid;",
         "uint32_t* cold_rows = dyn + tid;")]),
    "dense-t128": (_MK, [_set("kDenseThreads", 128), _set("kDenseMinBlocks", 8)]),
    "dense-min3": (_MK, [_set("kDenseMinBlocks", 3)]),
    "dense-min5": (_MK, [_set("kDenseMinBlocks", 5)]),
    "mk-unroll2": (_MK, [_set("kDenseSweepUnroll", 2)]),
    "mk-unroll4": (_MK, [_set("kDenseSweepUnroll", 4)]),
    "sweep-unroll1": (_SW, [_const("kUnroll", 4, 1)]),
    "sweep-unroll2": (_SW, [_const("kUnroll", 4, 2)]),
    "sweep-unroll8": (_SW, [_const("kUnroll", 4, 8)]),
    "b3-t64": (_MT, [_const("kThreads", 128, 64)]),
    "b3-t256": (_MT, [_const("kThreads", 128, 256), _const("kMinBlocks", 7, 3)]),
    "b3-r2": (_MT, [_const("kRays", 4, 2)]),
    "b3-r3": (_MT, [_const("kRays", 4, 3)]),
    "b3-r8": (_MT, [_const("kRays", 4, 8), _const("kMinBlocks", 7, 1)]),
    "b3-chunk128": (_MT, [_const("kChunk", 256, 128)]),
    "b3-chunk512": (_MT, [_const("kChunk", 256, 512), _const("kMinBlocks", 7, 4)]),
    "b3-unroll1": (_MT, [_const("kUnroll", 2, 1)]),
    "b3-min1": (_MT, [_const("kMinBlocks", 7, 1)]),
    "b3-min8": (_MT, [_const("kMinBlocks", 7, 8)]),
    "b3-waves1": (_MT, [_const("kWaves", 4, 1)]),
    "b3-waves2": (_MT, [_const("kWaves", 4, 2)]),
    "b3-g2": (_MT, [_const("kMaxGroup", 4, 2)]),
    "b3-g8": (_MT, [_const("kMaxGroup", 4, 8)]),
    "b3-dettest-first": (_MT, [(
        "keep[r] = u_pretest_keeps(det, dot(sub(o[r], pa), h));",
        "keep[r] = (fabsf(det) >= kEps) & u_pretest_keeps(det, dot(sub(o[r], pa), h));")]),
}


def patched(label: str):
    """The variant's patched copy of its source, or None where a patch's
    text is not once in the source (a variant of another version)."""
    from tpurt_torch import _build

    name, patches = VARIANTS[label]
    with open(os.path.join(_build.CSRC, name + ".cu")) as f:
        src = f.read()
    for old, new in patches:
        if isinstance(old, str):
            if src.count(old) != 1:
                return None
            src = src.replace(old, new)
        else:
            if len(old.findall(src)) != 1:
                return None
            src = old.sub(new, src)
    return src


def build_variant(label: str) -> tuple:
    """Compile the variant's patched copy of its source; returns (library
    path, ptxas's register and spill lines)."""
    from tpurt_torch import _build

    name, _patches = VARIANTS[label]
    src = patched(label)
    out_dir = os.path.join(_build.BUILD_DIR, "variants", label)
    os.makedirs(out_dir, exist_ok=True)
    cu, lib = os.path.join(out_dir, name + ".cu"), os.path.join(out_dir, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {label}:\n{proc.stdout}{proc.stderr}")
    return lib, _ptxas(proc.stdout + proc.stderr)


def _ptxas(text: str) -> list:
    return [line.split(":", 1)[-1].strip() for line in text.splitlines()
            if "registers" in line or "spill" in line]


@contextlib.contextmanager
def swapped(name: str, lib):
    """The wrappers load ``lib`` in place of csrc/<name> inside the block
    (``lib`` None: the shipped library)."""
    from tpurt_torch import _build

    shipped = _build.load(name)
    _build._LIBS[name] = shipped if lib is None else lib
    try:
        yield
    finally:
        _build._LIBS[name] = shipped


def b3_workloads():
    """B3's workloads: the sphere's rows against the parity frame's
    camera rays, all of them and the first tile's as the engine launches
    them (chip_smoke.py phase 9), culling backfaces in both."""
    from tpurt_torch.render import mt_sweep
    from tpurt_torch.scene.presets import bench_scene

    cfg = cs.parity_cfg()
    scene, cam = bench_scene("sphere", cfg, device="cuda")
    lo, ld, first, count = cs.b3_alone_rays(scene, cam, cfg)
    tile = next(ln for ln in cs.record_b3_launches(scene, cam, cfg)
                if ln["ids"] is None and ln["first"] == first)
    out = []
    for name, ln in (("B3-alone", dict(ro=lo, rd=ld)), ("B3-tile", tile)):
        ln = dict(ln, first=first, count=count, ids=None, cull_flags=None, cull=True)

        def info(n=ln["ro"].shape[0]):
            c = mt_sweep.launch_config(n)
            return (f"{n} rays: {c['threads']} threads x {c['rays_per_thread']} rays, "
                    f"G {c['groups']}, {c['blocks']} blocks, {c['resident_threads']} "
                    f"resident threads")

        out.append((name, _MT, cs.b3_engine_call(scene, ln), info))
    return out


def workloads(sources):
    """[(name, source, run() -> result tensors, info() -> str)] of the
    kernels in ``sources``."""
    from tpurt_torch.render import mega_cuda
    from tpurt_torch.render import plucker_fused as pf
    from tpurt_torch.render.renderer import flat_batch_args
    from tpurt_torch.scene.presets import bench_scene

    out = []
    if _MK in sources:
        bunny = cs.bunny_cfg(1920, 1080)
        teapot = cs.teapot_cfg(1280, 720)
        bunny_sc = cs.bunny_scene(bunny)
        teapot_sc = bench_scene("teapot", teapot, device="cuda")
        glass = cs.glass_cfg(1920, 1080)
        glass_sc = cs.glass_scene(glass)
        for name, (scene, cam), cfg, trips in (
                ("bunny-1080p 16 trips", bunny_sc, bunny, 16),
                ("bunny-1080p", bunny_sc, bunny, None),
                ("glass-final-1080p 64 trips", glass_sc, glass, 64),
                ("glass-final-1080p", glass_sc, glass, None),
                ("teapot-720p-dense", teapot_sc, teapot, None)):
            lane, ctx = cs.plain_start(scene, flat_batch_args(scene, cam, cfg, 0))
            buf0 = mega_cuda.pack(lane)

            def run(buf0=buf0, ctx=ctx, trips=trips):
                buf = buf0.clone()
                return (buf, *mega_cuda.launch(buf, ctx, trips))

            def info(dense=ctx.tables.dense is not None, r=buf0.shape[1],
                     depth=ctx.s_depth):
                # An older tree's launch_config takes no stack budget.
                kw = ({"s_depth": depth} if "s_depth" in inspect.signature(
                    mega_cuda.launch_config).parameters else {})
                c = mega_cuda.launch_config(dense, **kw)
                blocks = min(c["blocks_per_sm"] * c["sms"], -(-r // c["threads"]))
                return (f"{c['threads']} threads x {c['blocks_per_sm']} blocks per SM, "
                        f"{blocks} blocks, {c.get('smem_bytes', 0)} bytes of dynamic "
                        "shared memory a block")

            out.append((name, _MK, run, info))
    if _SW in sources:
        _scene, lo, ld, entry, table = cs.teapot_sweep_inputs()
        out.append(("B2-alone", _SW, lambda: pf.sweep_entry_local(lo, ld, entry, table),
                    lambda: "128 threads"))
    if _MT in sources:
        out += b3_workloads()
    return out


def main():
    import torch

    from tpurt_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: torch.cuda.is_available() is false")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    opts = dict(a[2:].split("=", 1) for a in sys.argv[1:] if a.startswith("--"))
    sources = tuple(args) or (_MK, _SW, _MT)
    only = opts["only"].split(",") if "only" in opts else None
    rounds = int(opts.get("rounds", 1))
    variants = []
    for v, (src, _p) in VARIANTS.items():
        if src not in sources or (only is not None and v not in only):
            continue
        if patched(v) is None:
            cs.log(f"variant {v}: written for another version of {src}.cu; skipped")
        else:
            variants.append(v)
    cs.CARD = cs.smi()
    t0 = time.time()
    with ThreadPoolExecutor(len(variants) + len(sources)) as pool:
        list(pool.map(_build.build, sources))
        built = dict(zip(variants, pool.map(build_variant, variants)))
    cs.log(f"built {len(built)} variants and the shipped {', '.join(sources)} in "
           f"{time.time() - t0:.1f} s")
    for name in sources:
        for line in _ptxas(_build.build_log(name)):
            cs.log(f"  ptxas shipped {name}: {line}")
    for label, (_path, lines) in built.items():
        for line in lines:
            cs.log(f"  ptxas {label}: {line}")
    if _MK in sources:
        cs.log_sass_memory("shipped", _build.lib_path(_MK))
        for label, (path, _lines) in built.items():
            if VARIANTS[label][0] == _MK:
                cs.log_sass_memory(label, path)
    libs = {label: ctypes.CDLL(path) for label, (path, _l) in built.items()}
    libs["shipped"] = None
    summary = {}
    for cell, source, run, info in workloads(sources):
        labels = ["shipped"] + [v for v in built if VARIANTS[v][0] == source]
        for label in labels:  # warm-up, and each variant's launch
            with swapped(source, libs[label]):
                run()
                cs.log(f"{cell} {label}: {info()}")
        with swapped(source, None):
            ref = run()
        times = {label: [] for label in labels}
        groups = {}
        for label in (labels + labels[::-1]) * rounds:
            with swapped(source, libs[label]):
                res, ms = cs.device_ms(run, reps=1)
            times[label].extend(ms)
            if source == _MK:  # the completion groups follow the schedule
                groups[label] = cs.lanes_per_group(res[2])
                res, ref_cmp = (*res[:2], res[2][:-1]), (*ref[:2], ref[2][:-1])
            else:
                ref_cmp = ref
            if not all(torch.equal(a, b) for a, b in zip(res, ref_cmp)):
                raise AssertionError(f"{cell}: variant {label} changed the result")
        if source == _MK:
            trips, work = ref[1].long(), ref[2].long()
            cs.log(f"{cell}: {int(trips.sum()) / max(int(work[2].sum()), 1):.3f} lane "
                   f"trips a segment, {int(work[0].sum()) / max(int(work[2].sum()), 1):.3f} "
                   "box tests a segment")
        for label in labels:
            extra = (f", {groups[label]} lanes a completion group"
                     if label in groups else "")
            cs.log(f"{cell} {label}: ms {[round(t, 3) for t in times[label]]} "
                   f"(best {min(times[label]):.3f}){extra} | {cs.CARD}")
            summary.setdefault(cell, {})[label] = min(times[label])
    cs.log(f"kernel_variants wall {time.time() - t0:.1f} s")
    print(json.dumps({"card": cs.CARD, "best_ms": summary}))


if __name__ == "__main__":
    sys.exit(main())
