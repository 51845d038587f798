"""tpurt_torch's public helpers against tpurt's, on the CPU, from seeded
numpy inputs: the AoS vector math and hsv2rgb, the three hemisphere and
masked draws, BVH stats and checks, write_obj, to_rgba, Scene.num_nodes,
SceneBuilder.stats and the subpackages' re-exports; and the ast
comparison of both packages' public names.

Bounds: the vector math equals numpy's unfused float32 arithmetic bit for
bit where it is products and sums, the oracle within tpurt's own test
tolerances, and tpurt's functions (called eagerly, op by op) bit for bit,
except ``rotate`` (tpurt's einsum sums in its own order: within 4 ulp at
the scale of |v|). Directions drawn through log, cos and sin are within
4 ulp at unit scale of tpurt's (their near-zero components have no ulp
of their own), with the RNG states equal.
"""

import ast
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oracle
from tpurt.accel import bvh as t_bvh
from tpurt.config import RenderConfig
from tpurt.core import rng as t_rng
from tpurt.core import vecmath as t_vm
from tpurt.render.tonemap import to_rgba as t_to_rgba
from tpurt.scene import obj as t_obj
from tpurt.scene import procedural as t_proc
from tpurt.scene.presets import cornell_sphere_scene as t_cornell
from tpurt_torch.accel import bvh
from tpurt_torch.core import rng, vecmath as vm
from tpurt_torch.render.tonemap import to_rgba
from tpurt_torch.scene import obj, procedural
from tpurt_torch.scene.presets import cornell_sphere_scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = np.float32
EPS23 = 2.0 ** -23


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(F)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _unit_pairs(n=512, seed=7):
    """Unit directions d and normals n facing against them, and two
    indices of refraction, as tests/test_vecmath.py draws them."""
    d, nrm = _rand((n, 3), seed), _rand((n, 3), seed + 1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where((np.sum(d * nrm, -1) > 0)[:, None], -nrm, nrm).astype(F)
    ior = np.random.RandomState(seed + 2).uniform(1.0, 2.0, (2, n)).astype(F)
    return d.astype(F), nrm, ior[0], ior[1]


def _dot(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


@pytest.mark.parametrize("name", ["cross3", "length3", "lerp3", "reflect",
                                  "rotate"])
def test_vecmath_products_against_numpy_and_tpurt(name):
    """Unfused float32 numpy gives the port's bits; so does tpurt's
    function called eagerly, apart from rotate's summation order."""
    a, b = _rand((4096, 3), 1), _rand((4096, 3), 2)
    t = np.random.RandomState(3).rand(4096).astype(F)
    m = vm.euler_rotation(0.3, -1.2, 2.0)
    if name == "cross3":
        args, targs = (_t(a), _t(b)), (jnp.asarray(a), jnp.asarray(b))
        want = np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], -1)
    elif name == "length3":
        args, targs = (_t(a),), (jnp.asarray(a),)
        want = np.sqrt(_dot(a, a))
    elif name == "lerp3":
        args = (_t(a), _t(b), _t(t))
        targs = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(t))
        want = a * (F(1.0) - t)[:, None] + b * t[:, None]
        # A Python scalar t rounds to float32 first, as in tpurt.
        np.testing.assert_array_equal(
            vm.lerp3(_t(a), _t(b), 0.3).numpy(),
            np.asarray(t_vm.lerp3(jnp.asarray(a), jnp.asarray(b), 0.3)))
    elif name == "reflect":
        d, nrm, _, _ = _unit_pairs(4096)
        args, targs = (_t(d), _t(nrm)), (jnp.asarray(d), jnp.asarray(nrm))
        want = d - (F(2.0) * _dot(d, nrm))[:, None] * nrm
        ref = np.stack([oracle.reflect(d[i], nrm[i]) for i in range(256)])
        np.testing.assert_allclose(want[:256], ref, atol=1e-6)
    else:
        args, targs = (m, _t(a)), (jnp.asarray(m), jnp.asarray(a))
        want = np.stack([m[i, 0] * a[:, 0] + m[i, 1] * a[:, 1]
                         + m[i, 2] * a[:, 2] for i in range(3)], -1)
        back = vm.rotate_t(m, vm.rotate(m, _t(a))).numpy()
        np.testing.assert_allclose(back, a, atol=1e-5)
    got = getattr(vm, name)(*args).numpy()
    theirs = np.asarray(getattr(t_vm, name)(*targs))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if name == "rotate":
        scale = np.linalg.norm(a, axis=-1, keepdims=True) * EPS23
        assert (np.abs(got - theirs) <= 4 * scale).all()
    else:
        np.testing.assert_array_equal(got, theirs)


@pytest.mark.parametrize("name", ["refract", "fresnel_reflectance"])
def test_optics_against_oracle_and_tpurt(name):
    """Within tests/test_vecmath.py's tolerance of the oracle, bit for bit
    tpurt's; total internal reflection gives the zero vector and 1."""
    d, nrm, ia, ib = _unit_pairs()
    got = getattr(vm, name)(_t(d), _t(nrm), _t(ia), _t(ib)).numpy()
    theirs = getattr(t_vm, name)(jnp.asarray(d), jnp.asarray(nrm),
                                 jnp.asarray(ia), jnp.asarray(ib))
    np.testing.assert_array_equal(got, np.asarray(theirs))
    scalar = oracle.refract if name == "refract" else oracle.reflectance
    ref = np.array([scalar(d[i], nrm[i], ia[i], ib[i]) for i in range(len(d))])
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # Scalar indices of refraction, and total internal reflection.
    dt = vm.normalize3(torch.tensor([0.95, -0.3122, 0.0]))
    out = getattr(vm, name)(dt, torch.tensor([0.0, 1.0, 0.0]), 2.5, 1.0)
    assert out.tolist() == ([0.0, 0.0, 0.0] if name == "refract" else 1.0)


def test_hsv2rgb_sectors_equal_tpurt():
    """tests/test_vecmath.py's eight sector cases, plus negative hues
    (h > -60 truncates into sector 0, h <= -60 takes the default arm) and
    hues past 360, equal to tpurt's; the device comes from a tensor h or
    from ``device``."""
    cases = [
        ((0.0, 1.0, 1.0), (1.0, 0.0, 0.0)),
        ((120.0, 1.0, 1.0), (0.0, 1.0, 0.0)),
        ((240.0, 1.0, 1.0), (0.0, 0.0, 1.0)),
        ((60.0, 1.0, 1.0), (1.0, 1.0, 0.0)),
        ((300.0, 1.0, 1.0), (1.0, 0.0, 1.0)),
        ((360.0, 1.0, 1.0), (1.0, 0.0, 0.0)),
        ((123.0, 0.0, 0.7), (0.7, 0.7, 0.7)),
        ((90.0, 0.5, 0.8), (0.6, 0.8, 0.4)),
    ]
    h, s, v = (np.array([c[0][k] for c in cases], F) for k in range(3))
    got = vm.hsv2rgb(h, s, v, device="cpu")
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), [c[1] for c in cases], atol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(t_vm.hsv2rgb(h, s, v)))
    extra = np.array([-30.0, -60.0, -90.0, -400.0, 400.0, 719.9, 59.99], F)
    sv = np.random.RandomState(4).uniform(0.1, 1.0, (2, len(extra))).astype(F)
    got = vm.hsv2rgb(_t(extra), _t(sv[0]), _t(sv[1]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(t_vm.hsv2rgb(extra, sv[0], sv[1])))
    # h = -90 truncates to sector -1: the default arm (v, p, q).
    vv, p = sv[1][2], sv[1][2] * (F(1.0) - sv[0][2])
    assert got[2, 0] == vv and got[2, 1] == p
    np.testing.assert_array_equal(vm.hsv2rgb(30.0, 0.0, 0.25, device="cpu"),
                                  [0.25, 0.25, 0.25])


def _seeds(n=4096, seed=5):
    return np.random.RandomState(seed).randint(
        0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("name", ["random_hemisphere_direction",
                                  "sample_hemisphere_cosine",
                                  "random_direction_masked"])
def test_rng_helpers_against_tpurt(name):
    """States bit for bit, unit directions within 4 ulp at unit scale,
    each in the normal's hemisphere; a masked draw leaves the masked
    lanes' states as they were and advances the others."""
    seeds = _seeds()
    _, nrm, _, _ = _unit_pairs(len(seeds), seed=11)
    nrm[:64] = (0.0, 0.0, 1.0)  # |n.z| >= 0.999: the other up vector
    nrm[64:128] = (0.0, 0.0, -1.0)
    state = _t(seeds.astype(np.int64))
    if name == "random_direction_masked":
        mask = np.arange(len(seeds)) % 3 == 0
        args, targs = (state, _t(mask)), (jnp.asarray(seeds), jnp.asarray(mask))
    else:
        args, targs = (_t(nrm), state), (jnp.asarray(nrm), jnp.asarray(seeds))
    new, d = getattr(rng, name)(*args)
    tnew, td = getattr(t_rng, name)(*targs)
    np.testing.assert_array_equal(new.numpy().astype(np.uint32), np.asarray(tnew))
    assert np.abs(d.numpy() - np.asarray(td)).max() <= 4 * EPS23
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=-1), 1.0,
                               atol=1e-6)
    if name == "random_direction_masked":
        new = new.numpy().astype(np.uint32)
        np.testing.assert_array_equal(new[~mask], seeds[~mask])
        full, dfull = rng.random_direction(state)
        np.testing.assert_array_equal(new[mask], full.numpy()[mask])
        np.testing.assert_array_equal(d.numpy(), dfull.numpy())
    else:
        assert (np.sum(d.numpy() * nrm, -1) >= -1e-6).all()


def _mesh(which):
    if which == "icosphere":
        return procedural.icosphere(3), t_proc.icosphere(3)
    return (procedural.torus_knot(segments=64, sides=8),
            t_proc.torus_knot(segments=64, sides=8))


def _built(module, pos, nrm):
    nodes = module.BVHNodes.empty()
    tri_pos, tri_nrm = pos.copy(), nrm.copy()
    root = module.build_bvh(nodes, tri_pos, tri_nrm, 0, len(pos), 64)
    return nodes, tri_pos, root


@pytest.mark.parametrize("which", ["icosphere", "torus_knot"])
def test_bvh_stats_and_validate(which):
    """Equal stats dicts; each package's validate_bvh passes on both
    packages' trees and raises AssertionError on a copy with a child box
    moved outside its parent."""
    (pos, nrm), (tpos, tnrm) = _mesh(which)
    np.testing.assert_array_equal(pos, tpos)
    mine, tri_pos, root = _built(bvh, pos, nrm)
    theirs, ttri_pos, troot = _built(t_bvh, tpos, tnrm)
    stats = bvh.bvh_stats(mine, root)
    assert stats == t_bvh.bvh_stats(theirs, troot)
    assert stats["leaf_count"] > 100 and stats["max_leaf_tris"] <= 2
    assert sorted(bvh._subtree(mine, root)) == list(range(len(mine)))
    for check in (bvh.validate_bvh, t_bvh.validate_bvh):
        check(mine, root, 0, len(pos), tri_pos)
        check(theirs, troot, 0, len(tpos), ttri_pos)
    broken = bvh.BVHNodes(*(list(getattr(mine, f)) for f in
                            ("bmin", "bmax", "child", "first", "ntris")))
    kid = broken.child[root]
    broken.bmax[kid] = broken.bmax[root] + F(1.0)
    for check in (bvh.validate_bvh, t_bvh.validate_bvh):
        with pytest.raises(AssertionError, match="child escapes"):
            check(broken, root, 0, len(pos), tri_pos)
    bvh.validate_bvh(mine, root, 0, len(pos), tri_pos)  # the original holds


def test_write_obj_bytes_and_round_trip(tmp_path):
    """The same bytes as tpurt's from numpy and from tensors; both
    packages' load_obj read the triangles back exactly."""
    pos, nrm = procedural.icosphere(1, radius=1.7)
    pos = pos + _rand((1, 3, 3), 9) * F(1e-3)
    want = tmp_path / "tpurt.obj"
    t_obj.write_obj(str(want), pos, nrm)
    for k, (a, b) in enumerate([(pos, nrm), (_t(pos), _t(nrm))]):
        path = tmp_path / f"port{k}.obj"
        obj.write_obj(str(path), a, b)
        assert path.read_bytes() == want.read_bytes()
    for load in (obj.load_obj, t_obj.load_obj):
        rpos, rnrm = load(str(tmp_path / "port1.obj"))
        np.testing.assert_array_equal(rpos, pos)
        np.testing.assert_array_equal(rnrm, nrm)


def test_to_rgba_equals_tpurt():
    rgb = np.random.RandomState(6).randint(0, 256, (5, 7, 3)).astype(np.uint8)
    got = to_rgba(_t(rgb))
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(t_to_rgba(jnp.asarray(rgb))))


def test_num_nodes_and_builder_stats():
    """Scene.num_nodes and SceneBuilder.stats of every mesh on the Cornell
    sphere scene equal tpurt's."""
    cfg = RenderConfig(object_path="sphere1.obj")
    scene, _, builder = cornell_sphere_scene(1, cfg, device="cpu")
    tscene, _, tbuilder = t_cornell(1, cfg)
    assert scene.num_nodes == tscene.num_nodes == len(builder.nodes)
    assert len(builder.meshes) == len(tbuilder.meshes) == scene.num_meshes
    for m, tm in zip(builder.meshes, tbuilder.meshes):
        assert builder.stats(m) == tbuilder.stats(tm)


@pytest.mark.parametrize("package", ["accel", "core", "render"])
def test_package_reexports(package):
    """Each subpackage exports tpurt's names, each the port's own module,
    class or function of that name and of the same kind as tpurt's."""
    import importlib
    import inspect

    theirs = importlib.import_module(f"tpurt.{package}")
    mine = importlib.import_module(f"tpurt_torch.{package}")
    names = _public_names(os.path.join(ROOT, "tpurt", package, "__init__.py"))
    assert names == _public_names(
        os.path.join(ROOT, "tpurt_torch", package, "__init__.py"))
    for name in names:
        ours, ref = getattr(mine, name), getattr(theirs, name)
        kinds = (inspect.ismodule, inspect.isclass, inspect.isfunction)
        assert [k(ours) for k in kinds] == [k(ref) for k in kinds], name
        home = ours.__name__ if inspect.ismodule(ours) else ours.__module__
        assert home.startswith(f"tpurt_torch.{package}."), (name, home)
        assert getattr(importlib.import_module(home), name.split(".")[-1],
                       ours) is ours


def _public_names(path):
    """Top-level public names of a module (functions, classes and their
    methods as ``Class.method``, assignments; imports in an __init__)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{b.name}" for b in node.body
                           if isinstance(b, ast.FunctionDef))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
        elif (isinstance(node, (ast.Import, ast.ImportFrom))
              and os.path.basename(path) == "__init__.py"):
            out.update(a.asname or a.name.split(".")[-1] for a in node.names)
    return {n for n in out
            if not any(p.startswith("_") and not p.startswith("__")
                       for p in n.split("."))}


#: tpurt's public names the port leaves out on purpose (ROADMAP north
#: star and A.10): the TPU knobs, the Mosaic workarounds, the Pallas
#: entry points, the fused dense table's TPU layout, the native OBJ
#: parser, the builder constants the port reads from its config, and the
#: phase timer and its sync point, which the port's spans and counters
#: replace (a span never synchronises).
EXCLUDED = {
    "_native.py": {"available", "get_lib", "parse_obj"},
    "config.py": {"DENSE_NUMERATOR_ACCEPT", "MEGA_BLOCK_LANES",
                  "MEGA_FAKE_GATHER", "MEGA_INTERLEAVE_FLOOR",
                  "MEGA_MAT_PRUNE", "MEGA_UNROLL", "MEGA_VMEM_LIMIT_MB"},
    "core/rng.py": {"u32_to_f32_exact"},
    "render/mega_pallas.py": {"BLOCK_LANES", "make_pallas_body"},
    "render/pallas_kernels.py": {"mt_sweep_pallas", "pad_tri_rows"},
    "render/plucker_fused.py": {"FusedDenseTable", "K_PAD"},
    "render/shading.py": {"mat_types_present"},
    "scene/builder.py": {"MEGA_ARITY", "MEGA_LEAF_TRIS", "MEGA_ROW_WIDTH"},
    "utils/profiling.py": {"materialize", "PhaseTimer", "PhaseTimer.__init__",
                           "PhaseTimer.__str__", "PhaseTimer.phase",
                           "PhaseTimer.report"},
}


def test_public_surface_matches_tpurt():
    """Every public top-level name and class method of each tpurt module
    is in the port's module of the same path, but for EXCLUDED."""
    gaps = {}
    base = os.path.join(ROOT, "tpurt")
    for d, _, files in os.walk(base):
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, f), base).replace(os.sep, "/")
            port = os.path.join(ROOT, "tpurt_torch", rel)
            have = _public_names(port) if os.path.exists(port) else set()
            gap = _public_names(os.path.join(d, f)) - have
            if gap:
                gaps[rel] = gap
    assert gaps == EXCLUDED
