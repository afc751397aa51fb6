"""The window kernel's launch geometry, shared-memory layout and
argument block (``ops/window_cuda.py``), on the CPU: for every grid the
kernel takes a block of G envs fits the card's shared memory and thread
limits, G keeps the most envs resident on an SM, the layout's arrays do
not overlap, and beyond the limits the geometry raises; the ctypes
argument block matches ``struct WindowArgs`` and ``struct Layout`` in
``csrc/window.cu`` field for field."""

import ctypes
import pathlib
import re

import numpy as np
import pytest
import torch

from traffic_env_tpu_torch import constants as C
from traffic_env_tpu_torch.config import Config, derive_spawn_rate
from traffic_env_tpu_torch.envs import fast_core
from traffic_env_tpu_torch.ops import window_cuda as wc
from traffic_env_tpu_torch.ops.window import make_window_spec, sim_to_dict
from traffic_env_tpu_torch.topology import GridRoad

SOURCE = pathlib.Path(wc.__file__).resolve().parent.parent / "csrc" / \
    "window.cu"


def table(k):
    """k archetypes (delta 4), lengths 4..4+k-1 m."""
    t = np.repeat(np.asarray(C.ARCHETYPES, np.float32), k, axis=0)
    t[:, C.L] = 4.0 + np.arange(k)
    return t


def specs(m, n, k, telemetry):
    """The spec of each spawn mode and shaping on an m x n grid."""
    topo = GridRoad(m, n, 250.0)
    arch = table(k) if k > 1 else None
    for over, device, Ks in ((dict(), True, 4), (dict(poisson=False), True, 4),
                             (dict(decel_penalty=True, remi=False), False, 8)):
        cfg = Config(grid_m=m, grid_n=n,
                     mode="validate" if telemetry else "train", **over)
        cfg = derive_spawn_rate(cfg.derive(), topo.open_sides(0))
        yield make_window_spec(topo, cfg, device, Ks, archetypes=arch)


def candidates(spec):
    """Every block geometry with at most ENVS_PER_BLOCK envs that fits."""
    for G in range(1, wc.ENVS_PER_BLOCK + 1):
        try:
            yield wc.block_geometry(G, spec.R, spec.Rt, spec.I,
                                    len(spec.entry), spec.Kc, spec.Ks,
                                    spec.k, spec.decel_penalty,
                                    wc.spawn_mode(spec))
        except ValueError:
            return


def resident(geom):
    return geom.envs_per_block * (
        wc.SMEM_PER_SM // (geom.smem_bytes + wc.SMEM_RESERVED))


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("k", [1, 2, 8])
def test_every_grid_fits_a_block(k, telemetry):
    """1x1 to 8x8, every spawn mode, with and without decel: G >= 1,
    shared memory and threads within the card's limits, threads in
    whole warps, and no other G keeps more envs resident."""
    for m in range(1, 9):
        for n in range(1, 9):
            for spec in specs(m, n, k, telemetry):
                geom = wc.spec_geometry(spec)
                assert geom.envs_per_block >= 1
                assert geom.smem_bytes <= wc.SMEM_PER_BLOCK == 232_448
                assert 32 <= geom.threads <= 1024
                assert geom.threads % 32 == 0
                assert geom.threads >= min(
                    1024, geom.envs_per_block * spec.R)
                assert all(resident(c) <= resident(geom)
                           for c in candidates(spec)), (m, n, spec.variant)


def test_smem_grows_with_the_block():
    """Shared memory per block is the sum of the layout: it grows with G
    and with each optional plane (archetypes, decel counts)."""
    topo = GridRoad(3, 3, 250.0)
    base = dict(R=topo.roads, Rt=topo.train_roads, I=topo.intersections,
                E=len(topo.entrypoints), Kc=4, ndraw=17)
    words = [wc.layout(G, multi=False, decel=False, **base).words
             for G in range(1, 9)]
    assert words == sorted(set(words))
    assert wc.layout(8, multi=True, decel=False, **base).words > words[-1]
    assert wc.layout(8, multi=False, decel=True, **base).words > words[-1]
    # the car rings dominate: 3 planes x 19 slots x 48 roads per env
    assert 4 * words[-1] > 8 * 3 * 19 * 48 * 4


@pytest.mark.parametrize("m,n,k", [(9, 8, 1), (8, 9, 1), (3, 3, 9)])
def test_beyond_the_kernel_raises(m, n, k):
    """More than 64 intersections or 8 archetypes: the geometry raises
    (the launch never falls back to the plain version)."""
    topo = GridRoad(m, n, 250.0)
    cfg = derive_spawn_rate(Config(grid_m=m, grid_n=n).derive(),
                            topo.open_sides(0))
    spec = make_window_spec(topo, cfg, True, 4,
                            archetypes=table(k) if k > 1 else None)
    with pytest.raises(ValueError):
        wc.spec_geometry(spec)


def test_a_block_too_large_raises():
    topo = GridRoad(8, 8, 250.0)
    with pytest.raises(ValueError, match="shared memory"):
        wc.block_geometry(8, topo.roads, topo.train_roads,
                          topo.intersections, 32, 4, 4, 2, False,
                          wc.SPAWN_POISSON)


@pytest.mark.parametrize("m,n", [(1, 1), (2, 4), (3, 3), (8, 8)])
def test_in_roads_are_each_intersections_train_roads(m, n):
    """Four train roads into each intersection, ascending (the order of
    the decel terms), exactly the roads whose dest is that
    intersection."""
    topo = GridRoad(m, n, 250.0)
    spec = make_window_spec(topo, Config(grid_m=m, grid_n=n).derive())
    table_ = wc.in_roads(spec)
    assert table_.shape == (topo.intersections, wc.MAX_IN)
    for i in range(topo.intersections):
        roads = table_[i][table_[i] >= 0]
        assert list(roads) == sorted(roads)
        assert list(roads) == list(np.flatnonzero(
            topo.dest[:topo.train_roads] == i))


def _c_fields(struct="WindowArgs"):
    """(name, kind) of a struct in csrc/window.cu, in order."""
    body = re.search(rf"struct {struct} \{{(.*?)\n\}};", SOURCE.read_text(),
                     re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.match(r"\s*(?:const )?(unsigned char|unsigned long long|"
                     r"long long|int|float|Layout)"
                     r"(\*)? (.*)", decl, re.S)
        if m:
            kind = "ptr" if m.group(2) else m.group(1)
            fields += [(name.strip(), kind) for name in m.group(3).split(",")]
    return fields


def test_args_match_the_kernel_struct():
    """The ctypes block and struct WindowArgs name the same fields in
    the same order with the same types."""
    kinds = {wc._P: "ptr", wc._I: "int", wc._F: "float",
             ctypes.c_longlong: "long long", wc._Layout: "Layout"}
    assert [(n, kinds[t]) for n, t in wc._Args._fields_] == _c_fields()
    assert len(_c_fields()) == 34 + 1 + 26 + 15 + 1
    assert [(n, kinds[t]) for n, t in wc._Layout._fields_] == \
        _c_fields("Layout")
    assert len(_c_fields("Layout")) == 38


# arrays of the layout that share words: the spawn scratch and the
# hand-off's staging area are live in disjoint phases of a tick
SPAWN = {"floor_e", "free_e", "placed", "bits"}
STAGE = {"stage_x", "stage_v", "stage_w", "stage_a"}


def _extents(L, G, R, Rt, I, E, Kc, multi, decel):
    """[start, end) words of each array of the layout ``L``."""
    cars, stage = 19 * L.SS, Kc * Rt * G
    sizes = dict(x=cars, v=cars, w=cars, ai=cars if multi else 0,
                 bits=L.ndraw * G, dcnt=Rt * G if decel else 0,
                 stage_x=stage, stage_v=stage, stage_w=stage,
                 stage_a=stage if multi else 0)
    for n in ("ld", "lc", "cnt"):
        sizes[n] = R * G
    for n in ("phase", "elapsed", "pdst", "act", "rsum", "lrew", "spen"):
        sizes[n] = I * G
    for n in ("waiting", "detected", "accp", "lastp", "nover"):
        sizes[n] = Rt * G
    for n in ("floor_e", "free_e", "placed"):
        sizes[n] = E * G
    for n in ("done", "steps", "gtick", "gap", "backlog", "seed", "ovf"):
        sizes[n] = G
    return {n: (getattr(L, n), getattr(L, n) + w) for n, w in sizes.items()}


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("decel", [False, True])
@pytest.mark.parametrize("G,grid,ndraw", [(1, (1, 1), 0), (8, (3, 3), 17),
                                          (3, (5, 5), 25), (1, (8, 8), 0)])
def test_layout_arrays_are_disjoint(G, grid, ndraw, multi, decel):
    """Every shared array lies inside the block's words, no two overlap
    (but the spawn scratch and the staging area, which share theirs),
    each car plane's slot rows are padded to whole banks, and the words
    are as many as the arrays need."""
    topo = GridRoad(*grid, 250.0)
    dims = dict(G=G, R=topo.roads, Rt=topo.train_roads,
                I=topo.intersections, E=len(topo.entrypoints), Kc=4)
    L = wc.layout(ndraw=ndraw, multi=multi, decel=decel, **dims)
    assert L.SS % 32 == 0 and topo.roads * G <= L.SS < topo.roads * G + 32
    ext = _extents(L, multi=multi, decel=decel, **dims)
    assert all(0 <= lo <= hi <= L.words for lo, hi in ext.values())
    for a, (alo, ahi) in ext.items():
        for b, (blo, bhi) in ext.items():
            shared = {a, b} <= SPAWN | STAGE and not {a, b} <= SPAWN \
                and not {a, b} <= STAGE
            if a < b and not shared:
                assert ahi <= blo or bhi <= alo, (a, b)
    assert L.words == max(hi for _, hi in ext.values())


def test_args_carry_the_geometry():
    """_args packs the spec, the batch and the geometry the launch uses;
    a CPU state is refused before anything is launched."""
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(Config().derive(), topo.open_sides(0))
    spec = make_window_spec(topo, cfg, True, 4)
    geom = wc.spec_geometry(spec)
    a = wc._args(spec, geom, 1000, {"x": 16})
    assert (a.B, a.R, a.Rt, a.I, a.E) == (1000, 48, 36, 9, 12)
    assert (a.G, 4 * a.L.words) == (geom.envs_per_block, geom.smem_bytes)
    assert a.L.ndraw == wc.n_draws(spec.Ks, False, wc.SPAWN_POISSON)
    assert a.x == 16 and a.v is None and a.spawn_mode == wc.SPAWN_POISSON
    gen = torch.Generator()
    gen.manual_seed(0)
    sim = fast_core.init_state_compact(topo, 4, gen, "cpu")
    with pytest.raises(ValueError, match="CUDA state"):
        wc.window(spec, sim_to_dict(sim),
                  torch.zeros((9, 4), dtype=torch.int32), None, sim.seed,
                  True)


@pytest.mark.parametrize("change", ["threads", "smem"])
def test_args_refuse_a_geometry_the_kernel_does_not_take(change):
    """A hand-built geometry with fewer threads than envs a block (the
    per-env phases would skip the envs past the last thread) or shared
    memory other than the layout's is refused before any launch."""
    import dataclasses
    topo = GridRoad(3, 3, 250.0)
    cfg = derive_spawn_rate(Config().derive(), topo.open_sides(0))
    spec = make_window_spec(topo, cfg, True, 4)
    geom = wc.spec_geometry(spec)
    bad = dataclasses.replace(geom, **(
        dict(threads=geom.envs_per_block - 1) if change == "threads"
        else dict(smem_bytes=geom.smem_bytes - 4)))
    wc._args(spec, geom, 64, {})
    with pytest.raises(ValueError, match="does not take"):
        wc._args(spec, bad, 64, {})
