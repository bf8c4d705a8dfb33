"""Synthetic metro generator.

Counterpart: reporter_tpu/netgen/synthetic.py (the grid cities, the
names "organic" and "organic-xl" of netgen/organic.py's irregular metros,
and the two variants: ``assign_mode_access`` and
``add_random_restrictions``).
The same name and seed give the same RoadNetwork bit for bit: the random
draws are made in the same order from the same numpy generator.
"""

from __future__ import annotations

import numpy as np

from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.netgen.network import (ACCESS_BICYCLE, ACCESS_FOOT,
                                               RoadNetwork, TurnRestriction,
                                               Way)

# name → (seed, nx, ny)
CITY_PRESETS: dict[str, tuple[int, int, int]] = {
    "tiny": (7, 6, 6),
    "sf": (1, 40, 40),
    "nyc": (2, 56, 36),
    "la": (3, 48, 48),
    "bayarea": (4, 128, 128),
    "bayarea-xl": (5, 384, 384),
}

_CITY_CENTERS = {
    "tiny": (-122.45, 37.77),
    "sf": (-122.4194, 37.7749),
    "nyc": (-73.9857, 40.7484),
    "la": (-118.2437, 34.0522),
    "bayarea": (-122.2711, 37.8044),
    "bayarea-xl": (-122.2711, 37.8044),
}


def generate_city(
    name: str = "tiny",
    *,
    nx: int | None = None,
    ny: int | None = None,
    seed: int | None = None,
    spacing: float = 120.0,
    jitter: float = 12.0,
    p_missing_block: float = 0.06,
    p_oneway: float = 0.25,
    p_curved: float = 0.25,
    center: "tuple[float, float] | None" = None,
) -> RoadNetwork:
    """A deterministic synthetic city: a jittered street grid with
    ``spacing`` meters between intersections, some removed block legs,
    some one-way ways, some curved legs, and two diagonal boulevards.

    "organic" (seed 11) and "organic-xl" (seed 12, ~2.5x the radius) are
    the irregular radial metros of netgen/organic.py; ``seed`` applies to
    them, the grid parameters and ``center`` do not (they raise)."""
    if name in ("organic", "organic-xl"):
        if center is not None:
            raise ValueError("center does not apply to the organic "
                             "generator; its centers are fixed")
        if (nx, ny) != (None, None) or (spacing, jitter) != (120.0, 12.0) \
                or (p_missing_block, p_oneway, p_curved) != (0.06, 0.25,
                                                             0.25):
            raise ValueError(
                "grid parameters don't apply to the organic generator; "
                "call netgen.organic.generate_organic_city directly")
        from reporter_tpu_torch.netgen.organic import generate_organic_city

        if name == "organic-xl":
            return generate_organic_city(
                name, seed=seed if seed is not None else 12,
                radius=16000.0, core_scale=2800.0, n_candidates=420000)
        return generate_organic_city(name, seed=seed if seed is not None
                                     else 11)
    preset = CITY_PRESETS.get(name)
    if preset is not None:
        pseed, pnx, pny = preset
        seed = pseed if seed is None else seed
        nx = pnx if nx is None else nx
        ny = pny if ny is None else ny
    if nx is None or ny is None or seed is None:
        raise ValueError(f"unknown city {name!r}; pass nx/ny/seed explicitly")

    rng = np.random.default_rng(seed)
    lon0, lat0 = (center if center is not None
                  else _CITY_CENTERS.get(name, (-122.0, 37.0)))

    # Node grid in local meters, centered at 0.
    xs = (np.arange(nx) - (nx - 1) / 2.0) * spacing
    ys = (np.arange(ny) - (ny - 1) / 2.0) * spacing
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    xy = np.stack([gx, gy], axis=-1)                     # [nx, ny, 2]
    xy = xy + rng.normal(0.0, jitter, size=xy.shape)

    node_lonlat = xy_to_lonlat(xy.reshape(-1, 2), np.array([lon0, lat0]))
    node_index = np.arange(nx * ny).reshape(nx, ny)

    removed = rng.random((nx, ny, 2)) < p_missing_block  # [.., 0]=east, [.., 1]=north

    ways: list[Way] = []
    way_id = 1

    def add_chain(chain: list[int], oneway: bool, name_: str, speed: float) -> None:
        nonlocal way_id
        if len(chain) < 2:
            return
        w = Way(way_id=way_id, nodes=chain, oneway=oneway, name=name_, speed_mps=speed)
        # Curved geometry on a fraction of legs: a midpoint pushed perpendicular.
        for i in range(len(chain) - 1):
            if rng.random() < p_curved:
                a = node_lonlat[chain[i]]
                b = node_lonlat[chain[i + 1]]
                mid = (a + b) / 2.0
                d = b - a
                perp = np.array([-d[1], d[0]])
                n = np.linalg.norm(perp)
                if n > 0:
                    bow = rng.uniform(0.05, 0.12)
                    mid = mid + perp * bow
                    w.geometry[i] = mid[None, :]
        ways.append(w)
        way_id += 1

    # Streets (constant j, varying i): break chains at removed east-legs.
    for j in range(ny):
        chain: list[int] = [int(node_index[0, j])]
        for i in range(nx - 1):
            if removed[i, j, 0]:
                add_chain(chain, rng.random() < p_oneway, f"st_{j}", 13.4)
                chain = [int(node_index[i + 1, j])]
            else:
                chain.append(int(node_index[i + 1, j]))
        add_chain(chain, rng.random() < p_oneway, f"st_{j}", 13.4)

    # Avenues (constant i, varying j): break chains at removed north-legs.
    for i in range(nx):
        chain = [int(node_index[i, 0])]
        for j in range(ny - 1):
            if removed[i, j, 1]:
                add_chain(chain, rng.random() < p_oneway, f"av_{i}", 13.4)
                chain = [int(node_index[i, j + 1])]
            else:
                chain.append(int(node_index[i, j + 1]))
        add_chain(chain, rng.random() < p_oneway, f"av_{i}", 13.4)

    # Two diagonal boulevards (two-way, faster).
    k = min(nx, ny)
    add_chain([int(node_index[t, t]) for t in range(k)], False, "diag_ne", 17.9)
    add_chain([int(node_index[t, ny - 1 - t]) for t in range(k)], False,
              "diag_se", 17.9)

    return RoadNetwork(node_lonlat=node_lonlat, ways=ways, name=name)


def assign_mode_access(net: RoadNetwork, seed: int = 21,
                       p_bike_only: float = 0.08,
                       p_foot_only: float = 0.05) -> RoadNetwork:
    """Give an all-access city a mode mix: a fraction of ways become
    bike-and-foot cycleways (5.6 m/s) and foot-only paths (1.4 m/s), the
    rest stay all-access. Mutates and returns ``net``; the name gains
    ``+m``. The fixture of per-mode compiles (compile_network(net,
    mode=...))."""
    rng = np.random.default_rng(seed)
    for w in net.ways:
        u = rng.random()
        if u < p_bike_only:
            w.access_mask = ACCESS_BICYCLE | ACCESS_FOOT
            w.speed_mps = 5.6
        elif u < p_bike_only + p_foot_only:
            w.access_mask = ACCESS_FOOT
            w.speed_mps = 1.4
    if not net.name.endswith("+m"):
        net.name = f"{net.name}+m"
    return net


def add_random_restrictions(net: RoadNetwork, fraction: float = 0.08,
                            seed: int = 99) -> RoadNetwork:
    """Add ``no_turn`` restrictions at about ``fraction`` of the junctions
    (nodes where a way arrives and at least two distinct ways leave). The
    banned exit must leave the arriving vehicle another way out, so a
    restriction forces a detour, never a dead end. Mutates and returns
    ``net``; the name gains ``+r`` when any restriction was added."""
    rng = np.random.default_rng(seed)
    # node → ways that can arrive at it / leave it (oneway-aware)
    arrive: dict[int, list] = {}
    leave: dict[int, list] = {}
    for w in net.ways:
        for i, nd in enumerate(w.nodes):
            if i > 0 or not w.oneway:
                arrive.setdefault(nd, []).append(w)
            if i < len(w.nodes) - 1 or not w.oneway:
                leave.setdefault(nd, []).append(w)
    junctions = [nd for nd in arrive
                 if len({w.way_id for w in leave.get(nd, [])}) >= 2]
    junctions.sort()
    n_pick = int(round(len(junctions) * fraction))
    for nd in rng.permutation(np.asarray(junctions))[:n_pick]:
        nd = int(nd)
        dst_ids = sorted({w.way_id for w in leave[nd]})
        # the banned exit must leave the arriving vehicle another way out
        src = [w for w in arrive[nd]
               if w.way_id in dst_ids and len(dst_ids) >= 2]
        if not src:
            continue
        fw = src[rng.integers(len(src))]
        to_choices = [d for d in dst_ids if d != fw.way_id]
        if not to_choices:
            continue
        tw = to_choices[rng.integers(len(to_choices))]
        net.restrictions.append(TurnRestriction(
            from_way=fw.way_id, via_node=nd, to_way=int(tw),
            kind="no_turn"))
    if net.restrictions and not net.name.endswith("+r"):
        net.name = f"{net.name}+r"
    return net
