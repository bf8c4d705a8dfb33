"""Synthetic metro generator.

Counterpart: reporter_tpu/netgen/synthetic.py (the grid cities, and the
names "organic" and "organic-xl" of netgen/organic.py's irregular metros).
The same name and seed give the same RoadNetwork bit for bit: the random
draws are made in the same order from the same numpy generator.
"""

from __future__ import annotations

import numpy as np

from reporter_tpu_torch.geometry import xy_to_lonlat
from reporter_tpu_torch.netgen.network import RoadNetwork, Way

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
