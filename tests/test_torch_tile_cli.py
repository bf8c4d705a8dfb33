"""The port's tile command line (``python -m reporter_tpu_torch.tiles``)
against the JAX package's (``python -m reporter_tpu.tiles``), subcommand
for subcommand: the files each writes (tile arrays, PBF, GeoJSON, binary
OSMLR tile) and the JSON each prints are equal (tolerance 0), except two
fields: ``compile_seconds`` (a wall time) and ``info``'s ``hbm_bytes``,
which is the port's staged layout (tiles/capacity.dense_staged_bytes)
where the JAX package sums every tile array.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from reporter_tpu.tiles.__main__ import main as j_main
from reporter_tpu.tiles.tileset import TileSet as JTileSet
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.tiles.__main__ import main
from reporter_tpu_torch.tiles.capacity import dense_staged_bytes
from reporter_tpu_torch.tiles.osmlr_tiles import read_osmlr_tile
from reporter_tpu_torch.tiles.tileset import ARRAY_FIELDS, TileSet

pytestmark = pytest.mark.usefixtures("few_torch_threads")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "irregular.osm")


def _run(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue()


def _line(out):
    return json.loads(out.strip().splitlines()[-1])


def _both(tmp_path, argv_of):
    """Run the port's and the JAX package's main on argv_of(tag) →
    (port output, JAX output)."""
    return (_run(main, argv_of(tmp_path / "port")),
            _run(j_main, argv_of(tmp_path / "jax")))


def _arrays_equal(a: str, b: str) -> None:
    ta, tb = TileSet.load(a), JTileSet.load(b)
    for f in ARRAY_FIELDS:
        x, y = getattr(ta, f), getattr(tb, f)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert tuple(ta.meta) == tuple(tb.meta) and ta.name == tb.name


def _no_seconds(doc):
    doc = json.loads(json.dumps(doc))
    doc.get("stats", {}).pop("compile_seconds", None)
    doc.pop("written", None)
    return doc


@pytest.fixture
def dirs(tmp_path):
    for d in ("port", "jax"):
        (tmp_path / d).mkdir()
    return tmp_path


def test_convert(dirs):
    outs = _both(dirs, lambda d: ["convert", FIXTURE, str(d / "m.osm.pbf")])
    assert _no_seconds(_line(outs[0])) == _no_seconds(_line(outs[1]))
    assert ((dirs / "port" / "m.osm.pbf").read_bytes()
            == (dirs / "jax" / "m.osm.pbf").read_bytes())


@pytest.mark.parametrize("mode", ["auto", "bicycle", "foot"])
@pytest.mark.parametrize("fmt", ["xml", "pbf"])
def test_build(dirs, mode, fmt):
    src = FIXTURE
    if fmt == "pbf":
        src = str(dirs / "m.osm.pbf")
        _run(j_main, ["convert", FIXTURE, src])
    outs = _both(dirs, lambda d: ["build", "--osm", src, "--mode", mode,
                                  "-o", str(d / "m.npz")])
    assert _no_seconds(_line(outs[0])) == _no_seconds(_line(outs[1]))
    _arrays_equal(str(dirs / "port" / "m.npz"), str(dirs / "jax" / "m.npz"))


@pytest.mark.parametrize("flags", [
    [],
    ["--cell-size", "80", "--cell-capacity", "8", "--index-radius", "60"],
    ["--reach-radius", "300", "--reach-max", "32",
     "--osmlr-max-length", "250", "--no-native"],
], ids=["defaults", "grid", "reach"])
def test_synth_and_flags(dirs, flags):
    outs = _both(dirs, lambda d: ["synth", "--city", "tiny", "--seed", "3",
                                  "-o", str(d / "t.npz"), *flags])
    assert _no_seconds(_line(outs[0])) == _no_seconds(_line(outs[1]))
    _arrays_equal(str(dirs / "port" / "t.npz"), str(dirs / "jax" / "t.npz"))


def test_info(dirs):
    path = str(dirs / "sf.npz")
    _run(j_main, ["synth", "--city", "sf", "-o", path])
    got, want = json.loads(_run(main, ["info", path])), \
        json.loads(_run(j_main, ["info", path]))
    assert got["hbm_bytes"] == sum(dense_staged_bytes(TileSet.load(path)))
    assert got["hbm_bytes"] != want["hbm_bytes"]
    got.pop("hbm_bytes"), want.pop("hbm_bytes")
    assert got == want
    assert got["grid_cells"] == got["stats"]["grid_cells"] > 0


@pytest.mark.parametrize("binary", [False, True], ids=["geojson", "binary"])
def test_osmlr(dirs, binary):
    path = str(dirs / "t.npz")
    _run(j_main, ["synth", "--city", "tiny", "-o", path])
    ext = ".osmlr" if binary else ".geojson"
    flag = ["--binary"] if binary else []
    outs = _both(dirs, lambda d: ["osmlr", path, "-o", str(d / f"s{ext}"),
                                  *flag])
    assert _no_seconds(_line(outs[0])) == _no_seconds(_line(outs[1]))
    a, b = dirs / "port" / f"s{ext}", dirs / "jax" / f"s{ext}"
    assert a.read_bytes() == b.read_bytes()
    if binary:
        geo = str(dirs / "s.geojson")
        _run(main, ["osmlr", path, "-o", geo])
        feats = json.load(open(geo))["features"]
        segs = read_osmlr_tile(str(a))["segments"]
        assert [s["id"] for s in segs] == [f["id"] for f in feats]
        for s, f in zip(segs, feats):
            np.testing.assert_allclose(s["coordinates"],
                                       f["geometry"]["coordinates"],
                                       atol=1.5e-7, rtol=0)


def test_entry_point_runs_without_jax(tmp_path):
    """``python -m reporter_tpu_torch.tiles`` as a subprocess: it writes
    the tile, prints its line, and never imports jax or reporter_tpu."""
    out = tmp_path / "t.npz"
    code = ("import runpy, sys; sys.argv = ['tiles', 'synth', '--city', "
            f"'tiny', '-o', {str(out)!r}]\n"
            "try:\n    runpy.run_module('reporter_tpu_torch.tiles', "
            "run_name='__main__')\nexcept SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'reporter_tpu')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert _line(proc.stdout)["name"] == "tiny" and out.exists()
