"""The port's wire entries against reporter_tpu.ops.match's jitted ones:
the same bytes for every infeed form (f32 points, i16 quanta, i8 deltas)
and every layout (compact u16, full u16, packed u32), and the same host
prepare. Tolerance 0 throughout.

The full-u16 and packed-u32 layouts serve metros past 16384 edges; as the
reference's own tests do, they are forced on a small tile by padding the
``edge_len`` table past that count (extra rows no candidate can name) and,
for u32, passing the ``wire_spec`` of the padded count.
"""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from reporter_tpu.config import CompilerParams, MatcherParams as JMatcherParams
from reporter_tpu.matcher.native_prepare import prepare_slice_python
from reporter_tpu.netgen.synthetic import generate_city
from reporter_tpu.netgen.traces import synthesize_fleet
from reporter_tpu.ops import match as jm
from reporter_tpu.tiles.compiler import compile_network
from reporter_tpu.tiles.tileset import _ARRAY_FIELDS
from _torch_support import (  # noqa: F401  (the port's gate: first)
    _torch_gate, _torch_module_gate, few_torch_threads)
from reporter_tpu_torch.config import MatcherParams
from reporter_tpu_torch.matcher.native_prepare import prepare_slice
from reporter_tpu_torch.ops import match as pm
from reporter_tpu_torch.tiles.tileset import tables_from_numpy

pytestmark = pytest.mark.usefixtures("few_torch_threads")

_GOLDEN = os.path.join(os.path.dirname(__file__), "fixtures",
                       "golden_traces.json")
_PAD_EDGES = 20000


@pytest.fixture(scope="module")
def setup():
    with open(_GOLDEN) as f:
        fx = json.load(f)[0]
    ts = compile_network(generate_city(fx["city"]),
                         CompilerParams(**fx["compiler"]))
    jtab = ts.device_tables("dense")
    ptab = tables_from_numpy({f: getattr(ts, f) for f in _ARRAY_FIELDS}, "cpu")
    prep = prepare_slice(_xys(ts), 64)
    assert prep[0] == 2               # every step fits the i8 delta form
    return ts, jtab, ptab, prep


def _xys(ts):
    fleet = synthesize_fleet(ts, 6, num_points=48, seed=4, gps_sigma=3.0)
    xys = [p.xy.astype(np.float32) for p in fleet]
    xys[2] = xys[2][:30]              # one short trace: padded tail
    return xys


def _padded(jtab, ptab):
    e = np.asarray(jtab["edge_len"])
    pad = np.concatenate([e, np.zeros(_PAD_EDGES - len(e), np.float32)])
    return (dict(jtab, edge_len=jnp.asarray(pad)),
            dict(ptab, edge_len=torch.from_numpy(pad)))


def _wire(entry, prep, jtab, ptab, spec=None):
    mode, pts, lens, origins, payload = prep
    params = JMatcherParams(candidate_backend="dense")
    if entry == "f32":
        ref = jm.match_batch_wire(jnp.asarray(pts), jnp.asarray(lens), jtab,
                                  None, params, spec=spec)
        got = pm.wire_from_f32(torch.from_numpy(pts), torch.from_numpy(lens),
                               ptab, MatcherParams(), spec=spec)
    else:
        q = payload if entry == "q8" else _q16_payload(prep)
        fn = jm.match_batch_wire_q8 if entry == "q8" else jm.match_batch_wire_q
        ref = fn(jnp.asarray(q), jnp.asarray(origins), jnp.asarray(lens), jtab,
                 None, params, spec=spec)
        pfn = pm.wire_from_q8 if entry == "q8" else pm.wire_from_q16
        got = pfn(torch.from_numpy(q), torch.from_numpy(origins),
                  torch.from_numpy(lens), ptab, MatcherParams(), spec=spec)
    return np.asarray(ref), got.numpy()


def _q16_payload(prep):
    _, pts, _, origins, _ = prep
    dq = np.round((pts - origins[:, None, :]) * np.float32(1.0 / 0.25))
    return dq.astype(np.int16)


def test_prepare_slice_matches_reference(setup):
    ts, _, _, prep = setup
    xys = _xys(ts)
    ref = prepare_slice_python(xys, 64)
    assert prep[0] == ref[0] == 2
    for a, b in zip(prep[1:], ref[1:]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    jump = [x.copy() for x in xys]
    jump[0][20:] += 50.0              # a 50 m step overflows i8 → i16
    a, b = prepare_slice(jump, 64), prepare_slice_python(jump, 64)
    assert a[0] == b[0] == 1 and a[4].tobytes() == b[4].tobytes()


@pytest.mark.parametrize("entry", ["f32", "q16", "q8"])
def test_wire_bytes_compact(setup, entry):
    _, jtab, ptab, prep = setup
    ref, got = _wire(entry, prep, jtab, ptab)
    assert ref.dtype == got.dtype == np.uint16 and got.shape == (6, 2, 64)
    np.testing.assert_array_equal(got, ref)
    e, o, s = pm.unpack_wire(got)
    re, ro, rs = jm.unpack_wire(ref)
    for a, b in ((e, re), (o, ro), (s, rs)):
        np.testing.assert_array_equal(a, b)
    assert (e[:, :30] >= 0).mean() > 0.9


@pytest.mark.parametrize("layout", ["full_u16", "packed_u32"])
def test_wire_bytes_big_metro_layouts(setup, layout):
    _, jtab, ptab, prep = setup
    jt, pt = _padded(jtab, ptab)
    spec = None
    if layout == "packed_u32":
        spec = pm.wire_spec(_PAD_EDGES, float(np.asarray(jtab["edge_len"]).max()))
        assert spec == jm.wire_spec(_PAD_EDGES,
                                    float(np.asarray(jtab["edge_len"]).max()))
    ref, got = _wire("q8", prep, jt, pt, spec)
    assert got.dtype == ref.dtype
    assert got.shape == (6, 3 if spec is None else 1, 64)
    np.testing.assert_array_equal(got, ref)
    compact_ref, _ = _wire("q8", prep, jtab, ptab)
    for a, b in zip(pm.unpack_wire(got, spec), jm.unpack_wire(compact_ref)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("num_edges,max_id,spec", [
    (5000, 4999, None), (16384, 16383, None), (60000, 59999, None),
    (60000, 59999, (14, 0.25)), (500000, 499999, (11, 0.25))])
def test_pack_wire_random_roundtrip(num_edges, max_id, spec):
    """Random MatchOutputs pack to the reference's bytes in every layout
    and unpack losslessly (ids, flags, 0.25 m offsets)."""
    rng = np.random.default_rng(8)
    B, T = 16, 64
    edges = rng.integers(0, max_id, size=(B, T), endpoint=True)
    edges[0, 0] = max_id
    matched = rng.random((B, T)) < 0.8
    matched[0, 0] = True
    edges = np.where(matched, edges, -1).astype(np.int32)
    hi = (1 << spec[0]) - 1 if spec else 65535
    offsets = (rng.integers(0, hi, size=(B, T)) * 0.25).astype(np.float32)
    offsets = np.where(matched, offsets, 0.0).astype(np.float32)
    starts = rng.random((B, T)) < 0.2
    ref = np.asarray(jm._pack_wire(jm.MatchOutput(
        jnp.asarray(edges), jnp.asarray(offsets), jnp.asarray(starts),
        jnp.asarray(matched)), num_edges, spec))
    got = pm._pack_wire(pm.MatchOutput(
        torch.from_numpy(edges), torch.from_numpy(offsets),
        torch.from_numpy(starts), torch.from_numpy(matched)),
        num_edges, spec).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    e, o, s = pm.unpack_wire(got, spec)
    np.testing.assert_array_equal(e, edges)
    np.testing.assert_array_equal(o, offsets)
    np.testing.assert_array_equal(s, starts)


def test_u32_wire_needs_its_spec():
    with pytest.raises(ValueError, match="wire_spec"):
        pm.unpack_wire(np.zeros((2, 1, 8), np.uint32))
