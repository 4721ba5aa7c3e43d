"""Mesh-sharded golden parity on the port: the reference's golden shapes
(``SHAPES`` of ``tests/test_mesh_goldens.py`` — filters, order ×
pagination, recurse, shortest, facets, vars, aggregation, math,
groupby, cascade, normalize, expand(), language chains, _predicate_)
through the port's engine with every predicate row-sharded
(``shard_threshold=1``) over a 1×8 and a 2×4 mesh of CPU shards.  Each
body must equal, byte for byte, the port's unsharded engine's and the
reference's unsharded engine's; a handful of shapes is also held against
the reference's own mesh engine on its 8 virtual CPU devices."""

import json

import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.parallel import make_mesh as jmake_mesh
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.parallel import make_mesh
from dgraph_tpu_torch.query import QueryEngine

from tests import test_goldens, test_mesh_goldens
from torch_pins import pinned_planner  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_planner")

SHAPES = test_mesh_goldens.SHAPES
SETUP = "mutation { schema { %s } set { %s } }" % (
    test_goldens.SCHEMA, test_goldens.RDF)


def _port(mesh=None):
    """A port engine over the golden graph; no hop cache, so that every
    hop of every shape expands (on the mesh, when it has one)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DGRAPH_TPU_CACHE", "0")
        e = QueryEngine(PostingStore(), device="cpu", mesh=mesh,
                        shard_threshold=1)
    e.run(SETUP)
    e.expand_device_min = 1
    return e


def _dump(resp) -> str:
    resp = dict(resp)
    resp.pop("server_latency", None)
    return json.dumps(resp)


@pytest.fixture(scope="module")
def plain():
    return _port()


@pytest.fixture(scope="module")
def reference():
    e = JaxEngine(JaxStore())
    e.run(SETUP)
    return e


@pytest.fixture(scope="module", params=[(1, 8), (2, 4)], ids=["1x8", "2x4"])
def meshed(request):
    data, model = request.param
    return _port(make_mesh(devices=["cpu"] * (data * model), data=data))


@pytest.mark.parametrize("shape", SHAPES)
def test_shape(plain, reference, meshed, shape):
    got = _dump(meshed.run(shape))
    assert got == _dump(plain.run(shape))
    assert got == _dump(reference.run(shape))


def test_sharded_path_engaged(meshed):
    meshed.run(SHAPES[0])
    assert meshed.arenas._sharded, "sharded arenas never built"
    assert meshed.stats["routes"].get("mesh", 0) >= 1, meshed.stats["routes"]


@pytest.mark.compile_budget(200)
@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[16], SHAPES[18]])
def test_shape_against_reference_mesh(shape):
    """The reference's own mesh engine (1×8 over its virtual CPU devices)
    on a few shapes: a child hop, a reverse hop, a recurse."""
    jm = JaxEngine(JaxStore(), mesh=jmake_mesh(8, data=1), shard_threshold=1)
    jm.run(SETUP)
    tm = _port(make_mesh(devices=["cpu"] * 8))
    assert _dump(tm.run(shape)) == _dump(jm.run(shape))
