"""The torch port imports without JAX and without the JAX package, and
builds nothing at import; its copies of the JAX package's jax-free host
modules stay equal to their originals."""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

IMPORT_ALL = """
import importlib, pkgutil, sys
import xapiand_tpu_torch
names = [m.name for m in pkgutil.walk_packages(xapiand_tpu_torch.__path__,
                                                "xapiand_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from xapiand_tpu_torch.ops import kernels
assert "jax" not in sys.modules, "jax imported"
assert not [m for m in sys.modules if m.split(".")[0] == "xapiand_tpu"], \
    "the JAX package imported"
assert kernels._lib is None and not kernels.build_info, "kernels built"
from xapiand_tpu_torch import native
assert not native._state and not native.build_info, "native library built"
assert {"xapiand_tpu_torch.search", "xapiand_tpu_torch.query.plan",
        "xapiand_tpu_torch.ops.executor", "xapiand_tpu_torch.ops.aggs",
        "xapiand_tpu_torch.aggregations",
        "xapiand_tpu_torch.utils.synth_faceted",
        "xapiand_tpu_torch.utils.synth_positional",
        "xapiand_tpu_torch.ops.phrase",
        "xapiand_tpu_torch.utils.dtutils",
        "xapiand_tpu_torch.utils.iputils",
        "xapiand_tpu_torch.utils.synth_geo", "xapiand_tpu_torch.native",
        "xapiand_tpu_torch.utils.synth_browse",
        "xapiand_tpu_torch.analysis.accuracy",
        "xapiand_tpu_torch.geo.cartesian", "xapiand_tpu_torch.geo.datum",
        "xapiand_tpu_torch.geo.ewkt", "xapiand_tpu_torch.geo.geospatial",
        "xapiand_tpu_torch.geo.htm", "xapiand_tpu_torch.database",
        "xapiand_tpu_torch.analysis.stem", "xapiand_tpu_torch.analysis.termgen",
        "xapiand_tpu_torch.schema.schema", "xapiand_tpu_torch.query.dsl",
        "xapiand_tpu_torch.models.builder", "xapiand_tpu_torch.models.merge",
        "xapiand_tpu_torch.ops.host_scorer", "xapiand_tpu_torch.ops.host_query",
        "xapiand_tpu_torch.utils.synth_docs"} <= set(names), names
print("ok", len(names))
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


def _run(code, extra_path=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (extra_path, ROOT, env.get("PYTHONPATH")) if p)
    return subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax_or_a_build():
    r = _run(IMPORT_ALL)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


DATABASE_ALONE = """
import sys
from xapiand_tpu_torch.database import Database
db = Database(device="cpu")
db.index_document({"body": "the runners were running quickly", "n": 3},
                  doc_id="a")
db.index_document({"body": "a runner runs", "n": 5}, doc_id="b")
db.commit()
r = db.search({"body": "run"}, k=5, aggs={"m": {"_median": {"_field": "n"}}})
assert sorted(h.id for h in r.hits) == ["a", "b"], r
assert 3.0 <= r.aggregations["m"]["_median"] <= 5.0, r.aggregations
from xapiand_tpu_torch.query.dsl import QueryDSL
q = QueryDSL(db.schema).parse({"body": "jumping"})
assert q.terms and q.terms[0].endswith(".jump"), q
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu", "nltk")]
from xapiand_tpu_torch.analysis.stem import Stem, StemError
try:
    Stem("french")
except StemError as e:      # nltk does not import here
    assert "french" in str(e) and "nltk" in str(e)
else:                       # it does: French stems through it
    assert "nltk" in sys.modules
print("ok")
"""


def test_port_imports_without_the_analysis_chain(tmp_path):
    """Where the host analysis packages are missing (the JAX package's
    models/__init__.py needs them), the port still imports: it loads no
    module of the JAX package. Its Database indexes English text (the
    native Porter2), searches with a K17c aggregation and parses a query
    there; an nltk-only language refuses by name."""
    (tmp_path / "nltk.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'nltk'\", name='nltk')\n")
    r = _run(IMPORT_ALL, extra_path=str(tmp_path))
    assert r.returncode == 0, r.stderr
    r = _run(DATABASE_ALONE, extra_path=str(tmp_path))
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")
    r = _run("import xapiand_tpu.models", extra_path=str(tmp_path))
    assert r.returncode != 0 and "nltk" in r.stderr   # the stub is in effect


SEARCH_ALONE = """
import torch
from xapiand_tpu_torch.query.ir import Q
from xapiand_tpu_torch.search import BatchSearcher, SegmentSearcher
from xapiand_tpu_torch.utils.synth import build_synthetic_segment, sample_queries
seg = build_synthetic_segment(2000, 200, seed=3)
irs = [Q.or_terms(q) for q in sample_queries(seg, 8, 3, seed=5)]
bs = BatchSearcher(SegmentSearcher(seg, device=torch.device("cpu")), k=10,
                   prefix_cap=128)
res = bs.run(irs)
assert len(res) == 8 and all(len(r["docids"]) == 10 for r in res)
from xapiand_tpu_torch.utils import synth_faceted as sf
c = sf.build_faceted_corpus(3000, seed=7)
qs = sf.faceted_queries(4, seed=11)
from xapiand_tpu_torch.aggregations import compile_for_segment, merge_and_shape
names, specs, arrays, metas = compile_for_segment(sf.SCHEMA, c.seg,
                                                  sf.CFG3_AGGS)
bs = BatchSearcher(SegmentSearcher(c.seg, device=torch.device("cpu")), k=10,
                   sort=sf.PRICE_DESC, aggs=(specs, arrays))
res = bs.run([q for f, q, _ in qs if f in "AB"])
want = sf.oracle_answers(c, [x for x in qs if x[0] in "AB"])
assert [r["count"] for r in res] == [w["count"] for w in want]
shaped = merge_and_shape(names, metas, [res[0]["aggs"]],
                         [{0: metas[0]["cat_names"]}])
assert shaped["price_stats"]["_count"] == want[0]["count"]
from xapiand_tpu_torch.utils import synth_positional as sp
pc = sp.build_corpus2(2000, seed=7)
pq = sp.queries2(pc, n_each=8, n_three=4)
res = BatchSearcher(SegmentSearcher(pc.seg, device=torch.device("cpu")),
                    k=10).run([q for _f, q, _w in pq])
assert sum(r["count"] for r in res[:8]) > 0
from xapiand_tpu_torch.utils import synth_geo as sg
gc = sg.build_corpus4(1500, seed=7)
gq = sg.queries4(6, 3)
gb = BatchSearcher(SegmentSearcher(gc.seg, device=torch.device("cpu")), k=10)
rmax = gb.plan([q for _f, q, _p in gq])[0][0].geo_specs[0][2]
res = gb.run([q for _f, q, _p in gq])
want = sg.oracle_answers(gc, gq, rmax)
assert [r["count"] for r in res] == [w["count"] for w in want]
assert sum(w["count"] for w in want) > 0
from xapiand_tpu_torch.models.weights import CollectionStats
from xapiand_tpu_torch.query.plan import bind, compile_ir
from xapiand_tpu_torch.utils import synth_browse as sb
bq = [x for x in sb.browse_queries(2, 2, 2, 2, 4) if x[0] == "C"]
ss = SegmentSearcher(c.seg, device=torch.device("cpu"))
st = CollectionStats(doc_count=c.seg.doc_count, avg_doclen=c.seg.avg_doclen,
                     doclen_lower=1.0)
res = [ss.execute(bind(compile_ir(q), c.seg, ss.scheme, st, k=10,
                       sort=sf.PRICE_DESC if p["sorted"] else (),
                       collapse_slot=sf.CAT_SLOT,
                       collapse_max=p["collapse_max"]),
                  {"N": st.doc_count, "avg_doclen": st.avg_doclen})
       for _f, q, p in bq]
want = sb.oracle_answers(c, bq)
assert [int(r["count"]) for r in res] == [w["count"] for w in want]
import sys
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu")]
print("ok")
"""


def test_port_searches_with_the_jax_package_absent(tmp_path):
    """A package named xapiand_tpu that fails to import, ahead of the real
    one on the path: the port imports all its modules and runs a relevance
    and a value-sorted faceted batch search with config 3's aggregations
    (compile_for_segment to merge_and_shape), config 2's phrase and
    boolean batch, config 4's circle AND window batch, and collapsed
    SegmentSearcher.execute calls of the browse traffic, plan to
    results, without it."""
    pkg = tmp_path / "xapiand_tpu"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        "raise ImportError('the JAX package is not available here')\n")
    for code in (IMPORT_ALL, SEARCH_ALONE, DATABASE_ALONE):
        r = _run(code, extra_path=str(tmp_path))
        assert r.returncode == 0, r.stderr
        assert r.stdout.startswith("ok")


# (path in both packages, the whole file or only the text before a marker)
HOST_COPIES = [
    ("aggregations.py", None),
    ("query/ir.py", None),
    ("query/plan.py", None),
    ("utils/synth.py", None),
    ("utils/serialise.py", None),
    ("utils/strmetrics.py", None),
    ("utils/phonetic.py", None),
    ("utils/dtutils.py", None),
    ("utils/iputils.py", None),
    ("models/segment.py", "class DeviceSegment"),
    ("geo/__init__.py", None),
    ("geo/cartesian.py", None),
    ("geo/htm.py", None),
    ("geo/ewkt.py", None),
    ("geo/datum.py", None),
    ("geo/geospatial.py", None),
    ("analysis/accuracy.py", None),
    ("native/native.cpp", None),
    ("native/__init__.py", "def _build"),
    ("utils/hashing.py", None),
    ("utils/uuid64.py", None),
    ("analysis/unicode_tok.py", None),
    ("analysis/stopwords.py", None),
    ("analysis/stem_extra.py", None),
    ("analysis/stem_extra2.py", None),
    ("analysis/termgen.py", None),
    ("schema/types.py", None),
    ("schema/schema.py", None),
    ("schema/__init__.py", None),
    ("query/boolparser.py", None),
    ("query/dsl.py", None),
    ("models/builder.py", None),
    ("models/merge.py", None),
    ("ops/host_scorer.py", None),
    ("ops/host_query.py", None),
]


@pytest.mark.parametrize("path,until", HOST_COPIES,
                         ids=[c[0] for c in HOST_COPIES])
def test_host_copy_equals_the_jax_file(path, until):
    """Each copied host module is its JAX original with the package's
    imports pointed at the port (``from xapiand_tpu.x`` and ``from
    xapiand_tpu import x``) and its citations of the reference's sources
    relative to that tree, and nothing else changed (models/segment.py
    continues past the copied host Segment with the torch device mirror,
    native/__init__.py past the copied bindings with its own loader)."""
    def text(pkg):
        with open(os.path.join(ROOT, pkg, path)) as f:
            return f.read()

    ref = text("xapiand_tpu")
    if until is not None:
        ref = ref[:ref.index(until)]
    want = re.sub(r"^(\s*)from xapiand_tpu(\.| import )",
                  r"\1from xapiand_tpu_torch\2", ref, flags=re.M)
    # a citation of the reference's sources by a local checkout path is
    # written relative to its tree, as the package's other citations are
    want = re.sub(r"\(/[\w/]*?/reference/src/", "(src/", want)
    got = text("xapiand_tpu_torch")
    assert got.startswith(want) if until else got == want
    assert not re.search(r"^\s*(from|import) (jax|xapiand_tpu)\b", got,
                         flags=re.M)
