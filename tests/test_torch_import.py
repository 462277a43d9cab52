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
assert {"xapiand_tpu_torch.search", "xapiand_tpu_torch.query.plan",
        "xapiand_tpu_torch.ops.executor",
        "xapiand_tpu_torch.utils.synth_faceted"} <= set(names), names
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


def test_port_imports_without_the_analysis_chain(tmp_path):
    """Where the host analysis packages are missing (the JAX package's
    models/__init__.py needs them), the port still imports: it loads no
    module of the JAX package."""
    (tmp_path / "nltk.py").write_text(
        "raise ModuleNotFoundError(\"No module named 'nltk'\", name='nltk')\n")
    r = _run(IMPORT_ALL, extra_path=str(tmp_path))
    assert r.returncode == 0, r.stderr
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
bs = BatchSearcher(SegmentSearcher(c.seg, device=torch.device("cpu")), k=10,
                   sort=(("value", sf.PRICE_SLOT, True),))
res = bs.run([q for f, q, _ in qs if f in "AB"])
want = sf.oracle_answers(c, [x for x in qs if x[0] in "AB"])
assert [r["count"] for r in res] == [w["count"] for w in want]
import sys
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "xapiand_tpu")]
print("ok")
"""


def test_port_searches_with_the_jax_package_absent(tmp_path):
    """A package named xapiand_tpu that fails to import, ahead of the real
    one on the path: the port imports all its modules and runs a relevance
    and a value-sorted faceted batch search, plan to results, without
    it."""
    pkg = tmp_path / "xapiand_tpu"
    pkg.mkdir()
    (pkg / "__init__.py").write_text(
        "raise ImportError('the JAX package is not available here')\n")
    for code in (IMPORT_ALL, SEARCH_ALONE):
        r = _run(code, extra_path=str(tmp_path))
        assert r.returncode == 0, r.stderr
        assert r.stdout.startswith("ok")


# (path in both packages, the whole file or only the text before a marker)
HOST_COPIES = [
    ("query/ir.py", None),
    ("query/plan.py", None),
    ("utils/synth.py", None),
    ("utils/serialise.py", None),
    ("utils/strmetrics.py", None),
    ("utils/phonetic.py", None),
    ("models/segment.py", "class DeviceSegment"),
]


@pytest.mark.parametrize("path,until", HOST_COPIES,
                         ids=[c[0] for c in HOST_COPIES])
def test_host_copy_equals_the_jax_file(path, until):
    """Each copied host module is its JAX original with the package's
    imports pointed at the port, and nothing else changed (models/segment.py
    continues past the copied host Segment with the torch device mirror)."""
    def text(pkg):
        with open(os.path.join(ROOT, pkg, path)) as f:
            return f.read()

    ref = text("xapiand_tpu")
    if until is not None:
        ref = ref[:ref.index(until)]
    want = re.sub(r"^(\s*)from xapiand_tpu\.", r"\1from xapiand_tpu_torch.",
                  ref, flags=re.M)
    got = text("xapiand_tpu_torch")
    assert got.startswith(want) if until else got == want
    assert not re.search(r"^\s*(from|import) (jax|xapiand_tpu)\b", got,
                         flags=re.M)
