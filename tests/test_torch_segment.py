"""The torch DeviceSegment holds the JAX DeviceSegment's arrays, element by
element, impact mirror included; state exported from JAX loads into the
port unchanged; concurrent first queries upload once."""

import threading
import time

import numpy as np
import pytest
import torch

from xapiand_tpu.database import Database
from xapiand_tpu.models.segment import DeviceSegment as JaxDeviceSegment
from xapiand_tpu.models.weights import CollectionStats as JStats
from xapiand_tpu.models.weights import get_scheme as jscheme
from xapiand_tpu.utils.synth import build_synthetic_segment
from xapiand_tpu_torch import search as psearch
from xapiand_tpu_torch.models.segment import (DeviceSegment,
                                              device_segment_from_numpy,
                                              value_arrays)
from xapiand_tpu_torch.models.weights import CollectionStats as PStats
from xapiand_tpu_torch.models.weights import get_scheme as pscheme
from xapiand_tpu_torch.utils import synth as psynth

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth_seg():
    return build_synthetic_segment(3000, 250, seed=3)


@pytest.fixture(scope="module")
def db_seg():
    """A builder segment with string, numeric, multi-value and geo slots."""
    db = Database()
    for i in range(60):
        db.index_document({
            "body": f"w{i % 5} text", "price": float(i), "cat": f"c{i % 3}",
            "tags": [i, i + 1, i + 7],
            "loc": {"_point": {"_latitude": 10 + i * 0.1,
                               "_longitude": 20.0}}}, doc_id=f"d{i}")
    db.commit()
    return db._searchers[0].segment


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_same_tree(port_tree, jax_tree):
    p, j = _flatten(port_tree), _flatten(jax_tree)
    assert sorted(p) == sorted(j)
    for k, jv in j.items():
        jv = np.asarray(jv)
        assert isinstance(p[k], torch.Tensor), k
        assert p[k].numpy().dtype == jv.dtype, k
        np.testing.assert_array_equal(p[k].numpy(), jv, err_msg=k)


@pytest.mark.parametrize("which", ["synth", "port-synth", "builder"])
def test_arrays_equal_jax_arrays_pytree(which, synth_seg, db_seg):
    """port-synth: the port uploads the segment its own synth.py builds from
    the same seed (host Segment and impact mirror are the port's copies)."""
    seg = db_seg if which == "builder" else synth_seg
    stats = dict(doc_count=seg.doc_count, avg_doclen=seg.avg_doclen)
    jds = JaxDeviceSegment(seg)
    pds = DeviceSegment(psynth.build_synthetic_segment(3000, 250, seed=3)
                        if which == "port-synth" else seg, CPU)
    assert jds.ensure_impact(jscheme("bm25"), JStats(**stats))
    assert pds.ensure_impact(pscheme("bm25"), PStats(**stats))
    # the port's geo columns add the int2 pairs geo_leaves.cu reads
    # (models/segment.py geo_arrays): the JAX tree's, interleaved
    ptree = dict(pds.arrays_pytree())
    ptree["geo"] = {slot: dict(col) for slot, col in ptree["geo"].items()}
    for col in ptree["geo"].values():
        assert torch.equal(col.pop("span"),
                           torch.stack((col["doc_off"], col["doc_len"]), 1))
        assert torch.equal(col.pop("flat"), torch.stack(
            (col["flat_start"], col["flat_end"]), 1))
    # and its value columns the packed keys and codes filter_leaves.cu and
    # agg_distinct.cu read (models/segment.py value_arrays; held to the
    # JAX channels in tests/test_torch_filter_distinct_design.py)
    ptree["values"] = {slot: dict(col)
                       for slot, col in ptree["values"].items()}
    for col in ptree["values"].values():
        want = value_arrays({ch: col[ch].numpy() for ch in
                             ("hi", "lo", "max_hi", "max_lo", "present")})
        for ch in ("keys", "codes", "code_hll"):
            np.testing.assert_array_equal(col.pop(ch).numpy(), want[ch])
    _assert_same_tree(ptree, jds.arrays_pytree())
    assert {"imp.docids", "imp.wdf", "imp.doclen"} <= \
        set(pds.arrays_pytree())


@pytest.mark.parametrize("which", ["synth", "builder"])
def test_device_segment_from_numpy_carries_jax_state(which, synth_seg,
                                                     db_seg):
    seg = synth_seg if which == "synth" else db_seg
    jds = JaxDeviceSegment(seg)
    jds.ensure_impact(jscheme("bm25"),
                      JStats(seg.doc_count, seg.avg_doclen))
    tree = {k: (v if isinstance(v, dict) else np.asarray(v))
            for k, v in jds.arrays_pytree().items()}
    tree["values"] = {s: {c: np.asarray(a) for c, a in col.items()}
                      for s, col in tree["values"].items()}
    tree["geo"] = {s: {c: np.asarray(a) for c, a in g.items()}
                   for s, g in tree["geo"].items()}
    _assert_same_tree(device_segment_from_numpy(tree, CPU),
                      jds.arrays_pytree())


def test_concurrent_first_access_uploads_once(synth_seg, monkeypatch):
    made = []

    class SlowDeviceSegment(DeviceSegment):
        def __init__(self, *a, **kw):
            made.append(1)
            time.sleep(0.05)
            super().__init__(*a, **kw)

    monkeypatch.setattr(psearch, "DeviceSegment", SlowDeviceSegment)
    searcher = psearch.SegmentSearcher(synth_seg, device=CPU)
    got = []
    threads = [threading.Thread(target=lambda: got.append(
        searcher.device_segment)) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(made) == 1
    assert all(g is got[0] for g in got) and len(got) == 8


def test_searcher_takes_an_explicit_device(synth_seg):
    """The card unless the caller names another device (the default is
    cuda since PR 8: nothing is uploaded until the first device-routed
    query); an explicit device is honoured."""
    assert psearch.SegmentSearcher(synth_seg).device == torch.device("cuda")
    ds = psearch.SegmentSearcher(synth_seg, device="cpu").device_segment
    assert ds.arrays["post_docids"].device == CPU
